"""failsan — chaos-driven fault-to-signal accounting.

The dynamic half of the failcheck static pass (analysis/failcheck.py),
completing the family-pair pattern (concheck<->fluidsan,
detcheck<->detsan, wirecheck<->wiresan): the
static analyzer proves every exception handler in the failure-path
components is loud (or carries a reviewed ``SILENT_HANDLERS``
justification); failsan closes the loop at runtime — **every fault
the chaos plane injects must map to at least one observable signal**.
A fault the system absorbed without a trace is exactly the silent
``except: pass`` of the fault-injection world, and it trips
``failsan_trips_total{site}`` BY SITE.

The accounting window is the armed schedule (qos/faults.py):

- ``PLANE.arm`` (via the plane's ``on_arm`` hook) opens a window:
  a merged ``flat()`` snapshot of every live ``MetricsRegistry``,
  plus positions into the stderr tee and the flight-record capture.
- ``PLANE.disarm`` (``on_disarm``) CLOSES the window — it captures
  ``PLANE.fired`` (the one replayable log of every injection) and
  the schedule's seed, but does NOT evaluate: the chaos harnesses
  disarm *before* the quiesce/drain phase, and most recovery signals
  (gap refetch, pending resubmit, anti-entropy catch-up) land during
  quiesce. Evaluation is LAZY — at the next ``arm``, or when
  ``trips()`` / ``signal_coverage()`` / ``flush()`` is called (the
  pytest plugin ``testing/sanitize_plugin.py`` calls ``flush()`` when a
  test body returns, after quiesce).
- Evaluation walks every fired ``(site, event, kind)`` entry and
  credits it when ANY of the reviewed signal forms moved since arm:

  1. a **paired handling metric delta** — ``SITE_SIGNALS`` maps each
     site (and kind, where kinds differ in how they are absorbed) to
     the metric families that account for its handling. The chaos
     plane's own ``chaos_*`` families never count: the injector
     observing itself is not the system handling the fault.
  2. a **loud stderr line** naming the site (the ``chaos[site]``
     transient-message shape, or the site name itself).
  3. a **flight-recorder record** naming the site (crash/recovery
     dumps mention the seam they recovered).

  A fired site with no ``SITE_SIGNALS`` entry is an unregistered
  seam — always a trip (register the pairing WITH the seam, the same
  review discipline as the wire schema). ``test.*`` sites are test
  fixtures and exempt.

The handler-observation half (``observe()``) drives the differential
against the static pass: a ``sys.settrace`` window (scoped to the
failcheck fail-scope files, so the fast path rejects everything
else by filename) watches real ``except`` clauses execute. A handler
that ran to completion with NO credit — no metric bump, no stderr
write, no flight record, no re-raise — while it held a live
exception is **runtime-silent**; the differential
(tests/test_failsan.py) asserts every runtime-silent handler site is
either a static ``swallowed-exception`` finding or a reviewed
``SILENT_HANDLERS`` entry. A gap fails BY NAME as an
analyzer-resolution gap, never silently.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import sys
import threading
from typing import Any, Optional

from ..obs import metrics as obs_metrics
from ..obs.flight_recorder import FlightRecorder
from ..qos.faults import PLANE

_TRIPS_TOTAL = obs_metrics.REGISTRY.counter(
    "failsan_trips_total",
    "chaos injections that mapped to NO observable signal (silent "
    "fault absorption detected by failsan), by injection site",
    labelnames=("site",))

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))) + os.sep

# ---------------------------------------------------------------------------
# the reviewed site -> signal registry
#
# One entry per registered injection site: kind -> metric families
# whose movement accounts for the fault's handling ("*" is the
# default for kinds not listed). Reviewed like SILENT_HANDLERS and
# WIRE_SCHEMA: the pairing is a claim about HOW the seam absorbs the
# fault, and the 20-seed differential sweep is what keeps it honest
# (a wrong pairing shows up as a trip, a vacuous one as an
# always-moving family that the per-site experiments in
# tests/test_failsan.py would flag). ``chaos_*`` families are
# forbidden here — enforced at import below.

SITE_SIGNALS: dict[str, dict[str, tuple[str, ...]]] = {
    # -- delta-stream transport (testing/chaos.py + socket driver) --
    # outbound: an injected nack is DELIVERED as a nack frame; an
    # injected disconnect loses the in-flight frame, and the
    # reconnect replays it from the pending queue
    "socket.frame_out": {
        "nack": ("container_nacks_total", "ingress_nacks_sent_total"),
        "disconnect": ("container_resubmits_total",
                       "container_catchup_ops_total"),
    },
    # inbound: a dropped/held frame surfaces as a sequence gap (gap
    # refetch / reconnect catch-up); a duplicated or late-released
    # frame is dropped by the sequence-number dedupe. ``delay`` can
    # resolve either way depending on what follows it, and with no
    # follow-on traffic it is absorbed purely as latency — the
    # roundtrip histogram is the reviewed acknowledgment that no
    # discrete handling event exists for an in-order late frame.
    "socket.frame_in": {
        "drop": ("container_catchup_ops_total",
                 "container_resubmits_total"),
        "duplicate": ("container_duplicate_drops_total",
                      "sidecar_duplicate_drops_total"),
        "reorder": ("container_catchup_ops_total",
                    "container_duplicate_drops_total"),
        "delay": ("container_catchup_ops_total",
                  "container_duplicate_drops_total",
                  "container_op_roundtrip_ms"),
    },
    # scripted protocol corruption (tests/test_broker's frame server
    # sends an insane length prefix): the driver tears the transport
    # down loudly and the client reconnects/catches up
    "testing.scripted_frame": {
        "*": ("driver_dispatch_faults_total",
              "container_catchup_ops_total",
              "container_resubmits_total"),
    },
    # -- partitioned ordering plane (service/partitioning.py) --
    "broker.queue_append": {"*": ("broker_append_retries_total",)},
    "broker.queue_consume": {"*": ("broker_redelivered_records_total",)},
    # -- durable storage (service/storage.py) --
    # transient checkpoint-write errors feed the storage breaker;
    # torn writes are crash states recovered (and their tmp debris
    # cleared) on the post-crash load
    "storage.checkpoint_write": {
        "error": ("qos_breaker_failures_total",),
        "error_burst": ("qos_breaker_failures_total",),
        "torn_write": ("storage_torn_recoveries_total",
                       "storage_crash_debris_cleaned_total"),
    },
    "storage.oplog_append": {"*": ("storage_torn_recoveries_total",)},
    "storage.bitrot": {"*": ("storage_scrub_repairs_total",)},
    # -- device dispatch (service/gpu_sidecar.py, tree_sidecar.py,
    #    parallel/mesh_pool.py) --
    "sidecar.dispatch": {"*": ("sidecar_dispatch_faults_total",)},
    "tree_sidecar.dispatch": {
        "*": ("tree_sidecar_dispatch_faults_total",)},
    "sidecar.pool_dispatch": {"*": ("pool_faults_total",)},
    "sidecar.pool_admit": {"*": ("pool_faults_total",)},
    "sidecar.pool_migrate": {"*": ("pool_faults_total",)},
    # -- ingress (service/ingress.py) --
    # a failed summary upload answers the waited rid with an error
    # frame (the generic dispatch handler accounts it)
    "ingress.summary_upload": {"*": ("ingress_errors_sent_total",)},
    # -- replication (service/replication.py) --
    # deferred acks surface as lag the anti-entropy pass drains;
    # lease/promotion faults surface as epoch movement, rejoins and
    # the degraded-window accounting; netsplit transitions are
    # force()d topology changes whose handling IS the degraded
    # window + post-heal rejoin/anti-entropy
    "repl.lag": {
        "*": ("repl_lag_deferrals_total",
              "repl_anti_entropy_ops_total", "repl_lag_ops")},
    "repl.append_ack": {
        "*": ("repl_ack_retries_total",
              "repl_anti_entropy_ops_total", "repl_lag_ops",
              "repl_degraded_seconds_total",
              "repl_unavailable_nacks_total")},
    "repl.lease_expire": {
        "*": ("repl_epoch", "repl_rejoin_total",
              "repl_unavailable_nacks_total",
              "repl_degraded_seconds_total")},
    "repl.promote": {
        "*": ("repl_epoch", "repl_degraded_seconds_total")},
    "repl.partition": {
        "*": ("repl_degraded_seconds_total", "repl_epoch",
              "repl_unavailable_nacks_total", "repl_rejoin_total")},
    "repl.heal": {
        "*": ("repl_rejoin_total", "repl_anti_entropy_ops_total",
              "repl_epoch", "repl_degraded_seconds_total")},
}

for _site, _kinds in SITE_SIGNALS.items():
    for _fams in _kinds.values():
        assert not any(f.startswith("chaos_") for f in _fams), (
            f"SITE_SIGNALS[{_site!r}] pairs the injector with "
            "itself: chaos_* families are the injection record, "
            "never the handling signal")


# ---------------------------------------------------------------------------
# state


@dataclasses.dataclass
class Trip:
    """One injection site whose fired events mapped to no signal
    within an armed window."""

    site: str
    kinds: tuple[str, ...]
    events: int
    seed: Optional[int]
    expected: tuple[str, ...]   # families consulted ((): unregistered)
    reason: str                 # "silent" | "unregistered-site"

    def describe(self) -> str:
        if self.reason == "unregistered-site":
            return (
                f"chaos site {self.site!r} fired {self.events} "
                f"event(s) (kinds {sorted(set(self.kinds))}) under "
                f"seed {self.seed} but has NO SITE_SIGNALS entry — "
                "register the fault-to-signal pairing with the seam "
                "(testing/failsan.py), the same review discipline "
                "as the wire schema"
            )
        return (
            f"chaos site {self.site!r} fired {self.events} event(s) "
            f"(kinds {sorted(set(self.kinds))}) under seed "
            f"{self.seed} with NO observable signal: none of "
            f"{list(self.expected)} moved, no stderr line or flight "
            "record named the site — the system absorbed an injected "
            "fault silently (the runtime shape of a swallowed "
            "exception; docs/ROBUSTNESS.md fault-to-signal "
            "accounting)"
        )


class _Window:
    """One armed schedule's accounting window."""

    __slots__ = ("seed", "snapshot", "stderr_pos", "flight_pos",
                 "fired", "closed")

    def __init__(self, seed: Optional[int], snapshot: dict,
                 stderr_pos: int, flight_pos: int):
        self.seed = seed
        self.snapshot = snapshot
        self.stderr_pos = stderr_pos
        self.flight_pos = flight_pos
        self.fired: list[tuple[str, int, str]] = []
        self.closed = False


class _State:
    def __init__(self) -> None:
        self.installed = 0
        self.registries: list = []       # every live MetricsRegistry
        self.stderr_lines: list[str] = []
        self.flight_tags: list[str] = []
        self.window: Optional[_Window] = None
        self.pending: list[_Window] = []
        self.trips: list[Trip] = []
        self.covered_events = 0
        self.total_events = 0
        self.orig_registry_init = None
        self.orig_flight_record = None
        self.orig_stderr = None
        self.orig_metric_fns: list = []
        # observe() bookkeeping
        self.ticks = 0                   # global credit counter
        self.observing = False


_STATE = _State()
_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# install: registry tracking, stderr tee, flight capture, plane hooks


class _StderrTee:
    """Write-through stderr proxy: forwards everything to the wrapped
    stream, keeps a line buffer for window evaluation, and bumps the
    observe() credit counter (a write to stderr is a loud signal)."""

    def __init__(self, inner):
        self._inner = inner
        self._buf = ""

    def write(self, data):
        _STATE.ticks += 1
        self._buf += str(data)
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            _STATE.stderr_lines.append(line)
        return self._inner.write(data)

    def flush(self):
        return self._inner.flush()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _merged_flat() -> dict[str, float]:
    """One flat view summed across every live registry (per-node
    harness registries included): a signal is a signal no matter
    which node's registry accounted it."""
    out: dict[str, float] = {}
    with _LOCK:
        regs = list(_STATE.registries)
    for reg in regs:
        try:
            flat = reg.flat()
        except Exception:       # a registry mid-construction
            continue
        for key, value in flat.items():
            out[key] = out.get(key, 0.0) + value
    return out


def _on_arm(schedule) -> None:
    _evaluate_pending()
    _STATE.window = _Window(
        seed=getattr(schedule, "seed", None),
        snapshot=_merged_flat(),
        stderr_pos=len(_STATE.stderr_lines),
        flight_pos=len(_STATE.flight_tags),
    )


def _on_disarm(plane) -> None:
    win = _STATE.window
    _STATE.window = None
    if win is None:
        return
    win.fired = list(plane.fired)
    win.closed = True
    if win.fired:
        _STATE.pending.append(win)


def _family_moved(family: str, before: dict, now: dict) -> bool:
    """Did any series of ``family`` change between the two merged
    flat views? Histograms flatten to ``name_count``/``name_sum``."""
    prefixes = (family + "{", family + "_count", family + "_sum")
    for key, value in now.items():
        if key == family or key.startswith(prefixes):
            if value != before.get(key, 0.0):
                return True
    return False


def _evaluate_window(win: _Window) -> None:
    now = _merged_flat()
    stderr_since = "\n".join(_STATE.stderr_lines[win.stderr_pos:])
    flight_since = "\n".join(_STATE.flight_tags[win.flight_pos:])
    by_site: dict[str, list[str]] = {}
    for site, _event, kind in win.fired:
        by_site.setdefault(site, []).append(kind)
    for site, kinds in sorted(by_site.items()):
        if site.startswith("test."):
            continue            # test-fixture seams
        _STATE.total_events += len(kinds)
        spec = SITE_SIGNALS.get(site)
        if spec is None:
            trip = Trip(site=site, kinds=tuple(kinds),
                        events=len(kinds), seed=win.seed,
                        expected=(), reason="unregistered-site")
            _record_trip(trip)
            continue
        families: set[str] = set()
        for kind in kinds:
            families.update(spec.get(kind, spec.get("*", ())))
        # stderr credit requires the transient-message shape
        # (``chaos[site]: injected ...``) — a handler that reports
        # the fault necessarily prints its message; a bare site-name
        # substring match would credit unrelated run chatter
        covered = (
            any(_family_moved(f, win.snapshot, now)
                for f in sorted(families))
            or f"chaos[{site}]" in stderr_since
            or site in flight_since
        )
        if covered:
            _STATE.covered_events += len(kinds)
        else:
            trip = Trip(site=site, kinds=tuple(kinds),
                        events=len(kinds), seed=win.seed,
                        expected=tuple(sorted(families)),
                        reason="silent")
            _record_trip(trip)


def _record_trip(trip: Trip) -> None:
    _STATE.trips.append(trip)
    _TRIPS_TOTAL.labels(site=trip.site).inc(trip.events)
    print(f"failsan: {trip.describe()}", file=sys.stderr, flush=True)


def _evaluate_pending() -> None:
    pending, _STATE.pending = _STATE.pending, []
    for win in pending:
        _evaluate_window(win)


# ---------------------------------------------------------------------------
# lifecycle


def install() -> None:
    """Track every MetricsRegistry, tee stderr, capture flight
    records, and hook the chaos plane's arm/disarm. Refcounted like
    the other sanitizers."""
    with _LOCK:
        _STATE.installed += 1
        if _STATE.installed > 1:
            return
    # registry tracking: the global REGISTRY plus every instance
    # constructed while installed (harness per-node registries)
    _STATE.registries = [obs_metrics.REGISTRY]
    orig_init = obs_metrics.MetricsRegistry.__init__
    _STATE.orig_registry_init = orig_init

    def tracking_init(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        _STATE.ticks += 1
        with _LOCK:
            _STATE.registries.append(self)

    obs_metrics.MetricsRegistry.__init__ = tracking_init
    # flight capture: every record names its tag + stringable values,
    # searchable for site names at window evaluation
    orig_record = FlightRecorder.record
    _STATE.orig_flight_record = orig_record

    def capturing_record(self, tag, **kv):
        _STATE.ticks += 1
        # the chaos plane's own recorder is the INJECTION log — its
        # records (inject/arm/disarm, all naming sites) are the
        # injector observing itself, never the system handling the
        # fault, and crediting them would make coverage vacuous
        if self is not PLANE.flight:
            _STATE.flight_tags.append(
                tag + " " + " ".join(
                    str(v) for v in kv.values()
                    if isinstance(v, (str, int, float, bool))))
        return orig_record(self, tag, **kv)

    FlightRecorder.record = capturing_record
    # metric-mutation ticks: observe() credits a handler that bumps
    # ANY metric while its clause runs; a class-level wrap is enough
    # (attribution by family is the window evaluation's job, done by
    # snapshot delta, not here)
    for cls, name in ((obs_metrics.Counter, "inc"),
                      (obs_metrics.Gauge, "set"),
                      (obs_metrics.Gauge, "inc"),
                      (obs_metrics.Gauge, "dec"),
                      (obs_metrics.Histogram, "observe")):
        orig = getattr(cls, name)

        def ticking(self, *args, _orig=orig, **kwargs):
            _STATE.ticks += 1
            return _orig(self, *args, **kwargs)

        _STATE.orig_metric_fns.append((cls, name, orig))
        setattr(cls, name, ticking)
    # stderr tee (write-through; pytest capture swaps around it are
    # tolerated — the metric pairing is the primary signal channel)
    _STATE.orig_stderr = sys.stderr
    sys.stderr = _StderrTee(sys.stderr)
    PLANE.on_arm.append(_on_arm)
    PLANE.on_disarm.append(_on_disarm)
    reset()


def uninstall() -> None:
    with _LOCK:
        if _STATE.installed == 0:
            return
        _STATE.installed -= 1
        if _STATE.installed:
            return
    if _on_arm in PLANE.on_arm:
        PLANE.on_arm.remove(_on_arm)
    if _on_disarm in PLANE.on_disarm:
        PLANE.on_disarm.remove(_on_disarm)
    if _STATE.orig_registry_init is not None:
        obs_metrics.MetricsRegistry.__init__ = \
            _STATE.orig_registry_init
        _STATE.orig_registry_init = None
    if _STATE.orig_flight_record is not None:
        FlightRecorder.record = _STATE.orig_flight_record
        _STATE.orig_flight_record = None
    for cls, name, orig in _STATE.orig_metric_fns:
        setattr(cls, name, orig)
    _STATE.orig_metric_fns = []
    if isinstance(sys.stderr, _StderrTee):
        sys.stderr = sys.stderr._inner
    _STATE.orig_stderr = None
    _STATE.registries = []
    _STATE.window = None


def installed() -> bool:
    return _STATE.installed > 0


def reset() -> None:
    """Drop windows, trips and coverage accounting (the registry /
    stderr / flight capture plumbing stays installed)."""
    _STATE.window = None
    _STATE.pending = []
    _STATE.trips = []
    _STATE.covered_events = 0
    _STATE.total_events = 0
    _STATE.stderr_lines = []
    _STATE.flight_tags = []


def flush() -> None:
    """Evaluate every closed window now (normally lazy)."""
    _evaluate_pending()


def trips() -> list[Trip]:
    _evaluate_pending()
    return list(_STATE.trips)


def signal_coverage() -> float:
    """Cumulative fired-events-with-a-signal ratio across every
    evaluated window since the last ``reset()`` (1.0 when nothing
    fired)."""
    _evaluate_pending()
    if _STATE.total_events == 0:
        return 1.0
    return _STATE.covered_events / _STATE.total_events


# ---------------------------------------------------------------------------
# observe(): the runtime handler-silence window (differential half)


@dataclasses.dataclass
class HandlerObservation:
    """One except clause seen executing during an observe() window."""

    relpath: str
    handler_key: str
    lineno: int
    count: int = 0
    silent_runs: int = 0        # completions with zero credit


class ObserveReport:
    """What an ``observe()`` window saw: every fail-scope handler
    that executed, with its runtime silence accounting."""

    def __init__(self) -> None:
        self.handlers: dict[tuple[str, str], HandlerObservation] = {}

    def observed(self) -> list[HandlerObservation]:
        return sorted(self.handlers.values(),
                      key=lambda h: (h.relpath, h.lineno))

    def runtime_silent(self) -> list[HandlerObservation]:
        """Handlers that completed at least one execution with NO
        credit — no metric bump, stderr write, flight record or
        re-raise while the clause ran."""
        return [h for h in self.observed() if h.silent_runs]

    def _note(self, relpath: str, handler_key: str, lineno: int,
              silent: bool) -> None:
        key = (relpath, handler_key)
        rec = self.handlers.get(key)
        if rec is None:
            rec = self.handlers[key] = HandlerObservation(
                relpath=relpath, handler_key=handler_key,
                lineno=lineno)
        rec.count += 1
        if silent:
            rec.silent_runs += 1


def _scope_handler_map() -> dict[str, list]:
    """abspath -> HandlerSite list for every fail-scope module,
    resolved through the static pass itself so the two halves share
    one keying (function-local import: testing must not depend on
    analysis at module level)."""
    from ..analysis.failcheck import (
        FAIL_SCOPE_COMPONENTS,
        module_handlers,
    )

    out: dict[str, list] = {}
    pkg = os.path.join(_REPO_ROOT, "fluidframework_tpu_torch")
    for comp in FAIL_SCOPE_COMPONENTS:
        root = os.path.join(pkg, comp)
        if not os.path.isdir(root):
            continue
        for dirpath, _dirs, files in os.walk(root):
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                abspath = os.path.join(dirpath, fn)
                relpath = abspath[len(_REPO_ROOT):].replace(
                    os.sep, "/")
                try:
                    with open(abspath, encoding="utf-8") as f:
                        tree = ast.parse(f.read(), filename=abspath)
                except (OSError, SyntaxError, ValueError):
                    continue
                sites = module_handlers(tree, relpath)
                if sites:
                    out[abspath] = [(s, relpath) for s in sites]
    return out


class _Observer:
    """The settrace window. Per-frame state machine: an 'exception'
    event marks a live exception; the first 'line' event inside an
    except-clause body is the handler executing; leaving the clause
    (or the frame) with the credit counter unmoved is a runtime-
    silent completion; a second 'exception' inside the clause is the
    re-raise (loud by definition)."""

    def __init__(self, report: ObserveReport):
        self.report = report
        self.scope = _scope_handler_map()
        self.frames: dict[int, dict] = {}
        self.prev_trace = None

    # -- handler-range lookup ------------------------------------------

    def _handler_at(self, abspath: str, lineno: int):
        best = None
        for site, relpath in self.scope.get(abspath, ()):
            if site.body_start <= lineno <= site.body_end:
                if best is None or site.body_start > best[0].body_start:
                    best = (site, relpath)
        return best

    # -- tracer --------------------------------------------------------

    def global_tracer(self, frame, event, arg):
        if event != "call":
            return None
        if frame.f_code.co_filename not in self.scope:
            return None
        return self.local_tracer

    def local_tracer(self, frame, event, arg):
        fid = id(frame)
        st = self.frames.get(fid)
        if st is None:
            st = self.frames[fid] = {"pending": False, "active": None}
        if event == "exception":
            active = st["active"]
            if active is not None and \
                    active[0][0].body_start <= frame.f_lineno \
                    <= active[0][0].body_end:
                # raised from within the clause: the loud re-raise
                self._finalize(st, silent=False)
            st["pending"] = True
        elif event == "line":
            active = st["active"]
            if active is not None:
                site = active[0][0]
                if not (site.body_start <= frame.f_lineno
                        <= site.body_end):
                    self._finalize(
                        st, silent=_STATE.ticks == active[1])
            if st["active"] is None and st["pending"]:
                hit = self._handler_at(
                    frame.f_code.co_filename, frame.f_lineno)
                if hit is not None:
                    st["active"] = (hit, _STATE.ticks)
                    st["pending"] = False
        elif event == "return":
            active = st["active"]
            if active is not None:
                self._finalize(st, silent=_STATE.ticks == active[1])
            self.frames.pop(fid, None)
        return self.local_tracer

    def _finalize(self, st: dict, silent: bool) -> None:
        (site, relpath), _ticks = st["active"]
        st["active"] = None
        self.report._note(relpath, site.handler_key, site.lineno,
                          silent)


class observe:
    """Context manager: trace fail-scope exception handlers for the
    duration, returning an :class:`ObserveReport`."""

    def __enter__(self) -> ObserveReport:
        if _STATE.observing:
            raise RuntimeError("failsan.observe() windows do not nest")
        _STATE.observing = True
        self.report = ObserveReport()
        self.observer = _Observer(self.report)
        self.observer.prev_trace = sys.gettrace()
        sys.settrace(self.observer.global_tracer)
        threading.settrace(self.observer.global_tracer)
        return self.report

    def __exit__(self, *exc) -> None:
        sys.settrace(self.observer.prev_trace)
        threading.settrace(None)
        _STATE.observing = False
        return None
