"""The deterministic process-wide fault-injection plane.

A copy of the reference's ``qos/faults.py``. Faults are not random monkey-testing: they are a SEEDED,
REPLAYABLE schedule fired at NAMED seams. Every recovery seam of the
port's serving plane registers an :class:`InjectionSite` here — the
merge sidecar's dispatch (``sidecar.dispatch``), the pools' dispatch,
admission and migration (``sidecar.pool_dispatch``,
``sidecar.pool_admit``, ``sidecar.pool_migrate``), the tree
sidecar's dispatch (``tree_sidecar.dispatch``) and the durable store's
checkpoint write, op-log append and bit rot (``storage.checkpoint_write``,
``storage.oplog_append``, ``storage.bitrot``), the ingress's summary
upload (``ingress.summary_upload``), the socket driver's frames
(``socket.frame_in``, ``socket.frame_out``) and the scripted frames of
``testing/fault_injection.py`` (``testing.scripted_frame``), under the
reference's site and kind names. ``standard_rates`` keeps the
reference's whole mix, sites of layers the port has not copied yet
included. A site consults the plane at its seam; when a
:class:`FaultSchedule` is armed, the plane's seeded per-site decision
stream says which fault kind (if any) fires at that event, and
``push`` scripts one regardless. Disarmed and unscripted, a site costs
one attribute read.

Determinism contract: decisions are drawn from an INDEPENDENT seeded
stream per site, keyed by (schedule seed, site name) and consumed one
draw per site event — so the injection sequence depends only on each
site's own event order, never on how unrelated sites interleave.
``plane.fired`` is that sequence, and a failing run reproduces from
the printed seed alone.

Loudness: every injected fault increments
``chaos_injected_total{site,kind}`` and lands in the plane's flight
recorder (which carries the schedule seed from arm time), so a chaos
run can never fire silently.

Layering: qos sits above obs/protocol only — this module imports
nothing it injects into; the seams pull the plane in.
"""
from __future__ import annotations

import random
from typing import Optional

from ..obs import metrics as obs_metrics
from ..obs.flight_recorder import FlightRecorder

# ----------------------------------------------------------------------
# the one injection vocabulary (testing/fault_injection.py speaks it
# too — satellite fold; docs/ROBUSTNESS.md has the kind x site matrix)

KIND_DROP = "drop"              # frame vanishes (slow-consumer shape)
KIND_DUPLICATE = "duplicate"    # delivered twice (at-least-once shape)
KIND_REORDER = "reorder"        # held past the next frame
KIND_DELAY = "delay"            # held until the next pump
KIND_DISCONNECT = "disconnect"  # transport torn down, no goodbye
KIND_NACK = "nack"              # injected throttle nack, op dropped
KIND_ERROR = "error"            # one transient exception
KIND_ERROR_BURST = "error_burst"  # N consecutive errors (breaker trip)
KIND_DEFER = "defer"            # skip this opportunity, retry later
KIND_TORN_WRITE = "torn_write"  # prefix-truncated bytes (crash state)
KIND_CORRUPT = "corrupt"        # insane length prefix on the wire
KIND_PARTITION = "partition"    # links between islands go dark
KIND_HEAL = "heal"              # a partition's links come back

#: how many consecutive events an ``error_burst`` poisons once fired —
#: sized past every breaker failure_threshold in the tree (3) so one
#: burst provably trips it
BURST_LENGTH = 4

_M_INJECTED = obs_metrics.REGISTRY.counter(
    "chaos_injected_total",
    "faults the chaos plane injected, by site and kind",
    labelnames=("site", "kind"))
_M_ARMED = obs_metrics.REGISTRY.gauge(
    "chaos_armed", "1 while a fault schedule is armed")
_M_SITES = obs_metrics.REGISTRY.gauge(
    "chaos_sites_registered", "injection sites registered")


class TransientFault(Exception):
    """The exception ``error``/``error_burst`` faults raise — shaped
    like the transient faults the seams already survive (the sidecar
    breaker records it; storage paths catch OSError subclasses where
    they must, so sites that need OSError semantics raise
    :class:`TransientIOFault`)."""


class TransientIOFault(TransientFault, OSError):
    """Transient fault for seams whose recovery contract is keyed on
    OSError (checkpoint writes behind the storage breaker)."""


class FaultSchedule:
    """A seeded, replayable fault schedule.

    ``rates`` maps site name -> {kind: probability per site event}.
    Kinds a site does not support are ignored at fire time (the site
    declares its vocabulary), so one schedule can carry a standard
    rate table across harnesses with different site subsets.
    ``max_per_site`` bounds injections per site so a long run cannot
    drown in faults; ``None`` = unbounded.
    """

    def __init__(self, seed: int,
                 rates: Optional[dict[str, dict[str, float]]] = None,
                 max_per_site: Optional[int] = None):
        self.seed = seed
        self.rates = dict(rates or {})
        self.max_per_site = max_per_site

    def stream_for(self, site_name: str) -> random.Random:
        """The site's independent decision stream. Keyed by (seed,
        site) so cross-site interleaving cannot perturb decisions."""
        return random.Random(f"{self.seed}:{site_name}")

    def rng_for(self, purpose: str) -> random.Random:
        """A seeded stream for HARNESS decisions derived from the same
        seed (crash step, tear mode, reconnect delays) — everything a
        failing seed needs to reproduce rides the one number."""
        return random.Random(f"{self.seed}/{purpose}")

    def __repr__(self) -> str:
        return (f"FaultSchedule(seed={self.seed}, "
                f"rates={self.rates!r}, "
                f"max_per_site={self.max_per_site})")


class InjectionSite:
    """One named seam. ``fire()`` at the seam returns the fault kind
    to apply (or None); ``push()`` queues a scripted injection (the
    faultInjectionDriver vocabulary: injectNack/injectDisconnect) that
    fires at the next event regardless of any armed schedule;
    ``force()`` records an injection the caller already decided on
    (the harness's crash-time torn writes)."""

    def __init__(self, plane: "FaultPlane", name: str,
                 kinds: tuple[str, ...]):
        self.plane = plane
        self.name = name
        self.kinds = tuple(kinds)
        self.events = 0          # seam consultations (armed or not)
        self.injected = 0
        self._scripted: list[str] = []
        self._burst_remaining = 0
        # per-arm decision stream (None while disarmed)
        self._stream: Optional[random.Random] = None

    # -- scripted injections (fault_injection.py fold) ------------------

    def push(self, kind: str, count: int = 1) -> None:
        if kind not in self.kinds:
            raise ValueError(
                f"site {self.name!r} does not speak {kind!r} "
                f"(kinds: {self.kinds})")
        self._scripted.extend([kind] * count)

    @property
    def scripted_pending(self) -> int:
        return len(self._scripted)

    # -- the seam consultation ------------------------------------------

    def fire(self, **context) -> Optional[str]:
        """Consult the seam: one event, at most one fault."""
        self.events += 1
        if self._scripted:
            return self._record(self._scripted.pop(0), context)
        if self._burst_remaining > 0:
            self._burst_remaining -= 1
            return self._record(KIND_ERROR, context, burst=True)
        schedule = self.plane.schedule
        if schedule is None or self._stream is None:
            return None
        rates = schedule.rates.get(self.name)
        if not rates:
            return None
        if (schedule.max_per_site is not None
                and self.injected >= schedule.max_per_site):
            return None
        # ONE draw per event, consumed whether or not a fault fires —
        # the decision stream's position is a pure function of the
        # site's event count, so adding a kind to the rate table
        # never shifts later decisions of other kinds
        r = self._stream.random()
        acc = 0.0
        for kind in self.kinds:
            p = rates.get(kind, 0.0)
            if p <= 0.0:
                continue
            acc += p
            if r < acc:
                if kind == KIND_ERROR_BURST:
                    self._burst_remaining = BURST_LENGTH - 1
                return self._record(kind, context)
        return None

    def force(self, kind: str, **context) -> str:
        """Record an injection the caller performs itself (crash-time
        torn writes enumerated by the harness): counted and
        flight-recorded like any fired fault."""
        self.events += 1
        return self._record(kind, context)

    def _record(self, kind: str, context: dict,
                burst: bool = False) -> str:
        self.injected += 1
        _M_INJECTED.labels(site=self.name, kind=kind).inc()
        self.plane.fired.append((self.name, self.events, kind))
        self.plane.flight.record(
            "inject", site=self.name, fault=kind, event=self.events,
            burst=burst, **{k: v for k, v in context.items()
                            if isinstance(v, (int, float, str, bool))})
        return kind

    def transient(self, kind: str) -> TransientFault:
        """The exception an ``error`` fault raises at this seam."""
        return TransientFault(
            f"chaos[{self.name}]: injected {kind} "
            f"(event {self.events})")

    def _arm(self, schedule: Optional[FaultSchedule]) -> None:
        self._stream = (schedule.stream_for(self.name)
                        if schedule is not None else None)
        self._burst_remaining = 0
        self.events = 0
        self.injected = 0


class FaultPlane:
    """The process-wide site registry + armed schedule."""

    def __init__(self) -> None:
        self._sites: dict[str, InjectionSite] = {}
        self.schedule: Optional[FaultSchedule] = None
        #: (site, site-event-index, kind) in firing order — the
        #: replayable injection sequence the determinism test pins
        self.fired: list[tuple[str, int, str]] = []
        self.flight = FlightRecorder(512, name="chaos")
        #: observer hooks (testing/failsan.py registers here — qos
        #: imports nothing above itself, so the observers come to the
        #: plane): ``on_arm`` callbacks get the schedule AFTER the
        #: sites are armed; ``on_disarm`` callbacks get the plane
        #: BEFORE the schedule is cleared, so they can read the seed
        #: and the fired log of the window that is ending
        self.on_arm: list = []
        self.on_disarm: list = []

    def site(self, name: str,
             kinds: tuple[str, ...] = ()) -> InjectionSite:
        """Register (or fetch) a site. Registration is idempotent;
        a re-registration may only widen the kind vocabulary."""
        existing = self._sites.get(name)
        if existing is not None:
            for kind in kinds:
                if kind not in existing.kinds:
                    existing.kinds = existing.kinds + (kind,)
            return existing
        site = InjectionSite(self, name, kinds)
        self._sites[name] = site
        _M_SITES.set(len(self._sites))
        if self.schedule is not None:
            # a seam first imported AFTER arm() (lazy imports mid-run)
            # must still get its decision stream, or the armed
            # schedule silently never fires there — the exact silent
            # hole the plane's loudness contract exists to close
            site._arm(self.schedule)
        return site

    def sites(self) -> dict[str, InjectionSite]:
        return dict(self._sites)

    @property
    def armed(self) -> bool:
        return self.schedule is not None

    def arm(self, schedule: FaultSchedule) -> None:
        """Arm a schedule: resets every site's event counter and
        decision stream so the injection sequence is a pure function
        of the seed, and records the seed in the flight recorder (a
        dump from any later fault carries it)."""
        self.schedule = schedule
        self.fired = []
        for site in self._sites.values():
            site._arm(schedule)
        _M_ARMED.set(1)
        self.flight.record("arm", seed=schedule.seed,
                           rates=str(sorted(schedule.rates)))
        for hook in list(self.on_arm):
            hook(schedule)

    def disarm(self) -> None:
        if self.schedule is not None:
            self.flight.record("disarm", seed=self.schedule.seed,
                               fired=len(self.fired))
            for hook in list(self.on_disarm):
                hook(self)
        self.schedule = None
        for site in self._sites.values():
            site._arm(None)
        _M_ARMED.set(0)

    class _Armed:
        def __init__(self, plane: "FaultPlane",
                     schedule: FaultSchedule):
            self.plane = plane
            self.schedule = schedule

        def __enter__(self) -> "FaultPlane":
            self.plane.arm(self.schedule)
            return self.plane

        def __exit__(self, *exc) -> None:
            self.plane.disarm()

    def while_armed(self, schedule: FaultSchedule) -> "_Armed":
        return self._Armed(self, schedule)


#: THE process-wide plane every seam registers against
PLANE = FaultPlane()


def standard_rates(sites: Optional[list[str]] = None
                   ) -> dict[str, dict[str, float]]:
    """The standard chaos mix (tools/stress --chaos, bench config11,
    the convergence differential): moderate rates at every seam,
    tuned so a ~100-event run fires a handful of faults per armed
    site. ``sites`` filters to a subset (--sites a,b)."""
    rates = {
        "socket.frame_in": {
            KIND_DROP: 0.08, KIND_DUPLICATE: 0.08,
            KIND_REORDER: 0.06, KIND_DELAY: 0.05,
        },
        "socket.frame_out": {
            KIND_DISCONNECT: 0.02, KIND_NACK: 0.03,
        },
        "broker.queue_append": {KIND_ERROR: 0.02},
        "broker.queue_consume": {KIND_DUPLICATE: 0.05},
        "storage.checkpoint_write": {
            KIND_ERROR: 0.02, KIND_ERROR_BURST: 0.01,
        },
        "sidecar.dispatch": {
            KIND_ERROR: 0.04, KIND_ERROR_BURST: 0.01,
        },
        "sidecar.pool_dispatch": {KIND_DEFER: 0.20},
        "sidecar.pool_admit": {KIND_ERROR: 0.25},
        "sidecar.pool_migrate": {KIND_DEFER: 0.25},
        "ingress.summary_upload": {KIND_ERROR: 0.30},
        # replicated sequencer seams (service/replication.py +
        # partitioning's queue counterpart): follower lag, lost/
        # erroring acks, lease renewal loss + spurious lapse (the
        # split-brain trigger), transient election failures
        "repl.lag": {KIND_DEFER: 0.15},
        "repl.append_ack": {KIND_DROP: 0.04, KIND_ERROR: 0.02},
        "repl.lease_expire": {KIND_DROP: 0.03, KIND_ERROR: 0.01},
        "repl.promote": {KIND_ERROR: 0.25},
    }
    if sites is not None:
        unknown = set(sites) - set(rates)
        if unknown:
            raise ValueError(
                f"unknown chaos sites {sorted(unknown)}; known: "
                f"{sorted(rates)}")
        rates = {k: v for k, v in rates.items() if k in sites}
    return rates
