"""Serving SLOs: declarative objectives over the metrics registry,
graded with multi-window burn rates.

Hop traces, registry histograms and flight recorders are raw
telemetry; nothing among them *interprets* it. This module is
the interpretation layer: an :class:`Objective` binds a latency bound
(or a goodput floor) to families already registered in
``obs.metrics.REGISTRY``, and the :class:`SloEngine` turns the
registry's cumulative counts into windowed **burn rates** — the rate
at which the objective's error budget is being consumed, normalized
so 1.0 means "burning exactly the budget" (Google SRE workbook,
multi-window multi-burn-rate alerting).

Two windows are evaluated per objective, a FAST one (reacts to acute
breakage) and a SLOW one (filters blips): the verdict is ``breach``
only when BOTH windows burn past the threshold, ``warn`` when only
the fast one does, ``ok`` otherwise. Production SRE practice uses
5m/1h; the serving harness (tools/serve_bench.py) keeps the same
1:12 ratio on its simulated clock. The engine is clock-injectable
like the qos stack, so the whole grading pipeline is deterministic
under a manual clock.

Latency objectives snap their threshold to the histogram's nearest
bucket bound at or above the requested value (cumulative ``le``
buckets are the only thing a Prometheus-semantics histogram can
answer exactly); the effective bound is reported so nobody mistakes
the snap for the ask.

On a transition into ``breach`` the engine increments
``slo_breach_total{objective}`` and dumps every registered flight
recorder plus profiler — the postmortem is captured at the moment
the objective is lost, not when a human notices.

Per-hop latency budgets (rather than one end-to-end number) follow
the collab-window/latency framing of "On Coordinating Collaborative
Objects": the ledger → histogram bridge (``op_hop_ms{hop}``,
runtime/op_lifecycle.py) gives every canonical hop its own
histogram, so an objective can bind to a single hop's budget.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from . import metrics as obs_metrics

_M_BREACH = obs_metrics.REGISTRY.counter(
    "slo_breach_total", "objectives that entered breach",
    labelnames=("objective",))
_M_BURN = obs_metrics.REGISTRY.gauge(
    "slo_burn_rate", "fast-window burn rate per objective",
    labelnames=("objective",))

VERDICT_OK = "ok"
VERDICT_WARN = "warn"
VERDICT_BREACH = "breach"

# 5m fast / 1h slow — the production default; harnesses on a manual
# clock scale both while keeping the 1:12 ratio
DEFAULT_FAST_WINDOW_S = 300.0
DEFAULT_SLOW_WINDOW_S = 3600.0


@dataclass(frozen=True)
class Objective:
    """One declarative objective.

    ``kind="latency"``: ``metric`` names a REGISTERED histogram;
    an observation above ``threshold_ms`` is a bad event and at
    least ``target`` of events must be good.

    ``kind="goodput"``: ``good_metric``/``total_metric`` name
    REGISTERED counters; the good/total ratio must stay >= ``target``
    (e.g. acked vs offered ops — a goodput floor).

    ``labels`` selects one series of a labelled family ({} = the
    anonymous series). Metric names must be string literals where
    declared: fluidlint's ``slo-unbound-objective`` rule statically
    checks each literal against the registry's registered names.
    """

    name: str
    metric: str = ""
    threshold_ms: float = 0.0
    target: float = 0.99
    kind: str = "latency"
    good_metric: str = ""
    total_metric: str = ""
    labels: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in ("latency", "goodput"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if not (0.0 < self.target < 1.0):
            raise ValueError(
                f"target must be in (0, 1), got {self.target}"
            )
        if self.kind == "latency" and not self.metric:
            raise ValueError("latency objective needs metric=")
        if self.kind == "goodput" and not (
                self.good_metric and self.total_metric):
            raise ValueError(
                "goodput objective needs good_metric= and total_metric="
            )


class _BoundObjective:
    """An Objective resolved against live registry children."""

    def __init__(self, obj: Objective,
                 registry: obs_metrics.MetricsRegistry):
        self.obj = obj
        if obj.kind == "latency":
            fam = registry.get(obj.metric)
            if fam is None or fam.kind != "histogram":
                raise ValueError(
                    f"objective {obj.name!r}: metric {obj.metric!r} "
                    "is not a registered histogram in obs.metrics "
                    "(register it before declaring the objective — "
                    "fluidlint slo-unbound-objective)"
                )
            self._hist = (
                fam.labels(**obj.labels) if obj.labels else fam._solo()
            )
            # snap to the smallest bucket bound >= threshold: the
            # cumulative le counts are exact there and nowhere else
            snapped = next(
                (b for b in self._hist.buckets
                 if b >= obj.threshold_ms),
                None,
            )
            if snapped is None:
                raise ValueError(
                    f"objective {obj.name!r}: threshold "
                    f"{obj.threshold_ms}ms is above every bucket of "
                    f"{obj.metric!r} (top bucket "
                    f"{self._hist.buckets[-1]}) — add a bucket or "
                    "lower the threshold"
                )
            self.effective_threshold_ms = snapped
        else:
            self._good = self._counter(registry, obj.good_metric, obj)
            self._total = self._counter(registry, obj.total_metric, obj)
            self.effective_threshold_ms = None

    @staticmethod
    def _counter(registry, name: str, obj: Objective):
        fam = registry.get(name)
        if fam is None or fam.kind != "counter":
            raise ValueError(
                f"objective {obj.name!r}: {name!r} is not a "
                "registered counter in obs.metrics"
            )
        return fam.labels(**obj.labels) if obj.labels else fam._solo()

    def cumulative(self) -> tuple[float, float]:
        """(bad_events, total_events) since process start. Both
        branches clamp good <= total: the two reads are not atomic
        against a concurrent observe/inc, and a momentary good >
        total would store a NEGATIVE bad count in the sample ring —
        later surfacing as a spurious bad event and a false breach."""
        if self.obj.kind == "latency":
            total = self._hist.count
            good = min(
                self._hist.count_le(self.effective_threshold_ms),
                total,
            )
            return float(total - good), float(total)
        total = self._total.value
        good = min(self._good.value, total)
        return float(total - good), float(total)


class SloEngine:
    """Samples objective counters over time and grades burn rates.

    ``tick()`` records one (timestamp, cumulative-counts) sample per
    objective into a bounded ring; ``evaluate()`` computes, for each
    window, the bad/total delta between now and the oldest retained
    sample inside the window, and from it the burn rate

        burn = (bad/total) / (1 - target)

    so burn 1.0 = consuming exactly the error budget, >1 = on track
    to exhaust it before the window ends. A window with no events
    reads burn 0 (nothing served = nothing burned; the goodput floor
    is the objective that catches a stalled service, via its offered
    counter).
    """

    def __init__(self, objectives: Sequence[Objective] = (),
                 *, fast_window_s: float = DEFAULT_FAST_WINDOW_S,
                 slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
                 max_burn: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 max_samples: int = 4096,
                 refresh: Optional[Callable[[], object]] = None):
        if not (0 < fast_window_s <= slow_window_s):
            raise ValueError(
                f"windows must be ordered: fast {fast_window_s} / "
                f"slow {slow_window_s}"
            )
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.max_burn = max_burn
        self._clock = clock
        self._registry = registry or obs_metrics.REGISTRY
        # the federation hook: a zero-arg callable run at the top of
        # every tick(). Binding the engine to a FederatedView's output
        # registry with refresh=view.refresh lets one objective grade
        # the WHOLE plane — a per-partition goodput floor over merged
        # counters — through the exact same burn-rate machinery
        # (docs/OBSERVABILITY.md "Fleet observability"). Call
        # view.refresh() once BEFORE construction so the families the
        # objectives bind to exist.
        self._refresh = refresh
        self._bound: dict[str, _BoundObjective] = {}
        # name -> ring of (t, bad, total); bounded — an engine left
        # ticking for days must not grow without bound
        self._samples: dict[str, deque] = {}
        self._max_samples = max_samples
        self._last_tick = float("-inf")
        self._breached: set[str] = set()
        # context sources: name -> zero-arg callable sampled into the
        # report (qos pressure tier, route split, ...)
        self._context: dict[str, Callable[[], object]] = {}
        # dumped on a transition into breach (flight recorders, the
        # profiler, ...): anything with dump_to(reason=...)
        self._dump_targets: list = []
        for obj in objectives:
            self.add_objective(obj)

    # ------------------------------------------------------------------

    def add_objective(self, obj: Objective) -> None:
        if obj.name in self._bound:
            raise ValueError(f"duplicate objective {obj.name!r}")
        self._bound[obj.name] = _BoundObjective(obj, self._registry)
        self._samples[obj.name] = deque(maxlen=self._max_samples)

    @property
    def objectives(self) -> tuple[str, ...]:
        return tuple(self._bound)

    def add_context(self, name: str,
                    sample: Callable[[], object]) -> None:
        """Attach a context source sampled into every report (e.g.
        the qos pressure tier at evaluation time)."""
        self._context[name] = sample

    def add_dump_target(self, target) -> None:
        """Register a flight recorder / profiler whose ``dump_to``
        runs when any objective transitions into breach."""
        self._dump_targets.append(target)

    # ------------------------------------------------------------------

    def tick(self) -> None:
        """Record one sample per objective at the current clock."""
        if self._refresh is not None:
            self._refresh()  # federated registries re-merge first
        now = self._clock()
        self._last_tick = now
        for name, bound in self._bound.items():
            bad, total = bound.cumulative()
            self._samples[name].append((now, bad, total))

    def maybe_tick(self, min_interval_s: float = 1.0) -> None:
        """tick() at most every ``min_interval_s`` — cheap enough to
        piggyback on a per-frame dispatch path."""
        if self._clock() - self._last_tick >= min_interval_s:
            self.tick()

    def _window_burn(self, name: str, window_s: float,
                     now: float) -> dict:
        """Burn over [now - window_s, now] from the retained ring."""
        ring = self._samples[name]
        bad1, total1 = self._bound[name].cumulative()
        # oldest retained sample still inside the window; fall back
        # to the window edge itself (zero history = zero delta)
        base = None
        for t, bad, total in ring:
            if t >= now - window_s:
                base = (bad, total)
                break
        if base is None:
            base = (bad1, total1)
        d_bad = max(0.0, bad1 - base[0])
        d_total = max(0.0, total1 - base[1])
        target = self._bound[name].obj.target
        bad_fraction = d_bad / d_total if d_total else 0.0
        burn = bad_fraction / (1.0 - target)
        return {
            "window_s": window_s,
            "bad": d_bad,
            "total": d_total,
            "bad_fraction": round(bad_fraction, 6),
            "burn": round(burn, 4),
        }

    def evaluate(self) -> dict:
        """The ``slo_report``: per-objective verdicts + context."""
        now = self._clock()
        out = {
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "max_burn": self.max_burn,
            "objectives": [],
        }
        newly_breached = []
        for name, bound in self._bound.items():
            fast = self._window_burn(name, self.fast_window_s, now)
            slow = self._window_burn(name, self.slow_window_s, now)
            if fast["burn"] > self.max_burn \
                    and slow["burn"] > self.max_burn:
                verdict = VERDICT_BREACH
            elif fast["burn"] > self.max_burn:
                verdict = VERDICT_WARN
            else:
                verdict = VERDICT_OK
            _M_BURN.labels(objective=name).set(fast["burn"])
            if verdict == VERDICT_BREACH:
                if name not in self._breached:
                    self._breached.add(name)
                    _M_BREACH.labels(objective=name).inc()
                    newly_breached.append(name)
            elif verdict == VERDICT_OK:
                # the latch clears on OK only: an objective
                # oscillating breach<->warn at the threshold must not
                # re-count the breach and re-dump every recorder on
                # each swing (the dump captures ONE postmortem per
                # lost objective, not a storm)
                self._breached.discard(name)
            obj = bound.obj
            rec = {
                "name": name,
                "kind": obj.kind,
                "target": obj.target,
                "fast": fast,
                "slow": slow,
                "verdict": verdict,
            }
            if obj.kind == "latency":
                rec["metric"] = obj.metric
                rec["threshold_ms"] = obj.threshold_ms
                rec["effective_threshold_ms"] = \
                    bound.effective_threshold_ms
            else:
                rec["good_metric"] = obj.good_metric
                rec["total_metric"] = obj.total_metric
            out["objectives"].append(rec)
        out["context"] = {}
        for name, sample in self._context.items():
            try:
                out["context"][name] = sample()
            except Exception as e:  # noqa: BLE001 - context is best-effort
                out["context"][name] = f"<error: {type(e).__name__}>"
        if newly_breached:
            self._dump_all(newly_breached)
        return out

    def report(self) -> dict:
        """tick + evaluate — the lazy entry point the ingress ``slo``
        frame and ``--dump-slo`` use (a live service's report is only
        as granular as how often someone asks, which is exactly the
        scrape model)."""
        self.tick()
        return self.evaluate()

    def _dump_all(self, breached: list) -> None:
        reason = "slo breach: " + ", ".join(sorted(breached))
        for target in self._dump_targets:
            try:
                target.dump_to(reason=reason)
            except Exception:  # noqa: BLE001 - a postmortem dump must
                pass  # never turn a breach into a crash


# The service-plane default objectives live in service/ingress.py
# (default_slo_objectives): objectives bind to histograms OWNED by
# the service layer, and obs — by the layer map — must never import
# what it observes.
