"""Composite backpressure signal: sampled queue depths -> one tier.

Sequencing is a serial bottleneck (one ordering authority per
document), so the honest load signal is not request rate but DEPTH:
how far behind the pipeline's queues are. This module aggregates any
number of registered depth sources — sequencer inbox, sidecar
``queued_ops``/dispatch backlog, broker fanout lag, per-session
outbound queues — into one normalized pressure value and a discrete
tier the policy engine (qos/policy.py) maps to actions.

Tiers (docs/QOS.md):

    0 NOMINAL    everything admitted (rate limits still apply)
    1 ELEVATED   shed summary uploads
    2 SEVERE     also shed read-only catch-up traffic
    3 CRITICAL   also shed admitted writers (service survival mode)

Each source normalizes as ``depth / capacity``; the composite value
is the MAX over sources (one saturated stage stalls the pipeline no
matter how idle the others are). Gauges land in
``obs.metrics.REGISTRY`` under bounded label sets — source names are
code-chosen, never derived from tenant/document input.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..obs import metrics as obs_metrics

TIER_NOMINAL = 0
TIER_ELEVATED = 1
TIER_SEVERE = 2
TIER_CRITICAL = 3

TIER_NAMES = ("nominal", "elevated", "severe", "critical")

_M_PRESSURE = obs_metrics.REGISTRY.gauge(
    "qos_pressure", "composite pressure (max normalized source depth)")
_M_TIER = obs_metrics.REGISTRY.gauge(
    "qos_pressure_tier", "pressure tier (0=nominal..3=critical)")
_M_SOURCE = obs_metrics.REGISTRY.gauge(
    "qos_pressure_source",
    "per-source normalized depth", labelnames=("source",))
_M_TRANSITIONS = obs_metrics.REGISTRY.counter(
    "qos_pressure_transitions_total",
    "tier changes observed by the monitor", labelnames=("to",))
_M_SOURCE_ERRORS = obs_metrics.REGISTRY.counter(
    "qos_pressure_source_errors_total",
    "pressure-source sampling callbacks that raised (source read 0)",
    labelnames=("source",))


@dataclass(frozen=True)
class PressureReading:
    """One sample: the composite value, its tier, per-source detail."""

    value: float
    tier: int
    by_source: dict = field(default_factory=dict)

    @property
    def tier_name(self) -> str:
        return TIER_NAMES[self.tier]


class PressureMonitor:
    """Registered depth sources -> PressureReading.

    ``min_interval_s`` rate-limits the sampling itself: at 10x
    offered load the admission gate runs per frame, and walking every
    source per frame would make the shed path cost what it sheds.
    0.0 (the default) samples every call — what deterministic tests
    want."""

    def __init__(self, *, elevated: float = 0.5, severe: float = 0.8,
                 critical: float = 1.0, min_interval_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        if not (0 < elevated <= severe <= critical):
            raise ValueError(
                f"tier thresholds must be ordered: "
                f"{elevated}/{severe}/{critical}"
            )
        self.thresholds = (elevated, severe, critical)
        self.min_interval_s = min_interval_s
        self._clock = clock
        self._sources: dict[str, tuple[Callable[[], float], float]] = {}
        self._cached: Optional[PressureReading] = None
        self._cached_at = float("-inf")
        # tier-transition log (bounded): what the SLO report cites as
        # overload context — "submit→ack burned through its budget
        # WHILE pressure sat at severe" is the sentence an operator
        # needs, and it requires the WHEN of each tier change
        self._last_tier = TIER_NOMINAL
        self.transitions: deque = deque(maxlen=64)
        self.transition_counts = [0, 0, 0, 0]

    # ------------------------------------------------------------------

    def add_source(self, name: str, sample: Callable[[], float],
                   capacity: float) -> None:
        """Register (or replace) a depth source. ``capacity`` is the
        depth that counts as saturated (ratio 1.0 = CRITICAL)."""
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self._sources[name] = (sample, float(capacity))
        self._cached = None

    def ensure_source(self, name: str, sample: Callable[[], float],
                      capacity: float) -> None:
        """add_source unless ``name`` is already registered — default
        wiring must not clobber an operator-supplied source."""
        if name not in self._sources:
            self.add_source(name, sample, capacity)

    def remove_source(self, name: str) -> None:
        self._sources.pop(name, None)
        self._cached = None

    @property
    def sources(self) -> tuple[str, ...]:
        return tuple(self._sources)

    # ------------------------------------------------------------------

    def tier_of(self, value: float) -> int:
        elevated, severe, critical = self.thresholds
        if value >= critical:
            return TIER_CRITICAL
        if value >= severe:
            return TIER_SEVERE
        if value >= elevated:
            return TIER_ELEVATED
        return TIER_NOMINAL

    def sample(self) -> PressureReading:
        now = self._clock()
        if (
            self._cached is not None
            and now - self._cached_at < self.min_interval_s
        ):
            return self._cached
        by_source: dict[str, float] = {}
        worst = 0.0
        for name, (fn, capacity) in self._sources.items():
            try:
                ratio = max(0.0, float(fn())) / capacity
            except Exception:  # noqa: BLE001 - a dead source reads 0
                # a sampling fault must not take the admission gate
                # down with it; the source simply stops contributing —
                # but a silently-dead source under-reports pressure
                # forever, so count every faulted sample
                _M_SOURCE_ERRORS.labels(source=name).inc()
                ratio = 0.0
            by_source[name] = ratio
            _M_SOURCE.labels(source=name).set(ratio)
            if ratio > worst:
                worst = ratio
        reading = PressureReading(
            value=worst, tier=self.tier_of(worst), by_source=by_source,
        )
        _M_PRESSURE.set(worst)
        _M_TIER.set(reading.tier)
        if reading.tier != self._last_tier:
            self.transitions.append(
                (now, self._last_tier, reading.tier)
            )
            self.transition_counts[reading.tier] += 1
            _M_TRANSITIONS.labels(
                to=TIER_NAMES[reading.tier]).inc()
            self._last_tier = reading.tier
        self._cached = reading
        self._cached_at = now
        return reading

    def tier(self) -> int:
        return self.sample().tier

    def context(self) -> dict:
        """Overload context for SLO reports (SloEngine.add_context):
        current tier + the recent transition trail."""
        reading = self.sample()
        return {
            "tier": reading.tier,
            "tier_name": reading.tier_name,
            "value": round(reading.value, 4),
            "by_source": {
                k: round(v, 4) for k, v in reading.by_source.items()
            },
            "transition_counts": {
                TIER_NAMES[i]: c
                for i, c in enumerate(self.transition_counts) if c
            },
            "recent_transitions": [
                {"t": t, "from": TIER_NAMES[a], "to": TIER_NAMES[b]}
                for t, a, b in list(self.transitions)[-8:]
            ],
        }
