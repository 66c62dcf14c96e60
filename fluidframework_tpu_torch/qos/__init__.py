"""Quality of service of the port: admission control, backpressure and
circuit breaking — the layer that keeps the ordering service live at
10x offered load. Copies of the reference's ``qos`` modules:

- **Token-bucket rate limiters** (:mod:`.rate_limiter`) — per-tenant
  / per-document / per-connection budgets for ops, bytes, summary
  uploads and catch-up reads;
- **Composite pressure signal** (:mod:`.pressure`) — queue depths
  from across the pipeline normalized into one tier;
- **Shed policy + admission gate** (:mod:`.policy`,
  :mod:`.admission`) — pressure tier x traffic class -> admit or
  shed with an HONEST ``retry_after_seconds``;
- **Circuit breaker** (:mod:`.breaker`) — closed/open/half-open with
  probe admission around the merge sidecar's dispatch;
- **Fault plane** (:mod:`.faults`) — named injection sites at every
  recovery seam + seeded replayable fault schedules.

Layering: qos sits beside obs (above protocol); the service plane
imports it, it imports nothing it protects. Everything is clock-
injectable so overload behavior pins down in deterministic tests.
"""
from __future__ import annotations

from .admission import AdmissionController, RateLimits, default_limits
from .faults import (
    PLANE,
    FaultPlane,
    FaultSchedule,
    InjectionSite,
    TransientFault,
    TransientIOFault,
    standard_rates,
)
from .breaker import (
    STATE_CLOSED,
    STATE_HALF_OPEN,
    STATE_OPEN,
    BreakerOpenError,
    CircuitBreaker,
)
from .policy import (
    CLASS_CATCHUP,
    CLASS_SUMMARY,
    CLASS_WRITE,
    REASON_PRESSURE,
    REASON_RATE_LIMIT,
    SHED_ORDER,
    Admission,
    ShedPolicy,
)
from .pressure import (
    TIER_CRITICAL,
    TIER_ELEVATED,
    TIER_NAMES,
    TIER_NOMINAL,
    TIER_SEVERE,
    PressureMonitor,
    PressureReading,
)
from .rate_limiter import Budget, ScopedBuckets, TokenBucket

__all__ = [
    "Admission",
    "AdmissionController",
    "BreakerOpenError",
    "Budget",
    "CircuitBreaker",
    "FaultPlane",
    "FaultSchedule",
    "InjectionSite",
    "PLANE",
    "standard_rates",
    "TransientFault",
    "TransientIOFault",
    "CLASS_CATCHUP",
    "CLASS_SUMMARY",
    "CLASS_WRITE",
    "PressureMonitor",
    "PressureReading",
    "RateLimits",
    "REASON_PRESSURE",
    "REASON_RATE_LIMIT",
    "ScopedBuckets",
    "SHED_ORDER",
    "ShedPolicy",
    "STATE_CLOSED",
    "STATE_HALF_OPEN",
    "STATE_OPEN",
    "TIER_CRITICAL",
    "TIER_ELEVATED",
    "TIER_NAMES",
    "TIER_NOMINAL",
    "TIER_SEVERE",
    "TokenBucket",
    "default_limits",
]
