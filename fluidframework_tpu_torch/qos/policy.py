"""Shed policy: pressure tier x traffic class -> admit or shed.

The shed ORDER is the subsystem's core judgment call (docs/QOS.md):

1. **summary uploads** go first — they are bulk, deferrable, and a
   missed summary only costs catch-up time (the op log retains
   everything until the NEXT ack truncates it);
2. **read-only catch-up** goes second — readers tolerate staleness,
   and every shed read frees fanout + outbound-queue budget for
   writers;
3. **admitted writers** go last — a writer's op stream is the product;
   shedding it is service-survival mode only (CRITICAL).

Every shed answer carries an honest ``retry_after_seconds``: for
rate-limit sheds the limiter computes the exact bucket-refill wait;
for pressure sheds the policy scales a base backoff by tier, so
clients naturally sort themselves by how overloaded the service is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .pressure import TIER_CRITICAL, TIER_ELEVATED, TIER_SEVERE

# traffic classes, in shed order (first shed first)
CLASS_SUMMARY = "summary"
CLASS_CATCHUP = "catchup"
CLASS_WRITE = "write"
SHED_ORDER = (CLASS_SUMMARY, CLASS_CATCHUP, CLASS_WRITE)

# shed reasons (bounded metric label values)
REASON_RATE_LIMIT = "rate_limit"
REASON_PRESSURE = "pressure"
# quorum-loss degraded mode (service/replication.py): not a pressure
# tier — the service refuses the write because it cannot PROVE it
# durable (quorum unreachable) or cannot prove its own leadership
# (lease service unreachable past the TTL). Rides throttle nacks in
# the same OPTIONAL shed_class wire field as the pressure reasons
# (1.0/1.1 peers that ignore it interop — test_wire_compat), and the
# nack is retriable by construction: the op stays with its submitter
# and the reconnect/resubmit path replays it after the heal.
REASON_UNAVAILABLE = "unavailable"

DEFAULT_SHED_AT = {
    CLASS_SUMMARY: TIER_ELEVATED,
    CLASS_CATCHUP: TIER_SEVERE,
    CLASS_WRITE: TIER_CRITICAL,
}


@dataclass(frozen=True)
class Admission:
    """One admission decision. ``admitted=False`` always carries a
    nonzero ``retry_after_seconds`` and a reason; ``tier`` and
    ``shed_class`` ride throttle nacks as OPTIONAL wire fields
    (1.0/1.1 peers that ignore them interop — test_wire_compat)."""

    admitted: bool
    retry_after_seconds: float = 0.0
    reason: str = ""
    tier: int = 0
    shed_class: Optional[str] = None


class ShedPolicy:
    """tier -> which classes shed, and with what backoff hint."""

    def __init__(self, shed_at: Optional[dict] = None,
                 base_retry_s: float = 0.25,
                 max_retry_s: float = 8.0):
        self.shed_at = dict(DEFAULT_SHED_AT)
        if shed_at:
            unknown = set(shed_at) - set(SHED_ORDER)
            if unknown:
                raise ValueError(
                    f"unknown traffic classes {sorted(unknown)}; "
                    f"pick from {SHED_ORDER}"
                )
            self.shed_at.update(shed_at)
        self.base_retry_s = base_retry_s
        self.max_retry_s = max_retry_s

    def sheds(self, klass: str, tier: int) -> bool:
        return tier >= self.shed_at.get(klass, TIER_CRITICAL)

    def shed_classes(self, tier: int) -> tuple[str, ...]:
        return tuple(
            k for k in SHED_ORDER if self.sheds(k, tier)
        )

    def retry_after(self, tier: int) -> float:
        """Pressure-shed backoff hint: base * 2^(tier-1), capped —
        the deeper the overload, the longer clients stay away."""
        if tier <= 0:
            return self.base_retry_s
        return min(self.max_retry_s,
                   self.base_retry_s * (2 ** (tier - 1)))
