"""AdmissionController: the one gate ingress consults per frame.

Composes the three qos pieces — scoped token buckets
(qos/rate_limiter.py), the composite pressure signal
(qos/pressure.py) and the shed policy (qos/policy.py) — into a
single ``admit()`` call answering: may this (class, tenant, document,
connection, ops, bytes) proceed, and if not, when should the caller
retry?

Decision order:

1. PRESSURE first: if the current tier sheds this traffic class, the
   request never touches the buckets (an overloaded service must not
   spend per-scope bucket work on traffic it is about to refuse).
2. RATE LIMITS second: every applicable bucket is peeked BEFORE any
   is charged — a partial take would bill callers for refused work —
   and the worst bucket's exact refill wait becomes
   ``retry_after_seconds``.

Admitted work is charged to every bucket it consulted.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..obs import metrics as obs_metrics
from .policy import (
    CLASS_CATCHUP,
    CLASS_SUMMARY,
    CLASS_WRITE,
    REASON_PRESSURE,
    REASON_RATE_LIMIT,
    Admission,
    ShedPolicy,
)
from .pressure import PressureMonitor
from .rate_limiter import Budget, ScopedBuckets

_M_ADMITTED = obs_metrics.REGISTRY.counter(
    "qos_admitted_total", "requests the admission gate let through",
    labelnames=("klass",))
_M_SHED = obs_metrics.REGISTRY.counter(
    "qos_shed_total", "requests refused with a throttle response",
    labelnames=("klass", "reason"))


@dataclass(frozen=True)
class RateLimits:
    """Budget per (scope, dimension); ``None`` = that limit is off.

    Scopes: *connection* (one TCP session), *document*, *tenant*
    (anonymous deployments share the "" tenant, making tenant budgets
    effectively global). Dimensions: ops, bytes, summary uploads,
    catch-up reads."""

    connection_ops: Optional[Budget] = None
    document_ops: Optional[Budget] = None
    tenant_ops: Optional[Budget] = None
    connection_bytes: Optional[Budget] = None
    tenant_bytes: Optional[Budget] = None
    summary_uploads: Optional[Budget] = None   # per tenant, count
    summary_bytes: Optional[Budget] = None     # per tenant
    catchup_reads: Optional[Budget] = None     # per connection, count


def default_limits(ops_per_sec: float = 2000.0) -> RateLimits:
    """The ``--qos`` flag's defaults: per-connection op/byte budgets
    sized for one busy interactive client, per-document and
    per-tenant budgets an order above (many clients share them), and
    modest summary/catch-up budgets — summaries are bulk work."""
    return RateLimits(
        connection_ops=Budget(ops_per_sec),
        document_ops=Budget(ops_per_sec * 4),
        tenant_ops=Budget(ops_per_sec * 16),
        connection_bytes=Budget(ops_per_sec * 1024),
        tenant_bytes=Budget(ops_per_sec * 16 * 1024),
        summary_uploads=Budget(4.0, burst=8.0),
        summary_bytes=Budget(8 << 20),
        catchup_reads=Budget(50.0, burst=100.0),
    )


class AdmissionController:
    def __init__(self, limits: Optional[RateLimits] = None,
                 pressure: Optional[PressureMonitor] = None,
                 policy: Optional[ShedPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.limits = limits or RateLimits()
        self.pressure = pressure
        self.policy = policy or ShedPolicy()
        self._clock = clock
        self._buckets: dict[str, ScopedBuckets] = {
            dim: ScopedBuckets(budget, clock)
            for dim, budget in vars(self.limits).items()
            if budget is not None
        }

    # ------------------------------------------------------------------

    def _demands(self, klass: str, tenant: str, document: str,
                 connection: str, ops: float, nbytes: float
                 ) -> list[tuple[ScopedBuckets, str, float]]:
        """(bucket-set, scope key, amount) triples this request must
        clear. Zero amounts are skipped (a 0-byte op must not charge
        the byte buckets a refill wait of 0/rate)."""
        spec = {
            CLASS_WRITE: (
                ("connection_ops", connection, ops),
                ("document_ops", document, ops),
                ("tenant_ops", tenant, ops),
                ("connection_bytes", connection, nbytes),
                ("tenant_bytes", tenant, nbytes),
            ),
            CLASS_SUMMARY: (
                ("summary_uploads", tenant, ops),
                ("summary_bytes", tenant, nbytes),
            ),
            CLASS_CATCHUP: (
                ("catchup_reads", connection, ops),
            ),
        }[klass]
        return [
            (self._buckets[dim], key, amount)
            for dim, key, amount in spec
            if amount > 0 and dim in self._buckets
        ]

    def admit(self, klass: str, *, tenant: str = "",
              document: str = "", connection: str = "",
              ops: float = 1.0, nbytes: float = 0.0) -> Admission:
        tier = 0
        if self.pressure is not None:
            tier = self.pressure.tier()
            if self.policy.sheds(klass, tier):
                _M_SHED.labels(klass=klass, reason=REASON_PRESSURE
                               ).inc()
                return Admission(
                    admitted=False,
                    retry_after_seconds=self.policy.retry_after(tier),
                    reason=REASON_PRESSURE, tier=tier,
                    shed_class=klass,
                )
        demands = self._demands(
            klass, tenant, document, connection, ops, nbytes
        )
        wait = max(
            (b.peek(key, n) for b, key, n in demands), default=0.0
        )
        if wait > 0.0:
            _M_SHED.labels(klass=klass, reason=REASON_RATE_LIMIT).inc()
            return Admission(
                admitted=False, retry_after_seconds=wait,
                reason=REASON_RATE_LIMIT, tier=tier, shed_class=klass,
            )
        for b, key, n in demands:
            b.take(key, n)
        _M_ADMITTED.labels(klass=klass).inc()
        return Admission(admitted=True, tier=tier)
