"""Token-bucket rate limiting — the per-tenant throttler analogue.

Reference: Routerlicious fronts alfred with per-tenant throttling
middleware (server/routerlicious/packages/services/src/throttler.ts,
utils/throttlerHelper.ts): every connect/submit consults a usage
counter and over-budget callers get a throttling response carrying
``retryAfterInMs``. The client half of that contract already exists
here (drivers/driver_utils.py honors ``retry_after_seconds``); this
module is the service half the stack was missing.

Design constraints:

- **Deterministic**: the clock is injectable (``clock=``), so tests
  and the overload harness drive refill explicitly — no wall-time
  races.
- **Honest waits**: a rejected take returns the exact seconds until
  the bucket can cover the request, which is what the throttle nack's
  ``retry_after_seconds`` must carry (a made-up constant teaches
  clients to ignore it).
- **Bounded memory**: per-scope bucket maps are LRU-capped — a scope
  churn attack (one op per fresh document id) cannot grow state
  without bound. Eviction forgets at most ``burst`` tokens of debt,
  which only ever errs toward admitting.

Single-threaded by design: limiters are consulted from the ingress
event loop (or a test/bench driver), never concurrently.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Hashable


@dataclass(frozen=True)
class Budget:
    """One refill schedule: ``rate`` tokens/second, ``burst`` cap.

    ``burst`` defaults to one second of rate — enough to absorb a
    flush-sized spike without admitting a sustained overage."""

    rate: float
    burst: float = 0.0

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"budget rate must be > 0, got {self.rate}")
        if self.burst <= 0:
            object.__setattr__(self, "burst", float(self.rate))


class TokenBucket:
    """Classic token bucket with peek/take split so a multi-bucket
    admission (connection AND document AND tenant) can check every
    budget before consuming from any — a partial take would charge
    callers for ops that were never admitted."""

    __slots__ = ("budget", "tokens", "_last", "_clock")

    def __init__(self, budget: Budget,
                 clock: Callable[[], float] = time.monotonic):
        self.budget = budget
        self.tokens = float(budget.burst)
        self._clock = clock
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        if now > self._last:
            self.tokens = min(
                self.budget.burst,
                self.tokens + (now - self._last) * self.budget.rate,
            )
        self._last = now

    def peek(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens are available (0.0 = now)."""
        self._refill()
        if self.tokens >= n:
            return 0.0
        return (n - self.tokens) / self.budget.rate

    def take(self, n: float = 1.0) -> None:
        """Consume unconditionally (call after a 0.0 peek; going
        negative is allowed so a peek/take pair under one admission
        stays correct even if a sibling bucket took first)."""
        self._refill()
        self.tokens -= n

    def try_take(self, n: float = 1.0) -> float:
        """Atomic peek+take: 0.0 and consumed, or the honest wait."""
        wait = self.peek(n)
        if wait == 0.0:
            self.take(n)
        return wait


class ScopedBuckets:
    """``key -> TokenBucket`` under one shared Budget, LRU-capped.

    One instance per (scope, dimension) pair — e.g. per-document op
    budgets — where the key space is attacker-influenced and must not
    grow without bound."""

    def __init__(self, budget: Budget,
                 clock: Callable[[], float] = time.monotonic,
                 max_scopes: int = 4096):
        self.budget = budget
        self._clock = clock
        self.max_scopes = max_scopes
        self._buckets: "OrderedDict[Hashable, TokenBucket]" = \
            OrderedDict()

    def bucket(self, key: Hashable) -> TokenBucket:
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = TokenBucket(
                self.budget, self._clock
            )
            while len(self._buckets) > self.max_scopes:
                self._buckets.popitem(last=False)
        else:
            self._buckets.move_to_end(key)
        return b

    def peek(self, key: Hashable, n: float = 1.0) -> float:
        return self.bucket(key).peek(n)

    def take(self, key: Hashable, n: float = 1.0) -> None:
        self.bucket(key).take(n)

    def __len__(self) -> int:
        return len(self._buckets)
