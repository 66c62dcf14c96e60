"""Circuit breaker: closed / open / half-open with probe admission.

A copy of the reference's ``qos/breaker.py``. It wraps a dependency that
can fail independently of load — in the port, the merge sidecar's
device dispatch (``GpuMergeSidecar(breaker=...)``) — so a hard-down
dependency degrades the service instead of taking the serving loop down
with it:

- CLOSED: calls pass through; ``failure_threshold`` CONSECUTIVE
  failures trip to OPEN (one success resets the streak — a flaky 1%
  failure rate must not open the breaker).
- OPEN: calls are refused instantly (``allow()`` is False /
  ``call()`` raises :class:`BreakerOpenError` with an honest
  ``retry_after_seconds``); after ``reset_timeout_s`` the next
  ``allow()`` transitions to HALF_OPEN.
- HALF_OPEN: ``probe_quota`` probe calls are admitted; any failure
  re-opens (fresh timeout), ``probe_successes`` consecutive
  successes close.

``on_open`` fires on every closed/half-open -> open transition — the
sidecar hooks its flight recorder there, so the postmortem of WHAT
tripped the breaker is captured at trip time. State/transition series
land in ``obs.metrics.REGISTRY`` (``qos_breaker_state{name}``,
``qos_breaker_transitions_total``).

Deterministic: the clock is injectable; nothing here sleeps.
Single-threaded by design (called from whatever loop drives the
wrapped dependency).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from ..obs import metrics as obs_metrics

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"
_STATE_CODE = {STATE_CLOSED: 0, STATE_HALF_OPEN: 1, STATE_OPEN: 2}

_M_STATE = obs_metrics.REGISTRY.gauge(
    "qos_breaker_state",
    "circuit state (0=closed, 1=half-open, 2=open)",
    labelnames=("name",))
_M_TRANSITIONS = obs_metrics.REGISTRY.counter(
    "qos_breaker_transitions_total", "breaker state transitions",
    labelnames=("name", "to"))
_M_REFUSED = obs_metrics.REGISTRY.counter(
    "qos_breaker_refused_total",
    "calls refused while the breaker was open", labelnames=("name",))
_M_FAILURES = obs_metrics.REGISTRY.counter(
    "qos_breaker_failures_total",
    "failures reported to the breaker (every record_failure, "
    "including sub-threshold ones that do not open the circuit)",
    labelnames=("name",))


class BreakerOpenError(RuntimeError):
    """The wrapped dependency is circuit-broken; retry later."""

    def __init__(self, message: str,
                 retry_after_seconds: float = 0.0):
        super().__init__(message)
        self.retry_after_seconds = retry_after_seconds


class CircuitBreaker:
    def __init__(self, name: str = "breaker", *,
                 failure_threshold: int = 3,
                 reset_timeout_s: float = 5.0,
                 probe_quota: int = 1,
                 probe_successes: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 on_open: Optional[Callable[["CircuitBreaker"],
                                            None]] = None):
        if failure_threshold < 1 or probe_quota < 1 \
                or probe_successes < 1:
            raise ValueError("breaker thresholds must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.probe_quota = probe_quota
        self.probe_successes = probe_successes
        self._clock = clock
        self.on_open = on_open
        self._state = STATE_CLOSED
        self._failures = 0          # consecutive, while closed
        self._opened_at = 0.0
        self._probes_left = 0       # while half-open
        self._probe_ok = 0          # consecutive, while half-open
        self.last_error: Optional[BaseException] = None
        _M_STATE.labels(name=name).set(0)

    # ------------------------------------------------------------------

    @property
    def state(self) -> str:
        """Current state, advancing OPEN -> HALF_OPEN on timeout."""
        self._maybe_half_open()
        return self._state

    def _transition(self, to: str) -> None:
        if to == self._state:
            return
        self._state = to
        _M_STATE.labels(name=self.name).set(_STATE_CODE[to])
        _M_TRANSITIONS.labels(name=self.name, to=to).inc()
        if to == STATE_OPEN:
            self._opened_at = self._clock()
            if self.on_open is not None:
                self.on_open(self)
        elif to == STATE_HALF_OPEN:
            self._probes_left = self.probe_quota
            self._probe_ok = 0
        else:  # closed
            self._failures = 0

    def _maybe_half_open(self) -> None:
        if (
            self._state == STATE_OPEN
            and self._clock() - self._opened_at >= self.reset_timeout_s
        ):
            self._transition(STATE_HALF_OPEN)

    def retry_after(self) -> float:
        """Honest wait until the next probe window (0 if admitting)."""
        if self.state == STATE_OPEN:
            return max(
                0.0,
                self._opened_at + self.reset_timeout_s - self._clock(),
            )
        return 0.0

    # ------------------------------------------------------------------

    def allow(self) -> bool:
        """May a call proceed right now? In HALF_OPEN this CONSUMES a
        probe slot — callers that get True must report the outcome
        via record_success/record_failure."""
        self._maybe_half_open()
        if self._state == STATE_CLOSED:
            return True
        if self._state == STATE_HALF_OPEN and self._probes_left > 0:
            self._probes_left -= 1
            return True
        _M_REFUSED.labels(name=self.name).inc()
        return False

    def record_success(self) -> None:
        if self._state == STATE_HALF_OPEN:
            self._probe_ok += 1
            if self._probe_ok >= self.probe_successes:
                self._transition(STATE_CLOSED)
            else:
                # serial probe admission: each success grants the
                # next probe slot, so probe_successes > probe_quota
                # converges instead of deadlocking out of probes
                self._probes_left += 1
        else:
            self._failures = 0

    def record_failure(self, error: Optional[BaseException] = None
                       ) -> None:
        self.last_error = error
        _M_FAILURES.labels(name=self.name).inc()
        if self._state == STATE_HALF_OPEN:
            self._transition(STATE_OPEN)  # probe failed: back off
            return
        if self._state == STATE_CLOSED:
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._transition(STATE_OPEN)

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` under the breaker; refusals raise
        :class:`BreakerOpenError` with the honest retry hint."""
        if not self.allow():
            raise BreakerOpenError(
                f"{self.name} is open "
                f"(last error: {self.last_error!r})",
                retry_after_seconds=self.retry_after(),
            )
        try:
            out = fn(*args, **kwargs)
        except Exception as e:
            self.record_failure(e)
            raise
        self.record_success()
        return out
