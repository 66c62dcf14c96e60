"""Shared driver plumbing: retry, throttling backoff, snapshot
prefetch.

Reference: packages/loader/driver-utils — ``runWithRetry`` (retriable
error loop with backoff + throttling respect), ``prefetchSnapshot``
(warm the snapshot/ops caches before Container.load), and the
compression utilities (op compression already lives in
runtime/op_lifecycle.py).
"""
from __future__ import annotations

import os
import random
import time
from typing import Any, Callable, Optional, TypeVar

T = TypeVar("T")


def default_seed() -> int:
    """The process's jitter seed: ``FFTPU_SEED`` when set (replaying a
    failure), otherwise fresh OS entropy — but always an EXPLICIT,
    recorded value, so a failing jittered-backoff schedule is
    reproducible by re-running with ``FFTPU_SEED=<printed seed>``."""
    env = os.environ.get("FFTPU_SEED")
    if env is not None:
        try:
            # base 0: accepts the decimal form JITTER_SEED prints and
            # pasted hex ("0x1f") alike
            return int(env, 0)
        except ValueError:
            raise ValueError(
                f"FFTPU_SEED must be an integer, got {env!r}"
            ) from None
    return int.from_bytes(os.urandom(4), "big")


#: the seed behind the module RNG; set FFTPU_SEED to pin it. Noted
#: ONCE on stderr at the first module-RNG jitter draw (the moment a
#: schedule starts mattering), so a flaky backoff failure always has
#: the seed in its captured output
JITTER_SEED = default_seed()

# module-level source for callers that don't inject their own
# (``run_with_retry(rng=...)`` overrides per call); seeded from
# JITTER_SEED so the backoff schedule is replayable from its seed
_RNG = random.Random(JITTER_SEED)

_SEED_NOTED = False


def _note_seed_once() -> None:
    global _SEED_NOTED
    if not _SEED_NOTED:
        _SEED_NOTED = True
        import sys

        print(
            f"driver_utils: jitter seed {JITTER_SEED} "
            f"(FFTPU_SEED={JITTER_SEED} replays this process's "
            "backoff schedules)",
            file=sys.stderr,
        )


def derived_seed(index: int) -> int:
    """A per-client seed derived from the recorded process seed:
    distinct streams per client (jitter must decorrelate clients)
    that all replay from the ONE surfaced ``FFTPU_SEED`` given the
    same construction order (the loader's backoff RNG uses this).
    Deriving a stream is the moment a schedule starts mattering, so
    the process seed is noted here too — a throttle-storm flake whose
    only jitter rode derived streams still carries its seed."""
    _note_seed_once()
    return (JITTER_SEED << 20) ^ index


class RetriableError(Exception):
    """An error the driver layer may retry (canRetry=true errors).
    ``retry_after_seconds`` mirrors service throttling responses."""

    def __init__(self, message: str = "",
                 retry_after_seconds: Optional[float] = None):
        super().__init__(message)
        self.retry_after_seconds = retry_after_seconds


def full_jitter_delay(attempt: int, *,
                      base_delay_s: float = 0.05,
                      max_delay_s: float = 5.0,
                      floor_s: float = 0.0,
                      rng: Optional[random.Random] = None) -> float:
    """AWS-style FULL-JITTER backoff: uniform in [0, min(cap,
    base*2^(attempt-1))], on TOP of ``floor_s``.

    ``floor_s`` carries a service throttle's ``retry_after_seconds``
    and is a FLOOR, never reduced: the service computed when capacity
    returns, and coming back earlier just re-sheds. The jitter rides
    ABOVE it because a deterministic schedule synchronizes every
    client the service throttled in the same window — they would all
    return at floor+base, floor+2*base, ... in lockstep, re-creating
    the spike the throttle shed (the thundering herd)."""
    span = min(max_delay_s, base_delay_s * (2 ** max(0, attempt - 1)))
    if rng is None:
        _note_seed_once()
    return max(0.0, floor_s) + (rng or _RNG).uniform(0.0, span)


def run_with_retry(fn: Callable[[], T], *,
                   max_retries: int = 5,
                   base_delay_s: float = 0.05,
                   max_delay_s: float = 5.0,
                   retriable=(RetriableError, ConnectionError,
                              TimeoutError),
                   sleep: Callable[[float], None] = time.sleep,
                   on_retry: Optional[Callable[[int, Exception], None]]
                   = None,
                   rng: Optional[random.Random] = None) -> T:
    """driver-utils runWithRetry: call ``fn`` until it succeeds or a
    non-retriable error/exhaustion; full-jitter exponential backoff
    (:func:`full_jitter_delay`) with a throttler's
    ``retry_after_seconds`` as the floor.

    ``rng=None`` (the default) draws jitter from the module RNG,
    which is seeded with :data:`JITTER_SEED` (``FFTPU_SEED`` when
    set): the whole process's backoff schedule replays from one
    recorded seed. Pass a dedicated seeded ``random.Random`` to pin
    one caller's schedule independently of everything else drawing
    from the shared stream."""
    attempt = 0
    while True:
        try:
            return fn()
        except retriable as e:  # noqa: PERF203 - retry loop
            attempt += 1
            if attempt > max_retries:
                raise
            hinted = getattr(e, "retry_after_seconds", None)
            delay = full_jitter_delay(
                attempt, base_delay_s=base_delay_s,
                max_delay_s=max_delay_s,
                floor_s=hinted if hinted is not None else 0.0,
                rng=rng,
            )
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delay)


class PrefetchingDocumentService:
    """prefetchSnapshot: wraps any DocumentService, fetching the
    latest summary and trailing ops ONCE (optionally ahead of time)
    and serving Container.load's storage reads from the cache — the
    reference uses this to overlap snapshot fetch with boot."""

    def __init__(self, inner):
        self._inner = inner
        self.document_id = inner.document_id
        self._summary: Any = None
        self._ops: Optional[list] = None
        self._base = 0

    def prefetch(self) -> "PrefetchingDocumentService":
        self._summary = self._inner.get_latest_summary()
        if self._summary is not None:
            # the load path replays from the snapshot's PROTOCOL
            # position (the summarize op itself sequences after the
            # snapshotted state), so the cache must start there, not
            # at the summary version's seq
            seq, tree = self._summary
            base = (tree.get("protocol") or {}).get(
                "sequenceNumber", seq
            )
        else:
            base = 0
        self._base = base
        self._ops = self._inner.read_ops(base)
        return self

    # -- DocumentService surface ---------------------------------------

    def get_latest_summary(self):
        if self._ops is None:
            self.prefetch()
        return self._summary

    def read_ops(self, from_seq: int, to_seq=None):
        if self._ops is None:
            self.prefetch()
        base = self._base
        covered_to = (self._ops[-1].sequence_number
                      if self._ops else base)
        if from_seq < base:
            # below the prefetched window: the cache cannot answer
            # (it starts at base+1) — delegate to the live service
            return self._inner.read_ops(from_seq, to_seq)
        if from_seq < covered_to:
            # inside the prefetched view: serve the cached consistent
            # snapshot (a load against it sees exactly prefetch-time
            # state; newer ops arrive via connect()'s catch-up below)
            return [m for m in self._ops
                    if m.sequence_number > from_seq
                    and (to_seq is None
                         or m.sequence_number <= to_seq)]
        # past the prefetched range: live service
        return self._inner.read_ops(from_seq, to_seq)

    def connect_to_delta_stream(self, client_id, on_message,
                                on_nack=None):
        return self._inner.connect_to_delta_stream(
            client_id, on_message, on_nack
        )

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()


class RetryDocumentService:
    """Wraps a DocumentService so its storage reads run under
    runWithRetry (transient socket drops / throttling survive)."""

    def __init__(self, inner, **retry_kwargs):
        self._inner = inner
        self._kw = retry_kwargs
        self.document_id = inner.document_id

    def get_latest_summary(self):
        return run_with_retry(self._inner.get_latest_summary,
                              **self._kw)

    def read_ops(self, from_seq: int, to_seq=None):
        return run_with_retry(
            lambda: self._inner.read_ops(from_seq, to_seq), **self._kw
        )

    def connect_to_delta_stream(self, client_id, on_message,
                                on_nack=None):
        return run_with_retry(
            lambda: self._inner.connect_to_delta_stream(
                client_id, on_message, on_nack
            ),
            **self._kw,
        )

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()
