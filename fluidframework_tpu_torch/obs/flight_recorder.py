"""Flight recorder: a fixed-size lock-free ring buffer of recent
events, dumped on faults.

A copy of the reference's ``obs/flight_recorder.py``. The sidecars'
dispatch loops record every round and settle here (host-side
timestamps and already-host scalars ONLY — no record may read a device
tensor; ``analysis/synccheck.py`` roots its dispatch-loop rule at these
entry points), and the last N events are dumped automatically on an
overflow recovery or a breaker trip, so "what were the last things that
happened before it failed" has an answer without a debugger attached.

Lock-free: slot indices come from ``itertools.count`` (atomic under
CPython), each slot write is a single tuple store. A reader racing a
writer can observe a torn WINDOW (an old event where a new one is
mid-write) but never a torn EVENT; ``events()`` sorts by index and
drops anything that moved past the ring, which is exactly the
best-effort a postmortem buffer needs.
"""
from __future__ import annotations

import itertools
import sys
import time
from typing import IO, Optional


class FlightRecorder:
    def __init__(self, capacity: int = 256, name: str = "",
                 clock=time.time):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.name = name
        self._clock = clock
        self._counter = itertools.count()
        self._slots: list = [None] * capacity

    def record(self, kind: str, **fields) -> None:
        """Append one event; O(1), no locks, never raises on a full
        ring (old events are overwritten — it's a flight recorder,
        not a log)."""
        i = next(self._counter)
        self._slots[i % self.capacity] = (i, self._clock(), kind,
                                          fields)

    @property
    def recorded(self) -> int:
        """Total events ever recorded (>= what the ring still holds)."""
        # count() has no peek; the next index IS the count, but we
        # must not consume one: reconstruct from the newest slot
        newest = max(
            (s[0] for s in self._slots if s is not None), default=-1
        )
        return newest + 1

    def events(self, last: Optional[int] = None) -> list[tuple]:
        """The retained events, oldest first, as (index, timestamp,
        kind, fields) tuples; ``last`` trims to the newest N."""
        held = sorted(
            (s for s in self._slots if s is not None),
            key=lambda s: s[0],
        )
        if last is not None:
            held = held[-last:]
        return held

    def dump(self, reason: str = "", last: Optional[int] = None) -> str:
        """Human-readable dump of the retained tail."""
        events = self.events(last)
        dropped = self.recorded - len(self.events())
        head = (
            f"flight-recorder[{self.name or 'anon'}] "
            f"dump ({reason or 'requested'}): {len(events)} event(s)"
            + (f", {dropped} older overwritten" if dropped > 0 else "")
        )
        if not events:
            return head + "\n  (empty)"
        t0 = events[0][1]
        lines = [head]
        for i, ts, kind, fields in events:
            detail = " ".join(
                f"{k}={v!r}" for k, v in fields.items()
            )
            lines.append(
                f"  #{i} +{(ts - t0) * 1000:9.3f}ms {kind}"
                + (f" {detail}" if detail else "")
            )
        return "\n".join(lines)

    def dump_to(self, reason: str = "",
                stream: Optional[IO[str]] = None,
                last: Optional[int] = None) -> str:
        """Dump to a stream (stderr by default) and return the text —
        the automatic fault-path entry point."""
        text = self.dump(reason, last)
        print(text, file=stream or sys.stderr, flush=True)
        return text
