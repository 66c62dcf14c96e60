"""Inbound scheduling: batch integrity + time-sliced processing.

Reference: packages/runtime/container-runtime/src/scheduleManager.ts
(``ScheduleManager`` :33 — the inbound queue must not yield mid-batch,
so a batch applies atomically from the app's point of view) and
deltaScheduler.ts (``DeltaScheduler`` :30 — inbound processing happens
in ~50ms time slices so op floods don't starve the host).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from ..protocol.messages import MessageType, SequencedMessage
from ..runtime.op_lifecycle import batch_flag


class ScheduleManager:
    """Groups inbound messages into atomic units: singleton messages
    pass through; messages between a {batch: true} and {batch: false}
    mark from one client release together. System messages interleaved
    by the service mid-batch are held *in sequence order* inside the
    open unit (the reference's scheduleManager.ts never reorders — it
    pauses the inbound queue until the whole batch is present, so
    nothing downstream ever observes a seq gap); a foreign *operation*
    mid-batch is a service ordering violation (batch asserts)."""

    def __init__(self) -> None:
        self._batch: list[SequencedMessage] = []

    @property
    def in_batch(self) -> bool:
        return bool(self._batch)

    def reset(self) -> None:
        """Drop partial batch state (connection teardown: the ops will
        be refetched from delta storage on reconnect)."""
        self._batch.clear()

    def feed(self, msg: SequencedMessage) -> list[SequencedMessage]:
        """Returns the messages now ready to process, in order."""
        flag = batch_flag(msg.metadata)
        if self._batch:
            if msg.type != MessageType.OPERATION:
                # Hold system traffic in seq order within the unit:
                # Container._process asserts strict seq continuity, so
                # releasing it ahead of the buffered batch would crash.
                self._batch.append(msg)
                return []
            assert msg.client_id == self._batch[0].client_id, (
                "foreign operation interleaved mid-batch: "
                f"{msg.client_id!r} inside "
                f"{self._batch[0].client_id!r}'s batch"
            )
            self._batch.append(msg)
            if flag is False:
                out, self._batch = self._batch, []
                return out
            return []
        if flag is True:
            self._batch = [msg]
            return []
        return [msg]


class DeltaScheduler:
    """Time-sliced draining (deltaScheduler.ts:30): process queued
    units until the slice budget elapses, then yield control. A unit
    (whole batch) never splits across slices."""

    DEFAULT_SLICE_S = 0.05  # the reference's 50ms (deltaScheduler.ts:33)

    def __init__(self, process_one: Callable[[SequencedMessage], None],
                 clock: Callable[[], float] = time.monotonic):
        self._process_one = process_one
        # injectable (the qos/slo idiom): slice deadlines are part of
        # the replay contract, so tests drive them on a manual clock
        # and detcheck keeps raw time.* reads out of drain()
        self._clock = clock
        self._queue: list[list[SequencedMessage]] = []

    def enqueue(self, unit: list[SequencedMessage]) -> None:
        if unit:
            self._queue.append(unit)

    @property
    def pending_units(self) -> int:
        return len(self._queue)

    def clear(self) -> None:
        self._queue.clear()

    def drain(self, slice_s: Optional[float] = None) -> int:
        """Process units until the budget runs out (None = no budget).
        Returns messages processed."""
        deadline = (
            None if slice_s is None else self._clock() + slice_s
        )
        done = 0
        while self._queue:
            unit = self._queue.pop(0)
            for msg in unit:  # a batch applies atomically
                self._process_one(msg)
                done += 1
            if deadline is not None and self._clock() >= deadline:
                break
        return done
