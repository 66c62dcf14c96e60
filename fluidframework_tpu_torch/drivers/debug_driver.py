"""Debugger driver — step-through op playback over any inner driver.

Reference: packages/drivers/debugger/src/fluidDebuggerController.ts:34
(DebugReplayController: user picks a starting point, then releases
sequenced ops in controlled steps while the container renders each
intermediate state) over replay-driver's ReplayController seam. The
TPU-repo construction wraps ANY DocumentService: the delta stream
connection it hands out buffers incoming sequenced messages and only
forwards them under controller commands — ``step(n)``,
``play_to(seq)``, ``resume_live()`` — so a host can inspect a
document's evolution message by message against a live service, not
just a file recording (tools/replay covers the offline case).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

from ..protocol.messages import DocumentMessage, SequencedMessage


class DebugDocumentService:
    """DocumentService wrapper with a playback gate on the delta
    stream. Storage/read paths pass through untouched.

    Delivery ordering: every release path (gated drain, live
    passthrough) appends to ONE fifo outbox under the state lock and
    drains it under a separate delivery lock, so a control-thread
    ``resume_live()`` can never race the network thread's next live
    message past still-buffered earlier sequence numbers."""

    def __init__(self, inner, start_paused: bool = True):
        self.inner = inner
        self.document_id = inner.document_id
        self._lock = threading.Lock()
        # RLock: a listener can synchronously trigger the next
        # _on_message on the same thread (in-proc LocalServer); the
        # nested pump drains the fifo and the outer loop finds it
        # empty — order still the fifo's
        self._deliver_lock = threading.RLock()
        self._buffer: list[SequencedMessage] = []
        self._outbox: deque[SequencedMessage] = deque()
        self._listener: Optional[Callable] = None
        self._paused = start_paused
        self._allowance = 0          # messages step() still owes
        self._play_to: Optional[int] = None
        self.delivered_seq = 0       # last seq released downstream
        # breakpoint: pause BEFORE delivering this seq. Guarded by
        # _lock (the drain gate reads it); mutate via set_breakpoint.
        self._break_at: Optional[int] = None

    # -- DocumentService surface --------------------------------------

    def connect_to_delta_stream(self, client_id: str,
                                listener: Callable, *args, **kwargs):
        self._listener = listener
        return self.inner.connect_to_delta_stream(
            client_id, self._on_message, *args, **kwargs)

    def read_ops(self, from_seq: int, to_seq: Optional[int] = None):
        return self.inner.read_ops(from_seq, to_seq)

    def get_latest_summary(self):
        return self.inner.get_latest_summary()

    def __getattr__(self, name):
        # everything else (lock, upload_summary, close, ...) passes
        # through to the wrapped driver
        return getattr(self.inner, name)

    # -- playback controller (fluidDebuggerController.ts) -------------

    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._buffer)

    @property
    def break_at(self) -> Optional[int]:
        return self._break_at

    def set_breakpoint(self, seq: Optional[int]) -> None:
        """Pause BEFORE delivering ``seq`` (None clears). The gate
        reads the breakpoint under ``_lock`` on the network thread, so
        an unsynchronized ``break_at`` write from a control thread
        could be missed by an in-flight drain — this setter is the
        supported mutation path."""
        with self._lock:
            self._break_at = seq

    def pause(self) -> None:
        """Strict stop: beyond gating future releases, recall every
        released-but-undelivered message from the outbox back to the
        buffer head (outbox messages precede buffered ones in the
        fifo, so re-prepending preserves order). A message another
        thread already popped for delivery cannot be recalled; nothing
        further leaves after pause() returns."""
        with self._lock:
            self._paused = True
            self._allowance = 0
            self._play_to = None
            if self._outbox:
                self._buffer[:0] = self._outbox
                self._outbox.clear()

    def step(self, n: int = 1) -> int:
        """Release up to ``n`` buffered messages; returns how many
        were delivered now (more may flow as they arrive until the
        allowance is spent)."""
        with self._lock:
            self._allowance += n
            self._outbox.extend(self._drain_locked())
        return self._pump()

    def play_to(self, seq: int) -> int:
        """Release every buffered/incoming message with
        sequence_number <= seq."""
        with self._lock:
            self._play_to = max(self._play_to or 0, seq)
            self._outbox.extend(self._drain_locked())
        return self._pump()

    def resume_live(self) -> int:
        """Drop the gate entirely: drain the buffer and forward
        everything from now on (the debugger's 'go live')."""
        with self._lock:
            self._paused = False
            self._allowance = 0
            self._play_to = None
            self._outbox.extend(self._buffer)
            self._buffer = []
        return self._pump()

    # -- internals ----------------------------------------------------

    def _on_message(self, msg: SequencedMessage) -> None:
        with self._lock:
            if not self._paused:
                # live passthrough rides the SAME fifo so it cannot
                # overtake anything a concurrent resume just released
                self._outbox.append(msg)
            else:
                self._buffer.append(msg)
                self._outbox.extend(self._drain_locked())
        self._pump()

    def _drain_locked(self) -> list:
        out = []
        while self._buffer:
            head = self._buffer[0]
            if self._break_at is not None and \
                    head.sequence_number >= self._break_at:
                self._allowance = 0
                self._play_to = None
                break
            if self._play_to is not None and \
                    head.sequence_number <= self._play_to:
                out.append(self._buffer.pop(0))
                continue
            if self._allowance > 0:
                self._allowance -= 1
                out.append(self._buffer.pop(0))
                continue
            break
        return out

    def _pump(self) -> int:
        """Drain the outbox in fifo order under the delivery lock.
        A thread that appended while another was pumping either gets
        its messages delivered by that pump or delivers them itself
        right after acquiring the lock — order is the fifo's."""
        n = 0
        with self._deliver_lock:
            while True:
                with self._lock:
                    if not self._outbox:
                        break
                    m = self._outbox.popleft()
                self.delivered_seq = max(
                    self.delivered_seq, m.sequence_number)
                if self._listener is not None:
                    self._listener(m)
                n += 1
        return n
