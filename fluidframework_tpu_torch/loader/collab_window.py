"""NoOp heartbeats: keep the collab window moving for idle clients.

Reference: packages/loader/container-loader/src/collabWindowTracker.ts.
The service computes ``minimumSequenceNumber`` as the min over every
write client's last *submitted* refSeq — so an idle write client pins
the msn at its last op forever, zamboni never collects below it, and
tombstones (host and device tables alike) grow without bound. The
tracker watches processed ops and emits a NO_OP whenever this client
has seen ``max_unacked_ops`` sequenced ops without telling the service
(or, via ``tick()``, when it has been idle ``idle_s`` wall seconds with
any unacknowledged advance).

The clock is injectable (``clock=`` defaulting to ``time.monotonic``,
the qos/slo idiom): idle-expiry is part of the replay contract —
detcheck's ``wall-clock-unrouted`` rule keeps a raw ``time.*`` read
from creeping back in.
"""
from __future__ import annotations

import time
from typing import Callable


class CollabWindowTracker:
    """``max_unacked_ops <= 0`` disables count-based heartbeats (the
    ``noopCountFrequency=0`` config); ``tick()`` stays available."""

    def __init__(self, submit_noop: Callable[[], None],
                 max_unacked_ops: int = 50, idle_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self._submit_noop = submit_noop
        self.max_unacked_ops = max_unacked_ops
        self.idle_s = idle_s
        self._clock = clock
        self._last_sent_refseq = 0
        self._unacked_ops = 0
        self._last_activity = self._clock()

    def on_op_sent(self, refseq: int) -> None:
        """Any outbound message carries our refSeq — heartbeat covered."""
        self._last_sent_refseq = max(self._last_sent_refseq, refseq)
        self._unacked_ops = 0
        self._last_activity = self._clock()

    def on_op_processed(self, seq: int) -> None:
        """Called per processed *runtime* op from another client (the
        caller must NOT feed joins/noops/acks here — counting system
        traffic creates acknowledgement cycles where heartbeats trigger
        heartbeats, the exact storm collabWindowTracker.ts guards
        against). Emits a NO_OP once enough unacknowledged ops pile up."""
        self._unacked_ops += 1
        if 0 < self.max_unacked_ops <= self._unacked_ops:
            self._heartbeat(seq)

    def tick(self, current_seq: int) -> bool:
        """Host-driven idle check (the reference's 2s timer): emits a
        NO_OP if there is any unacknowledged advance and no activity for
        ``idle_s``. Returns True if a heartbeat went out."""
        if (
            current_seq > self._last_sent_refseq
            and self._clock() - self._last_activity >= self.idle_s
        ):
            self._heartbeat(current_seq)
            return True
        return False

    def _heartbeat(self, seq: int) -> None:
        self._submit_noop()
        self._last_sent_refseq = seq
        self._unacked_ops = 0
        self._last_activity = self._clock()
