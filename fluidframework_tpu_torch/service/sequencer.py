"""Per-document total-order sequencer — the deli ``ticket()`` semantics.

Reference: server/routerlicious/packages/lambdas/src/deli/lambda.ts
(``DeliLambda.handler`` :378 -> ``ticket()`` :741; msn computation :308;
per-client refSeq tracking in ``clientSeqManager.ts``).

The part of the sequencer that ``testing.mocks.MockCollabSession``
drives: join/leave, ``ticket`` with the duplicate/gap/refSeq nacks, and
the msn stamp. It keeps no metrics and no trace hops; checkpointing
stays with the service layer, which this package does not carry.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    Nack,
    NackErrorType,
    SequencedMessage,
)


@dataclass
class _ClientState:
    """clientSeqManager.ts entry: per-client sequencing state."""

    client_id: str
    reference_sequence_number: int
    client_sequence_number: int = 0


@dataclass
class TicketResult:
    """Outcome of sequencing one raw op."""

    message: SequencedMessage | None = None
    nack: Nack | None = None


class DocumentSequencer:
    """deli ``ticket()`` (lambda.ts:741) for a single document."""

    def __init__(self, document_id: str = "",
                 clock: Optional[Callable[[], float]] = None):
        self.document_id = document_id
        self.sequence_number = 0
        self.minimum_sequence_number = 0
        self._clock = clock or time.time
        self._clients: dict[str, _ClientState] = {}

    def client_join(self, detail: ClientDetail) -> SequencedMessage:
        """Server-generated join. The new client's refSeq starts at the
        seq BEFORE its join: crediting it with the join's seq would let
        the msn outrun what the client has provably processed."""
        seq = self._next_seq()
        if detail.client_id not in self._clients:
            self._clients[detail.client_id] = _ClientState(
                client_id=detail.client_id,
                reference_sequence_number=seq - 1,
            )
        # a redundant join must NOT reset sequencing state
        return self._stamp_system(MessageType.CLIENT_JOIN, detail, seq)

    def client_leave(self, client_id: str) -> SequencedMessage | None:
        if client_id not in self._clients:
            return None
        del self._clients[client_id]
        seq = self._next_seq()
        return self._stamp_system(MessageType.CLIENT_LEAVE, client_id, seq)

    def ticket(self, client_id: str, op: DocumentMessage) -> TicketResult:
        """Assign seq + msn to one raw client op, or nack it."""
        client = self._clients.get(client_id)
        if client is None:
            return self._nack(
                op, f"client {client_id!r} not in quorum (join first)")
        expected = client.client_sequence_number + 1
        if op.client_sequence_number < expected:
            return TicketResult()  # duplicate delivery: dropped
        if op.client_sequence_number > expected:
            return self._nack(
                op, f"clientSequenceNumber gap: got "
                    f"{op.client_sequence_number}, expected {expected}")
        if op.reference_sequence_number < self.minimum_sequence_number:
            return self._nack(
                op, f"refSeq {op.reference_sequence_number} below msn "
                    f"{self.minimum_sequence_number}")
        if op.reference_sequence_number > self.sequence_number:
            return self._nack(
                op, "refSeq ahead of document sequence number")
        client.client_sequence_number = op.client_sequence_number
        client.reference_sequence_number = op.reference_sequence_number
        seq = self._next_seq()
        msn = self._compute_msn()
        return TicketResult(message=SequencedMessage(
            client_id=client_id,
            sequence_number=seq,
            minimum_sequence_number=msn,
            client_sequence_number=op.client_sequence_number,
            reference_sequence_number=op.reference_sequence_number,
            type=op.type,
            contents=op.contents,
            metadata=op.metadata,
            timestamp=self._clock(),
        ))

    def _nack(self, op: DocumentMessage, message: str) -> TicketResult:
        return TicketResult(nack=Nack(
            operation=op,
            sequence_number=self.sequence_number,
            error_type=NackErrorType.BAD_REQUEST,
            message=message,
        ))

    def _next_seq(self) -> int:
        self.sequence_number += 1
        return self.sequence_number

    def _compute_msn(self) -> int:
        """msn = min over connected clients' refSeqs (lambda.ts:308);
        with no clients the msn rides the sequence number. Never
        regresses across leave/join churn."""
        if self._clients:
            msn = min(
                c.reference_sequence_number for c in self._clients.values()
            )
        else:
            msn = self.sequence_number
        self.minimum_sequence_number = max(self.minimum_sequence_number, msn)
        return self.minimum_sequence_number

    def _stamp_system(self, msg_type: MessageType, contents: Any,
                      seq: int) -> SequencedMessage:
        msn = self._compute_msn()
        return SequencedMessage(
            client_id=None,
            sequence_number=seq,
            minimum_sequence_number=msn,
            client_sequence_number=-1,
            reference_sequence_number=-1,
            type=msg_type,
            contents=contents,
            timestamp=self._clock(),
        )
