"""Per-document total-order sequencer — the deli ``ticket()`` semantics.

Reference: server/routerlicious/packages/lambdas/src/deli/lambda.ts
(``DeliLambda.handler`` :378 -> ``ticket()`` :741; msn computation :308;
per-client refSeq tracking in ``clientSeqManager.ts``).

One ``DocumentSequencer`` is the single ordering authority for one
document (the reference guarantees this with one Kafka partition per
document; we guarantee it with one sequencer instance per doc, sharded
over the service plane — SURVEY §2.9 axis 1).

Responsibilities:
- assign a monotone ``sequence_number`` to every raw op,
- track each connected client's ``reference_sequence_number`` and stamp
  the ``minimum_sequence_number`` (= min refSeq over connected clients)
  on every outgoing op,
- join/leave bookkeeping, duplicate/gap detection on
  ``client_sequence_number``, nack policies,
- checkpoint/restore so a sharded service can resume after
  reassignment (deli/checkpointContext.ts).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..obs import metrics as _metrics
from ..obs.trace import stamp as _stamp
from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    Nack,
    NackErrorType,
    SequencedMessage,
)

# process-wide aggregates across every document's sequencer (label-
# free on purpose: per-document label sets are unbounded cardinality)
_TICKETS = _metrics.REGISTRY.counter(
    "sequencer_tickets_total", "raw ops assigned a sequence number")
_NACKS = _metrics.REGISTRY.counter(
    "sequencer_nacks_total", "raw ops refused by the sequencer")
_SYSTEM_MSGS = _metrics.REGISTRY.counter(
    "sequencer_system_messages_total",
    "service-generated sequenced messages (joins/leaves/acks)")


@dataclass
class _ClientState:
    """clientSeqManager.ts entry: per-client sequencing state."""

    client_id: str
    reference_sequence_number: int
    client_sequence_number: int = 0
    can_evict: bool = True
    last_update: float = 0.0


@dataclass
class TicketResult:
    """Outcome of sequencing one raw op."""

    message: SequencedMessage | None = None
    nack: Nack | None = None

    @property
    def ok(self) -> bool:
        return self.message is not None


class DocumentSequencer:
    """deli ``ticket()`` (lambda.ts:741) for a single document."""

    def __init__(
        self,
        document_id: str = "",
        sequence_number: int = 0,
        minimum_sequence_number: int = 0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.document_id = document_id
        self.sequence_number = sequence_number
        self.minimum_sequence_number = minimum_sequence_number
        # injectable wall clock (the qos/slo idiom): the wire-visible
        # ``timestamp`` stamps and trace hops route through it, so a
        # recorded corpus replayed under a manual clock is byte-stable
        # (production default stays real wall time — timestamps on
        # the wire MEAN server wall time)
        self._clock = clock or time.time
        self._clients: dict[str, _ClientState] = {}

    # ------------------------------------------------------------------
    # membership

    @property
    def clients(self) -> tuple[str, ...]:
        return tuple(self._clients)

    def client_join(self, detail: ClientDetail) -> SequencedMessage:
        """Server-generated join (alfred connect_document ->
        deli; lambdas/src/alfred/index.ts:465). The new client's refSeq
        starts at the seq BEFORE its join: the join itself hasn't
        reached the client yet, so crediting it with the join's seq
        lets the msn outrun what the client has provably processed —
        its first op (submitted before the join broadcast arrives over
        a real network) would then nack with 'refSeq below msn'
        (found by tools/net_stress over TCP; in-proc delivery is
        synchronous and never exposed the race)."""
        seq = self._next_seq()
        existing = self._clients.get(detail.client_id)
        if existing is None:
            self._clients[detail.client_id] = _ClientState(
                client_id=detail.client_id,
                reference_sequence_number=seq - 1,
                last_update=self._clock(),
            )
        # A redundant join (at-least-once ingress retry) must NOT reset
        # sequencing state, or replayed ops would be re-ticketed as new.
        return self._stamp_system(MessageType.CLIENT_JOIN, detail, seq)

    def client_leave(self, client_id: str) -> SequencedMessage | None:
        if client_id not in self._clients:
            return None
        del self._clients[client_id]
        seq = self._next_seq()
        return self._stamp_system(MessageType.CLIENT_LEAVE, client_id, seq)

    # ------------------------------------------------------------------
    # op sequencing

    def ticket(self, client_id: str, op: DocumentMessage) -> TicketResult:
        """Assign seq + msn to one raw client op, or nack it."""
        client = self._clients.get(client_id)
        if client is None:
            _NACKS.inc()
            return TicketResult(nack=Nack(
                operation=op,
                sequence_number=self.sequence_number,
                error_type=NackErrorType.BAD_REQUEST,
                message=f"client {client_id!r} not in quorum (join first)",
            ))

        # Duplicate / out-of-order client sequence numbers
        # (deli dup-detection around lambda.ts:800s).
        expected = client.client_sequence_number + 1
        if op.client_sequence_number < expected:
            # Duplicate delivery: drop silently (idempotence).
            return TicketResult()
        if op.client_sequence_number > expected:
            _NACKS.inc()
            return TicketResult(nack=Nack(
                operation=op,
                sequence_number=self.sequence_number,
                error_type=NackErrorType.BAD_REQUEST,
                message=(
                    f"clientSequenceNumber gap: got "
                    f"{op.client_sequence_number}, expected {expected}"
                ),
            ))

        # refSeq sanity: must be inside the collab window.
        if op.reference_sequence_number < self.minimum_sequence_number:
            _NACKS.inc()
            return TicketResult(nack=Nack(
                operation=op,
                sequence_number=self.sequence_number,
                error_type=NackErrorType.BAD_REQUEST,
                message=(
                    f"refSeq {op.reference_sequence_number} below msn "
                    f"{self.minimum_sequence_number}"
                ),
            ))
        if op.reference_sequence_number > self.sequence_number:
            _NACKS.inc()
            return TicketResult(nack=Nack(
                operation=op,
                sequence_number=self.sequence_number,
                error_type=NackErrorType.BAD_REQUEST,
                message="refSeq ahead of document sequence number",
            ))

        now = self._clock()
        client.client_sequence_number = op.client_sequence_number
        client.reference_sequence_number = op.reference_sequence_number
        client.last_update = now

        seq = self._next_seq()
        msn = self._compute_msn()
        _TICKETS.inc()
        # the deli stamp (deli/lambda.ts:1130): the op's client-side
        # hops travel with it; this marks the ordering authority.
        # timestamp= from the injected clock, so the stamp is as
        # replayable as the message it rides
        traces = _stamp(list(op.traces), "sequencer", "ticket",
                        timestamp=now)
        return TicketResult(message=SequencedMessage(
            client_id=client_id,
            sequence_number=seq,
            minimum_sequence_number=msn,
            client_sequence_number=op.client_sequence_number,
            reference_sequence_number=op.reference_sequence_number,
            type=op.type,
            contents=op.contents,
            metadata=op.metadata,
            timestamp=now,
            traces=traces,
        ))

    def system_message(self, msg_type: MessageType,
                       contents: Any) -> SequencedMessage:
        """Allocate a seq for a service-generated op (scribe's
        summaryAck/Nack loop back through deli the same way)."""
        _SYSTEM_MSGS.inc()
        return self._stamp_system(msg_type, contents, self._next_seq())

    def fast_forward(self, seq: int) -> None:
        """O(1) stream-position resume (restart fast-forward, follower
        promotion): equivalent to sequencing ``seq - sequence_number``
        NO_OPs — only the final seq and one msn recomputation are
        observable, and neither allocates per-op messages. A promoted
        follower with a full replicated log used to pay O(log) here."""
        if seq <= self.sequence_number:
            return
        self.sequence_number = seq
        self._compute_msn()

    # ------------------------------------------------------------------
    # checkpoint / resume (deli/checkpointContext.ts)

    def checkpoint(self) -> dict[str, Any]:
        return {
            "document_id": self.document_id,
            "sequence_number": self.sequence_number,
            "minimum_sequence_number": self.minimum_sequence_number,
            "clients": [
                {
                    "client_id": c.client_id,
                    "reference_sequence_number": c.reference_sequence_number,
                    "client_sequence_number": c.client_sequence_number,
                    "last_update": c.last_update,
                }
                for c in self._clients.values()
            ],
        }

    @classmethod
    def restore(cls, state: dict[str, Any],
                clock: Optional[Callable[[], float]] = None,
                ) -> "DocumentSequencer":
        seq = cls(
            document_id=state["document_id"],
            sequence_number=state["sequence_number"],
            minimum_sequence_number=state["minimum_sequence_number"],
            clock=clock,
        )
        for c in state["clients"]:
            seq._clients[c["client_id"]] = _ClientState(
                client_id=c["client_id"],
                reference_sequence_number=c["reference_sequence_number"],
                client_sequence_number=c["client_sequence_number"],
                # diagnostics parity with clientSeqManager (no code
                # consumes it yet): restored as recorded instead of
                # re-minted at restore-time, .get-defaulted for
                # checkpoints written before the field persisted
                last_update=c.get("last_update", 0.0),
            )
        return seq

    # ------------------------------------------------------------------
    # internals

    def _next_seq(self) -> int:
        self.sequence_number += 1
        return self.sequence_number

    def _compute_msn(self) -> int:
        """msn = min over connected clients' refSeqs (lambda.ts:308);
        with no clients the msn rides the sequence number. Monotone by
        construction (refSeqs only advance; joiners start at current
        seq)."""
        if self._clients:
            msn = min(
                c.reference_sequence_number for c in self._clients.values()
            )
        else:
            msn = self.sequence_number
        # msn never regresses even across leave/join churn.
        self.minimum_sequence_number = max(self.minimum_sequence_number, msn)
        return self.minimum_sequence_number

    def _stamp_system(
        self, msg_type: MessageType, contents: Any, seq: int
    ) -> SequencedMessage:
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
