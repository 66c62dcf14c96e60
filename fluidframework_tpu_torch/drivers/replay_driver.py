"""Replay driver: serves a recorded op stream as a read-only document.

Reference: packages/drivers/replay-driver/src
(``ReplayDocumentService`` replayDocumentService.ts:18,
``ReplayController``) — replays persisted op streams against snapshots
for validation and benchmarking (BASELINE configs are replay-driven).
"""
from __future__ import annotations

from typing import Callable, Optional

from ..protocol.messages import (
    DocumentMessage,
    Nack,
    SequencedMessage,
)


class _ReplayConnection:
    client_id = "replay-reader"
    open = True

    def submit(self, op: DocumentMessage) -> None:
        raise RuntimeError("replay documents are read-only")

    def disconnect(self) -> None:
        self.open = False


class ReplayDocumentService:
    """Replays ``messages`` (an already-sequenced stream) up to
    ``replay_to`` through the normal delta-stream interface."""

    def __init__(self, document_id: str,
                 messages: list[SequencedMessage],
                 summary: Optional[tuple[int, dict]] = None):
        self.document_id = document_id
        self._messages = sorted(messages,
                                key=lambda m: m.sequence_number)
        self._summary = summary

    def connect_to_delta_stream(
        self,
        client_id: str,
        on_message: Callable[[SequencedMessage], None],
        on_nack: Optional[Callable[[Nack], None]] = None,
    ) -> _ReplayConnection:
        conn = _ReplayConnection()
        base = self._summary[0] if self._summary else 0
        for msg in self._messages:
            if msg.sequence_number > base:
                on_message(msg)
        return conn

    def read_ops(self, from_seq: int, to_seq: Optional[int] = None
                 ) -> list[SequencedMessage]:
        return [
            m for m in self._messages
            if m.sequence_number > from_seq
            and (to_seq is None or m.sequence_number <= to_seq)
        ]

    def get_latest_summary(self) -> Optional[tuple[int, dict]]:
        return self._summary
