"""Driver contracts: how a client reaches a service.

Reference: packages/common/driver-definitions/src/storage.ts —
``IDocumentService`` (:288) with its three planes:
``IDocumentDeltaConnection`` (:193, live op stream),
``IDocumentDeltaStorageService`` (:76, op range reads) and
``IDocumentStorageService`` (:119, summaries/snapshots).
"""
from __future__ import annotations

from typing import Callable, Optional, Protocol

from ..protocol.messages import (
    DocumentMessage,
    Nack,
    SequencedMessage,
)


class DeltaStreamConnection(Protocol):
    """Live op stream (IDocumentDeltaConnection)."""

    client_id: str
    open: bool

    def submit(self, op: DocumentMessage) -> None: ...

    def disconnect(self) -> None: ...


class DocumentService(Protocol):
    """IDocumentService (storage.ts:288): one document, three planes."""

    document_id: str

    def connect_to_delta_stream(
        self,
        client_id: str,
        on_message: Callable[[SequencedMessage], None],
        on_nack: Optional[Callable[[Nack], None]] = None,
    ) -> DeltaStreamConnection: ...

    def read_ops(self, from_seq: int,
                 to_seq: Optional[int] = None) -> list[SequencedMessage]: ...

    def get_latest_summary(self) -> Optional[tuple[int, dict]]:
        """Returns (sequence_number, summary) or None."""
        ...
