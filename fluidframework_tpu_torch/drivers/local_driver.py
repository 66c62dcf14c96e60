"""Local driver: DocumentService over the in-proc LocalServer.

Reference: packages/drivers/local-driver/src/localDocumentService.ts
(:23) — pairs with LocalDeltaConnectionServer for integration tests.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..obs.trace import stamp as trace_stamp
from ..protocol.messages import DocumentMessage, Nack, SequencedMessage
from ..service.local_server import DeltaConnection, LocalServer


class _TracingDeltaConnection:
    """Stamps the ``driver:send`` hop on outbound ops, so in-proc
    traces line up with the socket driver's (no ``driver:deliver``
    stamp in-proc: the broadcast message OBJECT is shared by every
    subscriber, and per-client delivery stamps on a shared list would
    pollute each other's view)."""

    def __init__(self, inner: DeltaConnection):
        self._inner = inner

    def submit(self, op: DocumentMessage) -> None:
        trace_stamp(op.traces, "driver", "send")
        self._inner.submit(op)

    def disconnect(self) -> None:
        self._inner.disconnect()

    @property
    def open(self) -> bool:
        return self._inner.open

    @property
    def client_id(self) -> str:
        return self._inner.client_id


class LocalDocumentService:
    def __init__(self, server: LocalServer, document_id: str):
        self._server = server
        self.document_id = document_id

    def connect_to_delta_stream(
        self,
        client_id: str,
        on_message: Callable[[SequencedMessage], None],
        on_nack: Optional[Callable[[Nack], None]] = None,
    ) -> _TracingDeltaConnection:
        return _TracingDeltaConnection(self._server.connect(
            self.document_id, client_id, on_message, on_nack
        ))

    def read_ops(self, from_seq: int, to_seq: Optional[int] = None
                 ) -> list[SequencedMessage]:
        return self._server.read_ops(self.document_id, from_seq, to_seq)

    def get_latest_summary(self) -> Optional[tuple[int, dict]]:
        latest = self._server.latest_summary(self.document_id)
        if latest is None:
            return None
        return latest.sequence_number, latest.summary


class LocalDocumentServiceFactory:
    """IDocumentServiceFactory: document id -> service."""

    def __init__(self, server: LocalServer):
        self.server = server

    def create_document_service(self, document_id: str
                                ) -> LocalDocumentService:
        return LocalDocumentService(self.server, document_id)
