"""Local delta-connection server: the whole multi-document service
in-proc.

Reference: server/routerlicious/packages/local-server/src/
localDeltaConnectionServer.ts (:61) + localWebSocketServer.ts (:77) —
the integration-test backbone (SURVEY §4 pillar (c)): real sequencing,
msn, nacks and summaries with zero deployment. Our connection objects
stand in for sockets.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional

from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    Nack,
    SequencedMessage,
)
from .local_orderer import LocalOrderer


class DeltaConnection:
    """One client's live connection to a document (the socket
    analogue: driver-base/src/documentDeltaConnection.ts:41)."""

    def __init__(self, server: "LocalServer", orderer: LocalOrderer,
                 client_id: str, connection_id: str,
                 read_only: bool = False):
        self._server = server
        self._orderer = orderer
        self.client_id = client_id
        self.connection_id = connection_id
        self.read_only = read_only
        self.open = True
        self.on_message: Optional[Callable[[SequencedMessage], None]] = None
        self.on_nack: Optional[Callable[[Nack], None]] = None

    def submit(self, op: DocumentMessage) -> None:
        assert self.open, "submit on closed connection"
        if self.read_only:
            raise PermissionError(
                "submit on a read-mode connection (doc:read scope)")
        nack = self._orderer.submit(self.client_id, op)
        if nack is not None and self.on_nack is not None:
            self.on_nack(nack)

    def disconnect(self) -> None:
        if not self.open:
            return
        self.open = False
        self._orderer.broadcaster.unsubscribe(self.connection_id)
        if not self.read_only:
            self._orderer.disconnect(self.client_id)


class LocalServer:
    """Multi-document service: one LocalOrderer per document
    (document-parallelism — SURVEY §2.9 axis 1)."""

    def __init__(self, durable_dir: Optional[str] = None,
                 storage_breaker=None,
                 checkpoint_every: int = 1,
                 clock=None) -> None:
        self.documents: dict[str, LocalOrderer] = {}
        self.durable_dir = durable_dir
        # injectable wall clock threaded into every orderer's
        # sequencer (wire timestamps); None = real wall time
        self.clock = clock
        # ONE shared qos.CircuitBreaker across every document's
        # checkpoint writes (they share the disk, so they share the
        # failure domain); None = unguarded, as before
        self.storage_breaker = storage_breaker
        # checkpoint cadence (deli checkpoints every N dispatches): >1
        # leaves a restart a real op-log gap to fast-forward across —
        # the crash-recovery path tests/test_chaos.py exercises
        self.checkpoint_every = checkpoint_every
        self._conn_counter = itertools.count()

    def get_orderer(self, document_id: str) -> LocalOrderer:
        if document_id not in self.documents:
            self.documents[document_id] = self._make_orderer(
                document_id)
        return self.documents[document_id]

    # factory hooks: the replicated sequencer
    # (service/replication.py) swaps in a ReplicatedDocumentStorage
    # (op log behind the replication quorum) and an epoch-fenced
    # orderer without re-stating the construction logic
    def _make_storage(self, document_id: str):
        if self.durable_dir is None:
            return None
        import os

        from .storage import DocumentStorage

        return DocumentStorage(
            os.path.join(self.durable_dir, document_id))

    def _make_orderer(self, document_id: str) -> LocalOrderer:
        return LocalOrderer(
            document_id, storage=self._make_storage(document_id),
            storage_breaker=self.storage_breaker,
            checkpoint_every=self.checkpoint_every,
            clock=self.clock,
        )

    # ------------------------------------------------------------------
    # connection lifecycle (connect_document handshake,
    # lambdas/src/alfred/index.ts:465)

    def connect(self, document_id: str, client_id: str,
                on_message: Callable[[SequencedMessage], None],
                on_nack: Optional[Callable[[Nack], None]] = None,
                detail: Optional[ClientDetail] = None,
                read_only: bool = False,
                ) -> DeltaConnection:
        """``read_only`` = the reference's "read" connection mode:
        broadcast subscription only — no quorum join (the client's
        refSeq never pins the msn) and submit is rejected."""
        orderer = self.get_orderer(document_id)
        connection_id = f"conn-{next(self._conn_counter)}"
        conn = DeltaConnection(self, orderer, client_id, connection_id,
                               read_only=read_only)
        conn.on_message = on_message
        conn.on_nack = on_nack
        # subscribe BEFORE the join op so the client sees its own join
        orderer.broadcaster.subscribe(
            connection_id, lambda msg: conn.on_message and
            conn.on_message(msg)
        )
        if detail is None:
            # the join payload's ClientDetail rides the wire: stamp
            # it from the injected clock when one is set, so recorded
            # corpora stay byte-stable under a manual clock
            detail = ClientDetail(
                client_id, timestamp=self.clock(),
            ) if self.clock else ClientDetail(client_id)
        if not read_only:
            try:
                orderer.connect(detail)
            except Exception:
                # the client's own delivery callback refused the join
                # (e.g. the loader's unfillable-gap error): unwind the
                # half-made connection — a zombie subscription would
                # keep delivering into the dead client and raise its
                # error inside every UNRELATED submitter's dispatch
                conn.disconnect()
                raise
        return conn

    # ------------------------------------------------------------------
    # storage plane (delta storage + summaries)

    def read_ops(self, document_id: str, from_seq: int,
                 to_seq: Optional[int] = None) -> list[SequencedMessage]:
        return self.get_orderer(document_id).op_log.read(from_seq, to_seq)

    def latest_summary(self, document_id: str):
        return self.get_orderer(document_id).summary_store.latest()
