"""Python wrapper over the native sequencer core.

``NativeSequencerCore`` exposes the DocumentSequencer surface (ticket/
join/leave/checkpoint — service/sequencer.py) backed by the C++ hot
loop, plus a batch API the service plane uses for throughput. String
client ids are interned to ints here; nack construction stays in
Python (cold path).
"""
from __future__ import annotations

import ctypes
import time
from typing import Any, Callable, Optional

from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    Nack,
    NackErrorType,
    SequencedMessage,
    Trace,
)
from ..service.sequencer import TicketResult

_STATUS_MESSAGES = {
    1: "client not in quorum (join first)",
    3: "clientSequenceNumber gap",
    4: "refSeq below msn",
    5: "refSeq ahead of document sequence number",
}


class NativeSequencerCore:
    """Drop-in DocumentSequencer with the C++ ticket loop."""

    def __init__(self, document_id: str = "",
                 sequence_number: int = 0,
                 minimum_sequence_number: int = 0,
                 clock: Optional[Callable[[], float]] = None):
        from . import load_native_sequencer
        lib = load_native_sequencer()
        if lib is None:
            from . import native_build_error
            raise RuntimeError(
                f"native sequencer unavailable: {native_build_error()}"
            )
        self._lib = lib
        # same injectable wall clock as DocumentSequencer: wire
        # timestamps stay byte-stable under a manual clock
        self._clock = clock or time.time
        self.document_id = document_id
        self._handle = lib.seq_create(
            sequence_number, minimum_sequence_number
        )
        self._intern: dict[str, int] = {}
        self._unintern: list[str] = []

    def __del__(self):  # pragma: no cover - interpreter teardown
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.seq_destroy(handle)
            self._handle = None

    # ------------------------------------------------------------------

    @property
    def sequence_number(self) -> int:
        return self._lib.seq_sequence_number(self._handle)

    @property
    def minimum_sequence_number(self) -> int:
        return self._lib.seq_minimum_sequence_number(self._handle)

    @property
    def clients(self) -> tuple[str, ...]:
        n = self._lib.seq_client_count(self._handle)
        ids = (ctypes.c_int64 * n)()
        refs = (ctypes.c_int64 * n)()
        csns = (ctypes.c_int64 * n)()
        count = self._lib.seq_export_clients(
            self._handle, n, ids, refs, csns
        )
        return tuple(self._unintern[ids[i]] for i in range(count))

    def _intern_id(self, client_id: str) -> int:
        idx = self._intern.get(client_id)
        if idx is None:
            idx = len(self._unintern)
            self._intern[client_id] = idx
            self._unintern.append(client_id)
        return idx

    def _system_msg(self, msg_type: MessageType, contents: Any,
                    seq: int) -> SequencedMessage:
        return SequencedMessage(
            client_id=None,
            sequence_number=seq,
            minimum_sequence_number=self.minimum_sequence_number,
            client_sequence_number=-1,
            reference_sequence_number=-1,
            type=msg_type,
            contents=contents,
            timestamp=self._clock(),
        )

    # ------------------------------------------------------------------
    # DocumentSequencer surface

    def client_join(self, detail: ClientDetail) -> SequencedMessage:
        seq = self._lib.seq_client_join(
            self._handle, self._intern_id(detail.client_id)
        )
        return self._system_msg(MessageType.CLIENT_JOIN, detail, seq)

    def client_leave(self, client_id: str) -> Optional[SequencedMessage]:
        idx = self._intern.get(client_id)
        if idx is None:
            return None
        seq = self._lib.seq_client_leave(self._handle, idx)
        if seq < 0:
            return None
        return self._system_msg(MessageType.CLIENT_LEAVE, client_id, seq)

    def ticket(self, client_id: str,
               op: DocumentMessage) -> TicketResult:
        results = self.ticket_batch([(client_id, op)])
        return results[0]

    def ticket_batch(
        self, ops: list[tuple[str, DocumentMessage]]
    ) -> list[TicketResult]:
        """The throughput API: one native call tickets a whole window
        of raw ops (the deli lambda processes Kafka message boxcars
        the same way)."""
        n = len(ops)
        intern = self._intern
        cids = (ctypes.c_int64 * n)(
            *(intern.get(cid, -1) for cid, _ in ops)
        )
        csns = (ctypes.c_int64 * n)(
            *(op.client_sequence_number for _, op in ops)
        )
        refs = (ctypes.c_int64 * n)(
            *(op.reference_sequence_number for _, op in ops)
        )
        out_seq = (ctypes.c_int64 * n)()
        out_msn = (ctypes.c_int64 * n)()
        out_status = (ctypes.c_int32 * n)()
        self._lib.seq_ticket_batch(
            self._handle, n, cids, csns, refs,
            out_seq, out_msn, out_status,
        )
        results: list[TicketResult] = []
        now = self._clock()
        # nacks report the doc seq AT rejection time, matching the
        # sequential oracle: track it through the batch
        running_seq = self.sequence_number - sum(
            1 for i in range(n) if out_status[i] == 0
        )
        for i, (client_id, op) in enumerate(ops):
            status = out_status[i]
            if status == 0:
                running_seq = out_seq[i]
                traces = list(op.traces)
                traces.append(Trace("sequencer", "ticket"))
                results.append(TicketResult(message=SequencedMessage(
                    client_id=client_id,
                    sequence_number=out_seq[i],
                    minimum_sequence_number=out_msn[i],
                    client_sequence_number=op.client_sequence_number,
                    reference_sequence_number=(
                        op.reference_sequence_number
                    ),
                    type=op.type,
                    contents=op.contents,
                    metadata=op.metadata,
                    timestamp=now,
                    traces=traces,
                )))
            elif status == 2:
                results.append(TicketResult())  # duplicate: dropped
            else:
                results.append(TicketResult(nack=Nack(
                    operation=op,
                    sequence_number=running_seq,
                    error_type=NackErrorType.BAD_REQUEST,
                    message=_STATUS_MESSAGES.get(status, "rejected"),
                )))
        return results

    def ticket_batch_arrays(self, cids, csns, refs):
        """The true throughput lane: ticket a whole window with zero
        per-op Python objects. Inputs are int64 arrays (client ids
        already interned via ``intern_id``); returns (seq, msn, status)
        numpy arrays — exactly the numeric form the GPU sidecar's
        OpBatch wants, so sequencing feeds the device path without ever
        materializing SequencedMessage objects. Status 0 = sequenced,
        2 = duplicate (dropped), else nack (resolve via the scalar
        ``ticket`` path for the message/nack details — cold path)."""
        import numpy as np

        cids = np.ascontiguousarray(cids, dtype=np.int64)
        csns = np.ascontiguousarray(csns, dtype=np.int64)
        refs = np.ascontiguousarray(refs, dtype=np.int64)
        n = len(cids)
        out_seq = np.empty(n, np.int64)
        out_msn = np.empty(n, np.int64)
        out_status = np.empty(n, np.int32)
        p64 = ctypes.POINTER(ctypes.c_int64)
        p32 = ctypes.POINTER(ctypes.c_int32)
        self._lib.seq_ticket_batch(
            self._handle, n,
            cids.ctypes.data_as(p64),
            csns.ctypes.data_as(p64),
            refs.ctypes.data_as(p64),
            out_seq.ctypes.data_as(p64),
            out_msn.ctypes.data_as(p64),
            out_status.ctypes.data_as(p32),
        )
        return out_seq, out_msn, out_status

    def intern_id(self, client_id: str) -> int:
        """Public interning hook for the array lane (intern once per
        client, not per op)."""
        return self._intern_id(client_id)

    def system_message(self, msg_type: MessageType,
                       contents: Any) -> SequencedMessage:
        """Allocate a seq for a service-generated op (summaryAck/Nack
        loop back through the sequencer; they carry no client state,
        so the core just bumps its counter)."""
        seq = self._lib.seq_bump(self._handle)
        return self._system_msg(msg_type, contents, seq)

    # ------------------------------------------------------------------
    # checkpoint/restore (deli/checkpointContext.ts parity)

    def checkpoint(self) -> dict[str, Any]:
        n = self._lib.seq_client_count(self._handle)
        ids = (ctypes.c_int64 * n)()
        refs = (ctypes.c_int64 * n)()
        csns = (ctypes.c_int64 * n)()
        count = self._lib.seq_export_clients(
            self._handle, n, ids, refs, csns
        )
        return {
            "document_id": self.document_id,
            "sequence_number": self.sequence_number,
            "minimum_sequence_number": self.minimum_sequence_number,
            "clients": [
                {
                    "client_id": self._unintern[ids[i]],
                    "reference_sequence_number": refs[i],
                    "client_sequence_number": csns[i],
                }
                for i in range(count)
            ],
        }

    @classmethod
    def restore(cls, state: dict[str, Any],
                clock: Optional[Callable[[], float]] = None,
                ) -> "NativeSequencerCore":
        core = cls(
            document_id=state["document_id"],
            sequence_number=state["sequence_number"],
            minimum_sequence_number=state["minimum_sequence_number"],
            clock=clock,
        )
        for c in state["clients"]:
            core._lib.seq_restore_client(
                core._handle,
                core._intern_id(c["client_id"]),
                c["reference_sequence_number"],
                c["client_sequence_number"],
            )
        return core


class MultiDocSequencer:
    """A fleet of native sequencers ticketed in ONE FFI call per
    boxcar — the deli lambda's Kafka message-box shape (ops grouped by
    document, lambdas/src/deli/lambda.ts): the service plane's
    full-corpus replay path crosses the FFI boundary once per round,
    not once per document."""

    def __init__(self, n_docs: int):
        from . import load_native_sequencer

        lib = load_native_sequencer()
        if lib is None:
            from . import native_build_error

            raise RuntimeError(
                f"native sequencer unavailable: {native_build_error()}"
            )
        self._lib = lib
        self.n_docs = n_docs
        self._handles = (ctypes.c_void_p * n_docs)(
            *(lib.seq_create(0, 0) for _ in range(n_docs))
        )

    def __del__(self):  # pragma: no cover - interpreter teardown
        lib = getattr(self, "_lib", None)
        handles = getattr(self, "_handles", None)
        if lib is not None and handles is not None:
            for h in handles:
                if h:
                    lib.seq_destroy(h)
            self._handles = None

    def join(self, doc: int, client_idx: int) -> int:
        """Join an (interned) client to one document's quorum."""
        return self._lib.seq_client_join(self._handles[doc], client_idx)

    def doc_sequence_number(self, doc: int) -> int:
        return self._lib.seq_sequence_number(self._handles[doc])

    def ticket_boxcar(self, doc_start, cids, csns, refs):
        """Ticket one boxcar: flattened per-doc op slices delimited by
        ``doc_start`` (len n_docs+1). Returns (seq, msn, status) int64
        /int32 arrays aligned with the inputs — the numeric form the
        device OpBatch consumes directly (zero per-op Python)."""
        import numpy as np

        doc_start = np.ascontiguousarray(doc_start, np.int64)
        cids = np.ascontiguousarray(cids, np.int64)
        csns = np.ascontiguousarray(csns, np.int64)
        refs = np.ascontiguousarray(refs, np.int64)
        n = len(cids)
        out_seq = np.empty(n, np.int64)
        out_msn = np.empty(n, np.int64)
        out_status = np.empty(n, np.int32)
        p64 = ctypes.POINTER(ctypes.c_int64)
        p32 = ctypes.POINTER(ctypes.c_int32)
        self._lib.seq_ticket_multi(
            self._handles, self.n_docs,
            doc_start.ctypes.data_as(p64),
            cids.ctypes.data_as(p64),
            csns.ctypes.data_as(p64),
            refs.ctypes.data_as(p64),
            out_seq.ctypes.data_as(p64),
            out_msn.ctypes.data_as(p64),
            out_status.ctypes.data_as(p32),
        )
        return out_seq, out_msn, out_status
