"""Service pipeline stages — the routerlicious lambda equivalents.

Reference: server/routerlicious/packages/lambdas/src:
- deli (lambda.ts:192): sequencing — our ``DocumentSequencer`` wrapped
  by the orderer,
- scriptorium (scriptorium/lambda.ts:20): durable op log writes,
- broadcaster (broadcaster/lambda.ts:49): fan-out to connections,
- scribe (scribe/lambda.ts:46): server-side protocol replica that
  validates summaries and emits summaryAck/Nack.

Stages are synchronous callables over sequenced messages; the orderer
pipes deli's output through them in order (the reference's Kafka topics
collapse to direct calls in-proc, exactly like memory-orderer's
LocalKafka).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..obs import metrics as _metrics
from ..obs.trace import stamp as _stamp
from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.quorum import ProtocolOpHandler

_BROADCASTS = _metrics.REGISTRY.counter(
    "broadcaster_fanouts_total",
    "sequenced messages fanned out to subscribers")
_OPLOG_WRITES = _metrics.REGISTRY.counter(
    "scriptorium_writes_total", "sequenced ops persisted to the log")


class OpLog:
    """Scriptorium's Mongo op collection, in memory: the durable
    sequenced-op store backing delta storage reads
    (scriptorium/lambda.ts:20)."""

    def __init__(self) -> None:
        self._ops: list[SequencedMessage] = []

    def append(self, msg: SequencedMessage) -> None:
        if self._ops:
            assert msg.sequence_number == self._ops[-1].sequence_number + 1, (
                "op log must stay contiguous"
            )
        self._ops.append(msg)
        self._persist_append(msg)

    def read(self, from_seq: int, to_seq: Optional[int] = None
             ) -> list[SequencedMessage]:
        """Ops with from_seq < seq <= to_seq (delta-storage range
        semantics)."""
        out = []
        for msg in self._ops:
            if msg.sequence_number <= from_seq:
                continue
            if to_seq is not None and msg.sequence_number > to_seq:
                break
            out.append(msg)
        return out

    def truncate_below(self, seq: int) -> int:
        """Drop ops at/below ``seq`` (durableSequenceNumber advance —
        deli/lambda.ts:342 area). Returns dropped count."""
        before = len(self._ops)
        self._ops = [m for m in self._ops if m.sequence_number > seq]
        dropped = before - len(self._ops)
        if dropped:
            self._persist_truncate()
        return dropped

    # durability hooks (FileOpLog overrides; mirror of
    # ContentStore._store/_load)
    def _persist_append(self, msg: SequencedMessage) -> None:
        pass

    def _persist_truncate(self) -> None:
        pass

    @property
    def last_seq(self) -> int:
        return self._ops[-1].sequence_number if self._ops else 0

    def __len__(self) -> int:
        return len(self._ops)


class ScriptoriumLambda:
    def __init__(self, op_log: OpLog, clock=None):
        self.op_log = op_log
        # injectable wall clock for the hop stamp that PERSISTS with
        # the op (the log is a recorded corpus: on a manual clock it
        # must be byte-stable); None = stamp() wall default
        self._clock = clock

    def handler(self, msg: SequencedMessage) -> None:
        _stamp(msg.traces, "scriptorium", "write",
               timestamp=self._clock() if self._clock else None)
        _OPLOG_WRITES.inc()
        self.op_log.append(msg)


class CopierLambda:
    """copier — verbatim RAW-op capture BEFORE sequencing
    (lambdas/src/copier: writes the pre-deli input stream so the exact
    bytes a client submitted survive for audit/replay even when deli
    nacks or dedups them)."""

    def __init__(self, sink: Optional[list] = None) -> None:
        self.raw: list = sink if sink is not None else []

    def handler(self, document_id: str, client_id: str,
                payload: Any) -> None:
        import copy as _copy

        self.raw.append({
            "document_id": document_id,
            "client_id": client_id,
            "payload": _copy.deepcopy(payload),
        })

    def read(self, document_id: Optional[str] = None) -> list:
        """Deep copies: the capture is the audit record — a consumer
        mutating a returned dict must not corrupt it."""
        import copy as _copy

        return [_copy.deepcopy(r) for r in self.raw
                if document_id is None
                or r["document_id"] == document_id]


class BroadcasterLambda:
    """broadcaster/lambda.ts:49 — per-document fan-out."""

    def __init__(self, clock=None) -> None:
        self._subscribers: dict[str, Callable[[SequencedMessage], None]] = {}
        self._clock = clock

    def subscribe(self, subscriber_id: str,
                  handler: Callable[[SequencedMessage], None]) -> None:
        self._subscribers[subscriber_id] = handler

    def unsubscribe(self, subscriber_id: str) -> None:
        self._subscribers.pop(subscriber_id, None)

    def handler(self, msg: SequencedMessage) -> None:
        _stamp(msg.traces, "broadcaster", "fanout",
               timestamp=self._clock() if self._clock else None)
        _BROADCASTS.inc()
        for handler in list(self._subscribers.values()):
            handler(msg)


@dataclass
class ServiceSummary:
    sequence_number: int
    summary: dict
    timestamp: float = field(default_factory=time.time)


class SummaryStore:
    """Versioned summary storage (historian/gitrest facade): summaries
    are split into content-addressed subtree objects, incremental
    {"__summary_handle__": path} nodes are resolved against the
    previous version (SummaryType.Handle, summary.ts:55-59), and an
    unchanged subtree costs zero new objects. In-memory by default; a
    ``DocumentStorage`` backend makes it durable on disk."""

    def __init__(self, storage=None) -> None:
        from .storage import SummaryTreeStore

        self._storage = storage
        if storage is not None:
            self._trees = storage.trees
            self._mem_roots = None  # storage.versions is canonical
        else:
            self._trees = SummaryTreeStore()
            self._mem_roots: Optional[list[tuple[int, str]]] = []

    def write(self, sequence_number: int, summary: dict) -> str:
        """Store a summary (resolving handles); returns the root sha —
        the ack handle clients see (summaryAck.handle)."""
        return self.commit(sequence_number, self.stage(summary))

    def stage(self, summary: dict) -> str:
        """The client-upload half of the historian flow
        (driver-definitions/src/storage.ts:119
        uploadSummaryWithContext): write the tree CONTENT — resolving
        incremental handles against the last committed version — and
        return the root sha WITHOUT recording a version. The sha is
        the handle a summarize op proposes; scribe's ack commits it."""
        if self._storage is not None:
            prev = (self._storage.versions[-1].root
                    if self._storage.versions else None)
        else:
            prev = self._mem_roots[-1][1] if self._mem_roots else None
        return self._trees.write(summary, previous_root=prev)

    def has_tree(self, root: str) -> bool:
        """Is ``root`` a staged/committed tree in the content store?"""
        return self._trees.store.has(root)

    def commit(self, sequence_number: int, root: str) -> str:
        """Record a staged tree as the version at ``sequence_number``
        (scribe ack — the summary becomes the document's loadable
        state)."""
        if self._storage is not None:
            return self._storage.commit_summary(sequence_number, root)
        self._mem_roots.append((sequence_number, root))
        return root

    def latest(self) -> Optional[ServiceSummary]:
        if self._storage is not None:
            if not self._storage.versions:
                return None
            v = self._storage.versions[-1]
            return ServiceSummary(
                v.sequence_number, self._trees.read(v.root)
            )
        if not self._mem_roots:
            return None
        seq, root = self._mem_roots[-1]
        return ServiceSummary(seq, self._trees.read(root))

    @property
    def version_count(self) -> int:
        if self._storage is not None:
            return len(self._storage.versions)
        return len(self._mem_roots)

    def object_count(self) -> int:
        return self._trees.store.object_count()


class ScribeLambda:
    """scribe/lambda.ts:46 — holds a server-side ProtocolOpHandler,
    validates client summaries, writes service summaries, and emits
    summaryAck ops back through the sequencer."""

    def __init__(self, summary_store: SummaryStore,
                 submit_system_op: Callable[[MessageType, Any], None],
                 op_log: Optional[OpLog] = None, clock=None):
        self.protocol = ProtocolOpHandler()
        self.summary_store = summary_store
        self._submit_system_op = submit_system_op
        self._op_log = op_log
        self._clock = clock

    def handler(self, msg: SequencedMessage) -> None:
        _stamp(msg.traces, "scribe", "process",
               timestamp=self._clock() if self._clock else None)
        self.protocol.process_message(msg)
        if msg.type == MessageType.SUMMARIZE:
            self._handle_summarize(msg)

    def _handle_summarize(self, msg: SequencedMessage) -> None:
        contents = msg.contents or {}
        summary = contents.get("summary")
        staged = contents.get("handle")
        if isinstance(staged, str) and summary is None:
            # the reference flow (containerRuntime.ts:2477): the
            # summarizer client uploaded the tree to storage first and
            # proposes only the handle; scribe validates it exists and
            # commits the version
            if not self.summary_store.has_tree(staged):
                self._submit_system_op(MessageType.SUMMARY_NACK, {
                    "summaryProposal": msg.sequence_number,
                    "message": f"unknown summary handle {staged!r}",
                })
                return
            handle = self.summary_store.commit(
                msg.sequence_number, staged
            )
        elif isinstance(summary, dict):
            # inline payload (in-proc sessions without a storage plane)
            handle = self.summary_store.write(
                msg.sequence_number, summary
            )
        else:
            self._submit_system_op(MessageType.SUMMARY_NACK, {
                "summaryProposal": msg.sequence_number,
                "message": "malformed summary payload",
            })
            return
        # Ack advances the durable sequence number: ops at/below the
        # summarized seq can be truncated from the log (§3.4).
        if self._op_log is not None:
            self._op_log.truncate_below(
                contents.get("referenceSequenceNumber", 0)
            )
        self._submit_system_op(MessageType.SUMMARY_ACK, {
            "summaryProposal": msg.sequence_number,
            "handle": handle,
        })
