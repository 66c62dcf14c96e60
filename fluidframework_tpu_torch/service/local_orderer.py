"""In-process orderer: the full deli -> {scriptorium, scribe,
broadcaster} pipeline for one document.

Reference: server/routerlicious/packages/memory-orderer/src/
localOrderer.ts (``setupLambdas`` :237) — the whole service in-proc
over an in-memory Kafka; used by tinylicious/local-server and every
integration test (SURVEY §4 pillar (c)).

The port's copy leaves out the replicated plane's write fence (the
epoch fence, the quorum-loss rollback and the owed leaves) and the
native sequencer core: they come with the replication and native
layers.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Optional

from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    Nack,
    SequencedMessage,
)
from .lambdas import (
    BroadcasterLambda,
    OpLog,
    ScribeLambda,
    ScriptoriumLambda,
    SummaryStore,
)
from .sequencer import DocumentSequencer


class LocalOrderer:
    """One document's ordering service instance."""

    def __init__(self, document_id: str, lumberjack=None,
                 storage=None, checkpoint_every: int = 1,
                 storage_breaker=None, clock=None):
        from .telemetry import Lumberjack
        self.document_id = document_id
        self.lumberjack = lumberjack or Lumberjack()
        # injectable wall clock for the sequencer's wire timestamps
        # (None = real wall time); survives checkpoint restore and
        # the checkpoint-ahead rebuild below
        self.clock = clock
        self.storage = storage
        # optional qos.CircuitBreaker around checkpoint writes: a
        # hard-down disk degrades durability (the op log still has
        # every op; restart fast-forwards from it) instead of taking
        # the sequencing path down with it
        self.storage_breaker = storage_breaker
        self.op_log = storage.op_log if storage is not None else OpLog()
        self.summary_store = SummaryStore(storage)
        self.sequencer = DocumentSequencer(document_id, clock=clock)
        self._checkpoint_every = checkpoint_every
        self._since_checkpoint = 0
        self.scriptorium = ScriptoriumLambda(self.op_log, clock=clock)
        self.broadcaster = BroadcasterLambda(clock=clock)
        self.scribe = ScribeLambda(
            self.summary_store, self._submit_system_op, self.op_log,
            clock=clock,
        )
        # deli out-topic consumers, in order (localOrderer.ts:237)
        self._pipeline: list[Callable[[SequencedMessage], None]] = [
            self.scriptorium.handler,
            self.scribe.handler,
            self.broadcaster.handler,
        ]
        # The reference decouples stages with Kafka topics; in-proc we
        # flatten re-entrancy with a pump: a submit made from inside a
        # delivery enqueues and is dispatched after the current message
        # finishes (LocalKafka's async delivery, memory-orderer).
        self._dispatch_queue: deque[SequencedMessage] = deque()  # fluidlint: disable=service-unbounded-queue -- drained to empty inside _dispatch before control returns to the submitter; depth is bounded by re-entrant submits within ONE pump, not by client traffic
        self._dispatching = False
        if storage is not None:
            state = storage.read_checkpoint()
            if state is not None:
                self.restore(state)
            if self.sequencer.sequence_number > self.op_log.last_seq:
                # checkpoint AHEAD of the op log: with the storage
                # barriers (scriptorium fsyncs its append before the
                # checkpoint of that dispatch writes) this state is
                # unreachable from a crash — it means a pre-barrier
                # data dir or a log that lost a torn tail the
                # checkpoint saw. The log is the truth the clients
                # were (never) told: discard the checkpoint and
                # rebuild from the log alone, loudly. (The scribe
                # replica needs no reset here: the unconditional
                # fast-forward below re-anchors it to the rebuilt
                # sequencer either way.)
                import sys

                print(
                    f"orderer[{document_id}]: checkpoint at seq "
                    f"{self.sequencer.sequence_number} is AHEAD of "
                    f"the op log (seq {self.op_log.last_seq}); "
                    "discarding it and fast-forwarding from the log",
                    file=sys.stderr,
                )
                self.sequencer = DocumentSequencer(document_id,
                                                   clock=clock)
            # ops sequenced after the last checkpoint write (or with a
            # lost/absent checkpoint entirely) are in the durable log;
            # fast-forward the stream position so new tickets continue
            # the contiguous order
            self.sequencer.fast_forward(self.op_log.last_seq)
            # scribe's replica must fast-forward with the log too, or
            # the first post-restart message trips its contiguity
            # check (scribe/lambda.ts:108 skips below-checkpoint
            # messages the same way)
            self.scribe.protocol.sequence_number = (
                self.sequencer.sequence_number
            )
            self.scribe.protocol.minimum_sequence_number = (
                self.sequencer.minimum_sequence_number
            )
            # every pre-crash connection is gone: sequence leaves for
            # the checkpointed clients so (a) their stale csn state
            # cannot silently swallow a reconnecting client's ops as
            # duplicates, and (b) their refSeqs stop pinning the msn
            for cid in list(self.sequencer.clients):
                self.disconnect(cid)

    @property
    def inbox_depth(self) -> int:
        """Undispatched sequenced messages (the deli-inbox depth the
        qos pressure monitor samples; nonzero only mid-pump)."""
        return len(self._dispatch_queue)

    # ------------------------------------------------------------------
    # ingress (alfred submitOp path)

    def connect(self, detail: ClientDetail) -> SequencedMessage:
        join = self.sequencer.client_join(detail)
        self._dispatch(join)
        return join

    def disconnect(self, client_id: str) -> Optional[SequencedMessage]:
        leave = self.sequencer.client_leave(client_id)
        if leave is not None:
            self._dispatch(leave)
        return leave

    def submit(self, client_id: str,
               op: DocumentMessage) -> Optional[Nack]:
        result = self.sequencer.ticket(client_id, op)
        if result.nack is not None:
            # structured service telemetry (Lumberjack, lumber.ts:23)
            self.lumberjack.log("nack", result.nack.message, {
                "documentId": self.document_id,
                "clientId": client_id,
                "errorType": int(result.nack.error_type),
            })
            return result.nack
        if result.message is not None:
            self._dispatch(result.message)
        return None

    # ------------------------------------------------------------------

    def _submit_system_op(self, msg_type: MessageType,
                          contents: Any) -> None:
        """Scribe emits summaryAck/Nack as service-generated sequenced
        ops (scribe -> deli loopback)."""
        self._dispatch(self.sequencer.system_message(msg_type, contents))

    def _dispatch(self, msg: SequencedMessage) -> None:
        self._dispatch_queue.append(msg)
        if self._dispatching:
            return
        self._dispatching = True
        try:
            while self._dispatch_queue:
                current = self._dispatch_queue.popleft()
                for stage in self._pipeline:
                    stage(current)
                self._since_checkpoint += 1
        finally:
            self._dispatching = False
        if (
            self.storage is not None
            and self._since_checkpoint >= self._checkpoint_every
        ):
            self._since_checkpoint = 0
            self._write_checkpoint_guarded()

    def _write_checkpoint_guarded(self) -> None:
        """Checkpoint write, optionally circuit-broken: with a
        breaker, a failing disk is recorded (and the breaker
        eventually refuses instantly instead of paying the fault per
        op) but sequencing continues — the op log is the recovery
        path. Without one, faults propagate as before."""
        if self.storage_breaker is None:
            self.storage.write_checkpoint(self.checkpoint())
            return
        from ..qos import BreakerOpenError

        try:
            self.storage_breaker.call(
                self.storage.write_checkpoint, self.checkpoint()
            )
        except BreakerOpenError:
            pass  # open: refusal already counted by the breaker
        except OSError as e:
            # recorded as a breaker failure by call(); degrade, don't
            # kill the submit path — restart replays the op log
            self.lumberjack.log("checkpointFailed", str(e), {
                "documentId": self.document_id,
            })

    # ------------------------------------------------------------------
    # checkpoint/resume (deli/checkpointContext.ts + scribe state)

    def checkpoint(self) -> dict:
        return {"sequencer": self.sequencer.checkpoint()}

    def restore(self, state: dict) -> None:
        self.sequencer = DocumentSequencer.restore(
            state["sequencer"], clock=self.clock
        )
        # scribe's replica resumes at the checkpointed stream position
        # (scribe/lambda.ts:108 skips replayed messages below it)
        self.scribe.protocol.sequence_number = self.sequencer.sequence_number
        self.scribe.protocol.minimum_sequence_number = (
            self.sequencer.minimum_sequence_number
        )
