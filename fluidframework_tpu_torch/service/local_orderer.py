"""In-process orderer: the full deli -> {scriptorium, scribe,
broadcaster} pipeline for one document.

Reference: server/routerlicious/packages/memory-orderer/src/
localOrderer.ts (``setupLambdas`` :237) — the whole service in-proc
over an in-memory Kafka; used by tinylicious/local-server and every
integration test (SURVEY §4 pillar (c)).
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
                 storage_breaker=None, write_fence=None,
                 clock=None):
        import os

        from .telemetry import Lumberjack
        self.document_id = document_id
        self.lumberjack = lumberjack or Lumberjack()
        # injectable wall clock for the sequencer's wire timestamps
        # (None = real wall time); survives checkpoint restore and
        # the checkpoint-ahead rebuild below
        self.clock = clock
        self.storage = storage
        # optional epoch-fence hook (service/replication.py), called
        # with the operation name ("submit"/"connect"/"disconnect" —
        # the truthful context for refusal diagnostics): consulted
        # BEFORE ticketing, so a deposed leader refuses a write
        # without consuming a sequence number — its sequencer state
        # stays aligned with its (refused) log
        self.write_fence = write_fence
        # optional qos.CircuitBreaker around checkpoint writes: a
        # hard-down disk degrades durability (the op log still has
        # every op; restart fast-forwards from it) instead of taking
        # the sequencing path down with it
        self.storage_breaker = storage_breaker
        self.op_log = storage.op_log if storage is not None else OpLog()
        self.summary_store = SummaryStore(storage)
        self.sequencer = DocumentSequencer(document_id, clock=clock)
        if os.environ.get("FFTPU_NATIVE_SEQUENCER") == "1":
            try:
                from ..native import NativeSequencerCore
                self.sequencer = NativeSequencerCore(document_id,
                                                     clock=clock)
            except (RuntimeError, OSError) as e:
                # toolchain unavailable: the Python path stands in,
                # but an env var that asked for the native core and
                # didn't get it must not fall back silently
                import sys

                print(
                    f"orderer[{document_id}]: FFTPU_NATIVE_SEQUENCER"
                    f"=1 but the native core is unavailable "
                    f"({type(e).__name__}: {e}); using the Python "
                    "sequencer",
                    file=sys.stderr,
                )
        self._checkpoint_every = checkpoint_every
        self._since_checkpoint = 0
        # leaves that could not replicate during a quorum-loss
        # degraded window (absorbed, not sequenced): settled at the
        # client's next join — sequencing the owed leave FIRST resets
        # the csn watermark, or the rejoining client's resubmits
        # would be silently swallowed by the duplicate-csn dedupe
        # (found by the netsplit differential as a merge-tree
        # view-length divergence three hops downstream)
        self._owed_leaves: set[str] = set()
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
                self.sequencer = type(self.sequencer)(
                    document_id, clock=clock)
            # ops sequenced after the last checkpoint write (or with a
            # lost/absent checkpoint entirely) are in the durable log;
            # fast-forward the stream position so new tickets continue
            # the contiguous order
            if hasattr(self.sequencer, "fast_forward"):
                self.sequencer.fast_forward(self.op_log.last_seq)
            else:
                # implementations without the O(1) resume (the native
                # core) walk the gap the old way
                gap = (self.op_log.last_seq
                       - self.sequencer.sequence_number)
                for _ in range(max(0, gap)):
                    self.sequencer.system_message(
                        MessageType.NO_OP, None)
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
        if self.write_fence is not None:
            # refuse BEFORE the join consumes a sequence number: a
            # deposed leader's sequencer must stay aligned with its
            # (refused) log, or the unwind path's leave trips the
            # log-contiguity assert instead of the fence
            self.write_fence("connect")
            if detail.client_id in self._owed_leaves:
                # settle the leave the degraded window absorbed (the
                # gate above proved availability): the sequenced
                # leave resets the client's csn watermark, so the
                # reconnect's fresh csn 1 is a new stream, never a
                # "duplicate" the dedupe silently swallows
                pre_leave = self.sequencer.checkpoint()
                leave = self.sequencer.client_leave(detail.client_id)
                if leave is not None:
                    try:
                        self._dispatch(leave)
                    except self._unavailable_error():
                        # the window reopened between the gate and
                        # the leave's own barrier: still owed
                        self._rollback_ticket(pre_leave)
                        raise
                self._owed_leaves.discard(detail.client_id)
            # the join may still be the FIRST write to discover a
            # quorum loss (the barrier's deadline, not the cached
            # gate): snapshot so the refused ticket rolls back
            pre = self.sequencer.checkpoint()
            join = self.sequencer.client_join(detail)
            try:
                self._dispatch(join)
            except self._unavailable_error():
                self._rollback_ticket(pre)
                raise
            return join
        join = self.sequencer.client_join(detail)
        self._dispatch(join)
        return join

    def _unavailable_error(self):
        from .replication import QuorumUnavailableError

        return QuorumUnavailableError

    def _rollback_ticket(self, pre: dict) -> None:
        """Unwind a ticket whose replication was refused (quorum
        unavailable): the op log already unwound its append, so
        restoring the pre-ticket sequencer state re-aligns stream
        position, client table and msn — the seq slot is re-issued
        to the next accepted write. Only legal because the refused
        message never reached the broadcaster (scriptorium raises
        before the scribe/broadcaster stages run).

        The DURABLE LOG is the reconciliation floor: a re-entrant
        dispatch (a scribe loopback ack queued behind the ticketed
        op) may have quorum-committed intermediate ops AFTER the
        checkpoint was taken — rolling the sequencer below the log
        head would re-issue a seq the quorum already holds, so the
        restore fast-forwards back to the head. (A client whose op
        landed in that window may then see one csn-gap nack and ride
        the normal reconnect path — rare, loud, and ordered; never a
        fork.) Refused messages still queued from the aborted pump
        are dropped: never persisted, never fanned out, their
        submitters still hold them pending."""
        self.sequencer = type(self.sequencer).restore(
            pre, clock=self.clock)
        if hasattr(self.sequencer, "fast_forward"):
            self.sequencer.fast_forward(self.op_log.last_seq)
        else:
            gap = (self.op_log.last_seq
                   - self.sequencer.sequence_number)
            for _ in range(max(0, gap)):
                self.sequencer.system_message(MessageType.NO_OP, None)
        self._dispatch_queue.clear()
        self.scribe.protocol.sequence_number = \
            self.sequencer.sequence_number
        self.scribe.protocol.minimum_sequence_number = \
            self.sequencer.minimum_sequence_number

    def disconnect(self, client_id: str) -> Optional[SequencedMessage]:
        if self.write_fence is not None:
            from .replication import FencedWriteError

            try:
                self.write_fence("disconnect")
            except FencedWriteError:
                # teardown on a DEPOSED node must not detonate:
                # session close() runs this mid-cleanup (a transport
                # death during the deposed window), and a leave a
                # fenced node sequences could never reach a client
                # anyway — skip sequencing it; the client's lifecycle
                # continues on the real leader
                return None
            except self._unavailable_error():
                # quorum-loss degraded window: the leave cannot
                # replicate — absorbed, but OWED (see connect): the
                # cached verdict refuses it pre-ticket, so teardown
                # costs a flag, not a quorum deadline
                self._owed_leaves.add(client_id)
                return None
            pre = self.sequencer.checkpoint()
            leave = self.sequencer.client_leave(client_id)
            if leave is not None:
                try:
                    self._dispatch(leave)
                except self._unavailable_error():
                    # a leave that cannot replicate (quorum-loss
                    # window) is absorbed like the fenced teardown —
                    # but OWED: the client's next join sequences it
                    # first, resetting the csn watermark the stale
                    # entry would otherwise hold
                    self._rollback_ticket(pre)
                    self._owed_leaves.add(client_id)
                    return None
            return leave
        leave = self.sequencer.client_leave(client_id)
        if leave is not None:
            self._dispatch(leave)
        return leave

    def submit(self, client_id: str,
               op: DocumentMessage) -> Optional[Nack]:
        pre = None
        if self.write_fence is not None:
            try:
                # raises FencedWriteError when deposed; the
                # availability gate (quorum-loss degraded mode)
                # raises the RETRIABLE refusal, converted to a
                # throttle nack here so the client's pending/resubmit
                # path rides it with no new machinery
                self.write_fence("submit")
            except self._unavailable_error() as e:
                return self._unavailable_nack(op, e)
            # full checkpoint, not a scalar snapshot: checkpoint()/
            # restore() is the only rollback surface BOTH sequencer
            # implementations (python + native core) share, and its
            # cost is O(connected clients of THIS document) — the
            # collaborator count, not the fleet — paid only on the
            # replicated plane (write_fence unset = plain plane,
            # zero overhead)
            pre = self.sequencer.checkpoint()
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
            if pre is None:
                self._dispatch(result.message)
                return None
            try:
                self._dispatch(result.message)
            except self._unavailable_error() as e:
                # the quorum barrier's deadline lapsed mid-append:
                # the op log unwound its record; unwind the ticket
                # too and answer with the retriable nack
                self._rollback_ticket(pre)
                return self._unavailable_nack(op, e)
        return None

    def _unavailable_nack(self, op: DocumentMessage, e) -> Nack:
        from ..qos.policy import REASON_UNAVAILABLE
        from ..protocol.messages import NackErrorType

        nack = Nack(
            operation=op, sequence_number=0,
            error_type=NackErrorType.THROTTLING,
            message=str(e),
            retry_after_seconds=e.retry_after_seconds,
            shed_class=REASON_UNAVAILABLE,
        )
        self.lumberjack.log("nack", nack.message, {
            "documentId": self.document_id,
            "errorType": int(nack.error_type),
            "shedClass": REASON_UNAVAILABLE,
        })
        return nack

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
        # preserve the sequencer implementation (a NativeSequencerCore
        # must not silently degrade to the Python path on restart)
        self.sequencer = type(self.sequencer).restore(
            state["sequencer"], clock=self.clock
        )
        # scribe's replica resumes at the checkpointed stream position
        # (scribe/lambda.ts:108 skips replayed messages below it)
        self.scribe.protocol.sequence_number = self.sequencer.sequence_number
        self.scribe.protocol.minimum_sequence_number = (
            self.sequencer.minimum_sequence_number
        )
