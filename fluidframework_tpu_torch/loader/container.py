"""Container + delta management: the loader layer.

Reference: packages/loader/container-loader/src — ``Container``
(container.ts:270, load path, ``processRemoteMessage`` :1724),
``DeltaManager`` (deltaManager.ts:96: inbound queue, gap detection +
``fetchMissingDeltas`` :883, ``submit`` :213), ``ConnectionManager``
(connectionManager.ts:152: reconnect), protocol handler + quorum
wiring (src/protocol.ts).

One Container = one client's live replica of one document: it loads
from the latest service summary plus trailing ops, keeps a contiguous
inbound stream (fetching gaps from delta storage), routes ops into its
ContainerRuntime, and stamps outbound ops with csn/refSeq.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
import time
from typing import Any, Optional

from ..drivers.definitions import DocumentService
from ..drivers.driver_utils import derived_seed, full_jitter_delay
from ..models import default_registry
from ..obs import metrics as obs_metrics
from ..obs import register_closeable
from ..obs.trace import stamp as trace_stamp
from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    Nack,
    NackErrorType,
    SequencedMessage,
)
from ..protocol.quorum import ProtocolOpHandler
from ..runtime import ChannelRegistry, ContainerRuntime
from ..utils.events import EventEmitter
from .collab_window import CollabWindowTracker
from .scheduler import DeltaScheduler, ScheduleManager

# per-process construction ordinal feeding derived_seed: container
# backoff streams are distinct but replay together from FFTPU_SEED
_CONTAINER_COUNTER = itertools.count()

_OPS_SUBMITTED = obs_metrics.REGISTRY.counter(
    "container_ops_submitted_total",
    "runtime ops this process's containers put on the wire")
_OPS_ACKED = obs_metrics.REGISTRY.counter(
    "container_ops_acked_total",
    "own ops seen back sequenced (submit→ack completed)")
_NACKS_SEEN = obs_metrics.REGISTRY.counter(
    "container_nacks_total", "nacks containers received")
_ROUNDTRIP_MS = obs_metrics.REGISTRY.histogram(
    "container_op_roundtrip_ms", "submit→ack wall latency per own op")
_THROTTLE_DEFERRALS = obs_metrics.REGISTRY.counter(
    "container_throttle_deferrals_total",
    "flushes that deferred reconnect/resubmit under a throttle nack")
_DUP_DROPS = obs_metrics.REGISTRY.counter(
    "container_duplicate_drops_total",
    "inbound sequenced messages dropped as duplicate deliveries")
_CATCHUP_OPS = obs_metrics.REGISTRY.counter(
    "container_catchup_ops_total",
    "ops refetched from delta storage (gap refetch + reconnect "
    "catch-up)")


class Container(EventEmitter):
    def __init__(self, service: DocumentService,
                 registry: Optional[ChannelRegistry] = None,
                 client_id: str = "",
                 mc: Optional["MonitoringContext"] = None):
        from ..utils.config import MonitoringContext
        from ..utils.telemetry import (
            SampledTelemetryHelper,
            TelemetryLogger,
        )
        super().__init__()
        self.service = service
        self.client_id = client_id
        # telemetry/config travel together (mixinMonitoringContext)
        self.mc = mc or MonitoringContext(TelemetryLogger())
        self._sent_times: dict[int, float] = {}
        # op-roundtrip latency, sampled (connectionTelemetry.ts:288);
        # registered with the obs shutdown path so tail measurements
        # flush even when close() is never reached
        self._op_latency = SampledTelemetryHelper(
            self.mc.logger, "opRoundtripTime", sample_every=20,
        )
        register_closeable(self._op_latency)
        # per-op submit→ack trace attribution (obs pillar 1): the
        # newest acked ops' full hop breakdowns, via op_breakdown()
        from ..runtime.op_lifecycle import OpLatencyLedger

        self.op_ledger = OpLatencyLedger()
        self.runtime = ContainerRuntime(registry or default_registry())
        self.runtime.set_submit_fn(self._submit_runtime_op)
        self.protocol = ProtocolOpHandler()
        self.last_processed_seq = 0
        self._connection = None
        self._csn = 0
        self.closed = False
        # incremental-summary bookkeeping: per-channel change counts
        # captured at submit, promoted on the matching summaryAck
        self._acked_summary_counts: Optional[dict] = None
        self._pending_summary_counts: Optional[dict] = None
        self._pending_summary_seq: Optional[int] = None
        self._pending_summary_csn: Optional[int] = None
        # feature gates read ad hoc from config (config.ts pattern,
        # e.g. containerRuntime.ts:1704)
        compression_min = self.mc.config.get_number("compressionMinSize")
        if compression_min is not None:
            self.runtime.compressor.min_size = int(compression_min)
        chunk_size = self.mc.config.get_number("chunkSize")
        if chunk_size is not None:
            self.runtime.splitter.chunk_size = int(chunk_size)
        # inbound scheduling: batch integrity + sliced draining
        self._schedule = ScheduleManager()
        self._scheduler = DeltaScheduler(self._process)
        self.inbound_paused = False
        self._enqueued_seq = 0
        self._reconnect_on_nack = False
        # throttle-nack backoff (the client half of the qos
        # contract): a THROTTLING nack defers the reconnect/resubmit
        # until retry_after_seconds + full jitter has passed, with
        # consecutive throttles escalating the jitter span.
        # Injectable clock/rng so tests pin the schedule exactly.
        self._throttled_until = 0.0
        self._throttle_strikes = 0
        self._backoff_clock = time.monotonic
        # derived from the ONE surfaced process jitter seed
        # (FFTPU_SEED pins it): distinct stream per container (jitter
        # must decorrelate clients) but a throttle-storm schedule
        # still replays from the single recorded seed given the same
        # construction order
        self._backoff_seed = derived_seed(next(_CONTAINER_COUNTER))
        self._backoff_rng = random.Random(self._backoff_seed)
        # msn heartbeats for idle clients (collabWindowTracker.ts);
        # noopCountFrequency=0 disables count-based heartbeats
        noop_every = self.mc.config.get_number("noopCountFrequency")
        self.collab_window = CollabWindowTracker(
            self._submit_noop,
            max_unacked_ops=(
                int(noop_every) if noop_every is not None else 50
            ),
        )

    # ------------------------------------------------------------------
    # load (container.ts load path, §3.3)

    @classmethod
    def load(cls, service: DocumentService,
             registry: Optional[ChannelRegistry] = None,
             client_id: str = "", connect: bool = True,
             mc: Optional["MonitoringContext"] = None,
             replay_trailing: bool = True,
             pending_state: Optional[dict] = None) -> "Container":
        """``replay_trailing=False`` loads only the snapshot, leaving
        trailing-op replay to the caller (replay tool's step-by-step
        mode). ``pending_state`` rehydrates an offline stash produced
        by ``close_and_get_pending_state`` — stashed local ops
        re-apply as pending and resubmit (rebased) on connect."""
        container = cls(service, registry, client_id, mc=mc)
        latest = service.get_latest_summary()
        if pending_state is not None and latest is not None and \
                latest[0] > pending_state.get("lastProcessedSeq", 0):
            # the service summarized PAST the stash point: the stash's
            # positions need the older view, so rehydrate from the op
            # log instead of the snapshot — possible only while the
            # log still retains the range (summary acks truncate it,
            # scribe -> OpLog.truncate_below)
            probe = service.read_ops(0, 1)
            if not probe or probe[0].sequence_number != 1:
                raise ValueError(
                    "stash predates the service's op retention (a "
                    "newer summary truncated the log below the stash "
                    "point); the offline edits cannot be rebased "
                    "exactly — rehydrate against a service retaining "
                    "the full log, or discard the stash"
                )
            latest = None
        if latest is not None:
            version_seq, summary = latest
            container.runtime.load(summary.get("runtime", summary))
            proto = summary.get("protocol")
            if proto:
                container.protocol = ProtocolOpHandler(
                    minimum_sequence_number=proto["minimumSequenceNumber"],
                    sequence_number=proto["sequenceNumber"],
                    members={
                        cid: ClientDetail(**detail)
                        for cid, detail in proto["members"].items()
                    },
                    values=proto["values"],
                )
                # catch-up resumes at the snapshot's stream position,
                # not the summary version's seq (the summarize op
                # itself sequences after the snapshotted state)
                base_seq = proto["sequenceNumber"]
            else:
                container.protocol = ProtocolOpHandler(
                    minimum_sequence_number=version_seq,
                    sequence_number=version_seq,
                )
                base_seq = version_seq
            container.last_processed_seq = base_seq
        # catch-up trailing ops from delta storage ("DocumentOpen",
        # deltaManager.ts:451)
        if pending_state is not None:
            # stashed ops carry positions valid at the stash-time view:
            # replay the log up to that point, apply the stash as
            # pending local state, then let the remaining ops flow
            # through the NORMAL inbound path so pending state rebases
            # over them exactly like live concurrency (container.ts
            # offline load: stashed ops interleave at their refSeq)
            stash_seq = pending_state.get("lastProcessedSeq", 0)
            assert container.last_processed_seq <= stash_seq, (
                "stash is older than the base snapshot; re-fetch an "
                "older snapshot to rehydrate it"
            )
            for msg in service.read_ops(
                container.last_processed_seq, stash_seq
            ):
                container._process(msg)
            container.runtime.apply_stashed_state(
                pending_state.get("pending", [])
            )
        if replay_trailing:
            for msg in service.read_ops(container.last_processed_seq):
                container._process(msg)
        if connect:
            container.connect()
        return container

    def close_and_get_pending_state(self, force: bool = False) -> dict:
        """closeAndGetPendingLocalState (container.ts): serialize the
        pending local ops + stream position, close the container, and
        return the stash. Rehydrate later with
        ``Container.load(..., pending_state=state)`` — the offline
        edits apply as pending and resubmit on connect.

        Disconnects FIRST so unflushed edits stay local instead of
        racing onto the wire at stash time (they would sequence AND
        ride the stash — double-apply). Ops already sent but not yet
        acknowledged are the same hazard from an earlier flush; by
        default stashing refuses while any exist (process inbound acks
        or stay offline before stashing); ``force=True`` accepts the
        potential duplication."""
        self.disconnect()
        if self._sent_times and not force:
            raise ValueError(
                f"{len(self._sent_times)} op(s) in flight "
                "(sent, unacknowledged): draining them first is "
                "required for an exact stash — pass force=True to "
                "stash anyway and accept potential duplication"
            )
        state = {
            "clientId": self.client_id,
            "lastProcessedSeq": self.last_processed_seq,
            "pending": self.runtime.get_pending_state(),
        }
        self.close()
        return state

    # ------------------------------------------------------------------
    # connection lifecycle (connectionManager.ts:152)

    @property
    def connected(self) -> bool:
        return self._connection is not None and self._connection.open

    def connect(self) -> None:
        assert not self.closed
        if self.connected:
            return
        if self.runtime.connected:
            # the transport died WITHOUT a clean disconnect (socket
            # death, injected disconnect, service crash): the runtime
            # never observed the drop, and set_connection_state(True)
            # below would see connected->connected and SKIP the
            # pending replay — stranding every pending op as a
            # permanent orphan at the front of the pending queue
            # (every later ack then pops the wrong entry — found by
            # the chaos crash-recovery differential as a merge-tree
            # "pending queue out of order" assert three hops
            # downstream). Align the runtime with reality first.
            self.runtime.set_connection_state(False)
        # stale queued messages would double-process after the direct
        # catch-up below; they are all in the op log and get refetched
        self._clear_inbound_state()
        # catch up anything missed while disconnected, THEN attach the
        # live stream (CatchingUp -> Connected, connectionStateHandler)
        catchup = self.service.read_ops(self.last_processed_seq)
        if catchup and catchup[0].sequence_number > \
                self.last_processed_seq + 1:
            # a summary ack truncated the op log past this replica's
            # position while it was offline: exact catch-up is
            # impossible — say so actionably instead of tripping the
            # contiguity assert mid-replay (found by the chaos
            # differential: a client disconnected across a summary
            # window hit the bare assert on reconnect). Same error
            # (and ONE wording) as the gap-refetch path's check.
            raise self._truncation_error(catchup[0].sequence_number)
        for msg in catchup:
            _CATCHUP_OPS.inc()
            self._process(msg)
        self._connection = self.service.connect_to_delta_stream(
            self.client_id, self._on_message, self._on_nack
        )
        self._csn = 0
        self._sent_times.clear()
        self.runtime.set_connection_state(True, self.client_id)
        self.mc.logger.send_telemetry_event(
            "connected", clientId=self.client_id,
        )
        self.emit("connected")

    def disconnect(self) -> None:
        # an explicit disconnect supersedes any queued nack-reconnect
        self._reconnect_on_nack = False
        if self._connection is not None:
            self._connection.disconnect()
            self._connection = None
        self._clear_inbound_state()
        self.runtime.set_connection_state(False)
        self.mc.logger.send_telemetry_event(
            "disconnected", clientId=self.client_id,
        )
        self.emit("disconnected")

    def _clear_inbound_state(self) -> None:
        self._scheduler.clear()
        self._schedule.reset()
        self._enqueued_seq = 0

    def close(self) -> None:
        self.disconnect()
        # flush the sampled-latency tail (measurements below
        # sample_every used to vanish at teardown)
        self._op_latency.close()
        self.closed = True

    # ------------------------------------------------------------------
    # per-op latency attribution (obs pillar 1)

    def op_trace(self, csn: Optional[int] = None) -> Optional[dict]:
        """The ledgered trace entry for one of this container's own
        acked ops (by clientSequenceNumber; newest when omitted):
        {clientSequenceNumber, sequenceNumber, traces, hops,
        total_ms}."""
        return self.op_ledger.get(csn)

    def op_breakdown(self, csn: Optional[int] = None) -> str:
        """Formatted ordered hop list with per-hop latencies — the
        "where did op X spend its time" view."""
        return self.op_ledger.format(csn)

    # ------------------------------------------------------------------
    # inbound (DeltaManager inbound queue + gap refetch)

    def _on_message(self, msg: SequencedMessage) -> None:
        if msg.sequence_number <= self._last_enqueued_seq():
            _DUP_DROPS.inc()
            return  # duplicate delivery
        if msg.sequence_number > self._last_enqueued_seq() + 1:
            # gap: fetch the missing range from delta storage
            # (deltaManager.ts:883 fetchMissingDeltas). Contiguity is
            # checked per refetched op AND at the end: a log the
            # service truncated above this replica's position (a
            # summary ack while we were behind) can come back empty
            # OR with only the post-truncation suffix — either way
            # the gap is unfillable, and enqueuing would trip the
            # bare contiguity assert downstream. Fail loudly and
            # actionably instead (same contract as the
            # connect()-time check, which cannot catch this when no
            # ops trail the truncation yet).
            for missing in self.service.read_ops(
                self._last_enqueued_seq(), msg.sequence_number - 1
            ):
                if missing.sequence_number > \
                        self._last_enqueued_seq() + 1:
                    raise self._truncation_error(
                        missing.sequence_number)
                _CATCHUP_OPS.inc()
                self._enqueue_inbound(missing)
            if msg.sequence_number > self._last_enqueued_seq() + 1:
                raise self._truncation_error(msg.sequence_number)
        self._enqueue_inbound(msg)
        if not self.inbound_paused:
            self._scheduler.drain()

    def _last_enqueued_seq(self) -> int:
        return max(self.last_processed_seq, self._enqueued_seq)

    def _truncation_error(self, got_seq: int) -> RuntimeError:
        return RuntimeError(
            f"op stream gap {self._last_enqueued_seq() + 1}.."
            f"{got_seq - 1} is not in delta storage (truncated by a "
            "summary): this replica cannot catch up exactly — "
            "reload from the latest summary (Container.load)"
        )

    def _enqueue_inbound(self, msg: SequencedMessage) -> None:
        self._enqueued_seq = msg.sequence_number
        self._scheduler.enqueue(self._schedule.feed(msg))

    # DeltaQueue pause/resume (deltaQueue.ts:15) + sliced drain
    def pause_inbound(self) -> None:
        self.inbound_paused = True

    def resume_inbound(self) -> None:
        self.inbound_paused = False
        self._scheduler.drain()

    def process_inbound(self, slice_s: Optional[float] = None) -> int:
        """Explicit host-driven drain of queued inbound units,
        optionally time-budgeted (DeltaScheduler 50ms slices). This is
        the manual companion to ``pause_inbound`` — pausing stops the
        automatic drain; this call processes on the host's schedule
        (pass ``DeltaScheduler.DEFAULT_SLICE_S`` for the reference's
        50ms slice). Returns messages processed."""
        return self._scheduler.drain(slice_s)

    def _process(self, msg: SequencedMessage) -> None:
        assert msg.sequence_number == self.last_processed_seq + 1, (
            f"inbound stream broken: got {msg.sequence_number}, "
            f"expected {self.last_processed_seq + 1}"
        )
        # Flush before the view advances: outbox ops must go out with
        # the refSeq they were created against.
        self.runtime.flush()
        self.last_processed_seq = msg.sequence_number
        self.protocol.process_message(msg)
        if msg.type == MessageType.OPERATION:
            if bool(self.client_id) and msg.client_id == self.client_id:
                sent = self._sent_times.pop(
                    msg.client_sequence_number, None
                )
                if sent is not None:
                    roundtrip_ms = (time.monotonic() - sent) * 1000
                    self._op_latency.record(roundtrip_ms)
                    _ROUNDTRIP_MS.observe(roundtrip_ms)
                    _OPS_ACKED.inc()
                    # an acked op = the service is admitting us again:
                    # the throttle-escalation streak resets
                    self._throttle_strikes = 0
                    # the terminal hop: our own IN-FLIGHT op came back
                    # sequenced — close the trace and ledger the full
                    # breakdown. Guarded by `sent` on purpose: replays
                    # (reload catch-up, reconnect) revisit ops this
                    # instance never submitted, and on the in-proc
                    # path the message OBJECT is the durable op-log
                    # entry — an unguarded stamp would append a bogus
                    # ack hop to shared history on every reload
                    trace_stamp(msg.traces, "client", "ack")
                    self.op_ledger.record(
                        msg.client_sequence_number,
                        msg.sequence_number, msg.traces,
                    )
            self.runtime.process(msg)
        else:
            self.runtime.observe_system(msg)
            if (
                msg.type == MessageType.SUMMARIZE
                and msg.client_id == self.client_id
                and msg.client_sequence_number ==
                self._pending_summary_csn
            ):
                # our summarize op sequenced: remember its proposal seq
                # so the matching ack promotes the captured counts
                self._pending_summary_seq = msg.sequence_number
            if msg.type == MessageType.SUMMARY_ACK:
                proposal = (msg.contents or {}).get("summaryProposal")
                if (
                    self._pending_summary_seq is not None
                    and proposal == self._pending_summary_seq
                ):
                    self._acked_summary_counts = \
                        self._pending_summary_counts
                    self._pending_summary_counts = None
                    self._pending_summary_seq = None
                    self._pending_summary_csn = None
                self.emit("summaryAck", msg.contents)
            elif msg.type == MessageType.SUMMARY_NACK:
                self.emit("summaryNack", msg.contents)
        self.emit("processed", msg)
        # Heartbeat AFTER dispatch: a write client that only reads must
        # still advance the service-side msn or zamboni stalls globally.
        # Only other clients' RUNTIME ops count — feeding noops/joins
        # back into the tracker would let heartbeats trigger heartbeats
        # (the acknowledgement cycle collabWindowTracker.ts avoids).
        if (
            self.connected
            and msg.type == MessageType.OPERATION
            and msg.client_id != self.client_id
        ):
            self.collab_window.on_op_processed(msg.sequence_number)

    def _on_nack(self, nack: Nack) -> None:
        """A nack means the service dropped our op: the pending queue
        and csn stream are now misaligned with the service. The
        reference reconnects and replays pending state
        (connectionManager.ts nack handling); we tear the connection
        down immediately (safe mid-submit: later submits of the same
        flush stay pending) and reconnect at the next flush.

        A THROTTLING nack additionally arms a backoff deadline:
        ``retry_after_seconds`` is the floor (the service computed
        when capacity returns) plus full jitter escalating with
        consecutive throttles — reconnecting the moment the window
        expires, in lockstep with every other throttled client, would
        re-create the spike the service just shed."""
        _NACKS_SEEN.inc()
        if (
            nack.error_type == NackErrorType.THROTTLING
            and (nack.retry_after_seconds or 0.0) > 0.0
        ):
            # a POSITIVE retry hint = a qos admission shed; a bare
            # throttle nack (legacy servers, injected faults) keeps
            # the immediate reconnect-on-flush behavior
            self._throttle_strikes += 1
            delay = full_jitter_delay(
                self._throttle_strikes,
                base_delay_s=0.05, max_delay_s=5.0,
                floor_s=nack.retry_after_seconds,
                rng=self._backoff_rng,
            )
            self._throttled_until = max(
                self._throttled_until,
                self._backoff_clock() + delay,
            )
            self.emit("throttled", nack)
        self.emit("nack", nack)
        self.mc.logger.send_error_event(
            "nack", clientId=self.client_id, reason=nack.message,
        )
        self.disconnect()
        self._reconnect_on_nack = True  # after: disconnect clears it

    @property
    def throttled(self) -> bool:
        """Still inside a throttle-nack backoff window?"""
        return self._backoff_clock() < self._throttled_until

    # ------------------------------------------------------------------
    # outbound (DeltaManager.submit :213)

    def _submit_runtime_op(self, contents: Any, metadata: Any) -> None:
        if not self.connected:
            return  # stays pending; replayed on reconnect
        self._csn += 1
        self._sent_times[self._csn] = time.monotonic()
        self.collab_window.on_op_sent(self.last_processed_seq)
        _OPS_SUBMITTED.inc()
        self._connection.submit(DocumentMessage(
            client_sequence_number=self._csn,
            reference_sequence_number=self.last_processed_seq,
            type=MessageType.OPERATION,
            contents=contents,
            metadata=metadata,
            # trace origin: doc/client identity travels implicitly
            # (client_id on the sequenced form, csn here); the stamp
            # chain starts at the outbox
            traces=trace_stamp([], "client", "submit"),
        ))

    def _submit_noop(self) -> None:
        """msn heartbeat (MessageType.NO_OP): carries only our refSeq
        so the sequencer advances this client's contribution to the
        msn. No runtime content, no latency tracking."""
        if not self.connected:
            return
        self._csn += 1
        self._connection.submit(DocumentMessage(
            client_sequence_number=self._csn,
            reference_sequence_number=self.last_processed_seq,
            type=MessageType.NO_OP,
        ))

    def flush(self) -> None:
        if self._reconnect_on_nack and not self.closed:
            if self.throttled:
                # inside the throttle window: edits keep accumulating
                # as pending local state; the reconnect (and with it
                # the pending-op resubmit) waits out the deadline
                # instead of hammering the service
                _THROTTLE_DEFERRALS.inc()
            else:
                self._reconnect_on_nack = False
                if not self.connected:
                    try:
                        self.connect()  # replays pending, fresh csn
                    except Exception:
                        # the service refused the reconnect (e.g. the
                        # quorum-loss degraded window refusing joins):
                        # re-arm, or every later flush would silently
                        # stop retrying and strand the pending ops
                        self._reconnect_on_nack = True
                        raise
        self.runtime.flush()

    # ------------------------------------------------------------------
    # summarization (client half of §3.4)

    def summarize(self, incremental: bool = False) -> dict:
        """Produce and submit a summary; the service (scribe) acks it.
        Requires a quiescent runtime (no pending local ops).

        ``incremental=True`` replaces every channel that is unchanged
        since this container's last ACKED summary with a
        SummaryType.Handle node (summary.ts:55-59); the service
        storage expands handles against the stored previous version,
        so an unchanged channel costs neither serialization here nor
        new objects there."""
        self.flush()
        assert self.runtime.pending.count == 0, (
            "summarize with in-flight local ops"
        )
        counts = self._channel_counts()
        unchanged: frozenset = frozenset()
        if incremental and self._acked_summary_counts is not None:
            unchanged = frozenset(
                key for key, count in counts.items()
                if self._acked_summary_counts.get(key) == count
            )
        summary = {
            "protocol": self.protocol.snapshot(),
            "runtime": self.runtime.summarize(unchanged),
        }
        if self.connected:
            # the reference flow (containerRuntime.ts:2477): upload
            # the tree to storage, then propose only the handle on the
            # op stream; drivers without a storage upload plane (the
            # in-proc local/file drivers) carry the tree inline
            upload = getattr(self.service, "upload_summary", None)
            contents = None
            if upload is not None:
                try:
                    contents = {
                        "handle": upload(summary),
                        "referenceSequenceNumber": (
                            self.last_processed_seq
                        ),
                    }
                except PermissionError:
                    # an auth misconfiguration (token without write
                    # scope) is NOT transient: degrading to inline
                    # summaries forever would mask it — surface it
                    raise
                except (OSError, RuntimeError, TimeoutError) as e:
                    # a transient storage-upload failure must not
                    # wedge the summarizer (the proposal would never
                    # exist, so no ack/nack would ever clear it):
                    # degrade to the inline path — a fat op, but the
                    # loop completes
                    self.mc.logger.send_error_event(
                        "summaryUploadFailed", error=e,
                    )
            if contents is None:
                contents = {
                    "summary": summary,
                    "referenceSequenceNumber": self.last_processed_seq,
                }
            self._csn += 1
            self._pending_summary_counts = counts
            self._pending_summary_csn = self._csn
            self._connection.submit(DocumentMessage(
                client_sequence_number=self._csn,
                reference_sequence_number=self.last_processed_seq,
                type=MessageType.SUMMARIZE,
                contents=contents,
            ))
        return summary

    def _channel_counts(self) -> dict:
        return {
            (ds_id, cid): ch.change_count
            for ds_id, ds in self.runtime.datastores.items()
            for cid, ch in ds.channels.items()
        }
