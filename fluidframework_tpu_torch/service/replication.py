"""Replicated sequencer: op-log replication + leader failover — the
ordering plane survives host loss with zero client-visible downtime.

Single-node crash-restart converges bit-identically (the durable op
log), but a dead host still blacks out every document it orders until
an operator restarts it. This module replicates the sequencer's durable
op log to N follower nodes behind an explicit ack barrier and elects
a follower into the leader role when the leader's lease lapses — the
contract "On Coordinating Collaborative Objects" (arXiv 1007.5093)
frames: ONE total order per document, never re-issued, never forked,
across the handoff.

The three load-bearing pieces:

- **The ack barrier** — the op log's fsync-before-fanout extends to
  *fsync-AND-replicate-before-fanout*: ``ReplicatedOpLog`` makes the
  local fsynced append, then blocks in
  ``ReplicatedSequencerGroup.replicate_before_fanout`` until a QUORUM
  of nodes holds the op durably, and only then does the pipeline fan
  it out (scriptorium runs before the broadcaster, so the barrier
  sits exactly where the local fsync sat). An op any client was ever told
  about therefore survives the loss of any non-quorum subset of
  nodes; an op the quorum never accepted was never fanned out, and
  the submitting client still holds it pending (the client's
  reconnect/resubmit path replays it — no new client machinery).

- **The epoch fence** — every leader writes under the epoch its lease
  acquisition minted (``EpochFence.advance``). A deposed leader that
  still *thinks* it holds the lease (the split-brain candidate: its
  renewal was lost, or the lease service hiccuped) is refused at the
  write seam: ``EpochFence.check`` raises ``FencedWriteError`` and
  counts ``sequencer_fenced_writes_total`` BEFORE anything could fan
  out, and every follower independently refuses stale epochs as the
  backstop (fencing tokens: the RESOURCE checks the token, not the
  leader's belief). The fluidlint rule ``qoscheck:fence-before-fanout``
  pins the ordering statically.

- **Promotion at exactly the replicated head** — failover flushes the
  candidate's buffered (lagging) tail, anti-entropies any missing
  suffix from every surviving peer (any fanned-out op is on at least
  one surviving follower's contiguous prefix, because quorum heads
  imply contiguous prefixes), then boots a fresh
  ``ReplicatedLocalServer`` over the candidate's directory: the
  orderer fast-forwards the sequencer to the log head and ticketing
  resumes at exactly seq+1. Buffered ops still gapped after
  anti-entropy were never quorum-durable — dropped; their submitters
  resubmit.

Layout: ``<root>/node-0`` is the initial leader's durable dir (a
normal ``DocumentStorage`` tree per document); each follower keeps
the SAME ``<node>/<doc>/ops.jsonl`` layout, which is what makes
promotion "build a LocalServer over the follower's dir" instead of a
data migration.

Chaos seams (docs/ROBUSTNESS.md): ``repl.lag`` (a follower defers
durability — replication lag), ``repl.append_ack`` (a follower's ack
is lost / errors), ``repl.lease_expire`` (renewal dropped, or the
lease service lapses the grant NOW — the split-brain trigger),
``repl.promote`` (a transient election failure, retried).
"""
from __future__ import annotations

import os
import time
from typing import Any, Optional

from ..obs import metrics as obs_metrics
from ..obs.trace import stamp as _stamp
from ..protocol.messages import SequencedMessage
from ..protocol.serialization import message_from_json, message_to_json
from ..qos.faults import (
    KIND_DEFER,
    KIND_DROP,
    KIND_ERROR,
    KIND_HEAL,
    KIND_PARTITION,
    PLANE,
)
from .local_orderer import LocalOrderer
from .local_server import LocalServer
from .storage import DocumentStorage, FileOpLog, atomic_write, \
    jsonl_record, read_jsonl_tolerant, scrub_repair_jsonl

# chaos seams (one schedule drives the document plane and the
# partitioned-queue counterpart in partitioning.py — shared names,
# exactly like socket.frame_in/out across harnesses)
_SITE_LAG = PLANE.site("repl.lag", (KIND_DEFER,))
_SITE_ACK = PLANE.site("repl.append_ack", (KIND_DROP, KIND_ERROR))
_SITE_LEASE = PLANE.site("repl.lease_expire", (KIND_DROP, KIND_ERROR))
# error only: a deferred election would be indistinguishable from a
# slightly-later failover call on the step clock — a kind the code
# never acts on is exactly the vacuous vocabulary the sweep guard
# exists to forbid
_SITE_PROMOTE = PLANE.site("repl.promote", (KIND_ERROR,))
# netsplit topology transitions: force()d by NetworkTopology when the
# harness applies/heals a partition, so PLANE.fired stays the one
# replayable log of everything that happened to the run (the torn-
# state idiom: a topology change is a harness decision, not a draw)
_SITE_PARTITION = PLANE.site("repl.partition", (KIND_PARTITION,))
_SITE_HEAL = PLANE.site("repl.heal", (KIND_HEAL,))

def _group_metrics(registry: obs_metrics.MetricsRegistry) -> dict:
    """Register (or fetch) the replication families on ``registry``.

    Every replication metric holder is INJECTABLE: in-process
    multi-node harnesses (chaos, test_replication) give the leader
    and each follower their own registry so per-node series never
    double-count into one process aggregate, and
    ``obs.federation.FederatedView`` merges them back into the fleet
    view. Default (registry=None at every ctor) stays the
    process-wide REGISTRY — production topology is one node per
    process, unchanged. Names stay literals HERE so fluidlint's
    slo-unbound-objective collection sees them statically."""
    return {
        "followers": registry.gauge(
            "repl_followers", "follower replicas behind the leader",
            labelnames=("partition",)),
        "lag": registry.gauge(
            "repl_lag_ops",
            "worst follower replication lag at the last append (ops)"),
        "failovers": registry.counter(
            "sequencer_failovers_total",
            "follower promotions into the leader role"),
        "anti_entropy": registry.counter(
            "repl_anti_entropy_ops_total",
            "ops applied via anti-entropy catch-up and promotion "
            "suffix pulls"),
        # partition-tolerance plane (quorum-loss degraded mode,
        # follower lifecycle) — docs/OBSERVABILITY.md
        "degraded": registry.gauge(
            "repl_degraded",
            "1 while the leader is in quorum-loss degraded mode "
            "(writes nack retriable-unavailable; reads clamp at the "
            "committed watermark)"),
        "degraded_s": registry.counter(
            "repl_degraded_seconds_total",
            "cumulative seconds spent in degraded mode (accumulated "
            "at degraded_exit, on the group clock)"),
        "unavailable": registry.counter(
            "repl_unavailable_nacks_total",
            "writes refused with the retriable unavailable nack "
            "while quorum/lease was unprovable"),
        "rejoins": registry.counter(
            "repl_rejoin_total",
            "followers rejoined via full anti-entropy resync behind "
            "the epoch fence"),
        # fault-to-signal plane: the two transient-fault absorb
        # points in _offer_one each leave a visible mark, so a chaos
        # injection at repl.lag / repl.append_ack is never silent
        "lag_deferrals": registry.counter(
            "repl_lag_deferrals_total",
            "offers absorbed into the follower lag buffer instead "
            "of acking durably (replication lag deferral)"),
        "ack_retries": registry.counter(
            "repl_ack_retries_total",
            "transiently-failed follower ack offers retried once "
            "(second failure skips the round; anti-entropy repairs)"),
    }


def _fence_metrics(registry: obs_metrics.MetricsRegistry) -> dict:
    return {
        "epoch": registry.gauge(
            "repl_epoch", "current sequencer leadership epoch"),
        "fenced": registry.counter(
            "sequencer_fenced_writes_total",
            "writes refused by the epoch fence (deposed-leader "
            "attempts)"),
    }


def _note(timeline, kind: str, node: str = "", **fields) -> None:
    """Record a fleet-timeline event when a timeline is attached
    (obs/timeline.py); replication runs timeline-less by default."""
    if timeline is not None:
        timeline.record(kind, node=node, **fields)


class FencedWriteError(RuntimeError):
    """A write carried a stale leadership epoch: the writer was
    deposed. Refusing it here (BEFORE fan-out) is what makes a
    split-brain candidate harmless — the op was never sequenced as
    far as any client can observe, so the submitter resubmits it to
    the real leader."""


class LeaseHeldError(RuntimeError):
    """Acquisition attempted while a live (unexpired) lease is held
    by another node."""


class LeaseUnreachableError(RuntimeError):
    """The lease service is in another reachability island: no grant
    can be acquired or proven until the partition heals — elections
    are impossible, which is exactly what keeps a split from minting
    two leaders."""


class QuorumUnavailableError(RuntimeError):
    """The leader cannot prove a write durable (quorum unreachable
    within the deadline) or cannot prove its own leadership (lease
    lapsed with the lease service unreachable). RETRIABLE by
    construction: nothing was sequenced as far as any client can
    observe — the op stays with its submitter, rides a throttle nack
    with ``shed_class="unavailable"``, and the client's
    reconnect/resubmit path replays it after the heal."""

    def __init__(self, msg: str, retry_after_seconds: float = 0.25):
        super().__init__(msg)
        self.retry_after_seconds = retry_after_seconds


class NetworkTopology:
    """Reachability islands for the in-process multi-node harnesses —
    the netsplit fault vocabulary's state. Production deployments
    never construct one (``group.network`` stays None = fully
    connected, zero overhead); the chaos harness installs one and
    drives ``partition()``/``heal()`` on the seeded schedule.

    ``islands`` maps node id -> island index; nodes reach each other
    iff they share an island, and the LEASE SERVICE occupies an
    island of its own choosing (``lease_island``) so lease isolation
    — everyone replicating fine but nobody able to renew or elect —
    is expressible as its own split mode. Unknown nodes default to
    island 0 (a node the schedule never mentioned is reachable from
    the majority side)."""

    def __init__(self, timeline=None):
        self.islands: dict[str, int] = {}
        self.lease_island = 0
        self.timeline = timeline
        self.split = False
        self.flaps = 0

    def island_of(self, node: str) -> int:
        return self.islands.get(node, 0)

    def reachable(self, a: str, b: str) -> bool:
        return self.island_of(a) == self.island_of(b)

    def lease_reachable(self, node: str) -> bool:
        return self.island_of(node) == self.lease_island

    def partition(self, groups: list[list[str]],
                  lease_island: int = 0) -> None:
        """Apply a split: ``groups[i]`` lands in island ``i``; the
        lease service sits in ``groups[lease_island]``. Recorded
        through the ``repl.partition`` site (PLANE.fired stays the
        replayable log) and on the fleet timeline."""
        self.islands = {node: i
                        for i, group in enumerate(groups)
                        for node in group}
        self.lease_island = lease_island
        if self.split:
            self.flaps += 1
        self.split = True
        desc = "|".join(",".join(g) for g in groups)
        _SITE_PARTITION.force(KIND_PARTITION, islands=desc,
                              lease_island=lease_island)
        _note(self.timeline, "partition", islands=desc,
              lease_island=lease_island)

    def heal(self) -> None:
        if not self.split:
            return
        self.islands = {}
        self.lease_island = 0
        self.split = False
        _SITE_HEAL.force(KIND_HEAL)
        _note(self.timeline, "heal")


class EpochFence:
    """The monotone leadership epoch and THE check every replicated
    write makes before anything can fan out. ``advance()`` is called
    only by lease acquisition — one epoch per leadership term."""

    def __init__(self, epoch: int = 0, registry=None, timeline=None):
        self.epoch = epoch
        self.timeline = timeline
        m = _fence_metrics(registry or obs_metrics.REGISTRY)
        self._g_epoch = m["epoch"]
        self._c_fenced = m["fenced"]

    def advance(self) -> int:
        self.epoch += 1
        self._g_epoch.set(self.epoch)
        _note(self.timeline, "epoch_advance", epoch=self.epoch)
        return self.epoch

    def check(self, epoch: int, **context) -> None:
        if epoch != self.epoch:
            self._c_fenced.inc()
            _note(self.timeline, "fenced_write", epoch=epoch,
                  current=self.epoch,
                  **{k: v for k, v in context.items()
                     if isinstance(v, (int, float, str, bool))})
            raise FencedWriteError(
                f"epoch fence: write under epoch {epoch} refused, "
                f"current epoch is {self.epoch} ({context}) — the "
                "writer was deposed; the op stays with its submitter "
                "and resubmits to the current leader")


class SequencerLease:
    """The lease seam: leadership is a TTL'd grant renewed on the
    replication heartbeat. Clock-injectable (the chaos harness drives
    it on the step clock), so lease expiry — and therefore failover
    timing — is deterministic. Acquisition advances the epoch fence;
    renewal consults the ``repl.lease_expire`` chaos site, whose
    faults model the two real-world lease failure shapes: a renewal
    lost in transit (``drop`` — the TTL keeps running) and the lease
    service lapsing the grant NOW without telling the holder
    (``error`` — the split-brain trigger)."""

    def __init__(self, fence: EpochFence, ttl: float = 0.3,
                 clock=None, timeline=None, network=None):
        self.fence = fence
        self.ttl = ttl
        self.clock = clock or time.monotonic
        self.timeline = timeline
        # reachability to the lease SERVICE (netsplit plane): None =
        # fully connected. An unreachable caller's renewal is lost in
        # transit (the TTL keeps running) and its acquire refuses —
        # a minority island can never mint an epoch
        self.network: Optional[NetworkTopology] = network
        self.holder: Optional[str] = None
        self.expires_at = float("-inf")

    @property
    def epoch(self) -> int:
        return self.fence.epoch

    def expired(self) -> bool:
        return self.clock() >= self.expires_at

    def acquire(self, node_id: str) -> int:
        if self.network is not None and \
                not self.network.lease_reachable(node_id):
            raise LeaseUnreachableError(
                f"{node_id} cannot reach the lease service across "
                "the partition: no election from a minority island")
        if self.holder not in (None, node_id) and not self.expired():
            raise LeaseHeldError(
                f"lease held by {self.holder!r} for another "
                f"{self.expires_at - self.clock():.3f}s")
        self.holder = node_id
        self.expires_at = self.clock() + self.ttl
        _note(self.timeline, "lease_grant", node=node_id,
              ttl=self.ttl)
        return self.fence.advance()

    def renew(self, node_id: str, epoch: int) -> bool:
        if node_id != self.holder or epoch != self.fence.epoch:
            return False  # deposed caller: the grant moved on
        if self.network is not None and \
                not self.network.lease_reachable(node_id):
            # the renewal is lost in transit across the split: the
            # TTL keeps running toward the lapse — topology-driven
            # and deterministic, so it consumes NO chaos-site draw
            return False
        fault = _SITE_LEASE.fire(holder=node_id)
        if fault == KIND_DROP:
            return False  # renewal lost in transit; TTL keeps running
        if fault == KIND_ERROR:
            # lease-service hiccup: the grant lapses NOW and the
            # holder is NOT told — it keeps writing until the epoch
            # fence refuses it (the split-brain candidate the
            # deposed-race chaos mode exercises)
            self.expires_at = self.clock()
            _note(self.timeline, "lease_expire", node=node_id,
                  origin="fault")
            return False
        self.expires_at = self.clock() + self.ttl
        _note(self.timeline, "lease_renew", node=node_id)
        return True

    def force_expire(self, reason: str = "forced") -> None:
        """Harness-driven lapse (the deposed-race schedule), recorded
        through the plane like any crash-time forced state."""
        _SITE_LEASE.force(KIND_ERROR, reason=reason)
        self.expires_at = self.clock()
        _note(self.timeline, "lease_expire",
              node=self.holder or "", origin="forced", reason=reason)


class FollowerReplica:
    """One follower sequencer node: a durable, per-document,
    contiguous copy of the leader's op log, in EXACTLY the layout a
    ``LocalServer`` durable dir uses (``<root>/<doc>/ops.jsonl``) —
    so promotion is "boot a server over this directory", not a data
    migration. Appends fsync before acking (the follower's half of
    the ack barrier); a deferred (lagging) append is buffered
    in-memory and acked only once durable."""

    def __init__(self, root: str, node_id: str, registry=None,
                 timeline=None, stamp_ts=None):
        self.root = root
        self.node_id = node_id
        # the follower's OWN registry (satellite fix: follower series
        # used to alias the process-wide REGISTRY, double-counting
        # leader + follower into one registry in in-process multi-node
        # tests); default None keeps the process-wide aggregate —
        # production runs one node per process
        self._c_fenced = _fence_metrics(
            registry or obs_metrics.REGISTRY)["fenced"]
        self.timeline = timeline
        # timestamp source for the repl:follower_append hop stamp:
        # None = stamp()'s wall default; the group passes its injected
        # clock through so recorded corpora stay byte-stable per seed
        self._stamp_ts = stamp_ts
        os.makedirs(root, exist_ok=True)
        self.max_epoch_seen = 0
        self._heads: dict[str, int] = {}
        self._fhs: dict[str, Any] = {}
        self._lag: dict[str, list[SequencedMessage]] = {}
        # resume replicated heads from disk (a follower surviving its
        # own restart) — torn tails tolerated exactly like the
        # leader's log: the torn op never acked, so discarding it is
        # exact
        for doc in sorted(os.listdir(root)):
            path = self._log_path(doc)
            if not os.path.isfile(path):
                continue
            rows, torn = read_jsonl_tolerant(path, "repl")
            if torn:
                atomic_write(path, "".join(
                    jsonl_record(r) for r in rows))
            if rows:
                self._heads[doc] = rows[-1]["sequenceNumber"]

    def _log_path(self, doc: str) -> str:
        return os.path.join(self.root, doc, "ops.jsonl")

    def _fh(self, doc: str):
        fh = self._fhs.get(doc)
        if fh is None:
            os.makedirs(os.path.join(self.root, doc), exist_ok=True)
            fh = open(self._log_path(doc), "a")
            self._fhs[doc] = fh
        return fh

    # -- state ----------------------------------------------------------

    def documents(self) -> list[str]:
        return sorted(set(self._heads) | set(self._lag))

    def head(self, doc: str) -> int:
        """Last DURABLY replicated seq for ``doc`` (0 = none)."""
        return self._heads.get(doc, 0)

    def total_head(self) -> int:
        return sum(self._heads.values())

    def lag_depth(self) -> int:
        return sum(len(v) for v in self._lag.values())

    # -- the replication stream ----------------------------------------

    def _check_epoch(self, epoch: int, doc: str) -> None:
        if epoch < self.max_epoch_seen:
            self._c_fenced.inc()
            _note(self.timeline, "fenced_write", node=self.node_id,
                  epoch=epoch, current=self.max_epoch_seen, doc=doc)
            raise FencedWriteError(
                f"follower {self.node_id}: append under epoch "
                f"{epoch} refused (seen {self.max_epoch_seen}, "
                f"doc {doc!r}) — fencing-token backstop")
        self.max_epoch_seen = epoch

    def note_epoch(self, epoch: int) -> None:
        """A new leader's first contact: stale-epoch writes from the
        deposed leader are refused from here on."""
        self.max_epoch_seen = max(self.max_epoch_seen, epoch)

    def buffer_lag(self, doc: str, epoch: int,
                   msg: SequencedMessage) -> None:
        """Replication lag: the op arrived but is NOT yet durable —
        no ack. ``flush_lag`` makes the contiguous prefix durable."""
        self._check_epoch(epoch, doc)
        self._lag.setdefault(doc, []).append(msg)

    def append_durable(self, doc: str, epoch: int,
                       msg: SequencedMessage) -> None:
        self._check_epoch(epoch, doc)
        self._append_raw(doc, msg)

    def _append_raw(self, doc: str, msg: SequencedMessage) -> None:
        assert msg.sequence_number == self.head(doc) + 1, (
            f"follower {self.node_id} log must stay contiguous: "
            f"append seq {msg.sequence_number} onto head "
            f"{self.head(doc)} (doc {doc!r})")
        # the cross-node hop: this follower holds the op durably (one
        # stamp per follower that appends — catch-up/anti-entropy
        # appends stamp too, honestly dating when the copy landed)
        _stamp(msg.traces, "repl", "follower_append",
               timestamp=self._stamp_ts() if self._stamp_ts else None)
        fh = self._fh(doc)
        # crc-stamped (storage.jsonl_record): the scrubber's bit-rot
        # detection is only as good as the records carrying checksums
        fh.write(jsonl_record(message_to_json(msg)))
        fh.flush()
        os.fsync(fh.fileno())  # durable BEFORE the ack counts
        self._heads[doc] = msg.sequence_number

    def flush_lag(self, doc: Optional[str] = None) -> int:
        """Durably apply the buffered tail's CONTIGUOUS prefix;
        anything gapped (an earlier op was dropped in transit) stays
        buffered until catch-up supplies the middle. Returns ops
        applied."""
        applied = 0
        for d in ([doc] if doc is not None else list(self._lag)):
            pending = sorted(self._lag.get(d, []),
                             key=lambda m: m.sequence_number)
            keep: list[SequencedMessage] = []
            for msg in pending:
                if msg.sequence_number <= self.head(d):
                    continue  # catch-up already supplied it
                if msg.sequence_number == self.head(d) + 1:
                    self._append_raw(d, msg)
                    applied += 1
                else:
                    keep.append(msg)
            if keep:
                self._lag[d] = keep
            else:
                self._lag.pop(d, None)
        return applied

    def drop_lag(self) -> int:
        """Discard buffered ops still gapped after anti-entropy: no
        surviving node holds the middle, so they were never
        quorum-durable — never fanned out — and their submitters
        still hold them pending. Returns ops dropped."""
        dropped = self.lag_depth()
        self._lag.clear()
        return dropped

    def sync_from(self, doc: str, msgs: list[SequencedMessage]) -> int:
        """Anti-entropy: apply a peer/leader-supplied range (ops at or
        below our head are skipped — at-least-once safe)."""
        applied = 0
        for msg in msgs:
            if msg.sequence_number <= self.head(doc):
                continue
            self._append_raw(doc, msg)
            applied += 1
        return applied

    def read_log(self, doc: str,
                 from_seq: int = 0) -> list[SequencedMessage]:
        """Ops with seq > from_seq from the durable replica log."""
        path = self._log_path(doc)
        if not os.path.isfile(path):
            return []
        rows, _ = read_jsonl_tolerant(path, "repl")
        return [message_from_json(r) for r in rows
                if r["sequenceNumber"] > from_seq]

    def close(self) -> None:
        for fh in self._fhs.values():
            fh.close()
        self._fhs.clear()


class ReplicatedOpLog(FileOpLog):
    """The leader's per-document op log under the extended ack
    barrier: fence check, local fsynced append (the op log's barrier), then
    BLOCK until a quorum of followers holds the op durably — all
    before ``OpLog.append`` returns to scriptorium, which runs before
    the broadcaster, so nothing fans out un-replicated."""

    def __init__(self, path: str, group: "ReplicatedSequencerGroup",
                 document_id: str, epoch: int):
        self._group = group
        self._doc = document_id
        self._epoch = epoch
        super().__init__(path)

    def _persist_append(self, msg: SequencedMessage) -> None:
        try:
            self._group.fence.check(self._epoch, doc=self._doc,
                                    op="append")
        except FencedWriteError:
            # OpLog.append adds to the in-memory list BEFORE
            # persisting: the refused op must not linger there either,
            # or a deposed leader's read path would serve an op the
            # quorum never accepted
            self._ops.pop()
            raise
        _stamp(msg.traces, "repl", "fence_check",
               timestamp=self._group._trace_ts())
        super()._persist_append(msg)  # local fsync (the op log's barrier)
        try:
            self._group.replicate_before_fanout(
                self._doc, self._epoch, msg, self)
        except QuorumUnavailableError:
            # quorum deadline lapsed: UNWIND the local append — in
            # memory AND on disk — so the refused op can never be
            # served, replicated later under a stale epoch, or leave
            # the durable log ahead of the sequencer the submit path
            # rolls back. The op was never quorum-durable, never
            # fanned out; its submitter still holds it pending.
            # Cycle the append handle around the rewrite (the
            # _persist_truncate discipline): atomic_write replaces
            # the inode, and a post-heal append through the stale
            # handle would land on the unlinked file.
            self._ops.pop()
            self._fh.close()
            self._rewrite()
            self._fh = open(self.path, "a")
            raise

    def truncate_below(self, seq: int) -> int:
        # summary truncation must never outrun a laggard: this log is
        # every follower's catch-up source, and dropping records a
        # follower still needs would turn its next catch-up into an
        # unfillable gap
        return super().truncate_below(
            min(seq, self._group.replication_floor(self._doc)))


class ReplicatedDocumentStorage(DocumentStorage):
    """DocumentStorage whose op log is a :class:`ReplicatedOpLog`
    (summaries and checkpoints stay node-local: the replicated log is
    the recovery truth, and a promoted follower rebuilds everything
    else from it)."""

    def __init__(self, root: str, group: "ReplicatedSequencerGroup",
                 document_id: str, epoch: int):
        self._group = group
        self._document_id = document_id
        self._epoch = epoch
        super().__init__(root)

    def _make_op_log(self, path: str) -> FileOpLog:
        return ReplicatedOpLog(path, self._group,
                               self._document_id, self._epoch)


class ReplicatedLocalServer(LocalServer):
    """The LocalServer surface over the replicated plane: per-document
    orderers write through :class:`ReplicatedOpLog`, submits are
    fence-checked BEFORE ticketing (a deposed leader must not even
    consume sequence numbers), and the read path serves only
    quorum-COMMITTED ops — the window where an op is leader-durable
    but not yet quorum-durable is never client-visible."""

    def __init__(self, group: "ReplicatedSequencerGroup",
                 durable_dir: str, **kwargs):
        super().__init__(durable_dir=durable_dir, **kwargs)
        self.group = group
        self.epoch = group.fence.epoch

    def _make_storage(self, document_id: str):
        return ReplicatedDocumentStorage(
            os.path.join(self.durable_dir, document_id),
            self.group, document_id, self.epoch)

    def _make_orderer(self, document_id: str) -> LocalOrderer:
        return LocalOrderer(
            document_id, storage=self._make_storage(document_id),
            storage_breaker=self.storage_breaker,
            checkpoint_every=self.checkpoint_every,
            write_fence=self._fence_check_for(document_id),
            clock=self.clock,
        )

    def _fence_check_for(self, document_id: str):
        def check(op: str = "write") -> None:
            self.group.fence.check(self.epoch, doc=document_id,
                                   op=op)
            if op in ("submit", "connect", "disconnect"):
                # the availability gate (quorum-loss degraded mode):
                # AFTER the fence — a deposed leader refuses as
                # deposed, never as "retry later". A refused
                # disconnect is absorbed by the orderer as an OWED
                # leave (settled at the client's next join), so
                # teardown never detonates.
                self.group.ensure_available(document_id, op=op)
        return check

    def read_ops(self, document_id: str, from_seq: int,
                 to_seq: Optional[int] = None):
        # a deposed server must not serve reads either: its in-memory
        # state may disagree with the order the new leader is minting
        self.group.fence.check(self.epoch, doc=document_id, op="read")
        committed = self.group.committed(document_id)
        to = committed if to_seq is None else min(to_seq, committed)
        return super().read_ops(document_id, from_seq, to)


class ReplicatedSequencerGroup:
    """Leader + N follower sequencer nodes for one ordering scope.

    The group owns the lease, the epoch fence, the follower set and
    the committed watermark; the current leader's
    :class:`ReplicatedLocalServer` is ``group.server`` (callers front
    it with an AlfredServer exactly like a plain LocalServer — after
    a failover they front the NEW ``group.server`` and clients ride
    the reconnect/resubmit path through the handoff)."""

    def __init__(self, root: str, n_followers: int = 2,
                 quorum: Optional[int] = None, clock=None,
                 lease_ttl: float = 0.3, scope: str = "docs",
                 server_kwargs: Optional[dict] = None,
                 registry=None, follower_registries=None,
                 timeline=None, network: Optional[NetworkTopology] = None,
                 quorum_timeout_s: float = 0.5,
                 retry_interval_s: float = 0.05,
                 membership_grace_s: Optional[float] = None,
                 sleep=None):
        if n_followers < 1:
            raise ValueError(
                "a replicated sequencer needs at least one follower "
                "(n_followers >= 1), or host loss loses acked ops")
        if follower_registries is not None and \
                len(follower_registries) != n_followers:
            raise ValueError(
                f"{len(follower_registries)} follower registries for "
                f"{n_followers} followers")
        self.root = root
        self.scope = scope
        # timestamps for the repl hop stamps follow the clock ONLY
        # when one was injected: the default group clock is
        # time.monotonic (lease arithmetic), and monotonic stamps
        # must never mix into wall-clock hop tables
        self._injected_clock = clock is not None
        self.clock = clock or time.monotonic
        # the quorum barrier's wait primitive: deadline-bounded and
        # INJECTABLE (qoscheck:unbounded-blocking-wait pins the
        # deadline statically). Harnesses on the step clock inject a
        # sleep that ADVANCES it, so the wait-out is deterministic;
        # production defaults to the wall sleep.
        self._sleep = sleep if sleep is not None else time.sleep
        self.quorum_timeout_s = quorum_timeout_s
        self.retry_interval_s = retry_interval_s
        # follower unseen past the grace TTL -> membership shrinks
        # (and grows back on rejoin); default: a few lease TTLs
        self.membership_grace_s = membership_grace_s \
            if membership_grace_s is not None else 4 * lease_ttl
        # netsplit plane: None = fully connected (production; zero
        # overhead). The chaos harness installs a NetworkTopology and
        # drives partition()/heal() on the seeded schedule.
        self.network = network
        self.registry = registry or obs_metrics.REGISTRY
        self.timeline = timeline
        self.metrics = _group_metrics(self.registry)
        self.fence = EpochFence(registry=self.registry,
                                timeline=timeline)
        self.lease = SequencerLease(self.fence, ttl=lease_ttl,
                                    clock=self.clock,
                                    timeline=timeline, network=network)
        self.followers = [
            FollowerReplica(
                os.path.join(root, f"node-{i}"), f"node-{i}",
                registry=(follower_registries[i - 1]
                          if follower_registries else None),
                timeline=timeline, stamp_ts=self._trace_ts,
            )
            for i in range(1, n_followers + 1)
        ]
        # quorum-loss degraded mode (read-only brownout) + follower
        # lifecycle state. _degraded_probe_at paces rediscovery when
        # NO topology is installed (production): one write per
        # timeout window runs the barrier as the probe, the rest
        # fast-nack — without it every post-loss write would re-pay
        # the full discovery deadline.
        self.degraded = False
        self.degraded_reason = ""
        self._degraded_since = 0.0
        self._degraded_probe_at = 0.0
        self._last_seen: dict[str, float] = {
            f.node_id: self.clock() for f in self.followers}
        #: detached (grace-lapsed / wiped) followers by node id —
        #: rejoin() re-admits them behind the epoch fence
        self.detached: dict[str, str] = {}
        # quorum over ALL nodes (leader included); default = a strict
        # majority of the initial group ((total // 2) + 1 — for even
        # group sizes too: 4 nodes need 3, or losing a minority could
        # lose a client-acked op), floored at 2 so at least one
        # follower always holds every fanned-out op
        self.quorum = quorum if quorum is not None else max(
            2, (n_followers + 1) // 2 + 1)
        if self.quorum > 1 + n_followers:
            raise ValueError(
                f"quorum {self.quorum} unsatisfiable with "
                f"{n_followers} followers")
        self.server_kwargs = dict(server_kwargs or {})
        self._committed: dict[str, int] = {}
        self.max_lag_observed = 0
        self.leader_id = "node-0"
        self.epoch = self.lease.acquire(self.leader_id)
        self.server = self._build_server(
            os.path.join(root, "node-0"))
        self.metrics["followers"].labels(partition=self.scope).set(
            len(self.followers))

    def _build_server(self, durable_dir: str) -> ReplicatedLocalServer:
        return ReplicatedLocalServer(self, durable_dir,
                                     **self.server_kwargs)

    def _trace_ts(self) -> Optional[float]:
        """Timestamp for repl hop stamps: the injected clock when one
        exists (byte-stable recorded corpora per seed), else None —
        stamp()'s wall default."""
        return self.clock() if self._injected_clock else None

    # -- committed watermark -------------------------------------------

    def committed(self, doc: str) -> int:
        """Highest quorum-durable seq for ``doc`` — the only ops the
        read path may serve (Raft's commitIndex shape)."""
        return self._committed.get(doc, 0)

    def replication_floor(self, doc: str) -> int:
        """Lowest follower head: truncation must stay below nothing a
        laggard still needs from the leader's log."""
        return min(f.head(doc) for f in self.followers) \
            if self.followers else self.committed(doc)

    # -- quorum-loss degraded mode (read-only brownout) -----------------

    def _reachable(self, f: FollowerReplica) -> bool:
        return self.network is None or \
            self.network.reachable(self.leader_id, f.node_id)

    def _quorum_reachable(self) -> bool:
        """ONE owner for the reachable-quorum verdict (leader + the
        followers the topology can currently offer to), shared by the
        pre-ticket gate and the barrier's cached-verdict fast path so
        the two can never drift."""
        return 1 + sum(
            1 for f in self.followers if self._reachable(f)
        ) >= self.quorum

    def _lease_unprovable(self) -> bool:
        """The leader's lease lapsed AND the lease service is across
        the split: leadership cannot be proven, so writes must stop
        (a write the node cannot prove it is entitled to sequence is
        a fork candidate). A lapse with the lease service REACHABLE
        is different — the next heartbeat renews it (same holder,
        same epoch: the grant never moved)."""
        return (self.lease.expired()
                and self.network is not None
                and not self.network.lease_reachable(self.leader_id))

    def _enter_degraded(self, reason: str) -> None:
        if self.degraded:
            return
        self.degraded = True
        self.degraded_reason = reason
        self._degraded_since = self.clock()
        self._degraded_probe_at = self.clock() + self.quorum_timeout_s
        self.metrics["degraded"].set(1)
        _note(self.timeline, "degraded_enter", node=self.leader_id,
              reason=reason)

    def _exit_degraded(self) -> None:
        if not self.degraded:
            return
        self.degraded = False
        self.metrics["degraded"].set(0)
        self.metrics["degraded_s"].inc(
            max(0.0, self.clock() - self._degraded_since))
        _note(self.timeline, "degraded_exit", node=self.leader_id,
              reason=self.degraded_reason)
        self.degraded_reason = ""
        # the heal is also every unreachable follower's comeback:
        # refresh liveness so the grace TTL restarts from the heal,
        # not from the split
        for f in self.followers:
            if self._reachable(f):
                self._last_seen[f.node_id] = self.clock()

    def _refuse_unavailable(self, doc: str, op: str
                            ) -> QuorumUnavailableError:
        self.metrics["unavailable"].inc()
        return QuorumUnavailableError(
            f"quorum unavailable ({self.degraded_reason or 'quorum'}"
            f"): {op} on {doc!r} refused — retriable; resubmit after "
            "the partition heals (read-only brownout at the "
            "committed watermark)",
            retry_after_seconds=self.quorum_timeout_s)

    def ensure_available(self, doc: str, op: str = "submit") -> None:
        """The write path's pre-ticket availability gate (consulted by
        the same write_fence hook as the epoch fence, AFTER it).
        Degraded is a CACHED verdict: entered when the barrier timed
        out (or the lease became unprovable), so exactly one submit
        pays the discovery deadline and later ones fast-nack. Exit:
        with a topology installed, the moment a probe shows quorum
        reachable (and leadership provable) again; with NO topology
        (production — reachability is only discoverable by trying),
        one PACED probe write per timeout window runs the barrier as
        the arbiter and a quorum success there exits degraded."""
        if self._lease_unprovable():
            self._enter_degraded("lease_unreachable")
            raise self._refuse_unavailable(doc, op)
        if not self.degraded:
            return
        if self.network is not None:
            if self._quorum_reachable():
                self._exit_degraded()
                return
            raise self._refuse_unavailable(doc, op)
        if self.clock() >= self._degraded_probe_at:
            self._degraded_probe_at = \
                self.clock() + self.quorum_timeout_s
            return  # the probe write: the barrier decides
        raise self._refuse_unavailable(doc, op)

    # -- follower lifecycle (grace shrink, rejoin) ----------------------

    def detach(self, node_id: str, origin: str) -> Optional[str]:
        """THE membership-shrink path (grace lapse, or a crash-and-
        wipe observed as a dead host being replaced — both callers
        share it so the quorum rule can never drift between them):
        the follower leaves the membership, the quorum recomputes as
        a strict majority of the REMAINING set (floored at 2 — at
        least one follower must hold every fanned-out op — and
        clamped to what the remaining set can satisfy). The data dir
        stays on disk; ``rejoin()`` re-admits the node. Returns the
        detached root, or None when the node is unknown or the last
        follower (never shrink below one)."""
        f = next((x for x in self.followers
                  if x.node_id == node_id), None)
        if f is None or len(self.followers) <= 1:
            return None
        self.followers.remove(f)
        self.detached[node_id] = f.root
        f.close()
        self.quorum = min(
            self.quorum,
            max(2, (1 + len(self.followers)) // 2 + 1))
        self.quorum = min(self.quorum, 1 + len(self.followers))
        self.metrics["followers"].labels(
            partition=self.scope).set(len(self.followers))
        _note(self.timeline, "membership", node=node_id,
              action="shrink", origin=origin, quorum=self.quorum,
              followers=len(self.followers))
        return f.root

    def _check_membership_grace(self) -> None:
        """Followers unseen past the grace TTL detach (see
        :meth:`detach`)."""
        cutoff = self.clock() - self.membership_grace_s
        for f in list(self.followers):
            if self._last_seen.get(f.node_id, cutoff) >= cutoff:
                continue
            self.detach(f.node_id, origin="grace")

    def _leader_log(self, doc: str):
        """The leader's op log for ``doc``, booting the orderer from
        its durable dir when it has not been touched since a
        promotion (``server.documents`` is lazy; booting from the dir
        IS the crash-restore path). None when the leader holds
        nothing for the doc."""
        if self.server is None:
            return None
        if doc not in self.server.documents and not os.path.isdir(
                os.path.join(self.server.durable_dir, doc)):
            return None
        return self.server.get_orderer(doc).op_log

    def rejoin(self, node_id: str, registry=None) -> FollowerReplica:
        """Re-admit a crashed (possibly WIPED) follower: a fresh
        replica over its dir, fenced at the current epoch, fully
        resynced by anti-entropy from every peer's contiguous log
        (follower logs are never truncated, so one surviving peer
        covers a wiped node's whole history) plus the leader's log
        tail. Membership grows back and the quorum recomputes."""
        root = self.detached.pop(node_id, None) or \
            os.path.join(self.root, node_id)
        f = FollowerReplica(root, node_id, registry=registry,
                            timeline=self.timeline,
                            stamp_ts=self._trace_ts)
        f.note_epoch(self.fence.epoch)  # the fence: stale writers out
        docs = set()
        for peer in self.followers:
            docs.update(peer.documents())
        if self.server is not None:
            docs.update(self.server.documents)
            docs.update(
                d for d in os.listdir(self.server.durable_dir)
                if os.path.isdir(
                    os.path.join(self.server.durable_dir, d)))
        applied = 0
        for doc in sorted(docs):
            for peer in self.followers:
                if peer.head(doc) > f.head(doc):
                    applied += f.sync_from(
                        doc, peer.read_log(doc, f.head(doc)))
            log = self._leader_log(doc)
            if log is not None:
                behind = [m for m in log.read(f.head(doc))
                          if m.sequence_number <= self.committed(doc)]
                applied += f.sync_from(doc, behind)
        if applied:
            self.metrics["anti_entropy"].inc(applied)
        self.followers.append(f)
        self._last_seen[node_id] = self.clock()
        self.quorum = max(self.quorum,
                          (1 + len(self.followers)) // 2 + 1)
        self.metrics["followers"].labels(partition=self.scope).set(
            len(self.followers))
        self.metrics["rejoins"].inc()
        _note(self.timeline, "rejoin", node=node_id,
              ops_resynced=applied, quorum=self.quorum,
              followers=len(self.followers))
        return f

    # -- bit-rot scrubbing ---------------------------------------------

    def scrub(self) -> int:
        """Scrub every follower's replica logs: a record that fails
        its crc is read-repaired from any peer (other followers, then
        the leader's op log) whose copy is intact — quorum
        replication is what makes the repair possible. Returns
        records repaired (storage_scrub_repairs_total counts them
        per log); raises ``CorruptRecordError`` when NO intact copy
        survives anywhere."""
        repaired = 0
        for f in self.followers:
            for doc in f.documents():
                path = f._log_path(doc)
                if not os.path.isfile(path):
                    continue

                def fetch(index: int, rows: list, _doc=doc,
                          _f=f) -> Optional[dict]:
                    from .storage import CorruptRecordError

                    # contiguous follower logs start at seq 1, so an
                    # intact neighbour anchors the corrupt slot's seq
                    seq = None
                    for j, row in enumerate(rows):
                        if row is not None and "sequenceNumber" in row:
                            seq = row["sequenceNumber"] + (index - j)
                            break
                    if seq is None:
                        seq = index + 1
                    for peer in self.followers:
                        if peer is _f:
                            continue
                        try:
                            for m in peer.read_log(_doc, seq - 1):
                                if m.sequence_number == seq:
                                    return message_to_json(m)
                                break
                        except CorruptRecordError:
                            continue  # this peer rotted too: next
                    log = self._leader_log(_doc)
                    if log is not None:
                        for m in log.read(seq - 1, seq):
                            if m.sequence_number == seq:
                                return message_to_json(m)
                    return None

                report = scrub_repair_jsonl(path, "repl", fetch)
                if report.repaired:
                    # the rewrite replaced the inode: reopen the
                    # append handle or later appends land on the
                    # unlinked file
                    fh = f._fhs.pop(doc, None)
                    if fh is not None:
                        fh.close()
                    repaired += report.repaired
                    _note(self.timeline, "scrub_repair",
                          node=f.node_id, doc=doc,
                          records=report.repaired)
        return repaired

    # -- the ack barrier ------------------------------------------------

    def replicate_before_fanout(self, doc: str, epoch: int,
                                msg: SequencedMessage,
                                source_log) -> None:
        """Block until ``msg`` is durable on a quorum — but never
        forever: the wait is DEADLINE-BOUNDED on the injectable
        clock. Callers check the epoch fence FIRST
        (qoscheck:fence-before-fanout pins the ordering statically).
        Follower faults are absorbed — the quorum is the contract,
        not any single ack: a lagging follower is force-synced in
        deterministic order; an UNREACHABLE one (netsplit) simply
        cannot ack, and when the deadline lapses with the quorum
        still short the append is UNWOUND (the op was never
        client-visible) and the leader enters degraded mode,
        refusing the write with a retriable unavailable nack — a
        minority-side leader nacks its submitters instead of hanging
        them (qoscheck:unbounded-blocking-wait pins the deadline
        statically)."""
        seq = msg.sequence_number
        # the hop pair around the quorum barrier: forward marks the
        # leader offering the op to its followers, quorum_ack marks
        # the barrier satisfied — so the quorum wait is its OWN hop
        # in op_breakdown()/OTLP instead of silently inflating the
        # sequencer-ticket hop (the ledger bridge feeds
        # repl_quorum_wait_ms from exactly this pair)
        _stamp(msg.traces, "repl", "forward",
               timestamp=self._trace_ts())
        if self.degraded:
            # the verdict is CACHED: while a topology says the
            # partition stands, a write that slipped past the gate
            # (a leave, a mid-batch op) must not pay the discovery
            # deadline again — refuse immediately. Otherwise this is
            # the PACED probe write (or a topology-observed heal):
            # run the barrier, and a quorum success below is what
            # exits degraded.
            if self.network is not None:
                if not self._quorum_reachable():
                    raise self._refuse_unavailable(doc, "append")
                self._exit_degraded()
        acked = 1  # the leader's own fsynced append
        for f in self.followers:
            if self._offer(f, doc, epoch, msg, source_log):
                acked += 1
        # leadership heartbeat piggybacks on replication traffic
        self.lease.renew(self.leader_id, epoch)
        deadline = self.clock() + self.quorum_timeout_s
        # attempts bound the wait even under a mis-injected clock (a
        # harness whose sleep forgets to advance it): the barrier
        # degrades to a bounded retry count, never a busy spin
        attempts = 0
        max_attempts = max(1, int(
            self.quorum_timeout_s / max(self.retry_interval_s, 1e-9)
        ) + 1)
        while acked < self.quorum:
            for f in self.followers:
                if acked >= self.quorum:
                    break
                if f.head(doc) >= seq or not self._reachable(f):
                    continue
                self._force_sync(f, doc, epoch, msg, source_log)
                acked += 1
            if acked >= self.quorum:
                break
            if self.clock() >= deadline or attempts >= max_attempts:
                # quorum shortfall past the deadline: unwind + refuse
                # (the fix for the unbounded `while acked < quorum`
                # wait — a vanished follower set cannot hang a
                # submitter). The local append rolls back (the op was
                # never quorum-durable, never fanned out; its
                # submitter still holds it pending), degraded mode
                # latches so later submits fast-nack, and the nack is
                # retriable — the client's resubmit path converges after
                # the heal.
                self._enter_degraded("quorum_timeout")
                raise self._refuse_unavailable(doc, "append")
            self._sleep(self.retry_interval_s)
            attempts += 1
        if self.degraded:
            # the paced probe write reached quorum: the loss healed
            self._exit_degraded()
        self._last_seen.update(
            (f.node_id, self.clock())
            for f in self.followers if f.head(doc) >= seq)
        self._check_membership_grace()
        heads = sorted([seq] + [f.head(doc) for f in self.followers],
                       reverse=True)
        self._committed[doc] = max(self.committed(doc),
                                   heads[self.quorum - 1])
        _stamp(msg.traces, "repl", "quorum_ack",
               timestamp=self._trace_ts())
        lag = max((seq - f.head(doc) for f in self.followers),
                  default=0)
        self.metrics["lag"].set(lag)
        self.max_lag_observed = max(self.max_lag_observed, lag)

    def _offer(self, f: FollowerReplica, doc: str, epoch: int,
               msg: SequencedMessage, source_log) -> bool:
        """One replication attempt to one follower; True = durable
        ack. An unreachable follower (netsplit) cannot be offered
        anything — and consumes NO chaos-site draw, so the injection
        stream stays a pure function of the reachable event order.
        ``defer`` buffers (replication lag); a dropped/erroring ack
        is retried once (the broker-append idiom), then the follower
        just misses this round — catch-up repairs it on the next
        offer or at promotion."""
        if not self._reachable(f):
            return False
        seq = msg.sequence_number
        if _SITE_LAG.fire(follower=f.node_id, doc=doc,
                          seq=seq) == KIND_DEFER:
            self.metrics["lag_deferrals"].inc()
            f.buffer_lag(doc, epoch, msg)
            return False
        fault = _SITE_ACK.fire(follower=f.node_id, doc=doc, seq=seq)
        if fault is not None:
            self.metrics["ack_retries"].inc()
            fault = _SITE_ACK.fire(follower=f.node_id, doc=doc,
                                   seq=seq, retry=True)
            if fault is not None:
                return False
        self._catch_up(f, doc, seq - 1, source_log)
        f.append_durable(doc, epoch, msg)
        return True

    def _catch_up(self, f: FollowerReplica, doc: str, upto: int,
                  source_log) -> None:
        f.flush_lag(doc)
        if f.head(doc) < upto:
            applied = f.sync_from(
                doc, source_log.read(f.head(doc), upto))
            if applied:
                self.metrics["anti_entropy"].inc(applied)

    def _force_sync(self, f: FollowerReplica, doc: str, epoch: int,
                    msg: SequencedMessage, source_log) -> None:
        """The blocking path: quorum shortfall makes the leader WAIT
        on this follower — flush its buffer, supply any missing
        middle from the leader's log, land the op. No chaos sites
        fire here: the faults already fired (and were recorded) on
        the offer; this is the barrier waiting them out."""
        self._catch_up(f, doc, msg.sequence_number - 1, source_log)
        if f.head(doc) >= msg.sequence_number:
            return  # the flushed buffer already contained it
        f.append_durable(doc, epoch, msg)

    # -- failover -------------------------------------------------------

    def kill_leader(self):
        """Host loss: the leader process is simply gone — nothing
        graceful happens; the lease stops being renewed and lapses on
        its TTL. Returns the dead server object (harnesses keep it to
        model the deposed-leader race)."""
        dead = self.server
        self.server = None
        return dead

    def laggiest_follower(self) -> FollowerReplica:
        return min(self.followers, key=lambda f: f.total_head())

    def failover(self, candidate: Optional[FollowerReplica] = None
                 ) -> ReplicatedLocalServer:
        """Elect ``candidate`` (default: the best-replicated
        follower) into the leader role. Refuses while a live lease is
        held — failover is lease-driven, never a second writer."""
        if not self.lease.expired():
            raise LeaseHeldError(
                f"lease held by {self.lease.holder!r}; failover "
                "requires the lease to lapse first")
        # the election OBSERVES the lapse — the failover timeline's
        # detection-phase boundary (obs/timeline.py failover_phases)
        _note(self.timeline, "lease_expire",
              node=self.lease.holder or "", origin="observed")
        if not self.followers:
            raise RuntimeError("no followers left to promote")
        if candidate is None:
            # only a candidate that can reach the lease service can
            # be elected (acquire() enforces it; a minority island
            # never mints an epoch). max() keeps the FIRST maximum:
            # deterministic low-index tie-break.
            eligible = [f for f in self.followers
                        if self.network is None
                        or self.network.lease_reachable(f.node_id)]
            if not eligible:
                raise LeaseUnreachableError(
                    "no follower can reach the lease service across "
                    "the partition: no election until the heal")
            candidate = max(eligible, key=lambda f: f.total_head())
        fault = _SITE_PROMOTE.fire(node=candidate.node_id)
        if fault == KIND_ERROR:
            # transient election failure: the retry is exact (nothing
            # was promoted); a second injected fault is absorbed the
            # same way — promotion is idempotent until acquire()
            _SITE_PROMOTE.fire(node=candidate.node_id, retry=True)
        return self._promote(candidate)

    def _promote(self, candidate: FollowerReplica
                 ) -> ReplicatedLocalServer:
        # 1) the candidate's own received-but-buffered tail
        candidate.flush_lag()
        # 2) anti-entropy from every surviving REACHABLE peer: any
        # fanned-out op is durable on >= quorum-1 followers, so at
        # least one surviving peer holds it in its contiguous prefix
        # (a peer across a netsplit cannot be read — the in-process
        # object is right there, but pulling from it would model an
        # impossible cross-split transfer; the heal-time catch-up
        # repairs whatever it holds)
        for peer in self.followers:
            if peer is candidate:
                continue
            if self.network is not None and not \
                    self.network.reachable(candidate.node_id,
                                           peer.node_id):
                continue
            for doc in peer.documents():
                if peer.head(doc) > candidate.head(doc):
                    applied = candidate.sync_from(
                        doc, peer.read_log(doc, candidate.head(doc)))
                    if applied:
                        self.metrics["anti_entropy"].inc(applied)
                        _note(self.timeline, "anti_entropy",
                              node=candidate.node_id,
                              source=peer.node_id, doc=doc,
                              ops=applied)
        candidate.flush_lag()
        candidate.drop_lag()
        # 3) mint the new epoch and fence everyone else out
        self.epoch = self.lease.acquire(candidate.node_id)
        self.leader_id = candidate.node_id
        self.followers = [f for f in self.followers
                          if f is not candidate]
        for f in self.followers:
            f.note_epoch(self.epoch)
        self.quorum = min(self.quorum, 1 + len(self.followers))
        self._committed = {doc: candidate.head(doc)
                           for doc in candidate.documents()}
        # 4) the follower's dir BECOMES the leader's durable dir: the
        # orderer boot path fast-forwards each sequencer to its log
        # head, so ticketing resumes at exactly the replicated head
        candidate.close()
        self.server = self._build_server(candidate.root)
        self.metrics["failovers"].inc()
        self.metrics["followers"].labels(partition=self.scope).set(
            len(self.followers))
        _note(self.timeline, "promotion", node=self.leader_id,
              epoch=self.epoch,
              followers_left=len(self.followers))
        return self.server
