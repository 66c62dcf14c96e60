"""Scale-out partitioning — the kafka-service / document-router
analogue.

The reference scales the ordering service by sharding DOCUMENTS over
Kafka partitions: raw ops are produced keyed by document id, each
partition is consumed by a lambda host that demuxes records to
per-document lambda instances, and progress is committed as a
monotonic per-partition offset so a crashed/rebalanced consumer
resumes exactly where the checkpoint says (at-least-once delivery;
deli drops below-checkpoint duplicates by clientSequenceNumber).

Reference shapes rebuilt here:
- ``Partition`` (lambdas-driver/src/kafka-service/partition.ts:26):
  one consumed queue partition -> lambda, with a CheckpointManager.
- ``CheckpointManager`` (kafka-service/checkpointManager.ts:10):
  commit the lowest fully-processed offset, monotonically.
- ``DocumentLambda``/``DocumentPartition``
  (document-router/src/{documentLambda.ts:20,documentPartition.ts:20}):
  demux a partition's record stream to per-document orderers.
- The queue itself (services-ordering-rdkafka
  ``RdkafkaConsumer``/``Producer``) becomes an ``OrderingQueue``
  interface with in-memory and file-backed (durable) impls — the
  deployment seam where a real broker would plug in.

Device mapping (SURVEY §2.9 axis 1): a partition is the host-side unit
of document-parallelism; each partition's documents batch into the same
GPU merge sidecar dispatch, and partitions map 1:1 onto mesh doc-axis
shards (parallel/mesh.py) or onto separate hosts
(parallel/distributed.py).
"""
from __future__ import annotations

import itertools
import json
import os
import zlib
from typing import Any, Callable, Iterator, Optional

from ..obs import metrics as obs_metrics
from ..obs.trace import stamp as _trace_stamp
from ..protocol.messages import ClientDetail, DocumentMessage, Nack
from ..qos.faults import (
    KIND_DROP,
    KIND_DUPLICATE,
    KIND_ERROR,
    PLANE as _CHAOS,
)
from .local_orderer import LocalOrderer
from .storage import (
    CRC_KEY,
    DocumentStorage,
    atomic_write,
    jsonl_record,
    read_offset_tolerant,
    record_crc,
    scrub_repair_jsonl,
)

# chaos seams (docs/ROBUSTNESS.md): the consume side replays a record
# (at-least-once redelivery — deli's clientSequenceNumber dedupe must
# absorb it); the append side fails transiently (a flaky broker — the
# producer retries once, mirroring RemoteOrderingQueue's reconnect
# retry)
_SITE_APPEND = _CHAOS.site("broker.queue_append", (KIND_ERROR,))
_SITE_CONSUME = _CHAOS.site("broker.queue_consume", (KIND_DUPLICATE,))
# the partitioned plane shares the document plane's replication site
# (one schedule drives both harnesses — the socket.frame_* idiom;
# service/replication.py registers the same name)
_SITE_REPL_ACK = _CHAOS.site("repl.append_ack",
                             (KIND_DROP, KIND_ERROR))

# handling accounting for the seams above: every absorbed fault leaves
# a metric delta (the failsan fault-to-signal contract,
# docs/ROBUSTNESS.md)
_M_APPEND_RETRIES = obs_metrics.REGISTRY.counter(
    "broker_append_retries_total",
    "transiently-failed queue appends retried once by the producer")
_M_REDELIVERED = obs_metrics.REGISTRY.counter(
    "broker_redelivered_records_total",
    "op records replayed by at-least-once consume redelivery "
    "(absorbed by deli's clientSequenceNumber dedupe)")
_M_DEBRIS = obs_metrics.REGISTRY.counter(
    "storage_crash_debris_cleaned_total",
    "leftover write-then-rename tmp files cleared at startup (the "
    "crash-between-write-and-rename state)", labelnames=("file",))
_M_ACK_RETRIES = obs_metrics.REGISTRY.counter(
    "repl_ack_retries_total",
    "transiently-failed follower ack offers retried once "
    "(second failure skips the round; anti-entropy repairs)")


def partition_for(document_id: str, n_partitions: int) -> int:
    """Stable document -> partition routing (the Kafka key hash)."""
    return zlib.crc32(document_id.encode()) % n_partitions


# ----------------------------------------------------------------------
# Ordering queue: the broker seam


class QueueRecord:
    __slots__ = ("offset", "document_id", "payload")

    def __init__(self, offset: int, document_id: str, payload: dict):
        self.offset = offset
        self.document_id = document_id
        self.payload = payload


class OrderingQueue:
    """Partitioned, offset-addressed raw-op transport (the Kafka
    interface: services-ordering-rdkafka/src/rdkafkaProducer.ts:52,
    rdkafkaConsumer.ts:37). At-least-once: consumers re-read from the
    committed offset after a crash."""

    # True only when fanout_lag() is in-process arithmetic (safe to
    # sample on the ingress serving path as a qos pressure source);
    # networked implementations leave this False — their lag belongs
    # in an off-loop sampler, never a blocking probe inside admit()
    fanout_lag_is_local = False

    def produce(self, partition: int, document_id: str,
                payload: dict) -> int:
        raise NotImplementedError

    def read(self, partition: int, from_offset: int
             ) -> Iterator[QueueRecord]:
        raise NotImplementedError

    def committed(self, partition: int) -> int:
        """Last committed (fully processed) offset, -1 if none."""
        raise NotImplementedError

    def commit(self, partition: int, offset: int) -> None:
        raise NotImplementedError


class InMemoryOrderingQueue(OrderingQueue):
    # fanout_lag() is in-process arithmetic: safe to sample on the
    # ingress serving path (qos pressure source). The networked
    # RemoteOrderingQueue is NOT (blocking round trip) and leaves
    # this False.
    fanout_lag_is_local = True

    def __init__(self, n_partitions: int):
        self._logs: list[list[QueueRecord]] = [
            [] for _ in range(n_partitions)
        ]
        self._committed = [-1] * n_partitions

    def produce(self, partition: int, document_id: str,
                payload: dict) -> int:
        log = self._logs[partition]
        rec = QueueRecord(len(log), document_id, payload)
        log.append(rec)
        return rec.offset

    def read(self, partition: int, from_offset: int):
        yield from self._logs[partition][max(0, from_offset):]

    def committed(self, partition: int) -> int:
        return self._committed[partition]

    def commit(self, partition: int, offset: int) -> None:
        if offset > self._committed[partition]:
            self._committed[partition] = offset

    def fanout_lag(self) -> int:
        """Produced-but-uncommitted records across all partitions —
        the consumer-lag signal the qos pressure monitor samples
        (qos/pressure.py 'broker_fanout' source)."""
        return sum(
            len(log) - 1 - committed
            for log, committed in zip(self._logs, self._committed)
        )


class FileOrderingQueue(OrderingQueue):
    """Durable queue: one append-only jsonl per partition + a committed
    offset file — enough broker semantics (ordered, offset-addressed,
    survives the process) for single-box deployments and for the
    crash-restart tests."""

    fanout_lag_is_local = True  # counters in memory, no I/O

    def __init__(self, root: str, n_partitions: int,
                 fsync: bool = False):
        self.root = root
        self.n_partitions = n_partitions
        # fsync-per-produce: the replicated queue turns this on for
        # itself and its follower roots — its quorum-durability claim
        # is only as strong as each node's own write barrier. The
        # plain single-box queue keeps the cheaper buffered append
        # (its durability story is the per-document op log).
        self.fsync = fsync
        os.makedirs(root, exist_ok=True)
        self._counts = [0] * n_partitions
        self._committed = [-1] * n_partitions
        # sequential-read cursor per partition: (record offset, byte
        # position) of the next unread record, so steady-state pumps
        # seek instead of rescanning the log from line 0 (O(N^2) over
        # the log's life otherwise)
        self._cursor: dict[int, tuple[int, int]] = {}
        for p in range(n_partitions):
            if os.path.exists(self._log_path(p)):
                with open(self._log_path(p)) as f:
                    self._counts[p] = sum(1 for _ in f)
            if os.path.exists(self._commit_path(p)):
                # tolerant parse: a pre-barrier torn overwrite (or any
                # garbage) degrades loudly to "no commit" — the
                # consumer re-reads from the head and the deli csn
                # dedupe absorbs the at-least-once replay
                self._committed[p] = read_offset_tolerant(
                    self._commit_path(p), label="queue-offset")
            # a leftover commit tmp is the crash-between-write-and-
            # rename state: the committed file is the truth
            try:
                os.remove(self._commit_path(p) + ".tmp")
                _M_DEBRIS.labels(file="queue-offset").inc()
            except OSError:
                pass

    def _log_path(self, p: int) -> str:
        return os.path.join(self.root, f"partition-{p}.jsonl")

    def _commit_path(self, p: int) -> str:
        return os.path.join(self.root, f"partition-{p}.offset")

    def produce(self, partition: int, document_id: str,
                payload: dict) -> int:
        offset = self._counts[partition]
        with open(self._log_path(partition), "a") as f:
            # crc-stamped record (storage.jsonl_record): the consume
            # path verifies it, so a bit-rotted queue record is
            # detected (and scrub-repairable from a replica root)
            # instead of sequencing garbage
            f.write(jsonl_record(
                {"document_id": document_id, "payload": payload}
            ))
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        self._counts[partition] = offset + 1
        return offset

    def read(self, partition: int, from_offset: int):
        from .storage import CorruptRecordError

        path = self._log_path(partition)
        if not os.path.exists(path):
            return
        offset, byte_pos = 0, 0
        cur = self._cursor.get(partition)
        if cur is not None and cur[0] <= from_offset:
            offset, byte_pos = cur
        with open(path) as f:
            f.seek(byte_pos)
            while True:
                line = f.readline()
                if not line:
                    break
                rec_offset = offset
                offset += 1
                self._cursor[partition] = (offset, f.tell())
                if rec_offset < from_offset:
                    continue
                data = json.loads(line)
                if CRC_KEY in data and \
                        data[CRC_KEY] != record_crc(data):
                    raise CorruptRecordError(
                        f"queue record {rec_offset} of partition "
                        f"{partition} ({path!r}) failed its crc — "
                        "bit rot; scrub-repair it from a replica "
                        "root", path=path, index=rec_offset)
                yield QueueRecord(
                    rec_offset, data["document_id"], data["payload"]
                )

    def committed(self, partition: int) -> int:
        return self._committed[partition]

    def commit(self, partition: int, offset: int) -> None:
        if offset <= self._committed[partition]:
            return
        # the shared crash-atomic barrier (storage.atomic_write): the
        # plain overwrite this replaced could leave a TORN offset
        # file — a prefix like "1" of "15" silently rewinds the
        # checkpoint (absorbed, but slow) and garbage used to crash
        # the load (tests/test_durable_storage.py pins both states)
        atomic_write(self._commit_path(partition), str(offset))
        self._committed[partition] = offset

    def fanout_lag(self) -> int:
        """Produced-but-uncommitted records across all partitions
        (the qos 'broker_fanout' pressure source; see
        InMemoryOrderingQueue.fanout_lag)."""
        return sum(
            count - 1 - committed
            for count, committed in zip(self._counts, self._committed)
        )


# ----------------------------------------------------------------------
# Replicated counterparts (service/replication.py is the document-
# plane half; these are the PARTITIONED plane's: the per-partition
# queue log replicates to follower roots behind the same quorum ack,
# and the committed offset mirrors so a promoted follower resumes at
# the replicated head + checkpoint)


class ReplicatedFileOrderingQueue(FileOrderingQueue):
    """FileOrderingQueue with per-partition log replication to N
    follower roots behind a quorum ack — fsync-and-replicate-before-
    fanout for the partitioned plane (every node in the replica set
    fsyncs its appends; the plain queue's buffered write would make
    the quorum claim hollow) — and an epoch fence: given a SHARED
    ``fence`` (it models the external lease/coordination service;
    ``fence=None`` means fencing is explicitly off), a deposed
    producer's appends are refused before any consumer could see
    them. Promotion goes through :meth:`promote`, which — exactly
    like the document plane — anti-entropies the best-replicated
    follower root against every surviving peer first: under dropped
    acks a single follower may legitimately lag, and serving IT
    directly would lose quorum-acked records."""

    def __init__(self, root: str, n_partitions: int,
                 follower_roots: list[str],
                 quorum: Optional[int] = None,
                 fence: Optional[Any] = None,
                 epoch: Optional[int] = None,
                 registry: Optional[Any] = None):
        from .replication import _group_metrics

        super().__init__(root, n_partitions, fsync=True)
        # injectable registry (the replication satellite fix): a
        # partition worker under an in-process multi-node harness
        # keeps its repl series on its OWN registry instead of
        # double-counting into the process-wide one; default None =
        # process-wide, unchanged for production
        self._metrics = _group_metrics(
            registry or obs_metrics.REGISTRY)
        if not follower_roots:
            raise ValueError(
                "a replicated queue needs at least one follower root")
        self.followers = [
            FileOrderingQueue(r, n_partitions, fsync=True)
            for r in follower_roots
        ]
        self.quorum = quorum if quorum is not None else 2
        if self.quorum > 1 + len(self.followers):
            raise ValueError(
                f"quorum {self.quorum} unsatisfiable with "
                f"{len(self.followers)} followers")
        # fencing requires a SHARED EpochFence (it models the external
        # lease/coordination service — a queue-private fence could
        # never observe a competing producer, so defaulting one would
        # read as protection while providing none). fence=None means
        # fencing is explicitly OFF.
        self.fence = fence
        if epoch is not None:
            self.epoch = epoch
        else:
            self.epoch = fence.epoch if fence is not None else 0
        for p in range(n_partitions):
            self._metrics["followers"].labels(partition=str(p)).set(
                len(self.followers))

    @staticmethod
    def promote(follower_roots: list[str], n_partitions: int,
                fence: Optional[Any] = None) -> FileOrderingQueue:
        """Elect the best-replicated follower root into the leader
        role: anti-entropy pulls any missing per-partition suffix
        (and the highest mirrored commit) from every surviving peer —
        a quorum-acked record lives on at least one of them — so the
        promoted queue resumes at the TRUE replicated head, never a
        laggard's. Pass the SHARED ``fence`` to depose the old
        producer as part of promotion (``fence.advance()`` — without
        it a presumed-dead producer that revives keeps writing). The
        document plane's promotion protocol, queue-shaped."""
        queues = [FileOrderingQueue(r, n_partitions, fsync=True)
                  for r in follower_roots]
        best = max(queues, key=lambda q: sum(q._counts))
        for peer in queues:
            if peer is best:
                continue
            for p in range(n_partitions):
                if peer._counts[p] > best._counts[p]:
                    for rec in peer.read(p, best._counts[p]):
                        best.produce(p, rec.document_id, rec.payload)
                best.commit(p, min(peer.committed(p),
                                   best._counts[p] - 1))
        if fence is not None:
            # promotion IS the deposition: every stale-epoch producer
            # and checkpoint commit is refused from here on
            fence.advance()
        return best

    def produce(self, partition: int, document_id: str,
                payload: dict) -> int:
        # fence BEFORE the replicate gate (qoscheck:fence-before-
        # fanout): a deposed producer must not extend any replica
        if self.fence is not None:
            self.fence.check(self.epoch, partition=partition)
        offset = super().produce(partition, document_id, payload)
        self._replicate_before_fanout(partition, offset)
        return offset

    def _replicate_before_fanout(self, partition: int,
                                 offset: int) -> None:
        """Quorum-durable before the consumer side may observe the
        record — same contract (and the same ``repl.append_ack``
        site) as the document plane's barrier."""
        acked = 1  # the leader's own append
        behind: list[FileOrderingQueue] = []
        for f in self.followers:
            fault = _SITE_REPL_ACK.fire(partition=partition,
                                        offset=offset)
            if fault is not None:
                _M_ACK_RETRIES.inc()
                if _SITE_REPL_ACK.fire(
                        partition=partition, offset=offset,
                        retry=True) is not None:
                    behind.append(f)
                    continue
            self._sync_follower(f, partition, offset)
            acked += 1
        for f in behind:
            if acked >= self.quorum:
                break
            # the barrier BLOCKS on the laggard (see
            # ReplicatedSequencerGroup.replicate_before_fanout)
            self._sync_follower(f, partition, offset)
            acked += 1

    def _sync_follower(self, f: FileOrderingQueue, partition: int,
                       upto_offset: int) -> None:
        start = f._counts[partition]
        for rec in self.read(partition, start):
            if rec.offset > upto_offset:
                break
            f.produce(partition, rec.document_id, rec.payload)

    def commit(self, partition: int, offset: int) -> None:
        # the committed offset is CONSUMER authority — a deposed
        # consumer moving it would silently skip records for the
        # real one
        if self.fence is not None:
            self.fence.check(self.epoch, partition=partition,
                             op="commit")
        super().commit(partition, offset)
        for f in self.followers:
            f.commit(partition,
                     min(offset, f._counts[partition] - 1))

    def scrub(self) -> int:
        """Bit-rot scrub over every replica root's partition logs:
        a record that fails its crc on one node is read-repaired from
        any peer whose copy at the same offset is intact (the leader
        included — quorum replication is what makes the repair
        possible). Returns records repaired; raises
        ``CorruptRecordError`` when no peer holds an intact copy."""
        repaired = 0
        nodes = [self] + list(self.followers)
        for p in range(self.n_partitions):
            for node in nodes:
                path = node._log_path(p)
                if not os.path.exists(path):
                    continue

                def fetch(index: int, rows: list,
                          _node=node, _p=p) -> Optional[dict]:
                    for peer in nodes:
                        if peer is _node:
                            continue
                        try:
                            for rec in peer.read(_p, index):
                                return {
                                    "document_id": rec.document_id,
                                    "payload": rec.payload,
                                }
                        except ValueError:
                            # CorruptRecordError (this peer rotted
                            # too) or a raw json decode error (a
                            # torn/garbled line on an fsync=False
                            # peer): either way, try the next peer
                            continue
                    return None

                report = scrub_repair_jsonl(path, "queue", fetch)
                if report.repaired:
                    # the rewrite replaced the inode: drop the
                    # sequential-read cursor so the next read()
                    # reopens at a valid byte position
                    node._cursor.pop(p, None)
                    repaired += report.repaired
        return repaired


class ReplicatedCheckpointManager:
    """CheckpointManager with the epoch fence on every commit: the
    offset checkpoint is the consumer's claim to the partition, and
    two consumers both advancing it is exactly the split-brain the
    fence refuses. Same surface as :class:`CheckpointManager`."""

    def __init__(self, queue: OrderingQueue, partition: int,
                 fence: Any, epoch: int):
        self._inner = CheckpointManager(queue, partition)
        self._fence = fence
        self._epoch = epoch

    def starting(self, offset: int) -> None:
        self._inner.starting(offset)

    def completed(self, offset: int) -> None:
        self._fence.check(self._epoch, op="checkpoint")
        self._inner.completed(offset)


# ----------------------------------------------------------------------
# Checkpoint manager (kafka-service/checkpointManager.ts:10)


class CheckpointManager:
    """Monotonic offset commit over possibly out-of-order record
    completion: the checkpoint is the highest offset BELOW which every
    record has completed."""

    def __init__(self, queue: OrderingQueue, partition: int):
        self._queue = queue
        self._partition = partition
        self._inflight: set[int] = set()
        self._max_seen = queue.committed(partition)

    def starting(self, offset: int) -> None:
        self._inflight.add(offset)
        self._max_seen = max(self._max_seen, offset)

    def completed(self, offset: int) -> None:
        self._inflight.discard(offset)
        floor = min(self._inflight) - 1 if self._inflight \
            else self._max_seen
        if floor >= 0:
            self._queue.commit(self._partition, floor)


# ----------------------------------------------------------------------
# Per-document demux (document-router)


class DocumentPartition:
    """One document's lambda context inside a partition
    (document-router/src/documentPartition.ts:20): owns the document's
    orderer and applies its records in partition order."""

    def __init__(self, document_id: str,
                 orderer_factory: Callable[[str], LocalOrderer]):
        self.document_id = document_id
        self.orderer = orderer_factory(document_id)

    def process(self, payload: dict) -> Optional[Nack]:
        kind = payload.get("kind", "op")
        if kind == "join":
            self.orderer.connect(ClientDetail(**payload["detail"]))
            return None
        if kind == "leave":
            self.orderer.disconnect(payload["client_id"])
            return None
        from .ingress import document_message_from_json

        op = document_message_from_json(payload["op"])
        return self.orderer.submit(payload["client_id"], op)


class Partition:
    """One consumed queue partition (kafka-service/partition.ts:26):
    reads records from the committed offset, demuxes per document,
    commits progress through a CheckpointManager."""

    def __init__(self, queue: OrderingQueue, index: int,
                 orderer_factory: Callable[[str], LocalOrderer],
                 on_nack: Optional[
                     Callable[[str, str, Nack], None]] = None,
                 on_record: Optional[Callable] = None):
        self.queue = queue
        self.index = index
        self.checkpoints = CheckpointManager(queue, index)
        self.documents: dict[str, DocumentPartition] = {}
        self._orderer_factory = orderer_factory
        self._next_offset = queue.committed(index) + 1
        self._on_nack = on_nack
        # copier hook: observes every raw record pre-sequencing
        self._on_record = on_record
        self.paused = False

    def document(self, document_id: str) -> DocumentPartition:
        if document_id not in self.documents:
            self.documents[document_id] = DocumentPartition(
                document_id, self._orderer_factory
            )
        return self.documents[document_id]

    def pump(self, max_records: Optional[int] = None) -> int:
        """Process up to ``max_records`` pending records; returns the
        number processed."""
        if self.paused:
            return 0
        n = 0
        records = self.queue.read(self.index, self._next_offset)
        if max_records is not None:
            # bound the GENERATOR, not the loop: pulling one record
            # past the limit would advance a file-backed queue's read
            # cursor beyond _next_offset and force a full-log rescan
            # on the next pump
            records = itertools.islice(records, max_records)
        for rec in records:
            self.checkpoints.starting(rec.offset)
            payload = rec.payload
            client_id = payload.get("client_id") or \
                (payload.get("detail") or {}).get("client_id", "")
            if self._on_record is not None:
                self._on_record(rec.document_id, client_id, payload)
            nack = self.document(rec.document_id).process(rec.payload)
            if nack is not None and self._on_nack is not None:
                self._on_nack(rec.document_id, client_id, nack)
            if (rec.payload.get("kind", "op") == "op"
                    and _SITE_CONSUME.fire(
                        offset=rec.offset) is not None):
                # chaos seam: at-least-once REDELIVERY of the record
                # (a consumer crash between process and commit replays
                # it) — deli's clientSequenceNumber dedupe must drop
                # the duplicate, or the op log's contiguity assert
                # detonates. Op records only: join/leave are control
                # records the reference's dedupe does not cover.
                _M_REDELIVERED.inc()
                self.document(rec.document_id).process(rec.payload)
            self.checkpoints.completed(rec.offset)
            self._next_offset = rec.offset + 1
            n += 1
        return n


# ----------------------------------------------------------------------
# Partition manager


class PartitionedOrderingService:
    """N-partition ordering service: produce raw ops keyed by document,
    pump partitions to sequence them, resume from checkpoints after a
    crash. The scale-out seam: each partition is independent, so
    partitions can live on different processes/hosts with the queue as
    the only shared substrate (exactly Kafka's role in the
    reference)."""

    def __init__(self, n_partitions: int = 4,
                 queue: Optional[OrderingQueue] = None,
                 durable_dir: Optional[str] = None,
                 copier: Optional[Any] = None,
                 on_nack: Optional[
                     Callable[[str, str, Nack], None]] = None,
                 storage_breaker: Optional[Any] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.n_partitions = n_partitions
        self.durable_dir = durable_dir
        # injectable wall clock for every partition sequencer's wire
        # timestamps; None = real wall time
        self.clock = clock
        # shared qos.CircuitBreaker across every document's checkpoint
        # writes (same semantics as LocalServer.storage_breaker)
        self.storage_breaker = storage_breaker
        # external nack hook: every partition (including ones created
        # by resume_partition) routes through _dispatch_nack, which
        # records centrally then forwards here
        self._on_nack_hook = on_nack
        if queue is None:
            if durable_dir is not None:
                queue = FileOrderingQueue(
                    os.path.join(durable_dir, "queue"), n_partitions
                )
            else:
                queue = InMemoryOrderingQueue(n_partitions)
        self.queue = queue
        self.copier = copier  # CopierLambda: raw pre-deli capture
        self.nacks: list[tuple[str, str, Nack]] = []
        self.partitions = [
            Partition(queue, p, self._make_orderer, self._record_nack,
                      on_record=copier.handler if copier else None)
            for p in range(n_partitions)
        ]

    def _record_nack(self, document_id: str, client_id: str,
                     nack: Nack) -> None:
        self.nacks.append((document_id, client_id, nack))
        if self._on_nack_hook is not None:
            self._on_nack_hook(document_id, client_id, nack)

    def _make_orderer(self, document_id: str) -> LocalOrderer:
        storage = None
        if self.durable_dir is not None:
            storage = DocumentStorage(
                os.path.join(self.durable_dir, "docs", document_id)
            )
        return LocalOrderer(document_id, storage=storage,
                            storage_breaker=self.storage_breaker,
                            clock=self.clock)

    # -- producer side (alfred -> queue) -------------------------------
    def partition_of(self, document_id: str) -> int:
        return partition_for(document_id, self.n_partitions)

    def produce_join(self, document_id: str,
                     detail: ClientDetail) -> None:
        import dataclasses

        self.queue.produce(
            self.partition_of(document_id), document_id,
            {"kind": "join", "detail": dataclasses.asdict(detail)},
        )

    def produce_leave(self, document_id: str, client_id: str) -> None:
        self.queue.produce(
            self.partition_of(document_id), document_id,
            {"kind": "leave", "client_id": client_id},
        )

    def produce_op(self, document_id: str, client_id: str,
                   op: DocumentMessage) -> None:
        from .ingress import document_message_to_json

        # the cross-node hop: the raw op entered the partitioned
        # transport. Stamped BEFORE serialization so the hop rides the
        # queue record to the consuming partition worker (timestamp
        # from the injected clock when one exists — recorded queue
        # corpora stay byte-stable per seed)
        _trace_stamp(op.traces, "partition", "route",
                     timestamp=self.clock() if self.clock else None)
        payload = {"kind": "op", "client_id": client_id,
                   "op": document_message_to_json(op)}
        partition = self.partition_of(document_id)
        # chaos seam: a transiently-failing append (flaky broker) is
        # retried ONCE — the queue mutated nothing when the fault
        # fired, so the retry is exact (RemoteOrderingQueue's
        # drop-and-reconnect retry has the same shape); a second
        # consecutive fault propagates as the loud error it is
        if _SITE_APPEND.fire(doc=document_id) is not None:
            _M_APPEND_RETRIES.inc()
            if _SITE_APPEND.fire(doc=document_id, retry=True) \
                    is not None:
                raise _SITE_APPEND.transient(KIND_ERROR)
        self.queue.produce(partition, document_id, payload)

    # -- consumer side --------------------------------------------------
    def pump(self) -> int:
        """Drain every partition; returns total records processed."""
        return sum(p.pump() for p in self.partitions)

    def orderer(self, document_id: str) -> LocalOrderer:
        p = self.partitions[self.partition_of(document_id)]
        return p.document(document_id).orderer

    # -- rebalance ------------------------------------------------------
    def pause_partition(self, index: int) -> None:
        self.partitions[index].paused = True

    def resume_partition(self, index: int) -> None:
        """Partition reassignment: a fresh consumer takes the partition
        over from its committed checkpoint (Kafka consumer-group
        rebalance). Per-document state is rebuilt from durable deli
        checkpoints + at-least-once replay — which requires durable
        storage; without it the rebuilt orderers would silently restart
        sequencing from 0 while skipping committed records."""
        if self.durable_dir is None:
            raise RuntimeError(
                "partition reassignment requires durable_dir: "
                "document state cannot be rebuilt from an in-memory "
                "consumer (unpause the existing partition instead)"
            )
        self.partitions[index] = Partition(
            self.queue, index, self._make_orderer, self._record_nack,
            on_record=self.copier.handler if self.copier else None,
        )


# ----------------------------------------------------------------------
# LocalServer-surface adapter


class _PartitionedDeltaConnection:
    """DeltaConnection surface whose submit PRODUCES into the queue
    (alfred -> Kafka -> deli), then pumps the owning partition."""

    def __init__(self, server: "PartitionedServer", document_id: str,
                 client_id: str, connection_id: str,
                 read_only: bool = False):
        self._server = server
        self.document_id = document_id
        self.client_id = client_id
        self.connection_id = connection_id
        self.read_only = read_only
        self.open = True
        self.on_message = None
        self.on_nack = None

    def submit(self, op: DocumentMessage) -> None:
        assert self.open, "submit on closed connection"
        if self.read_only:
            raise PermissionError(
                "submit on a read-mode connection (doc:read scope)")
        self._server.svc.produce_op(
            self.document_id, self.client_id, op)
        self._server.pump_document(self.document_id)

    def disconnect(self) -> None:
        if not self.open:
            return
        self.open = False
        orderer = self._server.svc.orderer(self.document_id)
        orderer.broadcaster.unsubscribe(self.connection_id)
        # only remove OUR registration: a reconnect may already have
        # re-registered the same (doc, client) for a newer connection
        key = (self.document_id, self.client_id)
        route = self._server._nack_routes.get(key)
        if route is not None and route[0] == self.connection_id:
            self._server._nack_routes.pop(key, None)
        if not self.read_only:
            self._server.svc.produce_leave(
                self.document_id, self.client_id)
            self._server.pump_document(self.document_id)


class PartitionedServer:
    """The LocalServer surface over the PARTITIONED pipeline: the
    single-box deployment shape where the front door produces raw
    records into the broker seam and per-partition consumers sequence
    them (alfred -> Kafka -> deli -> broadcaster), instead of calling
    deli inline. Drop-in for AlfredServer's ``local=``; selected by
    ``python -m fluidframework_tpu_torch.service --partitions N``."""

    def __init__(self, n_partitions: int = 4,
                 durable_dir: Optional[str] = None,
                 copier=None, queue: Optional[OrderingQueue] = None,
                 storage_breaker=None, clock=None):
        import itertools as _it

        self.svc = PartitionedOrderingService(
            n_partitions=n_partitions, durable_dir=durable_dir,
            copier=copier, on_nack=self._route_nack, queue=queue,
            storage_breaker=storage_breaker, clock=clock,
        )
        self._nack_routes: dict[tuple[str, str], Any] = {}
        self._conn_counter = _it.count()

    @property
    def queue(self):
        """The underlying ordering queue — exposed so the ingress can
        wire its fanout lag as a qos pressure source (the partitioned
        deployment's real backpressure signal lives HERE, not in the
        inline dispatch queue)."""
        return self.svc.queue

    # nacks route to the SUBMITTING client's connection only (alfred
    # emits them on the submitting socket) — the partition hands us
    # the raw record's client id, so the lookup is exact
    def _route_nack(self, document_id: str, client_id: str,
                    nack) -> None:
        route = self._nack_routes.get((document_id, client_id))
        if route is not None:
            route[1](nack)

    def get_orderer(self, document_id: str) -> LocalOrderer:
        return self.svc.orderer(document_id)

    def connect(self, document_id: str, client_id: str,
                on_message, on_nack=None, detail=None,
                read_only: bool = False) -> _PartitionedDeltaConnection:
        orderer = self.svc.orderer(document_id)
        connection_id = f"pconn-{next(self._conn_counter)}"
        conn = _PartitionedDeltaConnection(
            self, document_id, client_id, connection_id,
            read_only=read_only,
        )
        conn.on_message = on_message
        conn.on_nack = on_nack
        # subscribe BEFORE the join so the client sees its own join
        orderer.broadcaster.subscribe(
            connection_id,
            lambda msg: conn.on_message and conn.on_message(msg),
        )
        if on_nack is not None:
            # keyed by (doc, client) -> (connection_id, handler): the
            # newest connection wins, and only its own disconnect may
            # remove the route
            self._nack_routes[(document_id, client_id)] = (
                connection_id, on_nack)
        if not read_only:
            self.svc.produce_join(
                document_id, detail or ClientDetail(client_id))
            self.pump_document(document_id)
        return conn

    def pump_document(self, document_id: str) -> int:
        """Drain only the partition that owns ``document_id`` — the
        connection hot path must not do O(n_partitions) queue reads
        per op."""
        return self.svc.partitions[
            self.svc.partition_of(document_id)
        ].pump()

    def read_ops(self, document_id: str, from_seq: int,
                 to_seq: Optional[int] = None):
        return self.svc.orderer(document_id).op_log.read(
            from_seq, to_seq)

    def latest_summary(self, document_id: str):
        return self.svc.orderer(document_id).summary_store.latest()
