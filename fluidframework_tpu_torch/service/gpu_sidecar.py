"""GPU merge sidecar: device-resident merge state for the service plane.

The sidecar subscribes to sequenced channel streams, accumulates
per-document windows, applies them to a ``[max_docs, capacity]``
segment table on the GPU in one dispatch per round, and serves text and
property signatures.

EXECUTOR ROUTES (``executor=``, ``ops/event_graph.EXECUTOR_ROUTES``):
``scan`` applies the window one op per document per step in the Hopper
window kernel (``ops/cuda_merge.py``); ``chunked`` applies chunks of up
to ``CHUNK_K`` ops per macro-step (``ops/merge_chunk.py``); ``egwalker``
applies each document's critical prefix in walker spans of up to
``EG_K`` ops (``ops/event_graph.py``) and its concurrent suffix in the
window kernel. The macro-step routes are plain torch on the device.

DISPATCH PIPELINE: ``apply`` packs the queued ops on the host
(noop coalescing, ``pack_rows`` onto a ``BucketLadder`` window rung,
the route's compile), copies the program to the device, enqueues its
apply on the CUDA stream and returns; CUDA is
asynchronous, so the host can pack the next round while the device
computes. ``_settle`` is the only host<->device sync: one read of the
in-flight round's ``overflow`` flags, and recovery when one is set.

DONATED DOUBLE BUFFER (``donate=``, ``FFTPU_SIDECAR_DONATE``): with
donation on, a round writes its output into the snapshot of two rounds
ago (retired at the previous settle) through the routes' ``*_pingpong``
twins instead of a fresh table; the live input is never the donated one.

OVERFLOW RECOVERY (grow, then pool, then host): no route writes into
its input table, so the pre-dispatch table stays valid as a snapshot.
A document that outgrows its slab makes the sidecar REGROW (2x): pad
the snapshot and re-apply the same compiled program, already
on the device — O(window). The macro-step routes PARK an overflowed
document at its pre-chunk state where the scan applies on; the re-apply
from the snapshot makes served state equal either way. Past
``max_capacity`` the document moves to the POOL TIER (``seq_mesh=``), a
pool on the mesh's devices built by ``select_pool``: a
``MeshShardedPool`` (many pooled documents spread over doc shards, with
live migration of hot ones) or a ``SeqShardedPool`` (one long
document's slot axis split over seq shards); pooled documents dispatch
their watermarked stream tails at the settle boundary. What even the
pool cannot hold, or a sidecar without a pool, is EVICTED to a
host-side scalar ``MergeTreeClient`` replica, seeded by decoding its
canonical encoded stream. A document that cannot be expressed as
tensors (a 33rd client, a 5th property key) is evicted at ingest.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..convert import batch_from_numpy, program_to_device
from ..models.mergetree import MergeTreeClient
from ..obs import metrics as obs_metrics
from ..obs.flight_recorder import FlightRecorder
from ..obs.heat import HeatLedger, attribute_round
from ..obs.profiler import device_trace
from ..obs.trace import stamp as trace_stamp
from ..ops.bucket_ladder import BucketLadder
from ..ops.host_bridge import (
    OP_FIELDS,
    DocStream,
    coalesce_noops,
    decode_stream,
    extract_signature,
    extract_text,
    fetch,
    interned_signature,
    pack_rows,
    replay_chunked,
)
from ..ops.event_graph import (
    EG_K,
    apply_window_egwalker,
    apply_window_egwalker_pingpong,
    build_event_graph,
    validate_executor,
)
from ..ops.merge_chunk import (
    CHUNK_K,
    apply_window_chunked,
    apply_window_chunked_pingpong,
    compile_chunks,
    macro_steps,
)
from ..ops.merge_kernel import (
    apply_window,
    apply_window_pingpong,
    compact,
    pad_capacity,
)
from ..ops.segment_table import (
    KIND_NOOP,
    OpBatch,
    SegmentTable,
    make_table,
    shares_storage,
)
from ..parallel.mesh import DOC_AXIS, DeviceMesh
from ..parallel.seq_shard import SEQ_AXIS, apply_window_seq_sharded
from ..protocol.messages import MessageType, SequencedMessage
from ..qos.faults import (
    KIND_DEFER,
    KIND_ERROR,
    KIND_ERROR_BURST,
    PLANE as _CHAOS,
)

# Registry families, the reference's names, kinds and labels (process
# aggregates across every sidecar and pool; exact per-instance counts stay
# on the owning object: ``grow_count``, ``stats``). Everything bumped
# from inside the dispatch loop is host-side only: a registry inc and a
# flight-recorder record never touch the device.
_M_ROUNDS = obs_metrics.REGISTRY.counter(
    "sidecar_rounds_total", "dispatch rounds flushed")
_M_OPS = obs_metrics.REGISTRY.counter(
    "sidecar_real_ops_total", "non-noop ops applied on device")
_M_GROW = obs_metrics.REGISTRY.counter(
    "sidecar_grow_total", "capacity-ladder regrows")
_M_EVICT = obs_metrics.REGISTRY.counter(
    "sidecar_evict_total", "documents evicted to host replicas")
_M_POOL_ADMIT = obs_metrics.REGISTRY.counter(
    "sidecar_pool_admit_total", "documents admitted to the seq pool")
_M_RECOVER = obs_metrics.REGISTRY.counter(
    "sidecar_overflow_recoveries_total",
    "settle boundaries that found the overflow flag set")
_M_PACK_MS = obs_metrics.REGISTRY.histogram(
    "sidecar_pack_ms", "host half of a round (pack + compile)")
_M_SETTLE_MS = obs_metrics.REGISTRY.histogram(
    "sidecar_settle_ms", "device-wait at the settle boundary")
_M_TRACKED = obs_metrics.REGISTRY.gauge(
    "sidecar_tracked_channels", "channels on the device batch path")
_M_POOLED = obs_metrics.REGISTRY.gauge(
    "sidecar_pooled_docs", "documents on the seq-sharded pool tier")
_M_HOSTED = obs_metrics.REGISTRY.gauge(
    "sidecar_host_docs", "documents evicted to host replicas")
_M_CAPACITY = obs_metrics.REGISTRY.gauge(
    "sidecar_capacity", "current primary slab capacity (slots/doc)")
_M_POOL_DISPATCH = obs_metrics.REGISTRY.counter(
    "pool_dispatches_total", "seq-pool incremental dispatches")
_M_POOL_DEPTH = obs_metrics.REGISTRY.gauge(
    "pool_dispatch_depth", "ops in the last pool dispatch")
_M_POOL_WATERMARK = obs_metrics.REGISTRY.gauge(
    "pool_watermark_ops", "sum of member stream watermarks")
_M_POOL_MEMBERS = obs_metrics.REGISTRY.gauge(
    "pool_members", "documents admitted to the pool")
_M_POOL_ROUTE_FALLBACK = obs_metrics.REGISTRY.counter(
    "pool_route_fallback_total",
    "SeqShardedPool chunked-route requests served by the "
    "scan-collective executor on a real seq mesh")
_M_DUP_DROPS = obs_metrics.REGISTRY.counter(
    "sidecar_duplicate_drops_total",
    "already-ingested sequenced messages dropped by the per-document "
    "sequence-number check (at-least-once delivery upstream)")
_M_SPAN_SPLITS = obs_metrics.REGISTRY.counter(
    "egwalker_span_splits_total",
    "would-be span breaks the egwalker compiler absorbed by event "
    "splitting (each one is a saved walker launch)")
_M_DISPATCH_FAULTS = obs_metrics.REGISTRY.counter(
    "sidecar_dispatch_faults_total",
    "device dispatch rounds that failed transiently before mutating "
    "anything (ops stay queued; the next apply retries exactly)")
_M_POOL_FAULTS = obs_metrics.REGISTRY.counter(
    "pool_faults_total",
    "pool operations deferred or retried under a transient fault "
    "(shared by NAME across the seq and mesh tiers, like the "
    "sidecar.pool_* chaos sites)", labelnames=("tier", "op"))

# chaos seams, the reference's sites: the dispatch site fires BEFORE the
# round mutates anything (queues intact, so a retry is exact); the pool
# sites model a lagging pool dispatch, a deferred migration and a
# transiently failing admission
_SITE_DISPATCH = _CHAOS.site(
    "sidecar.dispatch", (KIND_ERROR, KIND_ERROR_BURST))
_SITE_POOL_DISPATCH = _CHAOS.site("sidecar.pool_dispatch", (KIND_DEFER,))
_SITE_POOL_ADMIT = _CHAOS.site("sidecar.pool_admit", (KIND_ERROR,))
_SITE_POOL_MIGRATE = _CHAOS.site("sidecar.pool_migrate", (KIND_DEFER,))


def default_executor() -> str:
    """The sidecar's executor route when the caller names none:
    ``FFTPU_SIDECAR_EXECUTOR=scan|chunked|egwalker`` if set (a typo
    raises ``ValueError``: an emergency route change must never
    silently not happen), else ``"scan"``. The default is set from the
    port's own route numbers on the H100 (PERF.md, "Routes"): there the
    scan applies a whole window in one kernel launch, and neither
    macro-step route, each a few hundred plain torch launches per
    macro-step, was faster on any corpus."""
    env = os.environ.get("FFTPU_SIDECAR_EXECUTOR")
    if env:
        validate_executor(env, "FFTPU_SIDECAR_EXECUTOR")
        return env
    return "scan"


def default_donate() -> bool:
    """Whether the sidecar donates retired tables when the caller does
    not say: ``FFTPU_SIDECAR_DONATE=0|1`` if set (any other value
    raises ``ValueError``), else off on every device. On the CPU a
    donating twin only adds a copy per field. On the card the default
    was set from the port's H100 numbers (PERF.md, "Donation"): no
    route gains device time from donation (the window kernel writes a
    retired table no faster than a fresh one, the caching allocator
    reuses freed tables anyway), and the macro-step routes lose some to
    the copy per field that their twins add each round, and hold one
    more table between rounds."""
    env = os.environ.get("FFTPU_SIDECAR_DONATE")
    if env:
        if env not in ("0", "1"):
            raise ValueError(
                f"FFTPU_SIDECAR_DONATE={env!r}: expected '0' or '1'")
        return env == "1"
    return False


class SeqShardedPool:
    """Long-document tier: documents that outgrow the primary slab
    ladder move to a table whose SLOT axis is split over the mesh's seq
    shards (per-document capacity = the seq shard count x the ladder
    top), instead of leaving the device.

    Admissions are rare (a document must exhaust the primary ladder),
    so the machinery stays simple: admitting rebuilds the pool table at
    the next power-of-two row count and re-replays every member's
    canonical encoded stream in chunked sequence-sharded dispatches.
    The table rests on the mesh's first device between dispatches (a
    dispatch splits it over the shards and joins it back); ``compact``
    runs there, since it sorts whole rows."""

    def __init__(self, mesh: DeviceMesh, per_doc_capacity: int,
                 executor: Optional[str] = None):
        if SEQ_AXIS not in mesh.axis_names:
            raise ValueError(
                f"seq pool needs a {SEQ_AXIS!r} mesh axis (got "
                f"{mesh.axis_names}); a docs-sharded mesh routes to "
                "MeshShardedPool (select_pool)")
        n_seq = mesh.shape[SEQ_AXIS]
        if per_doc_capacity % n_seq or per_doc_capacity // n_seq < 2:
            raise ValueError(
                f"pool capacity {per_doc_capacity} invalid for "
                f"{n_seq}-way seq mesh")
        doc_axes = [a for a in mesh.axis_names if a != SEQ_AXIS]
        if doc_axes and mesh.shape[doc_axes[0]] != 1:
            raise ValueError(
                "pool requires an unsharded doc axis (doc_shards=1): "
                "row admissions don't track a sharded row axis")
        self.mesh = mesh
        self.device = mesh.device_list()[0]
        self.n_seq = n_seq
        self.capacity = per_doc_capacity
        # the chunked / egwalker macro-steps' multi-key sort does not
        # decompose over a slot-sharded axis: those routes apply only on
        # a one-shard seq mesh (an egwalker pool routes CHUNKED there:
        # pool dispatches are full-history replays); a real seq mesh
        # keeps the collective scan and says so once (_warn_route_once)
        validate_executor(executor, "executor")
        self.executor = executor or default_executor()
        self._route_warned = False
        self.members: list[int] = []      # sidecar slot per pool row
        self.row_of: dict[int, int] = {}  # sidecar slot -> row
        # per-member STREAM WATERMARK: how many of the slot's canonical
        # stream ops the pool table already reflects. A full-stream
        # rebuild advances every watermark to the stream head, so ops it
        # subsumed can never dispatch again: a deferred-op batch racing
        # a recovery rebuild cannot apply twice
        self.applied_upto: dict[int, int] = {}
        self._table: Optional[SegmentTable] = None
        self.dispatch_count = 0
        self.last_dispatch_depth = 0

    def _bucket(self) -> int:
        b = 1
        while b < max(1, len(self.members)):
            b *= 2
        return b

    def _warn_route_once(self) -> None:
        if self._route_warned:
            return
        self._route_warned = True
        _M_POOL_ROUTE_FALLBACK.inc()
        print(
            f"fftpu: SeqShardedPool: the {self.executor} macro-step does "
            "not decompose over a slot-sharded axis; using the "
            f"scan-collective route on this {self.n_seq}-way seq mesh (a "
            "docs-sharded MeshShardedPool follows the executor route — "
            "see select_pool)", file=sys.stderr, flush=True)

    def _apply(self, table: SegmentTable, arrays: dict) -> SegmentTable:
        if self.executor in ("chunked", "egwalker") and self.n_seq == 1:
            program = compile_chunks(arrays, k_max=CHUNK_K)
            out = apply_window_chunked(
                table, program_to_device(program, self.device), K=CHUNK_K,
                steps=macro_steps(program["chunk_start"], CHUNK_K))
        else:
            if self.executor in ("chunked", "egwalker"):
                self._warn_route_once()
            out = apply_window_seq_sharded(table, OpBatch(**arrays),
                                           self.mesh)
        # compact after every pool dispatch: remove-heavy histories
        # otherwise accumulate dead segments until they overflow a pool
        # that could easily hold the live text
        return compact(out)

    def _replay_all(self, streams) -> None:
        """Rebuild the pool table and re-replay every member's stream."""
        if not self.members:
            self._table = None
            return
        self._table = replay_chunked(
            self._apply, make_table(self._bucket(), self.capacity,
                                    self.device),
            {row: streams[slot].ops for row, slot in enumerate(self.members)},
            chunk=BucketLadder.replay_chunk(self.capacity),
        )
        self.applied_upto = {
            slot: len(streams[slot].ops) for slot in self.members}
        _M_POOL_MEMBERS.set(len(self.members))
        _M_POOL_WATERMARK.set(sum(self.applied_upto.values()))

    def admit(self, slots: list, streams) -> list:
        """Admit sidecar slots; returns the slots that FAILED (past even
        the pooled capacity) and were rolled back out."""
        for slot in slots:
            if slot not in self.row_of:
                self.row_of[slot] = len(self.members)
                self.members.append(slot)
        self._replay_all(streams)
        failed = self.overflowed_slots()
        if failed:
            for slot in failed:
                self.remove(slot)
            self._replay_all(streams)
        return failed

    def remove(self, slot: int) -> None:
        """Bookkeeping only: the table still holds the removed row's data
        and flags at the OLD indices. Callers MUST follow with rebuild()
        before the next read or dispatch, or the other members read the
        wrong rows and stale overflow flags evict innocent documents."""
        if slot not in self.row_of:
            return
        row = self.row_of.pop(slot)
        self.applied_upto.pop(slot, None)
        self.members.pop(row)
        for s2, r2 in self.row_of.items():
            if r2 > row:
                self.row_of[s2] = r2 - 1

    def rebuild(self, streams) -> None:
        self._replay_all(streams)

    def dispatch_pending(self, streams) -> list:
        """Apply every member's un-applied canonical-stream tail (past its
        watermark) in one dispatch; returns the slots that overflowed the
        pool. Tails a rebuild already subsumed are empty here, so this is
        exactly-once after any mix of rebuilds and dispatches."""
        if self._table is None:
            return []
        if _SITE_POOL_DISPATCH.fire(tier="seq") is not None:
            # deferred: tails stay past the watermark and apply whole at
            # the next settle — exactly once by construction
            _M_POOL_FAULTS.labels(tier="seq", op="dispatch").inc()
            return []
        pending, upto = {}, {}
        for slot, row in self.row_of.items():
            tail = streams[slot].ops[self.applied_upto.get(slot, 0):]
            if tail:
                pending[row] = coalesce_noops(tail)
                upto[slot] = len(streams[slot].ops)
        if not pending:
            return []
        depth = sum(len(ops) for ops in pending.values())
        self.dispatch_count += 1
        self.last_dispatch_depth = depth
        _M_POOL_DISPATCH.inc()
        _M_POOL_DEPTH.set(depth)
        self._table = self._apply(self._table,
                                  pack_rows(self._table.docs, pending))
        self.applied_upto.update(upto)
        _M_POOL_WATERMARK.set(sum(self.applied_upto.values()))
        return self.overflowed_slots()

    def prewarm(self) -> float:
        """Build the window kernel a one-shard seq pool launches on CUDA
        (nothing to do on the CPU); returns the seconds it took."""
        if self.mesh.device_type != "cuda":
            return 0.0
        from ..ops.cuda_merge import prewarm

        return prewarm()

    def overflowed_slots(self) -> list:
        if self._table is None:
            return []
        flags = self._table.overflow.cpu().numpy()
        return [self.members[r] for r in np.nonzero(flags)[0].tolist()
                if r < len(self.members)]

    def fetch(self) -> dict:
        return fetch(self._table)


def select_pool(mesh, per_doc_capacity: Optional[int] = None,
                executor: Optional[str] = None,
                route: Optional[str] = None,
                max_capacity: int = 16384,
                plane: str = "merge",
                device: torch.device | str = "cuda"):
    """THE route-selection point between the pool tiers: every sidecar
    pool (merge and tree plane) is constructed here, nowhere else.
    ``plane='tree'`` builds the tree plane's ``TreeSeqPool`` on
    ``device`` (its per-changeset sorts do not decompose over a
    slot-sharded axis, so the mesh is unused there and ``route`` does
    not apply); the merge pools live on the mesh's devices.

    - a mesh with a real ``seq`` axis (size > 1) -> ``SeqShardedPool``;
    - a mesh with a sharded ``docs`` axis -> ``MeshShardedPool``;
    - a one-shard mesh -> the tier its axis names match (a ``seq`` mesh
      the seq pool, a ``docs`` mesh a one-shard mesh pool).

    ``route='seq'|'mesh'`` (argument) or ``FFTPU_SIDECAR_POOL=seq|mesh``
    (environment; the argument wins) overrides; an unknown value raises
    ``ValueError``, and an override that does not fit the mesh fails in
    the chosen pool's own validation: an emergency route change must
    never silently not happen.

    Default ``per_doc_capacity``: the seq pool multiplies the ladder top
    by its seq-shard count; the mesh pool grants 4x the ladder top,
    capped at 8192 (per-document capacity stays chip-local there, and
    the op_off composite needs capacity * OPOFF_BOUND < 2**31)."""
    if plane not in ("merge", "tree"):
        raise ValueError(f"plane={plane!r}: expected 'merge' or 'tree'")
    if plane == "tree":
        from .tree_sidecar import TreeSeqPool

        return TreeSeqPool(
            mesh,
            per_doc_capacity if per_doc_capacity is not None
            else min(max_capacity * 4, 16384),
            executor=executor, device=device)
    source = "pool_route"
    validate_executor(executor, "executor")
    if route is None:
        route = os.environ.get("FFTPU_SIDECAR_POOL") or None
        source = "FFTPU_SIDECAR_POOL"
    if route is not None and route not in ("seq", "mesh"):
        raise ValueError(f"{source}={route!r}: expected 'seq' or 'mesh'")
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a merge pool needs a DeviceMesh, got {mesh!r}")
    seq_n = mesh.shape.get(SEQ_AXIS, 1)
    doc_n = mesh.shape.get(DOC_AXIS, 1)
    if route is None:
        if seq_n > 1:
            route = "seq"
        elif doc_n > 1:
            route = "mesh"
        else:
            route = "seq" if SEQ_AXIS in mesh.axis_names else "mesh"
    if route == "mesh":
        from ..parallel.mesh_pool import MeshShardedPool

        if per_doc_capacity is None:
            per_doc_capacity = min(max_capacity * 4, 8192)
        return MeshShardedPool(mesh, per_doc_capacity,
                               executor=executor or default_executor())
    if per_doc_capacity is None:
        per_doc_capacity = max_capacity * seq_n
    return SeqShardedPool(mesh, per_doc_capacity, executor=executor)


class GpuMergeSidecar:
    """Batched merge state for up to ``max_docs`` sequence channels.

    One tracked channel (doc slot) = one (document, datastore, channel)
    sequence stream. ``ingest`` consumes the document's sequenced
    envelope stream; ``apply`` flushes accumulated windows to the
    device in a single pipelined dispatch.

    ``executor`` picks the route (``scan``, ``chunked`` or
    ``egwalker``; None: ``default_executor()``); every route runs on
    the sidecar's device. ``device`` is ``"cuda"`` unless the caller
    asks for ``"cpu"`` (the tests do); with no GPU the default raises
    instead of running on the CPU.

    ``seq_mesh`` (a ``DeviceMesh`` of the sidecar's device type) turns
    the pool tier on, built by ``select_pool`` (``pool_route`` /
    ``FFTPU_SIDECAR_POOL`` override its choice; ``pool_capacity`` its
    per-document capacity).

    ``donate`` (None: ``default_donate``) turns the donated double
    buffer on: each round's output is written into the table retired
    two rounds ago (the pools keep their own dispatch).

    The observability and protection hooks are the reference's, at the
    same points of the round; all of them are host-side and none reads
    the device outside ``_settle``:

    - the registry families (``sidecar_*``, ``pool_*``) and a
      ``FlightRecorder(256, name="sidecar")`` (``flight``) record every
      round, settle and recovery; an overflow recovery or a breaker
      trip dumps it (``last_flight_dump``);
    - ``trace_ops`` (None: ``FFTPU_SIDECAR_TRACE=0|1``, a typo raises
      ``ValueError``; default off) stamps ``sidecar:pack`` and
      ``sidecar:settle`` on every ingested message's ``traces``;
    - ``breaker`` (a ``qos.CircuitBreaker``) wraps ``apply``: an open
      breaker leaves the ops queued and ``apply`` returns 0;
    - the chaos sites ``sidecar.dispatch`` / ``sidecar.pool_dispatch``
      / ``sidecar.pool_admit`` fire before the round mutates anything,
      so a retry is exact;
    - ``heat`` (a ``HeatLedger``) is charged at ``_settle`` with each
      round's wall-ms split over its documents by ops applied
      (``attribute_round``); ``attr_clock`` is the host clock it reads;
    - ``device_trace`` (``FFTPU_DEVICE_TRACE=1``) names the device
      half of every dispatch ``sidecar:dispatch:r{n}``.
    """

    def __init__(self, max_docs: int = 1024, capacity: int = 1024,
                 compact_every: int = 8, max_capacity: int = 16384,
                 seq_mesh=None, pool_capacity: Optional[int] = None,
                 pool_route: Optional[str] = None,
                 executor: Optional[str] = None,
                 pipeline: bool = True,
                 donate: Optional[bool] = None,
                 ladder: Optional[BucketLadder] = None,
                 device: torch.device | str = "cuda",
                 trace_ops: Optional[bool] = None,
                 breaker=None,
                 heat: Optional[HeatLedger] = None,
                 attr_clock: Optional[Callable[[], float]] = None):
        validate_executor(executor, "executor")
        self.executor = executor or default_executor()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "GpuMergeSidecar needs a CUDA device; pass device='cpu' "
                "to run the plain version on the CPU")
        if trace_ops is not None:
            self.trace_ops = trace_ops
        else:
            env_trace = os.environ.get("FFTPU_SIDECAR_TRACE")
            if env_trace and env_trace not in ("0", "1"):
                raise ValueError(
                    f"FFTPU_SIDECAR_TRACE={env_trace!r}: expected '0' or "
                    "'1'")
            self.trace_ops = env_trace == "1"
        # messages ingested since the last dispatch / packed into the
        # in-flight round (trace_ops bookkeeping; cleared every round)
        self._round_msgs: list[SequencedMessage] = []
        self._inflight_msgs: list[SequencedMessage] = []
        # the dispatch loop's last rounds, host-side events only
        self.flight = FlightRecorder(256, name="sidecar")
        self.last_flight_dump: Optional[str] = None
        # an open breaker leaves the ops queued (queued_ops grows); its
        # trip dumps this sidecar's flight recorder
        self.breaker = breaker
        if breaker is not None and breaker.on_open is None:
            def _dump_on_open(b) -> None:
                self.last_flight_dump = self.flight.dump_to(
                    reason=f"circuit breaker {b.name!r} opened "
                           f"(last error: {b.last_error!r})")
            breaker.on_open = _dump_on_open
        # device-time attribution: counts captured at pack time, charged
        # at the settle boundary from a host clock
        self.heat = heat
        self._attr_clock = (attr_clock if attr_clock is not None
                            else time.perf_counter)
        self._attr_counts: dict[str, int] = {}
        self._attr_t0 = 0.0
        self._slot_doc: dict[int, str] = {}
        if os.environ.get("FFTPU_SANITIZE") == "1":
            from ..testing import jitsan

            jitsan.install_from_env()
        self.donate = (donate if donate is not None
                       else default_donate())
        # pool tier: past the ladder top, documents move to a pool on the
        # mesh before any host eviction
        self._pool = None
        if seq_mesh is not None:
            self._pool = select_pool(
                seq_mesh, pool_capacity, executor=self.executor,
                route=pool_route, max_capacity=max_capacity)
            if self._pool.mesh.device_type != self.device.type:
                raise ValueError(
                    f"a {self.device.type} sidecar with a pool mesh on "
                    f"{self._pool.mesh.device_type}")
        self.pool_admit_count = 0
        self.max_docs = max_docs
        self.capacity = capacity
        self.max_capacity = max_capacity
        self.pipeline = pipeline
        self.ladder = ladder or BucketLadder()
        self._table = make_table(max_docs, capacity, self.device)
        self._slots: dict[tuple[str, str, str], int] = {}
        self._doc_slots: dict[str, list[tuple[int, str, str]]] = {}
        # per-document last ingested seq (the at-least-once dedupe)
        self._last_ingested: dict[str, int] = {}
        # per-slot applied-head seq (egwalker route): the max seq of any
        # op already dispatched for the slot. build_event_graph judges
        # ops whose refseq predates the window against it; advanced
        # after each window's program is compiled
        self._slot_head = np.zeros(max_docs, np.int64)
        # the encoded stream is the single canonical per-doc history:
        # eviction decodes it back into sequenced messages
        self._streams: list[DocStream] = []
        self._queued: list[list[dict]] = []
        # slot -> host oracle replica (evicted documents)
        self._host: dict[int, MergeTreeClient] = {}
        # pipeline state: the pre-dispatch snapshot and the device
        # program of the window it predates (regrow re-applies it), and
        # whether the in-flight round's overflow flag has been read yet
        self._prev_table: Optional[SegmentTable] = None
        self._last_program: Optional[dict] = None
        self._unsettled = False
        # donation fodder: the snapshot retired at the last settle, which
        # the next round writes its output into (donate on)
        self._dead: Optional[SegmentTable] = None
        self._applies = 0
        self._compact_every = compact_every
        self.grow_count = 0
        self.evict_count = 0
        # host ints per sidecar: host-pack (pack + route compile) and
        # settle (device-wait) seconds, rounds, macro-steps run, the
        # would-be span breaks the egwalker compiler absorbed, and the
        # seconds of pool dispatches (at settle) and pool admissions
        self.stats = {"pack_s": 0.0, "settle_s": 0.0, "rounds": 0,
                      "macro_steps": 0, "span_splits": 0,
                      "pool_s": 0.0, "admit_s": 0.0}
        _M_CAPACITY.set(self.capacity)

    # ------------------------------------------------------------------
    # registration + ingest

    def track(self, document_id: str, datastore_id: str,
              channel_id: str) -> int:
        key = (document_id, datastore_id, channel_id)
        if key in self._slots:
            return self._slots[key]
        if len(self._streams) >= self.max_docs:
            raise RuntimeError("sidecar document capacity exhausted")
        slot = len(self._streams)
        self._slots[key] = slot
        self._slot_doc[slot] = document_id
        self._doc_slots.setdefault(document_id, []).append(
            (slot, datastore_id, channel_id)
        )
        self._streams.append(DocStream())
        self._queued.append([])
        _M_TRACKED.set(len(self._streams))
        return slot

    def subscribe(self, server, document_id: str, datastore_id: str,
                  channel_id: str) -> None:
        """Attach to a server document's broadcaster (after the
        sequencer, beside the storage writer)."""
        self.track(document_id, datastore_id, channel_id)
        orderer = server.get_orderer(document_id)
        orderer.broadcaster.subscribe(
            f"gpu-sidecar-{id(self)}/{document_id}/{datastore_id}/"
            f"{channel_id}",
            lambda msg: self.ingest(document_id, msg),
        )

    def ingest(self, document_id: str, msg: SequencedMessage) -> None:
        """Consume one sequenced message of a document: channel ops for
        tracked channels encode as kernel ops; everything else becomes
        a NOOP that still advances the collab window.

        A message at/below the document's last ingested sequence number
        is a duplicate delivery and is dropped (at-least-once
        upstream)."""
        last = self._last_ingested.get(document_id, 0)
        if msg.sequence_number <= last:
            _M_DUP_DROPS.inc()
            return
        self._last_ingested[document_id] = msg.sequence_number
        if self.trace_ops and any(
            slot not in self._host
            for slot, _, _ in self._doc_slots.get(document_id, ())
        ):
            # the pack and settle hops of the round that carries it stamp
            # this object later (dataclasses.replace below shares the
            # traces list); fully evicted documents never reach a round
            self._round_msgs.append(msg)
        for slot, ds_id, ch_id in self._doc_slots.get(document_id, ()):
            stream = self._streams[slot]
            envelope = msg.contents if isinstance(msg.contents, dict) else {}
            if (
                msg.type == MessageType.OPERATION
                and envelope.get("kind", "op") == "op"
                and envelope.get("address") == ds_id
                and envelope.get("channel") == ch_id
            ):
                inner = dataclasses.replace(
                    msg, contents=envelope["contents"]
                )
            else:
                inner = dataclasses.replace(
                    msg, type=MessageType.NO_OP, contents=None,
                    client_id=None,
                )
            if slot in self._host:
                self._host[slot].apply_msg(inner)
                continue
            before = len(stream.ops)
            before_payloads = len(stream.payloads)
            try:
                if inner.type == MessageType.OPERATION:
                    stream.add_message(inner)
                else:
                    stream.add_noop(inner.minimum_sequence_number)
            except ValueError:
                # inexpressible in tensor form: roll the partial encode
                # back so the canonical stream stays exact, then the
                # host replica takes over, seeded from the stream, plus
                # the message that failed
                del stream.ops[before:]
                del stream.payloads[before_payloads:]
                self._settle()
                self._evict(slot)
                self._host[slot].apply_msg(inner)
                continue
            self._queued[slot].extend(stream.ops[before:])

    # ------------------------------------------------------------------
    # device application (the dispatch pipeline)

    @property
    def queued_ops(self) -> int:
        return sum(len(q) for q in self._queued)

    def apply(self) -> int:
        """Flush all queued windows in one batched dispatch; returns the
        number of real (non-noop) ops applied. Returns at enqueue: this
        round's overflow flag is read (and recovery run) at the next
        apply or read, inside ``_settle`` — or before returning when
        ``pipeline`` is off."""
        if not self._queued or self.queued_ops == 0:
            return 0
        if self.breaker is not None:
            if not self.breaker.allow():
                # open (or out of probes): the ops stay queued
                return 0
            try:
                real = self._dispatch()
            except Exception as e:  # noqa: BLE001 - the breaker records all
                self.breaker.record_failure(e)
                raise
            self.breaker.record_success()
        else:
            real = self._dispatch()
        self._applies += 1
        if self._applies % self._compact_every == 0:
            self._table = compact(self._table)
        if not self.pipeline:
            self._settle()
        return real

    def sync(self) -> None:
        """Barrier: settle the in-flight round (overflow recovery)."""
        self._settle()

    def prewarm(self, max_bucket: Optional[int] = None) -> float:
        """Walk every shape the (docs, window, capacity) ladder can
        reach on scratch tables: an all-noop window per capacity rung of
        the regrow ladder (``capacity`` up to ``max_capacity``) x window
        bucket up to ``max_bucket`` (default: the ladder's own) through
        the active route (through its donating
        twin when ``donate`` is on; on the egwalker route also the
        suffix's scan), ``compact`` per rung and ``pad_capacity``
        between rungs, then the pool's prewarm. On ``cuda`` the window
        kernel is built first and the walk ends in one device sync.
        The live table is untouched. A rung past 8192 trips the
        capacity ceiling, as in the reference (ROADMAP §C). Returns the
        seconds spent."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from ..ops.cuda_merge import prewarm as build_kernel

            build_kernel()
        noop = dict.fromkeys(OP_FIELDS, 0)
        noop["kind"] = KIND_NOOP
        head = np.zeros(self.max_docs, np.int64)
        prev = None
        for rung in BucketLadder.capacity_rungs(self.capacity,
                                                self.max_capacity):
            table = make_table(self.max_docs, rung, self.device)
            for bucket in self.ladder.window_buckets(max_bucket):
                arrays = pack_rows(self.max_docs, {0: [noop]},
                                   bucket_floor=bucket)
                program = self._to_device(
                    self._compile_program(arrays, head))
                dead = (make_table(self.max_docs, rung, self.device)
                        if self.donate else None)
                table = self._apply_program(table, program, dead)
                if self.executor == "egwalker":
                    # an all-noop window is wholly critical, so the walk
                    # applies the suffix's scan at this shape itself
                    table = self._apply_program(
                        table, self._to_device({"scan": arrays, "steps": 0}))
            table = compact(table)
            if prev is not None:
                pad_capacity(prev, rung)
            prev = table
        if self._pool is not None:
            self._pool.prewarm()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _compile_program(self, arrays: dict, base_head: np.ndarray) -> dict:
        """Host half of one dispatch: the packed arrays for the scan
        route, the compiled chunk program for the chunked route, the
        event-graph program (critical prefix + concurrent suffix,
        judged against the per-slot applied heads ``base_head``) for
        the egwalker route — each with its macro-step count, counted
        here on the host."""
        if self.executor == "chunked":
            program = compile_chunks(arrays, k_max=CHUNK_K)
            return {"chunked": program,
                    "steps": macro_steps(program["chunk_start"], CHUNK_K)}
        if self.executor == "egwalker":
            program = build_event_graph(
                arrays, base_head=base_head, k_max=EG_K,
                window_floor=self.ladder.window_floor)
            prefix = program["prefix"]
            return {"prefix": prefix, "suffix": program["suffix"],
                    "steps": 0 if prefix is None
                    else macro_steps(prefix["chunk_start"], EG_K),
                    "span_splits": int(program["span_splits"].sum())}
        return {"scan": arrays, "steps": 0}

    def _to_device(self, program: dict) -> dict:
        """The host-to-device copy of a compiled program: one copy per
        op block (``convert.program_to_device``)."""
        out = dict(program)
        for key in ("scan", "suffix"):
            if out.get(key) is not None:
                out[key] = batch_from_numpy(out[key], self.device)
        for key in ("chunked", "prefix"):
            if out.get(key) is not None:
                out[key] = program_to_device(out[key], self.device)
        return out

    def _apply_program(self, table: SegmentTable, program: dict,
                       dead: Optional[SegmentTable] = None) -> SegmentTable:
        """Device half of one dispatch, on a program already on the
        device; ``dead`` (optional) is a retired table of ``table``'s
        shape that the route's donating twin writes its output into.
        Enqueues work only: nothing here waits for the device."""
        if "scan" in program:
            if dead is not None:
                return apply_window_pingpong(dead, table, program["scan"])
            return apply_window(table, program["scan"])
        if "chunked" in program:
            return apply_window_chunked_pingpong(
                dead, table, program["chunked"], K=CHUNK_K,
                steps=program["steps"])
        # egwalker: the walker over every doc's critical prefix, then
        # the scan over the concurrent suffixes (per doc the suffix
        # follows the prefix in sequenced order). Donation rides the
        # walker stage: the suffix's input is that stage's live output
        if program["prefix"] is not None:
            table = apply_window_egwalker_pingpong(
                dead, table, program["prefix"], K=EG_K,
                steps=program["steps"])
        if program["suffix"] is not None:
            table = apply_window(table, program["suffix"])
        return table

    def _dispatch(self) -> int:
        # chaos seam, BEFORE any mutation: the queues are intact, so the
        # raised transient is exactly a failed device dispatch and the
        # next apply() retries the identical round
        fault = _SITE_DISPATCH.fire(queued=self.queued_ops)
        if fault is not None:
            _M_DISPATCH_FAULTS.inc()
            raise _SITE_DISPATCH.transient(fault)
        t0 = time.perf_counter()
        attr_t0 = self._attr_clock() if self.heat is not None else 0.0
        # HOST HALF — runs while the device still computes the previous
        # round: coalesce noop runs (safe: the queue is consumed whole),
        # pad the window to a ladder rung, compile the route's program
        packed = [coalesce_noops(q) for q in self._queued]
        attr_counts: dict[str, int] = {}
        if self.heat is not None:
            # per-document real-op counts off the pack (host ints; before
            # the pool tier takes its slots out of the window, so pooled
            # documents attribute too)
            for slot, ops in enumerate(packed):
                n = sum(1 for op in ops if op["kind"] != KIND_NOOP)
                if n and slot in self._slot_doc:
                    doc = self._slot_doc[slot]
                    attr_counts[doc] = attr_counts.get(doc, 0) + n
        pool_real = 0
        if self._pool is not None:
            # pooled docs dispatch from their canonical-stream tails at
            # the settle boundary (watermarked, rebuild-proof); their
            # queued copies are counted here and left out of the window
            for slot in list(self._pool.row_of):
                if packed[slot]:
                    pool_real += sum(1 for op in packed[slot]
                                     if op["kind"] != KIND_NOOP)
                    packed[slot] = []
        arrays = pack_rows(
            self.max_docs,
            {slot: ops for slot, ops in enumerate(packed) if ops},
            bucket_floor=self.ladder.window_floor,
        )
        program = self._compile_program(arrays, self._slot_head)
        if self.executor == "egwalker":
            # advance the applied heads AFTER compiling: the program's
            # criticality was judged against the pre-window heads (a
            # grow re-apply reuses the compiled program)
            for slot, ops in enumerate(packed):
                for op in reversed(ops):
                    if op["kind"] != KIND_NOOP:
                        if op["seq"] > self._slot_head[slot]:
                            self._slot_head[slot] = op["seq"]
                        break
        real = sum(
            1 for ops in packed for op in ops if op["kind"] != KIND_NOOP
        )
        for queue in self._queued:
            queue.clear()
        pack_s = time.perf_counter() - t0
        self.stats["pack_s"] += pack_s
        self.stats["rounds"] += 1
        self.stats["macro_steps"] += program["steps"]
        self.stats["span_splits"] += program.get("span_splits", 0)
        _M_ROUNDS.inc()
        _M_OPS.inc(real + pool_real)
        _M_PACK_MS.observe(pack_s * 1000.0)
        if program.get("span_splits"):
            _M_SPAN_SPLITS.inc(program["span_splits"])
        self.flight.record(
            "dispatch", round=self.stats["rounds"], real_ops=real,
            pool_ops=pool_real, pack_ms=round(pack_s * 1000.0, 3),
            capacity=self.capacity,
        )
        if self.trace_ops and self._round_msgs:
            pack_t = time.time()
            for m in self._round_msgs:
                trace_stamp(m.traces, "sidecar", "pack", timestamp=pack_t)
        # SYNC BOUNDARY — read the previous round's overflow flag (and
        # charge and stamp the previous round) before its snapshot is
        # retired
        self._settle()
        dead, self._dead = self._dead, None
        self._prev_table = self._table
        self._last_program = self._to_device(program)
        self._unsettled = True
        if self.heat is not None:
            self._attr_counts = attr_counts
            self._attr_t0 = attr_t0
        if self.trace_ops:
            self._inflight_msgs = self._round_msgs
            self._round_msgs = []
        # the device half, named by round in a device trace (opt-in:
        # FFTPU_DEVICE_TRACE=1); either way it forces no sync
        with device_trace(f"sidecar:dispatch:r{self.stats['rounds']}",
                          self.device):
            self._table = self._apply_program(
                self._prev_table, self._last_program,
                self._fodder(dead, self._prev_table))
        return real + pool_real

    def _fodder(self, dead: Optional[SegmentTable],
                table: SegmentTable) -> Optional[SegmentTable]:
        """``dead`` if a round on the live ``table`` may write into it:
        donation on, ``table``'s shape, and no storage shared with it (a
        route may pass an untouched field through, and ``compact`` /
        ``_retire_rows`` build tables that share fields). Host-only."""
        if (not self.donate or dead is None
                or (dead.docs, dead.capacity) != (table.docs,
                                                  table.capacity)
                or shares_storage(dead, table)):
            return None
        return dead

    def _settle(self) -> None:
        """The host<->device sync boundary: read the in-flight round's
        overflow flags, run recovery if one is set, then dispatch the
        pooled documents' stream tails. Reads and the next dispatch both
        funnel through here."""
        if not self._unsettled:
            return
        self._unsettled = False
        t0 = time.perf_counter()
        overflowed = bool(self._table.overflow.any())
        settle_s = time.perf_counter() - t0
        self.stats["settle_s"] += settle_s
        _M_SETTLE_MS.observe(settle_s * 1000.0)
        # `overflowed` is a host bool by now: the record reads no device
        self.flight.record("settle", settle_ms=round(settle_s * 1000.0, 3),
                           overflow=overflowed)
        if self.heat is not None and self._attr_counts:
            # the round's wall-ms (dispatch start -> here) split over its
            # documents by ops applied: host math over host ints
            round_ms = (self._attr_clock() - self._attr_t0) * 1000.0
            attribute_round(self.heat, self._attr_counts, round_ms)
            self._attr_counts = {}
        if self.trace_ops and self._inflight_msgs:
            settle_t = time.time()
            for m in self._inflight_msgs:
                trace_stamp(m.traces, "sidecar", "settle",
                            timestamp=settle_t)
            self._inflight_msgs = []
        if overflowed:
            _M_RECOVER.inc()
            # the automatic postmortem: what the loop did in the rounds
            # leading up to the overflow
            self.last_flight_dump = self.flight.dump_to(
                reason="_settle found the overflow flag set "
                       "(recovery running)")
            self._recover()
            # recovery re-applied, possibly at a new capacity: the old
            # snapshot is no fodder
            self._dead = None
        elif self.donate:
            self._dead = self._prev_table
        self._prev_table = None
        self._last_program = None
        if self._pool is not None and self._pool.members:
            # the pool reads its overflow flags on the spot, hence its
            # dispatch lives here; it advances only when a flush was in
            # flight, so reads stay side-effect-free and ingested but
            # never-applied ops stay invisible on both tiers
            t0 = time.perf_counter()
            for slot in self._pool.dispatch_pending(self._streams):
                self._evict(slot)  # past even the pooled capacity
            self.stats["pool_s"] += time.perf_counter() - t0

    # ------------------------------------------------------------------
    # overflow recovery: grow ladder, then pool, then host eviction

    def _recover(self) -> None:
        while True:
            overflowed = torch.nonzero(self._table.overflow).flatten()
            if overflowed.numel() == 0:
                return
            if self.capacity * 2 <= self.max_capacity:
                self._grow(self.capacity * 2)
            elif self._pool is not None:
                for slot in self._admit_to_pool(overflowed.tolist()):
                    self._evict(slot)
                return
            else:
                for slot in overflowed.tolist():
                    self._evict(slot)
                return

    def _grow(self, new_capacity: int) -> None:
        """Grow the slab 2x and retry the failed window: pad the
        pre-dispatch snapshot and re-apply the SAME compiled program,
        still on the device, at the new capacity (the failed dispatch
        wrote a fresh table, so the snapshot is intact; a route that
        parked a document re-applies its whole window here)."""
        self.grow_count += 1
        _M_GROW.inc()
        self.capacity = new_capacity
        _M_CAPACITY.set(new_capacity)
        self.flight.record("recover-grow", capacity=new_capacity)
        self._prev_table = pad_capacity(self._prev_table, new_capacity)
        self.stats["macro_steps"] += self._last_program["steps"]
        self._table = self._apply_program(self._prev_table,
                                          self._last_program)

    def _retire_rows(self, slots: list) -> None:
        """Zero the table's count/overflow of ``slots``: reads route to
        the host replica, and a stale overflow flag would re-trigger
        recovery."""
        if not slots:
            return
        idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        count = self._table.count.clone()
        overflow = self._table.overflow.clone()
        count[idx] = 0
        overflow[idx] = 0
        self._table = self._table._replace(count=count, overflow=overflow)

    def _admit_to_pool(self, slots: list) -> list:
        """Move slots to the pool tier and retire their primary rows;
        returns the slots the pool could not hold."""
        # already-members reappear here through the pipelined straggler
        # window (a round packed before their admission settled
        # re-applies their ops onto the retired primary row); their pool
        # state is current, so they need only the row retirement again
        fresh = [s for s in slots if s not in self._pool.row_of]
        t0 = time.perf_counter()
        failed = self._admit_with_retry(fresh) if fresh else []
        self.stats["admit_s"] += time.perf_counter() - t0
        admitted = [s for s in slots if s not in failed]
        newly = len([s for s in fresh if s not in failed])
        self.pool_admit_count += newly
        _M_POOL_ADMIT.inc(newly)
        _M_POOLED.set(len(self._pool.members))
        self.flight.record("recover-pool", admitted=newly,
                           failed=len(failed))
        self._retire_rows(admitted)
        for slot in admitted:
            self._queued[slot].clear()  # replayed from the stream
        return failed

    def _admit_with_retry(self, fresh: list) -> list:
        """Pool admission behind the ``sidecar.pool_admit`` seam: a
        transient admission fault (fired before the pool mutates
        anything) retries once; a second degrades the slots to host
        eviction, the last tier, instead of wedging the settle boundary.
        Served text is the same on every tier."""
        for _attempt in (0, 1):
            if _SITE_POOL_ADMIT.fire(slots=len(fresh)) is None:
                return self._pool.admit(fresh, self._streams)
            _M_POOL_FAULTS.labels(tier="seq", op="admit").inc()
        self.flight.record("recover-pool-admit-degraded",
                           slots=len(fresh))
        return list(fresh)

    def _evict(self, slot: int) -> None:
        """Move one document to a host-side scalar oracle replica —
        full fidelity (arbitrary props, unbounded length), off the
        device batch path."""
        # retire the device row first, and even for an already-evicted
        # doc: a pipelined round packed before the eviction settled can
        # re-apply ops onto the retired row
        self._retire_rows([slot])
        if slot in self._host:
            return
        self.evict_count += 1
        _M_EVICT.inc()
        self.flight.record("recover-evict", slot=slot)
        if self._pool is not None and slot in self._pool.row_of:
            # remove() is bookkeeping only: rebuild here, so every
            # eviction path leaves the other members' rows consistent
            self._pool.remove(slot)
            self._pool.rebuild(self._streams)
        host = MergeTreeClient(f"sidecar-host-{slot}")
        host.start_collaboration(f"sidecar-host-{slot}")
        self._host[slot] = host
        _M_HOSTED.set(len(self._host))
        if self._pool is not None:
            _M_POOLED.set(len(self._pool.members))
        self._queued[slot].clear()
        for msg in decode_stream(self._streams[slot]):
            host.apply_msg(msg)

    # ------------------------------------------------------------------
    # reads

    def _row(self, slot: int) -> dict:
        """One document's row of the table on the host (as a one-doc
        table: read it at doc 0)."""
        return fetch(SegmentTable(*(t[slot:slot + 1] for t in self._table)))

    def _read(self, slot: int) -> tuple:
        """(host table, row) holding a device-served document."""
        if self._pool is not None and slot in self._pool.row_of:
            return self._pool.fetch(), self._pool.row_of[slot]
        return self._row(slot), 0

    def text(self, document_id: str, datastore_id: str,
             channel_id: str) -> str:
        self._settle()
        slot = self._slots[(document_id, datastore_id, channel_id)]
        if slot in self._host:
            return self._host[slot].get_text()
        table, row = self._read(slot)
        return extract_text(table, self._streams[slot], row)

    def signature(self, document_id: str, datastore_id: str,
                  channel_id: str) -> tuple:
        self._settle()
        slot = self._slots[(document_id, datastore_id, channel_id)]
        if slot in self._host:
            return interned_signature(self._host[slot], self._streams[slot])
        table, row = self._read(slot)
        return extract_signature(table, self._streams[slot], row)

    def host_mode_docs(self) -> int:
        return len(self._host)

    def pooled_docs(self) -> int:
        return len(self._pool.members) if self._pool else 0

    def overflowed(self) -> bool:
        """True only if a document is CURRENTLY wrong (should never
        happen: recovery runs inside the settle boundary)."""
        self._settle()
        return bool(self._table.overflow.any())
