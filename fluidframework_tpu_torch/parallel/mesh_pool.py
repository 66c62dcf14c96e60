"""Doc-sharded document pool: one logical pool across the mesh's doc
shards (B7, the mesh half).

The reference's service plane scales by partitioning documents across
workers; here the DOC axis of the pooled segment table is split over the
mesh, so pool capacity grows with the shard count. This complements the
sequence-sharded pool (``service/gpu_sidecar.SeqShardedPool``): that one
splits one long document's slot axis; this one spreads many pooled
documents over shards. ``select_pool`` in the sidecar is the one
route-selection point between them.

- ONE logical table of ``n_shards * rows_per_shard`` rows: shard ``s``
  holds the global rows ``[s * R, (s + 1) * R)`` on its own device
  (``ShardedTable``).
- A dispatch is one ``apply_window`` per shard (on CUDA, one launch of
  the Hopper window kernel per shard). Documents are independent lanes,
  so it needs no collectives and equals the one-shard pool exactly.
- Admissions land on the least-occupied shard; the shared pow2 row
  bucket grows only when a shard outgrows it.
- Per-member STREAM WATERMARKS (``applied_upto``) make incremental
  dispatch exactly-once across rebuilds, deferred dispatches and
  migrations: the same contract and field names as ``SeqShardedPool``,
  so the sidecar drives either tier through one interface.
- A heat ledger (per-member EWMA of dispatched real ops) drives LIVE
  MIGRATION of hot documents between shards, only at the settle
  boundary (``dispatch_pending`` runs inside the sidecar's ``_settle``),
  only after the round's tails are applied, and only when no overflow is
  pending (recovery first). A migration is a row-permutation gather
  (``ops/shard_moves.migrate_rows``) that consumes the pre-move table:
  with every watermark at its stream head and nothing in flight, moving
  a row commutes with the op order.
- The reference's observability and chaos hooks at the same points: the
  ``mesh_pool_*`` / ``pool_faults_total`` families, the
  ``sidecar.pool_dispatch`` and ``sidecar.pool_migrate`` sites (a
  deferred dispatch leaves the tails past the watermark for the next
  settle, a deferred migration skips one move: both exact by
  construction), the ``pool:migrate`` hop on ``migration_traces`` and
  an optional ``FleetTimeline`` (``timeline=``) that records each
  migration.

Rows not owned by a member are GARBAGE (a migration's vacated row keeps
a stale copy): count / overflow / text are read only through ``row_of``,
and every rebuild replaces the table.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from ..convert import batch_from_numpy, program_to_device, \
    sharded_table_to_numpy
from ..obs import metrics as obs_metrics
from ..obs.heat import HeatLedger
from ..obs.trace import stamp as _trace_stamp
from ..ops.bucket_ladder import BucketLadder
from ..ops.event_graph import validate_executor
from ..ops.host_bridge import coalesce_noops, pack_rows, replay_chunked
from ..ops.merge_chunk import (
    CHUNK_K,
    apply_window_chunked,
    compile_chunks,
    macro_steps,
)
from ..ops.merge_kernel import apply_window, compact
from ..ops.segment_table import (
    KIND_NOOP,
    OPOFF_BOUND,
    OpBatch,
    ShardedTable,
    make_table,
)
from ..ops.shard_moves import migrate_rows
from ..qos.faults import KIND_DEFER, PLANE as _CHAOS
from .mesh import DOC_AXIS, DeviceMesh, doc_devices

# the migration heat's EWMA decay per dispatching settle (the
# reference's default)
HEAT_DECAY = 0.5

# chaos seams, shared by NAME with the seq tier (gpu_sidecar registers
# the same sites)
_SITE_POOL_DISPATCH = _CHAOS.site("sidecar.pool_dispatch", (KIND_DEFER,))
_SITE_POOL_MIGRATE = _CHAOS.site("sidecar.pool_migrate", (KIND_DEFER,))

# Registry families, the reference's (process aggregates across every
# pool; exact per-instance counts stay on the pool). Everything bumped
# from dispatch_pending is host-side only: it runs inside the sidecar's
# _settle boundary.
_M_MEMBERS = obs_metrics.REGISTRY.gauge(
    "mesh_pool_members", "pooled documents per shard",
    labelnames=("shard",))
_M_WATERMARK = obs_metrics.REGISTRY.gauge(
    "mesh_pool_watermark_ops", "sum of member stream watermarks")
_M_DISPATCH = obs_metrics.REGISTRY.counter(
    "mesh_pool_dispatches_total", "incremental mesh-pool dispatches")
_M_DEPTH = obs_metrics.REGISTRY.gauge(
    "mesh_pool_dispatch_depth", "ops in the last mesh-pool dispatch")
_M_MIGRATIONS = obs_metrics.REGISTRY.counter(
    "mesh_pool_migrations_total",
    "hot documents moved between shards at settle boundaries")
_M_IMBALANCE = obs_metrics.REGISTRY.gauge(
    "mesh_pool_shard_imbalance",
    "hottest-shard heat over mean shard heat (1.0 = balanced)")
_M_POOL_FAULTS = obs_metrics.REGISTRY.counter(
    "pool_faults_total",
    "pool operations deferred or retried under a transient fault "
    "(shared by NAME across the seq and mesh tiers, like the "
    "sidecar.pool_* chaos sites)", labelnames=("tier", "op"))
_M_ROUTE_FALLBACK = obs_metrics.REGISTRY.counter(
    "mesh_pool_route_fallback_total",
    "chunked-route requests served by the scan window body on a "
    "multi-shard mesh")


def apply_window_mesh_sharded(table: ShardedTable, batch,
                              mesh: DeviceMesh,
                              doc_axis: str = DOC_AXIS) -> ShardedTable:
    """Apply a [docs, window] op batch (an ``OpBatch`` or a dict of its
    fields, numpy or torch) to a doc-sharded table: shard ``s`` applies
    its own rows of the batch on its own device. Capacity is per-shard
    local, so the op_off bound is the single-device one."""
    n = mesh.shape[doc_axis]
    if len(table.shards) != n:
        raise ValueError(
            f"a {len(table.shards)}-shard table on a doc axis of {n}")
    if table.capacity * OPOFF_BOUND >= 2**31:
        raise ValueError(
            f"capacity {table.capacity} overflows the op_off composite")
    if isinstance(batch, tuple):
        batch = batch._asdict()
    R = table.rows_per_shard
    return ShardedTable([
        apply_window(shard, batch_from_numpy(
            {f: batch[f][s * R:(s + 1) * R] for f in OpBatch._fields},
            shard.device))
        for s, shard in enumerate(table.shards)])


def _compact(table: ShardedTable) -> ShardedTable:
    return ShardedTable([compact(t) for t in table.shards])


class MeshShardedPool:
    """Doc-sharded pool tier: documents that outgrow the primary slab
    ladder spread across the mesh's doc shards and stay on the device
    (host eviction stays the last resort, for documents past even the
    pooled per-doc capacity).

    Drives through the same interface as ``SeqShardedPool`` (admit /
    remove / rebuild / dispatch_pending / prewarm / overflowed_slots /
    fetch, plus ``row_of`` / ``applied_upto`` / ``members``)."""

    def __init__(self, mesh: DeviceMesh, per_doc_capacity: int,
                 executor: Optional[str] = None,
                 doc_axis: str = DOC_AXIS,
                 timeline=None):
        if doc_axis not in mesh.axis_names:
            raise ValueError(
                f"mesh pool needs a {doc_axis!r} mesh axis "
                f"(got {mesh.axis_names})")
        for axis in mesh.axis_names:
            if axis != doc_axis and mesh.shape[axis] != 1:
                raise ValueError(
                    f"mesh pool shards documents only: axis {axis!r} has "
                    f"size {mesh.shape[axis]} (slot-axis sharding is "
                    "SeqShardedPool's job)")
        if per_doc_capacity < 16 or \
                per_doc_capacity * OPOFF_BOUND >= 2**31:
            raise ValueError(
                f"pool capacity {per_doc_capacity} invalid (needs >= 16 "
                "and * OPOFF_BOUND to fit int32)")
        self.mesh = mesh
        self.doc_axis = doc_axis
        self.devices = doc_devices(mesh, doc_axis)
        self.n_shards = mesh.shape[doc_axis]
        self.capacity = per_doc_capacity
        # the chunked / egwalker macro-steps follow the executor route on
        # a one-shard mesh (an egwalker pool routes CHUNKED: pool
        # dispatches are full-history replays, where the critical-prefix
        # fast path buys nothing); a multi-shard mesh uses the window
        # apply per shard and says so once (_warn_route_once). None (a
        # direct construction) means scan; select_pool resolves the
        # sidecar's default route before constructing this pool.
        validate_executor(executor, "executor")
        self.executor = executor or "scan"
        self._route_warned = False
        # shard_members[s][r] = sidecar slot at local row r of shard s;
        # global row = s * rows_per_shard + r
        self.shard_members: list[list[int]] = [
            [] for _ in range(self.n_shards)]
        self.rows_per_shard = 1
        self.row_of: dict[int, int] = {}   # slot -> global row
        # per-member STREAM WATERMARK (see SeqShardedPool): a rebuild
        # advances every watermark to the stream head, so ops it
        # subsumed can never dispatch again
        self.applied_upto: dict[int, int] = {}
        # per-member heat: EWMA of dispatched real ops, decayed at every
        # dispatching settle; the cap must exceed any member population
        # (an eviction here would zero a live member's heat)
        self.heat = HeatLedger(max_keys=1 << 16, decay=HEAT_DECAY)
        self._table: Optional[ShardedTable] = None
        self.dispatch_count = 0
        self.last_dispatch_depth = 0
        self.migration_count = 0
        # a migration is a settle-boundary EVENT, not a per-op hop: each
        # stamps pool:migrate on the pool's own bounded trace list and,
        # when a FleetTimeline is attached, records a "migration" there
        self.timeline = timeline
        self.migration_traces: list = []

    # -- bookkeeping ---------------------------------------------------

    @property
    def members(self) -> list:
        """Slots in shard-then-row order (len() = pooled docs)."""
        return [s for shard in self.shard_members for s in shard]

    def _reindex(self, rows: Optional[int] = None) -> None:
        """Recompute ``row_of`` (and the pow2 row bucket, unless ``rows``
        pins it: a migration must not shrink the bucket under the live
        table)."""
        need = max((len(m) for m in self.shard_members), default=0)
        if rows is None:
            rows = 1
            while rows < need:
                rows *= 2
        assert rows >= max(need, 1)
        self.rows_per_shard = rows
        self.row_of = {}
        for shard, members in enumerate(self.shard_members):
            for r, slot in enumerate(members):
                self.row_of[slot] = shard * rows + r

    def _set_member_gauges(self) -> None:
        for shard, members in enumerate(self.shard_members):
            _M_MEMBERS.labels(shard=str(shard)).set(len(members))

    def _fresh_table(self) -> ShardedTable:
        return ShardedTable([make_table(self.rows_per_shard, self.capacity,
                                        dev) for dev in self.devices])

    # -- dispatch ------------------------------------------------------

    def _warn_route_once(self) -> None:
        if self._route_warned:
            return
        self._route_warned = True
        _M_ROUTE_FALLBACK.inc()
        print(
            f"fftpu: MeshShardedPool: the {self.executor} macro-step does "
            "not ride the doc-sharded dispatch; using the scan window "
            f"body on this {self.n_shards}-shard mesh",
            file=sys.stderr, flush=True)

    def _apply(self, table: ShardedTable, arrays: dict) -> ShardedTable:
        if self.executor in ("chunked", "egwalker") and self.n_shards == 1:
            program = compile_chunks(arrays, k_max=CHUNK_K)
            steps = macro_steps(program["chunk_start"], CHUNK_K)
            shard = table.shards[0]
            out = ShardedTable([apply_window_chunked(
                shard, program_to_device(program, shard.device),
                K=CHUNK_K, steps=steps)])
        else:
            if self.executor in ("chunked", "egwalker"):
                self._warn_route_once()
            out = apply_window_mesh_sharded(table, arrays, self.mesh,
                                            self.doc_axis)
        # compact after every pool dispatch: remove-heavy histories
        # otherwise accumulate dead segments until they overflow a pool
        # that could easily hold the live text
        return _compact(out)

    def _replay_all(self, streams) -> None:
        """Rebuild the pool table and re-replay every member's canonical
        stream in chunked sharded dispatches (the seq pool's recipe)."""
        self._reindex()
        if not self.row_of:
            self._table = None
            self.applied_upto = {}
            self._set_member_gauges()
            _M_WATERMARK.set(0)
            return
        self._table = replay_chunked(
            self._apply, self._fresh_table(),
            {row: streams[slot].ops for slot, row in self.row_of.items()},
            chunk=BucketLadder.replay_chunk(self.capacity),
        )
        self.applied_upto = {
            slot: len(streams[slot].ops) for slot in self.row_of}
        self._set_member_gauges()
        _M_WATERMARK.set(sum(self.applied_upto.values()))

    def admit(self, slots: list, streams) -> list:
        """Admit sidecar slots onto the least-occupied shards; returns the
        slots that FAILED (past even the pooled capacity) and were rolled
        back out."""
        for slot in slots:
            if slot not in self.row_of:
                shard = min(range(self.n_shards),
                            key=lambda i: (len(self.shard_members[i]), i))
                self.shard_members[shard].append(slot)
                self._reindex()
        self._replay_all(streams)
        failed = self.overflowed_slots()
        if failed:
            for slot in failed:
                self.remove(slot)
            self._replay_all(streams)
        return failed

    def remove(self, slot: int) -> None:
        """Bookkeeping only: the table still holds the removed row's data
        at the OLD indices. Callers MUST follow with rebuild() before the
        next read or dispatch."""
        for members in self.shard_members:
            if slot in members:
                members.remove(slot)
                break
        else:
            return
        self.applied_upto.pop(slot, None)
        self.heat.pop(slot)
        self._reindex()

    def rebuild(self, streams) -> None:
        self._replay_all(streams)

    def dispatch_pending(self, streams) -> list:
        """Apply every member's un-applied canonical-stream tail (past its
        watermark) in ONE sharded dispatch; returns the slots that
        overflowed the pool. After a clean dispatch the heat ledger may
        migrate one hot document (``_maybe_migrate``)."""
        if self._table is None:
            return []
        if _SITE_POOL_DISPATCH.fire(tier="mesh") is not None:
            # deferred: tails stay past the watermark and apply whole at
            # the next settle — exactly once by construction (the heat
            # waits too: a lagging dispatch must not decay it)
            _M_POOL_FAULTS.labels(tier="mesh", op="dispatch").inc()
            return []
        pending, depths, upto = {}, {}, {}
        for slot, row in self.row_of.items():
            tail = streams[slot].ops[self.applied_upto.get(slot, 0):]
            if tail:
                pending[row] = coalesce_noops(tail)
                # heat counts REAL ops only: every sequenced message fans
                # a noop into every other subscribed doc's stream, which
                # would wash out the hot-spot signal
                depths[slot] = sum(
                    1 for op in tail if op["kind"] != KIND_NOOP)
                upto[slot] = len(streams[slot].ops)
        if not pending:
            return []
        self.heat.ewma_tick(self.row_of, depths)
        depth = sum(len(ops) for ops in pending.values())
        self.dispatch_count += 1
        self.last_dispatch_depth = depth
        _M_DISPATCH.inc()
        _M_DEPTH.set(depth)
        self._table = self._apply(self._table,
                                  pack_rows(self._table.docs, pending))
        self.applied_upto.update(upto)
        _M_WATERMARK.set(sum(self.applied_upto.values()))
        overflowed = self.overflowed_slots()
        if not overflowed:
            # migration only on a clean settle: an overflow hands control
            # to the sidecar's recovery (evict + rebuild) first, so a
            # move never races a recovery rebuild within one settle
            self._maybe_migrate()
        return overflowed

    # -- migration -----------------------------------------------------

    def shard_loads(self) -> list:
        """Per-shard heat totals (what the migration policy reads)."""
        return [sum(self.heat.get(s, 0.0) for s in members)
                for members in self.shard_members]

    def _maybe_migrate(self) -> None:
        """Move at most ONE document from the hottest shard to the
        coldest, choosing the member whose move minimizes the resulting
        hottest-shard load (so a viral doc's co-residents move away from
        it when moving the viral doc itself would just relocate the hot
        spot). Deterministic: ties break on shard index, then slot."""
        if self.n_shards < 2 or self._table is None:
            return
        if _SITE_POOL_MIGRATE.fire() is not None:
            # deferred: migration is opportunistic — the heat persists,
            # so a hot shard offers the same move at the next settle
            _M_POOL_FAULTS.labels(tier="mesh", op="migrate").inc()
            return
        loads = self.shard_loads()
        hot = max(range(self.n_shards), key=lambda i: (loads[i], -i))
        mean = sum(loads) / self.n_shards
        _M_IMBALANCE.set(loads[hot] / mean if mean > 0 else 1.0)
        if len(self.shard_members[hot]) < 2:
            return
        # coldest shard with a free local row (a full shard cannot
        # receive without a row-bucket rebuild)
        open_shards = [
            i for i in range(self.n_shards)
            if i != hot and len(self.shard_members[i]) < self.rows_per_shard
        ]
        if not open_shards:
            return
        cold = min(open_shards, key=lambda i: (loads[i], i))
        best, best_peak = None, loads[hot]
        for slot in sorted(self.shard_members[hot],
                           key=lambda s: (-self.heat.get(s, 0.0), s)):
            h = self.heat.get(slot, 0.0)
            if h <= 0.0:
                continue
            peak = max(loads[hot] - h, loads[cold] + h)
            if peak < best_peak - 1e-12:
                best, best_peak = slot, peak
        if best is not None:  # else no move lowers the hottest shard
            self._move(best, hot, cold)

    def _move(self, slot: int, src: int, dst: int) -> None:
        old_rows = dict(self.row_of)
        self.shard_members[src].remove(slot)
        self.shard_members[dst].append(slot)
        # row bucket PINNED: the destination had a free local row, and
        # shrinking the bucket would desync row_of from the table
        self._reindex(rows=self.rows_per_shard)
        perm = np.arange(self._table.docs, dtype=np.int64)
        for s, new_row in self.row_of.items():
            perm[new_row] = old_rows[s]
        # op-ordered handoff: every watermark is at its stream head and
        # nothing is in flight, so the permutation commutes with the op
        # order; the pre-move table is consumed
        self._table = migrate_rows(self._table, perm)
        self.migration_count += 1
        _M_MIGRATIONS.inc()
        _trace_stamp(self.migration_traces, "pool", "migrate")
        del self.migration_traces[:-64]  # bounded, newest kept
        if self.timeline is not None:
            self.timeline.record("migration", node=f"shard-{src}",
                                 slot=slot, src=src, dst=dst)
        self._set_member_gauges()

    # -- prewarm + reads -------------------------------------------------

    def prewarm(self) -> float:
        """Build the window kernel the pool's CUDA shards launch (nothing
        to do on the CPU); returns the seconds it took."""
        if self.mesh.device_type != "cuda":
            return 0.0
        from ..ops.cuda_merge import prewarm

        return prewarm()

    def overflowed_slots(self) -> list:
        if self._table is None:
            return []
        flags = np.concatenate([t.overflow.cpu().numpy()
                                for t in self._table.shards])
        # non-member rows are garbage (vacated by migrations, padding up
        # to the row bucket): only member rows are read
        return [slot for slot, row in sorted(self.row_of.items(),
                                             key=lambda kv: kv[1])
                if flags[row]]

    def fetch(self) -> dict:
        return sharded_table_to_numpy(self._table)
