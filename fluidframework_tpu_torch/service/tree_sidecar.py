"""Tree serving plane: SharedTree documents served doc-parallel on the
GPU through the sidecar dispatch loop.

The merge sidecar's pipelined pack -> dispatch -> settle contract
(``gpu_sidecar.py``), for the second device-served DDS: forest state
lives on the device as SoA tensors ``[docs, slots]``
(``ops/tree_apply.py``) and every round's queued insert / remove / move
/ set changesets apply across all tracked tree documents in ONE
dispatch — the trunk-ring rebase (``ops/tree_kernel.py``), then the
forest apply on the validated executor route (``atom``, the per-row
loop, or ``macro``, the one-sort merge; both bit-identical). Both are
plain torch on the sidecar's device.

The tier policy, in order: the primary slab ladder (2x regrows that
re-apply the failed window from the pre-dispatch snapshot), then the
pooled tier (``TreeSeqPool``: a larger slab on the same device; the
per-changeset sorts do not decompose over a slot-sharded axis, so the
pool's capacity unlock is slab size), then host eviction to a scalar
``EditManager`` replica (full fidelity: nested fields, unbounded
width). Two tree-specific triggers take the same eviction path: a
device-inexpressible changeset (``encode_tree_commit`` raises
``ValueError``) and a commit whose ref predates the device trunk ring
(``ring_safe``: the ring holds the last ``TRUNK_RING`` rebased trunk
commits, and a straggler that must rebase over more is host work).

``ChannelKindRouter`` is the ingress-side routing point: the attach op
announces ``channelType``, and the router feeds sharedstring channels
to the merge sidecar and sharedtree channels to this one.

The reference's hooks ride the same loop, host-side only: the
``tree_sidecar_*`` / ``tree_pool_*`` registry families, a
``FlightRecorder(256, name="tree-sidecar")`` dumped on an overflow
recovery, the ``tree_sidecar.dispatch`` chaos site (it fires before the
round mutates anything, so a retry is exact) and ``device_trace`` around
the device half of every dispatch (``tree-sidecar:dispatch:r{n}``).
"""
from __future__ import annotations

import copy
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..convert import tree_map, tree_program_to_device
from ..models.tree.editmanager import Commit, EditManager
from ..models.tree.forest import root_signature
from ..obs import metrics as obs_metrics
from ..obs.flight_recorder import FlightRecorder
from ..obs.profiler import device_trace
from ..ops.bucket_ladder import BucketLadder
from ..ops.event_graph import validate_executor
from ..ops.tree_apply import (
    DEFAULT_ATOMS,
    TREE_EXECUTOR_ROUTES,
    TRUNK_RING,
    TreeProgram,
    TreeTable,
    apply_tree_window,
    decode_tree_row,
    encode_tree_commit,
    make_tree_table,
    pack_tree_window,
    pad_tree_capacity,
    ring_safe,
    window_extent,
)
from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.tree_payload import tree_change_from_json
from ..qos.faults import KIND_ERROR, KIND_ERROR_BURST, PLANE as _CHAOS

# Registry families, the reference's names, kinds and labels
_M_ROUNDS = obs_metrics.REGISTRY.counter(
    "tree_sidecar_rounds_total", "tree dispatch rounds flushed")
_M_COMMITS = obs_metrics.REGISTRY.counter(
    "tree_sidecar_commits_total",
    "sequenced tree changesets applied on device")
_M_GROW = obs_metrics.REGISTRY.counter(
    "tree_sidecar_grow_total", "tree capacity-ladder regrows")
_M_EVICT = obs_metrics.REGISTRY.counter(
    "tree_sidecar_evict_total",
    "tree documents evicted to host EditManager replicas")
_M_RING_EVICT = obs_metrics.REGISTRY.counter(
    "tree_sidecar_ring_evict_total",
    "tree documents evicted because a commit's ref predated the "
    "device trunk ring (ring_safe)")
_M_RECOVER = obs_metrics.REGISTRY.counter(
    "tree_sidecar_overflow_recoveries_total",
    "tree settle boundaries that found the overflow flag set")
_M_POOL_ADMIT = obs_metrics.REGISTRY.counter(
    "tree_sidecar_pool_admit_total",
    "tree documents admitted to the pooled tier")
_M_DUP_DROPS = obs_metrics.REGISTRY.counter(
    "tree_sidecar_duplicate_drops_total",
    "duplicate sequenced deliveries dropped by the per-document "
    "sequence-number guard")
_M_DISPATCH_FAULTS = obs_metrics.REGISTRY.counter(
    "tree_sidecar_dispatch_faults_total",
    "tree dispatch rounds that failed transiently before mutating "
    "anything (commits stay queued; the next apply retries exactly)")
_M_PACK_MS = obs_metrics.REGISTRY.histogram(
    "tree_sidecar_pack_ms", "host half of a tree round (encode+pack)")
_M_SETTLE_MS = obs_metrics.REGISTRY.histogram(
    "tree_sidecar_settle_ms",
    "device-wait at the tree settle boundary")
_M_TRACKED = obs_metrics.REGISTRY.gauge(
    "tree_sidecar_tracked_channels",
    "tree channels on the device batch path")
_M_HOSTED = obs_metrics.REGISTRY.gauge(
    "tree_sidecar_host_docs",
    "tree documents on host EditManager replicas")
_M_CAPACITY = obs_metrics.REGISTRY.gauge(
    "tree_sidecar_capacity",
    "current tree slab capacity (node slots/doc)")
_M_POOL_MEMBERS = obs_metrics.REGISTRY.gauge(
    "tree_pool_members", "tree documents on the pooled tier")
_M_POOL_DISPATCH = obs_metrics.REGISTRY.counter(
    "tree_pool_dispatches_total",
    "tree-pool incremental dispatches")

# chaos seam: fires BEFORE the round mutates anything (queues intact, so
# a retry is exact), the same contract as sidecar.dispatch
_SITE_DISPATCH = _CHAOS.site(
    "tree_sidecar.dispatch", (KIND_ERROR, KIND_ERROR_BURST))


def default_tree_executor() -> str:
    """The tree plane's route when the caller names none:
    ``FFTPU_TREE_EXECUTOR=atom|macro`` if set (a typo raises
    ``ValueError``: an emergency route change must never silently not
    happen), else ``"macro"``, the route the H100 runs faster end to
    end: 7176.2 / 8897.2 / 7277.7 / 6635.3 commits/s against
    ``atom``'s 5431.4 / 8053.2 / 6887.7 / 6369.3 on tree-full, both
    routes in each of four calls, with fewer device events per round
    (PERF.md, "Tree plane")."""
    env = os.environ.get("FFTPU_TREE_EXECUTOR")
    if env:
        validate_executor(env, "FFTPU_TREE_EXECUTOR",
                          routes=TREE_EXECUTOR_ROUTES)
        return env
    return "macro"


def _device(device: torch.device | str, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} needs a CUDA device; pass device='cpu' to run the "
            "plain torch version on the CPU")
    return device


class _Dispatch:
    """One packed window on the device with its host-int trip counts:
    the host computes the extent, then copies only the steps before it
    (the padded tail changes nothing), one copy per field."""

    def __init__(self, program: TreeProgram, device: torch.device):
        self.steps, self.rows = window_extent(program)
        self.program = tree_program_to_device(
            tree_map(program, lambda a: a[:self.steps]), device)

    def apply(self, table: TreeTable, route: str) -> TreeTable:
        return apply_tree_window(table, self.program, route,
                                 steps=self.steps, rows=self.rows)


class TreeSeqPool:
    """Pooled tier for tree documents that outgrow the primary slab
    ladder: a fixed-row table at a LARGER per-doc capacity on the
    sidecar's device, with host eviction the last resort. Admission
    rebuilds the pool table at the next pow2 row bucket and replays
    every member's canonical encoded-commit stream in chunked
    dispatches; incremental traffic dispatches watermarked stream
    tails at the settle boundary (exactly once by construction).
    ``mesh`` is accepted for API parity with the reference and unused:
    the pool is device-local."""

    def __init__(self, mesh, per_doc_capacity: int,
                 executor: Optional[str] = None,
                 ring: int = TRUNK_RING, atoms: int = DEFAULT_ATOMS,
                 ladder: Optional[BucketLadder] = None,
                 device: torch.device | str = "cuda"):
        validate_executor(executor, "executor",
                          routes=TREE_EXECUTOR_ROUTES)
        self.mesh = mesh
        self.capacity = per_doc_capacity
        self.executor = executor or default_tree_executor()
        self.ring = ring
        self.atoms = atoms
        self.ladder = ladder or BucketLadder()
        self.device = _device(device, "TreeSeqPool")
        self.members: list[int] = []
        self.row_of: dict[int, int] = {}
        # per-member stream watermark: encoded commits already
        # reflected by the pool table (rebuilds advance it to the
        # head, so a tail a rebuild subsumed can never dispatch again)
        self.applied_upto: dict[int, int] = {}
        self._table: Optional[TreeTable] = None
        self.dispatch_count = 0

    def _bucket(self) -> int:
        b = 1
        while b < max(1, len(self.members)):
            b *= 2
        return b

    def _apply(self, table: TreeTable, program: TreeProgram) -> TreeTable:
        return _Dispatch(program, self.device).apply(table, self.executor)

    def _replay_all(self, encoded: list[list[dict]]) -> None:
        if not self.members:
            self._table = None
            return
        rows = self._bucket()
        table = make_tree_table(rows, self.capacity, self.device,
                                ring=self.ring, atoms=self.atoms)
        chunk = BucketLadder.replay_chunk(self.capacity)
        depth = max(len(encoded[s]) for s in self.members)
        for start in range(0, max(depth, 1), chunk):
            queued = {
                row: encoded[slot][start:start + chunk]
                for row, slot in enumerate(self.members)
                if encoded[slot][start:start + chunk]
            }
            table = self._apply(table, pack_tree_window(
                rows, queued, self.ladder, bucket_floor=chunk,
                width=self.atoms))
        self._table = table
        self.applied_upto = {
            slot: len(encoded[slot]) for slot in self.members
        }
        _M_POOL_MEMBERS.set(len(self.members))

    def admit(self, slots: list, encoded: list[list[dict]]) -> list:
        """Admit sidecar slots; returns the slots that FAILED (exceed
        even pooled capacity) and were rolled back out."""
        for slot in slots:
            if slot not in self.row_of:
                self.row_of[slot] = len(self.members)
                self.members.append(slot)
        self._replay_all(encoded)
        failed = self.overflowed_slots()
        if failed:
            for slot in failed:
                self.remove(slot)
            self._replay_all(encoded)
        return failed

    def remove(self, slot: int) -> None:
        """Bookkeeping only — callers follow with rebuild() before the
        next read or dispatch."""
        if slot not in self.row_of:
            return
        row = self.row_of.pop(slot)
        self.applied_upto.pop(slot, None)
        self.members.pop(row)
        for s2, r2 in self.row_of.items():
            if r2 > row:
                self.row_of[s2] = r2 - 1

    def rebuild(self, encoded: list[list[dict]]) -> None:
        self._replay_all(encoded)

    def dispatch_pending(self, encoded: list[list[dict]]) -> list:
        """Apply every member's un-applied stream tail in one
        dispatch; returns slots that overflowed the pool."""
        if self._table is None:
            return []
        pending = {}
        upto = {}
        for slot, row in self.row_of.items():
            tail = encoded[slot][self.applied_upto.get(slot, 0):]
            if tail:
                pending[row] = tail
                upto[slot] = len(encoded[slot])
        if not pending:
            return []
        self.dispatch_count += 1
        _M_POOL_DISPATCH.inc()
        self._table = self._apply(self._table, pack_tree_window(
            self._table.docs, pending, self.ladder, width=self.atoms))
        self.applied_upto.update(upto)
        return self.overflowed_slots()

    def overflowed_slots(self) -> list:
        if self._table is None:
            return []
        flags = self._table.overflow.cpu().numpy()
        return [self.members[r]
                for r in np.nonzero(flags)[0].tolist()
                if r < len(self.members)]


class TreeSidecar:
    """Batched forest state for up to ``max_docs`` sharedtree channels.
    One tracked channel (doc slot) = one (document, datastore, channel)
    sequenced changeset stream; ``ingest`` consumes the document's
    sequenced envelope stream, ``apply`` flushes accumulated commit
    windows in a single pipelined dispatch, and ``_settle`` is the ONLY
    host<->device sync (one read of ``overflow``).

    ``executor`` picks the route (``atom`` or ``macro``; None:
    ``default_tree_executor()``). ``device`` is ``"cuda"`` unless the
    caller asks for ``"cpu"`` (the tests do); with no GPU the default
    raises instead of running on the CPU. Any non-None ``pool_mesh``
    turns the pooled tier on, built by ``gpu_sidecar.select_pool``
    (``plane="tree"``; the mesh itself is unused: the pool lives on
    ``device``); ``pool_capacity`` defaults to
    ``min(4 * max_capacity, 16384)``, the reference's rule."""

    def __init__(self, max_docs: int = 64, capacity: int = 64,
                 max_capacity: int = 4096,
                 pool_mesh=None, pool_capacity: Optional[int] = None,
                 executor: Optional[str] = None,
                 pipeline: bool = True,
                 ladder: Optional[BucketLadder] = None,
                 ring: int = TRUNK_RING,
                 width: int = DEFAULT_ATOMS,
                 device: torch.device | str = "cuda"):
        validate_executor(executor, "executor",
                          routes=TREE_EXECUTOR_ROUTES)
        self.executor = executor or default_tree_executor()
        self.device = _device(device, "TreeSidecar")
        self.max_docs = max_docs
        self.capacity = capacity
        self.max_capacity = max_capacity
        self.ring = ring
        self.width = width
        self.pipeline = pipeline
        self.ladder = ladder or BucketLadder()
        self.flight = FlightRecorder(256, name="tree-sidecar")
        self.last_flight_dump: Optional[str] = None
        if os.environ.get("FFTPU_SANITIZE") == "1":
            from ..testing import jitsan

            jitsan.install_from_env()
        self._pool: Optional[TreeSeqPool] = None
        if pool_mesh is not None:
            from .gpu_sidecar import select_pool

            self._pool = select_pool(
                pool_mesh, pool_capacity, executor=self.executor,
                max_capacity=max_capacity, plane="tree", device=self.device)
            self._pool.ring = ring
            self._pool.atoms = width
            self._pool.ladder = self.ladder
        self.pool_admit_count = 0
        self._table = make_tree_table(max_docs, capacity, self.device,
                                      ring=ring, atoms=width)
        self._slots: dict[tuple[str, str, str], int] = {}
        self._doc_slots: dict[str, list[tuple[int, str, str]]] = {}
        self._last_ingested: dict[str, int] = {}
        # per-slot canonical histories: raw scalar commits (evictions
        # replay these into the EditManager replica) and the encoded
        # device form (grow re-applies the window; the pool replays
        # the encoded stream)
        self._raw: list[list[Commit]] = []
        self._encoded: list[list[dict]] = []
        self._queued: list[list[dict]] = []
        # host payload tables per slot (node content / value dicts;
        # device tensors carry only indices into these)
        self._content_tables: list[list] = []
        self._value_tables: list[list] = []
        # host mirror of the device ring occupancy: seqs of the last
        # ``ring`` encoded commits per slot (ring_safe reads it at
        # ingest — commits queued ahead of this one will have pushed
        # the device ring by the time this one rebases)
        self._ring_hist: list[deque] = []
        self._session_ord: dict[str, int] = {}
        self._host: dict[int, EditManager] = {}
        # pipeline state: the pre-dispatch snapshot and the window it
        # predates, on the device (a grow re-applies it)
        self._prev_table: Optional[TreeTable] = None
        self._last_dispatch: Optional[_Dispatch] = None
        self._unsettled = False
        self.grow_count = 0
        self.evict_count = 0
        self.ring_evict_count = 0
        self.stats = {"pack_s": 0.0, "settle_s": 0.0, "rounds": 0}
        _M_CAPACITY.set(self.capacity)

    # ------------------------------------------------------------------
    # registration + ingest

    def track(self, document_id: str, datastore_id: str,
              channel_id: str) -> int:
        key = (document_id, datastore_id, channel_id)
        if key in self._slots:
            return self._slots[key]
        if len(self._raw) >= self.max_docs:
            raise RuntimeError("tree sidecar document capacity exhausted")
        slot = len(self._raw)
        self._slots[key] = slot
        self._doc_slots.setdefault(document_id, []).append(
            (slot, datastore_id, channel_id)
        )
        self._raw.append([])
        self._encoded.append([])
        self._queued.append([])
        self._content_tables.append([])
        self._value_tables.append([])
        self._ring_hist.append(deque(maxlen=self.ring))
        _M_TRACKED.set(len(self._raw))
        return slot

    def subscribe(self, server, document_id: str, datastore_id: str,
                  channel_id: str) -> None:
        """Attach to a server document's broadcaster (after the
        sequencer, beside the storage writer)."""
        self.track(document_id, datastore_id, channel_id)
        orderer = server.get_orderer(document_id)
        orderer.broadcaster.subscribe(
            f"tree-sidecar-{id(self)}/{document_id}/{datastore_id}/"
            f"{channel_id}",
            lambda msg: self.ingest(document_id, msg),
        )

    def _session(self, client_id: Optional[str]) -> int:
        sid = client_id or ""
        if sid not in self._session_ord:
            self._session_ord[sid] = len(self._session_ord) + 1
        return self._session_ord[sid]

    def ingest(self, document_id: str, msg: SequencedMessage) -> None:
        """Consume one sequenced message of a document. Only
        ``{"type": "tree"}`` channel ops for tracked channels carry
        forest state; everything else (joins, other channels,
        tree-schema ops) has no device effect.

        A message at/below the document's last ingested sequence number
        is a duplicate delivery and is dropped (at-least-once
        upstream)."""
        last = self._last_ingested.get(document_id, 0)
        if msg.sequence_number <= last:
            _M_DUP_DROPS.inc()
            return
        self._last_ingested[document_id] = msg.sequence_number
        envelope = msg.contents if isinstance(msg.contents, dict) else {}
        for slot, ds_id, ch_id in self._doc_slots.get(document_id, ()):
            if not (
                msg.type == MessageType.OPERATION
                and envelope.get("kind", "op") == "op"
                and envelope.get("address") == ds_id
                and envelope.get("channel") == ch_id
            ):
                continue
            changes = tree_change_from_json(envelope.get("contents"))
            if changes is None:
                continue  # tree-schema etc: no forest effect
            self._ingest_commit(slot, Commit(
                session_id=msg.client_id or "",
                seq=msg.sequence_number,
                ref_seq=msg.reference_sequence_number,
                changes=copy.deepcopy(changes),
            ))

    def _ingest_commit(self, slot: int, commit: Commit) -> None:
        if slot in self._host:
            self._host[slot].add_sequenced_change(commit, False)
            return
        if not ring_safe(list(self._ring_hist[slot]), commit.ref_seq,
                         self.ring):
            # the commit must rebase over more trunk commits than the
            # device ring retains: host work by design
            self.ring_evict_count += 1
            _M_RING_EVICT.inc()
            self._evict_at_ingest(slot, commit)
            return
        try:
            if set(commit.changes) - {"root"}:
                raise ValueError("non-root tree fields: host path only")
            enc = encode_tree_commit(
                commit.changes.get("root", []),
                self._content_tables[slot], self._value_tables[slot],
                seq=commit.seq, ref=commit.ref_seq,
                session=self._session(commit.session_id),
                width=self.width,
            )
        except ValueError:
            # device-inexpressible (nested fields, width overflow,
            # repair-store marks): the full-fidelity host replica
            # takes over
            self._evict_at_ingest(slot, commit)
            return
        self._raw[slot].append(commit)
        self._encoded[slot].append(enc)
        self._queued[slot].append(enc)
        self._ring_hist[slot].append(commit.seq)

    def _evict_at_ingest(self, slot: int, commit: Commit) -> None:
        self._settle()
        self._evict(slot)
        self._host[slot].add_sequenced_change(commit, False)

    # ------------------------------------------------------------------
    # device application (the dispatch pipeline)

    @property
    def queued_commits(self) -> int:
        return sum(len(q) for q in self._queued)

    def apply(self) -> int:
        """Flush all queued commit windows in one batched dispatch;
        returns the number of commits dispatched. Returns at enqueue:
        this round's overflow flag is read at the next apply or read,
        inside ``_settle`` — or before returning when ``pipeline`` is
        off."""
        if self.queued_commits == 0:
            return 0
        real = self._dispatch()
        if not self.pipeline:
            self._settle()
        return real

    def sync(self) -> None:
        """Barrier: settle the in-flight round (overflow recovery,
        pool dispatch)."""
        self._settle()

    def prewarm(self, max_bucket: Optional[int] = None) -> float:
        """Nothing to compile in the port (the device half is eager
        torch); kept for the reference's surface. Returns the seconds
        spent."""
        return 0.0

    def _apply_dispatch(self, table: TreeTable,
                        dispatch: _Dispatch) -> TreeTable:
        """Device half of one dispatch, on a program already on the
        device. Enqueues work only: nothing here waits for the
        device."""
        return dispatch.apply(table, self.executor)

    def _dispatch(self) -> int:
        # chaos seam BEFORE any mutation: queues intact, a retry is
        # exactly the same round
        fault = _SITE_DISPATCH.fire(queued=self.queued_commits)
        if fault is not None:
            _M_DISPATCH_FAULTS.inc()
            raise _SITE_DISPATCH.transient(fault)
        t0 = time.perf_counter()
        packed: dict[int, list[dict]] = {}
        pool_commits = 0
        for slot, q in enumerate(self._queued):
            if not q:
                continue
            if self._pool is not None and slot in self._pool.row_of:
                # pooled docs dispatch from their watermarked encoded
                # streams at the settle boundary
                pool_commits += len(q)
                continue
            packed[slot] = list(q)
        dispatch = _Dispatch(pack_tree_window(
            self.max_docs, packed, self.ladder, width=self.width),
            self.device)
        real = sum(len(v) for v in packed.values())
        for q in self._queued:
            q.clear()
        pack_s = time.perf_counter() - t0
        self.stats["pack_s"] += pack_s
        self.stats["rounds"] += 1
        _M_ROUNDS.inc()
        _M_COMMITS.inc(real + pool_commits)
        _M_PACK_MS.observe(pack_s * 1000.0)
        self.flight.record(
            "dispatch", round=self.stats["rounds"], commits=real,
            pool_commits=pool_commits, pack_ms=round(pack_s * 1000.0, 3),
            capacity=self.capacity,
        )
        # SYNC BOUNDARY — read the previous round's overflow flag
        # before its snapshot is retired below
        self._settle()
        self._prev_table = self._table
        self._last_dispatch = dispatch
        self._unsettled = True
        with device_trace(f"tree-sidecar:dispatch:r{self.stats['rounds']}",
                          self.device):
            self._table = self._apply_dispatch(self._prev_table,
                                               self._last_dispatch)
        return real + pool_commits

    def _settle(self) -> None:
        """The host<->device sync boundary: read the in-flight round's
        overflow flags, run recovery if one is set, flush the pool
        dispatch. Reads and the next dispatch both funnel through
        here."""
        if not self._unsettled:
            return
        self._unsettled = False
        t0 = time.perf_counter()
        overflowed = bool(self._table.overflow.any())
        settle_s = time.perf_counter() - t0
        self.stats["settle_s"] += settle_s
        _M_SETTLE_MS.observe(settle_s * 1000.0)
        self.flight.record("settle", settle_ms=round(settle_s * 1000.0, 3),
                           overflow=overflowed)
        if overflowed:
            _M_RECOVER.inc()
            self.last_flight_dump = self.flight.dump_to(
                reason="tree _settle found the overflow flag set "
                       "(recovery running)")
            self._recover()
        self._prev_table = None
        self._last_dispatch = None
        if self._pool is not None and self._pool.members:
            # the pool advances only when a flush was in flight
            for slot in self._pool.dispatch_pending(self._encoded):
                self._evict(slot)  # beyond even pooled capacity

    # ------------------------------------------------------------------
    # overflow recovery: grow ladder -> pooled tier -> host eviction

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
        pre-dispatch snapshot and re-apply the SAME window, still on
        the device, at the new capacity — exact, because a parked doc's
        state, ring and overflow flag all predate the window (the park
        contract)."""
        self.grow_count += 1
        _M_GROW.inc()
        self.capacity = new_capacity
        _M_CAPACITY.set(new_capacity)
        self.flight.record("recover-grow", capacity=new_capacity)
        self._prev_table = pad_tree_capacity(self._prev_table, new_capacity)
        self._table = self._apply_dispatch(self._prev_table,
                                           self._last_dispatch)

    def _retire_rows(self, slots: list) -> None:
        """Zero the primary table's count/overflow of ``slots`` on the
        device: reads route elsewhere for these docs, and a stale
        overflow flag would re-trigger recovery."""
        if not slots:
            return
        idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        self._table = self._table._replace(
            count=self._table.count.index_fill(0, idx, 0),
            overflow=self._table.overflow.index_fill(0, idx, 0),
        )

    def _admit_to_pool(self, slots: list) -> list:
        """Move slots to the pooled tier; retire their primary rows.
        Returns slots the pool could not hold. Already-members can
        reappear via a pipelined straggler window: they need only the
        row retirement again."""
        fresh = [s for s in slots if s not in self._pool.row_of]
        failed = self._pool.admit(fresh, self._encoded) if fresh else []
        admitted = [s for s in slots if s not in failed]
        newly = len([s for s in fresh if s not in failed])
        self.pool_admit_count += newly
        _M_POOL_ADMIT.inc(newly)
        self.flight.record("recover-pool", admitted=newly,
                           failed=len(failed))
        self._retire_rows(admitted)
        for slot in admitted:
            self._queued[slot].clear()  # replayed from the stream
        return failed

    def _evict(self, slot: int) -> None:
        """Move one document to a host-side scalar EditManager replica —
        full fidelity, off the device batch path."""
        # retire device state FIRST, even for an already-evicted doc
        # (a pipelined straggler round can re-flag a retired row)
        self._retire_rows([slot])
        if slot in self._host:
            return
        self.evict_count += 1
        _M_EVICT.inc()
        self.flight.record("recover-evict", slot=slot)
        if self._pool is not None and slot in self._pool.row_of:
            self._pool.remove(slot)
            self._pool.rebuild(self._encoded)
        replica = EditManager(session_id=f"tree-host-{slot}")
        for commit in self._raw[slot]:
            replica.add_sequenced_change(
                Commit(commit.session_id, commit.seq, commit.ref_seq,
                       copy.deepcopy(commit.changes)),
                False,
            )
        self._host[slot] = replica
        _M_HOSTED.set(len(self._host))
        if self._pool is not None:
            _M_POOL_MEMBERS.set(len(self._pool.members))
        self._queued[slot].clear()

    # ------------------------------------------------------------------
    # reads

    def _slot(self, document_id: str, datastore_id: str,
              channel_id: str) -> int:
        return self._slots[(document_id, datastore_id, channel_id)]

    def nodes(self, document_id: str, datastore_id: str,
              channel_id: str) -> list:
        """The served root-field node list (every tier); copies only the
        document's own row to the host."""
        self._settle()
        slot = self._slot(document_id, datastore_id, channel_id)
        if slot in self._host:
            content = self._host[slot].forest().content()
            return copy.deepcopy(content.get("root", []))
        if self._pool is not None and slot in self._pool.row_of:
            table, row = self._pool._table, self._pool.row_of[slot]
        else:
            table, row = self._table, slot
        count = int(table.count[row])
        return decode_tree_row(
            table.content[row, :count].cpu().numpy(),
            table.value[row, :count].cpu().numpy(), count,
            self._content_tables[slot], self._value_tables[slot],
        )

    def signature(self, document_id: str, datastore_id: str,
                  channel_id: str) -> str:
        """Canonical forest signature (sorted-key JSON over the served
        root field)."""
        return root_signature(
            self.nodes(document_id, datastore_id, channel_id))

    def host_mode_docs(self) -> int:
        return len(self._host)

    def pooled_docs(self) -> int:
        return len(self._pool.members) if self._pool else 0

    def overflowed(self) -> bool:
        """True only if a document is CURRENTLY wrong (should never
        happen: recovery runs inside the settle boundary)."""
        self._settle()
        return bool(self._table.overflow.any())


class ChannelKindRouter:
    """Ingress-side channel-kind routing: subscribe once per document,
    watch the sequenced stream for attach ops, and feed each announced
    channel's stream to the sidecar serving its kind — ``sharedstring``
    to the merge sidecar (``GpuMergeSidecar``), ``sharedtree`` to the
    tree sidecar. Channels of other kinds stay unrouted."""

    KINDS = {"sharedstring": "merge", "sharedtree": "tree"}

    def __init__(self, merge=None, tree=None):
        self.merge = merge
        self.tree = tree
        # (document, datastore, channel) -> sidecar already routed
        self._routed: dict[tuple[str, str, str], object] = {}

    def subscribe(self, server, document_id: str) -> None:
        orderer = server.get_orderer(document_id)
        orderer.broadcaster.subscribe(
            f"kind-router-{id(self)}/{document_id}",
            lambda msg: self.route(document_id, msg),
        )

    def _sidecar_for(self, channel_type: str):
        plane = self.KINDS.get(channel_type)
        return self.merge if plane == "merge" else \
            self.tree if plane == "tree" else None

    def route(self, document_id: str, msg: SequencedMessage) -> None:
        envelope = msg.contents if isinstance(msg.contents, dict) else {}
        if (
            msg.type == MessageType.OPERATION
            and envelope.get("kind") == "attach"
            and isinstance(envelope.get("contents"), dict)
        ):
            sidecar = self._sidecar_for(
                envelope["contents"].get("channelType"))
            ds, ch = envelope.get("address"), envelope.get("channel")
            key = (document_id, ds, ch)
            if sidecar is not None and key not in self._routed:
                sidecar.track(document_id, ds, ch)
                self._routed[key] = sidecar
        # forward to every sidecar serving a channel of this document
        # (each sidecar's own ingest filters by address/channel and
        # runs the per-document dedupe guard)
        seen = []
        for (doc, _ds, _ch), sidecar in self._routed.items():
            if doc == document_id and sidecar not in seen:
                seen.append(sidecar)
                sidecar.ingest(document_id, msg)
