"""Sequence-axis sharding: one long document's slot slab split across
shards (B7, the seq half).

Each shard holds a contiguous block of slots, and the merge step's
slot-axis-global operations become collectives among the shards:

- exclusive prefix sum -> local cumsum plus the gathered shard totals
  (the collective form of PartialSequenceLengths);
- first-true / masked-min lookups -> local min, then min across shards;
- point lookups and the visible total -> local sum, then sum across;
- the restructure shift -> the left neighbour's last k slots.

``fused_step`` itself is unchanged: the collectives come in through its
``AxisPrims`` seam, so the sharded window equals the unsharded one on
live slots, ``count``, ``min_seq`` and ``overflow`` by construction.

The reference runs this as one SPMD program (``shard_map`` under
``jit``). The port runs it as SPMD in threads of one process: one thread
per shard runs the unchanged window loop over its slot block, and every
collective is a barrier among the lane's shards (``ShardGroup``): a
shard writes its value into its slot, waits until every shard has
written, then reads the others' values, each moved to its own device
with ``.to``. The result does not depend on thread timing. A wait has a
timeout, and an exception in any shard aborts the group; both are raised
in the caller, so a shard that fails never leaves the others waiting or
a partial table behind.

Shard threads use each device's current stream. Same-device shards
share it, so their cross-shard reads are ordered by launch order (the
shards of a lane launch in turn); on distinct cards ``.to`` orders the
two streams.

The mesh may be 2-D (docs, seq): collectives reduce only over the seq
axis, and doc lanes stay independent.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..convert import batch_from_numpy
from ..ops.merge_kernel import apply_window
from ..ops.merge_step import (
    DOC_FIELDS,
    SLOT_FIELDS,
    AxisPrims,
    fused_step,
    state_to_table,
    table_to_state,
)
from ..ops.segment_table import OPOFF_BOUND, OpBatch, SegmentTable
from .mesh import DOC_AXIS, DeviceMesh, local_devices

SEQ_AXIS = "seq"

# seconds a shard waits at a collective for the others
BARRIER_TIMEOUT_S = 120.0


def make_seq_mesh(devices: Optional[Sequence] = None, doc_shards: int = 1,
                  doc_axis: str = DOC_AXIS) -> DeviceMesh:
    """A (docs, seq) mesh: ``doc_shards`` independent document lanes, the
    remaining devices splitting each document's slot axis (default:
    every local CUDA device)."""
    devices = list(devices) if devices is not None else local_devices()
    n = len(devices)
    if n % doc_shards:
        raise ValueError(f"{n} devices not divisible by {doc_shards}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return DeviceMesh(grid.reshape(doc_shards, n // doc_shards),
                      (doc_axis, SEQ_AXIS))


class ShardAborted(RuntimeError):
    """Raised in a shard whose group was aborted by another shard."""


class ShardGroup:
    """The collectives' meeting point for the ``n`` shards of one doc
    lane: ``exchange`` hands every shard the values all ``n`` wrote.

    The shards take turns in rank order (a token ring): a shard runs from
    one collective to the next, writes its value, hands the turn to the
    next shard and waits for its own turn again. When the turn comes
    back, every shard has written, so the collective is complete: the
    barrier of the reference's SPMD program, with at most one shard
    running Python at a time (shards that all wake at one barrier
    contend for the interpreter lock, and the losers wait out its
    switch interval). Slots alternate between two buffers: a shard
    writes collective k + 1 only after every shard has read k."""

    def __init__(self, n: int, timeout: float = BARRIER_TIMEOUT_S):
        self.n = n
        self.timeout = timeout
        self._turn = [threading.Event() for _ in range(n)]
        self._turn[0].set()
        self._slots = [[None] * n, [None] * n]
        # per-shard collective counter; shard r only touches entry r
        self._round = [0] * n
        self._aborted = False

    def wait_turn(self, rank: int) -> None:
        if not self._turn[rank].wait(self.timeout):
            self.abort()
            raise TimeoutError(
                f"sequence shard {rank} waited {self.timeout} s for a "
                "collective")
        self._turn[rank].clear()
        if self._aborted:
            raise ShardAborted(f"sequence shard {rank}: group aborted")

    def pass_turn(self, rank: int) -> None:
        self._turn[(rank + 1) % self.n].set()

    def exchange(self, rank: int, value: torch.Tensor) -> list:
        """Write this shard's value, wait for every shard's, and return
        all ``n`` in shard order (as written: on the writers' devices)."""
        k = self._round[rank]
        self._round[rank] = k + 1
        slots = self._slots[k % 2]
        slots[rank] = value
        self.pass_turn(rank)
        self.wait_turn(rank)
        return list(slots)

    def abort(self) -> None:
        self._aborted = True
        for turn in self._turn:
            turn.set()


def run_shards(body, lanes: int, n: int,
               timeout: float = BARRIER_TIMEOUT_S) -> list:
    """Run ``body(lane, rank, group)`` for every shard ``rank < n`` of
    every doc lane, each in a thread of its own, the shards of a lane
    sharing one ``ShardGroup``; return the results lane by lane. An
    exception in a shard aborts every group and is raised here; a shard
    that waits longer than ``timeout`` for a collective raises
    ``TimeoutError``. Never returns a partial result."""
    groups = [ShardGroup(n, timeout) for _ in range(lanes)]
    results = [None] * (lanes * n)
    errors: list = [None] * (lanes * n)

    def run(i: int) -> None:
        lane, rank = divmod(i, n)
        group = groups[lane]
        try:
            group.wait_turn(rank)
            results[i] = body(lane, rank, group)
            group.pass_turn(rank)
        except BaseException as e:  # noqa: BLE001 - raised in the caller
            errors[i] = e
            for g in groups:
                g.abort()

    threads = [threading.Thread(target=run, args=(i,), daemon=True,
                                name=f"seq-shard-{i}")
               for i in range(lanes * n)]
    for t in threads:
        t.start()
    failed_at = None
    pending = threads
    while pending:
        pending[0].join(0.05)
        pending = [t for t in pending if t.is_alive()]
        if failed_at is None and any(e is not None for e in errors):
            failed_at = time.monotonic()
        if failed_at is not None and time.monotonic() - failed_at > timeout:
            break  # a shard stuck outside the collectives: give up on it
    for e in errors:
        if e is not None and not isinstance(e, ShardAborted):
            raise e
    if pending or any(e is not None for e in errors):
        raise TimeoutError(
            f"a sequence shard did not return within {timeout} s of a "
            "failed shard")
    return results


def seq_prims(group: ShardGroup, rank: int,
              device: torch.device) -> AxisPrims:
    """Collective ``AxisPrims`` for shard ``rank`` of ``group``, whose
    slot block lives on ``device``."""
    n = group.n
    i32 = torch.int32

    def gather(x):
        return [v.to(device) for v in group.exchange(rank, x)]

    def across(reduce, x):
        return functools.reduce(reduce, gather(x))

    def iota_j(D, C, dev):
        return (rank * C + torch.arange(C, dtype=i32, device=dev)).expand(
            D, C)

    def excl_cumsum(x):
        incl = torch.cumsum(x, dim=-1, dtype=i32)
        totals = gather(incl[..., -1:])
        offset = functools.reduce(torch.add, totals[:rank],
                                  torch.zeros_like(totals[0]))
        return incl - x + offset

    def shift_right_many(arrs, k: int):
        # one exchange for the whole field family: every field's k-slot
        # tail stacked (all fields are int32, removers as its bits);
        # shard 0 takes zeros
        tails = torch.stack([a[..., a.shape[-1] - k:] for a in arrs])
        sent = group.exchange(rank, tails)
        recv = (sent[rank - 1].to(device) if rank
                else torch.zeros_like(tails))
        return [torch.cat([recv[i], a[..., :-k]], dim=-1)
                for i, a in enumerate(arrs)]

    def first_true(mask, j, default):
        return across(torch.minimum, torch.where(mask, j, default).amin(
            dim=-1, keepdim=True))

    def min_where(mask, arr, default):
        # the collective form of "value at the first masked slot" for a
        # monotone arr: excl_cumsum adds each shard's global offset
        return across(torch.minimum, torch.where(mask, arr, default).amin(
            dim=-1, keepdim=True))

    def at(arr, idx, j):
        return across(torch.add, torch.where(j == idx, arr, 0).sum(
            dim=-1, keepdim=True, dtype=i32))

    def total(vlen, incl):
        return across(torch.add, vlen.sum(dim=-1, keepdim=True, dtype=i32))

    return AxisPrims(
        iota_j=iota_j, excl_cumsum=excl_cumsum,
        shift_right_many=shift_right_many, first_true=first_true, at=at,
        min_where=min_where, total=total,
        global_capacity=lambda C: C * n,
    )


def _lane_grid(mesh: DeviceMesh, seq_axis: str,
               doc_axis: Optional[str]) -> np.ndarray:
    """The mesh's devices as a [doc lanes, seq shards] grid."""
    names = mesh.axis_names
    if doc_axis is None:
        if len(names) != 1:
            raise ValueError(f"mesh axes {names}: name the doc axis")
        return mesh.devices.reshape(1, -1)
    return np.transpose(mesh.devices,
                        (names.index(doc_axis), names.index(seq_axis)))


def _to(table: SegmentTable, device) -> SegmentTable:
    return SegmentTable(*(t.to(device) for t in table))


def apply_window_seq_sharded(
    table: SegmentTable, batch: OpBatch, mesh: DeviceMesh,
    seq_axis: str = SEQ_AXIS, doc_axis: Optional[str] = None,
) -> SegmentTable:
    """Apply a [docs, window] op batch (numpy or torch) with each
    document's slot slab sharded over ``seq_axis`` (and the documents
    over ``doc_axis`` when the mesh has one); returns the new table on
    ``table``'s device.

    Capacity must divide by the seq-axis size, and each shard must hold
    at least 2 slots (the restructure shifts by up to 2, and the
    boundary exchange reaches one neighbour). Per-doc scalars
    (count / min_seq / overflow) are replicated over the seq axis; every
    shard derives the same updates from globally reduced inputs."""
    if doc_axis is None and len(mesh.axis_names) > 1:
        doc_axis = next(a for a in mesh.axis_names if a != seq_axis)
    n_seq = mesh.shape[seq_axis]
    C = table.capacity
    if C % n_seq:
        raise ValueError(
            f"capacity {C} not divisible by seq axis {n_seq}")
    if C // n_seq < 2:
        raise ValueError(
            f"seq shard width {C // n_seq} < 2: the two-slot restructure "
            "shift would cross more than one shard boundary")
    # iota_j is GLOBAL under seq sharding, so the op_off composite spans
    # the global capacity: it must fit int32, or the masked min would
    # pick wrapped-negative entries
    if C * OPOFF_BOUND >= 2**31:
        raise ValueError(
            f"global capacity {C} overflows the op_off composite "
            f"(max {(2**31 - 1) // OPOFF_BOUND})")
    grid = _lane_grid(mesh, seq_axis, doc_axis)
    lanes = grid.shape[0]
    if table.docs % lanes:
        raise ValueError(
            f"{table.docs} rows not divisible by doc axis {lanes}")
    R, Cl = table.docs // lanes, C // n_seq
    rows = [slice(a * R, (a + 1) * R) for a in range(lanes)]
    if n_seq == 1:
        # a one-shard seq axis applies through apply_window (the Hopper
        # kernel on CUDA): with no other shard every collective above is
        # the identity, so the result equals the collective body's
        out = [_to(apply_window(
            _to(SegmentTable(*(t[r] for t in table)), grid[a, 0]),
            batch_from_numpy({f: getattr(batch, f)[r]
                              for f in OpBatch._fields}, grid[a, 0])),
            table.device) for a, r in enumerate(rows)]
        return SegmentTable(*(torch.cat(f) for f in zip(*out)))

    st = table_to_state(table)

    def body(a: int, b: int, group: ShardGroup):
        dev = grid[a, b]
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            mine = {f: (v[rows[a], b * Cl:(b + 1) * Cl] if f in SLOT_FIELDS
                        else v[rows[a]]).to(dev) for f, v in st.items()}
            ops = batch_from_numpy({f: getattr(batch, f)[rows[a]]
                                    for f in OpBatch._fields}, dev)
            prims = seq_prims(group, b, dev)
            for w in range(ops.kind.shape[-1]):
                op = {f: getattr(ops, f)[:, w:w + 1]
                      for f in OpBatch._fields}
                mine = fused_step(mine, op, prims)
            return mine

    blocks = run_shards(body, lanes, n_seq)
    out = {}
    for f in SLOT_FIELDS:
        out[f] = torch.cat([
            torch.cat([blocks[a * n_seq + b][f].to(table.device)
                       for b in range(n_seq)], dim=-1)
            for a in range(lanes)])
    for f in DOC_FIELDS:
        out[f] = torch.cat([blocks[a * n_seq][f].to(table.device)
                            for a in range(lanes)])
    return state_to_table(out)

