"""Batched sequenced-path window apply, slab regrow and compaction.

Applies a totally-ordered ``[docs, window]`` op batch to the
``[docs, capacity]`` segment table. Within one document ops are
sequentially dependent, so the window is a sequential loop; parallelism
is across documents.

- ``apply_window``: the serving entry. A table on the CPU goes through
  the plain loop of ``merge_step.fused_step``; a table on a CUDA device
  goes through the Hopper window kernel (``cuda_merge``), which launches
  or raises — there is no fallback.
- ``apply_window_plain``: the plain loop on any device, which the
  kernel is held against.
- ``apply_window_pingpong``: the double-buffered twin of
  ``apply_window``; its output is written into a retired table.
- ``pad_capacity`` / ``compact``: plain torch (the reference has them
  as XLA programs, not Pallas kernels).
- ``compiled_window``: the exact callable ``apply_window`` dispatches
  for a table, with its arguments and the window's cost reckoning.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .merge_step import fused_step, state_to_table, table_to_state
from .segment_table import (
    NOT_REMOVED,
    OPOFF_BOUND,
    OpBatch,
    SegmentTable,
    check_donated,
    copy_into,
)


def check_capacity(capacity: int) -> None:
    """The phase-1 op_off composite (j*OPOFF_BOUND + op_off) must fit
    int32, so the largest usable capacity is 8192."""
    assert capacity * OPOFF_BOUND < 2**31, (
        f"capacity {capacity} overflows the op_off composite"
    )


def apply_window_plain(table: SegmentTable, batch: OpBatch) -> SegmentTable:
    """Plain torch: loop ``fused_step`` over the window columns. Runs on
    any device; returns a new table and leaves ``table`` untouched."""
    check_capacity(table.capacity)
    st = table_to_state(table)
    for w in range(batch.kind.shape[-1]):
        op = {f: getattr(batch, f)[:, w:w + 1] for f in OpBatch._fields}
        st = fused_step(st, op)
    return state_to_table(st)


def apply_window(table: SegmentTable, batch: OpBatch) -> SegmentTable:
    """Apply a [docs, window] op batch; returns a new table (the input
    table stays valid — the sidecar's regrow re-applies a window to the
    pre-dispatch snapshot)."""
    device = table.device
    if device.type == "cpu":
        return apply_window_plain(table, batch)
    if device.type != "cuda":
        raise ValueError(f"no window apply for device {device}")
    from .cuda_merge import apply_window_cuda

    return apply_window_cuda(table, batch)


def compiled_window(table: SegmentTable, batch: OpBatch) -> tuple:
    """The counterpart of the reference's ``compiled_window()``: the
    exact callable ``apply_window`` dispatches for ``table`` (the Hopper
    window kernel ``cuda_merge.apply_window_cuda`` on a CUDA table, the
    plain loop ``apply_window_plain`` on the CPU), its positional
    arguments, and the window's ``WindowCost`` (``ops/window_cost.py``:
    int32 operations and bytes from shapes, over every slot-step and
    over the live slot-steps of ``batch``) — ``(fn, args, cost)``, so
    ``fn(*args)`` is the dispatch a caller instruments or times."""
    from .window_cost import window_cost

    if table.device.type == "cuda":
        from .cuda_merge import apply_window_cuda as fn
    elif table.device.type == "cpu":
        fn = apply_window_plain
    else:
        raise ValueError(f"no window apply for device {table.device}")
    return fn, (table, batch), window_cost(table, batch)


def apply_window_pingpong(dead: SegmentTable, table: SegmentTable,
                          batch: OpBatch) -> SegmentTable:
    """Double-buffered dispatch: apply ``batch`` to ``table`` with the
    output written into ``dead``, a retired table of the same shape
    (the sidecar's snapshot of two dispatches ago), which is never
    read. ``table`` survives as the pre-dispatch snapshot that a regrow
    re-applies from. Returns a table whose storage is ``dead``'s; the
    caller drops every other reference to ``dead``. On a CUDA table the
    window kernel writes into ``dead`` directly; on the CPU the plain
    loop's result is copied into it. Raises ``ValueError`` if ``dead``
    differs in shape or shares storage with ``table`` or ``batch``."""
    if table.device.type == "cuda":
        from .cuda_merge import apply_window_cuda

        return apply_window_cuda(table, batch, out=dead)  # checks dead
    check_donated(dead, table, batch)
    return copy_into(dead, apply_window(table, batch))


def pad_capacity(table: SegmentTable, new_capacity: int) -> SegmentTable:
    """Widen the slot slab without touching content: live slots and
    doc scalars carry over, new slots are garbage beyond ``count``
    (``removed_seq`` filled with NOT_REMOVED), and ``overflow`` is
    cleared."""
    grow = new_capacity - table.capacity
    assert grow > 0

    def pad(t, fill=0):
        return F.pad(t, (0, grow), value=fill)

    return table._replace(
        length=pad(table.length),
        seq=pad(table.seq),
        client=pad(table.client),
        removed_seq=pad(table.removed_seq, int(NOT_REMOVED)),
        removers=pad(table.removers),
        op_id=pad(table.op_id),
        op_off=pad(table.op_off),
        is_marker=pad(table.is_marker),
        prop=F.pad(table.prop, (0, 0, 0, grow)),
        overflow=torch.zeros_like(table.overflow),
    )


def compact(table: SegmentTable) -> SegmentTable:
    """Zamboni (mergeTree.ts:800): drop tombstones at/below the collab
    window, compacting live slots to the slab head. A stable sort of
    ``~keep`` per row gives the same permutation as the reference's
    stable argsort, so the whole slab — garbage tail included — matches
    it."""
    C = table.capacity
    j = torch.arange(C, dtype=torch.int32, device=table.device)
    alive = j < table.count[:, None]
    drop = alive & (table.removed_seq != int(NOT_REMOVED)) & (
        table.removed_seq <= table.min_seq[:, None]
    )
    keep = alive & ~drop
    src = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices

    def take(t):
        return torch.gather(t, 1, src)

    return table._replace(
        length=take(table.length),
        seq=take(table.seq),
        client=take(table.client),
        removed_seq=take(table.removed_seq),
        removers=take(table.removers),
        op_id=take(table.op_id),
        op_off=take(table.op_off),
        is_marker=take(table.is_marker),
        prop=torch.gather(
            table.prop, 1, src[..., None].expand(-1, -1, table.prop.shape[-1])
        ),
        count=keep.sum(dim=-1, dtype=torch.int32),
    )
