"""The window apply's cost, reckoned from shapes: int32 operations and
bytes of one ``[docs, window]`` op batch applied to a ``[docs,
capacity]`` segment table.

The port's counterpart of the XLA cost analysis the reference's bench
read off a compiled window. It is one reckoning for every implementation
of the window apply (the Hopper kernel, the plain loop, the macro-step
routes), so a bench and a roofline read them alike:

- ``step_ops_per_slot()``: int32 ALU operations per slot of one
  ``fused_step``, counted by running the plain step once on a tiny CPU
  input under a dispatch counter (135 at this revision of the step);
- ``live_slot_steps(table, batch)``: the slot-steps this window's data
  needs — for every insert, remove or annotate step, the document's live
  slots at that step, from the plain loop's own counts;
- ``window_cost(table, batch)``: both, with the bytes the apply must
  move (the table read once and written once, the op batch read once),
  as a ``WindowCost`` whose ``bound_ms`` takes a card's peak rates. Its
  shape-only numbers are there at once; the live count is computed when
  first read.

Nothing here times anything: the rates come from the caller.
"""
from __future__ import annotations

import functools
import torch

from .merge_step import fused_step, table_to_state
from .segment_table import KIND_ANNOTATE, OpBatch, SegmentTable, make_table


@functools.cache
def step_ops_per_slot() -> int:
    """int32 ALU operations per slot of one fused_step, counted by
    running the plain version once on a tiny CPU input under a dispatch
    counter.

    An op counts once when it reads or writes one element per slot (the
    min-reduces of the 12 lookups count by what they read). Not counted:
    views (expand, slice), the zero-fill pads and the dtype casts, which
    are data movement the kernel does as addressing. The plain version
    shifts each field by 1 or 2 slots with two nested selects; the
    kernel does it with one indexed load per field (src = j - m), so the
    two count as one select per field."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    movement = {aten.constant_pad_nd.default, aten._to_copy.default}
    D, C = 3, 8
    st = table_to_state(make_table(D, C, "cpu"))
    op = {f: torch.zeros((D, 1), dtype=torch.int32) for f in OpBatch._fields}

    class Count(TorchDispatchMode):
        ops = 0
        shift_selects = 0
        pads: list = []  # kept alive so their storages stay distinct

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten.constant_pad_nd.default:
                Count.pads.append(out)
            if func.is_view or func in movement:
                return out
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            if isinstance(out, torch.Tensor):
                tensors.append(out)
            if not any(t.numel() >= D * C for t in tensors):
                return out
            shifted = {p.untyped_storage().data_ptr() for p in Count.pads}
            if func is aten.where.self and any(
                    t.untyped_storage().data_ptr() in shifted
                    for t in tensors[1:3]):
                Count.shift_selects += 1
            else:
                Count.ops += 1
            return out

    with Count():
        fused_step(st, op)
    return Count.ops + Count.shift_selects // 2


def real_ops(kind: torch.Tensor) -> torch.Tensor:
    """Insert, remove and annotate ops (kinds 0..2); any other kind is a
    NOOP."""
    return (kind >= 0) & (kind <= KIND_ANNOTATE)


def live_slot_steps(table: SegmentTable, batch: OpBatch) -> int:
    """Slot-steps this window's data needs: for every insert, remove or
    annotate step, the document's live slots (``count``) at that step,
    from the plain loop's own counts. NOOP steps and slots at or above
    ``count`` do not enter a view. Runs the plain loop over the window
    on the table's device."""
    st = table_to_state(table)
    live = 0
    for w in range(batch.kind.shape[-1]):
        op = {f: getattr(batch, f)[:, w:w + 1] for f in OpBatch._fields}
        live += int((st["count"].long() * real_ops(op["kind"])).sum())
        st = fused_step(st, op)
    return live


class WindowCost:
    """The work of one window apply of ``batch`` to ``table``:
    ``ops_per_slot_step`` int32 operations per slot-step, over every
    slot-step (``docs * capacity * window``) or over the
    ``live_slot_steps`` the window's data needs, and the bytes it must
    move (``state_bytes`` read and written once, ``op_bytes`` read
    once). Everything but the live count comes from shapes at once; the
    live count runs the plain loop over the window when it is first
    read, so a handle costs nothing until then."""

    def __init__(self, table: SegmentTable, batch: OpBatch):
        self._table, self._batch = table, batch
        self.docs, self.capacity = table.docs, table.capacity
        self.window = batch.kind.shape[-1]
        self.ops_per_slot_step = step_ops_per_slot()
        self.state_bytes = sum(t.numel() * t.element_size() for t in table)
        self.op_bytes = sum(t.numel() * t.element_size() for t in batch)

    @functools.cached_property
    def live_slot_steps(self) -> int:
        return live_slot_steps(self._table, self._batch)

    @property
    def slot_steps(self) -> int:
        return self.docs * self.capacity * self.window

    @property
    def nbytes(self) -> int:
        return 2 * self.state_bytes + self.op_bytes

    @property
    def ops(self) -> int:
        """int32 operations over every slot of every step."""
        return self.slot_steps * self.ops_per_slot_step

    @property
    def live_ops(self) -> int:
        """int32 operations over the live slot-steps of this window."""
        return self.live_slot_steps * self.ops_per_slot_step

    def bound_ms(self, bytes_per_s: float, int32_ops_per_s: float,
                 live: bool = True) -> tuple[float, str]:
        """The least time a card with these peak rates could take, and
        what bounds it (``"bytes"`` or ``"operations"``): the larger of
        the bytes over the memory rate and the operations (the live
        ones, or every slot's with ``live=False``) over the int32
        rate."""
        bytes_ms = self.nbytes / bytes_per_s * 1e3
        ops_ms = (self.live_ops if live else self.ops) / int32_ops_per_s \
            * 1e3
        return ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                else (ops_ms, "operations"))


def window_cost(table: SegmentTable, batch: OpBatch) -> WindowCost:
    """The reckoning of ``batch`` applied to ``table``; its live
    slot-steps run the plain loop over the window when first read."""
    return WindowCost(table, batch)
