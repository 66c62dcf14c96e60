"""SharedMatrix batched path: two merge-kernel axes + vectorized cells.
A port of the reference's ``ops/matrix_bridge.py``.

Reference design: packages/dds/matrix/src/permutationvector.ts:137 —
each axis IS a merge tree whose runs carry stable handles, and cells
are LWW values keyed by (rowHandle, colHandle), commuting with any
concurrent permutation. The device mapping falls out directly:

- axis ops reuse ``merge_kernel.apply_window`` unchanged: a batch of N
  matrices is a 2N-doc ``SegmentTable`` (even slots = row axes, odd =
  col axes), one dispatch for every axis of every matrix — on a CUDA
  table, one launch of the Hopper window kernel;
- the "payload" of an axis insert is its alloc id — the handle of
  device slot position i is ``f"{alloc}:{op_off + i}"``, the same
  provenance rule the text path uses;
- cells apply on the device through ``matrix_cells.CellPack`` (one
  sort + last-wins scatter per window); ``extract_matrix`` materializes
  one matrix on the host with one vectorized numpy scatter in sequenced
  order (duplicate-index fancy assignment is last-wins) and one
  ``cells[np.ix_(rows, cols)]`` gather.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..convert import batch_from_numpy
from ..models.mergetree.ops import DeltaType
from ..protocol.messages import MessageType, SequencedMessage
from .host_bridge import DocStream, build_batch
from .merge_kernel import apply_window
from .segment_table import NOT_REMOVED, OpBatch, SegmentTable, make_table


def _collect_insert_handles(op, out: list) -> None:
    """Handle bases of every INSERT in ``op``, in the exact order
    ``DocStream`` appends payloads (GroupOps from reconnect
    resubmission recurse; split inserts carry handle=[alloc, off>0])."""
    if op.type == DeltaType.GROUP:
        for sub in op.ops:
            _collect_insert_handles(sub, out)
    elif op.type == DeltaType.INSERT:
        handle = getattr(op, "handle", None)
        out.append((handle[0], handle[1]) if handle else (None, 0))


class MatrixStream:
    """One matrix document's encoded sequenced stream."""

    def __init__(self) -> None:
        self.rows = DocStream()
        self.cols = DocStream()
        # (alloc id, base offset) per axis payload index (op_id ->)
        self.row_allocs: list[tuple] = []
        self.col_allocs: list[tuple] = []
        # cell ops in sequenced order
        self.cell_rows: list[str] = []
        self.cell_cols: list[str] = []
        self.cell_vals: list[Any] = []

    def add_message(self, msg: SequencedMessage) -> None:
        """Consume one of the matrix channel's inner sequenced
        messages (contents = {"target": ..., ...})."""
        contents = msg.contents if isinstance(msg.contents, dict) else {}
        target = contents.get("target")
        if msg.type != MessageType.OPERATION or target is None:
            self.rows.add_noop(msg.minimum_sequence_number)
            self.cols.add_noop(msg.minimum_sequence_number)
            return
        if target in ("rows", "cols"):
            stream, allocs, other = (
                (self.rows, self.row_allocs, self.cols)
                if target == "rows"
                else (self.cols, self.col_allocs, self.rows)
            )
            op = contents["op"]
            before = len(stream.payloads)
            stream.add_message(dataclasses.replace(msg, contents=op))
            new_handles: list = []
            _collect_insert_handles(op, new_handles)
            if len(new_handles) != len(stream.payloads) - before:
                raise ValueError("axis payloads and insert handles differ "
                                 "in number")
            allocs.extend(new_handles)
            other.add_noop(msg.minimum_sequence_number)
        elif target == "cell":
            self.cell_rows.append(contents["row"])
            self.cell_cols.append(contents["col"])
            self.cell_vals.append(contents["value"])
            self.rows.add_noop(msg.minimum_sequence_number)
            self.cols.add_noop(msg.minimum_sequence_number)
        else:  # pragma: no cover - forward compat
            raise ValueError(f"unknown matrix target {target!r}")

    @property
    def op_count(self) -> int:
        return (len(self.rows.ops) + len(self.cols.ops)
                + len(self.cell_rows))


def pack_matrix_batch(streams: list[MatrixStream]) -> OpBatch:
    """Pack every matrix's two axis streams into one OpBatch of numpy
    arrays: even doc slots = row axes, odd = col axes (the single
    definition of the slot-layout convention)."""
    axis_streams: list[DocStream] = []
    for ms in streams:
        axis_streams.append(ms.rows)
        axis_streams.append(ms.cols)
    return build_batch(axis_streams)


def dispatch_matrix_batch(batch: OpBatch, n_matrices: int,
                          capacity: int = 1024,
                          device: torch.device | str = "cuda"
                          ) -> SegmentTable:
    """ONE window dispatch over a packed 2N-doc axis batch (numpy or
    tensors) on ``device``: on ``cuda``, one launch of the window
    kernel. Returns at enqueue."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dispatch_matrix_batch needs a CUDA device; "
                           "pass device='cpu' to run on the CPU")
    return apply_window(make_table(2 * n_matrices, capacity, device),
                        batch_from_numpy(batch, device))


def apply_matrix_batch(streams: list[MatrixStream], capacity: int = 1024,
                       device: torch.device | str = "cuda") -> SegmentTable:
    """Pack + dispatch in one call (pack separately via
    ``pack_matrix_batch`` when the pack cost must stay off the timed
    path)."""
    return dispatch_matrix_batch(
        pack_matrix_batch(streams), len(streams), capacity, device
    )


def _visible_handles(table_np: dict, doc: int,
                     allocs: list[tuple]) -> list[str]:
    """In-order stable handles of one axis (live, not removed).
    ``allocs[op_id]`` is (alloc, base): payload position 0 of a split
    resubmitted insert corresponds to handle offset ``base``, not 0."""
    out = []
    for i in range(int(table_np["count"][doc])):
        if table_np["removed_seq"][doc, i] != NOT_REMOVED:
            continue
        alloc, base = allocs[int(table_np["op_id"][doc, i])]
        off = base + int(table_np["op_off"][doc, i])
        for k in range(int(table_np["length"][doc, i])):
            out.append(f"{alloc}:{off + k}")
    return out


def extract_matrix(table_np: dict, stream: MatrixStream,
                   doc: int) -> list[list[Any]]:
    """Materialize one matrix from a fetched axis table: axis handle
    orders from the table, cells via one vectorized scatter + one
    gather."""
    row_handles = _visible_handles(table_np, 2 * doc, stream.row_allocs)
    col_handles = _visible_handles(
        table_np, 2 * doc + 1, stream.col_allocs
    )
    if not stream.cell_vals:
        return [[None] * len(col_handles) for _ in row_handles]

    # intern every handle ever written (removed rows' cells scatter
    # into rows the gather never reads — harmless, like the reference's
    # sparse store retaining dead handles until GC)
    r_ids: dict[str, int] = {}
    c_ids: dict[str, int] = {}
    for h in stream.cell_rows:
        r_ids.setdefault(h, len(r_ids))
    for h in stream.cell_cols:
        c_ids.setdefault(h, len(c_ids))
    for h in row_handles:
        r_ids.setdefault(h, len(r_ids))
    for h in col_handles:
        c_ids.setdefault(h, len(c_ids))

    cells = np.full((len(r_ids), len(c_ids)), -1, np.int64)
    ri = np.fromiter(
        (r_ids[h] for h in stream.cell_rows), np.int64,
        len(stream.cell_rows),
    )
    ci = np.fromiter(
        (c_ids[h] for h in stream.cell_cols), np.int64,
        len(stream.cell_cols),
    )
    # sequenced-order LWW: duplicate-index assignment keeps the LAST
    # write (numpy fancy-assignment semantics)
    cells[ri, ci] = np.arange(len(stream.cell_vals), dtype=np.int64)

    vr = np.fromiter((r_ids[h] for h in row_handles), np.int64,
                     len(row_handles))
    vc = np.fromiter((c_ids[h] for h in col_handles), np.int64,
                     len(col_handles))
    if len(vr) == 0 or len(vc) == 0:
        return [[None] * len(vc) for _ in vr]
    picked = cells[np.ix_(vr, vc)]
    return [
        [
            None if picked[r, c] < 0
            else stream.cell_vals[int(picked[r, c])]
            for c in range(picked.shape[1])
        ]
        for r in range(picked.shape[0])
    ]
