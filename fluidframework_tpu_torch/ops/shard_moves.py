"""Cross-shard row movement for the doc-sharded document pool (B6).

A pooled document's row is self-contained: the merge step never reads
across the doc axis, so moving a document between shards is a pure
permutation gather on dim 0 of every ``SegmentTable`` field. Done at the
settle boundary, with every member's stream watermark applied and
nothing in flight, the move commutes with the op order, which is what
lets a migrated pool serve exactly what a never-migrated one serves.

- ``take_rows``: the gather on one table; the source stays readable.
- ``migrate_rows``: the migration handoff on a ``ShardedTable``. It
  consumes its source: the source's shard list is emptied, so no caller
  can read the pre-move table again, and its buffers go back to the
  allocator (the reference donates them).
"""
from __future__ import annotations

import numpy as np
import torch

from .segment_table import SegmentTable, ShardedTable


def take_rows(table: SegmentTable, idx) -> SegmentTable:
    """Output row ``r`` holds input row ``idx[r]``, every field."""
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=table.device)
    return SegmentTable(*(t.index_select(0, idx) for t in table))


def migrate_rows(table: ShardedTable, idx) -> ShardedTable:
    """Global row permutation of a doc-sharded table: global row ``r`` of
    the output holds global row ``idx[r]`` of the input, and each output
    shard stays on its input shard's device. Every output shard gathers
    from each source shard only the rows it takes, then moves them to
    its own device. ``table`` is consumed (its shard list is emptied)."""
    idx = np.asarray(idx, np.int64)
    R = table.rows_per_shard
    if idx.shape != (table.docs,):
        raise ValueError(f"permutation of {idx.shape} for {table.docs} rows")
    out = []
    for s, dst in enumerate(table.shards):
        want = idx[s * R:(s + 1) * R]
        src = want // R
        order = np.argsort(src, kind="stable")
        pieces = [
            take_rows(table.shards[k], want[order][src[order] == k] % R)
            for k in np.unique(src)
        ]
        pieces = [SegmentTable(*(t.to(dst.device) for t in p))
                  for p in pieces]
        back = torch.as_tensor(np.argsort(order, kind="stable"),
                               device=dst.device)
        out.append(SegmentTable(*(
            torch.cat(fields).index_select(0, back)
            for fields in zip(*pieces))))
    table.shards.clear()
    return ShardedTable(out)
