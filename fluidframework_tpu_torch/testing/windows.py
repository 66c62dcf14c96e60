"""Seeded random slot states and op windows for holding the window
kernel against its plain version: tables with a random garbage tail
and some documents filled to capacity, and ops drawn around each
document's visible length so that inserts, boundary splits, out-of-range
ranges and NOOPs all occur. ``live_difference`` compares two executors'
tables under the routes' contract."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.segment_table import (
    KIND_INSERT,
    KIND_REMOVE,
    NOT_REMOVED,
    PROP_CHANNELS,
    OpBatch,
    SegmentTable,
)


def random_table(rng, docs: int, cap: int, device) -> SegmentTable:
    """A [docs, cap] table of random slots; a quarter of the documents
    hold cap - 2 .. cap live slots, the rest up to 3/4 of cap."""
    shape = (docs, cap)
    count = rng.integers(0, cap * 3 // 4 + 1, docs)
    count[: max(1, docs // 4)] = cap - rng.integers(0, 3, max(1, docs // 4))
    removed = rng.random(shape) < 0.3
    arrays = dict(
        length=rng.integers(1, 7, shape),
        seq=rng.integers(1, 50, shape),
        client=rng.integers(0, 32, shape),
        removed_seq=np.where(removed, rng.integers(1, 60, shape),
                             int(NOT_REMOVED)),
        removers=np.where(
            removed, rng.integers(-2**31, 2**31, shape, dtype=np.int64), 0),
        op_id=rng.integers(0, 100, shape),
        op_off=rng.integers(0, 1000, shape),
        is_marker=(rng.random(shape) < 0.1),
        prop=rng.integers(0, 4, (docs, cap, PROP_CHANNELS)),
        count=count,
        min_seq=rng.integers(0, 20, docs),
        overflow=np.zeros(docs),
    )
    return SegmentTable(**{
        f: torch.tensor(np.asarray(a).astype(np.int32), device=device)
        for f, a in arrays.items()
    })


def random_batch(rng, table: SegmentTable, window: int, device) -> OpBatch:
    """Ops drawn around each document's current visible length, so
    inserts, boundary splits, out-of-range ranges and NOOPs all occur."""
    docs = table.docs
    count = table.count.cpu().numpy()
    live = np.arange(table.capacity)[None, :] < count[:, None]
    alive = live & (table.removed_seq.cpu().numpy() == int(NOT_REMOVED))
    est = np.where(alive, table.length.cpu().numpy(), 0).sum(axis=1)
    seq = np.full(docs, 60)
    min_seq = table.min_seq.cpu().numpy().astype(np.int64)
    cols = {f: np.zeros((docs, window), np.int64) for f in OpBatch._fields}
    for w in range(window):
        seq += 1
        min_seq += rng.integers(0, 2, docs)
        kind = rng.choice(4, docs, p=[0.45, 0.25, 0.15, 0.15])
        pos1 = (rng.random(docs) * (est + 5)).astype(np.int64)
        pos2 = pos1 + rng.integers(1, 13, docs)
        length = rng.integers(1, 7, docs)
        cols["kind"][:, w] = kind
        cols["pos1"][:, w] = pos1
        cols["pos2"][:, w] = pos2
        cols["seq"][:, w] = seq
        cols["refseq"][:, w] = np.maximum(
            min_seq, seq - rng.integers(1, 16, docs))
        cols["client"][:, w] = rng.integers(0, 32, docs)
        cols["op_id"][:, w] = rng.integers(0, 100, docs)
        cols["length"][:, w] = length
        cols["is_marker"][:, w] = rng.random(docs) < 0.1
        cols["prop_key"][:, w] = rng.integers(0, 4, docs)
        cols["prop_val"][:, w] = rng.integers(0, 5, docs)
        cols["min_seq"][:, w] = min_seq
        est = np.where((kind == KIND_INSERT) & (pos1 <= est), est + length,
                       est)
        cut = np.clip(np.minimum(pos2, est) - pos1, 0, None)
        est = np.where(kind == KIND_REMOVE, est - cut, est)
    return OpBatch(**{
        f: torch.tensor(a.astype(np.int32), device=device)
        for f, a in cols.items()
    })


# slot fields compared on the live slots [0, count) of a document
LIVE_FIELDS = ("length", "seq", "client", "removed_seq", "removers",
               "op_id", "op_off", "is_marker", "prop")


def live_difference(want: dict, got: dict) -> str | None:
    """The first difference between two fetched tables (numpy dicts)
    under the executors' contract, or None: ``count``, ``min_seq`` and
    ``overflow`` of every document, and the live slots ``[0, count)``
    of every slot field of each document not overflowed (the
    macro-step routes park an overflowed document where the scan
    applies on; slots past ``count`` are garbage in every route)."""
    for f in ("count", "min_seq", "overflow"):
        bad = np.flatnonzero(want[f] != got[f])
        if bad.size:
            d = int(bad[0])
            return f"{f}[{d}]: {want[f][d]} != {got[f][d]}"
    for d in np.flatnonzero(want["overflow"] == 0):
        n = int(want["count"][d])
        for f in LIVE_FIELDS:
            a, b = want[f][d, :n], got[f][d, :n]
            bad = np.argwhere(a != b)
            if bad.size:
                at = tuple(int(i) for i in bad[0])
                return (f"doc {d} {f}{list(at)}: {a[at]} != {b[at]} "
                        f"(live slots {n})")
    return None
