"""Seeded random slot states and op windows for holding the window
kernel against its plain version: tables with a random garbage tail
and some documents filled to capacity, and ops drawn around each
document's visible length so that inserts, boundary splits, out-of-range
ranges and NOOPs all occur; ``span_window`` aims every lookup of a
window at the slots around the boundaries between equal spans (the
cluster form's CTAs). ``live_difference`` compares two executors'
tables under the routes' contract."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.merge_step import fused_step, table_to_state
from ..ops.segment_table import (
    KIND_ANNOTATE,
    KIND_INSERT,
    KIND_NOOP,
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


def boundary_slots(cap: int, span: int) -> list:
    """The slots span-2 .. span+1 around each boundary between spans of
    ``span`` slots below ``cap``."""
    return [b + o for b in range(span, cap, span) for o in (-2, -1, 0, 1)
            if 0 <= b + o < cap]


def _aim(rng, vlen, stop, count, room, targets, todo):
    """One op (kind, pos1, pos2) of a document whose view has visible
    lengths ``vlen`` and stop mask ``stop``, adding at most ``room`` slots,
    that puts a lookup on a slot of ``targets``: the insert target (0),
    the first split (1) or the second (2), those of ``todo`` first.
    Returns the op and the (lookup, slot) pairs it aims at, or None when
    no target slot can be hit."""
    E = np.cumsum(vlen) - vlen
    cut = [s for s in targets if s < count and vlen[s] >= 2]

    def ins(s):  # insert at the start of s (adds 1) or inside it (adds 2)
        if room >= 2 and vlen[s] >= 2 and rng.random() < 0.5:
            return (KIND_INSERT, E[s] + 1, 0), [(0, s)]
        if room >= 1 and stop[s] and (s == 0 or vlen[s - 1] > 0):
            return (KIND_INSERT, E[s], 0), [(0, s)]
        if room >= 2 and vlen[s] >= 2:
            return (KIND_INSERT, E[s] + 1, 0), [(0, s)]
        return None

    def rng_op(s1, s2):  # a range split at s1 and at s2 (adds 2)
        if room < 2 or s1 not in cut or s2 not in cut:
            return None
        kind = KIND_REMOVE if rng.random() < 0.5 else KIND_ANNOTATE
        if s1 == s2 and vlen[s1] < 3:
            return None
        return ((kind, E[s1] + 1, E[s2] + 1 + (s1 == s2)),
                [(1, s1), (2, s2)])

    wanted = [c for c in todo if c[1] in targets]
    rest = [(look, s) for look in range(3) for s in targets]
    for group in (wanted, rest):
        for i in rng.permutation(len(group)):
            look, s = group[i]
            if look == 0:
                op = ins(s)
            elif look == 1:
                op = next(filter(None, (rng_op(s, s2) for s2 in
                                        range(s, s + 4))), None)
            else:
                op = next(filter(None, (rng_op(s1, s) for s1 in
                                        range(s, s - 4, -1))), None)
            if op is not None:
                return op
    return None


def span_window(rng, docs: int, cap: int, window: int, span: int, device,
                fill_docs: int = 1, overflow_docs: int = 0):
    """A ``[docs, cap]`` table and a ``window``-step op batch whose steps
    put the insert target and both range splits of their ops on the
    slots span-2 .. span+1 of every boundary between spans (each slot
    and lookup among the first to be aimed at), with the window's own
    inserts and splits shifting slots across the boundaries. The first
    ``overflow_docs`` documents fill to ``cap`` and then overflow, the
    next ``fill_docs`` fill to exactly ``cap``; the others hold up to
    ``cap - 3`` live slots. Every op is aimed on the state the plain
    step leaves (run on the CPU), at the view of a reader that has seen
    every earlier op; some steps are NOOPs."""
    shape = (docs, cap)
    count = np.where(np.arange(docs) % 2 == 0,
                     rng.integers(max(1, cap - span + 2), cap - 2, docs),
                     rng.integers(cap // 2, cap - 2, docs))
    count[:overflow_docs + fill_docs] = cap - 5
    removed = rng.random(shape) < 0.1
    table = SegmentTable(**{f: torch.tensor(
        np.asarray(a).astype(np.int32)) for f, a in dict(
            length=rng.integers(2, 9, shape),
            seq=rng.integers(1, 50, shape),
            client=rng.integers(0, 32, shape),
            removed_seq=np.where(removed, rng.integers(1, 60, shape),
                                 int(NOT_REMOVED)),
            removers=np.where(removed, rng.integers(
                -2**31, 2**31, shape, dtype=np.int64), 0),
            op_id=rng.integers(0, 100, shape),
            op_off=rng.integers(0, 1000, shape),
            is_marker=rng.random(shape) < 0.1,
            prop=rng.integers(0, 4, (docs, cap, PROP_CHANNELS)),
            count=count,
            min_seq=rng.integers(0, 20, docs),
            overflow=np.zeros(docs)).items()})
    targets = boundary_slots(cap, span)
    todo = [(look, s) for look in range(3) for s in targets]
    st = table_to_state(table)
    cols = {f: np.zeros((docs, window), np.int64) for f in OpBatch._fields}
    for w in range(window):
        seq = 61 + w
        cnt = st["count"][:, 0].numpy()
        mseq = st["min_seq"][:, 0].numpy()
        rs = st["removed_seq"].numpy()
        alive = np.arange(cap)[None, :] < cnt[:, None]
        gone = rs != int(NOT_REMOVED)
        vlen = np.where(alive & ~gone, st["length"].numpy(), 0)
        stop = alive & ~(gone & (rs <= mseq[:, None]))
        for d in range(docs):
            room = cap - int(cnt[d])
            total = int(vlen[d].sum())
            if rng.random() < 0.1:
                op = (KIND_NOOP, 0, 0)
            elif d < overflow_docs + fill_docs and room <= 2:
                op = ((KIND_INSERT, 0, 0) if room == 0 and d < overflow_docs
                      else (KIND_INSERT, total, 0) if room == 1
                      else (_aim(rng, vlen[d], stop[d], cnt[d], 2,
                                 range(int(cnt[d])), []) or (None,))[0]
                      if room == 2 else (KIND_ANNOTATE, 0, total))
            else:
                op, aimed = _aim(rng, vlen[d], stop[d], int(cnt[d]), room,
                                 targets, todo) or (None, [])
                todo = [c for c in todo if c not in aimed]
            if op is None:
                op = (KIND_ANNOTATE, 0, total)
            cols["kind"][d, w], cols["pos1"][d, w], cols["pos2"][d, w] = op
        cols["seq"][:, w] = seq
        cols["refseq"][:, w] = seq - 1
        cols["client"][:, w] = rng.integers(0, 32, docs)
        cols["op_id"][:, w] = rng.integers(0, 100, docs)
        cols["length"][:, w] = rng.integers(1, 7, docs)
        cols["is_marker"][:, w] = rng.random(docs) < 0.1
        cols["prop_key"][:, w] = rng.integers(0, 4, docs)
        cols["prop_val"][:, w] = rng.integers(0, 5, docs)
        cols["min_seq"][:, w] = mseq + rng.integers(0, 2, docs)
        st = fused_step(st, {f: torch.tensor(
            cols[f][:, w:w + 1].astype(np.int32)) for f in OpBatch._fields})
    batch = OpBatch(**{f: torch.tensor(a.astype(np.int32), device=device)
                       for f, a in cols.items()})
    return SegmentTable(*(t.to(device) for t in table)), batch


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
