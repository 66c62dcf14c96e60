"""Fused batched merge step in plain torch — the plain version of the
Hopper window kernel, and the CPU spec it is held to.

A line-by-line port of the reference's ``ops/merge_step.py::fused_step``
(mergeTree.ts ``insertingWalk`` :1723, ``markRangeRemoved`` :1908,
``annotateRange`` :1864), applying one sequenced op per document in
three passes:

  1. ONE view pass at (refseq, client) + exclusive prefix sum, from
     which the insert target AND both range-boundary splits are
     resolved (the p2 boundary is computed on the pre-op view and
     shifted into post-split coordinates, which is equivalent because
     splitting at p1 never changes visible lengths).
  2. ONE two-insertion restructure (split tails and/or the inserted
     segment) as zero-fill shifts by 1 and 2 plus per-slot selects.
  3. ONE stamp pass whose in-range mask is derived from the pre-op
     view.

State is a dict of ``[D, C]`` int32 slot tensors and ``[D, 1]`` per-doc
scalars; an op is a dict of ``[D, 1]`` tensors. Every value is int32 and
every result equals the reference's bit for bit (``removers`` as the
int32 view of its uint32 bits: ``(r >> c) & 1`` and ``1 << 31`` give the
same bits in both).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .segment_table import (
    KIND_ANNOTATE,
    KIND_INSERT,
    KIND_REMOVE,
    NOT_REMOVED,
    OPOFF_BOUND,
    PROP_CHANNELS,
    OpBatch,
    SegmentTable,
)

# the [D, C] fields a SegmentTable holds as they are
PLAIN_SLOT_FIELDS = (
    "length", "seq", "client", "removed_seq", "removers",
    "op_id", "op_off", "is_marker",
)

# per-slot state tensors [D, C]; prop channels split into one tensor each
SLOT_FIELDS = PLAIN_SLOT_FIELDS + tuple(
    f"prop{c}" for c in range(PROP_CHANNELS))

# per-doc scalar tensors [D, 1]
DOC_FIELDS = ("count", "min_seq", "overflow")

STATE_FIELDS = SLOT_FIELDS + DOC_FIELDS

# op fields consumed per step, each [D, 1]
OP_COLS = OpBatch._fields

_BIG = 2**31 - 1


def table_to_state(table: SegmentTable) -> dict:
    """SegmentTable -> dict-of-tensors state (prop split per channel,
    per-doc scalars lifted to [D, 1]). Views, not copies."""
    st = {f: getattr(table, f) for f in PLAIN_SLOT_FIELDS}
    for c in range(PROP_CHANNELS):
        st[f"prop{c}"] = table.prop[..., c]
    for f in DOC_FIELDS:
        st[f] = getattr(table, f)[..., None]
    return st


def state_to_table(st: dict) -> SegmentTable:
    return SegmentTable(
        **{f: st[f].contiguous() for f in PLAIN_SLOT_FIELDS},
        prop=torch.stack(
            [st[f"prop{c}"] for c in range(PROP_CHANNELS)], dim=-1
        ),
        **{f: st[f][..., 0].contiguous() for f in DOC_FIELDS},
    )


def _shift_right(arr: torch.Tensor, k: int) -> torch.Tensor:
    """arr[j-k] with zero fill along the slot axis."""
    return F.pad(arr, (k, 0))[..., : arr.shape[-1]]


def _first_true(mask, j, default):
    return torch.where(mask, j, default).amin(dim=-1, keepdim=True)


def _min_where(mask, arr, default):
    """min of ``arr`` over ``mask``; for a monotone non-decreasing
    ``arr`` this is ``arr[first_true(mask)]``."""
    return torch.where(mask, arr, default).amin(dim=-1, keepdim=True)


def fused_step(st: dict, op: dict) -> dict:
    """Apply one sequenced op per document (batched over the leading
    doc axis) to the slot state; returns the new state."""
    D, C = st["length"].shape
    dev = st["length"].device
    i32 = torch.int32
    j = torch.arange(C, dtype=i32, device=dev).expand(D, C)
    big = torch.tensor(_BIG, dtype=i32, device=dev)
    cap = torch.tensor(C, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)

    count, min_seq = st["count"], st["min_seq"]
    kind = op["kind"]
    is_ins = kind == KIND_INSERT
    is_rem = kind == KIND_REMOVE
    is_ann = kind == KIND_ANNOTATE
    is_range = is_rem | is_ann
    refseq, client = op["refseq"], op["client"]
    p1, p2 = op["pos1"], op["pos2"]

    # ---- phase 1: one view pass at (refseq, client) ------------------
    alive = j < count
    removed = st["removed_seq"] != int(NOT_REMOVED)
    below = removed & (st["removed_seq"] <= min_seq)
    rm_by_viewer = ((st["removers"] >> client) & 1).bool()
    removal_visible = removed & ((st["removed_seq"] <= refseq) | rm_by_viewer)
    insert_visible = (st["seq"] <= refseq) | (st["client"] == client)
    vis = alive & ~below & insert_visible & ~removal_visible
    stop = alive & ~below
    vlen = torch.where(vis, st["length"], zero)
    # dtype=int32: torch's integer cumsum otherwise widens to int64
    E = torch.cumsum(vlen, dim=-1, dtype=i32) - vlen
    incl = E + vlen
    total = incl[..., -1:]

    opoff_comp = j * OPOFF_BOUND + st["op_off"]

    # INSERT target: first stop slot with E==p1, or p1 strictly inside
    # (breakTie on the sequenced path — mergeTree.ts:1705)
    inside = stop & (E <= p1) & (p1 < incl)
    target = inside | (stop & (E == p1))
    idx_t = _first_true(target, j, count)
    E_t = _min_where(target, E, big)
    incl_t = _min_where(target, incl, big)
    opoff_t = _min_where(target, opoff_comp, big) % OPOFF_BOUND
    found_t = idx_t < count
    off_ins = torch.where(found_t, p1 - E_t, zero)

    # RANGE boundary splits, both resolved on the PRE-op view
    strict1 = (E < p1) & (p1 < incl)
    idx1 = _first_true(strict1, j, cap)
    s1 = idx1 < C
    E_1 = _min_where(strict1, E, big)
    incl_1 = _min_where(strict1, incl, big)
    opoff_1 = _min_where(strict1, opoff_comp, big) % OPOFF_BOUND
    off1 = torch.where(s1, p1 - E_1, zero)
    strict2 = (E < p2) & (p2 < incl)
    idx2 = _first_true(strict2, j, cap)
    s2 = idx2 < C
    E_2 = _min_where(strict2, E, big)
    incl_2 = _min_where(strict2, incl, big)
    opoff_2 = _min_where(strict2, opoff_comp, big) % OPOFF_BOUND
    off2 = torch.where(s2, p2 - E_2, zero)
    same = s1 & s2 & (idx1 == idx2)

    # ---- phase 2: unified two-insertion restructure ------------------
    valid_ins = is_ins & (p1 <= total)
    split_ins = valid_ins & (off_ins > 0)
    u1 = valid_ins | (is_range & s1)
    u2 = split_ins | (is_range & s2)
    added = u1.to(i32) + u2.to(i32)
    overflow_now = (added > 0) & (count + added > C)
    skip = overflow_now
    u1 = u1 & ~skip
    u2 = u2 & ~skip

    k1 = torch.where(is_ins, idx_t, idx1)
    A = torch.where(is_ins, idx_t + split_ins.to(i32), idx1 + 1)
    h2 = idx2 + s1.to(i32)
    B = torch.where(is_ins, A + 1, h2 + 1)

    m = (u1 & (j >= A)).to(i32) + (u2 & (j >= B)).to(i32)
    m1 = m == 1
    m2 = m == 2

    fully_in = vis & (vlen > 0) & (E >= p1) & (incl <= p2)
    arrs = {f: st[f] for f in SLOT_FIELDS}
    arrs["_stamp"] = fully_in.to(i32)
    mv = {
        n: torch.where(m2, _shift_right(a, 2),
                       torch.where(m1, _shift_right(a, 1), a))
        for n, a in arrs.items()
    }

    at_A = u1 & (j == A)
    at_B = u2 & (j == B)
    new_at_A = at_A & is_ins

    # values at the split slots, all from the phase-1 reduce layer
    len_k1 = torch.where(is_ins, incl_t - E_t, incl_1 - E_1)
    len_k2 = incl_2 - E_2
    opoff_k1 = torch.where(is_ins, opoff_t, opoff_1)
    opoff_k2 = opoff_2

    f_h1 = ~skip & (split_ins | (is_range & s1)) & (j == k1)
    f_h2 = ~skip & is_range & s2 & (j == h2)
    off1h = torch.where(is_ins, off_ins, off1)
    len_h2 = off2 - torch.where(same, off1, zero)

    length = mv["length"]
    length = torch.where(f_h1, off1h, length)
    length = torch.where(
        at_A, torch.where(is_ins, op["length"], len_k1 - off1), length)
    length = torch.where(f_h2, len_h2, length)
    length = torch.where(
        at_B, torch.where(is_ins, len_k1 - off_ins, len_k2 - off2), length)

    op_off = mv["op_off"]
    op_off = torch.where(
        at_A, torch.where(is_ins, zero, opoff_k1 + off1), op_off)
    op_off = torch.where(
        at_B,
        torch.where(is_ins, opoff_k1 + off_ins, opoff_k2 + off2),
        op_off,
    )

    seq = torch.where(new_at_A, op["seq"], mv["seq"])
    cli = torch.where(new_at_A, client, mv["client"])
    removed_seq = torch.where(new_at_A, int(NOT_REMOVED), mv["removed_seq"])
    removers = torch.where(new_at_A, zero, mv["removers"])
    op_id = torch.where(new_at_A, op["op_id"], mv["op_id"])
    is_marker = torch.where(new_at_A, op["is_marker"], mv["is_marker"])
    props = [torch.where(new_at_A, zero, mv[f"prop{c}"])
             for c in range(PROP_CHANNELS)]

    # ---- phase 3: stamps (mask derived from the pre-op view) ---------
    stamp = mv["_stamp"] != 0
    stamp = stamp | (at_A & is_range) | (f_h2 & is_range)
    stamp = stamp & is_range & ~skip

    rmask = is_rem & stamp
    newly = rmask & (removed_seq == int(NOT_REMOVED))
    bit = torch.ones_like(client) << client  # 1 << 31 is -2**31: bit 31
    removed_seq = torch.where(newly, op["seq"], removed_seq)
    removers = torch.where(rmask, removers | bit, removers)

    amask = is_ann & stamp
    props = [
        torch.where(amask & (op["prop_key"] == c), op["prop_val"], p)
        for c, p in enumerate(props)
    ]

    out = {
        "length": length,
        "seq": seq,
        "client": cli,
        "removed_seq": removed_seq,
        "removers": removers,
        "op_id": op_id,
        "op_off": op_off,
        "is_marker": is_marker,
        "count": count + added * (1 - skip.to(i32)),
        "min_seq": torch.maximum(min_seq, op["min_seq"]),
        "overflow": torch.where(overflow_now, 1, st["overflow"]).to(i32),
    }
    for c in range(PROP_CHANNELS):
        out[f"prop{c}"] = props[c]
    return out
