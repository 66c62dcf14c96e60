"""The plain reference of the array lane: the deli's tickets and the
merge window's segment table, worked out from the generated sessions
alone. Plain NumPy and PyTorch; nothing of the program is imported.

- ``tickets``: one document's deli (``join`` of every client, then each
  operation message in order): seq, msn and status per message, where
  a status other than 0 is a refusal.
- ``fused_step``: one sequenced op per document on ``[D, C]`` int32 slot
  state, a frozen copy of the port's plain version of its window kernel
  (``ops/merge_step.py``, itself a line-by-line port of merge-tree's
  ``insertingWalk`` / ``markRangeRemoved`` / ``annotateRange``).
- ``replay``: every session through the plain loop, round by round, with
  its own tickets stamped; the state after each round and the live
  slot-steps each round needs (for every insert, remove or annotate
  step, the document's live slots at that step).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .generator import FIELDS, KIND_ANNOTATE, KIND_INSERT, KIND_REMOVE

NOT_REMOVED = 2**31 - 1
OPOFF_BOUND = 1 << 17
PROP_CHANNELS = 4
SLOT_FIELDS = ("length", "seq", "client", "removed_seq", "removers",
               "op_id", "op_off", "is_marker")
PROP_FIELDS = tuple(f"prop{c}" for c in range(PROP_CHANNELS))
DOC_FIELDS = ("count", "min_seq", "overflow")
_BIG = 2**31 - 1

# the deli's refusals
OK, UNKNOWN_CLIENT, DUPLICATE, CSN_GAP, BELOW_MSN, AHEAD = range(6)


def tickets(session: dict, clients: int) -> tuple:
    """(seq, msn, status) of one document's messages, int64 / int64 /
    int32: clients 0 .. ``clients - 1`` join first (the join's seq, refSeq
    the seq before it), then every message of ``session`` in order."""
    seq = 0
    ref, csn = {}, {}
    for c in range(clients):
        seq += 1
        ref[c], csn[c] = seq - 1, 0
    msn = min(ref.values())
    n = len(session["cids"])
    out = (np.zeros(n, np.int64), np.zeros(n, np.int64),
           np.zeros(n, np.int32))
    for i in range(n):
        c = int(session["cids"][i])
        s, r = int(session["csns"][i]), int(session["refs"][i])
        if c not in ref:
            out[2][i] = UNKNOWN_CLIENT
        elif s <= csn[c]:
            out[2][i] = DUPLICATE
        elif s > csn[c] + 1:
            out[2][i] = CSN_GAP
        elif r < msn:
            out[2][i] = BELOW_MSN
        elif r > seq:
            out[2][i] = AHEAD
        else:
            csn[c], ref[c] = s, r
            seq += 1
            msn = max(msn, min(ref.values()))
            out[0][i], out[1][i] = seq, msn
    return out


# ---- the plain merge step ------------------------------------------------

def _shift_right(arr, k):
    return F.pad(arr, (k, 0))[..., : arr.shape[-1]]


def _first_true(mask, j, default):
    return torch.where(mask, j, default).amin(dim=-1, keepdim=True)


def _min_where(mask, arr, default):
    return torch.where(mask, arr, default).amin(dim=-1, keepdim=True)


def fused_step(st: dict, op: dict) -> dict:
    """Apply one sequenced op per document (``op``: ``[D, 1]`` int32 per
    field) to the slot state; returns the new state."""
    D, C = st["length"].shape
    dev = st["length"].device
    i32 = torch.int32
    j = torch.arange(C, dtype=i32, device=dev).expand(D, C)
    big = torch.full((), _BIG, dtype=i32, device=dev)
    cap = torch.full((), C, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)

    count, min_seq = st["count"], st["min_seq"]
    kind = op["kind"]
    is_ins = kind == KIND_INSERT
    is_rem = kind == KIND_REMOVE
    is_ann = kind == KIND_ANNOTATE
    is_range = is_rem | is_ann
    refseq, client = op["refseq"], op["client"]
    p1, p2 = op["pos1"], op["pos2"]

    # one view pass at (refseq, client)
    alive = j < count
    removed = st["removed_seq"] != NOT_REMOVED
    below = removed & (st["removed_seq"] <= min_seq)
    rm_by_viewer = ((st["removers"] >> client) & 1).bool()
    removal_visible = removed & ((st["removed_seq"] <= refseq) | rm_by_viewer)
    insert_visible = (st["seq"] <= refseq) | (st["client"] == client)
    vis = alive & ~below & insert_visible & ~removal_visible
    stop = alive & ~below
    vlen = torch.where(vis, st["length"], zero)
    E = torch.cumsum(vlen, dim=-1, dtype=i32) - vlen
    incl = E + vlen
    total = incl[..., -1:]
    opoff_comp = j * OPOFF_BOUND + st["op_off"]

    # insert target: first stop slot with E == p1, or p1 strictly inside
    inside = stop & (E <= p1) & (p1 < incl)
    target = inside | (stop & (E == p1))
    idx_t = _first_true(target, j, count)
    E_t = _min_where(target, E, big)
    incl_t = _min_where(target, incl, big)
    opoff_t = _min_where(target, opoff_comp, big) % OPOFF_BOUND
    found_t = idx_t < count
    off_ins = torch.where(found_t, p1 - E_t, zero)

    # range boundary splits, both on the pre-op view
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

    # two-insertion restructure
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
    names = SLOT_FIELDS + PROP_FIELDS + ("_stamp",)
    arrs = [st[f] for f in SLOT_FIELDS + PROP_FIELDS] + [fully_in.to(i32)]
    mv = {n: torch.where(m2, _shift_right(a, 2),
                         torch.where(m1, _shift_right(a, 1), a))
          for n, a in zip(names, arrs)}

    at_A = u1 & (j == A)
    at_B = u2 & (j == B)
    new_at_A = at_A & is_ins

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
        at_B, torch.where(is_ins, opoff_k1 + off_ins, opoff_k2 + off2),
        op_off)

    seq = torch.where(new_at_A, op["seq"], mv["seq"])
    cli = torch.where(new_at_A, client, mv["client"])
    removed_seq = torch.where(new_at_A, NOT_REMOVED, mv["removed_seq"])
    removers = torch.where(new_at_A, zero, mv["removers"])
    op_id = torch.where(new_at_A, op["op_id"], mv["op_id"])
    is_marker = torch.where(new_at_A, op["is_marker"], mv["is_marker"])
    props = [torch.where(new_at_A, zero, mv[f]) for f in PROP_FIELDS]

    # stamps, from the pre-op view
    stamp = mv["_stamp"] != 0
    stamp = stamp | (at_A & is_range) | (f_h2 & is_range)
    stamp = stamp & is_range & ~skip

    rmask = is_rem & stamp
    newly = rmask & (removed_seq == NOT_REMOVED)
    bit = torch.ones_like(client) << client  # 1 << 31 is bit 31
    removed_seq = torch.where(newly, op["seq"], removed_seq)
    removers = torch.where(rmask, removers | bit, removers)

    amask = is_ann & stamp
    props = [torch.where(amask & (op["prop_key"] == c), op["prop_val"], p)
             for c, p in enumerate(props)]

    out = {"length": length, "seq": seq, "client": cli,
           "removed_seq": removed_seq, "removers": removers,
           "op_id": op_id, "op_off": op_off, "is_marker": is_marker,
           "count": count + added * (1 - skip.to(i32)),
           "min_seq": torch.maximum(min_seq, op["min_seq"]),
           "overflow": torch.where(overflow_now, 1,
                                   st["overflow"]).to(i32)}
    out.update(zip(PROP_FIELDS, props))
    return out


def empty_state(docs: int, capacity: int, device="cpu") -> dict:
    st = {f: torch.zeros((docs, capacity), dtype=torch.int32, device=device)
          for f in SLOT_FIELDS + PROP_FIELDS}
    st["removed_seq"].fill_(NOT_REMOVED)
    st.update({f: torch.zeros((docs, 1), dtype=torch.int32, device=device)
               for f in DOC_FIELDS})
    return st


def as_table(st: dict) -> dict:
    """The state in the segment table's layout: the slot fields
    ``[D, C]``, ``prop`` ``[D, C, 4]``, the document fields ``[D]``."""
    out = {f: st[f].clone() for f in SLOT_FIELDS}
    out["prop"] = torch.stack([st[f] for f in PROP_FIELDS], dim=-1)
    out.update({f: st[f][:, 0].clone() for f in DOC_FIELDS})
    return out


def replay(sessions: list, clients: int, capacity: int, per_round: int,
           device="cpu") -> dict:
    """Every session as one document through the plain loop, round by
    round: ``tickets`` per session, ``tables`` the state after each round
    (``as_table`` form, one row per session) and ``live`` the live
    slot-steps of each round, ``[rounds, sessions]`` int64."""
    S = len(sessions)
    ticks = [tickets(s, clients) for s in sessions]
    n_rounds = -(-max(len(s["counts"]) for s in sessions) // per_round)
    st = empty_state(S, capacity, device)
    f_seq, f_msn = FIELDS.index("seq"), FIELDS.index("min_seq")
    tables, live = [], np.zeros((n_rounds, S), np.int64)
    for r in range(n_rounds):
        windows = []
        for s, (seq, msn, _) in zip(sessions, ticks):
            m0 = min(r * per_round, len(s["counts"]))
            m1 = min((r + 1) * per_round, len(s["counts"]))
            rows = s["rows"][s["row0"][m0]:s["row0"][m1]].copy()
            rows[:, f_seq] = np.repeat(seq[m0:m1], s["counts"][m0:m1])
            rows[:, f_msn] = np.repeat(msn[m0:m1], s["counts"][m0:m1])
            windows.append(rows)
        win = max(1, max(len(w) for w in windows))
        batch = np.zeros((S, win, len(FIELDS)), np.int32)
        batch[..., FIELDS.index("kind")] = 3
        for b, w in enumerate(windows):
            batch[b, :len(w)] = w
        cols = torch.from_numpy(batch).to(device)
        acc = torch.zeros(S, dtype=torch.int64, device=device)
        for w in range(win):
            op = {f: cols[:, w, k:k + 1] for k, f in enumerate(FIELDS)}
            acc += st["count"][:, 0].long() * (op["kind"][:, 0]
                                               <= KIND_ANNOTATE)
            st = fused_step(st, op)
        live[r] = acc.cpu().numpy()
        tables.append(as_table(st))
    return {"tickets": ticks, "tables": tables, "live": live}
