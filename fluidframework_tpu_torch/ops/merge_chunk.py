"""Chunked merge executor: up to K sequenced ops per document in one
macro-step. A port of the reference's ``ops/merge_chunk.py``.

Two halves:

1. HOST CHUNK COMPILER (``compile_chunks``, numpy). Within one chunk
   the only ops whose positions depend on other in-chunk ops are ops
   that can SEE them, and those are overwhelmingly same-client chains
   (a typing burst, a backspace run). A client's own chain is pure
   metadata: its view is the frozen base view at its refseq plus its
   own ops, so the host composes it exactly and rewrites each op's
   positions into frozen-base-view coordinates, emitting per op
   ``pred`` (the own insert this one lands right after), ``ev_cover``
   (own in-chunk inserts a range covers whole) and ``chunk_start``.
   A chunk closes where host arithmetic stops being exact: a
   cross-client dependency the later op can see, a same-client refseq
   advance mid-chain, an anchor strictly inside another op's text, or
   tombstone aging across min_seq. Worst case one op per chunk.

2. DEVICE MACRO-STEP (``apply_window_chunked``, plain torch). Per
   chunk: a per-lane view pass and prefix sum over the chunk-start
   state, a batched position resolve, the walk-order replay of events
   sharing an anchor, then the restructure as ONE stable sort over C
   base rows + 2K cut tails + K insert events, keyed (slot, offset,
   is_base, rank) packed into one int64. Range stamps are lexicographic
   key-interval tests masked by per-row visibility, with
   first-visible-remover-wins replayed across the chunk's removes.

Semantics contract: live slot state bit-identical to the scan executor
(``merge_kernel.apply_window``), except after a capacity overflow: the
scan keeps applying a flagged document's ops, this executor PARKS the
document at its pre-chunk state (the sidecar's snapshot re-apply makes
served state converge either way).

The reference loops macro-steps in an on-device ``lax.while_loop``
until every cursor has passed the window. Torch has no device loop,
and testing the cursors on the host would sync every step, so the
trip count is counted on the host from the compiled program
(``macro_steps``: one step per chunk of up to K lanes) and the loop
runs exactly that many steps; rows already at the window's end take
no-op steps.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import program_to_device
from .merge_step import DOC_FIELDS, state_to_table, table_to_state
from .segment_table import (
    KIND_ANNOTATE,
    KIND_INSERT,
    KIND_NOOP,
    KIND_REMOVE,
    NOT_REMOVED,
    PROP_CHANNELS,
    OpBatch,
    SegmentTable,
    check_donated,
    copy_into,
)

# extra per-op int32 arrays the chunk compiler emits alongside OpBatch
CHUNK_FIELDS = ("chunk_start", "pred", "ev_cover")

# every [D, W] array of a compiled chunk program, in block order
PROGRAM_FIELDS = OpBatch._fields + CHUNK_FIELDS

# Serving-side chunk length (<= 31 so ev_cover bitmasks fit int32).
CHUNK_K = 8

# "not found" filler of the masked min-reduces (above every position)
BIG = 2**30

_NOT_REMOVED = int(NOT_REMOVED)


def _host(a) -> np.ndarray:
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    # the sidecars compile host numpy; a tensor comes from a direct caller
    return a.cpu().numpy()  # synccheck: disable=cpu,numpy not the loop's


# ======================================================================
# host chunk compiler


class _Seg:
    """One segment of a client's own-view composition. ``base_len`` is
    the span's width in the client's FROZEN BASE VIEW (what the device
    resolves against); ``view_len`` its width in the client's current
    own view; ``ev_k`` >= 0 marks own in-chunk insert text (zero base
    width); ``rm_seq`` is the seq of the in-chunk remove that zeroed
    this segment's view (None = never removed), which lets the event
    walkers age tombstones out of the anchor walk."""

    __slots__ = ("base_len", "view_len", "ev_k", "rm_seq")

    def __init__(self, base_len, view_len, ev_k=-1):
        self.base_len = base_len
        self.view_len = view_len
        self.ev_k = ev_k
        self.rm_seq = None


class _Chain:
    """A client's own-op composition within the open chunk."""

    def __init__(self, refseq: int):
        self.refseq = refseq
        self.segs: list[_Seg] = []  # implicit infinite base tail after

    def _locate(self, pos: int, ms=None):
        """Own-view pos -> (seg index, offset, base coord). The walk
        stops at the FIRST zero-view segment once the position is
        consumed (a sequenced insert tie-breaks BEFORE zero-width slots
        at its point), unless ``ms`` is given and the segment is an
        in-chunk tombstone whose remove aged at/below it: then the walk
        passes through it. Index len(segs) = the infinite base tail."""
        base = 0
        rem = pos
        for i, s in enumerate(self.segs):
            if rem < s.view_len or (rem == 0 and s.view_len == 0):
                if ms is not None and s.view_len == 0 \
                        and s.rm_seq is not None and s.rm_seq <= ms:
                    base += s.base_len
                    continue
                return i, rem, base + (rem if s.ev_k < 0 else 0)
            rem -= s.view_len
            base += s.base_len
        return len(self.segs), rem, base + rem

    def map_insert(self, pos: int, length: int, k: int, ms=None):
        """Place own insert at own-view ``pos``. Returns
        (base_coord, pred, ok); ok False => the anchor falls strictly
        inside own event text (the chunk must break). ``ms`` is the
        op's exclusive min_seq watermark."""
        i, off, base = self._locate(pos, ms)
        if off > 0:
            if i < len(self.segs):
                seg = self.segs[i]
                if seg.ev_k >= 0:
                    return 0, -1, False
                tail = _Seg(seg.base_len - off, seg.view_len - off)
                seg.base_len = off
                seg.view_len = off
                self.segs.insert(i + 1, tail)
            else:
                self.segs.append(_Seg(off, off))
            i += 1
        # pred: nearest preceding own event within the zero-base run
        # just before the insertion point
        pred = -1
        q = i - 1
        while q >= 0 and self.segs[q].base_len == 0:
            if self.segs[q].ev_k >= 0:
                pred = self.segs[q].ev_k
                break
            q -= 1
        self.segs.insert(i, _Seg(0, length, ev_k=k))
        return base, pred, True

    def map_range(self, p1: int, p2: int):
        """Map own-view range [p1, p2) to base coords + fully-covered
        own events. Returns (b1, b2, cover_mask, ok)."""
        i1, o1, b1 = self._locate(p1)
        i2, o2, b2 = self._locate(p2)
        for idx, off in ((i1, o1), (i2, o2)):
            if idx < len(self.segs) and off > 0 \
                    and self.segs[idx].ev_k >= 0:
                return 0, 0, 0, False
        cover = 0
        i, off, _ = self._locate(p1)
        rem = p2 - p1
        while rem > 0 and i < len(self.segs):
            s = self.segs[i]
            avail = s.view_len - off
            if avail > 0:
                take = min(avail, rem)
                if s.ev_k >= 0 and off == 0 and take == s.view_len:
                    cover |= 1 << s.ev_k
                rem -= take
            off = 0
            i += 1
        return b1, b2, cover, True

    def apply_remove(self, p1: int, p2: int, seq=None) -> None:
        """Materialize own remove in the own view (base widths stay:
        the device counts the text until the chunk materializes).
        ``seq`` stamps the zeroed segments' ``rm_seq``."""
        for p in (p2, p1):  # split p2 first so indices stay valid
            i, off, _ = self._locate(p)
            if off > 0 and i < len(self.segs):
                seg = self.segs[i]
                assert seg.ev_k < 0, "event split rejected earlier"
                tail = _Seg(seg.base_len - off, seg.view_len - off)
                seg.base_len = off
                seg.view_len = off
                self.segs.insert(i + 1, tail)
            elif off > 0:
                self.segs.append(_Seg(off, off))
        i, off, _ = self._locate(p1)
        rem = p2 - p1
        while rem > 0 and i < len(self.segs):
            s = self.segs[i]
            if s.view_len:
                take = min(s.view_len - off, rem)
                if off == 0:
                    rem -= s.view_len if s.view_len <= rem else rem
                    s.view_len = max(0, s.view_len - take)
                    if s.view_len == 0:
                        s.rm_seq = seq
                else:  # pragma: no cover - boundaries were split
                    rem -= take
            off = 0
            i += 1


def compile_chunks(arrays: dict, k_max: int = CHUNK_K) -> dict:
    """Rewrite [D, W] OpBatch field arrays into chunked form (positions
    in frozen-base-view coordinates) + CHUNK_FIELDS. Pure numpy/host.
    ``k_max`` caps chunk length (it must match the device K; <= 31 so
    ev_cover bitmasks fit int32)."""
    assert 1 <= k_max <= 31
    kind = _host(arrays["kind"])
    D, W = kind.shape
    out = {f: np.array(_host(arrays[f]), np.int32, copy=True)
           for f in OpBatch._fields}
    chunk_start = np.zeros((D, W), np.int32)
    pred = np.full((D, W), -1, np.int32)
    ev_cover = np.zeros((D, W), np.int32)

    # all-NOOP rows need no chain analysis: a boundary every k_max lanes
    active = np.flatnonzero((kind != KIND_NOOP).any(axis=1))
    idle_mask = np.ones(D, np.bool_)
    idle_mask[active] = False
    chunk_start[idle_mask, ::k_max] = 1

    for d in active:
        chains: dict[int, _Chain] = {}
        chunk: list[int] = []   # window indices of the open chunk
        base_w = 0              # chunk start window index
        ms_run = 0              # running max min_seq within chunk
        ms_global = 0           # max min_seq over ALL ops before w
        ms_base = 0             # ms_global when the chunk opened
        rm_committed: list[int] = []  # remove seqs of CLOSED chunks
        rm_open: list[int] = []       # remove seqs in the open chunk

        def fresh(w):
            nonlocal chains, chunk, base_w, ms_run, ms_base
            chunk_start[d, w] = 1
            chains = {}
            chunk = []
            base_w = w
            ms_run = 0
            ms_base = ms_global
            rm_committed.extend(rm_open)  # stays seq-sorted: stream order
            rm_open.clear()

        fresh(0)
        for w in range(W):
            kd = kind[d, w]
            if kd == KIND_NOOP:
                if len(chunk) >= k_max:
                    fresh(w)
                chunk.append(w)
                ms_run = max(ms_run, int(out["min_seq"][d, w]))
                ms_global = max(ms_global, int(out["min_seq"][d, w]))
                continue
            cli = int(out["client"][d, w])
            ref = int(out["refseq"][d, w])
            ms_k = max(ms_run, int(out["min_seq"][d, w]))

            def must_break():
                if len(chunk) >= k_max:
                    return True
                # a committed tombstone aged across min_seq since the
                # chunk opened: this insert's stop mask (hence anchor
                # slot) differs from earlier in-chunk events', and the
                # same-anchor rank group would split across it.
                # ms_global excludes op w's own min_seq (the step
                # applies an op's min_seq after its view pass)
                if kd == KIND_INSERT and ms_global > ms_base and \
                        bisect_right(rm_committed, ms_global) > \
                        bisect_right(rm_committed, ms_base):
                    return True
                for i in chunk:
                    ki = kind[d, i]
                    if ki == KIND_NOOP or ki == KIND_ANNOTATE:
                        continue
                    same = int(out["client"][d, i]) == cli
                    seen = same or int(out["seq"][d, i]) <= ref
                    if not same and seen:
                        return True  # cross-client visible ins/rm
                    if ki == KIND_REMOVE and \
                            int(out["seq"][d, i]) <= ms_k:
                        return True  # tombstone ages into "below"
                ch = chains.get(cli)
                if ch is not None and ch.segs and ch.refseq != ref:
                    return True  # frozen base view changed mid-chain
                return False

            if must_break():
                fresh(w)
            chain = chains.get(cli)
            if chain is None:
                chain = chains[cli] = _Chain(ref)
            chain.refseq = ref

            if kd == KIND_INSERT:
                b, pr, ok = chain.map_insert(
                    int(out["pos1"][d, w]),
                    int(out["length"][d, w]), w - base_w)
                if not ok:
                    fresh(w)
                    chain = chains[cli] = _Chain(ref)
                    b, pr, ok = chain.map_insert(
                        int(out["pos1"][d, w]),
                        int(out["length"][d, w]), 0)
                    assert ok
                out["pos1"][d, w] = b
                pred[d, w] = pr
            else:
                p1 = int(out["pos1"][d, w])
                p2 = int(out["pos2"][d, w])
                b1, b2, cover, ok = chain.map_range(p1, p2)
                if not ok:
                    fresh(w)
                    chain = chains[cli] = _Chain(ref)
                    b1, b2, cover, ok = chain.map_range(p1, p2)
                    assert ok
                out["pos1"][d, w] = b1
                out["pos2"][d, w] = b2
                ev_cover[d, w] = cover
                if kd == KIND_REMOVE:
                    chain.apply_remove(p1, p2)
                    rm_open.append(int(out["seq"][d, w]))
            chunk.append(w)
            ms_run = ms_k
            ms_global = max(ms_global, int(out["min_seq"][d, w]))

    out["chunk_start"] = chunk_start
    out["pred"] = pred
    out["ev_cover"] = ev_cover
    return out


def build_chunked(batch: OpBatch, K: int = CHUNK_K) -> dict:
    """OpBatch (numpy or tensors) -> compiled chunk program (host)."""
    return compile_chunks(
        {f: _host(getattr(batch, f)) for f in OpBatch._fields}, k_max=K)


def macro_steps(chunk_start, K: int) -> int:
    """Host: the most macro-steps any row of a compiled program takes.
    A step consumes lanes from the row's cursor up to (not including)
    the next ``chunk_start`` flag, at most K of them; lanes past the
    window read as chunk starts. So a chunk of n lanes takes
    ceil(n / K) steps (one, when K matches the compile's k_max), and a
    row's first lane opens a chunk whether flagged or not. An
    overflowed row parks early and takes fewer."""
    starts = _host(chunk_start) > 0
    D, W = starts.shape
    if D == 0 or W == 0:
        return 0
    starts = starts.copy()
    starts[:, 0] = True
    rows, cols = np.nonzero(starts)
    same_row = np.append(rows[1:] == rows[:-1], False)
    ends = np.where(same_row, np.append(cols[1:], W), W)
    per_chunk = -(-(ends - cols) // K)
    return int(np.bincount(rows, weights=per_chunk, minlength=D).max())


# ======================================================================
# device macro-step (plain torch)


def _gather_ops(block: torch.Tensor, cursor: torch.Tensor, K: int) -> dict:
    """The next K lanes per doc from the [F, D, W] program block, as a
    dict of [D, K]. Beyond-window lanes read as NOOP chunk starts (they
    stop the take); their other fields repeat lane W-1 (clamped)."""
    n_fields, D, W = block.shape
    idx = cursor[:, None] + torch.arange(
        K, dtype=torch.int32, device=block.device)[None]
    cidx = idx.clamp(max=W - 1).long()
    lanes = torch.gather(block, 2, cidx[None].expand(n_fields, D, K))
    out = dict(zip(PROGRAM_FIELDS, lanes.unbind(0)))
    off_end = idx >= W
    out["kind"] = torch.where(off_end, KIND_NOOP, out["kind"])
    out["chunk_start"] = torch.where(off_end, 1, out["chunk_start"])
    return out


def _take(ops: dict, K: int):
    """Lanes before the next chunk boundary: (lane iota [1, K],
    take_upto [D], taken [D, K], kind with untaken lanes as NOOP)."""
    kidx = torch.arange(K, dtype=torch.int32,
                        device=ops["kind"].device)[None]
    take_upto = torch.where(
        (ops["chunk_start"] > 0) & (kidx > 0), kidx, K).amin(dim=-1)
    taken = kidx < take_upto[:, None]
    kind = torch.where(taken, ops["kind"], KIND_NOOP)
    return kidx, take_upto, taken, kind


def _ms_pre(min_seq: torch.Tensor, ops: dict,
            taken: torch.Tensor) -> torch.Tensor:
    """[D, K] exclusive running max of the taken lanes' min_seq over the
    doc's min_seq: the step applies an op's min_seq after its view
    pass, so lane k sees the watermark of lanes < k."""
    inc = torch.cummax(torch.where(taken, ops["min_seq"], 0), dim=1).values
    return torch.maximum(min_seq[:, None], F.pad(inc[:, :-1], (1, 0)))


def _rank_replay(a_slot, a_off, ev_valid, pred, K: int) -> torch.Tensor:
    """Rank of each insert event within its (anchor slot, offset) group,
    replaying the walk's insertion order: event t lands right after
    its host-computed ``pred`` event, else at the anchor's front."""
    lane = torch.arange(K, device=a_slot.device)[None]
    rank = torch.zeros_like(a_slot)
    same_anchor = ((a_slot[:, :, None] == a_slot[:, None, :])
                   & (a_off[:, :, None] == a_off[:, None, :]))  # [D,e,t]
    for t in range(K):
        pr = pred[:, t]
        pr_rank = torch.where(
            pr >= 0,
            rank.gather(1, pr.clamp(min=0).long()[:, None])[:, 0] + 1, 0)
        placing = ev_valid[:, t]
        bump = (same_anchor[:, :, t] & ev_valid & (lane < t)
                & (rank >= pr_rank[:, None]) & placing[:, None])
        rank = rank + bump.to(torch.int32)
        rank[:, t] = torch.where(placing, pr_rank, 0)
    return rank


def _cuts(C: int, K: int, ev_valid, a_slot, a_off, range_taken,
          s1, r1s, r1o, s2, r2s, r2o):
    """Boundary cuts strictly inside a row (insert anchors, range
    ends), deduplicated on (slot, offset), each with the next cut
    offset in the same row. Returns [D, 2K] (slot, off, valid, next)."""
    ins_cut = ev_valid & (a_off > 0)
    r1_cut = range_taken & s1 & (r1o > 0)
    r2_cut = range_taken & s2 & (r2o > 0)
    cut_slot = torch.cat([
        torch.where(ins_cut, a_slot, torch.where(r1_cut, r1s, C)),
        torch.where(r2_cut, r2s, C),
    ], dim=-1)
    cut_off = torch.cat([
        torch.where(ins_cut, a_off, torch.where(r1_cut, r1o, 0)),
        torch.where(r2_cut, r2o, 0),
    ], dim=-1)
    cut_valid = torch.cat([ins_cut | r1_cut, r2_cut], dim=-1)
    # dedupe identical (slot, off): keep the earliest entry
    lane = torch.arange(2 * K, device=a_slot.device)
    dup = ((cut_slot[:, :, None] == cut_slot[:, None, :])
           & (cut_off[:, :, None] == cut_off[:, None, :])
           & cut_valid[:, :, None] & cut_valid[:, None, :]
           & (lane[None, :, None] < lane[None, None, :]))  # [D,i,j]
    cut_valid = cut_valid & ~dup.any(dim=1)
    cut_slot = torch.where(cut_valid, cut_slot, C)
    cut_off = torch.where(cut_valid, cut_off, 0)
    same_row = cut_slot[:, :, None] == cut_slot[:, None, :]
    higher = cut_off[:, None, :] > cut_off[:, :, None]
    next_off = torch.where(same_row & higher & cut_valid[:, None, :],
                           cut_off[:, None, :], BIG).amin(dim=-1)
    return cut_slot, cut_off, cut_valid, next_off


def _rows(st: dict, ops: dict, K: int, kidx, ev_valid, a_slot, a_off,
          rank, cut_slot, cut_off, cut_valid, next_off) -> dict:
    """The restructure's row tables [D, R = C + 3K]: C base rows (heads
    shortened to their first cut), 2K cut tails (fields of the parent
    row, read by gather), K insert events; plus the sort keys and the
    fragment extents the stamps test."""
    D, C = st["length"].shape
    dev = st["length"].device
    i32 = torch.int32
    z = {n: torch.zeros((D, n), dtype=i32, device=dev) for n in (C, 2 * K, K)}
    one = {n: torch.ones((D, n), dtype=i32, device=dev) for n in (C, 2 * K)}

    def rows(base, tail, event):
        return torch.cat([base, tail, event], dim=-1)

    # invalid cuts read a clamped row: their sort key (slot C+1) parks
    # them past every live row, and no stamp reads them
    cut_clamped = cut_slot.clamp(max=C - 1).long()

    def row_at(field):
        return field.gather(1, cut_clamped)

    tail_len = torch.minimum(next_off, row_at(st["length"])) - cut_off
    # head shortening: a base row's new length is its smallest cut offset
    head_len = st["length"].scatter_reduce(
        1, cut_clamped, torch.where(cut_valid, cut_off, BIG),
        reduce="amin", include_self=True)
    j = torch.arange(C, dtype=i32, device=dev).expand(D, C)
    r = {
        "key_slot": rows(j, torch.where(cut_valid, cut_slot, C + 1),
                         torch.where(ev_valid, a_slot, C + 1)),
        "key_off": rows(z[C], cut_off, torch.where(ev_valid, a_off, 0)),
        "key_base": rows(one[C], one[2 * K], z[K]),
        "key_rank": rows(z[C], z[2 * K], rank),
        "length": rows(head_len, tail_len,
                       torch.where(ev_valid, ops["length"], 0)),
        "seq": rows(st["seq"], row_at(st["seq"]), ops["seq"]),
        "client": rows(st["client"], row_at(st["client"]), ops["client"]),
        "removed_seq": rows(
            st["removed_seq"],
            torch.where(cut_valid, row_at(st["removed_seq"]), _NOT_REMOVED),
            torch.full((D, K), _NOT_REMOVED, dtype=i32, device=dev)),
        "removers": rows(st["removers"], row_at(st["removers"]), z[K]),
        "op_id": rows(st["op_id"], row_at(st["op_id"]), ops["op_id"]),
        "op_off": rows(st["op_off"], row_at(st["op_off"]) + cut_off, z[K]),
        "is_marker": rows(st["is_marker"], row_at(st["is_marker"]),
                          ops["is_marker"]),
        # fragment extent [lo, hi) in parent-row offsets, for stamps
        "frag_lo": rows(z[C], cut_off, z[K]),
        "is_event": rows(z[C], z[2 * K], ev_valid.to(i32)),
        "ev_bit": rows(z[C], z[2 * K], kidx.expand(D, K)),
        "live": rows(j < st["count"][:, None], cut_valid, ev_valid),
    }
    for c in range(PROP_CHANNELS):
        f = f"prop{c}"
        r[f] = rows(st[f], row_at(st[f]), z[K])
    r["frag_hi"] = r["frag_lo"] + r["length"]
    return r


def _ev_stamp(ops: dict, r: dict, range_taken) -> torch.Tensor:
    """[D, R, K] event rows a range op covers whole, from the host
    ``ev_cover`` bitmask (bit k = in-chunk event lane k)."""
    cover = ((ops["ev_cover"][:, None, :] >> r["ev_bit"][:, :, None])
             & 1) > 0
    return cover & (r["is_event"][:, :, None] > 0) & range_taken[:, None, :]


def _lww_props(r: dict, ops: dict, ann_eff, K: int) -> list:
    """Per channel, the value of the LAST effective annotate lane on
    each row (lane order is sequenced order within a chunk)."""
    lane = torch.arange(K, dtype=torch.int32, device=ann_eff.device)
    out = []
    for c in range(PROP_CHANNELS):
        cand = ann_eff & (ops["prop_key"][:, None, :] == c)
        win_k = torch.where(cand, lane, -1).amax(dim=-1)  # [D,R]
        win_val = ops["prop_val"].gather(1, win_k.clamp(min=0).long())
        out.append(torch.where(win_k >= 0, win_val, r[f"prop{c}"]))
    return out


def _finish(st: dict, ops: dict, K: int, r: dict, taken, ev_valid,
            cut_valid, new_removed, new_removers, new_props):
    """Count the adds, flag overflow, sort the rows and write the first
    C of them back — except on overflowed docs, which PARK at their
    pre-chunk state. Returns the new state."""
    D, C = st["length"].shape
    adds = ev_valid.sum(dim=-1, dtype=torch.int32) + cut_valid.sum(
        dim=-1, dtype=torch.int32)
    new_count = st["count"] + adds
    overflow_now = new_count > C
    keep = ~overflow_now[:, None]

    # ONE stable sort: (slot, off, is_base, rank) packed into one int64
    # key. All four are non-negative; slot <= C+1, off < 2**31,
    # is_base is one bit and rank < K <= 31, so the packing orders
    # exactly like the lexicographic four-key sort.
    minor = ((r["key_off"].long() * 2 + r["key_base"]) * K
             + r["key_rank"])
    key = (r["key_slot"].long() << 40) | minor
    perm = torch.sort(key, dim=-1, stable=True).indices

    head = perm[:, :C]

    def upd(old, new):
        return torch.where(keep, new.gather(1, head), old)

    out = {
        "length": upd(st["length"], r["length"]),
        "seq": upd(st["seq"], r["seq"]),
        "client": upd(st["client"], r["client"]),
        "removed_seq": upd(st["removed_seq"], new_removed),
        "removers": upd(st["removers"], new_removers),
        "op_id": upd(st["op_id"], r["op_id"]),
        "op_off": upd(st["op_off"], r["op_off"]),
        "is_marker": upd(st["is_marker"], r["is_marker"]),
        "count": torch.where(overflow_now, st["count"], new_count),
        "min_seq": torch.maximum(
            st["min_seq"],
            torch.where(taken, ops["min_seq"], 0).amax(dim=-1)),
        "overflow": torch.where(overflow_now, 1, st["overflow"]),
    }
    for c in range(PROP_CHANNELS):
        out[f"prop{c}"] = upd(st[f"prop{c}"], new_props[c])
    return out, overflow_now


def _macro_step(st: dict, ops: dict, K: int):
    """Apply one chunk of up to K ops per document. Returns (new state,
    consumed lanes [D], overflowed now [D])."""
    D, C = st["length"].shape
    dev = st["length"].device
    i32 = torch.int32
    kidx, take_upto, taken, kind = _take(ops, K)
    is_ins = kind == KIND_INSERT
    is_rem = kind == KIND_REMOVE
    is_ann = kind == KIND_ANNOTATE
    range_taken = (is_rem | is_ann) & taken

    # ---- per-op view pass vs the chunk-start state: [D, K, C] --------
    j3 = torch.arange(C, dtype=i32, device=dev).view(1, 1, C)
    count = st["count"][:, None]                           # [D,1]
    seq3 = st["seq"][:, None, :]
    rseq3 = st["removed_seq"][:, None, :]
    refseq = ops["refseq"][..., None]                      # [D,K,1]
    client = ops["client"][..., None]
    ms_pre = _ms_pre(st["min_seq"], ops, taken)            # [D,K]

    alive = j3 < count[..., None]
    removed = rseq3 != _NOT_REMOVED
    below = removed & (rseq3 <= ms_pre[..., None])
    # removers holds the int32 bits of the reference's uint32: the
    # arithmetic shift leaves bit c at bit 0 all the same
    rm_by_viewer = ((st["removers"][:, None, :] >> client) & 1) > 0
    removal_visible = removed & ((rseq3 <= refseq) | rm_by_viewer)
    insert_visible = (seq3 <= refseq) | (st["client"][:, None, :] == client)
    vis = alive & ~below & insert_visible & ~removal_visible
    stop = alive & ~below
    vlen = torch.where(vis, st["length"][:, None, :], 0)   # [D,K,C]
    # dtype=int32: torch's integer cumsum otherwise widens to int64
    E = torch.cumsum(vlen, dim=-1, dtype=i32) - vlen
    incl = E + vlen
    total = incl[..., -1]                                  # [D,K]

    # ---- batched resolve (masked min-reduces) -------------------------
    p1 = ops["pos1"][..., None]
    p2 = ops["pos2"][..., None]
    target = stop & (((E <= p1) & (p1 < incl)) | (E == p1))
    idx_t = torch.where(target, j3, count[..., None]).amin(dim=-1)
    E_t = torch.where(target, E, BIG).amin(dim=-1)
    t_found = idx_t < count
    ev_valid = is_ins & (ops["pos1"] <= total) & taken
    a_slot = torch.where(t_found, idx_t, count)            # [D,K]
    a_off = torch.where(t_found, ops["pos1"] - E_t, 0)

    def split_at(p, pos):
        """First row strictly containing ``p`` (slot, offset, found),
        else the first row with E >= p (count if none), offset 0."""
        strict = (E < p) & (p < incl)
        i = torch.where(strict, j3, C).amin(dim=-1)
        e = torch.where(strict, E, BIG).amin(dim=-1)
        s = i < C
        jn = torch.where(E >= p, j3, count[..., None]).amin(dim=-1)
        return s, torch.where(s, i, jn), torch.where(s, pos - e, 0)

    s1, r1s, r1o = split_at(p1, ops["pos1"])
    s2, r2s, r2o = split_at(p2, ops["pos2"])

    rank = _rank_replay(a_slot, a_off, ev_valid, ops["pred"], K)
    cut_slot, cut_off, cut_valid, next_off = _cuts(
        C, K, ev_valid, a_slot, a_off, range_taken,
        s1, r1s, r1o, s2, r2s, r2o)
    r = _rows(st, ops, K, kidx, ev_valid, a_slot, a_off, rank,
              cut_slot, cut_off, cut_valid, next_off)

    # ---- stamps in key space ------------------------------------------
    # per (row, range op): lexicographic containment of the fragment in
    # [(r1s, r1o), (r2s, r2o)), masked by the row's visibility to the op
    ks = r["key_slot"][:, :, None]                         # [D,R,1]
    lo = r["frag_lo"][:, :, None]
    hi = r["frag_hi"][:, :, None]
    a1s, a1o = r1s[:, None, :], r1o[:, None, :]            # [D,1,K]
    a2s, a2o = r2s[:, None, :], r2o[:, None, :]
    in_interval = (((ks > a1s) | ((ks == a1s) & (lo >= a1o)))
                   & ((ks < a2s) | ((ks == a2s) & (hi <= a2o)))
                   & (r["is_event"][:, :, None] == 0))
    refk = ops["refseq"][:, None, :]
    clik = ops["client"][:, None, :]
    rr = r["removed_seq"][:, :, None]
    r_removed = rr != _NOT_REMOVED
    row_below = r_removed & (rr <= ms_pre[:, None, :])
    row_rm_vis = r_removed & (
        (rr <= refk) | (((r["removers"][:, :, None] >> clik) & 1) > 0))
    row_ins_vis = (r["seq"][:, :, None] <= refk) | (
        r["client"][:, :, None] == clik)
    row_vis = (r["live"][:, :, None] & ~row_below & row_ins_vis
               & ~row_rm_vis & (r["length"][:, :, None] > 0))
    raw_stamp = ((in_interval & row_vis & range_taken[:, None, :])
                 | _ev_stamp(ops, r, range_taken))         # [D,R,K]

    # first-visible-remover-wins across the chunk's removes: a remove
    # is suppressed on rows an earlier unsuppressed remove it can SEE
    # already took; invisible overlaps both stamp
    visp = ((ops["seq"][:, :, None] <= ops["refseq"][:, None, :])
            | (ops["client"][:, :, None] == ops["client"][:, None, :]))
    rm_taken = is_rem & taken
    lane = torch.arange(K, device=dev)[None]
    eff = torch.zeros_like(raw_stamp)
    for t in range(K):
        prior = visp[:, :, t] & (lane < t) & rm_taken      # [D,i]
        stamped_before = (eff & prior[:, None, :]).any(dim=-1)
        eff[:, :, t] = raw_stamp[:, :, t] & ~stamped_before
    rm_eff = eff & rm_taken[:, None, :]
    ann_eff = eff & (is_ann & taken)[:, None, :]

    first_rm_seq = torch.where(
        rm_eff, ops["seq"][:, None, :], BIG).amin(dim=-1)
    new_removed = torch.where(
        (r["removed_seq"] == _NOT_REMOVED) & rm_eff.any(dim=-1),
        first_rm_seq, r["removed_seq"])
    # per (row, client) at most one effective remove stamps, so the
    # bit union is the reference's uint32 sum: summed in int64 and
    # wrapped back to the int32 bit pattern
    bit = torch.ones_like(ops["client"], dtype=torch.int64) << ops[
        "client"].long()
    bits = torch.where(rm_eff, bit[:, None, :], 0).sum(dim=-1) & 0xFFFFFFFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(i32)
    new_removers = r["removers"] | bits

    new_props = _lww_props(r, ops, ann_eff, K)
    out, overflow_now = _finish(st, ops, K, r, taken, ev_valid, cut_valid,
                                new_removed, new_removers, new_props)
    return out, take_upto, overflow_now


# ======================================================================
# the macro-step loop

Step = Callable[[dict, dict, int], tuple]


def _chunk_state(table: SegmentTable) -> dict:
    st = table_to_state(table)
    # doc-scalar fields flat [D] in the macro-step executors
    for f in DOC_FIELDS:
        st[f] = st[f][..., 0]
    return st


def _chunk_unstate(st: dict) -> SegmentTable:
    st = dict(st)
    for f in DOC_FIELDS:
        st[f] = st[f][..., None]
    return state_to_table(st)


def run_macro_steps(table: SegmentTable, program: dict, K: int,
                    step: Step, steps: int | None = None):
    """Apply a compiled macro-step program (``PROGRAM_FIELDS`` arrays,
    numpy or tensors) to ``table`` with ``step`` (``_macro_step`` or
    the walker's), running exactly ``steps`` macro-steps (default:
    ``macro_steps`` of the program, counted on the host). Returns the
    new table and each row's final cursor, which the host bound leaves
    at the window's end. On a CUDA table nothing here waits for the
    device: pass ``steps`` with a program already on the device."""
    if steps is None:
        steps = macro_steps(program["chunk_start"], K)
    ops_w = program_to_device(
        {f: program[f] for f in PROGRAM_FIELDS}, table.device)
    block = torch.stack([ops_w[f] for f in PROGRAM_FIELDS])  # [F,D,W]
    W = block.shape[-1]
    st = _chunk_state(table)
    cursor = torch.zeros(table.docs, dtype=torch.int32, device=table.device)
    for _ in range(steps):
        running = (cursor < W).any()
        st2, take, over = step(st, _gather_ops(block, cursor, K), K)
        # the reference's while-loop stops once every cursor sits at W;
        # a further step here changes nothing but min_seq (lane W-1's
        # again, on a parked row), so keep that too
        st2["min_seq"] = torch.where(running, st2["min_seq"], st["min_seq"])
        st = st2
        cursor = torch.where(over, W, cursor + take).clamp(max=W)
    return _chunk_unstate(st), cursor


def apply_window_chunked(table: SegmentTable, chunked: dict,
                         K: int = CHUNK_K,
                         steps: int | None = None) -> SegmentTable:
    """Apply a compiled chunk program (``compile_chunks`` output) to the
    table; returns a new table. ``K`` must equal the compile's k_max."""
    return run_macro_steps(table, chunked, K, _macro_step, steps)[0]


def apply_window_chunked_pingpong(dead: SegmentTable | None,
                                  table: SegmentTable, chunked: dict,
                                  K: int = CHUNK_K,
                                  steps: int | None = None) -> SegmentTable:
    """Double-buffered twin of ``apply_window_chunked``: the result is
    written into ``dead`` (a retired table of the same shape, never
    read), while ``table`` survives as the caller's pre-dispatch
    snapshot. The macro-steps build new tensors each step, so the final
    state is copied into ``dead``'s storage, one ``copy_`` per field.
    ``dead=None`` is the plain call. Raises ``ValueError`` if ``dead``
    differs in shape or shares storage with an input."""
    if dead is None:
        return apply_window_chunked(table, chunked, K=K, steps=steps)
    check_donated(dead, table, chunked)
    return copy_into(dead, apply_window_chunked(table, chunked, K=K,
                                                steps=steps))


def compiled_window(table: SegmentTable, chunked: dict,
                    K: int = CHUNK_K) -> tuple:
    """The counterpart of the reference's ``compiled_window`` for the
    chunked route: ``(fn, args, cost)`` where ``fn(*args)`` is exactly
    the dispatch ``apply_window_chunked`` makes at this ``K`` (the
    macro-step count counted on the host, as the sidecar passes it) and
    ``cost`` is the window's ``WindowCost`` (``ops/window_cost.py``) on
    the program's op batch — the same reckoning every route reads."""
    from .window_cost import window_cost

    batch = OpBatch(**program_to_device(
        {f: chunked[f] for f in OpBatch._fields}, table.device))
    steps = macro_steps(chunked["chunk_start"], K)
    return (apply_window_chunked, (table, chunked, K, steps),
            window_cost(table, batch))
