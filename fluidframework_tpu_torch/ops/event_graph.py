"""Event-graph merge executor: the vectorized Eg-walker route. A port
of the reference's ``ops/event_graph.py``.

"Collaborative Text Editing with Eg-walker" (arXiv 2409.14252) walks
the concurrent-op event graph: at a *critical version* (one every later
op has seen) ops apply directly to the document, and re-preparing the
state for an op's own version is paid only across concurrent spans.

1. EVENT GRAPH (``build_event_graph``, host, numpy). In a sequenced
   stream an op's causal past is ``{seq <= refseq}`` plus its own prior
   ops, so op *w* by client *c* is critical iff ``refseq[w] >=
   frontier_other[w]``, the max seq of any prior op from ANOTHER client
   (the pre-window history enters through a per-row ``base_head``
   watermark). Each document's window splits at its first non-critical
   op: the critical PREFIX is composed on the host by one shared span
   chain (``merge_chunk._Chain``, cross-client: every op of a critical
   span sees every earlier one); the concurrent SUFFIX is left raw.

2. WALKER (``apply_window_egwalker``, plain torch): the prefix in
   macro-steps of up to ``EG_K`` ops. Every op of a span sees the same
   full-visibility view of the span-base state (``alive & ~removed``),
   so one [D, C] view pass and prefix sum serve every lane, and
   first-visible-remover-wins collapses to first-remover-wins. The
   restructure is the chunked step's.

3. SUFFIX: ``merge_kernel.apply_window``, the scan route: on a CUDA
   table that is the Hopper window kernel, which launches or raises.

Semantics contract: live slot state bit-identical to the scan executor,
with the chunked executor's overflow semantics (a document whose span
would exceed capacity is flagged and parked at its pre-span state).
"""
from __future__ import annotations

from bisect import bisect_right
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..convert import batch_from_numpy
from .bucket_ladder import BucketLadder
from .merge_chunk import (
    BIG,
    _NOT_REMOVED,
    _Chain,
    _cuts,
    _ev_stamp,
    _finish,
    _host,
    _lww_props,
    _ms_pre,
    _rank_replay,
    _rows,
    _take,
    run_macro_steps,
)
from .merge_kernel import apply_window
from .segment_table import (
    KIND_ANNOTATE,
    KIND_INSERT,
    KIND_NOOP,
    KIND_REMOVE,
    OpBatch,
    SegmentTable,
)

# The sidecar's executor routes: one registry, validated loudly.
EXECUTOR_ROUTES = ("scan", "chunked", "egwalker")

# Walker macro-step lane count (<= 31: the ev_cover bitmask is int32).
EG_K = 16


def validate_executor(route: Optional[str], source: str,
                      routes: tuple = EXECUTOR_ROUTES) -> None:
    """Raise ``ValueError`` unless ``route`` is None or a known route:
    an emergency route change must never silently not happen."""
    if route is not None and route not in routes:
        raise ValueError(
            f"{source}={route!r}: expected one of "
            f"{'|'.join(repr(r) for r in routes)}"
        )


class EventGraph(NamedTuple):
    """SoA event graph of one dispatch window, arrays [docs, window]
    (int32 unless noted)."""

    parent_seq: np.ndarray      # other-client parent head (= refseq)
    parent_own: np.ndarray      # window index of own prior op, -1
    frontier_other: np.ndarray  # max prior other-client seq (+ history)
    critical: np.ndarray        # 1 iff the op saw everything before it
    prefix_len: np.ndarray      # [docs] critical-prefix length


# ======================================================================
# host half: graph construction + critical-span composition


def _graph_arrays(kind, seq, refseq, client, base_head):
    """One pass per active row: frontier, parents, criticality. Seqs
    ascend in stream order, so the max-other-client-seq frontier is a
    top-2-by-distinct-client running pair; ``base_head`` counts as
    another client's head (conservative: it can demote an op to the
    suffix, never promote one)."""
    D, W = kind.shape
    parent_seq = np.array(refseq, np.int32)
    parent_own = np.full((D, W), -1, np.int32)
    frontier_other = np.zeros((D, W), np.int32)
    critical = np.ones((D, W), np.bool_)
    active = np.flatnonzero((kind != KIND_NOOP).any(axis=1))
    for d in active:
        top1_seq = int(base_head[d])
        top1_cli = -1
        top2_seq = int(base_head[d])
        last_own: dict[int, int] = {}
        for w in range(W):
            if kind[d, w] == KIND_NOOP:
                continue
            c = int(client[d, w])
            s = int(seq[d, w])
            other = top2_seq if c == top1_cli else top1_seq
            frontier_other[d, w] = other
            parent_own[d, w] = last_own.get(c, -1)
            critical[d, w] = int(refseq[d, w]) >= other
            if c == top1_cli:
                top1_seq = s
            else:
                top2_seq = top1_seq
                top1_seq = s
                top1_cli = c
            last_own[c] = w
    return parent_seq, parent_own, frontier_other, critical


def _compile_span_row(out, chunk_start, pred, ev_cover, span_splits,
                      d: int, k_max: int) -> None:
    """Compose one document's critical prefix into spans with ONE
    shared chain, rewriting positions into span-base coordinates in
    place and emitting chunk_start/pred/ev_cover.

    Where the chunk compiler breaks on min_seq aging, this compiler
    SPLITS THE EVENT and keeps composing (Eg-walker's internal-run
    split): an open-span tombstone aging out of the stop set is passed
    through by ``_Chain._locate`` with the exclusive ``ms`` watermark,
    and a committed tombstone crossing min_seq is resolved by the
    device's per-lane ``ms_pre`` stop mask, unless an earlier in-span
    insert shares the exact anchor coordinate (then the span breaks).
    Every absorbed break counts into ``span_splits[d]``. Breaks that
    remain: the ``k_max`` lane cap, an anchor strictly inside another
    in-span op's text, and that aging collision."""
    kind = out["kind"]
    W = kind.shape[1]
    chain = _Chain(0)
    chunk: list[int] = []
    base_w = 0
    ms_run = 0
    ms_global = 0
    ms_base = 0
    ms_counted = 0
    rm_committed: list[int] = []   # remove seqs of CLOSED spans
    rm_open: list[int] = []        # remove seqs in the open span
    ins_coords: set = set()        # base coords of in-span inserts

    def fresh(w: int) -> None:
        nonlocal chain, chunk, base_w, ms_run, ms_base, ms_counted
        chunk_start[d, w] = 1
        chain = _Chain(0)
        chunk = []
        base_w = w
        ms_run = 0
        ms_base = ms_global
        ms_counted = ms_global
        rm_committed.extend(rm_open)  # stays seq-sorted: stream order
        rm_open.clear()
        ins_coords.clear()

    def committed_aged(lo: int) -> bool:
        """Did min_seq cross a committed remove's seq since ``lo``?"""
        return ms_global > lo and \
            bisect_right(rm_committed, ms_global) > \
            bisect_right(rm_committed, lo)

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
        ms_k = max(ms_run, int(out["min_seq"][d, w]))

        def must_break() -> bool:
            if len(chunk) >= k_max:
                return True
            # the aging-collision residue (the probe does not mutate;
            # ms_run is the exclusive watermark, as the device's ms_pre)
            if kd == KIND_INSERT and committed_aged(ms_base):
                probe = chain._locate(
                    int(out["pos1"][d, w]), ms_run)[2]
                if probe in ins_coords:
                    return True
            return False

        if must_break():
            fresh(w)
        else:
            # count the breaks event splitting absorbed: an open-span
            # tombstone aging out of the anchor walk, or a committed
            # tombstone crossing min_seq before an insert
            if rm_open and rm_open[0] <= ms_k:
                span_splits[d] += 1
                while rm_open and rm_open[0] <= ms_k:
                    rm_committed.append(rm_open.pop(0))
                # one aging event = one absorbed break
                ms_counted = max(ms_counted, ms_k)
            if kd == KIND_INSERT and committed_aged(ms_counted):
                span_splits[d] += 1
                ms_counted = ms_global
        if kd == KIND_INSERT:
            b, pr, ok = chain.map_insert(
                int(out["pos1"][d, w]),
                int(out["length"][d, w]), w - base_w, ms_run)
            if not ok:
                fresh(w)
                b, pr, ok = chain.map_insert(
                    int(out["pos1"][d, w]),
                    int(out["length"][d, w]), 0, ms_run)
                assert ok
            out["pos1"][d, w] = b
            pred[d, w] = pr
            ins_coords.add(b)
        else:
            p1 = int(out["pos1"][d, w])
            p2 = int(out["pos2"][d, w])
            b1, b2, cover, ok = chain.map_range(p1, p2)
            if not ok:
                fresh(w)
                b1, b2, cover, ok = chain.map_range(p1, p2)
                assert ok
            out["pos1"][d, w] = b1
            out["pos2"][d, w] = b2
            ev_cover[d, w] = cover
            if kd == KIND_REMOVE:
                chain.apply_remove(p1, p2, int(out["seq"][d, w]))
                rm_open.append(int(out["seq"][d, w]))
        chunk.append(w)
        ms_run = ms_k
        ms_global = max(ms_global, int(out["min_seq"][d, w]))


def build_event_graph(arrays: dict, base_head=None, k_max: int = EG_K,
                      window_floor: int = 16) -> dict:
    """[D, W] OpBatch field arrays -> the egwalker dispatch program.

    Returns ``{"egwalker": True, "k": k_max, "graph": EventGraph,
    "prefix": ..., "suffix": ..., "span_splits": [D] int32}``:
    ``prefix`` holds every document's critical prefix (positions in
    span-base coordinates + CHUNK_FIELDS, window bucketed on the
    ``BucketLadder``), ``suffix`` the raw remainder from each
    document's first non-critical op on (left-aligned, bucketed; None
    when every op is critical). ``base_head`` [D] is the max sequence
    number already applied per row (omitted: a fresh table)."""
    assert 1 <= k_max <= 31
    kind = np.array(_host(arrays["kind"]), np.int32)
    D, W = kind.shape
    raw = {f: np.array(_host(arrays[f]), np.int32) for f in OpBatch._fields}
    if base_head is None:
        base_head = np.zeros(D, np.int64)
    parent_seq, parent_own, frontier_other, critical = _graph_arrays(
        kind, raw["seq"], raw["refseq"], raw["client"], base_head)

    # split index per row: the first non-critical REAL op
    lane = np.arange(W, dtype=np.int64)[None]
    bad = np.where(~critical & (kind != KIND_NOOP), lane, W)
    prefix_len = bad.min(axis=1).astype(np.int32) if W else \
        np.zeros(D, np.int32)
    graph = EventGraph(parent_seq, parent_own, frontier_other,
                       critical.astype(np.int32), prefix_len)
    ladder = BucketLadder(window_floor=window_floor)

    span_splits = np.zeros(D, np.int32)
    program: dict = {"egwalker": True, "k": k_max, "graph": graph,
                     "prefix": None, "suffix": None,
                     "span_splits": span_splits}
    max_p = int(prefix_len.max()) if D else 0
    if max_p > 0:
        P = ladder.window_bucket(max_p)
        valid = lane[:, :P] < prefix_len[:, None] if P <= W else \
            np.concatenate(
                [lane < prefix_len[:, None],
                 np.zeros((D, P - W), np.bool_)], axis=1)
        pref = {}
        for f in OpBatch._fields:
            src = raw[f][:, :P] if P <= W else np.concatenate(
                [raw[f], np.zeros((D, P - W), np.int32)], axis=1)
            fill = KIND_NOOP if f == "kind" else 0
            pref[f] = np.where(valid, src, fill).astype(np.int32)
        chunk_start = np.zeros((D, P), np.int32)
        pred = np.full((D, P), -1, np.int32)
        ev_cover = np.zeros((D, P), np.int32)
        has_real = (pref["kind"] != KIND_NOOP).any(axis=1)
        # idle rows need no chain analysis: boundary every k_max lanes
        chunk_start[~has_real, ::k_max] = 1
        for d in np.flatnonzero(has_real):
            _compile_span_row(pref, chunk_start, pred, ev_cover,
                              span_splits, int(d), k_max)
        pref["chunk_start"] = chunk_start
        pref["pred"] = pred
        pref["ev_cover"] = ev_cover
        program["prefix"] = pref

    suf_len = (W - prefix_len).astype(np.int64)
    max_s = int(suf_len.max()) if D else 0
    if max_s > 0:
        S = ladder.window_bucket(max_s)
        suffix = {f: np.zeros((D, S), np.int32)
                  for f in OpBatch._fields}
        suffix["kind"][:] = KIND_NOOP
        for d in np.flatnonzero(suf_len > 0):
            p = int(prefix_len[d])
            n = W - p
            for f in OpBatch._fields:
                suffix[f][d, :n] = raw[f][d, p:W]
        program["suffix"] = suffix
    return program


# ======================================================================
# device half: the walker macro-step (plain torch)


def _walker_step(st: dict, ops: dict, K: int):
    """Apply one critical span of up to K ops per document: the chunked
    step (``merge_chunk._macro_step``) with one shared view and
    first-remover-wins. Returns (new state, consumed lanes [D],
    overflowed now [D])."""
    D, C = st["length"].shape
    dev = st["length"].device
    kidx, take_upto, taken, kind = _take(ops, K)
    is_ins = kind == KIND_INSERT
    is_rem = kind == KIND_REMOVE
    is_ann = kind == KIND_ANNOTATE
    range_taken = (is_rem | is_ann) & taken

    # ---- ONE shared view pass over the span-base state ----------------
    # every op of a critical span has seen every seq in it: vis = alive
    # & ~removed for all lanes. Only the stop mask (insert tie-break
    # eligibility) depends on the lane, through its exclusive min_seq
    # watermark ms_pre
    j = torch.arange(C, dtype=torch.int32, device=dev)[None]
    count = st["count"][:, None]                           # [D,1]
    alive = j < count
    removed = st["removed_seq"] != _NOT_REMOVED
    ms_pre = _ms_pre(st["min_seq"], ops, taken)
    below_lane = removed[:, None, :] & (
        st["removed_seq"][:, None, :] <= ms_pre[..., None])  # [D,K,C]
    vis = alive & ~removed
    stop3 = alive[:, None, :] & ~below_lane
    vlen = torch.where(vis, st["length"], 0)               # [D,C]
    E = torch.cumsum(vlen, dim=-1, dtype=torch.int32) - vlen
    incl = E + vlen
    total = incl[:, -1]                                    # [D]

    # ---- batched resolve of all K lanes against the shared view -------
    E3 = E[:, None, :]                                     # [D,1,C]
    incl3 = incl[:, None, :]
    p1 = ops["pos1"][..., None]                            # [D,K,1]
    p2 = ops["pos2"][..., None]

    def first_true(mask, default):
        """[D,K,C] bool -> ([D,K] first-True index or default, any)."""
        any_ = mask.any(dim=-1)
        idx = mask.to(torch.uint8).argmax(dim=-1).to(torch.int32)
        return torch.where(any_, idx, default), any_

    def e_at(idx):
        """E[d, idx[d, k]] (callers gate on the found flag)."""
        return E.gather(1, idx.clamp(max=C - 1).long())

    target = stop3 & (((E3 <= p1) & (p1 < incl3)) | (E3 == p1))
    idx_t, t_any = first_true(target, count)
    t_found = t_any & (idx_t < count)
    ev_valid = is_ins & (ops["pos1"] <= total[:, None]) & taken
    a_slot = torch.where(t_found, idx_t, count)            # [D,K]
    a_off = torch.where(t_found, ops["pos1"] - e_at(idx_t), 0)

    def split_at(p, pos):
        """First row strictly containing ``p`` (found, slot, offset),
        else the first row with E >= p (count if none), offset 0."""
        i, s = first_true((E3 < p) & (p < incl3), C)
        jn, _ = first_true(E3 >= p, count)
        return s, torch.where(s, i, jn), torch.where(s, pos - e_at(i), 0)

    s1, r1s, r1o = split_at(p1, ops["pos1"])
    s2, r2s, r2o = split_at(p2, ops["pos2"])

    rank = _rank_replay(a_slot, a_off, ev_valid, ops["pred"], K)
    cut_slot, cut_off, cut_valid, next_off = _cuts(
        C, K, ev_valid, a_slot, a_off, range_taken,
        s1, r1s, r1o, s2, r2s, r2o)
    r = _rows(st, ops, K, kidx, ev_valid, a_slot, a_off, rank,
              cut_slot, cut_off, cut_valid, next_off)

    # ---- stamps ---------------------------------------------------------
    # a base/tail row is stampable iff live, not removed in the span-base
    # state and non-empty (one [D, R] mask for every lane); the interval
    # test runs in the shared view's E-space: the row's absolute extent
    # [E[slot] + lo, E[slot] + hi) must lie inside [pos1, pos2)
    row_E = E.gather(1, r["key_slot"].clamp(max=C - 1).long())  # [D,R]
    in_interval = (((row_E + r["frag_lo"])[:, :, None] >= p1[:, None, :, 0])
                   & ((row_E + r["frag_hi"])[:, :, None]
                      <= p2[:, None, :, 0]))               # [D,R,K]
    row_stampable = (r["live"] & (r["removed_seq"] == _NOT_REMOVED)
                     & (r["length"] > 0) & (r["is_event"] == 0))
    raw_stamp = ((in_interval & row_stampable[:, :, None]
                  & range_taken[:, None, :])
                 | _ev_stamp(ops, r, range_taken))

    # first-remover-wins: every op sees every earlier in-span remove, so
    # a later range op skips rows an earlier remove lane stamped (an
    # exclusive cumulative-or over the lanes)
    rm_lane = (is_rem & taken)[:, None, :]                 # [D,1,K]
    rm_raw = (raw_stamp & rm_lane).to(torch.int32)
    prior_rm = torch.cumsum(rm_raw, dim=-1, dtype=torch.int32) - rm_raw > 0
    eff = raw_stamp & ~prior_rm
    rm_eff = eff & rm_lane
    ann_eff = eff & (is_ann & taken)[:, None, :]

    # at most one effective remove per row: the first rm lane
    any_rm = rm_eff.any(dim=-1)                            # [D,R]
    rm_k = rm_eff.to(torch.uint8).argmax(dim=-1).clamp(max=K - 1)
    new_removed = torch.where(
        (r["removed_seq"] == _NOT_REMOVED) & any_rm,
        ops["seq"].gather(1, rm_k), r["removed_seq"])
    rm_client = ops["client"].gather(1, rm_k)
    # 1 << 31 is -2**31: bit 31 of the int32 bit pattern
    rm_bit = torch.ones_like(rm_client) << rm_client
    new_removers = r["removers"] | torch.where(any_rm, rm_bit, 0)

    new_props = _lww_props(r, ops, ann_eff, K)
    out, overflow_now = _finish(st, ops, K, r, taken, ev_valid, cut_valid,
                                new_removed, new_removers, new_props)
    return out, take_upto, overflow_now


def apply_window_egwalker(table: SegmentTable, prefix: dict,
                          K: int = EG_K,
                          steps: int | None = None) -> SegmentTable:
    """Apply a compiled critical-prefix program (the ``prefix`` half of
    ``build_event_graph``'s output) to the table; returns a new table.
    ``K`` must equal the build's k_max."""
    return run_macro_steps(table, prefix, K, _walker_step, steps)[0]


def apply_batch_egwalker(table: SegmentTable, batch: OpBatch,
                         k_max: int = EG_K, base_head=None,
                         window_floor: int = 16) -> SegmentTable:
    """Build the event graph of one OpBatch (numpy or tensors) and run
    the whole route: the walker over the critical prefix, then the scan
    (on a CUDA table, the Hopper window kernel) over the suffix."""
    program = build_event_graph(
        {f: getattr(batch, f) for f in OpBatch._fields},
        base_head=base_head, k_max=k_max, window_floor=window_floor)
    if program["prefix"] is not None:
        table = apply_window_egwalker(table, program["prefix"], K=k_max)
    if program["suffix"] is not None:
        table = apply_window(
            table, batch_from_numpy(program["suffix"], table.device))
    return table
