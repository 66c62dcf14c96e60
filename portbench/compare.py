"""The comparison that decides ``correct``: the program's tickets and
tables of the kept batches against the plain reference's, exactly.

Document ``d`` replayed session ``tile[d]``, so the reference's session
row stands for every document of its tile. Numbers compared, each with
the limit 0:

- ``ticket_mismatches``: messages of the kept batches whose seq, msn or
  status differ from the reference deli's;
- ``table_docs_differing``: documents of the kept batches' last tables
  whose ``count``, ``min_seq`` or ``overflow``, or any field of any live
  slot (below the reference's count), differ from the reference's table
  after the same round.

A refused ticket (its status differs from the reference's 0) and an
overflowed document (its flag differs, or it matches a reference that
overflowed too) also count in ``failed_messages``.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import DOC_FIELDS, SLOT_FIELDS

LIMITS = {"ticket_mismatches": 0, "table_docs_differing": 0}


def expected_tickets(rounds: list, ref_tickets: list, tile) -> list:
    """Per round, the reference's (seq, msn, status) over every document
    in the boxcar's order."""
    out = []
    for rd in rounds:
        out.append(tuple(np.concatenate(
            [ref_tickets[s][k][m0:m1] for s, (m0, m1) in
             ((s, rd["spans"][s]) for s in tile)]) for k in range(3)))
    return out


def ticket_mismatches(kept: dict, expected: list) -> int:
    bad = 0
    for got, want in zip(kept["tickets"], expected):
        differ = np.zeros(len(want[0]), bool)
        for g, w in zip(got, want):
            differ |= np.asarray(g) != w
        bad += int(differ.sum())
    return bad


def table_docs_differing(table, ref_table: dict, tile) -> int:
    """Documents of ``table`` (the program's ``SegmentTable``) that
    differ from their session's row of ``ref_table``."""
    dev = table.count.device
    idx = torch.as_tensor(np.asarray(tile), device=dev)
    want = {f: t.to(dev)[idx] for f, t in ref_table.items()}
    bad = torch.zeros(table.docs, dtype=torch.bool, device=dev)
    for f in DOC_FIELDS:
        bad |= getattr(table, f) != want[f]
    live = (torch.arange(table.capacity, device=dev)[None, :]
            < want["count"][:, None])
    for f in SLOT_FIELDS:
        bad |= ((getattr(table, f) != want[f]) & live).any(-1)
    bad |= ((table.prop != want["prop"]) & live[..., None]).any(-1).any(-1)
    return int(bad.sum())


def judge(win, rounds: list, ref: dict, tile) -> dict:
    """Every compared number beside its limit, in ``LIMITS``' order."""
    expected = expected_tickets(rounds, ref["tickets"], tile)
    tickets = tables = 0
    for kept in win.kept:
        tickets += ticket_mismatches(kept, expected)
        tables += table_docs_differing(
            kept["table"], ref["tables"][kept["rounds"] - 1], tile)
    values = {"ticket_mismatches": tickets, "table_docs_differing": tables}
    return {k: {"value": values[k], "limit": lim}
            for k, lim in LIMITS.items()}


def failed_messages(win, rounds: list, tile) -> int:
    """Messages refused in the window, and the messages of every
    document of a kept batch that ran out of slots."""
    failed = sum(r[4] for r in win.rounds)
    for kept in win.kept:
        over = kept["table"].overflow.ne(0).cpu().numpy()
        for rd in rounds[:kept["rounds"]]:
            n = np.diff(rd["doc_start"])
            failed += int(n[over].sum())
    return failed
