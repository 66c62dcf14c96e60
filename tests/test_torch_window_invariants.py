"""What the Hopper window kernel (``ops/csrc/merge_window.cu``) assumes of
the slot states it is given, checked on the CPU at every ``fused_step``
of the plain version.

1. The lookup shortcut. On every table the merge plane holds, live
   lengths are >= 0, the visible total stays below 2**31 and
   0 <= op_off < OPOFF_BOUND. Then E, incl and the op_off composite
   ``j * OPOFF_BOUND + op_off`` are non-decreasing in the slot index, so
   each of ``fused_step``'s masked min-reduces equals that array's value
   at the mask's first true slot: the kernel reduces 3 indices, not 12
   values.
2. The garbage tail. Slots at or above ``count`` never enter a view,
   and a step that adds k slots shifts them right by exactly k, so the
   kernel writes the tail once, from its input shifted by the window's
   growth.

The states come from ``GpuMergeSidecar(device="cpu")`` driven by seeded
op streams (through grow and eviction at the small capacity), and from
the seeded random tables and windows that ``chip_smoke.py`` holds the
kernel to.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.ops import merge_kernel
from fluidframework_tpu_torch.ops.merge_step import SLOT_FIELDS
from fluidframework_tpu_torch.ops.segment_table import (
    NOT_REMOVED,
    OPOFF_BOUND,
)
from fluidframework_tpu_torch.protocol.messages import MessageType
from fluidframework_tpu_torch.service import GpuMergeSidecar
from fluidframework_tpu_torch.testing import (
    FuzzConfig,
    record_op_stream,
    windows,
)

BIG = 2**31 - 1


def _phase1(st, op):
    """fused_step's view, scan and three lookup masks, recomputed."""
    D, C = st["length"].shape
    j = torch.arange(C, dtype=torch.int32).expand(D, C)
    count, min_seq = st["count"], st["min_seq"]
    refseq, client = op["refseq"], op["client"]
    p1, p2 = op["pos1"], op["pos2"]
    alive = j < count
    removed = st["removed_seq"] != int(NOT_REMOVED)
    below = removed & (st["removed_seq"] <= min_seq)
    rm_by_viewer = ((st["removers"] >> client) & 1).bool()
    removal_visible = removed & ((st["removed_seq"] <= refseq) | rm_by_viewer)
    insert_visible = (st["seq"] <= refseq) | (st["client"] == client)
    stop = alive & ~below
    vis = stop & insert_visible & ~removal_visible
    vlen = torch.where(vis, st["length"], 0)
    E = torch.cumsum(vlen, dim=-1, dtype=torch.int32) - vlen
    incl = E + vlen
    comp = j * OPOFF_BOUND + st["op_off"]
    masks = {
        "target": (stop & (E <= p1) & (p1 < incl)) | (stop & (E == p1)),
        "strict1": (E < p1) & (p1 < incl),
        "strict2": (E < p2) & (p2 < incl),
    }
    return j, alive, vlen, E, incl, comp, masks


def _check_lookups(st, op):
    j, alive, vlen, E, incl, comp, masks = _phase1(st, op)
    assert bool((st["length"][alive] >= 0).all()), "a live length < 0"
    assert bool((vlen.long().sum(dim=-1) < 2**31).all()), "total >= 2**31"
    op_off = st["op_off"][alive]
    assert bool(((op_off >= 0) & (op_off < OPOFF_BOUND)).all()), (
        "op_off out of [0, OPOFF_BOUND)")
    for name, mask in masks.items():
        first = torch.where(mask, j, BIG).amin(dim=-1, keepdim=True)
        found = first < BIG
        at = first.clamp(max=j.shape[-1] - 1).long()
        for what, arr in (("E", E), ("incl", incl), ("comp", comp)):
            masked_min = torch.where(mask, arr, BIG).amin(dim=-1, keepdim=True)
            at_first = torch.where(found, arr.gather(-1, at), BIG)
            assert torch.equal(masked_min, at_first), (
                f"{name}: min of {what} over the mask is not its value at "
                f"the first true slot")


def _check_tail(st, new):
    added = (new["count"] - st["count"])[:, 0].tolist()
    for d, k in enumerate(added):
        assert k >= 0
        start = int(new["count"][d, 0])
        for f in SLOT_FIELDS:
            got = new[f][d, start:]
            want = st[f][d, start - k:st[f].shape[-1] - k]
            assert torch.equal(got, want), (
                f"doc {d} field {f}: the tail is not the old tail shifted "
                f"by {k}")


@pytest.fixture
def checked_steps(monkeypatch):
    """Route the plain version's every fused_step through both checks;
    yields the list of checked steps."""
    real = merge_kernel.fused_step
    steps = []

    def step(st, op):
        _check_lookups(st, op)
        new = real(st, op)
        _check_tail(st, new)
        steps.append(op["kind"])
        return new

    monkeypatch.setattr(merge_kernel, "fused_step", step)
    return steps


def _wrap(stream):
    out = []
    for msg in stream:
        if msg.type == MessageType.OPERATION:
            msg = dataclasses.replace(msg, contents={
                "kind": "op", "address": "d", "channel": "s",
                "contents": msg.contents,
            })
        out.append(msg)
    return out


@pytest.mark.parametrize("cap", [16, 128, 1024])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_invariants_on_sidecar_tables(checked_steps, cap, seed):
    streams = [_wrap(record_op_stream(FuzzConfig(
        n_clients=3, n_steps=90, seed=100 * seed + i))[1])
        for i in range(3)]
    sidecar = GpuMergeSidecar(max_docs=3, capacity=cap, max_capacity=256,
                              device="cpu")
    docs = [f"doc-{i}" for i in range(len(streams))]
    for doc in docs:
        sidecar.track(doc, "d", "s")
    longest = max(len(s) for s in streams)
    for start in range(0, longest, 40):
        for doc, s in zip(docs, streams):
            for msg in s[start:start + 40]:
                sidecar.ingest(doc, msg)
        sidecar.apply()
    sidecar.sync()
    kinds = torch.cat(checked_steps)
    assert int((kinds < 3).sum()) > 0, "no real op was checked"
    if cap == 16:
        assert sidecar.grow_count > 0


@pytest.mark.parametrize("cap", [16, 128, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_invariants_on_random_windows(checked_steps, cap, seed):
    rng = np.random.default_rng(seed)
    table = windows.random_table(rng, 8, cap, "cpu")
    for _ in range(2):
        batch = windows.random_batch(rng, table, 32, "cpu")
        table = merge_kernel.apply_window_plain(table, batch)
    assert len(checked_steps) == 64
    assert int(table.overflow.sum()) > 0
