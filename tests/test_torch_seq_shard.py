"""The port's sequence-sharded window against the JAX package's: one
long document's slot slab split over 2, 4 and 8 shards (the port's
threads with collectives over ``[cpu] * n``, the reference's
``shard_map`` over the session's virtual CPU devices), on the same
seeded streams. Every field of the table equals the reference's and the
port's unsharded scan, bit for bit, and the text equals the recorder's.
Also the three refusals, the capacity ceiling both packages share, and
that a failing or stalled shard raises in the caller."""
import time

import jax
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import build_batch, encode_stream, fetch
from fluidframework_tpu.ops import make_table
from fluidframework_tpu.ops.merge_kernel import (
    apply_window as ref_apply_window,
)
from fluidframework_tpu.ops.host_bridge import interned_signature
from fluidframework_tpu.models.mergetree import MergeTreeClient
from fluidframework_tpu.parallel import (
    apply_window_seq_sharded as ref_apply_seq,
)
from fluidframework_tpu.parallel import make_seq_mesh as ref_seq_mesh
from fluidframework_tpu.service.tpu_sidecar import select_pool as ref_select
from fluidframework_tpu.testing import (
    FuzzConfig,
    MockCollabSession,
    record_op_stream,
)
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.ops.host_bridge import (
    encode_stream as port_encode,
)
from fluidframework_tpu_torch.ops.host_bridge import (
    extract_signature,
    extract_text,
)
from fluidframework_tpu_torch.ops import merge_step
from fluidframework_tpu_torch.ops.merge_kernel import apply_window
from fluidframework_tpu_torch.parallel import (
    apply_window_seq_sharded,
    make_seq_mesh,
)
from fluidframework_tpu_torch.parallel.seq_shard import run_shards, seq_prims
from fluidframework_tpu_torch.service.gpu_sidecar import select_pool

CPU = torch.device("cpu")


def _streams(n_docs, base_seed, steps=120, **kw):
    cfg = dict(n_clients=3, remove_weight=0.3, annotate_weight=0.15)
    cfg.update(kw)
    cases = [record_op_stream(FuzzConfig(n_steps=steps,
                                         seed=base_seed + 13 * i, **cfg))
             for i in range(n_docs)]
    return [t for t, _ in cases], [s for _, s in cases]


def _run(streams, capacity, n, doc_shards=1):
    """The batch through the reference's seq-sharded window, the port's
    and the port's scan; asserts all three equal on every field and
    returns the encodings and the port's table."""
    encs = [encode_stream(s) for s in streams]
    batch = build_batch(encs)
    table = make_table(len(encs), capacity)
    ref = fetch(ref_apply_seq(table, batch, ref_seq_mesh(
        jax.devices()[:n], doc_shards=doc_shards)))
    start = convert.table_from_numpy(fetch(table), "cpu")
    got = convert.table_to_numpy(apply_window_seq_sharded(
        start, batch, make_seq_mesh([CPU] * n, doc_shards=doc_shards)))
    scan = convert.table_to_numpy(apply_window(
        start, convert.batch_from_numpy(batch, "cpu")))
    for f in ref:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f"{f} vs JAX")
        np.testing.assert_array_equal(got[f], scan[f], err_msg=f"{f} vs scan")
    return [port_encode(s) for s in streams], got


@pytest.mark.parametrize("n", [2, 4, 8])
def test_seq_sharded_matches_reference(n):
    texts, streams = _streams(2, base_seed=4001, steps=80)
    encs, got = _run(streams, capacity=256, n=n)
    for d, text in enumerate(texts):
        assert extract_text(got, encs[d], d) == text


def test_seq_sharded_2d_mesh_docs_by_seq():
    """docs x seq 2-D mesh: collectives stay inside each doc lane."""
    texts, streams = _streams(4, base_seed=5501, steps=60)
    encs, got = _run(streams, capacity=128, n=8, doc_shards=2)
    for d, text in enumerate(texts):
        assert extract_text(got, encs[d], d) == text


def test_seq_sharded_signature_matches_oracle():
    text, stream = record_op_stream(FuzzConfig(
        n_clients=4, n_steps=120, seed=177,
        remove_weight=0.35, annotate_weight=0.2))
    encs, got = _run([stream], capacity=256, n=4)
    assert extract_text(got, encs[0], 0) == text
    obs = MergeTreeClient("observer")
    obs.start_collaboration("observer")
    for msg in stream:
        obs.apply_msg(msg)
    want = interned_signature(obs, encode_stream(stream))
    assert extract_signature(got, encs[0], 0) == want


def test_seq_sharded_overflow_flag_consistent():
    """Global capacity is the sum of the shards': a stream whose live
    set outgrows one shard's 32 slots but fits 128 does not overflow."""
    _, streams = _streams(1, base_seed=9100, steps=120)
    _, got = _run(streams, capacity=128, n=4)
    assert got["count"][0] > 128 // 4
    assert not got["overflow"].any()


@pytest.mark.parametrize("seed", [
    s if s in (5, 7) else pytest.param(s, marks=pytest.mark.slow)
    for s in range(12)])
def test_seq_sharded_adversarial_fuzz(seed):
    """More clients, remove / annotate storms, longer streams."""
    text, stream = record_op_stream(FuzzConfig(
        n_clients=6, n_steps=220, seed=seed * 73 + 11,
        remove_weight=0.35, annotate_weight=0.2))
    encs, got = _run([stream], capacity=512, n=4)
    assert extract_text(got, encs[0], 0) == text


def test_seq_sharded_ops_spanning_shard_boundaries():
    """Removes and annotates whose ranges cross shard boundaries: both
    split slots in different shards, through the boundary exchange."""
    stream = []
    s = MockCollabSession(["A", "B"], stream_log=stream)
    for i in range(100):
        s.do("A", "insert_text_local", 0, f"seg{i:03d}-")
    s.process_all()
    s.do("B", "remove_range_local", 50, 450)
    s.do("A", "annotate_range_local", 10, 700, {"bold": 1})
    s.do("B", "insert_text_local", 200, "XBOUNDARYX")
    s.process_all()
    expected = s.assert_converged()
    encs, got = _run([stream], capacity=256, n=4)
    assert extract_text(got, encs[0], 0) == expected


@pytest.mark.parametrize("capacity,n,match", [
    (500, 8, "not divisible"),
    (8, 8, "shard width"),
    (32768, 2, "overflows the op_off composite"),
])
def test_seq_sharded_refusals(capacity, n, match):
    """Both packages refuse the same tables, before any work."""
    _, streams = _streams(1, base_seed=1, steps=10)
    batch = build_batch([encode_stream(s) for s in streams])
    with pytest.raises(ValueError, match=match):
        ref_apply_seq(make_table(1, capacity), batch,
                      ref_seq_mesh(jax.devices()[:n]))
    with pytest.raises(ValueError, match=match):
        apply_window_seq_sharded(
            convert.table_from_numpy(fetch(make_table(1, capacity)), "cpu"),
            batch, make_seq_mesh([CPU] * n))


def test_seq_pool_default_capacity_trips_the_ceiling():
    """The reference's own fault, mirrored (ROADMAP C, slice 1): the seq
    pool's default capacity is max_capacity (16384) x the seq shard
    count, past the op_off ceiling of 8192, in both packages."""
    ref_pool = ref_select(ref_seq_mesh(jax.devices()[:2]))
    pool = select_pool(make_seq_mesh([CPU] * 2))
    assert pool.capacity == ref_pool.capacity == 32768
    assert pool.capacity * (1 << 17) >= 2**31


@pytest.mark.parametrize("prims", ["local", "one-shard collectives"])
def test_fused_step_prims_seam_matches_reference(prims):
    """``fused_step`` through its ``AxisPrims`` seam: the explicit
    ``LOCAL_PRIMS`` and the collective prims of a one-shard group both
    equal the reference's scan of its step (``LOCAL_PRIMS``) on fuzzed
    windows, every field."""
    _, streams = _streams(4, base_seed=555, steps=60, n_clients=4)
    batch = build_batch([encode_stream(s) for s in streams])
    want = fetch(ref_apply_window(make_table(4, 64), batch))
    st = merge_step.table_to_state(
        convert.table_from_numpy(fetch(make_table(4, 64)), "cpu"))

    def window(lane, rank, group):
        state = st
        seam = (merge_step.LOCAL_PRIMS if prims == "local"
                else seq_prims(group, rank, CPU))
        for w in range(batch.kind.shape[1]):
            state = merge_step.fused_step(state, {
                f: torch.tensor(getattr(batch, f)[:, w:w + 1])
                for f in batch._fields}, prims=seam)
        return state

    (got,) = run_shards(window, lanes=1, n=1)
    got = convert.table_to_numpy(merge_step.state_to_table(got))
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_failed_shard_raises_in_the_caller():
    def body(lane, rank, group):
        if rank == 1:
            raise KeyError("shard 1 failed")
        return group.exchange(rank, torch.zeros(1))

    with pytest.raises(KeyError, match="shard 1 failed"):
        run_shards(body, lanes=2, n=3, timeout=30.0)


def test_stalled_shard_times_out():
    def body(lane, rank, group):
        if rank == 1:
            time.sleep(0.5)  # holds the turn past the others' timeout
        return group.exchange(rank, torch.zeros(1))

    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_shards(body, lanes=1, n=2, timeout=0.1)
    assert time.monotonic() - t0 < 5.0
