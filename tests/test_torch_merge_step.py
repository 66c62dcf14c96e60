"""The port's plain merge step and window apply against the JAX
reference, bit for bit on every field (``removers`` as a bit pattern):
the XLA scan, the Pallas kernel in interpret mode, ``pad_capacity`` and
``compact``. Inputs are the reference's seeded fuzz streams, fed to
both packages through ``convert``."""
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import encode_stream, fetch, make_table
from fluidframework_tpu.ops import merge_kernel as ref_kernel
from fluidframework_tpu.ops import merge_step as ref_step
from fluidframework_tpu.ops.host_bridge import coalesce_noops, pack_rows
from fluidframework_tpu.ops.segment_table import OpBatch as RefOpBatch
from fluidframework_tpu.ops.segment_table import SegmentTable as RefTable
from fluidframework_tpu.testing import FuzzConfig, record_op_stream
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.ops import merge_kernel, merge_step


def _streams(docs, seed0, steps):
    out = []
    for d in range(docs):
        _, stream = record_op_stream(FuzzConfig(
            n_clients=3, n_steps=steps, seed=seed0 + d,
            insert_weight=0.5, remove_weight=0.25, annotate_weight=0.1,
            process_weight=0.15, insert_props_weight=0.2,
        ))
        out.append(coalesce_noops(encode_stream(stream).ops))
    return out


def _windows(ops_by_doc, window, n):
    """The first ``n`` consecutive [docs, window] op windows."""
    return [
        pack_rows(len(ops_by_doc), {
            d: ops[k * window:(k + 1) * window]
            for d, ops in enumerate(ops_by_doc)
        }, bucket_floor=window)
        for k in range(n)
    ]


def _assert_equal(ref_np, got, what=""):
    got_np = convert.table_to_numpy(got)
    for f, want in ref_np.items():
        assert got_np[f].dtype == want.dtype, f
        np.testing.assert_array_equal(got_np[f], want, err_msg=f"{f} {what}")


def _to_port(ref_table):
    return convert.table_from_numpy(fetch(ref_table), "cpu")


@pytest.mark.parametrize("cap", [16, 128, 1024])
@pytest.mark.parametrize("window", [16, 64])
def test_apply_window_matches_reference_scan(cap, window):
    docs = 4
    ops = _streams(docs, seed0=cap * 7 + window, steps=70)
    ref = make_table(docs, cap)
    got = convert.table_from_numpy(fetch(ref), "cpu")
    for k, arrays in enumerate(_windows(ops, window, 2)):
        ref = ref_kernel.apply_window(ref, RefOpBatch(**arrays))
        got = merge_kernel.apply_window(
            got, convert.batch_from_numpy(arrays, "cpu"))
        _assert_equal(fetch(ref), got, f"window {k}")


def test_fused_step_matches_reference_step():
    """One step from a mid-stream state, per op column."""
    docs, cap = 5, 64
    ops = _streams(docs, seed0=555, steps=50)
    first, second = _windows(ops, 16, 2)
    ref = ref_kernel.apply_window(make_table(docs, cap), RefOpBatch(**first))
    ref_st = ref_step.table_to_state(ref)
    st = merge_step.table_to_state(_to_port(ref))
    for w in range(16):
        ref_op = {f: second[f][:, w:w + 1] for f in RefOpBatch._fields}
        op = {f: torch.tensor(second[f][:, w:w + 1])
              for f in RefOpBatch._fields}
        ref_st = ref_step.fused_step(ref_st, ref_op)
        st = merge_step.fused_step(st, op)
    _assert_equal(fetch(ref_step.state_to_table(ref_st, RefTable)),
                  merge_step.state_to_table(st))


def test_overflow_flag_matches_reference():
    docs, cap = 3, 16
    ops = _streams(docs, seed0=77, steps=80)
    (arrays,) = _windows(ops, 64, 1)
    ref = ref_kernel.apply_window(make_table(docs, cap), RefOpBatch(**arrays))
    got = merge_kernel.apply_window(
        _to_port(make_table(docs, cap)),
        convert.batch_from_numpy(arrays, "cpu"))
    assert fetch(ref)["overflow"].any()
    _assert_equal(fetch(ref), got)


def _pallas_interpret(table, batch):
    from fluidframework_tpu.ops import pallas_merge

    ops = {f: getattr(batch, f) for f in ref_step.OP_COLS}
    out = pallas_merge._pallas_call(
        ref_step.table_to_state(table), ops, interpret=True)
    return ref_step.state_to_table(out, RefTable)


@pytest.mark.parametrize("docs,seed0,steps", [
    (4, 1070, 30),   # tests/test_pallas_merge.py, seed 7
    (5, 4321, 25),   # its doc-padding shape
])
def test_apply_window_matches_pallas_interpret(docs, seed0, steps):
    from fluidframework_tpu.ops import build_batch

    streams = []
    for d in range(docs):
        _, stream = record_op_stream(FuzzConfig(
            n_clients=3, n_steps=steps, seed=seed0 + d,
            insert_weight=0.5, remove_weight=0.25, annotate_weight=0.1,
            process_weight=0.15,
        ))
        streams.append(encode_stream(stream))
    batch = build_batch(streams)
    ref = _pallas_interpret(make_table(docs, 128), batch)
    got = merge_kernel.apply_window(
        _to_port(make_table(docs, 128)),
        convert.batch_from_numpy(batch, "cpu"))
    _assert_equal(fetch(ref), got)


@pytest.mark.parametrize("cap", [16, 128])
def test_pad_capacity_and_compact_match_reference(cap):
    docs = 4
    ops = _streams(docs, seed0=900 + cap, steps=60)
    (arrays,) = _windows(ops, 64, 1)
    ref = ref_kernel.apply_window(make_table(docs, cap), RefOpBatch(**arrays))
    got = _to_port(ref)
    _assert_equal(fetch(ref_kernel.pad_capacity(ref, cap * 2)),
                  merge_kernel.pad_capacity(got, cap * 2))
    ref_c = fetch(ref_kernel.compact(ref))
    got_c = merge_kernel.compact(got)
    assert (ref_c["count"] < fetch(ref)["count"]).any()  # tombstones went
    _assert_equal(ref_c, got_c)


def test_capacity_ceiling_matches_reference():
    """capacity * OPOFF_BOUND must fit int32: 8192 is the largest
    capacity either package takes."""
    merge_kernel.check_capacity(8192)
    with pytest.raises(AssertionError):
        merge_kernel.check_capacity(16384)
