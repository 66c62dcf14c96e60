"""The span-boundary windows of ``testing/windows.span_window`` on the
CPU: through the plain ``fused_step``'s own first-true lookups, every
slot span-2 .. span+1 of every boundary is the insert target, the first
split and the second split of some step, and some step fills the table
to its capacity; the small window equals the reference's XLA scan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import fetch
from fluidframework_tpu.ops import merge_kernel as ref_kernel
from fluidframework_tpu.ops.segment_table import OpBatch as RefOpBatch
from fluidframework_tpu.ops.segment_table import SegmentTable as RefTable
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.ops import cuda_merge
from fluidframework_tpu_torch.ops.merge_kernel import apply_window_plain
from fluidframework_tpu_torch.ops.merge_step import (
    LOCAL_PRIMS, AxisPrims, fused_step, table_to_state,
)
from fluidframework_tpu_torch.ops.segment_table import KIND_INSERT, OpBatch
from fluidframework_tpu_torch.testing import windows


@pytest.mark.parametrize("docs,cap,window,span", [
    (24, 128, 16, 16),
    (8, 8192, 32, cuda_merge.cluster_span(8192)),
])
def test_span_window_lands_on_every_boundary(docs, cap, window, span):
    table, batch = windows.span_window(
        np.random.default_rng(cap), docs, cap, window, span, "cpu")
    found = []  # fused_step's three first-true lookups, in step order
    prims = AxisPrims(first_true=lambda m, j, default: found.append(
        LOCAL_PRIMS.first_true(m, j, default)) or found[-1])
    st, filled = table_to_state(table), False
    for w in range(window):
        st = fused_step(st, {f: getattr(batch, f)[:, w:w + 1]
                             for f in OpBatch._fields}, prims)
        filled |= bool((st["count"] == cap).any())
    idx = torch.stack(found)[..., 0].reshape(window, 3, docs).numpy()
    kind = batch.kind.numpy().T
    for look, ran in enumerate([kind == KIND_INSERT] + [
            (kind == 1) | (kind == 2)] * 2):
        hit = set(idx[:, look][ran].tolist())
        missed = [s for s in windows.boundary_slots(cap, span)
                  if s not in hit]
        assert not missed, f"lookup {look} never at slots {missed}"
    assert filled and int(st["overflow"].sum()) == 0


def test_span_window_overflow_matches_reference():
    table, batch = windows.span_window(
        np.random.default_rng(5), 6, 128, 24, 16, "cpu", fill_docs=2,
        overflow_docs=2)
    got = apply_window_plain(table, batch)
    assert got.overflow.tolist() == [1, 1, 0, 0, 0, 0]
    assert (got.count[:4] == 128).all()
    ref = ref_kernel.apply_window(
        RefTable(**{f: jnp.asarray(a) for f, a in
                    convert.table_to_numpy(table).items()}),
        RefOpBatch(**{f: jnp.asarray(getattr(batch, f).numpy())
                      for f in OpBatch._fields}))
    for f, want in fetch(ref).items():
        np.testing.assert_array_equal(convert.table_to_numpy(got)[f], want,
                                      err_msg=f)
