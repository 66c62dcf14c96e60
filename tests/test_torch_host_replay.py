"""The port's scalar host replay (``ops.host_replay``) against the JAX
package's and against the port's scan, and the port's scan against the
reference's compiled C++ replayer (``native/merge_replay.cpp`` through
``native.replay_baseline``): the same recorded streams, the same tables,
texts, signatures and checksums. Exact: the work is integer-only."""
import numpy as np
import pytest

from fluidframework_tpu.native import load_merge_replay, merge_replay_error
from fluidframework_tpu.native.replay_baseline import (
    encode_ops_array,
    replay,
    table_checksum,
)
from fluidframework_tpu.ops import encode_stream as ref_encode_stream
from fluidframework_tpu.ops.host_replay import (
    replay_encoded as ref_replay_encoded,
)
from fluidframework_tpu.testing import FuzzConfig, record_op_stream
from fluidframework_tpu_torch.convert import batch_from_numpy
from fluidframework_tpu_torch.ops.host_bridge import (
    build_batch,
    encode_stream,
    extract_signature,
    extract_text,
    fetch,
)
from fluidframework_tpu_torch.ops.host_replay import replay_encoded
from fluidframework_tpu_torch.ops.merge_kernel import apply_window
from fluidframework_tpu_torch.ops.segment_table import make_table


def scan_table(enc, capacity):
    """The port's scan route on the CPU over one encoded stream."""
    table = fetch(apply_window(make_table(1, capacity, "cpu"),
                               batch_from_numpy(build_batch([enc]), "cpu")))
    assert not table["overflow"].any()
    return table


@pytest.mark.parametrize("seed", range(8))
def test_host_replay_matches_reference_and_scan(seed):
    text, stream = record_op_stream(FuzzConfig(
        n_clients=3, n_steps=90, seed=seed * 7 + 1,
        remove_weight=0.3, annotate_weight=0.15,
        insert_props_weight=0.3,
    ))
    enc = encode_stream(stream)
    ref_enc = ref_encode_stream(stream)
    assert enc.ops == ref_enc.ops
    host = replay_encoded(enc.ops).as_table()
    want = ref_replay_encoded(ref_enc.ops).as_table()
    assert host.keys() == want.keys()
    for f, a in want.items():
        assert np.array_equal(host[f], a), f
    assert replay_encoded(enc.ops).min_seq == ref_replay_encoded(
        ref_enc.ops).min_seq
    table = scan_table(enc, 1024)
    assert extract_text(host, enc, 0) == extract_text(table, enc, 0) == text
    assert extract_signature(host, enc, 0) == extract_signature(
        table, enc, 0)


@pytest.mark.parametrize("seed", range(12))
def test_scan_matches_cpp_replay(seed):
    if load_merge_replay() is None:
        pytest.skip(f"native replayer unavailable: {merge_replay_error()}")
    text, stream = record_op_stream(FuzzConfig(
        n_clients=3, n_steps=100, seed=seed * 17 + 3,
        remove_weight=0.3, annotate_weight=0.15,
    ))
    got = replay(encode_ops_array(ref_encode_stream(stream)))
    assert got is not None
    cpp_checksum, live, _dt = got
    assert table_checksum(scan_table(encode_stream(stream), 512),
                          0) == cpp_checksum
    # live char count = converged text length (the workload is
    # text-only: no markers)
    assert live == len(text)
