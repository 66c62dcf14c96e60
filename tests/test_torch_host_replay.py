"""The port's scalar host replay (``ops.host_replay``) against the JAX
package's and against the port's scan, the port's scan against the
reference's compiled C++ replayer (``native/merge_replay.cpp`` through
``native.replay_baseline``), and the port's own C++ replayer and host
tier (its copy of ``merge_replay.cpp``, built by its own loader) against
the reference's: the same recorded streams, the same tables, texts,
signatures, checksums and live counts. Exact: the work is
integer-only."""
import numpy as np
import pytest

from fluidframework_tpu.native import load_merge_replay, merge_replay_error
from fluidframework_tpu.native.replay_baseline import (
    encode_ops_array,
    replay,
    table_checksum,
)
from fluidframework_tpu.native.replay_baseline import (
    MergeHostSession as RefMergeHostSession,
)
from fluidframework_tpu.ops import encode_stream as ref_encode_stream
from fluidframework_tpu.ops.host_replay import (
    replay_encoded as ref_replay_encoded,
)
from fluidframework_tpu.testing import FuzzConfig, record_op_stream
from fluidframework_tpu_torch import native as port_native
from fluidframework_tpu_torch.convert import batch_from_numpy
from fluidframework_tpu_torch.ops.host_bridge import (
    build_batch,
    encode_stream,
    extract_signature,
    extract_text,
    fetch,
)
from fluidframework_tpu_torch.native import replay_baseline as port_baseline
from fluidframework_tpu_torch.ops.host_replay import replay_encoded
from fluidframework_tpu_torch.ops.merge_kernel import apply_window
from fluidframework_tpu_torch.ops.segment_table import make_table
from test_torch_native_build import reference_native


@pytest.fixture(autouse=True)
def _reference_libraries():
    """The reference's replayer, built race-free under xdist."""
    reference_native()


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
    assert load_merge_replay() is not None, merge_replay_error()
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


def _fuzz(seed, n_steps=100):
    return record_op_stream(FuzzConfig(
        n_clients=3, n_steps=n_steps, seed=seed * 17 + 3,
        remove_weight=0.3, annotate_weight=0.15, insert_props_weight=0.3,
    ))


@pytest.mark.parametrize("seed", range(6))
def test_port_cpp_replay_equals_reference(seed):
    """The port's replayer on its own encoding equals the reference's on
    the reference's: the encoded arrays, checksum and live count (one
    rep and three), and the port's scan."""
    assert port_native.load_merge_replay() is not None, (
        port_native.merge_replay_error())
    text, stream = _fuzz(seed)
    enc = encode_stream(stream)
    arr = port_baseline.encode_ops_array(enc)
    ref_arr = encode_ops_array(ref_encode_stream(stream))
    assert np.array_equal(arr, ref_arr)
    for reps in (1, 3):
        got, want = port_baseline.replay(arr, reps), replay(ref_arr, reps)
        assert got[:2] == want[:2], reps
    assert got[0] == port_baseline.table_checksum(scan_table(enc, 1024), 0)


def test_port_host_session_equals_reference():
    """Both packages' C++ host tiers (``MergeHostSession``) fed the same
    rows of eight documents in three rounds: equal checksums, live
    counts and texts, each equal to the port's scan."""
    streams = [_fuzz(seed, 80)[1] for seed in range(8)]
    encs = [encode_stream(s) for s in streams]
    arrs = [port_baseline.encode_ops_array(e) for e in encs]
    port, ref = port_baseline.MergeHostSession(8), RefMergeHostSession(8)
    for r in range(3):
        parts = [a[len(a) * r // 3:len(a) * (r + 1) // 3] for a in arrs]
        rows = np.concatenate(parts)
        doc_of_row = np.repeat(np.arange(8), [len(p) for p in parts])
        port.apply(rows, doc_of_row)
        ref.apply(rows, doc_of_row)
    for d, enc in enumerate(encs):
        assert port.stats(d) == ref.stats(d), d
        assert port.text(d, enc) == ref.text(d, enc) == extract_text(
            scan_table(enc, 1024), enc, 0)
        assert port.stats(d)[0] == port_baseline.table_checksum(
            scan_table(enc, 1024), 0)
    port.close()
    ref.close()
