"""The port's host bridge and seeded traffic against the JAX package's:
the same messages encode, pack and read back identically."""
import numpy as np
import pytest

from fluidframework_tpu.models.mergetree import MergeTreeClient
from fluidframework_tpu.ops import apply_window, fetch, make_table
from fluidframework_tpu.ops import host_bridge as ref_hb
from fluidframework_tpu.testing import FuzzConfig as RefFuzzConfig
from fluidframework_tpu.testing import record_op_stream as ref_record
from fluidframework_tpu.testing.fuzz import (
    record_sequential_stream as ref_record_sequential,
)
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.ops import host_bridge as hb
from fluidframework_tpu_torch.testing import (
    FuzzConfig,
    record_op_stream,
    record_sequential_stream,
)

SEEDS = [3, 11, 29]


def _cfg(cls, seed):
    return cls(n_clients=3, n_steps=60, seed=seed, annotate_weight=0.15,
               insert_props_weight=0.3)


def _stream_key(stream):
    return [
        (m.client_id, m.sequence_number, m.minimum_sequence_number,
         m.reference_sequence_number, int(m.type))
        for m in stream
    ]


def _enc_key(enc):
    return (enc.ops, enc.payloads, enc.client_ids, enc.prop_keys,
            enc.prop_vals)


@pytest.mark.parametrize("seed", SEEDS)
def test_record_op_stream_matches_reference(seed):
    ref_text, ref_stream = ref_record(_cfg(RefFuzzConfig, seed))
    text, stream = record_op_stream(_cfg(FuzzConfig, seed))
    assert text == ref_text
    assert _stream_key(stream) == _stream_key(ref_stream)
    assert _enc_key(hb.encode_stream(stream)) == _enc_key(
        ref_hb.encode_stream(ref_stream))


@pytest.mark.parametrize("seed", SEEDS)
def test_record_sequential_stream_matches_reference(seed):
    ref_text, ref_stream = ref_record_sequential(seed=seed, n_steps=40)
    text, stream = record_sequential_stream(seed=seed, n_steps=40)
    assert text == ref_text
    assert _enc_key(hb.encode_stream(stream)) == _enc_key(
        ref_hb.encode_stream(ref_stream))


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_decode_and_build_batch_match_reference(seed):
    _, stream = ref_record(_cfg(RefFuzzConfig, seed))
    enc, ref_enc = hb.encode_stream(stream), ref_hb.encode_stream(stream)
    assert _enc_key(enc) == _enc_key(ref_enc)
    assert _stream_key(hb.decode_stream(enc)) == _stream_key(
        ref_hb.decode_stream(ref_enc))
    assert hb.coalesce_noops(enc.ops) == ref_hb.coalesce_noops(ref_enc.ops)
    got, want = hb.build_batch([enc, enc]), ref_hb.build_batch(
        [ref_enc, ref_enc])
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def _columns():
    text = "helloworldabc"
    return dict(
        n=4,
        kind=np.array([0, 0, 1, 0], np.int32),
        text_off=np.array([0, 5, 10, 10, 13]),
        pos1=np.array([0, 5, 1, 2], np.int32),
        pos2=np.array([0, 0, 3, 0], np.int32),
        refseq=np.array([4, 4, 5, 6], np.int32),
        text=text,
    )


def test_lower_columns_and_pack_rows_match_reference():
    cols = _columns()
    block, payloads = hb.lower_columns(cols, seq0=7, client=2, min_seq=3)
    ref_block, ref_payloads = ref_hb.lower_columns(
        cols, seq0=7, client=2, min_seq=3)
    np.testing.assert_array_equal(block, ref_block)
    assert payloads == ref_payloads
    _, stream = ref_record(_cfg(RefFuzzConfig, 5))
    ops = ref_hb.encode_stream(stream).ops
    for rows in (
        {0: ops[:20], 3: ops[20:23]},            # dict rows
        {1: block, 2: ops[:5], 4: block[:2]},    # columnar blocks mixed in
    ):
        for floor in (16, 64):
            got = hb.pack_rows(6, rows, bucket_floor=floor)
            want = ref_hb.pack_rows(6, rows, bucket_floor=floor)
            assert got.keys() == want.keys()
            for f in want:
                np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("seed", SEEDS)
def test_extraction_from_converted_table_matches_reference(seed):
    _, stream = ref_record(_cfg(RefFuzzConfig, seed))
    ref_enc = ref_hb.encode_stream(stream)
    table = apply_window(make_table(1, 256),
                         ref_hb.build_batch([ref_enc]))
    ref_np = fetch(table)
    got_np = convert.table_to_numpy(convert.table_from_numpy(ref_np, "cpu"))
    for f in ref_np:
        np.testing.assert_array_equal(got_np[f], ref_np[f])
    enc = hb.encode_stream(stream)
    assert hb.extract_text(got_np, enc, 0) == ref_hb.extract_text(
        ref_np, ref_enc, 0)
    assert hb.extract_signature(got_np, enc, 0) == ref_hb.extract_signature(
        ref_np, ref_enc, 0)
    oracle = MergeTreeClient("o")
    oracle.start_collaboration("o")
    for msg in stream:
        oracle.apply_msg(msg)
    assert hb.interned_signature(oracle, enc) == ref_hb.interned_signature(
        oracle, ref_enc)
