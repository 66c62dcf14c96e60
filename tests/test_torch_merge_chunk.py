"""The port's chunked executor against the JAX package's, and against the
port's scan, on the same op windows: ``compile_chunks`` array for array,
and ``apply_window_chunked`` on the live slots of every field plus
``count``, ``min_seq`` and ``overflow``. Inputs are the reference's
seeded fuzz streams and the targeted windows of its own chunked tests,
fed to both packages as numpy. Every run also asserts that the
host-counted macro-step loop left each row's cursor at the window's
end."""
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import build_batch, encode_stream, fetch
from fluidframework_tpu.ops import make_table as ref_make_table
from fluidframework_tpu.ops import merge_chunk as ref_chunk
from fluidframework_tpu.ops.merge_kernel import apply_window_impl
from fluidframework_tpu.ops.segment_table import (
    KIND_ANNOTATE,
    KIND_INSERT,
    KIND_NOOP,
    KIND_REMOVE,
    OpBatch,
)
from fluidframework_tpu.testing import FuzzConfig, record_op_stream
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.ops import merge_chunk, merge_kernel
from fluidframework_tpu_torch.ops.segment_table import make_table
from fluidframework_tpu_torch.testing.windows import live_difference

# few distinct (docs, window, capacity) shapes keep the JAX jits warm
FUZZ_DOCS, FUZZ_WINDOW, FUZZ_CAP = 4, 128, 512
RAW_WINDOW, RAW_CAP = 16, 64


def smoke_seeds(n, keep):
    """range(n), every seed outside ``keep`` slow-marked."""
    return [s if s in keep else pytest.param(s, marks=pytest.mark.slow)
            for s in range(n)]


def _arrays(batch) -> dict:
    return {f: np.asarray(getattr(batch, f), np.int32)
            for f in OpBatch._fields}


def run_routes(batch, capacity, K=merge_chunk.CHUNK_K):
    """The reference batch through the JAX scan and chunked routes and
    the port's chunked route and scan; asserts the programs equal and
    all four tables agree. Returns the port's compiled program and
    chunked table (numpy)."""
    D, W = np.asarray(batch.kind).shape
    arrays = _arrays(batch)
    want = ref_chunk.compile_chunks(arrays, k_max=K)
    program = merge_chunk.compile_chunks(arrays, k_max=K)
    assert program.keys() == want.keys()
    for key, arr in want.items():
        assert program[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(program[key], arr, err_msg=key)

    ref_scan = fetch(apply_window_impl(ref_make_table(D, capacity), batch))
    ref_chunked = fetch(ref_chunk.apply_window_chunked(
        ref_make_table(D, capacity), want, K=K))
    table, cursor = merge_chunk.run_macro_steps(
        make_table(D, capacity, "cpu"), program, K,
        merge_chunk._macro_step)
    assert cursor.tolist() == [W] * D
    got = convert.table_to_numpy(table)
    port_scan = convert.table_to_numpy(merge_kernel.apply_window_plain(
        make_table(D, capacity, "cpu"), convert.batch_from_numpy(
            arrays, "cpu")))
    for what, ref in (("JAX chunked", ref_chunked), ("JAX scan", ref_scan),
                      ("port scan", port_scan)):
        diff = live_difference(ref, got)
        assert diff is None, f"port chunked vs {what}: {diff}"
    return program, got


def _fuzz_batch(configs):
    streams = [record_op_stream(cfg)[1] for cfg in configs]
    return build_batch([encode_stream(s) for s in streams],
                       window=FUZZ_WINDOW)


@pytest.mark.parametrize("seed", smoke_seeds(12, {1, 2, 3}))
def test_concurrent_mix(seed):
    run_routes(_fuzz_batch([FuzzConfig(
        n_clients=4, n_steps=90, seed=seed * FUZZ_DOCS + d,
        insert_weight=0.55, remove_weight=0.25, annotate_weight=0.05,
        process_weight=0.15) for d in range(FUZZ_DOCS)]), FUZZ_CAP)


@pytest.mark.parametrize("seed", smoke_seeds(6, {2}))
def test_heavy_process_short_chunks(seed):
    """Frequent refseq advances: many cross-client breaks, K = 4."""
    run_routes(_fuzz_batch([FuzzConfig(
        n_clients=3, n_steps=80, seed=1000 + seed * FUZZ_DOCS + d,
        insert_weight=0.45, remove_weight=0.3, annotate_weight=0.1,
        process_weight=0.3) for d in range(FUZZ_DOCS)]), FUZZ_CAP, K=4)


@pytest.mark.parametrize("seed", smoke_seeds(6, {7}))
def test_single_client_chains(seed):
    """One client typing and backspacing: the host composes it all."""
    run_routes(_fuzz_batch([FuzzConfig(
        n_clients=1, n_steps=70, seed=2000 + seed * FUZZ_DOCS + d,
        insert_weight=0.55, remove_weight=0.3, annotate_weight=0.1,
        process_weight=0.05) for d in range(FUZZ_DOCS)]), FUZZ_CAP)


def test_multidoc_shapes_and_regression_seed_90007():
    """Docs of different shapes in one dispatch, with the reference's
    seed-90007 stream (a min_seq advance mid-chunk aging a committed
    tombstone between two same-position inserts)."""
    configs = [FuzzConfig(
        n_clients=1 + i % 4, n_steps=30 + 10 * i, seed=3000 + i,
        insert_weight=0.5, remove_weight=0.25, annotate_weight=0.1,
        process_weight=0.15) for i in range(FUZZ_DOCS - 1)]
    configs.append(FuzzConfig(
        n_clients=4, n_steps=120, seed=90007, insert_weight=0.5,
        remove_weight=0.3, annotate_weight=0.1, process_weight=0.1))
    run_routes(_fuzz_batch(configs), FUZZ_CAP)


def _raw(rows, window=RAW_WINDOW):
    """One doc's window from raw op dicts, NOOP-padded to ``window``."""
    base = dict(kind=KIND_NOOP, pos1=0, pos2=0, seq=0, refseq=0,
                client=0, op_id=0, length=0, is_marker=0,
                prop_key=0, prop_val=0, min_seq=0)
    arrs = {f: np.zeros((1, window), np.int32) for f in OpBatch._fields}
    arrs["kind"][:] = KIND_NOOP
    for w, r in enumerate(rows):
        for f, v in dict(base, **r).items():
            arrs[f][0, w] = v
    return OpBatch(**arrs)


def _ins(pos, seq, refseq, client, op_id, length, **kw):
    return dict(kind=KIND_INSERT, pos1=pos, seq=seq, refseq=refseq,
                client=client, op_id=op_id, length=length, **kw)


def _rm(p1, p2, seq, refseq, client, **kw):
    return dict(kind=KIND_REMOVE, pos1=p1, pos2=p2, seq=seq,
                refseq=refseq, client=client, **kw)


# (name, rows, {lane: chunk_start flag} as the reference's tests pin)
TARGETED = [
    ("typing burst",
     [_ins(i, i + 1, 0, 0, i, 1) for i in range(6)],
     dict(enumerate([1, 0, 0, 0, 0, 0]))),
    ("backspace run",
     [_ins(i, i + 1, 0, 0, i, 1) for i in range(4)]
     + [_rm(3, 4, 5, 0, 0), _rm(2, 3, 6, 0, 0)],
     dict(enumerate([1, 0, 0, 0, 0, 0]))),
    ("same-position inserts",
     [_ins(0, 1, 0, 0, 0, 2), _ins(0, 2, 0, 1, 1, 3),
      _ins(0, 3, 0, 2, 2, 1)], None),
    ("cross-client break",
     [_ins(0, 1, 0, 0, 0, 4), _ins(2, 2, 1, 1, 1, 2), _rm(1, 3, 3, 2, 0)],
     {0: 1, 1: 1}),
    ("tombstone boundary",
     [_ins(0, 1, 0, 0, 0, 6), _rm(2, 4, 2, 1, 0), _ins(2, 3, 1, 0, 1, 1)],
     None),
    ("annotate lww",
     [_ins(0, 1, 0, 0, 0, 5),
      dict(kind=KIND_ANNOTATE, pos1=0, pos2=5, seq=2, refseq=1, client=0,
           prop_key=1, prop_val=7),
      dict(kind=KIND_ANNOTATE, pos1=1, pos2=3, seq=3, refseq=1, client=0,
           prop_key=1, prop_val=9)], None),
    ("min_seq on noops",
     [_ins(0, 1, 0, 0, 0, 3), dict(kind=KIND_NOOP, min_seq=1),
      _rm(0, 1, 2, 1, 0, min_seq=1)], None),
    ("mid-chunk aging",
     [_ins(0, 1, 0, 0, 0, 2), _rm(1, 2, 2, 1, 1),
      _ins(1, 3, 2, 2, 1, 1, min_seq=2), _ins(1, 4, 2, 3, 2, 1)],
     {3: 1}),
    # client index 31 sets the removers sign bit: its own remove is
    # visible to its later insert only through that bit, and a blind
    # concurrent remove by client 5 stamps over it
    ("client 31 removes",
     [_ins(0, 1, 0, 0, 0, 6), _rm(1, 3, 2, 1, 31), _ins(1, 3, 1, 31, 1, 2),
      _rm(0, 4, 4, 1, 5),
      dict(kind=KIND_ANNOTATE, pos1=0, pos2=3, seq=5, refseq=1,
           client=31, prop_key=2, prop_val=4)], None),
]


@pytest.mark.parametrize("name,rows,starts", TARGETED,
                         ids=[t[0] for t in TARGETED])
def test_targeted_window(name, rows, starts):
    program, got = run_routes(_raw(rows), RAW_CAP)
    for lane, flag in (starts or {}).items():
        assert program["chunk_start"][0, lane] == flag, lane
    if name == "mid-chunk aging":
        assert got["seq"][0, :4].tolist() == [1, 4, 3, 1]
    if name == "typing burst":
        assert got["count"].tolist() == [6]
    if name == "client 31 removes":
        live = got["removers"][0, :got["count"][0]]
        assert (live & np.uint32(1 << 31)).any()


def test_overflow_parks_the_document():
    """Capacity 4, ten inserts: every route flags the overflow; the
    macro-step routes park the doc at its pre-chunk state."""
    batch = _raw([_ins(0, i + 1, 0, 0, i, 1) for i in range(10)])
    program = merge_chunk.build_chunked(batch)
    table, cursor = merge_chunk.run_macro_steps(
        make_table(1, 4, "cpu"), program, merge_chunk.CHUNK_K,
        merge_chunk._macro_step)
    ref = fetch(ref_chunk.apply_window_chunked(
        ref_make_table(1, 4), ref_chunk.build_chunked(batch)))
    got = convert.table_to_numpy(table)
    assert cursor.tolist() == [RAW_WINDOW]
    assert got["overflow"].tolist() == ref["overflow"].tolist() == [1]
    assert got["count"].tolist() == ref["count"].tolist() == [0]
    assert live_difference(ref, got) is None


def test_macro_steps_counts_chunks_on_the_host():
    starts = np.array([[1, 0, 0, 1, 0, 0, 0, 0, 0, 0],   # chunks 3 + 7
                       [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],   # one chunk of 10
                       [1, 1, 1, 1, 1, 1, 1, 1, 1, 1]])  # ten of one
    assert merge_chunk.macro_steps(starts, 8) == 10
    assert merge_chunk.macro_steps(starts[:2], 8) == 2
    assert merge_chunk.macro_steps(starts[:2], 4) == 3
    assert merge_chunk.macro_steps(starts[:1], 2) == 6
    assert merge_chunk.macro_steps(np.zeros((2, 0), np.int32), 8) == 0
    assert merge_chunk.macro_steps(torch.tensor(starts), 16) == 10
