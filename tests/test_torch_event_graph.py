"""The port's egwalker route against the JAX package's, and against the
port's scan, on the same op windows: ``build_event_graph`` (graph,
critical prefix, concurrent suffix, ``span_splits``) array for array,
and ``apply_window_egwalker`` / ``apply_batch_egwalker`` on the live
slots of every field plus ``count``, ``min_seq`` and ``overflow``.
Corpora: sequential, remove-heavy (so that event splitting absorbs span
breaks), concurrent and mixed, from the reference's seeded recorders,
plus the targeted windows of the reference's own egwalker tests."""
import numpy as np
import pytest

from fluidframework_tpu.ops import build_batch, encode_stream, fetch
from fluidframework_tpu.ops import event_graph as ref_eg
from fluidframework_tpu.ops import make_table as ref_make_table
from fluidframework_tpu.ops.merge_kernel import apply_window_impl
from fluidframework_tpu.ops.segment_table import (
    KIND_ANNOTATE,
    KIND_INSERT,
    KIND_NOOP,
    KIND_REMOVE,
    OpBatch,
)
from fluidframework_tpu.testing import (
    FuzzConfig,
    record_op_stream,
    record_sequential_stream,
)
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.ops import event_graph, merge_chunk, merge_kernel
from fluidframework_tpu_torch.ops.segment_table import make_table
from fluidframework_tpu_torch.testing.windows import live_difference

DOCS, WINDOW, CAP = 4, 128, 512
RAW_WINDOW, RAW_CAP = 16, 64


def _arrays(batch) -> dict:
    return {f: np.asarray(getattr(batch, f), np.int32)
            for f in OpBatch._fields}


def assert_same_program(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    assert got["egwalker"] is want["egwalker"] is True
    assert got["k"] == want["k"]
    for f, arr in want["graph"]._asdict().items():
        ours = getattr(got["graph"], f)
        assert ours.dtype == arr.dtype, f
        np.testing.assert_array_equal(ours, arr, err_msg=f)
    np.testing.assert_array_equal(got["span_splits"], want["span_splits"])
    assert got["span_splits"].dtype == want["span_splits"].dtype
    for half in ("prefix", "suffix"):
        if want[half] is None:
            assert got[half] is None, half
            continue
        assert got[half].keys() == want[half].keys(), half
        for f, arr in want[half].items():
            assert got[half][f].dtype == arr.dtype, (half, f)
            np.testing.assert_array_equal(got[half][f], arr,
                                          err_msg=f"{half}.{f}")


def run_routes(batch, capacity, base_head=None):
    """The reference batch through the JAX scan and egwalker routes and
    the port's egwalker route and scan: asserts equal programs, equal
    tables, and that the walker loop left every cursor at the prefix
    window's end. Returns the port's program and table (numpy)."""
    D = np.asarray(batch.kind).shape[0]
    arrays = _arrays(batch)
    want = ref_eg.build_event_graph(arrays, base_head=base_head)
    program = event_graph.build_event_graph(arrays, base_head=base_head)
    assert_same_program(program, want)

    ref_scan = fetch(apply_window_impl(ref_make_table(D, capacity), batch))
    ref_walk = fetch(ref_eg.apply_batch_egwalker(
        ref_make_table(D, capacity), batch, base_head=base_head))
    got = convert.table_to_numpy(event_graph.apply_batch_egwalker(
        make_table(D, capacity, "cpu"),
        convert.batch_from_numpy(arrays, "cpu"), base_head=base_head))
    port_scan = convert.table_to_numpy(merge_kernel.apply_window_plain(
        make_table(D, capacity, "cpu"),
        convert.batch_from_numpy(arrays, "cpu")))
    for what, ref in (("JAX egwalker", ref_walk), ("JAX scan", ref_scan),
                      ("port scan", port_scan)):
        diff = live_difference(ref, got)
        assert diff is None, f"port egwalker vs {what}: {diff}"

    if program["prefix"] is not None:
        P = program["prefix"]["kind"].shape[1]
        walked, cursor = merge_chunk.run_macro_steps(
            make_table(D, capacity, "cpu"), program["prefix"],
            event_graph.EG_K, event_graph._walker_step)
        assert cursor.tolist() == [P] * D
        prefix_only = fetch(ref_eg.apply_window_egwalker(
            ref_make_table(D, capacity), want["prefix"]))
        diff = live_difference(prefix_only, convert.table_to_numpy(walked))
        assert diff is None, f"walker prefix vs JAX: {diff}"
    return program, got


def _corpus(kind: str, seed: int):
    """One stream of a config14 corpus, at test size."""
    if kind == "sequential":
        return record_sequential_stream(seed=seed, n_steps=80)[1]
    if kind == "remove_heavy":
        return record_sequential_stream(seed=seed, n_steps=80,
                                        remove_weight=0.45)[1]
    if kind == "concurrent":
        return record_op_stream(FuzzConfig(
            n_clients=4, n_steps=80, seed=seed, insert_weight=0.55,
            remove_weight=0.25, annotate_weight=0.05,
            process_weight=0.05))[1]
    return record_op_stream(FuzzConfig(
        n_clients=3, n_steps=80, seed=seed, insert_weight=0.55,
        remove_weight=0.25, annotate_weight=0.05, process_weight=0.15))[1]


CORPORA = ("sequential", "remove_heavy", "concurrent", "mixed")
CASES = [
    (kind, seed) if seed == 0 else pytest.param(
        kind, seed, marks=pytest.mark.slow)
    for kind in CORPORA for seed in range(4)
]


@pytest.mark.parametrize("kind,seed", CASES)
def test_corpus(kind, seed):
    streams = [_corpus(kind, 100 * seed + d) for d in range(DOCS)]
    batch = build_batch([encode_stream(s) for s in streams], window=WINDOW)
    program, _ = run_routes(batch, CAP)
    if kind in ("sequential", "remove_heavy"):
        assert program["suffix"] is None  # the fast path was taken
    if kind == "remove_heavy":
        assert program["span_splits"].sum() > 0
    if kind == "concurrent":
        assert program["suffix"] is not None


@pytest.mark.parametrize("kind", [
    k if k in ("sequential", "mixed") else pytest.param(
        k, marks=pytest.mark.slow) for k in CORPORA])
def test_corpus_with_applied_history(kind):
    """A nonzero ``base_head`` (the sidecar's per-slot applied head)
    demotes ops whose refseq predates it to the suffix: the programs
    and tables still agree."""
    streams = [_corpus(kind, 7 + d) for d in range(DOCS)]
    batch = build_batch([encode_stream(s) for s in streams], window=WINDOW)
    seq = np.asarray(batch.seq)
    base_head = (seq.max(axis=1) // 3).astype(np.int64)
    assert base_head.min() > 0
    run_routes(batch, CAP, base_head=base_head)


def _raw(rows):
    base = dict(kind=KIND_NOOP, pos1=0, pos2=0, seq=0, refseq=0,
                client=0, op_id=0, length=0, is_marker=0,
                prop_key=0, prop_val=0, min_seq=0)
    arrs = {f: np.zeros((1, RAW_WINDOW), np.int32) for f in OpBatch._fields}
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


# (name, rows, {lane: prefix chunk_start flag}, span_splits or None)
TARGETED = [
    ("frontier and parents",
     [_ins(0, 1, 0, 0, 0, 2), _ins(0, 2, 0, 1, 1, 1),
      _ins(1, 3, 2, 0, 2, 1)], {}, None),
    ("cross-client span",
     [_ins(0, 1, 0, 0, 0, 4), _ins(4, 2, 1, 1, 1, 2), _rm(0, 6, 3, 2, 0)],
     {0: 1, 1: 0, 2: 0}, None),
    ("cross-client same anchor",
     [_ins(0, 1, 0, 0, 0, 1), _ins(1, 2, 1, 1, 1, 1),
      _ins(0, 3, 2, 2, 2, 1)], {}, None),
    ("anchor inside foreign text",
     [_ins(0, 1, 0, 0, 0, 4), _ins(2, 2, 1, 1, 1, 1)], {0: 1, 1: 1}, None),
    ("open-span aging split",
     [_ins(0, 1, 0, 0, 0, 3), _rm(1, 2, 2, 1, 1),
      _ins(1, 3, 2, 2, 1, 1, min_seq=2)], {2: 0}, 1),
    ("aged anchor pass-through",
     [_ins(0, 1, 0, 0, 0, 4), _rm(1, 3, 2, 1, 1),
      dict(kind=KIND_NOOP, min_seq=2), _ins(1, 3, 2, 2, 1, 2)], {}, 1),
    ("committed aging collision",
     [_ins(0, 1, 0, 0, 0, 2), _rm(1, 2, 2, 1, 1),
      _ins(1, 3, 2, 2, 1, 1, min_seq=2), _ins(1, 4, 3, 3, 2, 1)],
     {3: 1}, None),
    ("remove-heavy burst",
     [op for i in range(6) for op in (
         _ins(i, 2 * i + 1, 2 * i, 0, i, 1, min_seq=max(0, 2 * i - 1)),
         _rm(0, 1, 2 * i + 2, 2 * i + 1, 0, min_seq=2 * i))],
     {0: 1}, None),
    ("min_seq on noops",
     [_ins(0, 1, 0, 0, 0, 3), dict(kind=KIND_NOOP, min_seq=1),
      _rm(0, 1, 2, 1, 0, min_seq=1)], {}, None),
    # client index 31 sets the removers sign bit; a blind remove by
    # client 5 makes the rest of the window a concurrent suffix
    ("client 31 removes",
     [_ins(0, 1, 0, 0, 0, 6), _rm(1, 3, 2, 1, 31), _ins(1, 3, 2, 31, 1, 2),
      dict(kind=KIND_ANNOTATE, pos1=0, pos2=3, seq=4, refseq=3,
           client=31, prop_key=2, prop_val=4),
      _rm(0, 4, 5, 1, 5)], {}, None),
]


@pytest.mark.parametrize("name,rows,starts,splits", TARGETED,
                         ids=[t[0] for t in TARGETED])
def test_targeted_window(name, rows, starts, splits):
    program, got = run_routes(_raw(rows), RAW_CAP)
    for lane, flag in starts.items():
        assert program["prefix"]["chunk_start"][0, lane] == flag, lane
    if splits is not None:
        assert program["span_splits"][0] == splits
    if name == "frontier and parents":
        g = program["graph"]
        assert g.parent_own[0, :3].tolist() == [-1, -1, 0]
        assert g.frontier_other[0, :3].tolist() == [0, 1, 2]
        assert g.critical[0, :3].tolist() == [1, 0, 1]
        assert g.prefix_len.tolist() == [1]
    if name == "committed aging collision":
        assert got["seq"][0, :4].tolist() == [1, 4, 3, 1]
    if name == "remove-heavy burst":
        assert program["prefix"]["chunk_start"][0].sum() == 1
        assert program["span_splits"][0] >= 3
    if name == "client 31 removes":
        assert program["suffix"] is not None
        live = got["removers"][0, :got["count"][0]]
        assert (live & np.uint32(1 << 31)).any()


def test_base_head_gates_history():
    rows = [_ins(0, 5, 3, 0, 0, 1)]
    arrays = _arrays(_raw(rows))
    for head, critical in ((None, 1), (np.array([4], np.int64), 0)):
        want = ref_eg.build_event_graph(arrays, base_head=head)
        got = event_graph.build_event_graph(arrays, base_head=head)
        assert_same_program(got, want)
        assert got["graph"].critical[0, 0] == critical


def test_overflow_parks_the_document():
    batch = _raw([_ins(0, i + 1, i, 0, i, 1) for i in range(10)])
    D = 1
    ref = fetch(ref_eg.apply_batch_egwalker(ref_make_table(D, 4), batch))
    got = convert.table_to_numpy(event_graph.apply_batch_egwalker(
        make_table(D, 4, "cpu"), convert.batch_from_numpy(
            _arrays(batch), "cpu")))
    assert got["overflow"].tolist() == ref["overflow"].tolist() == [1]
    assert live_difference(ref, got) is None


def test_registry_and_validation_match_reference():
    assert event_graph.EXECUTOR_ROUTES == ref_eg.EXECUTOR_ROUTES
    assert event_graph.EG_K == ref_eg.EG_K
    assert 1 <= event_graph.EG_K <= 31
    for route in event_graph.EXECUTOR_ROUTES + (None,):
        event_graph.validate_executor(route, "executor")
    with pytest.raises(ValueError, match="executor='egwalkr'"):
        event_graph.validate_executor("egwalkr", "executor")
