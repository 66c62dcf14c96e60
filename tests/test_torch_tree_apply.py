"""The port's forest apply (ROADMAP B9, plain torch on the CPU) against
the JAX package's ``apply_tree_window``: the same packed windows of
recorded SharedTree traffic, on the same forest tables (moved across
through ``convert``), give equal tables on every field — ``content``,
``value``, ``count``, ``overflow``, every ``ring`` field, ``ring_seq``
and ``ring_session`` — on both routes, through parking inside a window
and ``pad_tree_capacity``. The port's trimmed window loop (host-counted
steps and rows, ``window_extent``) is held to its own full-bucket
program and to the reference's."""
import random

import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import tree_apply as J
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.ops import tree_apply as P
from fluidframework_tpu_torch.protocol.messages import MessageType
from fluidframework_tpu_torch.testing.tree_fuzz import record_tree_stream
from test_torch_tree_kernel import one_torch_thread  # noqa: F401

ROUTES = ("atom", "macro")
DOCS = 6


def encode_stream(mod, stream, width=P.DEFAULT_ATOMS):
    """One document's tree ops encoded by ``mod``'s ``encode_tree_commit``
    with the sidecar's session ordinals; returns (commits, content
    table, value table)."""
    content, value, sessions, out = [], [], {}, []
    for msg in stream:
        env = msg.contents if isinstance(msg.contents, dict) else {}
        if msg.type != MessageType.OPERATION or env.get("kind") != "op":
            continue
        out.append(mod.encode_tree_commit(
            env["contents"]["changes"].get("root", []), content, value,
            seq=msg.sequence_number, ref=msg.reference_sequence_number,
            session=sessions.setdefault(msg.client_id, len(sessions) + 1),
            width=width))
    return out, content, value


def corpus(seed, docs=DOCS, **kw):
    """Per-document commit lists (port encoding), each held equal to the
    reference's encoding of the same stream."""
    rng = random.Random(seed)
    per_doc = []
    for d in range(docs):
        _, stream = record_tree_stream(
            seed * 100 + d, rounds=rng.randint(3, 6), **kw)
        mine, ct, vt = encode_stream(P, stream)
        ref, rct, rvt = encode_stream(J, stream)
        assert (ct, vt) == (rct, rvt)
        for a, b in zip(mine, ref):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), k
        per_doc.append(mine)
    return per_doc


def windows(per_doc, depth):
    """Window k holds commits [k*depth, (k+1)*depth) of every doc."""
    longest = max(len(c) for c in per_doc)
    for start in range(0, longest, depth):
        yield {d: c[start:start + depth] for d, c in enumerate(per_doc)
               if c[start:start + depth]}


def leaves(tree):
    """The arrays of a TreeTable / TreeProgram, nested atoms flattened."""
    for f in tree:
        yield from (f if isinstance(f, tuple) else (f,))


def as_numpy(tree):
    return convert.tree_map(tree, np.asarray)


def as_ref(tree):
    """A port TreeTable / TreeProgram of numpy arrays as the reference's
    NamedTuple types."""
    cls = J.TreeTable if len(tree) == len(J.TreeTable._fields) \
        else J.TreeProgram
    return cls(*(J.TreeAtoms(*f) if isinstance(f, tuple) else f
                 for f in as_numpy(tree)))


def both_programs(queued, docs=DOCS, **kw):
    """The numpy programs each package packs from the same queue, held
    equal; returns the port's."""
    mine = P.pack_tree_window(docs, queued, **kw)
    ref = J.pack_tree_window(docs, queued, **kw)
    for x, y in zip(leaves(mine), leaves(ref), strict=True):
        assert np.array_equal(x, y)
    return mine


def assert_tables_equal(ref, port, ctx=""):
    """Every field of two TreeTables (the reference's, the port's),
    exactly, int32 on the port side."""
    order = list(J.TreeTable._fields)
    names = order[:order.index("ring")] + \
        [f"ring.{f}" for f in J.TreeAtoms._fields] + \
        order[order.index("ring") + 1:]
    for name, a, b in zip(names, leaves(as_numpy(ref)), leaves(port),
                          strict=True):
        assert b.dtype == torch.int32, name
        assert np.array_equal(a, b.numpy()), f"{ctx} {name}"


def run_three(route, table_np, program):
    """Apply one numpy program to one numpy table three ways: the
    reference, the port trimmed to ``window_extent``, the port over the
    full bucket."""
    ref = J.apply_tree_window(as_ref(table_np), as_ref(program), route)
    dev = convert.tree_program_to_device(program, "cpu")
    start = convert.tree_table_from_numpy(table_np, "cpu")
    steps, rows = P.window_extent(program)
    trimmed = P.apply_tree_window(start, dev, route, steps=steps, rows=rows)
    full = P.apply_tree_window(start, dev, route)
    return ref, trimmed, full


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", range(3))
def test_windows_match_reference(route, seed):
    """Recorded traffic (seeding, three writers racing moves, removes,
    inserts and sets), four commits per doc per window, at a capacity
    some documents outgrow (they stay parked through the later
    windows): every window, every field equal. The trimmed loop is the
    port's; the full bucket is held to it in the tests below."""
    per_doc = corpus(seed, seed_nodes=24, seed_chunk=8)
    table = as_numpy(P.make_tree_table(DOCS, 28, "cpu"))
    for k, queued in enumerate(windows(per_doc, 4)):
        program = both_programs(queued)
        ref = J.apply_tree_window(as_ref(table), as_ref(program), route)
        steps, rows = P.window_extent(program)
        port = P.apply_tree_window(
            convert.tree_table_from_numpy(table, "cpu"),
            convert.tree_program_to_device(program, "cpu"), route,
            steps=steps, rows=rows)
        assert_tables_equal(ref, port, f"window {k}")
        table = as_numpy(ref)
    assert 0 < table.overflow.sum() < DOCS


@pytest.mark.parametrize("route", ROUTES)
def test_parking_within_one_window_and_pad(route):
    """A window whose inserts pass the capacity mid-window parks those
    documents (state, ring and count stop at the last step that fit;
    ``overflow`` is set); padding the pre-window snapshot and
    re-applying the same window clears it — equal to the reference at
    every stage."""
    per_doc = corpus(11, seed_nodes=32, seed_chunk=8)
    snapshot = as_numpy(P.make_tree_table(DOCS, 16, "cpu"))
    queued = next(windows(per_doc, 8))
    program = both_programs(queued)
    ref, trimmed, full = run_three(route, snapshot, program)
    assert_tables_equal(ref, trimmed, "parked")
    assert_tables_equal(ref, full, "parked")
    parked = trimmed.overflow.numpy()
    assert parked.any()
    # two 8-node seed commits fit 16 slots; the third parks the doc
    assert (trimmed.count.numpy()[parked > 0] == 16).all()

    padded_ref = J.pad_tree_capacity(as_ref(snapshot), 64)
    padded = P.pad_tree_capacity(
        convert.tree_table_from_numpy(snapshot, "cpu"), 64)
    assert_tables_equal(padded_ref, padded, "padded")
    ref, trimmed, full = run_three(route, as_numpy(padded), program)
    assert_tables_equal(ref, trimmed, "re-applied")
    assert_tables_equal(ref, full, "re-applied")
    assert not trimmed.overflow.any()


@pytest.mark.parametrize("route", ROUTES)
def test_trimmed_loop_on_ragged_window(route):
    """Documents with 0..7 commits in one 16-step bucket, one of them
    parked from the start: the trimmed loop (``steps`` = the deepest
    real step, ``rows`` = the busiest document's rows) equals the full
    bucket and the reference on every field."""
    per_doc = corpus(5, seed_nodes=16, seed_chunk=8)
    queued = {d: c[:d + 2] for d, c in enumerate(per_doc) if d != 2}
    table = as_numpy(P.make_tree_table(DOCS, 64, "cpu"))
    table.overflow[4] = 1
    program = both_programs(queued)
    steps, rows = P.window_extent(program)
    assert steps == max(len(c) for c in queued.values()) < program.window
    assert len(rows) == steps and max(rows) < 2 * P.DEFAULT_ATOMS
    ref, trimmed, full = run_three(route, table, program)
    assert_tables_equal(ref, trimmed, "trimmed")
    assert_tables_equal(ref, full, "full")
    assert np.array_equal(trimmed.content[4].numpy(), table.content[4])


def test_window_extent_counts():
    program = P.pack_tree_window(3, {
        0: [P.encode_tree_commit([{"t": "ins", "content": [{"type": "n"}]}],
                                 [], [], seq=1, ref=0, session=1)],
        2: [P.noop_tree_commit()] * 2 + [P.encode_tree_commit(
            [{"t": "skip", "n": 1},
             {"t": "del", "n": 1, "did": ["m", 0]},
             {"t": "rev", "n": 1, "rev": "m", "idx": 0}],
            [], [], seq=5, ref=1, session=2)],
    })
    assert program.window == 16
    # step 0: one INS row; step 1: padding; step 2: one MOV = 2 rows
    assert P.window_extent(program) == (3, [1, 0, 2])
    empty = P.pack_tree_window(3, {})
    assert P.window_extent(empty) == (0, [])


def test_host_half_matches_reference():
    """make_tree_table, ring_safe, noop_tree_commit and decode_tree_row
    equal the reference's."""
    assert_tables_equal(J.make_tree_table(4, 32, ring=8, atoms=16),
                        P.make_tree_table(4, 32, "cpu", ring=8, atoms=16))
    for hist, ref in (([], 0), ([3, 4], 1), (list(range(5, 21)), 4),
                      (list(range(5, 21)), 5)):
        assert P.ring_safe(hist, ref) == J.ring_safe(hist, ref)
    mine, theirs = P.noop_tree_commit(), J.noop_tree_commit()
    assert mine.keys() == theirs.keys()
    assert all(np.array_equal(mine[k], theirs[k]) for k in mine)
    content = [{"type": "n", "value": i} for i in range(4)]
    values = [{"new": 7, "old": 1}]
    row_c, row_v = np.array([2, 0, 3, -1]), np.array([-1, 0, -1, -1])
    assert P.decode_tree_row(row_c, row_v, 3, content, values) == \
        J.decode_tree_row(row_c, row_v, 3, content, values)
    with pytest.raises(ValueError, match="route"):
        P.apply_tree_window(P.make_tree_table(1, 4, "cpu"), None,
                            route="scan")
