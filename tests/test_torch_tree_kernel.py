"""The port's batched tree rebase (ROADMAP B8, plain torch on the CPU)
against the JAX package's: the same seeded changesets, encoded by each
package's own ``tree_atoms``, rebase to equal atoms on every field —
and, applied, to the node sequence the scalar mark-list algebra gives
(the mirror of ``tests/test_tree_kernel.py``). The port's copies of the
scalar algebra and the atom codec are held to the reference's too."""
import random

import numpy as np
import pytest
import torch

from fluidframework_tpu.models.tree import changeset as jcs
from fluidframework_tpu.ops import tree_atoms as jatoms
from fluidframework_tpu.ops import tree_kernel as jkernel
from fluidframework_tpu.testing.tree_fuzz import random_changeset, random_trunk
from fluidframework_tpu_torch.models.tree import changeset as pcs
from fluidframework_tpu_torch.models.tree.forest import Forest
from fluidframework_tpu_torch.ops import tree_atoms as patoms
from fluidframework_tpu_torch.ops import tree_kernel as pkernel
from fluidframework_tpu_torch.testing import tree_fuzz as pfuzz

FIELDS = ("kind", "pos", "n", "muted", "pos2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tree tests' tensors are small: one intra-op thread runs them
    faster and leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def base_seq(n):
    return [{"type": "n", "value": i} for i in range(n)]


def scalar_rebase_chain(c_marks, overs):
    change = {"root": c_marks}
    for o in overs:
        change = pcs.rebase(change, {"root": o})
    return change.get("root", [])


def encode_both(marks_list, allow_moves=True):
    """Each package's own encoding of the same mark lists, stacked
    ``[docs, A]``: (JAX TreeAtoms of numpy, port TreeAtoms of int32
    tensors, host content tables)."""
    jenc = [jatoms.encode_changeset(m, allow_moves=allow_moves)
            for m in marks_list]
    penc = [patoms.encode_changeset(m, allow_moves=allow_moves)
            for m in marks_list]
    for (je, jc), (pe, pc) in zip(jenc, penc):
        for f in FIELDS:
            assert np.array_equal(je[f], pe[f]), f
        assert jc == pc
    stacked = patoms.stack_changesets([e for e, _ in penc])
    return (jatoms.stack_changesets([e for e, _ in jenc]),
            patoms.TreeAtoms(*(torch.from_numpy(a) for a in stacked)),
            [c for _, c in penc])


def trunk_both(overs_per_doc):
    """[docs, K, A] trunks from per-doc lists of over mark lists."""
    per_doc = [[patoms.encode_changeset(o, allow_moves=False)[0]
                for o in overs] for overs in overs_per_doc]
    arrays = [np.stack([np.stack([t[f] for t in doc]) for doc in per_doc])
              for f in FIELDS]
    return (jatoms.TreeAtoms(*arrays),
            patoms.TreeAtoms(*(torch.from_numpy(a) for a in arrays)))


def assert_atoms_equal(jout, pout):
    """Every field, every doc, exactly; returns the port's as numpy."""
    out = {}
    for f in FIELDS:
        p = getattr(pout, f)
        assert p.dtype == torch.int32, f
        j = np.asarray(getattr(jout, f))
        assert np.array_equal(p.numpy(), j), f
        out[f] = p.numpy()
    return out


def canon(changes):
    """``changes`` with each move's pairing token (``mv``, drawn from a
    process-wide counter in each package) renamed by first appearance:
    the pairing stays, the counter's value goes."""
    names = {}

    def walk(x):
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        if isinstance(x, dict):
            return {k: names.setdefault(v, len(names)) if k == "mv"
                    else walk(v) for k, v in x.items()}
        return x

    return walk(changes)


def row(out, d):
    return {f: out[f][d] for f in FIELDS}


@pytest.mark.parametrize("seed", range(20))
def test_single_over_parity(seed):
    rng = random.Random(seed * 101 + 13)
    n = rng.randint(4, 16)
    base = base_seq(n)
    c_marks = random_changeset(rng, n, 3)
    o_marks = random_changeset(rng, n, 3)
    after_o = pcs.walk_apply(base, o_marks)
    expect = pcs.walk_apply(after_o, scalar_rebase_chain(c_marks, [o_marks]))

    jc, pc, contents = encode_both([c_marks])
    jo, po, _ = encode_both([o_marks])
    out = assert_atoms_equal(jkernel.rebase_atoms(jc, jo),
                             pkernel.rebase_atoms(pc, po))
    assert patoms.apply_atoms(after_o, row(out, 0), contents[0]) == expect


@pytest.mark.parametrize("seed", range(15))
def test_trunk_scan_parity(seed):
    """Rebase over a K-deep trunk suffix: the port's loop equals the
    JAX scan, and both equal the scalar sequential rebase."""
    rng = random.Random(seed * 7 + 3)
    n = rng.randint(6, 14)
    c_marks = random_changeset(rng, n, 3)
    overs, cur = random_trunk(rng, base_seq(n), rng.randint(2, 4), 3)
    expect = pcs.walk_apply(cur, scalar_rebase_chain(c_marks, overs))

    jc, pc, contents = encode_both([c_marks])
    jt, pt = trunk_both([overs])
    out = assert_atoms_equal(jkernel.rebase_over_trunk(jc, jt),
                             pkernel.rebase_over_trunk(pc, pt))
    assert patoms.apply_atoms(cur, row(out, 0), contents[0]) == expect


def test_batched_docs_independent():
    """Sixteen documents rebase independently in one call, each over its
    own 3-deep trunk."""
    rng = random.Random(99)
    cases = []
    for _ in range(16):
        n = rng.randint(4, 12)
        c = random_changeset(rng, n, 3)
        overs, cur = random_trunk(rng, base_seq(n), 3, 3)
        cases.append((c, overs, cur))
    jc, pc, contents = encode_both([c for c, _, _ in cases])
    jt, pt = trunk_both([o for _, o, _ in cases])
    out = assert_atoms_equal(jkernel.rebase_over_trunk(jc, jt),
                             pkernel.rebase_over_trunk(pc, pt))
    for d, (c_marks, overs, cur) in enumerate(cases):
        expect = pcs.walk_apply(cur, scalar_rebase_chain(c_marks, overs))
        assert patoms.apply_atoms(cur, row(out, d), contents[d]) == expect


@pytest.mark.parametrize("seed", range(15))
def test_kernel_move_parity_fuzz(seed):
    """MOV atoms rebased over a random ins/del/mod trunk: equal to the
    JAX kernel on every field and to the scalar algebra, delete-wins
    muting of both halves included."""
    rng = random.Random(seed * 41 + 5)
    base = base_seq(8)
    src = rng.randint(0, len(base) - 1)
    dst = rng.choice([d for d in range(len(base) + 1)
                      if d <= src or d >= src + 1])
    c_marks = pcs.stamp({"root": pcs.move(src, 1, dst)}, f"M{seed}")["root"]
    overs, cur = random_trunk(rng, base, rng.randint(1, 4), 3)

    f = Forest({"root": [dict(x) for x in base]})
    for i, o in enumerate(overs):
        f.apply({"root": o}, f"o{i}")
    f.apply({"root": scalar_rebase_chain(c_marks, overs)}, "scalar")

    jc, pc, contents = encode_both([c_marks])
    jt, pt = trunk_both([overs])
    out = assert_atoms_equal(jkernel.rebase_over_trunk(jc, jt),
                             pkernel.rebase_over_trunk(pc, pt))
    assert patoms.apply_atoms(cur, row(out, 0), contents[0]) == \
        f.content()["root"]


@pytest.mark.parametrize("seed", range(8))
def test_over_moves_and_muted_atoms(seed):
    """Over-changesets that carry MOV atoms (both halves shift) and
    pre-muted atoms: the port and JAX agree on every field."""
    rng = random.Random(seed + 500)
    docs = 6
    cs_marks, overs = [], []
    for _ in range(docs):
        n = rng.randint(3, 10)
        cs_marks.append(random_changeset(rng, n, 4, move_p=0.5))
        overs.append(random_changeset(rng, n, 4, move_p=0.5))
    jc, pc, _ = encode_both(cs_marks)
    jo, po, _ = encode_both(overs)
    mute = np.asarray(
        [[rng.random() < 0.2 for _ in range(jo.kind.shape[1])]
         for _ in range(docs)], np.int32)
    jo = jo._replace(muted=np.maximum(jo.muted, mute))
    po = po._replace(muted=torch.maximum(po.muted, torch.from_numpy(mute)))
    assert_atoms_equal(jkernel.rebase_atoms(jc, jo),
                       pkernel.rebase_atoms(pc, po))


@pytest.mark.parametrize("seed", range(10))
def test_scalar_algebra_matches_reference(seed):
    """The port's copy of the changeset algebra (the oracle's core):
    rebase, compose, invert and walk_apply equal the reference's on
    fuzzed changesets."""
    rng = random.Random(seed * 13 + 1)
    n = rng.randint(3, 12)
    a = random_changeset(rng, n, 3)
    b = random_changeset(rng, n, 3)
    assert pcs.rebase({"root": a}, {"root": b}) == \
        jcs.rebase({"root": a}, {"root": b})
    assert pcs.walk_apply(base_seq(n), a) == jcs.walk_apply(base_seq(n), a)
    # compose and invert need the mods' old values: stamped edits
    first = pfuzz.random_change_with_moves(rng, base_seq(n), "a")
    f = Forest({"root": base_seq(n)})
    f.apply(first, "a")
    second = pfuzz.random_change_with_moves(rng, f.content()["root"], "b")
    assert pcs.compose([first, second]) == jcs.compose([first, second])
    assert pcs.invert(first, "a") == jcs.invert(first, "a")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_generators_match_reference(seed):
    """The copied generators give the reference's changesets for the
    same seeds."""
    from fluidframework_tpu.testing import tree_fuzz as jfuzz

    jr, pr = random.Random(seed), random.Random(seed)
    base = base_seq(7)
    for i in range(5):
        assert canon(pfuzz.random_changeset(pr, 7, 3, move_p=0.3)) == \
            canon(jfuzz.random_changeset(jr, 7, 3, move_p=0.3))
        assert canon(pfuzz.random_change_with_moves(pr, base, f"u{i}")) \
            == canon(jfuzz.random_change_with_moves(jr, base, f"u{i}"))
    assert canon(pfuzz.random_trunk(pr, base, 3, move_p=0.5)) == \
        canon(jfuzz.random_trunk(jr, base, 3, move_p=0.5))


def test_device_inexpressible_marks_raise():
    with pytest.raises(ValueError):
        patoms.encode_changeset([pcs.rev(1, "uid", 0)])
    with pytest.raises(ValueError):
        patoms.encode_changeset([pcs.mod(fields={"x": [pcs.dele(1)]})])
    with pytest.raises(ValueError):
        patoms.encode_changeset([pcs.dele(1)] * (patoms.DEFAULT_ATOMS + 1))


def test_valueless_mod_encodes_as_skip():
    enc, content = patoms.encode_changeset(
        [pcs.skip(1), {"t": "mod"}, pcs.dele(1)])
    assert list(enc["kind"][:2]) == [2, 0]  # just the unit del
    assert enc["pos"][0] == 2
    assert patoms.apply_atoms([{"v": 0}, {"v": 1}, {"v": 2}], enc,
                              content) == [{"v": 0}, {"v": 1}]
