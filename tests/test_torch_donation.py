"""The donated double buffer and the ladder prewarm on the CPU: each
route's donating twin (``*_pingpong``) equals its plain twin bit for
bit, writes into the retired table and refuses one that aliases an
input; ``GpuMergeSidecar`` with donation on and off serves equal tables,
texts and signatures through a grow, a pool admission and an eviction;
``prewarm`` walks every capacity rung x window bucket and leaves the
live table alone; and the prewarm's capacity ceiling raises as the JAX
package's does."""
import numpy as np
import pytest
import torch

from fluidframework_tpu.drivers import LocalDocumentServiceFactory
from fluidframework_tpu.loader import Container
from fluidframework_tpu.service import LocalServer, TpuMergeSidecar
from fluidframework_tpu_torch.ops.event_graph import (
    apply_window_egwalker,
    apply_window_egwalker_pingpong,
    build_event_graph,
)
from fluidframework_tpu_torch.ops.host_bridge import fetch
from fluidframework_tpu_torch.ops.merge_chunk import (
    apply_window_chunked,
    apply_window_chunked_pingpong,
    compile_chunks,
)
from fluidframework_tpu_torch.ops.merge_kernel import (
    apply_window,
    apply_window_pingpong,
)
from fluidframework_tpu_torch.ops.segment_table import (
    SegmentTable,
    make_table,
)
from fluidframework_tpu_torch.parallel import make_seq_mesh
from fluidframework_tpu_torch.service import GpuMergeSidecar
from fluidframework_tpu_torch.service.gpu_sidecar import default_donate
from fluidframework_tpu_torch.testing import windows

ROUTES = ("scan", "chunked", "egwalker")


def _route_inputs(route, seed):
    """A seeded random table and window, and the route's (plain call,
    donating twin, program)."""
    rng = np.random.default_rng(seed)
    table = windows.random_table(rng, 6, 48, "cpu")
    batch = windows.random_batch(rng, table, 12, "cpu")
    arrays = {f: getattr(batch, f).numpy() for f in batch._fields}
    if route == "scan":
        return table, apply_window, apply_window_pingpong, batch
    if route == "chunked":
        return (table, apply_window_chunked, apply_window_chunked_pingpong,
                compile_chunks(arrays))
    program = build_event_graph(arrays)["prefix"]
    assert program is not None
    return (table, apply_window_egwalker, apply_window_egwalker_pingpong,
            program)


def _ptrs(table):
    return [t.untyped_storage().data_ptr() for t in table]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("route", ROUTES)
def test_twin_equals_plain_and_writes_into_dead(route, seed):
    table, plain, twin, program = _route_inputs(route, seed)
    before = SegmentTable(*(t.clone() for t in table))
    want = plain(table, program)
    dead = make_table(table.docs, table.capacity, "cpu")
    got = twin(dead, table, program)
    for f, a, b in zip(SegmentTable._fields, got, want):
        assert torch.equal(a, b), f
    assert _ptrs(got) == _ptrs(dead)
    assert set(_ptrs(got)).isdisjoint(_ptrs(table))
    for a, b in zip(table, before):  # the live input survives
        assert torch.equal(a, b)
    if route != "scan":  # no fodder: the plain call
        again = twin(None, table, program)
        for a, b in zip(again, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("route", ROUTES)
def test_twin_refuses_aliased_or_misshapen_dead(route):
    table, _, twin, program = _route_inputs(route, 2)
    fresh = make_table(table.docs, table.capacity, "cpu")
    for dead in (table,                               # the live input
                 fresh._replace(length=table.length),  # one field shared
                 fresh._replace(prop=table.prop[..., :]),  # a view of one
                 make_table(table.docs, table.capacity * 2, "cpu")):
        with pytest.raises(ValueError):
            twin(dead, table, program)


def _writer(server, sidecars, doc):
    factory = LocalDocumentServiceFactory(server)
    for sc in sidecars:
        sc.subscribe(server, doc, "d", "s")
    c = Container.load(factory.create_document_service(doc),
                       client_id=f"{doc}-w")
    return c, c.runtime.create_datastore("d").create_channel(
        "sharedstring", "s")


def _count_donations(sidecar):
    seen = {"donated": 0, "dispatches": 0}
    inner = sidecar._apply_program

    def hook(table, program, dead=None):
        out = inner(table, program, dead)
        seen["dispatches"] += 1
        if dead is not None:
            seen["donated"] += 1
            assert _ptrs(out) == _ptrs(dead) or "prefix" in program
            assert set(_ptrs(dead)).isdisjoint(_ptrs(table))
        return out

    sidecar._apply_program = hook
    return seen


@pytest.mark.parametrize("route", ROUTES)
def test_sidecar_donation_on_off_equal(route):
    """Grow (16 -> 32), a pool admission (past 32) and an eviction (a
    fifth property key) with donation on and off: equal tables, texts
    and signatures, each text its writer's."""
    server = LocalServer()
    sidecars = [GpuMergeSidecar(
        device="cpu", max_docs=4, capacity=16, max_capacity=32,
        pool_capacity=256, executor=route, donate=donate,
        seq_mesh=make_seq_mesh([torch.device("cpu")]))
        for donate in (False, True)]
    seen = _count_donations(sidecars[1])
    writers = {doc: _writer(server, sidecars, doc)
               for doc in ("small", "mid", "big", "props")}
    for r in range(12):
        for doc, n in (("small", 1), ("mid", 2), ("big", 6)):
            c, s = writers[doc]
            for _ in range(n):
                s.insert_text(0, "abcdefgh"[: 3 + r % 5])
                if s.get_length() > 10 and r % 3 == 2:
                    s.remove_text(2, 5)
            c.flush()
        if r == 5:
            c, s = writers["props"]
            s.insert_text(0, "hello world")
            for i, key in enumerate(["k1", "k2", "k3", "k4", "k5"]):
                s.annotate_range(0, 5, {key: i + 1})
            c.flush()
        for sc in sidecars:
            sc.apply()
    for sc in sidecars:
        sc.sync()
        assert sc.grow_count >= 1 and sc.pool_admit_count >= 1
        assert sc.evict_count >= 1
    off, on = sidecars
    assert seen["donated"] >= 3, seen
    a, b = fetch(off._table), fetch(on._table)
    for f in a:
        assert np.array_equal(a[f], b[f]), f
    for doc, (_, s) in writers.items():
        assert on.text(doc, "d", "s") == off.text(doc, "d", "s") == \
            s.get_text(), doc
        assert on.signature(doc, "d", "s") == off.signature(doc, "d", "s")


def test_donate_default_and_env(monkeypatch):
    monkeypatch.delenv("FFTPU_SIDECAR_DONATE", raising=False)
    assert not default_donate()
    assert not GpuMergeSidecar(device="cpu").donate
    assert GpuMergeSidecar(device="cpu", donate=True).donate
    for env, want in (("1", True), ("0", False)):
        monkeypatch.setenv("FFTPU_SIDECAR_DONATE", env)
        assert GpuMergeSidecar(device="cpu").donate is want
        assert GpuMergeSidecar(device="cpu", donate=not want).donate \
            is (not want)
    for bad in ("yes", "true", "2"):
        monkeypatch.setenv("FFTPU_SIDECAR_DONATE", bad)
        with pytest.raises(ValueError, match="FFTPU_SIDECAR_DONATE"):
            GpuMergeSidecar(device="cpu")


def _width(program):
    for key in ("scan", "suffix"):
        if program.get(key) is not None:
            return program[key].kind.shape[-1]
    block = program.get("chunked") or program["prefix"]
    return block["kind"].shape[-1]


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("route", ROUTES)
def test_prewarm_walks_the_ladder(route, donate):
    server = LocalServer()
    sc = GpuMergeSidecar(device="cpu", max_docs=4, capacity=16,
                         max_capacity=64, executor=route, donate=donate)
    c, s = _writer(server, [sc], "doc")
    s.insert_text(0, "hello prewarm")
    c.flush()
    sc.apply()
    sc.sync()
    live = fetch(sc._table)
    table_obj = sc._table
    walked = []
    inner = sc._apply_program

    def hook(table, program, dead=None):
        walked.append((table.capacity, _width(program), dead is not None))
        return inner(table, program, dead)

    sc._apply_program = hook
    assert sc.prewarm(max_bucket=32) >= 0.0
    shapes = [(c_, w) for c_ in (16, 32, 64) for w in (16, 32)]
    # the donating twin and, with donation on, the plain form a grow
    # re-applies; + the suffix's scan on the egwalker route
    per_shape = (2 if donate else 1) + (route == "egwalker")
    assert [(c_, w) for c_, w, _ in walked] == [
        x for x in shapes for _ in range(per_shape)]
    assert [d for _, _, d in walked] == [
        donate and (i % per_shape == 0) for i in range(len(walked))]
    assert sc._table is table_obj
    for f, a in fetch(sc._table).items():
        assert np.array_equal(a, live[f]), f
    assert sc.text("doc", "d", "s") == s.get_text()


def test_prewarm_capacity_ceiling_matches_reference():
    """At rung 16384 the op_off composite overflows int32: both
    packages' prewarm raise there (ROADMAP §C, mirrored not fixed)."""
    kw = dict(max_docs=2, capacity=8192, max_capacity=16384,
              executor="scan")
    with pytest.raises(AssertionError, match="16384"):
        TpuMergeSidecar(**kw).prewarm(max_bucket=16)
    port = GpuMergeSidecar(device="cpu", **kw)
    walked = []
    inner = port._apply_program

    def hook(table, program, dead=None):
        walked.append(table.capacity)
        return inner(table, program, dead)

    port._apply_program = hook
    with pytest.raises(AssertionError, match="16384"):
        port.prewarm(max_bucket=16)
    assert walked == [8192, 16384]
    GpuMergeSidecar(device="cpu", max_docs=2, capacity=4096,
                    max_capacity=8192, executor="scan").prewarm(max_bucket=16)
