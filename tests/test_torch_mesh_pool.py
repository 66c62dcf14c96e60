"""The port's doc-sharded pool (``MeshShardedPool`` on ``[cpu] * n``)
and its route selection against the JAX package's, on the same
sequenced messages from the reference ``LocalServer``: the same pool
tier chosen, the same placement (``row_of``), the same migrations and
the same served text and signature per member, through admission,
eviction, hot-spot migration and a migration racing a recovery rebuild.
Also the row gather (B6), the window floor and the sharded-table
conversion against the reference's forms."""
import jax
import numpy as np
import pytest
import torch

from fluidframework_tpu.drivers import LocalDocumentServiceFactory
from fluidframework_tpu.loader import Container
from fluidframework_tpu.ops import fetch
from fluidframework_tpu.ops.shard_moves import take_rows as ref_take_rows
from fluidframework_tpu.parallel import make_mesh as ref_mesh
from fluidframework_tpu.parallel import make_seq_mesh as ref_seq_mesh
from fluidframework_tpu.service import LocalServer, TpuMergeSidecar
from fluidframework_tpu.service.tpu_sidecar import select_pool as ref_select
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.ops.host_bridge import DocStream
from fluidframework_tpu_torch.ops.shard_moves import migrate_rows, take_rows
from fluidframework_tpu_torch.parallel import (
    DeviceMesh,
    MeshShardedPool,
    global_window_floor,
    make_mesh,
    make_seq_mesh,
    shard_table,
)
from fluidframework_tpu_torch.service import GpuMergeSidecar
from fluidframework_tpu_torch.service.gpu_sidecar import (
    SeqShardedPool,
    select_pool,
)
from fluidframework_tpu_torch.testing import windows

CPU = torch.device("cpu")


def _cpus(n):
    return [CPU] * n


def _open_doc(server, sidecars, doc):
    factory = LocalDocumentServiceFactory(server)
    for sc in sidecars:
        sc.subscribe(server, doc, "d", "s")
    c = Container.load(factory.create_document_service(doc),
                       client_id=f"{doc}-w")
    return c, c.runtime.create_datastore("d").create_channel(
        "sharedstring", "s")


def _grow_into_pool(c, s, n_chunks=20):
    for i in range(n_chunks):
        s.insert_text(0, "abcdefgh")
        c.flush()
        if i % 3 == 2 and s.get_length() > 6:
            s.remove_text(2, 5)
            c.flush()


def _settle(sidecars):
    for sc in sidecars:
        sc.apply()
        sc.sync()


def _assert_parity(sidecars, docs, strings):
    ref = sidecars[0]
    for doc in docs:
        want = strings[doc].get_text()
        for sc in sidecars:
            assert sc.text(doc, "d", "s") == want, (type(sc), doc)
            assert sc.signature(doc, "d", "s") == \
                ref.signature(doc, "d", "s"), (type(sc), doc)


# ======================================================================
# route selection (one place: select_pool), held to the reference's


@pytest.mark.parametrize("axes,n", [
    ("docs", 4), ("seq", 4), ("seq", 1), ("docs", 1)])
def test_select_pool_routes_by_mesh_axes(axes, n):
    if axes == "docs":
        ref, port = ref_mesh(jax.devices()[:n]), make_mesh(_cpus(n))
    else:
        ref, port = ref_seq_mesh(jax.devices()[:n]), make_seq_mesh(_cpus(n))
    want, got = ref_select(ref, 128), select_pool(port, 128)
    assert type(got).__name__ == type(want).__name__
    assert got.capacity == want.capacity


def test_select_pool_env_and_arg_override(monkeypatch):
    docs1, seq1 = make_mesh(_cpus(1)), make_seq_mesh(_cpus(1))
    assert isinstance(select_pool(seq1, 128, route="seq"), SeqShardedPool)
    monkeypatch.setenv("FFTPU_SIDECAR_POOL", "mesh")
    assert isinstance(select_pool(docs1, 128), MeshShardedPool)
    monkeypatch.setenv("FFTPU_SIDECAR_POOL", "seq")
    with pytest.raises(ValueError, match="seq pool needs"):
        select_pool(docs1, 128)
    monkeypatch.setenv("FFTPU_SIDECAR_POOL", "warp")
    with pytest.raises(ValueError, match="FFTPU_SIDECAR_POOL"):
        select_pool(docs1, 128)
    monkeypatch.delenv("FFTPU_SIDECAR_POOL")
    with pytest.raises(ValueError, match="pool_route='msh'"):
        select_pool(seq1, 128, route="msh")
    with pytest.raises(ValueError, match="pool_route='msh'"):
        GpuMergeSidecar(device="cpu", seq_mesh=seq1, pool_route="msh")


def test_select_pool_defaults(monkeypatch):
    """The default route resolves the sidecar's executor, and the
    default capacities follow the reference's rules."""
    monkeypatch.setenv("FFTPU_SIDECAR_EXECUTOR", "chunked")
    assert select_pool(make_mesh(_cpus(1)), 128).executor == "chunked"
    monkeypatch.setenv("FFTPU_SIDECAR_EXECUTOR", "scan")
    assert select_pool(make_mesh(_cpus(1)), 128).executor == "scan"
    assert select_pool(make_mesh(_cpus(2)), max_capacity=32).capacity == 128
    assert select_pool(make_mesh(_cpus(2))).capacity == 8192
    assert select_pool(make_seq_mesh(_cpus(2)),
                       max_capacity=64).capacity == 128


def test_mesh_pool_rejects_bad_meshes():
    with pytest.raises(ValueError, match="mesh axis"):
        MeshShardedPool(make_seq_mesh(_cpus(2)), 128, doc_axis="absent")
    with pytest.raises(ValueError, match="documents only"):
        MeshShardedPool(make_seq_mesh(_cpus(4), doc_shards=2), 128)
    with pytest.raises(ValueError, match="capacity"):
        MeshShardedPool(make_mesh(_cpus(2)), 8)
    with pytest.raises(ValueError, match="no merge apply"):
        DeviceMesh(["cpu", "meta"], ("docs",))


# ======================================================================
# the pool tier end to end, beside the reference sidecar


def _pair(n_shards, **kw):
    return (TpuMergeSidecar(seq_mesh=ref_mesh(jax.devices()[:n_shards]),
                            **kw),
            GpuMergeSidecar(device="cpu", seq_mesh=make_mesh(
                _cpus(n_shards)), **kw))


def test_overgrown_docs_spread_across_shards():
    server = LocalServer()
    sidecars = _pair(4, max_docs=8, capacity=16, max_capacity=32,
                     pool_capacity=256)
    docs, strings = [f"doc-{i}" for i in range(4)], {}
    for doc in docs:
        c, s = _open_doc(server, sidecars, doc)
        _grow_into_pool(c, s, n_chunks=60)
        strings[doc] = s
    _settle(sidecars)
    ref, port = sidecars
    assert port.pooled_docs() == ref.pooled_docs() == 4
    assert port.host_mode_docs() == 0
    assert port._pool.shard_members == ref._pool.shard_members
    assert [len(m) for m in port._pool.shard_members] == [1, 1, 1, 1]
    _assert_parity(sidecars, docs, strings)


def test_mesh_pool_eviction_keeps_survivors_correct():
    server = LocalServer()
    sidecars = _pair(2, max_docs=4, capacity=16, max_capacity=32,
                     pool_capacity=128)
    a_c, a_s = _open_doc(server, sidecars, "doc-a")
    b_c, b_s = _open_doc(server, sidecars, "doc-b")
    _grow_into_pool(a_c, a_s, n_chunks=60)
    _grow_into_pool(b_c, b_s, n_chunks=60)
    _settle(sidecars)
    for _ in range(120):
        a_s.insert_text(0, "zzzzzzzz")
        a_c.flush()
    _settle(sidecars)
    ref, port = sidecars
    assert (port.host_mode_docs(), port.pooled_docs()) == (1, 1)
    b_s.insert_text(0, "still-alive-")
    b_c.flush()
    _settle(sidecars)
    assert port.pooled_docs() == ref.pooled_docs() == 1
    _assert_parity(sidecars, ["doc-a", "doc-b"],
                   {"doc-a": a_s, "doc-b": b_s})


# ======================================================================
# the migration differential


def _hotspot(server, n_docs=3):
    """The reference and the port, each on a 2-shard docs mesh
    (migrations expected) and a one-shard seq mesh (the never-migrated
    oracle); max_capacity == capacity, so every overgrown doc pools at
    its first overflow."""
    kw = dict(max_docs=6, capacity=16, max_capacity=16, pool_capacity=256)
    sidecars = [
        TpuMergeSidecar(seq_mesh=ref_mesh(jax.devices()[:2]), **kw),
        GpuMergeSidecar(device="cpu", seq_mesh=make_mesh(_cpus(2)), **kw),
        GpuMergeSidecar(device="cpu", seq_mesh=make_seq_mesh(_cpus(1)),
                        **kw),
    ]
    assert isinstance(sidecars[1]._pool, MeshShardedPool)
    assert isinstance(sidecars[2]._pool, SeqShardedPool)
    docs, containers, strings = [], {}, {}
    for i in range(n_docs):
        doc = f"doc-{i}"
        containers[doc], strings[doc] = _open_doc(server, sidecars, doc)
        docs.append(doc)
    return sidecars, docs, containers, strings


def _hot_rounds(sidecars, docs, containers, strings, rounds):
    for _ in range(rounds):
        for doc in docs:
            for _ in range(12 if doc == "doc-0" else 1):
                strings[doc].insert_text(0, "XY")
            containers[doc].flush()
        _settle(sidecars)


def _assert_same_placement(ref_pool, pool):
    assert pool.row_of == ref_pool.row_of
    assert pool.shard_members == ref_pool.shard_members
    assert pool.migration_count == ref_pool.migration_count


def test_hotspot_migration_is_bit_exact_vs_single_shard_pool():
    server = LocalServer()
    sidecars, docs, containers, strings = _hotspot(server)
    for doc in docs:
        _grow_into_pool(containers[doc], strings[doc])
    _settle(sidecars)
    assert [sc.pooled_docs() for sc in sidecars] == [3, 3, 3]
    _hot_rounds(sidecars, docs, containers, strings, 6)
    ref, port, oracle = sidecars
    assert port._pool.migration_count > 0
    _assert_same_placement(ref._pool, port._pool)
    assert oracle._pool.dispatch_count > 0
    assert [sc.host_mode_docs() for sc in sidecars] == [0, 0, 0]
    _assert_parity(sidecars, docs, strings)


def test_migration_racing_overflow_recovery_rebuild():
    """After a migration, ONE apply carries deferred ops for the migrated
    members and a fourth doc overflowing into the pool: the admission
    rebuild subsumes them exactly once, keeping the migrated placement;
    then a fresh primary overflow left unsettled while a migrated
    member's ops are packed."""
    server = LocalServer()
    sidecars, docs, containers, strings = _hotspot(server)
    for doc in docs:
        _grow_into_pool(containers[doc], strings[doc])
    _settle(sidecars)
    _hot_rounds(sidecars, docs, containers, strings, 4)
    ref, port, _ = sidecars
    assert port._pool.migration_count > 0
    before = [list(m) for m in port._pool.shard_members]
    for late in ("doc-late", "doc-x"):
        containers[late], strings[late] = _open_doc(server, sidecars, late)
        docs.append(late)
    for doc in docs[:3]:
        for _ in range(3):
            strings[doc].insert_text(0, "AB")
        containers[doc].flush()
    for _ in range(20):
        strings["doc-late"].insert_text(0, "qrstuvwx")
    containers["doc-late"].flush()
    _settle(sidecars)
    assert [sc.pooled_docs() for sc in sidecars] == [4, 4, 4]
    for shard, members in enumerate(before):
        assert port._pool.shard_members[shard][:len(members)] == members
    _assert_parity(sidecars, docs, strings)
    for _ in range(20):
        strings["doc-x"].insert_text(0, "qrstuvwx")
    containers["doc-x"].flush()
    for sc in sidecars:
        sc.apply()  # no sync: recovery waits for the next settle
    for _ in range(3):
        strings["doc-0"].insert_text(0, "Z")
    containers["doc-0"].flush()
    _settle(sidecars)
    assert [sc.pooled_docs() for sc in sidecars] == [5, 5, 5]
    _assert_same_placement(ref._pool, port._pool)
    _assert_parity(sidecars, docs, strings)


# ======================================================================
# loud off-route fallbacks


def _one_noop_stream():
    streams = [DocStream()]
    streams[0].add_noop(0)
    return streams


def test_seq_pool_off_route_fallback_is_loud(capsys):
    pool = SeqShardedPool(make_seq_mesh(_cpus(4)), 256, executor="chunked")
    streams = _one_noop_stream()
    pool.admit([0], streams)
    assert "scan-collective route" in capsys.readouterr().err
    streams[0].add_noop(1)
    pool.dispatch_pending(streams)  # once per instance, not per dispatch
    assert "scan-collective" not in capsys.readouterr().err


def test_mesh_pool_chunked_request_is_loud_on_multishard(capsys):
    pool = MeshShardedPool(make_mesh(_cpus(2)), 128, executor="chunked")
    pool.admit([0], _one_noop_stream())
    assert "scan window body" in capsys.readouterr().err


def test_mesh_pool_single_shard_follows_chunked_route(capsys):
    pool = MeshShardedPool(make_mesh(_cpus(1)), 128, executor="chunked")
    assert pool.admit([0], _one_noop_stream()) == []
    assert pool._route_warned is False
    assert capsys.readouterr().err == ""


# ======================================================================
# the row gather (B6), the window floor, the sharded table's forms


def _ref_table(seed, docs=8, cap=32):
    rng = np.random.default_rng(seed)
    return convert.table_to_numpy(windows.random_table(rng, docs, cap, "cpu"))


def test_take_and_migrate_rows_match_reference():
    import jax.numpy as jnp

    from fluidframework_tpu.ops.segment_table import SegmentTable as RefTable

    arrays = _ref_table(11)
    perm = np.random.default_rng(12).permutation(8)
    want = fetch(ref_take_rows(
        RefTable(**{f: jnp.asarray(a) for f, a in arrays.items()}), perm))
    got = convert.table_to_numpy(take_rows(
        convert.table_from_numpy(arrays, "cpu"), perm))
    sharded = convert.sharded_table_from_numpy(arrays, _cpus(4))
    moved = migrate_rows(sharded, perm)
    assert sharded.shards == []  # fluidlint: disable=donated-buffer-reuse -- the source is consumed
    assert [t.docs for t in moved.shards] == [2, 2, 2, 2]
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_array_equal(
            convert.sharded_table_to_numpy(moved)[f], want[f], err_msg=f)


def test_sharded_table_forms_and_window_floor():
    arrays = _ref_table(21)
    mesh = make_mesh(_cpus(4))
    table = shard_table(convert.table_from_numpy(arrays, "cpu"), mesh)
    back = convert.sharded_table_to_numpy(table)
    for f in arrays:
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)
    assert int(global_window_floor(table)) == int(arrays["min_seq"].min())
    with pytest.raises(ValueError, match="not divisible"):
        shard_table(convert.table_from_numpy(arrays, "cpu"),
                    make_mesh(_cpus(3)))

