"""The port's TreeSidecar (on the CPU, through the plain torch device
half) against the JAX package's TreeSidecar, on both routes (the mirror
of ``tests/test_tree_serve.py``): the same sequenced streams, from the
reference LocalServer, reach all four sidecars, and every document's
signature agrees across them and with the scalar SharedTree oracle —
through the three-writer fuzz, the grow ladder, parking inside one
window, host eviction (capacity, ring straggler, inexpressible
changeset), the pooled tier, duplicate delivery and the
ChannelKindRouter. The tier counters agree too.

The recorder the card run drives (``record_tree_stream``) is held to
the real loader: the same scripted session through
LocalServer/Container/SharedTree sequences the same tree ops."""
import copy
import json
import random

import pytest
import torch

from fluidframework_tpu.drivers import LocalDocumentServiceFactory
from fluidframework_tpu.loader import Container
from fluidframework_tpu.models.tree import changeset as cs
from fluidframework_tpu.models.tree import node
from fluidframework_tpu.protocol.messages import (
    MessageType,
    SequencedMessage,
)
from fluidframework_tpu.service import (
    LocalServer,
    TpuMergeSidecar,
    TreeSidecar as JaxTreeSidecar,
)
from fluidframework_tpu.service.tree_sidecar import (
    ChannelKindRouter as JaxRouter,
)
from fluidframework_tpu.testing.tree_fuzz import random_change_with_moves
from fluidframework_tpu_torch.service import GpuMergeSidecar
from fluidframework_tpu_torch.service import tree_sidecar as tree_sidecar_mod
from fluidframework_tpu_torch.service.tree_sidecar import (
    ChannelKindRouter,
    TreeSidecar,
    default_tree_executor,
)
from fluidframework_tpu_torch.testing.tree_fuzz import record_tree_stream
from test_merge_chunk import smoke_seeds
from test_torch_tree_kernel import canon, one_torch_thread  # noqa: F401

ROUTES = ("atom", "macro")


def _sidecars(pool=False, **kw):
    """One sidecar per package and route, identical otherwise; the
    pooled tier on a one-device mesh (JAX) or the CPU (the port)."""
    jkw, pkw = dict(kw), dict(kw)
    if pool:
        import jax

        from fluidframework_tpu.parallel import make_seq_mesh

        jkw["pool_mesh"] = make_seq_mesh(jax.devices()[:1])
        pkw["pool_mesh"] = torch.device("cpu")
    out = {}
    for r in ROUTES:
        out[("jax", r)] = JaxTreeSidecar(executor=r, **jkw)
        out[("port", r)] = TreeSidecar(executor=r, device="cpu", **pkw)
    return out


def _open_doc(server, sidecars, doc, client_id=None):
    factory = LocalDocumentServiceFactory(server)
    for sc in sidecars.values():
        sc.subscribe(server, doc, "d", "t")
    c = Container.load(factory.create_document_service(doc),
                       client_id=client_id or f"{doc}-w")
    t = c.runtime.create_datastore("d").create_channel("sharedtree", "t")
    return c, t


def _join(server, doc, client_id):
    factory = LocalDocumentServiceFactory(server)
    c = Container.load(factory.create_document_service(doc),
                       client_id=client_id)
    return c, c.runtime.get_datastore("d").get_channel("t")


def _sig_of(tree):
    """The scalar oracle in the sidecars' signature convention."""
    return json.dumps({"root": tree.root().get("root", [])},
                      sort_keys=True, default=str)


def _flush_all(sidecars):
    for sc in sidecars.values():
        sc.apply()
        sc.sync()


def _assert_parity(sidecars, docs, oracle=None):
    """Every sidecar serves the same signature per doc (and the
    oracle's); the ports' tier counters equal the reference's."""
    for doc in docs:
        sigs = {k: sc.signature(doc, "d", "t") for k, sc in sidecars.items()}
        assert len(set(sigs.values())) == 1, (doc, sigs)
        if oracle is not None and doc in oracle:
            assert sigs[("jax", "atom")] == _sig_of(oracle[doc]), doc
    for r in ROUTES:
        ref, port = sidecars[("jax", r)], sidecars[("port", r)]
        for attr in ("grow_count", "evict_count", "ring_evict_count",
                     "pool_admit_count", "capacity"):
            assert getattr(port, attr) == getattr(ref, attr), (r, attr)
        assert port.host_mode_docs() == ref.host_mode_docs(), r
        assert port.pooled_docs() == ref.pooled_docs(), r
        assert not port.overflowed(), r


def mk_nodes(n, base=0):
    return [node("n", value=base + i) for i in range(n)]


# ======================================================================
# three blind writers, moves racing removes


@pytest.mark.parametrize("seed", smoke_seeds(10, {0, 4, 7}))
def test_three_writer_concurrent_move_fuzz(seed):
    rng = random.Random(seed * 101 + 13)
    server = LocalServer()
    sidecars = _sidecars(max_docs=2, capacity=64, max_capacity=1024)
    c1, t1 = _open_doc(server, sidecars, "doc", client_id="alice")
    t1.insert_nodes(("root",), 0, mk_nodes(6))
    c1.flush()
    c2, t2 = _join(server, "doc", "bob")
    c3, t3 = _join(server, "doc", "carol")
    writers = [(c1, t1, "A"), (c2, t2, "B"), (c3, t3, "C")]
    for rnd in range(5):
        for _c, t, uid in writers:
            t.apply_changeset(random_change_with_moves(
                rng, t.get_field(("root",)), f"{uid}{rnd}"))
        order = list(writers)
        rng.shuffle(order)
        for c, _t, _uid in order:
            c.flush()
        if rng.random() < 0.5:
            for sc in sidecars.values():
                sc.apply()
    assert _sig_of(t1) == _sig_of(t2) == _sig_of(t3), "scalar replicas split"
    _flush_all(sidecars)
    _assert_parity(sidecars, ["doc"], {"doc": t1})


# ======================================================================
# policy transitions


@pytest.mark.slow
def test_routes_agree_on_steady_multidoc_traffic():
    rng = random.Random(11)
    server = LocalServer()
    sidecars = _sidecars(max_docs=8, capacity=256)
    docs = [f"doc-{i}" for i in range(4)]
    trees, containers = {}, {}
    for doc in docs:
        c, t = _open_doc(server, sidecars, doc)
        t.insert_nodes(("root",), 0, mk_nodes(4))
        c.flush()
        containers[doc], trees[doc] = c, t
    for _ in range(40):
        doc = rng.choice(docs)
        t = trees[doc]
        n = len(t.get_field(("root",)))
        roll = rng.random()
        if n > 2 and roll < 0.25:
            start = rng.randint(0, n - 2)
            t.delete_nodes(("root",), start, rng.randint(1, n - start))
        elif n >= 2 and roll < 0.5:
            t.move_nodes(("root",), rng.randint(0, n - 2), 1,
                         rng.choice([0, n]))
        elif n > 0 and roll < 0.7:
            t.set_value(("root",), rng.randint(0, n - 1),
                        rng.randint(100, 199))
        else:
            t.insert_nodes(("root",), rng.randint(0, n),
                           mk_nodes(rng.randint(1, 2), 500))
        containers[doc].flush()
        if rng.random() < 0.3:
            for sc in sidecars.values():
                sc.apply()
    _flush_all(sidecars)
    _assert_parity(sidecars, docs, trees)


@pytest.mark.slow
def test_routes_agree_through_grow_ladder():
    server = LocalServer()
    sidecars = _sidecars(max_docs=2, capacity=16, max_capacity=512)
    c, t = _open_doc(server, sidecars, "doc")
    for i in range(30):
        t.insert_nodes(("root",), 0, mk_nodes(4, i * 10))
        c.flush()
        if i % 4 == 3 and len(t.get_field(("root",))) > 6:
            t.delete_nodes(("root",), 2, 5)
            c.flush()
    _flush_all(sidecars)
    for sc in sidecars.values():
        assert sc.grow_count >= 1
        assert sc.host_mode_docs() == 0
    _assert_parity(sidecars, ["doc"], {"doc": t})


def test_routes_agree_on_overflow_parking_within_one_window():
    server = LocalServer()
    sidecars = _sidecars(max_docs=2, capacity=16, max_capacity=256)
    c, t = _open_doc(server, sidecars, "doc")
    for i in range(7):
        t.insert_nodes(("root",), 0, mk_nodes(4, i * 10))
    c.flush()
    _flush_all(sidecars)   # one dispatch: overflow mid-window on all
    for sc in sidecars.values():
        assert sc.grow_count >= 1
    _assert_parity(sidecars, ["doc"], {"doc": t})


def test_routes_agree_through_eviction_and_recovery():
    server = LocalServer()
    sidecars = _sidecars(max_docs=2, capacity=16, max_capacity=16)
    c, t = _open_doc(server, sidecars, "big")
    c2, t2 = _open_doc(server, sidecars, "small")
    for i in range(20):
        t.insert_nodes(("root",), 0, mk_nodes(2, i * 10))
        c.flush()
    t2.insert_nodes(("root",), 0, mk_nodes(3))
    c2.flush()
    _flush_all(sidecars)
    for sc in sidecars.values():
        assert sc.host_mode_docs() == 1
    # post-eviction traffic keeps flowing (host replica ingest path);
    # the small doc stays on the device
    t.move_nodes(("root",), 0, 1, 4)
    t2.set_value(("root",), 0, 42)
    c.flush()
    c2.flush()
    for sc in sidecars.values():
        sc.apply()
    _assert_parity(sidecars, ["big", "small"], {"big": t, "small": t2})


def test_ring_straggler_evicts_to_host():
    """A commit whose ref predates the device trunk ring takes the host
    path, evicted before its encode, on every sidecar."""
    server = LocalServer()
    sidecars = _sidecars(max_docs=2, capacity=256)
    c, t = _open_doc(server, sidecars, "doc", client_id="w")
    t.insert_nodes(("root",), 0, mk_nodes(4))
    c.flush()
    for i in range(20):
        t.set_value(("root",), 0, i)
        c.flush()
    last = max(sc._last_ingested["doc"] for sc in sidecars.values())
    change = cs.stamp({"root": [cs.skip(1), cs.mod(value={
        "new": 999, "old": None})]}, "straggler")
    for sc in sidecars.values():
        sc.ingest("doc", SequencedMessage(
            client_id="straggler", sequence_number=last + 1,
            minimum_sequence_number=0, client_sequence_number=1,
            reference_sequence_number=1, type=MessageType.OPERATION,
            contents={"kind": "op", "address": "d", "channel": "t",
                      "contents": {"type": "tree", "changes": change}},
        ))
        sc.apply()
        sc.sync()
    for sc in sidecars.values():
        assert sc.ring_evict_count == 1
        assert sc.host_mode_docs() == 1
    _assert_parity(sidecars, ["doc"])
    assert '"value": 999' in sidecars[("port", "atom")].signature(
        "doc", "d", "t")


def test_inexpressible_changeset_evicts_to_host():
    server = LocalServer()
    sidecars = _sidecars(max_docs=2, capacity=64)
    c, t = _open_doc(server, sidecars, "doc")
    t.insert_nodes(("root",), 0, mk_nodes(3))
    c.flush()
    t.apply_changeset(cs.stamp({"side": [cs.ins(mk_nodes(2, 900))]},
                               "u-side"))
    c.flush()
    t.set_value(("root",), 0, 42)  # post-eviction traffic
    c.flush()
    _flush_all(sidecars)
    for sc in sidecars.values():
        assert sc.evict_count == 1
        assert sc.host_mode_docs() == 1
    _assert_parity(sidecars, ["doc"], {"doc": t})


def test_routes_agree_with_pool_tier():
    """Grow ladder -> pooled-tier admission -> continued pooled
    collaboration, on every sidecar."""
    server = LocalServer()
    sidecars = _sidecars(pool=True, max_docs=2, capacity=16,
                         max_capacity=32, pool_capacity=256)
    c, t = _open_doc(server, sidecars, "big")
    for i in range(25):
        t.insert_nodes(("root",), 0, mk_nodes(2, i * 10))
        c.flush()
    _flush_all(sidecars)
    for sc in sidecars.values():
        assert sc.pooled_docs() == 1
        assert sc.host_mode_docs() == 0
    for _ in range(3):
        t.move_nodes(("root",), 0, 1, 5)
        c.flush()
    for sc in sidecars.values():
        sc.apply()
    _assert_parity(sidecars, ["big"], {"big": t})
    for sc in sidecars.values():
        assert sc._pool.dispatch_count >= 1


def test_pool_capacity_beyond_pool_evicts():
    """A document that outgrows even the pooled slab goes to the host
    replica, on every sidecar alike."""
    server = LocalServer()
    sidecars = _sidecars(pool=True, max_docs=2, capacity=16,
                         max_capacity=16, pool_capacity=32)
    c, t = _open_doc(server, sidecars, "big")
    for i in range(25):
        t.insert_nodes(("root",), 0, mk_nodes(2, i * 10))
        c.flush()
    _flush_all(sidecars)
    for sc in sidecars.values():
        assert sc.host_mode_docs() == 1
        assert sc.pooled_docs() == 0
    _assert_parity(sidecars, ["big"], {"big": t})


def test_duplicate_delivery_dropped():
    server = LocalServer()
    sidecars = _sidecars(max_docs=2, capacity=64)
    c, t = _open_doc(server, sidecars, "doc")
    t.insert_nodes(("root",), 0, mk_nodes(3))
    c.flush()
    replay = SequencedMessage(
        client_id="doc-w", sequence_number=1,
        minimum_sequence_number=0, client_sequence_number=1,
        reference_sequence_number=0, type=MessageType.OPERATION,
        contents={"kind": "op", "address": "d", "channel": "t",
                  "contents": {"type": "tree", "changes": cs.stamp(
                      {"root": [cs.ins(mk_nodes(1))]}, "dup")}},
    )
    for sc in sidecars.values():
        slot = sc._slot("doc", "d", "t")
        depth = len(sc._raw[slot])
        assert depth >= 1
        sc.ingest("doc", replay)
        assert len(sc._raw[slot]) == depth, "duplicate extended history"
        sc.apply()
    _assert_parity(sidecars, ["doc"], {"doc": t})


# ======================================================================
# ingress routing, defaults


def test_channel_kind_router_routes_by_channel_type():
    """One document carrying both channel kinds: each router feeds the
    string channel to its merge sidecar and the tree channel to its
    tree sidecar off the attach op's channelType."""
    server = LocalServer()
    planes = {
        "jax": (TpuMergeSidecar(max_docs=4, capacity=64),
                JaxTreeSidecar(max_docs=4, capacity=64)),
        "port": (GpuMergeSidecar(max_docs=4, capacity=64, device="cpu"),
                 TreeSidecar(max_docs=4, capacity=64, device="cpu")),
    }
    JaxRouter(*planes["jax"]).subscribe(server, "doc")
    ChannelKindRouter(*planes["port"]).subscribe(server, "doc")
    factory = LocalDocumentServiceFactory(server)
    c = Container.load(factory.create_document_service("doc"),
                       client_id="w")
    ds = c.runtime.create_datastore("d")
    s = ds.create_channel("sharedstring", "s")
    t = ds.create_channel("sharedtree", "t")
    s.insert_text(0, "hello")
    t.insert_nodes(("root",), 0, mk_nodes(2))
    c.flush()
    s.insert_text(5, "!")
    t.move_nodes(("root",), 0, 1, 2)
    c.flush()
    for merge_sc, tree_sc in planes.values():
        for sc in (merge_sc, tree_sc):
            sc.apply()
            sc.sync()
        assert merge_sc.text("doc", "d", "s") == s.get_text()
        assert tree_sc.signature("doc", "d", "t") == _sig_of(t)
        assert ("doc", "d", "s") not in tree_sc._slots
        assert ("doc", "d", "t") not in merge_sc._slots


def test_default_tree_executor(monkeypatch):
    monkeypatch.delenv("FFTPU_TREE_EXECUTOR", raising=False)
    assert default_tree_executor() in ROUTES
    assert TreeSidecar(device="cpu").executor == default_tree_executor()
    for route in ROUTES:
        monkeypatch.setenv("FFTPU_TREE_EXECUTOR", route)
        assert default_tree_executor() == route
    monkeypatch.setenv("FFTPU_TREE_EXECUTOR", "macr0")
    with pytest.raises(ValueError, match="FFTPU_TREE_EXECUTOR"):
        default_tree_executor()
    with pytest.raises(ValueError, match="executor"):
        TreeSidecar(executor="scan", device="cpu")


def test_pool_default_capacity_and_prewarm(monkeypatch):
    """The pool's default capacity, and ``prewarm`` walking every
    capacity rung on both routes (a fresh table, then a dispatch's
    output), the pad step between rungs and the pool's first-admission
    window, with the live table untouched."""
    sc = TreeSidecar(max_docs=4, capacity=16, max_capacity=64,
                     pool_mesh=torch.device("cpu"), device="cpu")
    assert sc._pool.capacity == 256  # min(max_capacity * 4, 16384)
    walked = []
    for name in ("apply_tree_window", "pad_tree_capacity"):
        inner = getattr(tree_sidecar_mod, name)

        def hook(table, *args, inner=inner, name=name, **kw):
            route = args[1] if name == "apply_tree_window" else None
            walked.append((name, table.docs, table.slots, route))
            return inner(table, *args, **kw)

        monkeypatch.setattr(tree_sidecar_mod, name, hook)
    live = sc._table
    assert sc.prewarm() >= 0.0
    assert sc._table is live
    want = []
    for cap in (16, 32, 64):
        want += [("apply_tree_window", 4, cap, r) for r in ROUTES
                 for _ in range(2)]
        if cap > 16:
            want.append(("pad_tree_capacity", 4, cap // 2, None))
    want += [("apply_tree_window", 1, 256, sc.executor)] * 2
    assert walked == want


# ======================================================================
# the recorder against the real loader


def _loader_session(seed, writers=3, rounds=24, seed_nodes=192,
                    seed_chunk=32):
    """``record_tree_stream``'s session through LocalServer / Container /
    SharedTree: each round every writer authors, then the writers send
    in ``rng.shuffle`` order with inbound processing paused, so every op
    carries the ref of the view it was authored against."""
    rng = random.Random(seed)
    server = LocalServer()
    log = []
    server.get_orderer("doc").broadcaster.subscribe(
        "log", lambda m: log.append(copy.deepcopy(m)))
    factory = LocalDocumentServiceFactory(server)
    ids = [f"w{i}" for i in range(writers)]
    c0 = Container.load(factory.create_document_service("doc"),
                        client_id=ids[0])
    t0 = c0.runtime.create_datastore("d").create_channel("sharedtree", "t")
    for start in range(0, seed_nodes, seed_chunk):
        t0.insert_nodes(("root",), start, [
            node("n", value=v)
            for v in range(start, min(start + seed_chunk, seed_nodes))])
        c0.flush()
    ws = [(c0, t0)] + [_join(server, "doc", cid) for cid in ids[1:]]
    for rnd in range(rounds):
        for i, (_c, t) in enumerate(ws):
            t.apply_changeset(random_change_with_moves(
                rng, t.get_field(("root",)), f"{chr(65 + i)}{rnd}"))
        order = list(ws)
        rng.shuffle(order)
        for c, _ in ws:
            c.pause_inbound()
        for c, _ in order:
            c.flush()
        for c, _ in ws:
            c.resume_inbound()
    return log, ws[0][1]


def _tree_ops(stream):
    return [(m.sequence_number, m.reference_sequence_number, m.client_id,
             canon(m.contents["contents"]["changes"]))
            for m in stream if m.type == MessageType.OPERATION
            and m.contents.get("kind") == "op"]


@pytest.mark.parametrize("seed", [3, 1700, 1731])
def test_recorder_matches_loader_session(seed):
    """The recorder's tree ops equal the loader's: sequence number,
    reference sequence number, client and changeset; the message kinds
    and minimum sequence numbers of the whole stream agree too, and the
    recorder's signature is the SharedTree's."""
    log, tree = _loader_session(seed, rounds=12)
    sig, stream = record_tree_stream(seed, rounds=12)
    assert _tree_ops(stream) == _tree_ops(log)
    assert len(_tree_ops(stream)) == 6 + 3 * 12
    assert [(m.type, m.sequence_number, m.minimum_sequence_number)
            for m in stream] == \
        [(m.type, m.sequence_number, m.minimum_sequence_number)
         for m in log]
    assert sig == _sig_of(tree)


def test_recorded_streams_through_both_sidecars():
    """Eight recorded documents through the JAX and the port sidecar on
    both routes, ingested the way the card run feeds them (the seeding
    prefix, then one round of three ops per apply): all equal the
    recorder's converged writers, grow once, and stay on the device."""
    docs = [f"doc-{i}" for i in range(8)]
    recorded = [record_tree_stream(1700 + i, rounds=8) for i in range(8)]
    sidecars = _sidecars(max_docs=8, capacity=128, max_capacity=512)
    for sc in sidecars.values():
        for doc in docs:
            sc.track(doc, "d", "t")
    prefix = 10  # three joins, the attach and six seed commits
    longest = max(len(s) for _, s in recorded)
    bounds = [0] + list(range(prefix, longest, 3)) + [longest]
    for a, b in zip(bounds, bounds[1:]):
        for sc in sidecars.values():
            for doc, (_, stream) in zip(docs, recorded):
                for msg in stream[a:b]:
                    sc.ingest(doc, msg)
            sc.apply()
    for sc in sidecars.values():
        sc.sync()
        assert sc.host_mode_docs() == 0
        assert sc.ring_evict_count == 0
        assert sc.grow_count == 1 and sc.capacity == 256
        for doc, (sig, _) in zip(docs, recorded):
            assert sc.signature(doc, "d", "t") == sig, doc
    _assert_parity(sidecars, docs)
