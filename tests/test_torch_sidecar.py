"""GpuMergeSidecar (on the CPU, through the plain version) against the
JAX package's TpuMergeSidecar on the scan route: the same sequenced
messages, from the reference LocalServer, reach both sidecars, and
every document's text and signature agree — through grow, eviction,
property-channel overflow and pipelined multi-round applies."""
import random

import pytest

from fluidframework_tpu.drivers import LocalDocumentServiceFactory
from fluidframework_tpu.loader import Container
from fluidframework_tpu.service import LocalServer, TpuMergeSidecar
from fluidframework_tpu_torch.service import GpuMergeSidecar


def _pair(**kw):
    return (TpuMergeSidecar(executor="scan", **kw),
            GpuMergeSidecar(device="cpu", **kw))


def _subscribe(server, sidecars, doc):
    for sc in sidecars:
        sc.subscribe(server, doc, "d", "s")


def _writer(server, doc, client_id):
    factory = LocalDocumentServiceFactory(server)
    c = Container.load(factory.create_document_service(doc),
                       client_id=client_id)
    return c, c.runtime.create_datastore("d").create_channel(
        "sharedstring", "s")


def _assert_same(sidecars, docs, strings=None):
    ref, port = sidecars
    for doc in docs:
        text = ref.text(doc, "d", "s")
        assert port.text(doc, "d", "s") == text, doc
        assert port.signature(doc, "d", "s") == ref.signature(
            doc, "d", "s"), doc
        if strings is not None:
            assert text == strings[doc].get_text(), doc


def _churn(c, s, n_chunks=40, chunk="abcdefgh"):
    for i in range(n_chunks):
        s.insert_text(0, chunk)
        c.flush()
        if i % 3 == 2 and s.get_length() > 6:
            s.remove_text(2, 5)
            c.flush()


def test_sidecar_tracks_service_stream():
    server = LocalServer()
    sidecars = _pair(max_docs=4, capacity=256)
    _subscribe(server, sidecars, "doc")
    factory = LocalDocumentServiceFactory(server)
    a = Container.load(factory.create_document_service("doc"),
                       client_id="alice")
    b = Container.load(factory.create_document_service("doc"),
                       client_id="bob")
    sa = a.runtime.create_datastore("default").create_channel(
        "sharedstring", "text")
    b.runtime.create_datastore("default").create_channel(
        "sharedstring", "text")
    for sc in sidecars:
        sc.subscribe(server, "doc", "default", "text")
    sa.insert_text(0, "hello sidecar")
    a.flush()
    sb = b.runtime.get_datastore("default").get_channel("text")
    sb.remove_text(0, 6)
    sb.annotate_range(0, 7, {"bold": 1})
    b.flush()
    for sc in sidecars:
        assert sc.apply() > 0
        assert not sc.overflowed()
    ref, port = sidecars
    assert port.text("doc", "default", "text") == sa.get_text() == "sidecar"
    assert port.signature("doc", "default", "text") == ref.signature(
        "doc", "default", "text")


@pytest.mark.parametrize("pipeline", [True, False])
def test_multidoc_rounds(pipeline):
    rng = random.Random(42)
    server = LocalServer()
    sidecars = _pair(max_docs=8, capacity=256)
    sidecars[1].pipeline = pipeline
    docs = [f"doc-{i}" for i in range(5)]
    strings, containers = {}, {}
    for doc in docs:
        _subscribe(server, sidecars, doc)
        factory = LocalDocumentServiceFactory(server)
        c1, c2 = (Container.load(factory.create_document_service(doc),
                                 client_id=f"{doc}-{who}")
                  for who in "ab")
        s1 = c1.runtime.create_datastore("d").create_channel(
            "sharedstring", "s")
        c2.runtime.create_datastore("d").create_channel("sharedstring", "s")
        containers[doc] = (c1, c2)
        strings[doc] = (s1, c2.runtime.get_datastore("d").get_channel("s"))
    rounds = 0
    for _ in range(60):
        doc = rng.choice(docs)
        idx = rng.randint(0, 1)
        s = strings[doc][idx]
        length = s.get_length()
        if length > 4 and rng.random() < 0.4:
            start = rng.randint(0, length - 2)
            s.remove_text(start, rng.randint(start + 1, length))
        elif length > 4 and rng.random() < 0.2:
            s.annotate_range(0, 3, {"color": rng.choice(["r", "g", None])})
        else:
            s.insert_text(rng.randint(0, length),
                          rng.choice(["ab", "xyz", "q"]))
        containers[doc][idx].flush()
        if rng.random() < 0.3:
            for sc in sidecars:
                sc.apply()
            rounds += 1
    for sc in sidecars:
        sc.apply()
    assert rounds >= 8
    assert sidecars[1].stats["rounds"] > 8
    assert not sidecars[1].overflowed()
    _assert_same(sidecars, docs, {d: strings[d][0] for d in docs})


def test_overflow_grows_capacity_ladder():
    server = LocalServer()
    sidecars = _pair(max_docs=2, capacity=16, max_capacity=512)
    _subscribe(server, sidecars, "doc")
    c, s = _writer(server, "doc", "doc-writer")
    _churn(c, s)
    for sc in sidecars:
        sc.apply()
        sc.sync()
    ref, port = sidecars
    assert port.grow_count >= 1
    assert port.capacity == ref.capacity
    assert port.host_mode_docs() == 0
    assert not port.overflowed()
    _assert_same(sidecars, ["doc"], {"doc": s})


def test_overflow_evicts_to_host_at_max_capacity():
    server = LocalServer()
    sidecars = _pair(max_docs=2, capacity=16, max_capacity=16)
    _subscribe(server, sidecars, "doc")
    c, s = _writer(server, "doc", "doc-writer")
    _churn(c, s)
    for sc in sidecars:
        sc.apply()
        sc.sync()
    port = sidecars[1]
    assert port.evict_count >= 1 and port.host_mode_docs() == 1
    assert not port.overflowed()
    _assert_same(sidecars, ["doc"], {"doc": s})
    s.insert_text(0, "MORE")  # later traffic flows to the host replica
    s.annotate_range(0, 4, {"bold": 777})
    c.flush()
    for sc in sidecars:
        sc.apply()
    _assert_same(sidecars, ["doc"], {"doc": s})


def test_five_property_keys_evicts_at_ingest():
    server = LocalServer()
    sidecars = _pair(max_docs=2, capacity=256)
    _subscribe(server, sidecars, "doc")
    c, s = _writer(server, "doc", "w")
    s.insert_text(0, "hello world")
    c.flush()
    for i, key in enumerate(["k1", "k2", "k3", "k4", "k5", "k6"]):
        s.annotate_range(0, 5, {key: i + 1})
        c.flush()
    for sc in sidecars:
        sc.apply()
    assert sidecars[1].host_mode_docs() == 1
    _assert_same(sidecars, ["doc"], {"doc": s})


def test_healthy_neighbour_of_evicted_doc():
    server = LocalServer()
    sidecars = _pair(max_docs=2, capacity=16, max_capacity=16)
    _subscribe(server, sidecars, "big")
    c1, s1 = _writer(server, "big", "w1")
    _churn(c1, s1)
    _subscribe(server, sidecars, "small")
    c2, s2 = _writer(server, "small", "w2")
    s2.insert_text(0, "tiny")
    c2.flush()
    for sc in sidecars:
        sc.apply()
        sc.sync()
    assert sidecars[1].host_mode_docs() == 1
    _assert_same(sidecars, ["big", "small"], {"big": s1, "small": s2})


def test_duplicate_delivery_is_dropped():
    server = LocalServer()
    sidecars = _pair(max_docs=2, capacity=64)
    _subscribe(server, sidecars, "doc")
    seen = []
    server.get_orderer("doc").broadcaster.subscribe(
        "dup-tap", seen.append)
    c, s = _writer(server, "doc", "w")
    s.insert_text(0, "once")
    c.flush()
    for msg in seen:  # at-least-once: every message arrives again
        for sc in sidecars:
            sc.ingest("doc", msg)
    for sc in sidecars:
        sc.apply()
    _assert_same(sidecars, ["doc"], {"doc": s})


def test_unported_routes_raise():
    """The chunked and egwalker routes construct, a route typo is loud,
    and a pool mesh that is not a ``DeviceMesh`` raises instead of
    being ignored."""
    for route in ("chunked", "egwalker"):
        assert GpuMergeSidecar(device="cpu", executor=route).executor == route
    with pytest.raises(ValueError, match="executor='egwalkr'"):
        GpuMergeSidecar(device="cpu", executor="egwalkr")
    with pytest.raises(TypeError, match="DeviceMesh"):
        GpuMergeSidecar(device="cpu", seq_mesh=object())
