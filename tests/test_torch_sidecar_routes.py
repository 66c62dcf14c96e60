"""GpuMergeSidecar on the chunked and egwalker routes (on the CPU,
through their plain torch device halves) against the JAX package's
TpuMergeSidecar on the same route: the same sequenced messages, from
the reference LocalServer, reach both sidecars, and every document's
text and signature agree, as do the grow and eviction counts, through
steady multi-document traffic, the grow ladder, overflow parking inside
one window, and host eviction. The pool tier waits for ROADMAP A7."""
import random

import pytest

from fluidframework_tpu.drivers import LocalDocumentServiceFactory
from fluidframework_tpu.loader import Container
from fluidframework_tpu.service import LocalServer, TpuMergeSidecar
from fluidframework_tpu_torch.service import GpuMergeSidecar
from fluidframework_tpu_torch.service.gpu_sidecar import default_executor

ROUTES = ("chunked", "egwalker")


def _pair(route, **kw):
    return (TpuMergeSidecar(executor=route, **kw),
            GpuMergeSidecar(device="cpu", executor=route, **kw))


def _open_doc(server, sidecars, doc, client_id=None):
    for sc in sidecars:
        sc.subscribe(server, doc, "d", "s")
    factory = LocalDocumentServiceFactory(server)
    c = Container.load(factory.create_document_service(doc),
                       client_id=client_id or f"{doc}-w")
    s = c.runtime.create_datastore("d").create_channel("sharedstring", "s")
    return c, s


def _apply(sidecars):
    for sc in sidecars:
        sc.apply()
        sc.sync()


def _assert_same(sidecars, strings):
    ref, port = sidecars
    for doc, s in strings.items():
        text = ref.text(doc, "d", "s")
        assert port.text(doc, "d", "s") == text == s.get_text(), doc
        assert port.signature(doc, "d", "s") == ref.signature(
            doc, "d", "s"), doc
    assert port.grow_count == ref.grow_count
    assert port.evict_count == ref.evict_count
    assert port.capacity == ref.capacity
    assert not port.overflowed()


@pytest.mark.parametrize("route", ROUTES)
def test_steady_multidoc_traffic(route):
    rng = random.Random(7)
    server = LocalServer()
    sidecars = _pair(route, max_docs=8, capacity=256)
    docs = [f"doc-{i}" for i in range(4)]
    opened = {doc: _open_doc(server, sidecars, doc) for doc in docs}
    rounds = 0
    for _ in range(50):
        doc = rng.choice(docs)
        c, s = opened[doc]
        length = s.get_length()
        roll = rng.random()
        if length > 4 and roll < 0.3:
            start = rng.randint(0, length - 2)
            s.remove_text(start, rng.randint(start + 1, length))
        elif length > 2 and roll < 0.45:
            s.annotate_range(0, rng.randint(1, length),
                             {"k": rng.randint(1, 3)})
        else:
            s.insert_text(rng.randint(0, length),
                          rng.choice(["ab", "xyz", "q"]))
        c.flush()
        if rng.random() < 0.3:
            for sc in sidecars:
                sc.apply()
            rounds += 1
    _apply(sidecars)
    assert rounds >= 8
    assert sidecars[1].stats["macro_steps"] > 0
    _assert_same(sidecars, {doc: opened[doc][1] for doc in docs})


@pytest.mark.slow
@pytest.mark.parametrize("route", ROUTES)
def test_grow_ladder(route):
    """Windows that overflow a 16-slot slab: the routes park where the
    scan applies on, and the re-apply from the snapshot reconverges
    (slow, as in the reference's suite; the one-window parking test
    below grows on every route in tier 1)."""
    server = LocalServer()
    sidecars = _pair(route, max_docs=2, capacity=16, max_capacity=512)
    c, s = _open_doc(server, sidecars, "doc")
    for i in range(40):
        s.insert_text(0, "abcdefgh")
        c.flush()
        if i % 3 == 2 and s.get_length() > 6:
            s.remove_text(2, 5)
            c.flush()
    _apply(sidecars)
    assert sidecars[1].grow_count >= 1
    assert sidecars[1].host_mode_docs() == 0
    _assert_same(sidecars, {"doc": s})


@pytest.mark.parametrize("route", ROUTES)
def test_overflow_parking_within_one_window(route):
    """ONE window that keeps going past the capacity overflow point."""
    server = LocalServer()
    sidecars = _pair(route, max_docs=2, capacity=16, max_capacity=256)
    c, s = _open_doc(server, sidecars, "doc")
    for _ in range(30):
        s.insert_text(0, "wxyz")
    c.flush()
    _apply(sidecars)
    assert sidecars[1].grow_count >= 1
    _assert_same(sidecars, {"doc": s})


@pytest.mark.parametrize("route", ROUTES)
def test_eviction_and_recovery(route):
    server = LocalServer()
    sidecars = _pair(route, max_docs=2, capacity=16, max_capacity=16)
    c, s = _open_doc(server, sidecars, "big")
    c2, s2 = _open_doc(server, sidecars, "small")
    for _ in range(40):
        s.insert_text(0, "abcdefgh")
        c.flush()
    s2.insert_text(0, "tiny")
    c2.flush()
    _apply(sidecars)
    assert sidecars[1].host_mode_docs() == 1
    # post-eviction traffic keeps flowing on both tiers
    s.insert_text(0, "MORE")
    s2.insert_text(4, "!")
    c.flush()
    c2.flush()
    _apply(sidecars)
    _assert_same(sidecars, {"big": s, "small": s2})


def test_executor_env_override_is_loud(monkeypatch):
    monkeypatch.delenv("FFTPU_SIDECAR_EXECUTOR", raising=False)
    assert default_executor() == "scan"
    assert GpuMergeSidecar(device="cpu").executor == "scan"
    monkeypatch.setenv("FFTPU_SIDECAR_EXECUTOR", "egwalker")
    assert GpuMergeSidecar(device="cpu").executor == "egwalker"
    monkeypatch.setenv("FFTPU_SIDECAR_EXECUTOR", "egwalkr")
    with pytest.raises(ValueError, match="FFTPU_SIDECAR_EXECUTOR"):
        default_executor()
