"""The long-document tier: a document that outgrows the primary slab
ladder moves to the sequence-sharded pool and stays on the device;
host eviction only past even the pooled capacity. ``GpuMergeSidecar``
(on the CPU, its pool on a ``[cpu] * n`` seq mesh) beside the JAX
package's ``TpuMergeSidecar`` (on the session's virtual CPU devices),
fed the same sequenced messages from the reference ``LocalServer``:
the same tier counts, and every document's text equals its writer's and
its signature the reference's."""
import jax
import pytest
import torch

from fluidframework_tpu.drivers import LocalDocumentServiceFactory
from fluidframework_tpu.loader import Container
from fluidframework_tpu.parallel import make_seq_mesh as ref_seq_mesh
from fluidframework_tpu.service import LocalServer, TpuMergeSidecar
from fluidframework_tpu_torch.parallel import make_seq_mesh
from fluidframework_tpu_torch.service import GpuMergeSidecar
from fluidframework_tpu_torch.service.gpu_sidecar import SeqShardedPool


def make_pair(n_seq=2, max_docs=3, capacity=16, max_capacity=32,
              pool_capacity=256):
    kw = dict(max_docs=max_docs, capacity=capacity,
              max_capacity=max_capacity, pool_capacity=pool_capacity)
    return (TpuMergeSidecar(seq_mesh=ref_seq_mesh(jax.devices()[:n_seq]),
                            **kw),
            GpuMergeSidecar(device="cpu", seq_mesh=make_seq_mesh(
                [torch.device("cpu")] * n_seq), **kw))


def open_doc(server, sidecars, doc):
    factory = LocalDocumentServiceFactory(server)
    for sc in sidecars:
        sc.subscribe(server, doc, "d", "s")
    c = Container.load(factory.create_document_service(doc),
                       client_id=f"{doc}-w")
    return c, c.runtime.create_datastore("d").create_channel(
        "sharedstring", "s")


def write_doc(server, sidecars, doc, n_chunks, chunk="abcdefgh"):
    c, s = open_doc(server, sidecars, doc)
    for i in range(n_chunks):
        s.insert_text(0, chunk)
        c.flush()
        if i % 3 == 2 and s.get_length() > 6:
            s.remove_text(2, 5)
            c.flush()
    return c, s


def settle(sidecars):
    for sc in sidecars:
        sc.apply()
        sc.sync()  # pipelined dispatch: the pool policy runs at settle


def check(sidecars, strings, pooled, hosted):
    ref, port = sidecars
    for sc in sidecars:
        assert (sc.pooled_docs(), sc.host_mode_docs()) == (pooled, hosted)
    for doc, s in strings.items():
        assert port.text(doc, "d", "s") == s.get_text() == \
            ref.text(doc, "d", "s"), doc
        assert port.signature(doc, "d", "s") == \
            ref.signature(doc, "d", "s"), doc


def test_overgrown_doc_lands_in_pool_not_host():
    server = LocalServer()
    sidecars = make_pair()
    _, s = write_doc(server, sidecars, "big", n_chunks=60)
    settle(sidecars)
    assert sidecars[1].pool_admit_count == sidecars[0].pool_admit_count >= 1
    check(sidecars, {"big": s}, pooled=1, hosted=0)


def test_pooled_doc_keeps_collaborating():
    server = LocalServer()
    sidecars = make_pair()
    c, s = write_doc(server, sidecars, "big", n_chunks=60)
    settle(sidecars)
    for _ in range(10):
        s.insert_text(3, "XYZ")
        c.flush()
    settle(sidecars)
    assert sidecars[1]._pool.dispatch_count >= 1
    check(sidecars, {"big": s}, pooled=1, hosted=0)


def test_mixed_primary_and_pooled_docs_converge():
    server = LocalServer()
    sidecars = make_pair()
    big_c, big_s = write_doc(server, sidecars, "big", n_chunks=60)
    small_c, small_s = write_doc(server, sidecars, "small", n_chunks=4)
    settle(sidecars)
    big_s.insert_text(0, "B")
    big_c.flush()
    small_s.insert_text(0, "S")
    small_c.flush()
    settle(sidecars)
    check(sidecars, {"big": big_s, "small": small_s}, pooled=1, hosted=0)


def test_beyond_pool_capacity_falls_back_to_host():
    server = LocalServer()
    sidecars = make_pair(max_capacity=32, pool_capacity=64)
    _, s = write_doc(server, sidecars, "huge", n_chunks=120)
    settle(sidecars)
    check(sidecars, {"huge": s}, pooled=0, hosted=1)


def test_pool_rejects_sharded_doc_axis():
    mesh = make_seq_mesh([torch.device("cpu")] * 4, doc_shards=2)
    with pytest.raises(ValueError, match="unsharded doc axis"):
        SeqShardedPool(mesh, 256)


def test_pool_eviction_does_not_corrupt_remaining_members():
    """Evicting one pooled doc (dispatch overflow) rebuilds the pool:
    the other members' rows and overflow flags stay right."""
    server = LocalServer()
    sidecars = make_pair(max_capacity=32, pool_capacity=128)
    a_c, a_s = write_doc(server, sidecars, "doc-a", n_chunks=60)
    b_c, b_s = write_doc(server, sidecars, "doc-b", n_chunks=60)
    settle(sidecars)
    check(sidecars, {"doc-a": a_s, "doc-b": b_s}, pooled=2, hosted=0)
    for _ in range(120):
        a_s.insert_text(0, "zzzzzzzz")
        a_c.flush()
    settle(sidecars)
    check(sidecars, {"doc-a": a_s, "doc-b": b_s}, pooled=1, hosted=1)
    b_s.insert_text(0, "still-alive-")
    b_c.flush()
    settle(sidecars)
    check(sidecars, {"doc-a": a_s, "doc-b": b_s}, pooled=1, hosted=1)


def test_ingest_eviction_of_pooled_doc_rebuilds_pool():
    """A pooled doc leaving through ingest's tensor-inexpressible path
    (too many property keys) rebuilds the pool for the survivors."""
    server = LocalServer()
    sidecars = make_pair(pool_capacity=256)
    a_c, a_s = write_doc(server, sidecars, "doc-a", n_chunks=60)
    b_c, b_s = write_doc(server, sidecars, "doc-b", n_chunks=60)
    settle(sidecars)
    a_s.insert_text(0, "X", {f"k{i}": i for i in range(9)})
    a_c.flush()
    settle(sidecars)
    check(sidecars, {"doc-a": a_s, "doc-b": b_s}, pooled=1, hosted=1)
    b_s.insert_text(0, "ok-")
    b_c.flush()
    settle(sidecars)
    check(sidecars, {"doc-a": a_s, "doc-b": b_s}, pooled=1, hosted=1)


def test_remove_heavy_doc_fits_pool_after_compaction():
    """A doc whose HISTORY exceeds the pooled capacity but whose live
    text fits stays pooled: replay and dispatch compact."""
    server = LocalServer()
    sidecars = make_pair(max_docs=2, max_capacity=32, pool_capacity=64)
    c, s = open_doc(server, sidecars, "churn")
    for _ in range(80):
        s.insert_text(0, "abcd")
        c.flush()
        if s.get_length() > 8:
            s.remove_text(0, 4)
            c.flush()
    settle(sidecars)
    check(sidecars, {"churn": s}, pooled=1, hosted=0)


def _deferred_pair(server):
    sidecars = make_pair(n_seq=1, capacity=16, max_capacity=16)
    big = open_doc(server, sidecars, "big")
    other = open_doc(server, sidecars, "other")
    for _ in range(20):
        big[1].insert_text(0, "abcdefgh")
        big[0].flush()
    settle(sidecars)
    check(sidecars, {"big": big[1]}, pooled=1, hosted=0)
    return sidecars, big, other


def test_deferred_pool_ops_not_double_applied_by_recovery_rebuild():
    """ONE apply carries deferred ops of a pooled doc and another doc
    overflowing into the pool: the admission rebuild replays full
    streams, which already hold the deferred ops, and the watermarks
    keep them from applying twice."""
    server = LocalServer()
    sidecars, (big_c, big_s), (other_c, other_s) = _deferred_pair(server)
    for _ in range(20):
        big_s.insert_text(0, "abcdefgh")
    big_c.flush()
    for _ in range(20):
        other_s.insert_text(0, "qrstuvwx")
    other_c.flush()
    settle(sidecars)
    check(sidecars, {"big": big_s, "other": other_s}, pooled=2, hosted=0)


def test_pool_ops_packed_across_recovery_rebuild_apply_once():
    """Round N overflows 'other' with the flag unsettled; round N+1
    packs ops of pooled 'big', and its leading settle runs round N's
    recovery rebuild, which subsumes them: applied once."""
    server = LocalServer()
    sidecars, (big_c, big_s), (other_c, other_s) = _deferred_pair(server)
    for _ in range(20):
        other_s.insert_text(0, "qrstuvwx")
    other_c.flush()
    for sc in sidecars:
        sc.apply()
    for _ in range(3):
        big_s.insert_text(0, "XY")
    big_c.flush()
    settle(sidecars)
    check(sidecars, {"big": big_s, "other": other_s}, pooled=2, hosted=0)
