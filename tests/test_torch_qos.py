"""The port's protection plane against the JAX package's: the circuit
breaker's transitions under a scripted clock; a seeded ``error_burst``
at ``sidecar.dispatch`` tripping a breaker around ``apply`` (open, then
half-open, then closed) with the same transitions and the same served
texts and signatures after the retries, the trip named in the flight
dump; the same at ``tree_sidecar.dispatch`` on the tree plane; the
pools' ``defer`` sites (dispatch and migration) and ``pool_admit``'s
retry-then-degrade, each held to the reference sidecar on the same
sequenced messages and to the clients' own text."""
import copy

import jax
import pytest

from fluidframework_tpu.parallel import make_mesh as ref_mesh
from fluidframework_tpu.parallel import make_seq_mesh as ref_seq_mesh
from fluidframework_tpu.qos import breaker as ref_breaker
from fluidframework_tpu.qos import faults as ref_faults
from fluidframework_tpu.service import LocalServer, TpuMergeSidecar
from fluidframework_tpu.service import TreeSidecar as JaxTreeSidecar
from fluidframework_tpu_torch.obs import REGISTRY
from fluidframework_tpu_torch.parallel import make_mesh, make_seq_mesh
from fluidframework_tpu_torch.qos import breaker, faults
from fluidframework_tpu_torch.service import GpuMergeSidecar, TreeSidecar
from fluidframework_tpu_torch.testing import record_tree_stream
from test_torch_mesh_pool import (
    _assert_parity,
    _cpus,
    _grow_into_pool,
    _hot_rounds,
    _open_doc,
    _settle,
)
from test_torch_obs import _corpus

PACKAGES = {"ref": (ref_breaker, ref_faults), "port": (breaker, faults)}


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _script(b, clock):
    """A scripted failure/success/time sequence; the state after each
    step."""
    seen = []
    for step in ("f", "f", "s", "f", "f", "f", "a", "t", "a", "f", "t",
                 "a", "s", "a", "f", "f", "f", "t", "a", "s"):
        if step == "f":
            b.record_failure(RuntimeError("x"))
        elif step == "s":
            b.record_success()
        elif step == "a":
            seen.append(b.allow())
        else:
            clock.t += 5.0
        seen.append(b.state)
    return seen


def test_breaker_transitions_match_reference():
    runs, opened = {}, {}
    for name, (bmod, _f) in PACKAGES.items():
        clock = Clock()
        opened[name] = []
        b = bmod.CircuitBreaker(
            "b", failure_threshold=3, reset_timeout_s=5.0, clock=clock,
            on_open=lambda br, n=name: opened[n].append(br.state))
        runs[name] = _script(b, clock)
    assert runs["port"] == runs["ref"]
    assert opened["port"] == opened["ref"] and len(opened["port"]) >= 2
    b = breaker.CircuitBreaker("c", failure_threshold=1)
    with pytest.raises(RuntimeError):
        b.call(lambda: (_ for _ in ()).throw(RuntimeError("down")))
    with pytest.raises(breaker.BreakerOpenError) as err:
        b.call(lambda: 1)
    assert err.value.retry_after_seconds > 0


def _burst():
    return {"sidecar.dispatch": {"error_burst": 1.0},
            "tree_sidecar.dispatch": {"error_burst": 1.0}}


def _drive_under_burst(sc, plane, brk, clock, corpus, per_round=9):
    """Feed rounds while a one-shot error_burst is armed at the dispatch
    site; when the breaker is open, step the clock past its timeout.
    Returns the breaker's transitions, in order, and the flight dump
    each trip left."""
    states, dumps = [], []
    inner = brk._transition

    def transition(to):
        if to != brk._state:
            states.append(to)
        inner(to)
        if to == "open":
            dumps.append(sc.last_flight_dump)

    brk._transition = transition
    msgs = {doc: copy.deepcopy(s) for doc, s in corpus.items()}
    for doc in msgs:
        sc.track(doc, "d", "s")
    longest = max(len(s) for s in msgs.values())
    schedule = plane.FaultSchedule(11, rates=_burst(), max_per_site=1)
    with plane.PLANE.while_armed(schedule):
        for start in range(0, longest, per_round):
            for doc, stream in msgs.items():
                for msg in stream[start:start + per_round]:
                    sc.ingest(doc, msg)
            try:
                sc.apply()
            except plane.TransientFault:
                pass
            if brk.state == "open":
                clock.t += 10.0
    while sc.queued_ops:
        sc.apply()
    sc.sync()
    return states, dumps


def test_dispatch_burst_trips_breaker_and_retries_exactly():
    corpus = _corpus(n_steps=90)
    runs = {}
    for name, (bmod, fmod) in PACKAGES.items():
        clock = Clock()
        brk = bmod.CircuitBreaker(f"dispatch-{name}", failure_threshold=3,
                                  reset_timeout_s=5.0, clock=clock)
        kw = dict(max_docs=4, capacity=16, max_capacity=64, breaker=brk)
        sc = (TpuMergeSidecar(executor="scan", **kw) if name == "ref"
              else GpuMergeSidecar(device="cpu", **kw))
        before = REGISTRY.flat()
        states, dumps = _drive_under_burst(sc, fmod, brk, clock, corpus)
        runs[name] = (sc, states, dumps, REGISTRY.delta(before))
    (ref, ref_states, _, _), (port, states, dumps, delta) = (
        runs["ref"], runs["port"])
    assert states == ref_states == [
        "open", "half_open", "open", "half_open", "closed"]
    assert delta["sidecar_dispatch_faults_total"] == 4
    assert delta['chaos_injected_total{site="sidecar.dispatch",'
                 'kind="error_burst"}'] == 1
    assert len(dumps) == 2
    for dump in dumps:
        assert "circuit breaker 'dispatch-port' opened" in dump
        assert "TransientFault" in dump and "chaos[sidecar.dispatch]" in dump
    for doc in corpus:
        assert port.text(doc, "d", "s") == ref.text(doc, "d", "s")
        assert port.signature(doc, "d", "s") == \
            ref.signature(doc, "d", "s")
    assert not faults.PLANE.armed


def test_tree_dispatch_burst_retries_exactly():
    """The tree plane's seam: the burst's four rounds fail before
    mutating anything; the commits stay queued and the next apply serves
    the same forest as the reference, and as the writers converged."""
    recorded = [record_tree_stream(1700 + i) for i in range(3)]
    sigs = {}
    for name, (_b, fmod) in PACKAGES.items():
        sc = (JaxTreeSidecar(max_docs=4, capacity=64, max_capacity=512)
              if name == "ref" else
              TreeSidecar(max_docs=4, capacity=64, max_capacity=512,
                          device="cpu"))
        docs = [f"tree-{i}" for i in range(len(recorded))]
        for doc in docs:
            sc.track(doc, "d", "t")
        failed = 0
        schedule = fmod.FaultSchedule(5, rates=_burst(), max_per_site=1)
        with fmod.PLANE.while_armed(schedule):
            longest = max(len(s) for _, s in recorded)
            for start in range(0, longest, 6):
                for doc, (_sig, stream) in zip(docs, recorded):
                    for msg in copy.deepcopy(stream[start:start + 6]):
                        sc.ingest(doc, msg)
                try:
                    sc.apply()
                except fmod.TransientFault:
                    failed += 1
        sc.apply()
        sc.sync()
        assert failed == fmod.BURST_LENGTH
        sigs[name] = [sc.signature(doc, "d", "t") for doc in docs]
        if name == "port":
            assert sigs[name] == [sig for sig, _ in recorded]
            assert sc.flight.name == "tree-sidecar"
            assert sc.stats["rounds"] > 0
    assert sigs["port"] == sigs["ref"]


def _pool_pair(kind):
    kw = dict(max_docs=6, capacity=16, max_capacity=16, pool_capacity=256)
    if kind == "mesh":
        return [TpuMergeSidecar(seq_mesh=ref_mesh(jax.devices()[:2]), **kw),
                GpuMergeSidecar(device="cpu", seq_mesh=make_mesh(_cpus(2)),
                                **kw)]
    return [TpuMergeSidecar(seq_mesh=ref_seq_mesh(jax.devices()[:1]), **kw),
            GpuMergeSidecar(device="cpu", seq_mesh=make_seq_mesh(_cpus(1)),
                            **kw)]


@pytest.mark.parametrize("kind", ["mesh", "seq"])
def test_pool_defer_sites_match_reference(kind):
    """Seeded defers at sidecar.pool_dispatch (and pool_migrate on the
    mesh pool): tails wait past their watermark for a later settle, a
    migration waits for a later one; the same defers, placement and
    served state as the reference, equal to the clients' text."""
    server = LocalServer()
    sidecars = _pool_pair(kind)
    docs = [f"doc-{i}" for i in range(3)]
    containers, strings = {}, {}
    for doc in docs:
        containers[doc], strings[doc] = _open_doc(server, sidecars, doc)
    rates = {"sidecar.pool_dispatch": {"defer": 0.4},
             "sidecar.pool_migrate": {"defer": 0.5}}
    before = REGISTRY.flat()
    with ref_faults.PLANE.while_armed(ref_faults.FaultSchedule(3, rates)), \
            faults.PLANE.while_armed(faults.FaultSchedule(3, rates)):
        for doc in docs:
            _grow_into_pool(containers[doc], strings[doc])
        _settle(sidecars)
        _hot_rounds(sidecars, docs, containers, strings, 8)
        fired = list(faults.PLANE.fired)
        assert fired == list(ref_faults.PLANE.fired)
    _settle(sidecars)
    _settle(sidecars)  # a last deferred tail applies here
    ref, port = sidecars
    assert any(kind == "defer" for _s, _e, kind in fired)
    assert port.pooled_docs() == ref.pooled_docs() == 3
    assert port._pool.row_of == ref._pool.row_of
    if kind == "mesh":
        assert port._pool.migration_count == ref._pool.migration_count
    tier = "mesh" if kind == "mesh" else "seq"
    assert REGISTRY.delta(before)[
        f'pool_faults_total{{tier="{tier}",op="dispatch"}}'] > 0
    _assert_parity(sidecars, docs, strings)


def test_pool_admit_retries_then_degrades_to_host():
    """Two admission faults in a row: the slot degrades to the host
    tier (the flight recorder says so), as the reference does; the next
    overflowing document is admitted after one retry."""
    server = LocalServer()
    sidecars = _pool_pair("mesh")
    for site in (ref_faults.PLANE.site("sidecar.pool_admit"),
                 faults.PLANE.site("sidecar.pool_admit")):
        site.push("error", 3)
    docs = ["doc-0", "doc-1"]
    containers, strings = {}, {}
    for doc in docs:
        containers[doc], strings[doc] = _open_doc(server, sidecars, doc)
        _grow_into_pool(containers[doc], strings[doc])
        _settle(sidecars)
    ref, port = sidecars
    assert (port.host_mode_docs(), port.pooled_docs()) == \
        (ref.host_mode_docs(), ref.pooled_docs()) == (1, 1)
    kinds = [kind for _i, _t, kind, _f in port.flight.events()]
    assert kinds == [kind for _i, _t, kind, _f in ref.flight.events()]
    assert "recover-pool-admit-degraded" in kinds
    assert faults.PLANE.site("sidecar.pool_admit").scripted_pending == 0
    _assert_parity(sidecars, docs, strings)
