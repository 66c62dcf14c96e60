"""The reference's tests of the qos plane (``test_qos``), the SLO
engine, span export and the open-loop harness (``test_slo_serving``)
and fleet observability (``test_fleet_obs``), run on both packages
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired).

No case is left out.

Mirrored by hand, since they build a merge sidecar (the reference's
``TpuMergeSidecar``, the port's ``GpuMergeSidecar(device="cpu")``):
``test_qos.py::test_sidecar_breaker_scripted_fault_full_cycle`` and
``test_slo_serving.py::
test_serve_bench_sidecar_route_split_grades_settle_budget``.
"""
import pytest

from test_torch_service_layers import (
    PACKAGES,
    alfred_fixture,
    case_id,
    mirror_cases,
    run_mirrored,
)

MIRRORED = ("test_qos", "test_slo_serving", "test_fleet_obs")
LEFT_OUT: dict = {}
BY_HAND = {
    ("test_qos", "test_sidecar_breaker_scripted_fault_full_cycle"),
    ("test_slo_serving",
     "test_serve_bench_sidecar_route_split_grades_settle_budget"),
}


@pytest.fixture()
def alfred(package, monkeypatch):
    yield from alfred_fixture(package, monkeypatch)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT, BY_HAND),
                         ids=case_id)
def test_mirrored(package, module, name, params, request):
    run_mirrored(package, module, name, request, params)


def _sidecar(package, **kw):
    if package == "fluidframework_tpu":
        from fluidframework_tpu.service.tpu_sidecar import TpuMergeSidecar

        return TpuMergeSidecar(**kw)
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    return GpuMergeSidecar(device="cpu", **kw)


@pytest.mark.parametrize("package", PACKAGES)
def test_sidecar_breaker_scripted_fault_full_cycle(package):
    """test_qos.py's case on each package's sidecar: open -> half-open
    -> close pinned by a SCRIPTED sidecar dispatch fault; while open,
    apply() refuses instantly and ops stay queued; the flight recorder
    dumps at trip time."""
    import importlib

    qos = importlib.import_module(f"{package}.qos")

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = Clock()
    br = qos.CircuitBreaker("sidecar-dispatch", failure_threshold=2,
                            reset_timeout_s=5.0, clock=clock)
    sc = _sidecar(package, max_docs=2, capacity=64, breaker=br)
    sc.track("doc", "ds", "ch")
    script = ["fail", "fail", "ok"]

    def scripted_dispatch():
        step = script.pop(0)
        if step == "fail":
            raise RuntimeError("device fault (scripted)")
        n = sc.queued_ops
        for q in sc._queued:
            q.clear()
        return n

    sc._dispatch = scripted_dispatch
    sc._queued[0].append({"kind": 1})

    with pytest.raises(RuntimeError):
        sc.apply()
    assert br.state == qos.STATE_CLOSED
    with pytest.raises(RuntimeError):
        sc.apply()
    assert br.state == qos.STATE_OPEN
    assert sc.last_flight_dump is not None
    assert "opened" in sc.last_flight_dump
    assert sc.apply() == 0
    assert sc.queued_ops == 1
    assert br.state == qos.STATE_OPEN
    clock.t += 6.0
    assert br.state == qos.STATE_HALF_OPEN
    assert sc.apply() == 1
    assert br.state == qos.STATE_CLOSED
    assert sc.queued_ops == 0
    assert script == []


@pytest.mark.parametrize("package", PACKAGES)
def test_serve_bench_sidecar_route_split_grades_settle_budget(package):
    """test_slo_serving.py's case; the port's sidecar runs on the CPU
    because the config names it."""
    import importlib

    sb = importlib.import_module(f"{package}.tools.serve_bench")
    kw = dict(n_docs=8, readers_per_doc=2, duration_s=1.0, tick_s=0.05,
              capacity_ops_per_s=100.0, offered_multiple=0.8, seed=7,
              sidecar_docs=2, sidecar_steps=10)
    if package == "fluidframework_tpu_torch":
        kw["sidecar_device"] = "cpu"
    r = sb.run_serve_bench(sb.ServeBenchConfig(**kw))
    assert r.sidecar_rounds > 0
    assert r.sidecar_ops > 0
    assert 0.0 < r.route_split_sidecar < 1.0
    names = {o["name"] for o in r.slo_report["objectives"]}
    assert "sidecar-settle-p99" in names
