"""The reference's runtime-sanitizer tests (``test_sanitizer``,
``test_wiresan``, ``test_detsan``, ``test_failsan``), run on the port's
``testing`` sanitizers (``test_torch_service_layers.run_mirrored``: the
reference's own test source, imports rewired). The sweep's seeds outside
{0, 1, 2} keep the reference's slow marks.

No case is left out. A unit case (its own locks, fake repo, scripted
site) runs on both packages. A differential case, which drives the real
chaos harness, serve_bench or the TCP front door and holds what it
observes against a static pass over the whole package, runs on the port
only: the reference's own files run it on the reference. The port's
chaos harness defaults its merge sidecars to ``cuda``, so its
differentials hand it ``device="cpu"`` (``PORT_EDITS``).
"""
import pytest

from test_torch_service_layers import (
    PACKAGES,
    alfred_fixture,
    case_id,
    mirror_cases,
    registries_restored,
    run_mirrored,
)

PORT = PACKAGES[1]
MIRRORED = ("test_sanitizer", "test_wiresan", "test_detsan",
            "test_failsan")
LEFT_OUT: dict = {}
PORT_ONLY = {
    ("test_sanitizer", "test_runtime_lock_edges_are_subset_of_static_graph"),
    ("test_sanitizer",
     "test_static_graph_contains_the_declared_indirect_edges"),
    ("test_wiresan", "test_runtime_wire_traffic_is_subset_of_static_schema"),
    ("test_detsan",
     "test_runtime_sites_are_subset_of_static_findings_and_registry"),
    ("test_failsan", "test_sweep_full_fault_to_signal_coverage"),
    ("test_failsan",
     "test_runtime_silent_handlers_are_subset_of_static_and_registry"),
}
_CPU = ', device="cpu")'
PORT_EDITS = {
    "test_wiresan": (
        ("run_chaos(seed=seed, faults=True, n_steps=10)",
         "run_chaos(seed=seed, faults=True, n_steps=10" + _CPU),
    ),
    "test_detsan": (
        ("run_chaos(seed=3, faults=True, n_steps=12)",
         "run_chaos(seed=3, faults=True, n_steps=12" + _CPU),
    ),
    "test_failsan": (
        ("run_chaos(seed=seed).converged",
         "run_chaos(seed=seed" + _CPU + ".converged"),
        ("run_chaos_failover(seed=seed)",
         "run_chaos_failover(seed=seed" + _CPU),
        ("run_chaos_netsplit(seed=seed)",
         "run_chaos_netsplit(seed=seed" + _CPU),
        ("run_chaos(seed=3, faults=True, n_steps=12)",
         "run_chaos(seed=3, faults=True, n_steps=12" + _CPU),
    ),
}


@pytest.fixture(autouse=True)
def _registries_restored():
    yield from registries_restored()


@pytest.fixture()
def alfred(package, monkeypatch):
    yield from alfred_fixture(package, monkeypatch)


def _cases() -> list:
    out = []
    for case in mirror_cases(MIRRORED, LEFT_OUT):
        module, name, params = getattr(case, "values", case)
        marks = getattr(case, "marks", ())
        for package in PACKAGES:
            if package != PORT and (module, name) in PORT_ONLY:
                continue
            out.append(pytest.param(
                package, module, name, params, marks=marks,
                id=f"{package}-{module}-{name}-{case_id(params)}"))
    return out


@pytest.mark.parametrize("package,module,name,params", _cases())
def test_mirrored(package, module, name, params, request):
    edits = PORT_EDITS.get(module, ()) if package == PORT else ()
    run_mirrored(package, module, name, request, params, edits)


def test_left_out_cases_exist():
    """Every case named as left out or port-only is still a test of
    the reference."""
    cases = {(m, n) for m, n, _ in (getattr(c, "values", c)
                                    for c in mirror_cases(MIRRORED, {}))}
    named = PORT_ONLY | {(m, n) for m, names in LEFT_OUT.items()
                         for n in names}
    assert named <= cases, named - cases
