"""The reference's tests of the ordering plane's scale-out and
replication layer, run on both packages
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired): the replicated sequencer
(``test_replication``), the partitioned ordering service
(``test_partitioning``), the networked broker (``test_broker``), the
Materialized History service and its lambda (``test_moira``) and the
service interfaces with the foreman lambda
(``test_service_interfaces``).

Mirrored by hand, with the reference's slow mark (they start service
subprocesses: ``python -m <package>.service.broker`` / ``.moira``):
``test_broker.py::test_partitions_span_processes_against_one_broker``
and ``test_moira.py::test_moira_two_process_durable``.

``test_replication`` reads some process-wide counters as absolute
values (``repl_rejoin_total == 1`` after one rejoin), as a fresh
process has them; each mirrored case therefore puts both packages'
process-wide registries back as it found them
(``test_torch_service_layers.registries_restored``), so that the
reference's own ``tests/test_replication.py`` may follow this file in
one test worker.
"""
import pytest

from test_torch_service_layers import (
    PACKAGES,
    case_id,
    mirror_cases,
    registries_restored,
    run_mirrored,
)

MIRRORED = ("test_replication", "test_partitioning", "test_broker",
            "test_moira", "test_service_interfaces")
LEFT_OUT: dict = {}
SLOW = {
    ("test_broker", "test_partitions_span_processes_against_one_broker"),
    ("test_moira", "test_moira_two_process_durable"),
}


@pytest.fixture(autouse=True)
def _registries_restored():
    yield from registries_restored()


def test_every_module_mirrored_whole():
    """No case of the five modules is left out, and each module gives
    cases."""
    cases = mirror_cases(MIRRORED, LEFT_OUT, SLOW)
    assert {m for m, _n, _p in cases} == set(MIRRORED)
    assert not LEFT_OUT


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT, SLOW),
                         ids=case_id)
def test_mirrored(package, module, name, params, request):
    run_mirrored(package, module, name, request, params)


@pytest.mark.slow
@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name", sorted(SLOW), ids=case_id)
def test_mirrored_slow(package, module, name, request):
    run_mirrored(package, module, name, request)
