"""The reference's tests of the tools (``test_tools``: the benchmark
harness, the replay tool, the headless exporter, fault injection and
the stress runner), run on both packages
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired). Nothing is left out: 9 functions, 10 cases
with the stress seeds.
"""
import pytest

from test_torch_service_layers import (
    PACKAGES,
    case_id,
    mirror_cases,
    run_mirrored,
)

MIRRORED = ("test_tools",)
LEFT_OUT: dict = {}


def test_every_mirrored_case_is_run():
    cases = mirror_cases(MIRRORED, LEFT_OUT)
    assert len(cases) == 10
    assert not LEFT_OUT


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT), ids=case_id)
def test_mirrored(package, module, name, params, request):
    run_mirrored(package, module, name, request, params)
