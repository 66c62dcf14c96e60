"""The reference's tests of the TCP service over the socket driver
(``test_net_service``) and of the caching and multiplexing driver
(``test_caching_driver``), run on both packages
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired; each module's own ``server`` fixture is built
from the same source, so from the package under test).

Nothing is left out: the two ``net_stress`` cases run the port's
``tools.net_stress``, whose server and worker processes run the port.
"""
import pytest

from test_torch_service_layers import (
    PACKAGES,
    case_id,
    mirror_cases,
    run_mirrored,
)

MIRRORED = ("test_net_service", "test_caching_driver")
LEFT_OUT: dict = {}


def test_nothing_is_left_out():
    cases = mirror_cases(MIRRORED, LEFT_OUT)
    names = {n for _m, n, _p in (getattr(c, "values", c) for c in cases)}
    assert {"test_multi_process_stress_converges",
            "test_multi_process_stress_converges_partitioned"} <= names
    assert not LEFT_OUT


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT), ids=case_id)
def test_mirrored(package, module, name, params, request):
    run_mirrored(package, module, name, request, params)
