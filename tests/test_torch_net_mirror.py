"""The reference's tests of the TCP service over the socket driver
(``test_net_service``) and of the caching and multiplexing driver
(``test_caching_driver``), run on both packages
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired; each module's own ``server`` fixture is built
from the same source, so from the package under test).

Left out, with the module they wait for (the port does not have it yet):

- ``test_net_service.py::test_multi_process_stress_converges``:
  ``tools.net_stress``;
- ``test_net_service.py::test_multi_process_stress_converges_partitioned``:
  ``tools.net_stress``.
"""
import pytest

from test_torch_service_layers import (
    PACKAGES,
    case_id,
    mirror_cases,
    run_mirrored,
)

MIRRORED = ("test_net_service", "test_caching_driver")
LEFT_OUT = {
    "test_net_service": {
        "test_multi_process_stress_converges": "tools.net_stress",
        "test_multi_process_stress_converges_partitioned":
            "tools.net_stress",
    },
}


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT), ids=case_id)
def test_mirrored(package, module, name, params, request):
    run_mirrored(package, module, name, request, params)
