"""The reference's tests of the observability plane (``test_obs``), the
merge sidecar end to end (``test_tpu_sidecar``) and the window kernel
against the scalar oracle (``test_merge_kernel``), run on the port
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired). The reference's own files run the same bodies
on the reference in the same session; a second run here would only put
more JAX compiles beside the reference lint gate's timed run.

No case is left out. A case runs with ``PORT_EDITS`` where
the package rename is not enough: the reference's ``TpuMergeSidecar``
(module ``tpu_sidecar``) is the port's ``GpuMergeSidecar`` (module
``gpu_sidecar``), built on the CPU, and a table or batch the port's
entry points would put on the card (``make_table`` defaults to
``cuda``) is made on the CPU.
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
MIRRORED = ("test_obs", "test_tpu_sidecar", "test_merge_kernel")
LEFT_OUT: dict = {}

_SIDECAR = (
    ("service.tpu_sidecar import TpuMergeSidecar",
     "service.gpu_sidecar import GpuMergeSidecar"),
    ("import LocalServer, TpuMergeSidecar",
     "import LocalServer, GpuMergeSidecar"),
    ("TpuMergeSidecar(", 'GpuMergeSidecar(device="cpu", '),
)


def _on_cpu(capacity: str) -> tuple:
    return (f"    table = make_table({capacity})\n"
            "    table = apply_window(table, batch)",
            f"    table = make_table({capacity}, \"cpu\")\n"
            "    table = apply_window(table, batch_from_numpy(batch, "
            "\"cpu\"))")


PORT_EDITS = {
    "test_obs": _SIDECAR,
    "test_tpu_sidecar": _SIDECAR[1:],
    "test_merge_kernel": (
        ("from fluidframework_tpu_torch.ops import (",
         "from fluidframework_tpu_torch.convert import batch_from_numpy\n"
         "from fluidframework_tpu_torch.ops import ("),
        _on_cpu("len(encs), capacity"),
        _on_cpu("1, 512"),
        ("    table = make_table(1, 8)  # deliberately tiny\n"
         "    table = apply_window(table, batch)",
         "    table = make_table(1, 8, \"cpu\")  # deliberately tiny\n"
         "    table = apply_window(table, batch_from_numpy(batch, "
         "\"cpu\"))"),
    ),
}


@pytest.fixture(autouse=True)
def _registries_restored():
    yield from registries_restored()


@pytest.fixture()
def alfred(package, monkeypatch):
    yield from alfred_fixture(package, monkeypatch)


@pytest.fixture()
def package():
    return PORT


@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT), ids=case_id)
def test_mirrored(package, module, name, params, request):
    run_mirrored(package, module, name, request, params, PORT_EDITS[module])
