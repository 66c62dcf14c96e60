"""The reference's tests of the runtime's summarizer, GC, attribution and
id compressor (``test_summarizer``, ``test_gc_blobs_attribution``), the
URL resolver and debug driver (``test_url_resolver``), the driver
helpers (``test_driver_utils``), telemetry and config
(``test_telemetry_config``), the scalar merge tree, its intervals and
reconnect (``test_mergetree``, ``test_intervals``, ``test_reconnect``),
the convergence fuzz (``test_convergence_fuzz``), the heat plane
(``test_heat``), and the merge plane's adversarial fuzz and overflow
recovery (``test_adversarial_fuzz``, ``test_overflow_recovery``), run
on both packages (``test_torch_service_layers.run_mirrored``: the
reference's own test source, imports rewired). Nothing is left out.

Three sources name what the port calls otherwise, so on the port they
run with the edits in ``EDITS``:

- the reference's ``TpuMergeSidecar`` is bound to the port's
  ``GpuMergeSidecar(device="cpu")`` (the port's planes run on the CPU
  only when the caller names it);
- ``make_table`` is given ``"cpu"`` for the same reason, and the
  packed batch goes to the CPU through ``convert.batch_from_numpy``
  (the reference's window apply takes numpy, the port's takes
  tensors), so the window apply is the plain version of the Hopper
  kernel;
- ``test_heat``'s two-device mesh is the CPU's twice rather than
  ``jax.devices()[:2]``.
"""
import pytest

from test_torch_service_layers import (
    PACKAGES,
    alfred_fixture,
    case_id,
    mirror_cases,
    run_mirrored,
)

MIRRORED = (
    "test_summarizer",
    "test_gc_blobs_attribution",
    "test_url_resolver",
    "test_driver_utils",
    "test_telemetry_config",
    "test_mergetree",
    "test_intervals",
    "test_reconnect",
    "test_convergence_fuzz",
    "test_heat",
    "test_adversarial_fuzz",
    "test_overflow_recovery",
)
LEFT_OUT: dict = {}
_CPU_SIDECAR = (
    "import functools\n"
    "from fluidframework_tpu_torch.service import GpuMergeSidecar\n"
    "TpuMergeSidecar = functools.partial(GpuMergeSidecar, "
    "device=\"cpu\")\n")
_CPU_BATCH = "from fluidframework_tpu_torch.convert import batch_from_numpy\n"
EDITS = {
    "test_heat": (
        ("import jax\n", "import torch\n"),
        ("    from fluidframework_tpu_torch.service import "
         "TpuMergeSidecar\n",
         "    from fluidframework_tpu_torch.service import "
         "GpuMergeSidecar\n"
         "    TpuMergeSidecar = functools.partial(GpuMergeSidecar, "
         "device=\"cpu\")\n"),
        ("import random\n", "import functools\nimport random\n"),
        ("make_mesh(jax.devices()[:2])",
         "make_mesh([torch.device(\"cpu\")] * 2)"),
    ),
    "test_adversarial_fuzz": (
        ("import pytest\n", "import pytest\n" + _CPU_BATCH),
        ("make_table(len(encs), capacity)",
         "make_table(len(encs), capacity, \"cpu\")"),
        ("    batch = build_batch(encs)\n",
         "    batch = batch_from_numpy(build_batch(encs), \"cpu\")\n"),
    ),
    "test_overflow_recovery": (
        ("import pytest\n", "import pytest\n" + _CPU_BATCH),
        ("from fluidframework_tpu_torch.service import LocalServer, "
         "TpuMergeSidecar\n",
         "from fluidframework_tpu_torch.service import LocalServer\n"
         + _CPU_SIDECAR),
        ("make_table(1, 1024)", "make_table(1, 1024, \"cpu\")"),
        ("    batch = build_batch([enc])\n",
         "    batch = batch_from_numpy(build_batch([enc]), \"cpu\")\n"),
    ),
}


@pytest.fixture()
def alfred(package, monkeypatch):
    yield from alfred_fixture(package, monkeypatch)


def test_every_mirrored_module_gives_cases():
    cases = mirror_cases(MIRRORED, LEFT_OUT)
    assert {m for m, _n, _p in (getattr(c, "values", c) for c in cases)} \
        == set(MIRRORED)
    assert not LEFT_OUT


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT), ids=case_id)
def test_mirrored(package, module, name, params, request):
    edits = EDITS.get(module, ()) if package == PACKAGES[1] else ()
    run_mirrored(package, module, name, request, params, edits)
