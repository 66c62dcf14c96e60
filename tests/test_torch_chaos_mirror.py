"""The reference's chaos tests (``test_chaos``: the fault plane, the
crash-restart, kill-the-leader and netsplit convergence differentials,
the storms and the ``tools.stress`` chaos modes), run on both packages
(``test_torch_service_layers.run_mirrored``: the reference's own test
source, imports rewired). The sweeps' seeds outside {0, 1, 2} keep the
reference's slow marks.

No case is left out. The port's harness runs its merge sidecars on the
CPU: the edits below hand ``device="cpu"`` to the harness's entry
points and ``--sidecar-device cpu`` to the CLI, the seams' import
names the port's sidecar module, and the body that built
the reference's two-device JAX mesh builds the port's
``make_mesh([torch.device("cpu")] * 2)``. The reference's module-scoped
fixtures (the fault-free oracles) are built once per package here too.
"""
import functools
import inspect

import pytest

from test_torch_service_layers import (
    PACKAGES,
    _namespace,
    alfred_fixture,
    case_id,
    mirror_cases,
    registries_restored,
    run_mirrored,
)

MIRRORED = ("test_chaos",)
LEFT_OUT: dict = {}
PORT = "fluidframework_tpu_torch"
PORT_EDITS = (
    ("\nN_SEEDS = 20\n",
     "\n_cpu = functools.partial(functools.partial, device=\"cpu\")\n"
     "run_chaos, run_chaos_failover, run_chaos_netsplit = (\n"
     "    _cpu(run_chaos), _cpu(run_chaos_failover),\n"
     "    _cpu(run_chaos_netsplit))\n"
     "run_chaos_storm, ChaosHarness = (_cpu(run_chaos_storm),\n"
     "                                 _cpu(ChaosHarness))\n"
     "\nN_SEEDS = 20\n"),
    ("import json\nimport os\n", "import functools\nimport json\nimport os\n"),
    ("import fluidframework_tpu_torch.service.tpu_sidecar  # noqa",
     "import fluidframework_tpu_torch.service.gpu_sidecar  # noqa"),
    ("        rc = mod.main(argv)",
     "        rc = mod.main(argv + [\"--sidecar-device\", \"cpu\"])"),
    ("""    import jax

    from fluidframework_tpu_torch.parallel import make_seq_mesh
    from fluidframework_tpu_torch.parallel.mesh import make_mesh
    from fluidframework_tpu_torch.service.tpu_sidecar import TpuMergeSidecar

    if route == "seq":
        mesh = make_seq_mesh(jax.devices()[:1])
    else:
        mesh = make_mesh(jax.devices()[:2])
    return TpuMergeSidecar(
""", """    import torch

    from fluidframework_tpu_torch.parallel import make_seq_mesh
    from fluidframework_tpu_torch.parallel.mesh import make_mesh
    from fluidframework_tpu_torch.service.gpu_sidecar import GpuMergeSidecar

    if route == "seq":
        mesh = make_seq_mesh([torch.device("cpu")])
    else:
        mesh = make_mesh([torch.device("cpu")] * 2)
    return GpuMergeSidecar(
        device="cpu",
"""),
)
# the reference's scope="module" fixtures
MODULE_FIXTURES = ("oracle", "failover_oracle")


@pytest.fixture(autouse=True)
def _registries_restored():
    yield from registries_restored()


@pytest.fixture()
def alfred(package, monkeypatch):
    yield from alfred_fixture(package, monkeypatch)


@functools.lru_cache(maxsize=None)
def _edits(package: str) -> tuple:
    """The package's edits; on first use, each module-scoped fixture of
    its executed source is made to build its value once."""
    edits = PORT_EDITS if package == PORT else ()
    namespace = _namespace("test_chaos", package, edits)
    for name in MODULE_FIXTURES:
        namespace[name] = _Once(namespace[name]._get_wrapped_function())
    return edits


class _Once:
    """A fixture stand-in that ``run_mirrored`` builds like the
    fixture it wraps, computing the value on the first request only."""

    def __init__(self, fn):
        self._fn = fn
        self._value = None

    def _get_wrapped_function(self):
        def value(**kwargs):
            if self._value is None:
                self._value = self._fn(**kwargs)
            return self._value

        value.__signature__ = inspect.signature(self._fn)
        return value


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name,params",
                         mirror_cases(MIRRORED, LEFT_OUT), ids=case_id)
def test_mirrored(package, module, name, params, request):
    run_mirrored(package, module, name, request, params, _edits(package))
