"""The reference's tests of the service, driver, loader and runtime
layers, run on both packages.

Each mirrored test body is the reference test file's own source, executed
once per package: for the port, every ``fluidframework_tpu`` import in
the source is rewired to ``fluidframework_tpu_torch`` and nothing else
changes, so a body cannot drift from the reference's. Every case runs
twice (``[fluidframework_tpu-...]`` and ``[fluidframework_tpu_torch-...]``).

Left out, with the module they wait for (the port does not have it yet):

- ``test_durable_storage.py::test_service_survives_kill_and_restart``:
  a service subprocess behind the TCP ingress (``service.ingress``);
- ``test_durable_storage.py::test_queue_commit_offset_is_crash_atomic``,
  ``::test_torn_queue_offset_states_are_pinned``,
  ``::test_queue_record_crc_detected_and_scrubbed``: the partitioned
  ordering queue (``service.partitioning``).
"""
import ast
import functools
import inspect
import re
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
PACKAGES = ("fluidframework_tpu", "fluidframework_tpu_torch")
MIRRORED = (
    "test_local_server",
    "test_quorum",
    "test_sequencer",
    "test_collab_window",
    "test_op_lifecycle",
    "test_durable_storage",
)
LEFT_OUT = {
    "test_durable_storage": {
        "test_service_survives_kill_and_restart": "service.ingress",
        "test_queue_commit_offset_is_crash_atomic": "service.partitioning",
        "test_torn_queue_offset_states_are_pinned": "service.partitioning",
        "test_queue_record_crc_detected_and_scrubbed":
            "service.partitioning",
    },
}


def _cases() -> list:
    out = []
    for module in MIRRORED:
        tree = ast.parse((TESTS / f"{module}.py").read_text())
        for node in tree.body:
            if (isinstance(node, ast.FunctionDef)
                    and node.name.startswith("test_")
                    and node.name not in LEFT_OUT.get(module, {})):
                out.append((module, node.name))
    return out


@functools.lru_cache(maxsize=None)
def _namespace(module: str, package: str) -> dict:
    """The reference test module's namespace, its imports taken from
    ``package``."""
    path = TESTS / f"{module}.py"
    source = re.sub(r"\bfluidframework_tpu\b", package, path.read_text())
    namespace = {"__name__": f"{module}[{package}]", "__file__": str(path)}
    exec(compile(source, f"{path}[{package}]", "exec"), namespace)
    return namespace


def test_left_out_cases_exist():
    """Every case named as left out is still a test of the reference."""
    for module, names in LEFT_OUT.items():
        tree = ast.parse((TESTS / f"{module}.py").read_text())
        defined = {n.name for n in tree.body
                   if isinstance(n, ast.FunctionDef)}
        assert set(names) <= defined, module


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,name", _cases(),
                         ids=lambda v: v)
def test_mirrored(package, module, name, request):
    fn = _namespace(module, package)[name]
    assert not getattr(fn, "pytestmark", None), (
        f"{module}::{name} carries marks; mirror it by hand")
    fn(**{arg: request.getfixturevalue(arg)
          for arg in inspect.signature(fn).parameters})
