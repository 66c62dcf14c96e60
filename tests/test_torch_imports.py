"""The PyTorch port stands alone: importing it (and ``chip_smoke``)
loads neither JAX nor anything of the JAX package, and with no GPU its
entry points refuse to run quietly on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import fluidframework_tpu_torch
from fluidframework_tpu_torch.service import GpuMergeSidecar

REPO = Path(__file__).resolve().parent.parent
PORT = Path(fluidframework_tpu_torch.__file__).resolve().parent

_CHILD = r"""
import importlib, pkgutil, sys
import fluidframework_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "fluidframework_tpu" or m.startswith("fluidframework_tpu."))
print(len(names), bad)
"""


def test_port_import_loads_no_jax():
    env = dict(os.environ)
    env.pop("FFTPU_SANITIZE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    n_modules, bad = proc.stdout.split(" ", 1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]"


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_source_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "fluidframework_tpu"), (
                f"{path.name}:{node.lineno} imports {mod}")


def test_sidecar_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuMergeSidecar()


def test_cpu_apply_never_touches_the_build(monkeypatch):
    from fluidframework_tpu_torch.ops import cuda_merge, merge_kernel
    from fluidframework_tpu_torch.ops.segment_table import (
        KIND_NOOP, OpBatch, make_table,
    )

    def refuse(*_a, **_k):
        raise AssertionError("the kernel build was touched")

    monkeypatch.setattr(cuda_merge, "build", refuse)
    monkeypatch.setattr(cuda_merge, "load_library", refuse)
    launches = cuda_merge.LAUNCHES
    table = make_table(2, 16, "cpu")
    batch = OpBatch(*(
        torch.full((2, 4), KIND_NOOP if f == "kind" else 0,
                   dtype=torch.int32)
        for f in OpBatch._fields))
    out = merge_kernel.apply_window(table, batch)
    assert out.count.tolist() == [0, 0]
    assert cuda_merge.LAUNCHES == launches


def test_cuda_wrapper_rejects_cpu_tensors():
    from fluidframework_tpu_torch.ops.cuda_merge import apply_window_cuda
    from fluidframework_tpu_torch.ops.segment_table import OpBatch, make_table

    table = make_table(1, 16, "cpu")
    batch = OpBatch(*(torch.zeros((1, 1), dtype=torch.int32)
                      for _ in OpBatch._fields))
    with pytest.raises(ValueError, match="CUDA"):
        apply_window_cuda(table, batch)
