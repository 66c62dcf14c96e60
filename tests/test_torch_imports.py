"""The PyTorch port stands alone: importing it (and ``chip_smoke``)
loads neither JAX nor anything of the JAX package, and with no GPU its
entry points refuse to run quietly on the CPU."""
import ast
import json
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

# the modules of the executor routes, named so that a rename cannot drop
# them from the checks below unnoticed
ROUTE_MODULES = (
    "fluidframework_tpu_torch.ops.merge_chunk",
    "fluidframework_tpu_torch.ops.event_graph",
    "fluidframework_tpu_torch.service.gpu_sidecar",
)
# the tree plane's modules, named for the same reason
TREE_MODULES = (
    "fluidframework_tpu_torch.models.tree.changeset",
    "fluidframework_tpu_torch.models.tree.forest",
    "fluidframework_tpu_torch.models.tree.anchors",
    "fluidframework_tpu_torch.models.tree.editmanager",
    "fluidframework_tpu_torch.protocol.tree_payload",
    "fluidframework_tpu_torch.testing.tree_fuzz",
    "fluidframework_tpu_torch.ops.tree_atoms",
    "fluidframework_tpu_torch.ops.tree_kernel",
    "fluidframework_tpu_torch.ops.tree_apply",
    "fluidframework_tpu_torch.service.tree_sidecar",
)
# the pool tiers' and sharding modules, named for the same reason
POOL_MODULES = (
    "fluidframework_tpu_torch.obs.heat",
    "fluidframework_tpu_torch.ops.shard_moves",
    "fluidframework_tpu_torch.parallel.mesh",
    "fluidframework_tpu_torch.parallel.seq_shard",
    "fluidframework_tpu_torch.parallel.mesh_pool",
    "fluidframework_tpu_torch.parallel.distributed",
)
# the host replay's and the matrix plane's modules, named for the same
# reason
MATRIX_MODULES = (
    "fluidframework_tpu_torch.ops.host_replay",
    "fluidframework_tpu_torch.ops.matrix_cells",
    "fluidframework_tpu_torch.ops.matrix_bridge",
    "fluidframework_tpu_torch.testing.matrix_streams",
)

# the observability, protection and tooling modules, named for the same
# reason
OBS_MODULES = (
    "fluidframework_tpu_torch.obs.metrics",
    "fluidframework_tpu_torch.obs.flight_recorder",
    "fluidframework_tpu_torch.obs.trace",
    "fluidframework_tpu_torch.obs.profiler",
    "fluidframework_tpu_torch.obs.timeline",
    "fluidframework_tpu_torch.qos.faults",
    "fluidframework_tpu_torch.qos.breaker",
    "fluidframework_tpu_torch.ops.window_cost",
    "fluidframework_tpu_torch.testing.jitsan",
    "fluidframework_tpu_torch.analysis.synccheck",
    "fluidframework_tpu_torch.analysis.__main__",
)

_CHILD = r"""
import importlib, json, pkgutil, sys
import fluidframework_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "fluidframework_tpu" or m.startswith("fluidframework_tpu."))
print(json.dumps({"names": names, "bad": bad}))
"""


def test_port_import_loads_no_jax():
    env = dict(os.environ)
    env.pop("FFTPU_SANITIZE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert len(out["names"]) >= 20
    assert set(ROUTE_MODULES + TREE_MODULES + POOL_MODULES
               + MATRIX_MODULES + OBS_MODULES) <= set(out["names"])
    assert out["bad"] == []


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_source_scan_covers_the_route_modules():
    scanned = set(_sources())
    for name in (ROUTE_MODULES + TREE_MODULES + POOL_MODULES
                 + MATRIX_MODULES + OBS_MODULES):
        path = REPO.joinpath(*name.split(".")).with_suffix(".py")
        assert path in scanned, name


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


def test_ops_package_exports_the_route_entry_points():
    from fluidframework_tpu_torch import ops
    from fluidframework_tpu_torch.ops import event_graph, merge_chunk

    assert ops.apply_window_chunked is merge_chunk.apply_window_chunked
    assert ops.apply_batch_egwalker is event_graph.apply_batch_egwalker
    from fluidframework_tpu_torch.ops import tree_apply, tree_kernel

    assert ops.apply_tree_window is tree_apply.apply_tree_window
    assert ops.rebase_atoms is tree_kernel.rebase_atoms
    from fluidframework_tpu_torch.ops import (
        host_replay, matrix_bridge, matrix_cells,
    )

    assert ops.replay_encoded is host_replay.replay_encoded
    assert ops.CellPack is matrix_cells.CellPack
    assert ops.dispatch_matrix_batch is matrix_bridge.dispatch_matrix_batch
    for name in ops.__all__:
        assert getattr(ops, name) is not None, name
    with pytest.raises(AttributeError):
        ops.no_such_entry_point


def test_sidecar_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuMergeSidecar()


def test_matrix_plane_without_gpu_raises():
    from fluidframework_tpu_torch.ops import CellPack, dispatch_matrix_batch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CellPack(4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        dispatch_matrix_batch(None, 1)


def test_tree_plane_without_gpu_raises():
    from fluidframework_tpu_torch.ops import make_tree_table
    from fluidframework_tpu_torch.service import TreeSeqPool, TreeSidecar

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_tree_table(2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        TreeSidecar()
    with pytest.raises(RuntimeError, match="CUDA"):
        TreeSeqPool(None, 64)


def test_pool_mesh_without_gpu_raises():
    """A mesh never lands on the CPU unless the caller names it."""
    from fluidframework_tpu_torch.parallel import (
        make_global_mesh, make_mesh, make_seq_mesh,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (make_mesh, make_seq_mesh, make_global_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh([torch.device("cuda", 0)])
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuMergeSidecar(seq_mesh=make_mesh([torch.device("cpu")]))


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
