"""The PyTorch port stands alone: importing it (and ``chip_smoke``)
loads neither JAX nor anything of the JAX package, and with no GPU its
entry points refuse to run quietly on the CPU."""
import ast
import json
import os
import re
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

# the in-process service and client stack's modules, named for the same
# reason
SERVICE_MODULES = (
    "fluidframework_tpu_torch.utils.events",
    "fluidframework_tpu_torch.utils.telemetry",
    "fluidframework_tpu_torch.utils.config",
    "fluidframework_tpu_torch.protocol.quorum",
    "fluidframework_tpu_torch.protocol.serialization",
    "fluidframework_tpu_torch.service.sequencer",
    "fluidframework_tpu_torch.service.telemetry",
    "fluidframework_tpu_torch.service.lambdas",
    "fluidframework_tpu_torch.service.storage",
    "fluidframework_tpu_torch.service.local_orderer",
    "fluidframework_tpu_torch.service.local_server",
    "fluidframework_tpu_torch.drivers.definitions",
    "fluidframework_tpu_torch.drivers.driver_utils",
    "fluidframework_tpu_torch.drivers.local_driver",
    "fluidframework_tpu_torch.drivers.replay_driver",
    "fluidframework_tpu_torch.drivers.file_driver",
    "fluidframework_tpu_torch.runtime.handles",
    "fluidframework_tpu_torch.runtime.shared_object",
    "fluidframework_tpu_torch.runtime.datastore",
    "fluidframework_tpu_torch.runtime.op_lifecycle",
    "fluidframework_tpu_torch.runtime.blobs",
    "fluidframework_tpu_torch.runtime.container_runtime",
    "fluidframework_tpu_torch.models.intervals",
    "fluidframework_tpu_torch.models.sharedstring",
    "fluidframework_tpu_torch.models.map",
    "fluidframework_tpu_torch.loader.collab_window",
    "fluidframework_tpu_torch.loader.scheduler",
    "fluidframework_tpu_torch.loader.container",
    "fluidframework_tpu_torch.testing.runtime_mocks",
)

# the networked front door's modules and the planes it rides on, named
# for the same reason
INGRESS_MODULES = (
    "fluidframework_tpu_torch.protocol.columnar",
    "fluidframework_tpu_torch.service.tenancy",
    "fluidframework_tpu_torch.qos.rate_limiter",
    "fluidframework_tpu_torch.qos.pressure",
    "fluidframework_tpu_torch.qos.policy",
    "fluidframework_tpu_torch.qos.admission",
    "fluidframework_tpu_torch.obs.slo",
    "fluidframework_tpu_torch.obs.spans",
    "fluidframework_tpu_torch.obs.federation",
    "fluidframework_tpu_torch.service.ingress",
    "fluidframework_tpu_torch.service.__main__",
    "fluidframework_tpu_torch.drivers.socket_driver",
    "fluidframework_tpu_torch.drivers.caching_driver",
    "fluidframework_tpu_torch.testing.fault_injection",
    "fluidframework_tpu_torch.testing.chaos",
    "fluidframework_tpu_torch.tools.stress",
    "fluidframework_tpu_torch.tools.serve_bench",
)

# the DDS catalogue's modules (every channel type of the registry, the
# generic DDS fuzz engine, the stored-format compat helpers), named for
# the same reason
DDS_MODULES = (
    "fluidframework_tpu_torch.models.tree.schema",
    "fluidframework_tpu_torch.models.tree.editable",
    "fluidframework_tpu_torch.models.tree.sharedtree",
    "fluidframework_tpu_torch.models.matrix",
    "fluidframework_tpu_torch.models.cell",
    "fluidframework_tpu_torch.models.counter",
    "fluidframework_tpu_torch.models.summaryblock",
    "fluidframework_tpu_torch.models.quorum_dds",
    "fluidframework_tpu_torch.models.taskmanager",
    "fluidframework_tpu_torch.models.consensus",
    "fluidframework_tpu_torch.models.ink",
    "fluidframework_tpu_torch.models.ot",
    "fluidframework_tpu_torch.models.property_dds",
    "fluidframework_tpu_torch.models.legacy_tree",
    "fluidframework_tpu_torch.testing.dds_fuzz",
    "fluidframework_tpu_torch.testing.compat",
)

# the runtime's summarizer, GC and attribution, the id compressor, the
# last two drivers and the framework layer, named for the same reason
FRAMEWORK_MODULES = (
    "fluidframework_tpu_torch.runtime.summarizer",
    "fluidframework_tpu_torch.runtime.gc",
    "fluidframework_tpu_torch.runtime.attribution",
    "fluidframework_tpu_torch.utils.id_compressor",
    "fluidframework_tpu_torch.drivers.debug_driver",
    "fluidframework_tpu_torch.drivers.url_resolver",
    "fluidframework_tpu_torch.framework.richtext",
    "fluidframework_tpu_torch.framework.flowdoc",
    "fluidframework_tpu_torch.framework.undo_redo",
    "fluidframework_tpu_torch.framework.fluid_static",
    "fluidframework_tpu_torch.framework.data_object",
    "fluidframework_tpu_torch.framework.helpers",
    "fluidframework_tpu_torch.framework.clients",
    "fluidframework_tpu_torch.framework",
)

# the ordering plane's scale-out and replication layer, named for the
# same reason (``local_orderer`` and ``obs.timeline`` are whole copies
# since this layer came)
ORDERING_MODULES = (
    "fluidframework_tpu_torch.service.core_interfaces",
    "fluidframework_tpu_torch.service.local_orderer",
    "fluidframework_tpu_torch.service.partitioning",
    "fluidframework_tpu_torch.service.replication",
    "fluidframework_tpu_torch.service.broker",
    "fluidframework_tpu_torch.service.moira",
    "fluidframework_tpu_torch.service.foreman",
    "fluidframework_tpu_torch.obs.timeline",
)

# the native host layer (the C++ sequencer core and merge replayer with
# their loaders) and the chaos harness and its CLI, named for the same
# reason
NATIVE_MODULES = (
    "fluidframework_tpu_torch.native",
    "fluidframework_tpu_torch.native.sequencer_core",
    "fluidframework_tpu_torch.native.replay_baseline",
    "fluidframework_tpu_torch.testing.chaos",
    "fluidframework_tpu_torch.tools.stress",
)

# the fluidlint families, the CLI and the runtime sanitizers, named for
# the same reason
ANALYSIS_MODULES = (
    "fluidframework_tpu_torch.analysis",
    "fluidframework_tpu_torch.analysis.__main__",
    "fluidframework_tpu_torch.analysis.core",
    "fluidframework_tpu_torch.analysis.callgraph",
    "fluidframework_tpu_torch.analysis.layercheck",
    "fluidframework_tpu_torch.analysis.lockcheck",
    "fluidframework_tpu_torch.analysis.concurrency",
    "fluidframework_tpu_torch.analysis.obscheck",
    "fluidframework_tpu_torch.analysis.qoscheck",
    "fluidframework_tpu_torch.analysis.wirecheck",
    "fluidframework_tpu_torch.analysis.determinism",
    "fluidframework_tpu_torch.analysis.failcheck",
    "fluidframework_tpu_torch.analysis.shapecheck",
    "fluidframework_tpu_torch.testing.sanitizer",
    "fluidframework_tpu_torch.testing.wiresan",
    "fluidframework_tpu_torch.testing.detsan",
    "fluidframework_tpu_torch.testing.failsan",
    "fluidframework_tpu_torch.testing.sanitize_plugin",
)

# the tools and the examples (the reference keeps its examples outside
# its package; the port's are a subpackage), named for the same reason
TOOLS_MODULES = (
    "fluidframework_tpu_torch.tools",
    "fluidframework_tpu_torch.tools.benchmark",
    "fluidframework_tpu_torch.tools.replay_tool",
    "fluidframework_tpu_torch.tools.fluid_runner",
    "fluidframework_tpu_torch.tools.fetch_tool",
    "fluidframework_tpu_torch.tools.net_stress",
    "fluidframework_tpu_torch.examples",
) + tuple(f"fluidframework_tpu_torch.examples.{name}" for name in (
    "collaborative_text", "todo_app", "table_grid", "tree_outline",
    "property_cad", "network_chat", "ink_whiteboard", "richtext_editor",
    "webflow_editor", "secure_multitenant", "fleet_timeline",
    "netsplit_timeline", "slo_report", "heat_dump", "op_trace"))

_CHILD = r"""
import importlib, json, pkgutil, sys
import fluidframework_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import runpy
sys.argv = ["fluidframework_tpu_torch.service", "--help"]
try:
    runpy.run_module("fluidframework_tpu_torch.service", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
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
    assert "--dump-metrics" in proc.stdout  # the service's --help ran
    out = json.loads(proc.stdout.splitlines()[-1])
    assert len(out["names"]) >= 20
    assert set(ROUTE_MODULES + TREE_MODULES + POOL_MODULES
               + MATRIX_MODULES + OBS_MODULES + SERVICE_MODULES
               + INGRESS_MODULES + DDS_MODULES + FRAMEWORK_MODULES
               + ORDERING_MODULES + NATIVE_MODULES
               + ANALYSIS_MODULES[1:] + TOOLS_MODULES[1:]) \
        <= set(out["names"])
    assert out["bad"] == []


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_source_scan_covers_the_route_modules():
    scanned = set(_sources())
    for name in (ROUTE_MODULES + TREE_MODULES + POOL_MODULES
                 + MATRIX_MODULES + OBS_MODULES + SERVICE_MODULES
                 + INGRESS_MODULES + DDS_MODULES + FRAMEWORK_MODULES
                 + ORDERING_MODULES + NATIVE_MODULES + ANALYSIS_MODULES
                 + TOOLS_MODULES):
        path = REPO.joinpath(*name.split(".")).with_suffix(".py")
        if not path.exists():  # a package
            path = path.with_suffix("") / "__init__.py"
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


def test_no_string_names_a_module_of_the_reference():
    """A command a tool or an example spawns (``-m <module>``, a ``-c``
    program) is a string the import scan cannot see: no string of the
    port names a module of the JAX package. The one exception is the
    OTLP scope name, kept equal to the reference's on purpose."""
    hits = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(
                    node.value, str) and re.search(
                    r"\bfluidframework_tpu\.", node.value):
                hits.append((path.relative_to(REPO).as_posix(),
                             node.value))
    assert hits == [("fluidframework_tpu_torch/obs/spans.py",
                     "fluidframework_tpu.obs")]


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


def test_ordering_modules_import_alone():
    """Each module of the ordering layer, imported by itself in a fresh
    interpreter, loads neither JAX nor the JAX package."""
    child = ("import importlib, json, sys\n"
             f"for name in {list(ORDERING_MODULES)!r}:\n"
             "    importlib.import_module(name)\n"
             "print(json.dumps(sorted(m for m in sys.modules if m == 'jax'"
             " or m.startswith('jax.') or m == 'fluidframework_tpu'"
             " or m.startswith('fluidframework_tpu.'))))\n")
    env = dict(os.environ)
    env.pop("FFTPU_SANITIZE", None)
    proc = subprocess.run([sys.executable, "-c", child], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []


_NATIVE_CHILD = r"""
import json, sys
seen = []
sys.addaudithook(lambda event, args: seen.append((event, repr(args)))
                 if event in ("open", "ctypes.dlopen", "subprocess.Popen")
                 else None)
from fluidframework_tpu_torch import native
from fluidframework_tpu_torch.native.replay_baseline import MergeHostSession
from fluidframework_tpu_torch.native.sequencer_core import MultiDocSequencer
assert native.load_native_sequencer() is not None, native.native_build_error()
assert native.load_merge_replay() is not None, native.merge_replay_error()
MultiDocSequencer(2).join(1, 0)
MergeHostSession(2).close()
print(json.dumps(seen))
"""


def test_native_layer_reads_nothing_of_the_reference(tmp_path):
    """The port's native layer, imported, built and loaded in a fresh
    interpreter (with its build directory empty, so ``g++`` runs),
    opens, compiles and loads no file of ``fluidframework_tpu/`` (no
    ``.cpp`` and no ``.so`` of the reference's ``native/``), and loads
    neither JAX nor the JAX package."""
    import shutil

    from fluidframework_tpu_torch import native

    copy = tmp_path / "repo"
    shutil.copytree(PORT, copy / PORT.name, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    env = dict(os.environ)
    env.pop("FFTPU_SANITIZE", None)
    env.pop("FFTPU_DISABLE_NATIVE", None)
    proc = subprocess.run([sys.executable, "-c", _NATIVE_CHILD],
                          cwd=copy, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    seen = json.loads(proc.stdout.splitlines()[-1])
    reference = str(REPO / "fluidframework_tpu") + os.sep
    assert [e for e in seen if reference in e[1]
            or "fluidframework_tpu/" in e[1]] == []
    built = copy / PORT.name / "_build"
    compiled = [e for e in seen if e[0] == "subprocess.Popen"]
    assert len(compiled) == 2 and all(
        str(copy / PORT.name / "native") in e[1] for e in compiled)
    loaded = [e for e in seen if e[0] == "ctypes.dlopen"
              and str(built) in e[1]]
    assert len(loaded) == 2, seen
    assert sorted(p.name.split("-")[0] for p in built.glob("*.so")) == [
        "merge_replay", "sequencer"]
    assert native.BUILD_DIR == PORT / "_build"


def _start_service(args, data_dir):
    """``python -m fluidframework_tpu_torch.service`` on an ephemeral
    port: the process and the port it printed (None if it exited)."""
    import re

    env = dict(os.environ)
    env.pop("FFTPU_SANITIZE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service",
         "--port", "0", "--data-dir", str(data_dir), *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()
    found = re.search(r"listening on [\w.]+:(\d+)", line)
    return proc, (int(found.group(1)) if found else None), line


def test_partitioned_service_cli_serves_and_refuses_layout_change(tmp_path):
    """``--partitions 2`` serves a TCP session through ``run_server``'s
    ``PartitionedServer`` (a writer and a reader equal), and a restart
    of the same data dir under another partition count is refused, as
    the reference refuses it."""
    import time

    from fluidframework_tpu_torch.drivers import SocketDocumentServiceFactory
    from fluidframework_tpu_torch.loader import Container

    data = tmp_path / "data"
    proc, port, line = _start_service(["--partitions", "2"], data)
    try:
        assert port is not None, line
        factory = SocketDocumentServiceFactory("127.0.0.1", port)
        svc = factory.create_document_service("cli-doc")
        try:
            with svc.lock:
                c = Container.load(svc, client_id="writer")
                s = c.runtime.create_datastore("d").create_channel(
                    "sharedstring", "s")
                for i in range(4):
                    s.insert_text(s.get_length(), f"edit {i}; ")
                c.flush()
            deadline = time.monotonic() + 60
            while True:
                with svc.lock:
                    if c.runtime.pending.count == 0:
                        break
                assert time.monotonic() < deadline, "no acks"
                time.sleep(0.02)
            reader_svc = factory.create_document_service("cli-doc")
            try:
                with reader_svc.lock:
                    r = Container.load(reader_svc, client_id="reader")
                    got = r.runtime.get_datastore("d").get_channel("s")
                    with svc.lock:
                        assert got.get_text() == s.get_text() == "".join(
                            f"edit {i}; " for i in range(4))
                        assert got.signature() == s.signature()
                    r.close()
            finally:
                reader_svc.close()
            with svc.lock:
                c.close()
        finally:
            svc.close()
    finally:
        proc.terminate()
        proc.wait(30)
        proc.stdout.close()
    with open(data / "layout.json") as f:
        assert json.load(f) == {"mode": "partitioned", "partitions": 2,
                                "queue": "local"}
    proc, port, line = _start_service(["--partitions", "4"], data)
    out = line + proc.stdout.read()
    assert proc.wait(60) != 0 and port is None
    proc.stdout.close()
    assert "refusing to start" in out and "'partitions': 4" in out
    from fluidframework_tpu.service.ingress import _check_durable_layout

    with pytest.raises(SystemExit) as refused:
        _check_durable_layout(str(data), 4)
    assert str(refused.value.code) in out  # the reference's refusal
