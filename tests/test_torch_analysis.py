"""The port's fluidlint, held against the port's own tree: the two
layering repairs, every registry entry of the families and the
sanitizers resolving to code of the port, detcheck's reach into
``GpuMergeSidecar``, and the CLI's per-family report.

The whole-tree gate itself (every family clean, the allowlist empty and
within its cap) is the reference's ``test_fluidlint_gate`` run on the
port (``tests/test_torch_analysis_mirror.py``)."""
import ast
import re
import textwrap

import pytest

from fluidframework_tpu_torch.analysis import (
    concurrency,
    core,
    determinism,
    failcheck,
    layercheck,
    obscheck,
    synccheck,
    wirecheck,
)
from fluidframework_tpu_torch.analysis.callgraph import build_callgraph

PKG = "fluidframework_tpu_torch"


@pytest.fixture(scope="module")
def tree():
    """The port package's parsed files and their call graph (one parse
    for every case of the module)."""
    files = core.walk_python_files([PKG])
    return files, build_callgraph(files)


def _resolves(files, suffix: str, qual: str) -> bool:
    """``suffix`` names a file of the port and ``qual`` a function of
    it (``*``: the module itself; a nested def by its dotted path)."""
    srcs = [f for f in files if f.relpath.endswith(suffix)]
    if not srcs:
        return False
    if qual == "*":
        return True
    quals = {q for src in srcs for q, _fn in determinism._functions(
        src.tree)}
    return qual in quals


def test_allowlist_is_empty():
    assert core.load_allowlist() == []


def test_default_roots_are_the_port_and_its_own_tests():
    files = core.walk_python_files(core.DEFAULT_ROOTS)
    tops = {f.relpath.split("/")[0] for f in files}
    assert tops == {PKG, "chip_smoke.py", "tests"}
    tests = {f.relpath for f in files if f.relpath.startswith("tests/")}
    assert tests and all(
        re.fullmatch(r"tests/test_torch_\w+\.py", t) for t in tests)


def test_a_glob_matching_nothing_is_an_error():
    with pytest.raises(ValueError, match="no file matches"):
        core.walk_python_files(["tests/test_nothing_*.py"])


def test_service_imports_parallel_function_locally_only(tree):
    """The repair of ``service/gpu_sidecar.py``: its ``parallel``
    imports are function-local, as the reference's are, so the port's
    layer map keeps the reference's ``service`` row."""
    files, _graph = tree
    assert "parallel" not in layercheck.ALLOWED["service"]
    edges = [(a, b, path) for a, b, path, _line in layercheck.edges(files)
             if a == "service" and b == "parallel"]
    assert edges == []
    (src,) = [f for f in files
              if f.relpath == f"{PKG}/service/gpu_sidecar.py"]
    local = [n for n in ast.walk(src.tree)
             if isinstance(n, ast.ImportFrom)
             and (n.module or "").startswith("parallel")]
    assert len(local) >= 3  # SeqShardedPool, its apply, select_pool


def test_a_module_level_parallel_import_in_service_is_flagged(tmp_path):
    """The same import at module level is a layer-undeclared finding:
    the gate holds the repair."""
    pkg = tmp_path / PKG
    (pkg / "service").mkdir(parents=True)
    (pkg / "parallel").mkdir()
    (pkg / "service" / "gpu_sidecar.py").write_text(
        "from ..parallel.mesh import DeviceMesh\n")
    findings = core.run_analysis(roots=[PKG], families=["layercheck"],
                                 repo_root=str(tmp_path))
    assert [(f.rule, f.key) for f in findings] == [
        ("layer-undeclared", "service->parallel")]


def test_convert_is_declared_with_its_sanctioned_cycle(tree):
    """``convert`` (the numpy <-> device boundary of ops's types) is
    declared: ops, parallel and service may import it, it imports ops,
    and the pair is sanctioned, so the declared map stays acyclic."""
    files, _graph = tree
    assert layercheck.ALLOWED["convert"] == {"ops"}
    for row in ("ops", "parallel", "service"):
        assert "convert" in layercheck.ALLOWED[row], row
    assert ("convert", "ops") in layercheck.SANCTIONED_CYCLES
    assert layercheck.declared_cycle() == []
    users = {a for a, b, _path, _line in layercheck.edges(files)
             if b == "convert"}
    assert users == {"ops", "parallel", "service"}


def test_detcheck_reaches_the_gpu_sidecar(tree):
    """The translated registries put ``GpuMergeSidecar`` in the
    deterministic scope: its ingest, apply and prewarm are reached
    from the roots (the chaos harness and serve_bench drive it by
    attribute)."""
    files, graph = tree
    reached = {(i.relpath, i.qualname)
               for i in determinism._det_reachable(files, graph)}
    for qual in ("GpuMergeSidecar.ingest", "GpuMergeSidecar.apply",
                 "GpuMergeSidecar.prewarm", "GpuMergeSidecar._dispatch",
                 "GpuMergeSidecar._settle"):
        assert (f"{PKG}/service/gpu_sidecar.py", qual) in reached, qual


def test_an_unregistered_clock_read_in_the_sidecar_is_flagged(tmp_path):
    """Non-vacuity of the reach: a clock read in a sidecar method the
    sinks do not name fails the gate."""
    pkg = tmp_path / PKG
    (pkg / "testing").mkdir(parents=True)
    (pkg / "service").mkdir()
    (pkg / "testing" / "chaos.py").write_text(textwrap.dedent("""
        class ChaosHarness:
            def crash(self):
                pass
    """))
    (pkg / "service" / "gpu_sidecar.py").write_text(textwrap.dedent("""
        import time

        class GpuMergeSidecar:
            def ingest(self, doc, msg):
                return time.monotonic()
    """))
    findings = core.run_analysis(roots=[PKG], families=["detcheck"],
                                 repo_root=str(tmp_path))
    assert [f.key for f in findings] == [
        "gpu_sidecar.py:GpuMergeSidecar.ingest:time.monotonic"]


def test_the_registry_set_that_waits_for_the_tools():
    """No registry entry waits for a module of the reference: the tools
    are copied, so the tools' clock sinks resolve like every other
    entry (the test below)."""
    assert determinism.AWAITING_PORT == frozenset()
    assert {("tools/benchmark.py", "*"), ("tools/net_stress.py", "*")} \
        <= set(determinism.WALL_CLOCK_SINKS)


def test_the_layer_map_declares_the_examples(tree):
    """The examples are a subpackage of the port (the reference keeps
    them outside its package): they import the framework, which the
    tools row lacks, and no subpackage imports them."""
    files, _graph = tree
    assert layercheck.ALLOWED["examples"] >= {"framework", "tools",
                                              "loader", "drivers"}
    assert not any("examples" in deps for row, deps
                   in layercheck.ALLOWED.items())
    assert sum("/examples/" in f.relpath for f in files) == 16


def test_every_registry_entry_names_code_of_the_port(tree):
    files, _graph = tree
    unresolved = []

    def need(registry, suffix, qual):
        if (suffix, qual) in determinism.AWAITING_PORT:
            return
        if not _resolves(files, suffix, qual):
            unresolved.append((registry, suffix, qual))

    for suffix, quals in determinism.DETERMINISTIC_ROOTS.items():
        for qual in quals:
            need("DETERMINISTIC_ROOTS", suffix, qual)
    for (suffix, qual), targets in \
            determinism.DETERMINISTIC_INDIRECT.items():
        need("DETERMINISTIC_INDIRECT", suffix, qual)
        for tsuffix, tqual in targets:
            need("DETERMINISTIC_INDIRECT", tsuffix, tqual)
    for suffix, qual in determinism.WALL_CLOCK_SINKS:
        need("WALL_CLOCK_SINKS", suffix, qual)
    for suffix, key in failcheck.SILENT_HANDLERS:
        need("SILENT_HANDLERS", suffix, key.split(":except")[0])
    for suffix, (roots, boundary) in synccheck.DISPATCH_LOOPS.items():
        for name in roots + boundary:
            src = [f for f in files if f.relpath.endswith(suffix)]
            names = {n.name for s in src for n in ast.walk(s.tree)
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))}
            if name not in names:
                unresolved.append(("DISPATCH_LOOPS", suffix, name))
    for suffix in wirecheck.WIRE_MODULES:
        need("WIRE_MODULES", suffix, "*")
    need("SCHEMA_MODULE", wirecheck.SCHEMA_MODULE, "*")
    for suffix, qual in wirecheck.PAYLOAD_CODECS:
        need("PAYLOAD_CODECS", suffix, qual)
    for (suffix, qual), targets in concurrency.INDIRECT_CALLS.items():
        need("INDIRECT_CALLS", suffix, qual)
        for tsuffix, tqual in targets:
            need("INDIRECT_CALLS", tsuffix, tqual)
    assert unresolved == []
    # and the staleness checks the gate runs agree
    assert determinism.stale_wall_clock_sinks(files) == []
    assert failcheck.stale_silent_handlers(files) == []
    assert wirecheck.stale_schema_entries(files) == []


def test_failsan_sites_and_families_are_the_ports(tree):
    """Every ``SITE_SIGNALS`` site is an injection site the port
    registers, every site the port registers has an entry, and every
    family it consults is one the port registers."""
    from fluidframework_tpu_torch.testing import failsan

    files, _graph = tree
    registered = set()
    for src in files:
        for node in ast.walk(src.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "site" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                registered.add(node.args[0].value)
    assert set(failsan.SITE_SIGNALS) == registered
    families = set(obscheck.collect_registrations(files))
    consulted = {f for kinds in failsan.SITE_SIGNALS.values()
                 for fams in kinds.values() for f in fams}
    assert consulted <= families, consulted - families


def test_wiresan_patches_the_ports_seams():
    from fluidframework_tpu_torch.drivers import socket_driver
    from fluidframework_tpu_torch.service import ingress
    from fluidframework_tpu_torch.testing import wiresan

    before = (ingress.pack_frame, socket_driver.pack_frame,
              ingress.AlfredServer._dispatch)
    wiresan.install()
    try:
        patched = (ingress.pack_frame, socket_driver.pack_frame,
                   ingress.AlfredServer._dispatch)
        assert all(getattr(fn, "__wiresan_wrapped__", False)
                   for fn in patched)
    finally:
        wiresan.uninstall()
    assert (ingress.pack_frame, socket_driver.pack_frame,
            ingress.AlfredServer._dispatch) == before


def test_synccheck_joins_the_combined_run(tmp_path):
    """synccheck runs as a family of the combined run, its findings
    keyed line-free, and its own API stays as it was."""
    assert "synccheck" in core.FAMILIES
    assert core.FAMILY_RULES["synccheck"] == ("dispatch-loop-sync",)
    assert "jaxhazards" not in core.FAMILIES
    # the reference's shapecheck is the port's, with the same rule ids
    assert core.FAMILY_RULES["shapecheck"] == (
        "donated-buffer-reuse", "unladdered-jit-shape",
        "kernel-dtype-widen", "shape-mismatch", "prewarm-coverage")
    svc = tmp_path / PKG / "service"
    svc.mkdir(parents=True)
    (svc / "gpu_sidecar.py").write_text(textwrap.dedent("""
        import torch

        class GpuMergeSidecar:
            def apply(self):
                torch.cuda.synchronize()
                return self._settle()

            def _settle(self):
                torch.cuda.synchronize()
    """))
    findings = core.run_analysis(roots=[PKG], families=["synccheck"],
                                 repo_root=str(tmp_path))
    assert [(f.rule, f.key, f.line) for f in findings] == [
        ("dispatch-loop-sync",
         "gpu_sidecar.py:apply:synchronize", 6)]
    direct = synccheck.check_source(
        (svc / "gpu_sidecar.py").read_text(), "x.py", ["apply"],
        ["_settle"])
    assert [(f.rule, f.line) for f in direct] == [("synchronize", 6)]


def test_cli_reports_every_family(tmp_path, monkeypatch, capsys):
    from fluidframework_tpu_torch.analysis import __main__ as cli

    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    monkeypatch.setattr(cli, "REPO_ROOT", str(tmp_path))
    assert cli.main([str(clean)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{fam}: clean" for fam in core.FAMILIES]
