"""layercheck — machine-enforced package layering.

The reference monorepo's layer-check build step pins which release
group may depend on which (Loader < Runtime < Framework < ...); this
is the same gate for the reproduction's subpackages. The declared
order, bottom to top:

    utils < protocol < {models, runtime, ops} < native < drivers
          < loader < {framework, parallel} < service-facing tools

with two sanctioned mutual pairs mirroring the reference's release
groups (local-driver <-> local-server): drivers <-> service and
native <-> service. The port adds one module the JAX package has no
counterpart for, the top-level ``convert`` (numpy <-> device moves of
``ops``'s own table and batch types; JAX arrays convert through numpy,
so the reference needs no such module), and a third sanctioned pair,
convert <-> ops. ``ALLOWED`` below is the single source of truth —
tests/test_layer_check.py asserts against this exact map, so the
tier-1 suite and the linter cannot drift apart.

Only MODULE-LEVEL imports create edges: TYPE_CHECKING blocks and
function-local imports cannot create import cycles and are the
sanctioned escape hatch for the remaining upward references.
"""
from __future__ import annotations

import ast
import os

from .core import Finding, SourceFile

PACKAGE = "fluidframework_tpu_torch"

# subpackage -> subpackages it may import at module level
ALLOWED = {
    "analysis": set(),  # the linter depends on nothing it lints
    # the git-ignored output directory of the port's native and CUDA
    # builds (shared libraries, no python): a directory of the package
    # all the same, so it is declared, with no dependencies
    "_build": set(),
    "utils": set(),
    "protocol": {"utils"},
    # obs sits just above protocol: every layer may observe (trace
    # stamps, metrics, flight recorders), and obs itself depends only
    # on the wire Trace type + utils — never on what it observes
    "obs": {"protocol", "utils"},
    # qos sits beside obs: admission control / backpressure / circuit
    # breaking used BY the service plane (and the tools that drive
    # overload), depending only on obs metrics + protocol vocabulary
    # — never on what it protects
    "qos": {"obs", "protocol", "utils"},
    "models": {"protocol", "utils", "runtime"},  # runtime: the
    # SharedObject contract lives in runtime/shared_object (layer 6
    # sits on the datastore runtime, sharedObject.ts:42)
    # convert: the numpy <-> device boundary of ops's own types
    "ops": {"convert", "models", "protocol", "utils"},
    "runtime": {"obs", "protocol", "utils"},
    # drivers bind to the in-proc/networked service (local-driver ->
    # local-server in the reference); qos: the transport seams
    # register chaos injection sites (qos/faults.py) and honor the
    # throttle/backoff vocabulary
    "drivers": {"obs", "protocol", "qos", "service", "utils"},
    "loader": {"drivers", "models", "obs", "protocol", "runtime",
               "utils"},
    "framework": {"drivers", "loader", "models", "runtime",
                  "service", "utils"},
    "service": {"convert", "models", "native", "obs", "ops", "protocol",
                "qos", "utils"},
    "native": {"ops", "protocol", "service", "utils"},
    # obs: the mesh-sharded pool registers its own metric families
    # (mesh_pool_*) — observation only, obs never imports parallel;
    # qos: the pool's dispatch/migration seams register chaos
    # injection sites (qos/faults.py) — injection only, qos never
    # imports parallel
    "parallel": {"convert", "obs", "ops", "qos", "utils"},
    # the port's top-level numpy <-> device module: it builds ops's
    # SegmentTable / OpBatch from host arrays and back, so it and ops
    # import each other (the sanctioned pair below)
    "convert": {"ops"},
    # drivers/loader: the chaos harness (testing/chaos.py) drives real
    # Containers over the real ingress dispatch path — the client
    # stack is what it exercises
    "testing": {"drivers", "loader", "models", "obs", "ops",
                "protocol", "qos", "runtime", "service", "utils"},
    "tools": {"drivers", "loader", "models", "obs", "ops", "protocol",
              "qos", "runtime", "service", "testing", "utils"},
    # the runnable demos (the reference keeps them outside its package):
    # they sit on top, driving the framework, the client stack and the
    # tools; nothing imports them
    "examples": {"drivers", "framework", "loader", "models", "obs",
                 "service", "testing", "tools"},
}

# the sanctioned mutual pairs; excluded from the acyclicity check
SANCTIONED_CYCLES = {("drivers", "service"), ("native", "service"),
                     ("convert", "ops")}


def module_level_imports(tree: ast.AST) -> list[ast.stmt]:
    """Import statements that bind at module import time — skipping
    TYPE_CHECKING blocks and anything nested inside functions."""
    out: list[ast.stmt] = []

    def visit_body(body):
        for stmt in body:
            if isinstance(stmt, ast.If):
                if "TYPE_CHECKING" in ast.unparse(stmt.test):
                    continue
                visit_body(stmt.body)
                visit_body(stmt.orelse)
            elif isinstance(stmt, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            elif isinstance(stmt, ast.ClassDef):
                visit_body(stmt.body)
            elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
                out.append(stmt)
            elif isinstance(stmt, ast.Try):
                visit_body(stmt.body)
                visit_body(stmt.orelse)
                for h in stmt.handlers:
                    visit_body(h.body)
                visit_body(stmt.finalbody)

    visit_body(tree.body)
    return out


def _resolve_targets(stmt: ast.stmt, pkg_parts: list[str]
                     ) -> list[str]:
    """Resolve an import statement in module ``PACKAGE/<pkg_parts>``
    to the top-level subpackages it references (absolute AND relative
    forms)."""
    targets = []

    def from_root(names):
        # `from fluidframework_tpu import service` / `from .. import
        # service` name subpackages directly — the same edge as the
        # dotted form and NOT exempt. Names that are not subpackages
        # are root-facade symbol re-exports (`from .. import fetch`),
        # which stay "<root>".
        for alias in names:
            targets.append(
                alias.name if alias.name in ALLOWED else "<root>"
            )

    if isinstance(stmt, ast.Import):
        for alias in stmt.names:
            parts = alias.name.split(".")
            if parts[0] == PACKAGE:
                targets.append(parts[1] if len(parts) > 1 else "<root>")
    elif isinstance(stmt, ast.ImportFrom):
        if stmt.level > 0:
            # from ..x import y inside PACKAGE/a/b.py: strip
            # (level-1) trailing dirs from the containing package path
            up = stmt.level - 1
            base = pkg_parts[: len(pkg_parts) - up] if up else \
                list(pkg_parts)
            mod = (stmt.module or "").split(".")
            full = [p for p in base + mod if p]
            if full:
                targets.append(full[0])
            else:
                from_root(stmt.names)
        elif stmt.module and stmt.module.split(".")[0] == PACKAGE:
            parts = stmt.module.split(".")
            if len(parts) > 1:
                targets.append(parts[1])
            else:
                from_root(stmt.names)
    return targets


def edges(files: list[SourceFile]
          ) -> list[tuple[str, str, str, int]]:
    """(from_pkg, to_pkg, relpath, line) for every cross-subpackage
    module-level import edge inside the package."""
    out = []
    prefix = PACKAGE + "/"
    for src in files:
        if src.tree is None or not src.relpath.startswith(prefix):
            continue
        inner = src.relpath[len(prefix):]
        dir_parts = inner.split("/")[:-1]
        pkg = dir_parts[0] if dir_parts else "<root>"
        for stmt in module_level_imports(src.tree):
            for target in _resolve_targets(stmt, dir_parts):
                if target != pkg:
                    out.append((pkg, target, src.relpath, stmt.lineno))
    return out


def declared_cycle() -> list[str]:
    """Cycles in the DECLARED map beyond the sanctioned pairs (guards
    the map itself — an edit must not legalize a dependency loop)."""
    graph = {k: set(v) for k, v in ALLOWED.items()}
    for a, b in SANCTIONED_CYCLES:
        graph[a].discard(b)
    bad: list[str] = []
    seen: set[str] = set()
    stack: set[str] = set()

    def dfs(n):
        if n in stack:
            bad.append(n)
            return
        if n in seen:
            return
        stack.add(n)
        for m in graph.get(n, ()):
            dfs(m)
        stack.remove(n)
        seen.add(n)

    for pkg in graph:
        dfs(pkg)
    return bad


def check(files: list[SourceFile]) -> list[Finding]:
    findings = []
    for pkg, target, relpath, line in edges(files):
        if pkg == "<root>" or target == "<root>":
            continue  # package facade re-exports
        if target not in ALLOWED.get(pkg, set()):
            findings.append(Finding(
                rule="layer-undeclared",
                path=relpath, line=line,
                message=(
                    f"undeclared layer dependency {pkg} -> {target} "
                    f"(declared: {sorted(ALLOWED.get(pkg, set()))}); "
                    "redesign, use a function-local import, or "
                    "declare the edge in analysis/layercheck.py with "
                    "justification"
                ),
                key=f"{pkg}->{target}",
            ))
    for pkg in declared_cycle():
        findings.append(Finding(
            rule="layer-cycle", path=f"{PACKAGE}/analysis/layercheck.py",
            line=1,
            message=f"declared layer map has a cycle through {pkg!r}",
            key=f"cycle:{pkg}",
        ))
    return findings
