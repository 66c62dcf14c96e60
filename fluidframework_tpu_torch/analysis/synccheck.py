"""synccheck — the port's host-sync lint over its dispatch loops.

The counterpart of the reference's ``jaxhazards:dispatch-loop-sync``
rule. The sidecars' apply loops are host/device pipelines: the host
packs round N+1 while the device computes round N, and the ONLY
sanctioned device->host sync is ``_settle`` (the one read of the
in-flight round's overflow flags, where recovery runs) and ``sync``,
the barrier that calls it. Any other read of a device tensor reachable
from the loop re-serializes packing against device compute and silently
un-pipelines serving.

An AST pass over the port's sources. ``DISPATCH_LOOPS`` names, per
module, the loop's root functions and its sync boundaries; from the
roots it follows module-local calls (bare names, ``self.<method>``,
and a class's ``__init__`` when the class is called), pruning at a
boundary, and flags in every function it reaches:

- ``item``: ``.item()`` on a tensor, and ``int()`` / ``float()`` of one;
- ``cpu``: ``.cpu()``;
- ``tolist``: ``.tolist()`` on a tensor;
- ``numpy``: ``.numpy()``;
- ``truthiness``: a tensor as a condition (``if t``, ``while t``,
  ``bool(t)``, ``not t``, ``and`` / ``or``, a conditional expression);
- ``synchronize``: ``torch.cuda.synchronize`` and any
  ``.synchronize()``;
- ``to-cpu``: ``.to("cpu")`` (or to a CPU device) without
  ``non_blocking=True``;
- ``nonzero``: ``torch.nonzero`` / ``.nonzero()``, whose output shape
  waits for the device.

Whether an expression is a tensor is inferred locally: a call of
``torch.*`` (but ``torch.device`` and friends), a parameter annotated
with a tensor or table type, ``self._table`` and the sidecars' other
table attributes, a name assigned one of those, and attributes,
subscripts, method calls and arithmetic on a tensor (but the host
attributes ``shape``, ``docs``, ``capacity``...). ``.cpu()``,
``.numpy()`` and ``.synchronize()`` are flagged on any receiver.

A finding is suppressed only by a comment on its line,
``# synccheck: disable=<rule>[,<rule>] <reason>``; a disable without a
reason is itself a finding (``disable-without-reason``).

Run it with ``python -m fluidframework_tpu_torch.analysis``.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Optional

PACKAGE = Path(__file__).resolve().parent.parent

# module (path under the package) -> (loop root functions, sync
# boundaries). The sidecars' loops end at ``_settle`` / ``sync``; the
# window kernel's launch at its one wait for the window before it; the
# route and pool modules' dispatch halves, the upload and the obs / qos
# entry points the loop calls must be sync-free all through.
DISPATCH_LOOPS = {
    "service/gpu_sidecar.py": (
        ("apply", "ingest", "_dispatch", "_compile_program", "_to_device",
         "_apply_program", "_fodder"),
        ("_settle", "sync"),
    ),
    "service/tree_sidecar.py": (
        ("apply", "ingest", "_ingest_commit", "_dispatch",
         "_apply_dispatch"),
        ("_settle", "sync"),
    ),
    # the doc-sharded pool's device halves (its dispatch runs inside the
    # sidecar's _settle, which reads the pool's overflow flags)
    "parallel/mesh_pool.py": (
        ("apply_window_mesh_sharded", "_apply", "_compact",
         "_maybe_migrate", "_move"),
        (),
    ),
    # the macro-step routes: the host compile runs in the pipeline's pack
    # stage, the device halves in its device stage
    "ops/merge_chunk.py": (
        ("compile_chunks", "apply_window_chunked",
         "apply_window_chunked_pingpong", "run_macro_steps"),
        (),
    ),
    "ops/event_graph.py": (
        ("build_event_graph", "apply_window_egwalker",
         "apply_window_egwalker_pingpong"),
        (),
    ),
    # the op programs' upload, which every loop above reaches: sync-free
    # all through (pinned staging, copies on a copy stream)
    "convert.py": (("program_to_device", "_staged", "_copy_stream"), ()),
    # the window kernel's launch, which every loop above reaches: its
    # one host wait, for the window launched before it on the stream
    # (at most one window queued behind the running one), is the
    # boundary; the checks and the launch before it must be sync-free
    "ops/cuda_merge.py": (
        ("apply_window_cuda", "launch", "_queue"),
        ("_wait_for_window",),
    ),
    # the obs and qos entry points the loop calls into: host timestamps
    # and already-host scalars only
    "obs/flight_recorder.py": (("record", "dump", "dump_to", "events"), ()),
    "obs/metrics.py": (("inc", "dec", "set", "observe", "labels"), ()),
    "obs/trace.py": (("stamp",), ()),
    "obs/heat.py": (
        ("ewma_tick", "charge", "get", "pop", "attribute_round"), ()),
    "obs/profiler.py": (("device_trace", "span", "record"), ()),
    "qos/faults.py": (("fire", "transient"), ()),
    "qos/breaker.py": (("allow", "record_success", "record_failure"), ()),
}

RULES = ("item", "cpu", "tolist", "numpy", "truthiness", "synchronize",
         "to-cpu", "nonzero")

# annotations whose parameters hold tensors (a table's fields do)
TENSOR_TYPES = {"Tensor", "SegmentTable", "OpBatch", "ShardedTable",
                "TreeTable", "TreeProgram", "TreeAtoms"}
# self attributes that hold device tables
TENSOR_ATTRS = {"_table", "_prev_table", "_dead"}
# attributes of a tensor or table that are host values
HOST_ATTRS = {"shape", "dtype", "device", "docs", "capacity", "slots",
              "window", "ndim", "is_cuda", "rows_per_shard", "shards",
              "_fields"}
# tensor methods whose result is a host value
HOST_METHODS = {"item", "tolist", "numpy", "size", "dim", "numel",
                "data_ptr", "untyped_storage", "element_size", "stride",
                "is_contiguous", "_asdict", "_replace"}
# torch calls that return no tensor
TORCH_HOST = ("torch.device", "torch.Size", "torch.cuda.", "torch.dtype",
              "torch.profiler.", "torch.is_tensor", "torch.get_",
              "torch.set_", "torch.is_")

_DISABLE = re.compile(r"#\s*synccheck:\s*disable=([\w,-]+)(.*)$")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    function: str
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] in "
                f"{self.function}(): {self.message}")


def _dotted(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _annotation_is_tensor(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    names = {n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(ann) if isinstance(n, ast.Attribute)}
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        names |= set(re.findall(r"\w+", ann.value))
    return bool(names & TENSOR_TYPES)


def _target_names(targets) -> list[str]:
    """The plain names an assignment binds (not attributes or items)."""
    out = []
    for t in targets:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out.extend(_target_names(t.elts))
        elif isinstance(t, ast.Starred):
            out.extend(_target_names([t.value]))
    return out


class _Tensors:
    """The local tensor inference of one function."""

    def __init__(self, fn: ast.FunctionDef):
        args = fn.args
        self.names = {
            a.arg for a in (*args.posonlyargs, *args.args,
                            *args.kwonlyargs)
            if _annotation_is_tensor(a.annotation)}
        # flow-insensitive: iterate assignments to a fixed point
        assigns = [n for n in ast.walk(fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign))]
        changed = True
        while changed:
            changed = False
            for node in assigns:
                value = node.value
                if value is None or not self.is_tensor(value):
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for name in _target_names(targets):
                    if name not in self.names:
                        self.names.add(name)
                        changed = True

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in HOST_ATTRS:
                return False
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr in TENSOR_ATTRS
            return self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted is not None and dotted.startswith("torch."):
                return not dotted.startswith(TORCH_HOST)
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in HOST_METHODS:
                    return False
                return self.is_tensor(node.func.value)
            return False
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.is_tensor(node.left) or any(
                self.is_tensor(c) for c in node.comparators)
        return False


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(
    torch.device("cpu"))`` without ``non_blocking=True``."""
    for kw in call.keywords:
        if kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return False
    targets = list(call.args[:1]) + [kw.value for kw in call.keywords
                                     if kw.arg == "device"]
    for t in targets:
        if isinstance(t, ast.Constant) and isinstance(t.value, str) and \
                t.value.split(":")[0] == "cpu":
            return True
        if isinstance(t, ast.Call) and _dotted(t.func) == "torch.device" \
                and t.args and isinstance(t.args[0], ast.Constant) and \
                t.args[0].value == "cpu":
            return True
    return False


def _function_findings(fn: ast.FunctionDef, path: str) -> list[Finding]:
    tensors = _Tensors(fn)
    out = []

    def flag(rule: str, node: ast.AST, what: str) -> None:
        out.append(Finding(rule, path, node.lineno, fn.name,
                           f"{what}: a device->host sync inside the "
                           "dispatch loop outside its sync boundary — "
                           "move the read into _settle"))

    def condition(node: ast.AST) -> None:
        if tensors.is_tensor(node):
            flag("truthiness", node, "a tensor used as a condition")

    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            condition(node.test)
        elif isinstance(node, ast.BoolOp):
            for value in node.values:
                condition(value)
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            condition(node.operand)
        elif isinstance(node, ast.comprehension):
            for cond in node.ifs:
                condition(cond)
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted in ("bool",) and node.args:
            condition(node.args[0])
        elif dotted in ("int", "float") and node.args and \
                tensors.is_tensor(node.args[0]):
            flag("item", node, f"{dotted}() of a tensor")
        elif dotted in ("torch.cuda.synchronize", "torch.nonzero"):
            rule = dotted.rsplit(".", 1)[-1]
            flag(rule, node, f"{dotted}()")
        if not isinstance(node.func, ast.Attribute):
            continue
        attr, recv = node.func.attr, node.func.value
        if attr in ("cpu", "numpy", "synchronize"):
            flag(attr, node, f".{attr}()")
        elif attr in ("item", "tolist", "nonzero") and \
                tensors.is_tensor(recv):
            flag(attr, node, f".{attr}() on a tensor")
        elif attr == "to" and _to_cpu(node):
            flag("to-cpu", node, ".to() a CPU device without "
                 "non_blocking=True")
    return out


def _reachable(tree: ast.Module, roots: Iterable[str],
               boundary: Iterable[str]) -> list[ast.FunctionDef]:
    by_name: dict[str, list[ast.FunctionDef]] = {}
    classes: dict[str, ast.ClassDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)
        elif isinstance(node, ast.ClassDef):
            classes[node.name] = node
    boundary = set(boundary)
    seen: dict[int, ast.FunctionDef] = {}
    queue = [fn for name in roots for fn in by_name.get(name, [])]
    while queue:
        fn = queue.pop()
        if id(fn) in seen:
            continue
        seen[id(fn)] = fn
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = None
            if isinstance(node.func, ast.Name):
                callee = node.func.id
            elif isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self":
                callee = node.func.attr
            if callee is None or callee in boundary:
                continue
            if callee in classes:
                queue.extend(
                    n for n in classes[callee].body
                    if isinstance(n, ast.FunctionDef)
                    and n.name == "__init__")
            else:
                queue.extend(by_name.get(callee, []))
    return list(seen.values())


def check_source(source: str, path: str, roots: Iterable[str],
                 boundary: Iterable[str] = ()) -> list[Finding]:
    """Findings of one module's source with these loop roots and sync
    boundaries, suppressions applied."""
    return _check_tree(ast.parse(source, filename=path),
                       source.splitlines(), path, roots, boundary)


def _check_tree(tree: ast.Module, lines: list, path: str,
                roots: Iterable[str], boundary: Iterable[str]
                ) -> list[Finding]:
    findings = []
    for fn in _reachable(tree, roots, boundary):
        findings.extend(_function_findings(fn, path))
    kept, seen = [], set()
    for f in sorted(findings, key=lambda f: (f.line, f.rule)):
        if (f.line, f.rule) in seen:
            continue
        seen.add((f.line, f.rule))
        m = _DISABLE.search(lines[f.line - 1])
        if m is None or f.rule not in m.group(1).split(","):
            kept.append(f)
        elif not m.group(2).strip():
            kept.append(dataclasses.replace(
                f, rule="disable-without-reason",
                message=f"synccheck: disable={f.rule} needs a reason"))
    return kept


def check_package(package: Path = PACKAGE,
                  loops: dict = DISPATCH_LOOPS) -> list[Finding]:
    """Every finding of the port's registered dispatch loops."""
    findings = []
    for rel, (roots, boundary) in sorted(loops.items()):
        path = package / rel
        findings.extend(check_source(
            path.read_text(), f"{package.name}/{rel}", roots, boundary))
    return findings


def check(files, loops: dict = DISPATCH_LOOPS) -> list:
    """The fluidlint family ``synccheck`` (rule ``dispatch-loop-sync``):
    this module's findings over the registered loops among a combined
    run's parsed files (``core.SourceFile``), as ``core.Finding``. The
    key is line-free: ``<module>:<function>:<synccheck rule>``."""
    from .core import Finding as LintFinding

    out = []
    for src in files:
        if src.tree is None:
            continue
        cfg = next((v for rel, v in loops.items()
                    if src.relpath.endswith(rel)), None)
        if cfg is None:
            continue
        roots, boundary = cfg
        module = src.relpath.rsplit("/", 1)[-1]
        for f in _check_tree(src.tree, src.source.splitlines(),
                             src.relpath, roots, boundary):
            out.append(LintFinding(
                rule="dispatch-loop-sync", path=f.path, line=f.line,
                message=f"[{f.rule}] in {f.function}(): {f.message}",
                key=f"{module}:{f.function}:{f.rule}"))
    return out
