"""Shared interprocedural call graph for the fluidlint pass families.

Every serious bug this repo has shipped (the PR2 ingress event-loop
ack stall, the PR1 broker/moira lock races) crossed a module boundary,
while the original pass families resolved calls module-locally. This
builder is the one place call resolution lives so concheck, detcheck,
wirecheck and failcheck (and future passes) see the same edges.

Resolution, deliberately syntactic (no runtime imports, no type
inference — the linter depends on nothing it lints):

- **bare names** (``helper(x)``) resolve to module-local top-level
  functions, to symbols imported via ``from mod import helper`` when
  the source module is in the scanned tree, and to local/imported
  classes (a class call is an edge to its ``__init__``);
- **self/cls methods** (``self._drain()``) resolve to methods of the
  enclosing class, walking resolvable base classes;
- **module attributes** (``ingress.pack_frame(...)`` after ``from
  ..service import ingress``) resolve when the attribute chain is
  ``<imported module>.<top-level def>``;
- **class attributes** (``Frame.parse(...)`` on an imported or local
  class) resolve to that class's methods.

Anything else (``self.queue.produce(...)``, callbacks stored in
attributes, dynamic dispatch) is *unresolved*: passes that need those
edges declare them explicitly (see ``concurrency.INDIRECT_CALLS``) so
the gap is a reviewed registry entry, not a silent miss.

Dotted module paths map onto scanned files by relpath (``a/b/c.py`` or
``a/b/c/__init__.py``), so the graph works identically over the real
package and over the tmp-dir fixture trees the unit tests build.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Iterable, Optional, Union

from .core import SourceFile

FuncKey = tuple  # (relpath, qualname)


@dataclasses.dataclass
class FunctionInfo:
    """One function/method definition in the scanned tree."""

    key: FuncKey
    node: Union[ast.FunctionDef, ast.AsyncFunctionDef]
    src: SourceFile
    class_name: Optional[str]       # enclosing class, if a method

    @property
    def relpath(self) -> str:
        return self.key[0]

    @property
    def qualname(self) -> str:
        return self.key[1]

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def is_async(self) -> bool:
        return isinstance(self.node, ast.AsyncFunctionDef)


@dataclasses.dataclass
class _Module:
    src: SourceFile
    dotted: str
    # top-level function name -> [FunctionInfo] (redefinitions kept)
    functions: dict
    # class name -> {method name -> [FunctionInfo]}
    classes: dict
    # class name -> [base-name expressions as dotted strings]
    bases: dict
    # import alias -> ("module", relpath) | ("symbol", relpath, name)
    imports: dict
    # alias -> dotted path (for passes matching stdlib prefixes)
    aliases: dict


def _module_dotted(relpath: str) -> Optional[str]:
    if not relpath.endswith(".py"):
        return None
    stem = relpath[:-3]
    if stem.endswith("/__init__"):
        stem = stem[: -len("/__init__")]
    return stem.replace("/", ".")


def _attr_chain(node: ast.AST) -> Optional[list]:
    """['a', 'b', 'c'] for ``a.b.c``; None if the base is not a Name."""
    parts: list = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return list(reversed(parts))


class CallGraph:
    def __init__(self, files: list):
        self._modules: dict[str, _Module] = {}
        self._by_dotted: dict[str, str] = {}
        self._by_node: dict[int, FunctionInfo] = {}
        self._callees: dict[int, list] = {}
        self._all: list[FunctionInfo] = []
        self._build(files)

    # -- construction -------------------------------------------------

    def _build(self, files: list) -> None:
        for src in files:
            if src.tree is None:
                continue
            dotted = _module_dotted(src.relpath)
            if dotted is None:
                continue
            self._by_dotted[dotted] = src.relpath
        for src in files:
            if src.tree is None:
                continue
            dotted = _module_dotted(src.relpath)
            if dotted is None:
                continue
            self._modules[src.relpath] = self._index_module(src, dotted)

    def _index_module(self, src: SourceFile, dotted: str) -> _Module:
        functions: dict = {}
        classes: dict = {}
        bases: dict = {}

        def add(info: FunctionInfo) -> None:
            self._by_node[id(info.node)] = info
            self._all.append(info)

        def index_fn(node, class_name, prefix):
            qual = f"{prefix}{node.name}"
            info = FunctionInfo((src.relpath, qual), node, src,
                                class_name)
            add(info)
            if class_name is None:
                functions.setdefault(node.name, []).append(info)
            else:
                classes.setdefault(class_name, {}).setdefault(
                    node.name, []).append(info)
            # nested defs attribute to the same enclosing scope: a
            # closure runs (at most) when its owner runs, which is the
            # granularity reachability needs
            for sub in ast.walk(node):
                if sub is not node and isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._by_node.setdefault(id(sub), info)

        for stmt in src.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                index_fn(stmt, None, "")
            elif isinstance(stmt, ast.ClassDef):
                bases[stmt.name] = [
                    ".".join(chain) for b in stmt.bases
                    if (chain := _attr_chain(b)) is not None
                ]
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        index_fn(sub, stmt.name, f"{stmt.name}.")

        imports, aliases = self._resolve_imports(src, dotted)
        return _Module(src, dotted, functions, classes, bases,
                       imports, aliases)

    def _resolve_imports(self, src: SourceFile, dotted: str
                         ) -> tuple[dict, dict]:
        """Map local names to scanned modules/symbols. Function-local
        imports count too (lazy imports still create call edges at
        run time)."""
        imports: dict = {}
        aliases: dict = {}
        pkg_parts = dotted.split(".")[:-1]
        if src.relpath.endswith("/__init__.py"):
            pkg_parts = dotted.split(".")
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    bound = a.name if a.asname else a.name.split(".")[0]
                    aliases[local] = bound
                    # `import a.b.c as x` binds the leaf module to x;
                    # bare `import a.b.c` binds `a` — deeper chains
                    # re-resolve through `aliases` + the dotted index
                    # at each call site
                    if bound in self._by_dotted:
                        imports[local] = (
                            "module", self._by_dotted[bound])
            elif isinstance(node, ast.ImportFrom):
                if node.level > 0:
                    up = node.level - 1
                    base = pkg_parts[: len(pkg_parts) - up] if up \
                        else list(pkg_parts)
                    mod_dotted = ".".join(
                        p for p in base + (node.module or "").split(".")
                        if p
                    )
                else:
                    mod_dotted = node.module or ""
                for a in node.names:
                    local = a.asname or a.name
                    aliases[local] = f"{mod_dotted}.{a.name}" \
                        if mod_dotted else a.name
                    sub = f"{mod_dotted}.{a.name}" if mod_dotted \
                        else a.name
                    if sub in self._by_dotted:
                        imports[local] = ("module", self._by_dotted[sub])
                    elif mod_dotted in self._by_dotted:
                        imports[local] = (
                            "symbol", self._by_dotted[mod_dotted],
                            a.name,
                        )
        return imports, aliases

    # -- resolution ---------------------------------------------------

    def _class_methods(self, mod: _Module, class_name: str,
                       method: str, _seen=None) -> list:
        """Methods named ``method`` on ``class_name`` or a resolvable
        base (same module or imported symbol)."""
        _seen = _seen or set()
        if (mod.src.relpath, class_name) in _seen:
            return []
        _seen.add((mod.src.relpath, class_name))
        out = list(mod.classes.get(class_name, {}).get(method, []))
        if out:
            return out
        for base in mod.bases.get(class_name, []):
            head = base.split(".")[0]
            if head in mod.classes or head in mod.bases:
                out.extend(self._class_methods(mod, head, method,
                                               _seen))
            elif head in mod.imports:
                ref = mod.imports[head]
                if ref[0] == "symbol":
                    target = self._modules.get(ref[1])
                    if target is not None:
                        out.extend(self._class_methods(
                            target, ref[2], method, _seen))
        return out

    def _lookup_symbol(self, mod: _Module, name: str,
                       _seen=None) -> list:
        """Module-level function (or class -> __init__) named
        ``name`` in ``mod``. When the module holds no such def but
        RE-EXPORTS the name (``from .merge_kernel import compact`` in
        a package __init__), the chain is chased — the facade import
        (``from ..ops import compact``) used to silently drop the
        edge, which is exactly how the sidecar's kernel entry points
        hid from prewarm-coverage."""
        out = list(mod.functions.get(name, []))
        if name in mod.classes:
            out.extend(mod.classes[name].get("__init__", []))
        if out:
            return out
        _seen = _seen or set()
        if (mod.src.relpath, name) in _seen:
            return []
        _seen.add((mod.src.relpath, name))
        ref = mod.imports.get(name)
        if ref is not None and ref[0] == "symbol":
            target = self._modules.get(ref[1])
            if target is not None:
                return self._lookup_symbol(target, ref[2], _seen)
        return out

    def resolve_call(self, call: ast.Call,
                     caller: Optional[FunctionInfo],
                     src: SourceFile) -> list:
        """FunctionInfo targets of one call site ([] = unresolved)."""
        mod = self._modules.get(src.relpath)
        if mod is None:
            return []
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            out = self._lookup_symbol(mod, name)
            ref = mod.imports.get(name)
            if ref is not None:
                if ref[0] == "symbol":
                    target = self._modules.get(ref[1])
                    if target is not None:
                        out.extend(self._lookup_symbol(target, ref[2]))
                elif ref[0] == "module":
                    pass  # a module is not callable
            return out
        chain = _attr_chain(func)
        if chain is None:
            return []
        head, rest = chain[0], chain[1:]
        if head in ("self", "cls") and caller is not None and \
                caller.class_name is not None and len(rest) == 1:
            return self._class_methods(mod, caller.class_name, rest[0])
        ref = mod.imports.get(head)
        if ref is not None and ref[0] == "module":
            target = self._modules.get(ref[1])
            if target is not None:
                if len(rest) == 1:
                    return self._lookup_symbol(target, rest[0])
                if len(rest) == 2:
                    found = self._class_methods(target, rest[0],
                                                rest[1])
                    if found:
                        return found
            # deeper chains (`pkg.sub.mod.fn()` where `pkg` is itself
            # a scanned package) and submodule attributes fall through
            # to the dotted index below — an early [] here would
            # silently drop real cross-module edges
        elif ref is not None and ref[0] == "symbol" and len(rest) == 1:
            # Imported CLASS attribute: ``Frame.parse(...)``
            target = self._modules.get(ref[1])
            if target is not None:
                return self._class_methods(target, ref[2], rest[0])
            return []
        # local class attribute: ``Frame.parse(...)`` in-module, and
        # `import a.b.c` chains resolved through the dotted index
        if head in mod.classes and len(rest) == 1:
            return self._class_methods(mod, head, rest[0])
        dotted = ".".join([mod.aliases.get(head, head)] + rest[:-1])
        if dotted in self._by_dotted:
            target = self._modules.get(self._by_dotted[dotted])
            if target is not None:
                return self._lookup_symbol(target, rest[-1])
        return []

    # -- graph surface ------------------------------------------------

    def functions(self) -> list:
        """Every indexed FunctionInfo (one per def)."""
        return list(self._all)

    def info_for_node(self, node: ast.AST) -> Optional[FunctionInfo]:
        return self._by_node.get(id(node))

    def callees(self, info: FunctionInfo) -> list:
        """Resolved direct callees of one function (cached)."""
        cached = self._callees.get(id(info.node))
        if cached is not None:
            return list(cached)
        out: list = []
        seen: set = set()
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            for target in self.resolve_call(node, info, info.src):
                if id(target.node) not in seen:
                    seen.add(id(target.node))
                    out.append(target)
        self._callees[id(info.node)] = out
        return list(out)

    def reachable(self, roots: Iterable,
                  prune: Optional[Callable] = None) -> list:
        """FunctionInfos reachable from ``roots`` (roots included)
        through resolved call edges; ``prune(info)`` stops traversal
        THROUGH a function (it is still itself returned)."""
        seen: dict[int, FunctionInfo] = {}
        queue = [r for r in roots]
        while queue:
            info = queue.pop()
            if info is None or id(info.node) in seen:
                continue
            seen[id(info.node)] = info
            if prune is not None and prune(info):
                continue
            queue.extend(self.callees(info))
        return list(seen.values())

    def module_aliases(self, relpath: str) -> dict:
        mod = self._modules.get(relpath)
        return dict(mod.aliases) if mod is not None else {}


def build_callgraph(files: list) -> CallGraph:
    return CallGraph(files)
