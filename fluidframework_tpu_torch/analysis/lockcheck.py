"""lockcheck — lock discipline around cross-thread mutable state.

For every class (or module) that creates a ``threading.Lock`` /
``RLock``, infer which attributes (or globals) are written while the
lock is held, then report writes that bypass it — the exact shape of
the ``debug_driver.break_at`` race the round-5 advisor found: an
attribute read under the state lock but mutated raw from outside.

Inference rules, deliberately conservative:

- Lock regions are ``with self.<lock>:`` blocks (``acquire()`` /
  ``release()`` pairs are not tracked — none exist in this tree; use
  ``with``).
- A private helper method (``_name``) counts as lock-held when EVERY
  in-class call site holds the lock (transitively) — that covers the
  ``_drain_locked`` pattern without annotations. Public methods are
  externally callable and never inherit a caller's lock.
- An attribute's guard is the INTERSECTION of locks held across its
  locked writes; only writes holding none of the guard are reported
  (an attr consistently written under lock A inside a nested lock-B
  region is not a lock-B attr).
- ``__init__`` is construction-time and exempt.

Two rules:

- ``lock-unlocked-write`` — a method of the owning scope writes a
  guarded attribute (or module global) without holding its lock.
- ``lock-external-write`` — code OUTSIDE the owning class assigns,
  through an instance, a public attribute the class only ever writes
  under its lock: external callers cannot hold a private lock
  correctly, so mutation must go through the class's locked setter.
  (Matching is by bare attribute name across the tree; restricting
  the registry to locked-WRITTEN attrs keeps config names like
  ``host``/``timeout`` — merely read under locks — out of it.)
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from .core import Finding, SourceFile

# method calls that mutate their receiver (list/dict/set/deque)
MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popleft",
    "appendleft", "clear", "add", "discard", "update", "setdefault",
    "sort", "reverse",
}

LOCK_FACTORIES = {"threading.Lock", "threading.RLock", "Lock", "RLock"}


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    parts = []
    f = node.func
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts)) in LOCK_FACTORIES


@dataclasses.dataclass
class _Access:
    attr: str
    write: bool
    held: frozenset
    method: str
    line: int


@dataclasses.dataclass
class _CallSite:
    callee: str
    held: frozenset


class _ScopeWalker(ast.NodeVisitor):
    """Walk one function/method body tracking which of the scope's
    locks are held, recording attribute/global accesses and intra-scope
    calls. ``base`` is "self" for methods, None for module functions
    (then plain Names declared ``global`` are the tracked attrs)."""

    def __init__(self, locks: set, method: str, base: Optional[str],
                 tracked_globals: Optional[set] = None):
        self.locks = locks
        self.method = method
        self.base = base
        self.tracked_globals = tracked_globals or set()
        self.declared_global: set = set()
        self.held: frozenset = frozenset()
        self.accesses: list[_Access] = []
        self.calls: list[_CallSite] = []

    # -- helpers -------------------------------------------------------

    def _own_attr(self, node: ast.AST) -> Optional[str]:
        if self.base is not None:
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == self.base:
                return node.attr
            return None
        if isinstance(node, ast.Name) and \
                node.id in self.declared_global and \
                node.id in self.tracked_globals:
            return node.id
        return None

    def _lock_name(self, node: ast.AST) -> Optional[str]:
        """The scope lock a with-item context names, if any. Unlike
        attribute tracking this needs no ``global`` declaration —
        ``with _lock:`` only READS the module global."""
        if self.base is not None:
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == self.base and \
                    node.attr in self.locks:
                return node.attr
            return None
        if isinstance(node, ast.Name) and node.id in self.locks:
            return node.id
        return None

    def _record(self, attr: str, write: bool, line: int) -> None:
        self.accesses.append(_Access(
            attr, write, self.held, self.method, line,
        ))

    def _record_target(self, target: ast.AST, line: int) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_target(elt, line)
            return
        attr = self._own_attr(target)
        if attr is not None:
            self._record(attr, True, line)
            return
        if isinstance(target, ast.Subscript):
            # self.attr[k] = v / self.attr[:0] = ... mutate the attr
            attr = self._own_attr(target.value)
            if attr is not None:
                self._record(attr, True, line)
        if isinstance(target, ast.Starred):
            self._record_target(target.value, line)

    # -- visitors ------------------------------------------------------

    def visit_Global(self, node: ast.Global) -> None:
        self.declared_global.update(node.names)

    def visit_With(self, node: ast.With) -> None:
        acquired = set()
        for item in node.items:
            name = self._lock_name(item.context_expr)
            if name is not None:
                acquired.add(name)
        prev = self.held
        self.held = self.held | frozenset(acquired)
        for stmt in node.body:
            self.visit(stmt)
        self.held = prev

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._record_target(target, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target, node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target, node.lineno)
            self.visit(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        # self.attr.append(...) — receiver mutation counts as a write
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATORS:
            attr = self._own_attr(f.value)
            if attr is not None:
                self._record(attr, True, node.lineno)
        # self.method(...) / local function call
        if self.base is not None:
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and \
                    f.value.id == self.base:
                self.calls.append(_CallSite(f.attr, self.held))
        elif isinstance(f, ast.Name):
            self.calls.append(_CallSite(f.id, self.held))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self._own_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._record(attr, False, node.lineno)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if self.base is None and isinstance(node.ctx, ast.Load):
            attr = self._own_attr(node)
            if attr is not None:
                self._record(attr, False, node.lineno)

    def visit_FunctionDef(self, node):  # nested defs: same scope rules
        for stmt in node.body:
            self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.visit(node.body)


@dataclasses.dataclass
class _Scope:
    """One lock-owning scope (a class, or the module itself)."""

    name: str            # class name, or "<module>"
    locks: set
    accesses: list[_Access]
    callsites: dict      # method -> list[_CallSite]
    methods: set


def _propagate(scope: _Scope) -> dict[str, frozenset]:
    """locks guaranteed held on entry to each PRIVATE helper (every
    in-scope call site holds them, transitively). Greatest fixpoint."""
    private = {
        m for m in scope.methods
        if m.startswith("_") and not m.startswith("__")
    }
    inherited = {m: frozenset(scope.locks) for m in private}
    sites: dict[str, list[tuple[str, frozenset]]] = {m: [] for m in private}
    for caller, calls in scope.callsites.items():
        for c in calls:
            if c.callee in private:
                sites[c.callee].append((caller, c.held))
    changed = True
    while changed:
        changed = False
        for m in private:
            if not sites[m]:
                new = frozenset()
            else:
                new = frozenset(scope.locks)
                for caller, held in sites[m]:
                    new &= held | inherited.get(caller, frozenset())
            if new != inherited[m]:
                inherited[m] = new
                changed = True
    return inherited


def _analyze_scope(scope: _Scope, relpath: str,
                   ) -> tuple[list[Finding], dict[str, str]]:
    """Findings for one scope, plus the scope's PUBLIC guarded attrs
    (attr -> owning scope name) for the external-write rule."""
    inherited = _propagate(scope)

    def effective(acc: _Access) -> frozenset:
        return acc.held | inherited.get(acc.method, frozenset())

    events = [a for a in scope.accesses if a.method != "__init__"]
    writes: dict[str, list[_Access]] = {}
    for a in events:
        if a.write:
            writes.setdefault(a.attr, []).append(a)

    findings = []
    # module-scope keys carry the module filename: "<module>.attr"
    # alone would collide across files (one allowlist entry silently
    # grandfathering every module's same-named global). Class keys
    # stay bare — class names are already tree-unique identities.
    module = relpath.rsplit("/", 1)[-1]
    key_scope = f"{module}:{scope.name}" \
        if scope.name == "<module>" else scope.name
    for attr, evs in sorted(writes.items()):
        locked = [e for e in evs if effective(e)]
        if not locked:
            continue
        guard = frozenset(scope.locks)
        for e in locked:
            guard &= effective(e)
        if not guard:
            continue  # inconsistent guards; no single lock to enforce
        lock_desc = "/".join(sorted(guard))
        for e in evs:
            if effective(e) & guard:
                continue
            findings.append(Finding(
                rule="lock-unlocked-write",
                path=relpath, line=e.line,
                message=(
                    f"{scope.name}.{e.method}() writes {attr!r} "
                    f"without {lock_desc!r} (other writes hold it); "
                    "a concurrent locked reader can observe a torn "
                    "update"
                ),
                key=f"{key_scope}.{attr}",
            ))
    # public attrs the class WRITES under its lock: the class chose to
    # serialize mutation, so a raw external write bypasses an existing
    # discipline. Attrs merely READ under the lock (host/port/timeout
    # config) are deliberately excluded — name-based cross-file
    # matching would flag every unrelated object sharing the name.
    public_guarded = {
        attr: scope.name
        for attr, evs in writes.items()
        if not attr.startswith("_") and scope.name != "<module>"
        and any(effective(e) for e in evs)
    }
    return findings, public_guarded


def _collect_scopes(src: SourceFile) -> list[_Scope]:
    scopes = []
    tree = src.tree

    def _assign_targets(stmt):
        """Targets of a lock-creating statement — plain and annotated
        (``_lock: threading.Lock = threading.Lock()``) assignments."""
        if isinstance(stmt, ast.Assign) and _is_lock_ctor(stmt.value):
            return stmt.targets
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and _is_lock_ctor(stmt.value):
            return [stmt.target]
        return []

    # module-level locks guard module globals
    mod_locks = set()
    for stmt in tree.body:
        for t in _assign_targets(stmt):
            if isinstance(t, ast.Name):
                mod_locks.add(t.id)
    if mod_locks:
        tracked = set()
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign):
                tracked.update(
                    t.id for t in stmt.targets
                    if isinstance(t, ast.Name)
                )
            elif isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                tracked.add(stmt.target.id)
        accesses, callsites, methods = [], {}, set()
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                w = _ScopeWalker(mod_locks, stmt.name, None, tracked)
                for s in stmt.body:
                    w.visit(s)
                accesses.extend(w.accesses)
                callsites[stmt.name] = w.calls
                methods.add(stmt.name)
        scopes.append(_Scope("<module>", mod_locks, accesses,
                             callsites, methods))

    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        locks = set()
        for sub in ast.walk(node):
            for t in _assign_targets(sub):
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self":
                    locks.add(t.attr)
        if not locks:
            continue
        accesses, callsites, methods = [], {}, set()
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                w = _ScopeWalker(locks, stmt.name, "self")
                for s in stmt.body:
                    w.visit(s)
                accesses.extend(w.accesses)
                callsites[stmt.name] = w.calls
                methods.add(stmt.name)
        scopes.append(_Scope(node.name, locks, accesses, callsites,
                             methods))
    return scopes


class _ExternalWriteFinder(ast.NodeVisitor):
    """Assignments ``<expr>.attr = ...`` through a non-self base, for
    attrs registered as public lock-guarded somewhere in the tree."""

    def __init__(self, registry: dict[str, set], relpath: str):
        self.registry = registry
        self.relpath = relpath
        self.findings: list[Finding] = []

    def _check_target(self, target: ast.AST, line: int) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_target(elt, line)
            return
        if not isinstance(target, ast.Attribute):
            return
        base = target.value
        if isinstance(base, ast.Name) and base.id in ("self", "cls"):
            return
        owners = self.registry.get(target.attr)
        if not owners:
            return
        owner = "/".join(sorted(owners))
        self.findings.append(Finding(
            rule="lock-external-write",
            path=self.relpath, line=line,
            message=(
                f"raw write to {target.attr!r}, which "
                f"{owner} writes only under a lock: external callers "
                "cannot hold a private lock — use/add a locked "
                "setter on the owning class"
            ),
            key=f"{owner}.{target.attr}",
        ))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_target(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target, node.lineno)
        self.generic_visit(node)


def check(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    # public guarded attr -> owning class(es); matching is by bare
    # attribute name (no cross-file type inference), so colliding
    # owners are all reported rather than last-writer-wins
    registry: dict[str, set] = {}
    for src in files:
        if src.tree is None:
            continue
        for scope in _collect_scopes(src):
            scope_findings, public_guarded = _analyze_scope(
                scope, src.relpath
            )
            findings.extend(scope_findings)
            for attr, owner in public_guarded.items():
                registry.setdefault(attr, set()).add(owner)
    if registry:
        for src in files:
            if src.tree is None:
                continue
            finder = _ExternalWriteFinder(registry, src.relpath)
            finder.visit(src.tree)
            # writes inside the owning class's own file through a
            # non-self alias are rare and legitimate there; still
            # report — the allowlist can grandfather if needed
            findings.extend(finder.findings)
    return findings
