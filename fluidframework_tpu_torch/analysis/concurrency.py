"""concheck — interprocedural concurrency analysis.

Every serious shipped bug so far (the PR2 ingress event-loop ack
stall, the PR1 broker/moira lock races) was a cross-module concurrency
bug invisible to single-module AST scans. This family walks the shared
call graph (analysis/callgraph.py) and enforces the three obligations
a mixed asyncio+threads service plane carries:

- **``lock-order-cycle``** — a repo-wide lock-acquisition-order graph:
  acquiring lock B while holding lock A (directly nested ``with``, or
  through any resolvable call chain) adds edge A->B; a cycle means two
  threads can each hold one lock of the pair while waiting on the
  other — a potential deadlock. Lock identity is (module, scope,
  attribute), the same class-level granularity the runtime sanitizer
  (testing/sanitizer.py) aggregates to, so the two halves compare.
- **``async-blocking-call``** — a blocking primitive (socket
  recv/sendall/accept, ``time.sleep``, file I/O, a blocking
  ``queue.Queue`` get/put, an ``Event.wait``, or acquiring a SLOW lock
  — one held across blocking I/O somewhere in the program) reachable
  from an ``async def`` in a drivers/service/qos path without an
  executor hop. Blocking the event loop stalls every connection the
  loop serves, not just the caller. ``run_in_executor`` /
  ``asyncio.to_thread`` naturally break reachability: the offloaded
  function is passed as an argument, never called from the coroutine.
- **``await-holding-lock``** — an ``await`` inside a ``with <threading
  lock>:`` body parks the coroutine at the await while the OS lock
  stays held; any thread (or any other coroutine on an executor
  thread) that wants the lock now waits on scheduler whim. Threading
  locks must never span a suspension point.

Known false-positive shapes (docs/ANALYSIS.md has the guidance):
fast locks (never held across blocking work) are deliberately NOT
blocking primitives, so ``metrics.Counter.inc`` style short critical
sections stay clean; receiver-typed checks (queue/event/socket
attributes) only fire when the attribute's constructor is visible to
the scope, so duck-typed injected dependencies are unresolved rather
than misflagged.

Call edges the graph cannot resolve syntactically (callbacks stored in
attributes) are declared in ``INDIRECT_CALLS`` below — a reviewed
registry, not a silent miss. The runtime sanitizer's differential test
(tests/test_sanitizer.py) enforces exactly this: every lock-order edge
observed at run time must be a subset of this pass's static edges, so
a missing resolution surfaces as a named analyzer-resolution gap.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from .callgraph import CallGraph, FunctionInfo, build_callgraph
from .core import Finding, SourceFile, dotted_path as _dotted

LOCK_FACTORIES = {"threading.Lock", "threading.RLock"}

# receiver-typed blocking surfaces: constructor dotted path -> kind
TYPED_CTORS = {
    "queue.Queue": "queue",
    "queue.LifoQueue": "queue",
    "queue.PriorityQueue": "queue",
    "queue.SimpleQueue": "queue",
    "threading.Event": "event",
    "threading.Condition": "event",
    "socket.socket": "socket",
    "socket.create_connection": "socket",
}
TYPED_BLOCKING_METHODS = {
    "queue": {"get", "put", "join"},
    "event": {"wait", "wait_for"},
    "socket": {"connect", "makefile"},
}

# unconditionally blocking calls by dotted path (prefix match when the
# entry ends with a dot, exact-or-attr match otherwise)
BLOCKING_CALLS = (
    "time.sleep",
    "open",
    "io.open",
    "socket.create_connection",
    "socket.getaddrinfo",
    "os.replace",
    "os.makedirs",
    "os.listdir",
    "os.remove",
    "os.fsync",
    "os.rename",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "shutil.",
)

# attribute-call names distinctive enough to flag on ANY receiver
# (in this tree they only ever appear on sockets)
BLOCKING_METHODS_ALWAYS = {"recv", "recv_into", "recvfrom", "sendall",
                           "accept"}

# path components whose async defs are event-loop roots for the
# async-blocking-call rule (the serving planes; matches qoscheck's
# path-component scoping so tmp-dir fixtures exercise the rule)
ASYNC_SCOPE_COMPONENTS = {"drivers", "service", "qos"}

# Call edges real control flow takes but syntax cannot resolve: the
# (module-suffix, qualname) on the left stores a callable in an
# attribute (or receives one) and invokes it; the right lists where
# that control flow can land. Reviewed registry — the sanitizer
# differential test fails on any runtime lock-order edge these plus
# the resolvable edges do not cover.
INDIRECT_CALLS = {
    # The socket driver's dispatch thread delivers broadcasts while
    # holding ``self.lock``; the container's inbound path may issue
    # blocking requests from inside the callback (gap refetch calls
    # read_ops — deltaManager.ts:883), which re-enters _request/_send
    # and takes _pending_lock/_send_lock under self.lock.
    ("drivers/socket_driver.py", "SocketDocumentService._deliver"): (
        ("drivers/socket_driver.py", "SocketDocumentService._request"),
        ("drivers/socket_driver.py", "SocketDocumentService._send"),
    ),
}


@dataclasses.dataclass(frozen=True)
class LockId:
    relpath: str
    scope: str          # class name, or "<module>"
    attr: str

    def display(self) -> str:
        base = self.relpath.rsplit("/", 1)[-1]
        return f"{base}:{self.scope}.{self.attr}"


@dataclasses.dataclass
class LockInfo:
    lock_id: LockId
    creation_line: int
    kind: str           # "Lock" | "RLock"


@dataclasses.dataclass
class _Acq:
    lock: LockId
    held: frozenset
    line: int


@dataclasses.dataclass
class _Blocking:
    desc: str
    held: frozenset
    line: int


@dataclasses.dataclass
class _Call:
    node: ast.Call
    held: frozenset
    line: int


@dataclasses.dataclass
class _Await:
    held: frozenset     # locks held at the await
    line: int


@dataclasses.dataclass
class _FnFacts:
    info: FunctionInfo
    acquisitions: list
    blocking: list
    calls: list
    awaits: list


def _blocking_call_match(dotted: str) -> bool:
    return any(
        dotted == p or (p.endswith(".") and dotted.startswith(p))
        for p in BLOCKING_CALLS
    )


class _Scopes:
    """Lock + typed-attribute registries for one file."""

    def __init__(self, src: SourceFile, aliases: dict):
        self.src = src
        self.aliases = aliases
        # (scope, attr) -> LockInfo
        self.locks: dict = {}
        # (scope, attr) -> typed kind ("queue"/"event"/"socket")
        self.typed: dict = {}
        self._collect()

    def _ctor_kind(self, value: ast.AST) -> Optional[tuple]:
        if not isinstance(value, ast.Call):
            return None
        dotted = _dotted(value.func, self.aliases)
        if dotted is None:
            return None
        if dotted in LOCK_FACTORIES:
            return ("lock", dotted.rsplit(".", 1)[-1])
        kind = TYPED_CTORS.get(dotted)
        if kind is not None:
            return ("typed", kind)
        return None

    def _register(self, scope: str, target: ast.AST,
                  value: ast.AST, line: int) -> None:
        kind = self._ctor_kind(value)
        if kind is None:
            return
        attr = None
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            attr = target.attr
        elif isinstance(target, ast.Name) and scope == "<module>":
            attr = target.id
        if attr is None:
            return
        if kind[0] == "lock":
            self.locks[(scope, attr)] = LockInfo(
                LockId(self.src.relpath, scope, attr), line, kind[1])
        else:
            self.typed[(scope, attr)] = kind[1]

    def _collect(self) -> None:
        tree = self.src.tree

        def targets_of(stmt):
            if isinstance(stmt, ast.Assign):
                return stmt.targets, stmt.value
            if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                return [stmt.target], stmt.value
            return [], None

        for stmt in tree.body:
            targets, value = targets_of(stmt)
            for t in targets:
                self._register("<module>", t, value, stmt.lineno)
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for sub in ast.walk(node):
                targets, value = targets_of(sub)
                for t in targets:
                    self._register(node.name, t, value,
                                   getattr(sub, "lineno", 0))


class _FnWalker(ast.NodeVisitor):
    """Walk one function body tracking held locks; record
    acquisitions, blocking primitives, calls and awaits."""

    def __init__(self, info: FunctionInfo, scopes: _Scopes):
        self.info = info
        self.scopes = scopes
        self.held: frozenset = frozenset()
        self.facts = _FnFacts(info, [], [], [], [])
        # function-local typed receivers: name -> kind
        self.local_typed: dict = {}
        # nested-def facts, merged in finalize() ONLY when the owner
        # calls the closure by name: a closure merely PASSED somewhere
        # (run_in_executor(None, work)) runs on whatever thread the
        # receiver chooses, not on this function's path — folding its
        # body in unconditionally would flag the sanctioned executor
        # offload pattern itself
        self._nested: dict = {}
        self._called_names: set = set()

    # -- resolution helpers -------------------------------------------

    def _lock_of(self, expr: ast.AST) -> Optional[LockId]:
        cls = self.info.class_name
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and cls is not None:
            li = self.scopes.locks.get((cls, expr.attr))
            return li.lock_id if li else None
        if isinstance(expr, ast.Name):
            li = self.scopes.locks.get(("<module>", expr.id))
            return li.lock_id if li else None
        return None

    def _typed_kind(self, expr: ast.AST) -> Optional[str]:
        cls = self.info.class_name
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and cls is not None:
            return self.scopes.typed.get((cls, expr.attr))
        if isinstance(expr, ast.Name):
            return self.local_typed.get(expr.id) or \
                self.scopes.typed.get(("<module>", expr.id))
        return None

    # -- visitors -----------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        prev = self.held
        # items acquire LEFT TO RIGHT: in `with self.a, self.b:` the
        # b-acquisition already holds a, so the a->b order edge must
        # be recorded exactly as the single-item nested form would
        for item in node.items:
            self.visit(item.context_expr)
            lock = self._lock_of(item.context_expr)
            if lock is not None:
                self.facts.acquisitions.append(
                    _Acq(lock, self.held, item.context_expr.lineno))
                self.held = self.held | frozenset((lock,))
        for stmt in node.body:
            self.visit(stmt)
        self.held = prev

    visit_AsyncWith = visit_With

    def visit_Await(self, node: ast.Await) -> None:
        self.facts.awaits.append(_Await(self.held, node.lineno))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # function-local typed receivers: q = queue.Queue()
        kind = None
        if isinstance(node.value, ast.Call):
            dotted = _dotted(node.value.func, self.scopes.aliases)
            if dotted is not None:
                kind = TYPED_CTORS.get(dotted)
        if kind is not None:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.local_typed[t.id] = kind
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func, self.scopes.aliases)
        desc = None
        if dotted is not None and _blocking_call_match(dotted):
            desc = dotted
        elif isinstance(node.func, ast.Attribute):
            meth = node.func.attr
            if meth in BLOCKING_METHODS_ALWAYS:
                desc = f".{meth}"
            else:
                kind = self._typed_kind(node.func.value)
                if kind is not None and \
                        meth in TYPED_BLOCKING_METHODS[kind]:
                    desc = f".{meth}"
                elif meth == "acquire":
                    lock = self._lock_of(node.func.value)
                    if lock is not None:
                        # bare acquire(): treated like a with-entry
                        # (slow-lock logic decides if it blocks)
                        self.facts.acquisitions.append(
                            _Acq(lock, self.held, node.lineno))
        if desc is not None:
            self.facts.blocking.append(
                _Blocking(desc, self.held, node.lineno))
        if isinstance(node.func, ast.Name):
            self._called_names.add(node.func.id)
        self.facts.calls.append(_Call(node, self.held, node.lineno))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        # a nested def executes when CALLED, not here: walk it with a
        # FRESH walker (empty held set — the closure may run on any
        # thread later) and merge its facts only if finalize() sees a
        # local call to it
        sub = _FnWalker(self.info, self.scopes)
        sub.local_typed = dict(self.local_typed)
        for stmt in node.body:
            sub.visit(stmt)
        self._nested.setdefault(node.name, []).append(sub)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # lambdas are (almost) always passed, not called in place —
        # treat like an uncalled closure and keep their bodies out
        # (an immediately-invoked lambda's blocking call is a
        # documented false negative)
        pass

    def finalize(self) -> "_FnWalker":
        """Merge the facts of nested defs the owner demonstrably
        calls (directly, or through another merged closure)."""
        merged: set = set()
        changed = True
        while changed:
            changed = False
            for name, subs in self._nested.items():
                if name not in self._called_names:
                    continue
                for sub in subs:
                    if id(sub) in merged:
                        continue
                    merged.add(id(sub))
                    changed = True
                    sub.finalize()
                    self.facts.acquisitions.extend(
                        sub.facts.acquisitions)
                    self.facts.blocking.extend(sub.facts.blocking)
                    self.facts.calls.extend(sub.facts.calls)
                    self.facts.awaits.extend(sub.facts.awaits)
                    self._called_names |= sub._called_names
        return self


class Analysis:
    """The shared interprocedural computation behind all three rules
    (and the lock-graph surface the sanitizer differential test
    compares against)."""

    def __init__(self, files: list, graph: Optional[CallGraph] = None):
        self.files = [f for f in files if f.tree is not None]
        self.graph = graph or build_callgraph(self.files)
        self.scopes: dict[str, _Scopes] = {}
        self.facts: dict[int, _FnFacts] = {}
        self.locks: dict[LockId, LockInfo] = {}
        # (LockId, LockId) -> witness (path, line, via)
        self.edges: dict = {}
        self._indirect: dict[int, list] = {}
        self._collect()
        self._propagate()

    # -- phase 1: per-function facts ----------------------------------

    def _collect(self) -> None:
        for src in self.files:
            scopes = _Scopes(
                src, self.graph.module_aliases(src.relpath))
            self.scopes[src.relpath] = scopes
            for (scope, attr), li in scopes.locks.items():
                self.locks[li.lock_id] = li
        for info in self.graph.functions():
            scopes = self.scopes.get(info.relpath)
            if scopes is None:
                continue
            walker = _FnWalker(info, scopes)
            for stmt in info.node.body:
                walker.visit(stmt)
            self.facts[id(info.node)] = walker.finalize().facts
        # resolve the INDIRECT_CALLS registry against real functions
        by_suffix: dict = {}
        for info in self.graph.functions():
            by_suffix.setdefault(
                (info.relpath, info.qualname), []).append(info)

        def find(suffix_key):
            return [
                info for (relpath, qual), infos in by_suffix.items()
                for info in infos
                if relpath.endswith(suffix_key[0])
                and qual == suffix_key[1]
            ]

        for src_key, dst_keys in INDIRECT_CALLS.items():
            for src_info in find(src_key):
                targets = []
                for dk in dst_keys:
                    targets.extend(find(dk))
                self._indirect[id(src_info.node)] = targets

    def _callees(self, info: FunctionInfo) -> list:
        return self.graph.callees(info) + \
            self._indirect.get(id(info.node), [])

    # -- phase 2: fixpoints -------------------------------------------

    def _transitive(self, direct: dict) -> dict:
        """Generic union-over-callees fixpoint: node-id -> set."""
        trans = {k: set(v) for k, v in direct.items()}
        changed = True
        while changed:
            changed = False
            for info in self.graph.functions():
                cur = trans.setdefault(id(info.node), set())
                before = len(cur)
                for callee in self._callees(info):
                    cur |= trans.get(id(callee.node), set())
                if len(cur) != before:
                    changed = True
        return trans

    def _propagate(self) -> None:
        # locks transitively acquired when a function runs
        direct_acq = {
            fid: {a.lock for a in facts.acquisitions}
            for fid, facts in self.facts.items()
        }
        self.trans_acquired = self._transitive(direct_acq)

        # lock-order edges: direct nesting + held-at-call-site x
        # transitively-acquired-by-callee
        for fid, facts in self.facts.items():
            info = facts.info
            for acq in facts.acquisitions:
                for held in acq.held:
                    if held != acq.lock:
                        self.edges.setdefault(
                            (held, acq.lock),
                            (info.relpath, acq.line,
                             f"{info.qualname} acquires "
                             f"{acq.lock.display()} while holding "
                             f"{held.display()}"))
                    elif self.locks[acq.lock].kind == "Lock":
                        # re-acquiring a NON-reentrant Lock already
                        # held on this path is a self-deadlock; a
                        # self-edge makes it a one-lock cycle
                        self.edges.setdefault(
                            (acq.lock, acq.lock),
                            (info.relpath, acq.line,
                             f"{info.qualname} re-acquires "
                             f"{acq.lock.display()} it already "
                             "holds"))
            for call in facts.calls:
                if not call.held:
                    continue
                # _callees_at includes INDIRECT_CALLS targets: a
                # callback invoked at an unresolved call site inside a
                # registered function fires within the same held
                # regions its resolvable calls do
                for callee in self._callees_at(info, call):
                    self._edge_through(info, call, callee)

        # functions whose execution can block (directly or through
        # callees); slow locks iterate with it to fixpoint
        self.slow_locks: set = set()
        trans_blocking: dict = {}
        for _ in range(len(self.locks) + 1):
            direct = {}
            for fid, facts in self.facts.items():
                hits = {b.desc for b in facts.blocking}
                hits |= {
                    f"with {a.lock.display()}"
                    for a in facts.acquisitions
                    if a.lock in self.slow_locks
                }
                direct[fid] = hits
            trans_blocking = self._transitive(direct)
            new_slow = set(self.slow_locks)
            for fid, facts in self.facts.items():
                info = facts.info
                for b in facts.blocking:
                    new_slow |= b.held
                for call in facts.calls:
                    if not call.held:
                        continue
                    blocked = False
                    for callee in self._callees_at(info, call):
                        if trans_blocking.get(id(callee.node)):
                            blocked = True
                            break
                    if blocked:
                        new_slow |= call.held
            if new_slow == self.slow_locks:
                self.trans_blocking = trans_blocking
                break
            self.slow_locks = new_slow
        else:  # pragma: no cover - bounded by lock count
            self.trans_blocking = trans_blocking

    def _callees_at(self, info: FunctionInfo, call: _Call) -> list:
        out = self.graph.resolve_call(call.node, info, info.src)
        out.extend(self._indirect.get(id(info.node), []))
        return out

    def _edge_through(self, info: FunctionInfo, call: _Call,
                      callee: FunctionInfo) -> None:
        for lock in self.trans_acquired.get(id(callee.node), ()):
            for held in call.held:
                if held != lock:
                    self.edges.setdefault(
                        (held, lock),
                        (info.relpath, call.line,
                         f"{info.qualname} -> {callee.qualname}"))
                elif self.locks[lock].kind == "Lock":
                    self.edges.setdefault(
                        (lock, lock),
                        (info.relpath, call.line,
                         f"{info.qualname} -> {callee.qualname} "
                         f"re-acquires held {lock.display()}"))

    # -- the lock-graph surface (sanitizer differential) --------------

    def lock_edges_by_site(self) -> set:
        """Static edges keyed by lock CREATION SITE (relpath, line) —
        the identity the runtime sanitizer observes."""
        out = set()
        for (a, b) in self.edges:
            ia, ib = self.locks.get(a), self.locks.get(b)
            if ia is None or ib is None:
                continue
            out.add(((a.relpath, ia.creation_line),
                     (b.relpath, ib.creation_line)))
        return out


def _cycles(edges: dict) -> list:
    """Strongly-connected components of the lock graph with more than
    one lock (or a genuine self-edge, kept upstream only for
    non-reentrant locks)."""
    graph: dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    sccs: list = []
    counter = [0]

    def strongconnect(v):
        work = [(v, iter(sorted(graph[v], key=lambda x: x.display())))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append(
                        (w, iter(sorted(graph[w],
                                        key=lambda x: x.display()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w is node:
                        break
                sccs.append(scc)

    for v in sorted(graph, key=lambda x: x.display()):
        if v not in index:
            strongconnect(v)
    out = []
    for scc in sccs:
        if len(scc) > 1:
            out.append(sorted(scc, key=lambda x: x.display()))
        elif (scc[0], scc[0]) in edges:
            out.append(scc)
    return out


def check(files: list, graph: Optional[CallGraph] = None) -> list:
    ana = Analysis(files, graph)
    findings: list = []

    # -- lock-order-cycle ---------------------------------------------
    for cycle in _cycles(ana.edges):
        members = set(cycle)
        names = sorted(lock.display() for lock in cycle)
        # every REAL edge inside the SCC, each with its witness —
        # the SCC's member list has no meaningful direction, the
        # edges do
        cyc_edges = sorted(
            ((a, b, ana.edges[(a, b)]) for (a, b) in ana.edges
             if a in members and b in members),
            key=lambda e: (e[0].display(), e[1].display()),
        )
        detail = "; ".join(
            f"{a.display()} -> {b.display()} ({via})"
            for a, b, (_p, _l, via) in cyc_edges
        )
        path, line, _via = cyc_edges[0][2]
        findings.append(Finding(
            rule="lock-order-cycle",
            path=path, line=line,
            message=(
                f"lock-acquisition-order cycle among {names}: "
                f"{detail} — two threads taking these locks in "
                "opposite orders deadlock; pick one global order and "
                "restructure the offending call path"
            ),
            key="cycle:" + "<->".join(names),
        ))

    # -- await-holding-lock -------------------------------------------
    for facts in ana.facts.values():
        info = facts.info
        if not info.is_async:
            continue
        module = info.relpath.rsplit("/", 1)[-1]
        seen = set()
        for aw in facts.awaits:
            for lock in sorted(aw.held, key=lambda x: x.display()):
                if (lock, info.qualname) in seen:
                    continue
                seen.add((lock, info.qualname))
                findings.append(Finding(
                    rule="await-holding-lock",
                    path=info.relpath, line=aw.line,
                    message=(
                        f"await inside `with {lock.display()}:` in "
                        f"{info.qualname}(): the coroutine parks with "
                        "the OS lock held — every thread wanting it "
                        "now waits on the event loop's schedule; "
                        "release before awaiting (or use an "
                        "asyncio.Lock)"
                    ),
                    # qualname, not bare name: same-named methods of
                    # two classes in one module must not share one
                    # allowlist key
                    key=f"{module}:{info.qualname}:{lock.attr}",
                ))

    # -- async-blocking-call ------------------------------------------
    def in_scope(relpath: str) -> bool:
        return bool(
            set(relpath.split("/")[:-1]) & ASYNC_SCOPE_COMPONENTS
        )

    roots = [
        info for info in ana.graph.functions()
        if info.is_async and in_scope(info.relpath)
    ]
    via: dict[int, str] = {}
    queue = []
    for r in roots:
        if id(r.node) not in via:
            via[id(r.node)] = r.qualname
            queue.append(r)
    while queue:
        info = queue.pop()
        for callee in ana._callees(info):
            if id(callee.node) not in via:
                via[id(callee.node)] = via[id(info.node)]
                queue.append(callee)

    reported = set()
    for fid, root_qual in via.items():
        facts = ana.facts.get(fid)
        if facts is None:
            continue
        info = facts.info
        module = info.relpath.rsplit("/", 1)[-1]
        hits = [
            (b.desc, b.desc.lstrip("."), b.line)
            for b in facts.blocking
        ]
        hits += [
            (f"acquisition of slow lock {a.lock.display()} (held "
             "across blocking I/O elsewhere in the program)",
             f"with-{a.lock.attr}", a.line)
            for a in facts.acquisitions if a.lock in ana.slow_locks
        ]
        for desc, keydesc, line in hits:
            dedupe = (info.relpath, info.qualname, keydesc)
            if dedupe in reported:
                continue
            reported.add(dedupe)
            findings.append(Finding(
                rule="async-blocking-call",
                path=info.relpath, line=line,
                message=(
                    f"blocking {desc} in {info.qualname}() is "
                    f"reachable from async {root_qual}(): it stalls "
                    "the event loop for every connection the loop "
                    "serves — hop through "
                    "loop.run_in_executor/asyncio.to_thread (or use "
                    "the asyncio-native primitive)"
                ),
                key=f"{module}:{info.qualname}:{keydesc}",
            ))
    return findings


def build_analysis(files: list,
                   graph: Optional[CallGraph] = None) -> Analysis:
    """The lock-graph surface for tooling and the sanitizer
    differential test."""
    return Analysis(files, graph)
