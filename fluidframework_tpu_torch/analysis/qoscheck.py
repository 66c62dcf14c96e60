"""qoscheck — overload-safety rules for the service plane.

``service-unbounded-queue``: an ``asyncio.Queue()`` without a
``maxsize`` (or a ``collections.deque()`` without a ``maxlen``)
reachable in the service layer is a standing invitation for one slow
consumer or one hot tenant to buffer the server into the ground —
exactly the failure the qos subsystem exists to rule out (the
per-session outbound queue was this bug until it grew a bound and a
slow-consumer policy; docs/QOS.md). The rule flags every unbounded
construction in a ``service``/``qos`` path component; the few
intentional ones (queues drained synchronously before the
constructor's caller returns) carry a justified inline
``# fluidlint: disable=service-unbounded-queue``.

Scope is by PATH COMPONENT (any ``service`` or ``qos`` directory in
the file's repo-relative path), so the rule covers the real tree and
still fires on test fixtures placed under a ``service/`` tmp dir.
``queue.Queue()`` (the threading one) counts too — the driver layer
uses it legitimately, but in the service plane it has the same
unbounded-buffer failure mode.

``retry-without-jitter``: a ``time.sleep(<constant>)`` inside a
retry/reconnect loop in a ``drivers``/``service``/``qos`` path
component synchronizes every client the service just shed — after a
mass disconnect (exactly what a chaos storm injects) they all come
back at t+delay, t+2*delay, ... in lockstep, re-creating the spike
that caused the shedding (the thundering herd). Backoff delays must
route through ``drivers/driver_utils.full_jitter_delay`` (which also
honors a throttle's ``retry_after_seconds`` as the floor).
Flagged: a constant argument (directly, via constant arithmetic, or
via a local name bound to one) slept inside a ``for``/``while`` body.
Clean: the slept value flows from a ``full_jitter_delay(...)`` call
(directly or via a local name). Unknown provenance (parameters,
attributes, other calls) is trusted — the arithmetic-with-names
backoff (``base * 2 ** attempt``: exponential but unjittered) is a
documented false negative; route it through the helper anyway.

``fence-before-fanout``: inside the replicated sequencer, the calls
that release a sequenced op toward fan-out (the reviewed
``FANOUT_GATES`` registry — ``replicate_before_fanout`` and its
underscore twin, on both the document plane and the partitioned
queue) MUST be textually preceded, in the same function, by an epoch
fence check (``<...>.fence.check(...)`` or a ``check_epoch(...)``
call). A deposed leader that fans out before checking the fence is
the split-brain failure the whole replication design exists to rule
out (docs/ROBUSTNESS.md "Replication & failover"); the runtime half
is ``EpochFence.check`` raising ``FencedWriteError`` + the
follower-side stale-epoch refusal, and this rule pins the ordering
statically so a refactor cannot silently move the fan-out above the
fence. Scope: ``service`` path components (where the replicated
sequencer lives).

``unbounded-blocking-wait``: a polling/blocking wait loop in the
service plane — a ``while`` loop whose body sleeps (``time.sleep``,
an injectable ``self._sleep``/``wait`` primitive) while it waits for
external progress — must carry a DEADLINE: a comparison against a
clock reading or a ``deadline``/``timeout``-named bound somewhere in
the loop. The replicated sequencer's quorum barrier was this bug
(the ``while acked < quorum`` wait): a minority-side leader hung
every submitter forever instead of answering with the retriable
unavailable nack (docs/ROBUSTNESS.md "Partition tolerance &
degraded mode"). Scope: ``service`` path components. A wait that is
legitimately unbounded (none known today — the allowlist stays
empty) would carry a justified inline
``# fluidlint: disable=unbounded-blocking-wait``.
"""
from __future__ import annotations

import ast
from typing import Optional

from .core import (
    Finding,
    SourceFile,
    dotted_path as _dotted,
    import_aliases,
)

# dotted-path suffixes that construct a queue-like container, and the
# keyword (or positional index) that bounds it
_QUEUE_SUFFIXES = {
    "asyncio.Queue": ("maxsize", 0),
    "asyncio.LifoQueue": ("maxsize", 0),
    "asyncio.PriorityQueue": ("maxsize", 0),
    "queue.Queue": ("maxsize", 0),
    "queue.LifoQueue": ("maxsize", 0),
    "queue.PriorityQueue": ("maxsize", 0),
    "collections.deque": ("maxlen", 1),
    "deque": ("maxlen", 1),
}


def _in_scope(relpath: str) -> bool:
    parts = relpath.split("/")
    return "service" in parts[:-1] or "qos" in parts[:-1]


def _import_aliases(tree: ast.AST) -> dict[str, str]:
    # same resolution style as obscheck: relative-import tails stay,
    # suffix matching keys on them
    return import_aliases(tree, relative="tail")


def _bound_spec(dotted: str) -> Optional[tuple[str, int]]:
    for suffix, spec in _QUEUE_SUFFIXES.items():
        if dotted == suffix or dotted.endswith("." + suffix):
            # the bare-name form ("deque") only counts when it came
            # through an import (collections.deque resolves dotted);
            # a module's own class named deque would resolve bare and
            # must not fire — mirrored from obscheck's reasoning
            if suffix == "deque" and dotted == "deque":
                return None
            return spec
    return None


def _has_bound(node: ast.Call, spec: tuple[str, int]) -> bool:
    kw_name, pos_index = spec

    def bounds(value: ast.AST) -> bool:
        if not isinstance(value, ast.Constant):
            return True  # a computed bound: trust it
        if value.value is None:
            return False  # explicit None = unbounded
        # asyncio/queue semantics: maxsize <= 0 means INFINITE;
        # deque(maxlen=0) genuinely bounds (to empty)
        if kw_name == "maxsize" and isinstance(
                value.value, (int, float)) and value.value <= 0:
            return False
        return True

    for kw in node.keywords:
        if kw.arg == kw_name:
            return bounds(kw.value)
        if kw.arg is None:
            return True  # **kwargs: cannot prove unbounded
    if len(node.args) > pos_index:
        return bounds(node.args[pos_index])
    return False


def _qualname_of(stack: list[str], node: ast.Call,
                 parents: dict) -> str:
    """Stable, line-free finding key: enclosing scope + assignment
    target (e.g. ``_ClientSession.__init__.outbound``)."""
    target = ""
    parent = parents.get(node)
    # walk up through subscripts/annotations to the binding statement
    hops = 0
    while parent is not None and hops < 4:
        if isinstance(parent, (ast.Assign, ast.AnnAssign)):
            t = parent.targets[0] if isinstance(parent, ast.Assign) \
                else parent.target
            if isinstance(t, ast.Attribute):
                target = t.attr
            elif isinstance(t, ast.Name):
                target = t.id
            break
        parent = parents.get(parent)
        hops += 1
    scope = ".".join(stack) or "<module>"
    return f"{scope}.{target}" if target else scope


JITTER_HELPER = "full_jitter_delay"


def _in_retry_scope(relpath: str) -> bool:
    parts = relpath.split("/")
    return any(p in ("drivers", "service", "qos") for p in parts[:-1])


def _is_sleep_call(node: ast.Call, aliases: dict) -> bool:
    dotted = _dotted(node.func, aliases)
    if dotted is None:
        return False
    return dotted == "time.sleep" or dotted.endswith(".time.sleep") \
        or dotted == "sleep" and aliases.get("sleep", "") == "time.sleep"


def _derives_from_jitter(value: ast.AST, env: dict) -> bool:
    """Does the expression (or a local name it reads) flow from a
    full_jitter_delay(...) call?"""
    for node in ast.walk(value):
        if isinstance(node, ast.Call):
            callee = node.func
            name = callee.attr if isinstance(callee, ast.Attribute) \
                else getattr(callee, "id", None)
            if name == JITTER_HELPER:
                return True
        if isinstance(node, ast.Name) and node.id in env:
            if env[node.id] == "jitter":
                return True
    return False


def _const_only(value: ast.AST, env: dict) -> bool:
    """True when every leaf is a literal constant or a local name
    bound to one — the deterministic-schedule shape the rule exists
    to flag."""
    for node in ast.walk(value):
        if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.Constant,
                             ast.operator, ast.unaryop, ast.expr_context)):
            continue
        if isinstance(node, ast.Name):
            if env.get(node.id) != "const":
                return False
            continue
        return False
    return True


def _check_retry_jitter(src: SourceFile, aliases: dict,
                        module: str, findings: list) -> None:
    # Class.method qualnames so same-named methods of two classes
    # never share a finding key
    quals: dict[ast.AST, str] = {}
    for cls in ast.walk(src.tree):
        if isinstance(cls, ast.ClassDef):
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    quals[item] = f"{cls.name}.{item.name}"
    for scope in ast.walk(src.tree):
        if not isinstance(scope, (ast.FunctionDef,
                                  ast.AsyncFunctionDef,
                                  ast.Module)):
            continue
        # textual-order local provenance: name -> "const" | "jitter"
        # (later bindings supersede; anything else drops the name)
        env: dict[str, str] = {}
        hits = 0
        own_body = list(ast.iter_child_nodes(scope))

        def walk(node, in_loop: bool, owner) -> None:
            nonlocal hits
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) \
                    and node is not owner:
                return  # nested scopes analyzed on their own walk
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if _derives_from_jitter(node.value, env):
                    env[name] = "jitter"
                elif _const_only(node.value, env):
                    env[name] = "const"
                else:
                    env.pop(name, None)
            if isinstance(node, ast.Call) and in_loop \
                    and _is_sleep_call(node, aliases) and node.args:
                arg = node.args[0]
                if not _derives_from_jitter(arg, env) \
                        and _const_only(arg, env):
                    hits += 1
                    qual = quals.get(
                        owner, getattr(owner, "name", "<module>"))
                    suffix = "" if hits == 1 else str(hits)
                    findings.append(Finding(
                        rule="retry-without-jitter",
                        path=src.relpath, line=node.lineno,
                        message=(
                            "constant sleep in a retry/reconnect "
                            "loop: a fixed delay synchronizes every "
                            "shed client's comeback (thundering "
                            "herd) — route the delay through "
                            "driver_utils.full_jitter_delay "
                            "(docs/ROBUSTNESS.md)"
                        ),
                        key=f"{module}:{qual}.sleep{suffix}",
                    ))
            loops_here = in_loop or isinstance(node,
                                               (ast.For, ast.While))
            for child in ast.iter_child_nodes(node):
                walk(child, loops_here, owner)

        for child in own_body:
            walk(child, False, scope)


#: reviewed registry: the replication gates — calls that release a
#: sequenced op toward fan-out in the replicated sequencer. Adding a
#: new gate spelling here is a REVIEWED change (the rule's coverage
#: is only as good as this list).
FANOUT_GATES = ("replicate_before_fanout", "_replicate_before_fanout")

#: bare-call fence spellings; ``<...>.fence.check(...)`` is always
#: recognized structurally
FENCE_CALLS = ("check_epoch",)


def _callee_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_fence_check(node: ast.Call) -> bool:
    name = _callee_name(node.func)
    if name in FENCE_CALLS:
        return True
    if name != "check" or not isinstance(node.func, ast.Attribute):
        return False
    value = node.func.value
    # <anything>.fence.check(...) / fence.check(...)
    if isinstance(value, ast.Attribute) and value.attr == "fence":
        return True
    return isinstance(value, ast.Name) and value.id == "fence"


def _check_fence_before_fanout(src: SourceFile, module: str,
                               findings: list) -> None:
    quals: dict[ast.AST, str] = {}
    for cls in ast.walk(src.tree):
        if isinstance(cls, ast.ClassDef):
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    quals[item] = f"{cls.name}.{item.name}"
    def own_calls(scope) -> list[ast.Call]:
        """Calls in the scope's OWN body — nested defs are their own
        scopes (a fence check inside a nested helper does not guard
        the outer function's gate, and a nested gate must not be
        double-reported against the outer scope)."""
        out: list[ast.Call] = []

        def walk(node) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                if isinstance(child, ast.Call):
                    out.append(child)
                walk(child)

        walk(scope)
        return out

    for scope in ast.walk(src.tree):
        if not isinstance(scope, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
            continue
        calls = own_calls(scope)
        fences = sorted((n.lineno, n.col_offset) for n in calls
                        if _is_fence_check(n))
        hits = 0
        for call in sorted(calls, key=lambda n: (n.lineno,
                                                 n.col_offset)):
            if _callee_name(call.func) not in FANOUT_GATES:
                continue
            pos = (call.lineno, call.col_offset)
            if any(f < pos for f in fences):
                continue
            hits += 1
            qual = quals.get(scope, scope.name)
            suffix = "" if hits == 1 else str(hits)
            findings.append(Finding(
                rule="fence-before-fanout",
                path=src.relpath, line=call.lineno,
                message=(
                    f"{_callee_name(call.func)}() releases a "
                    "sequenced op toward fan-out without an epoch "
                    "fence check earlier in this function: a "
                    "deposed leader (split-brain candidate) could "
                    "fan out an op the quorum will refuse — call "
                    "<...>.fence.check(epoch) (or check_epoch) "
                    "first (docs/ROBUSTNESS.md)"
                ),
                key=f"{module}:{qual}.fanout{suffix}",
            ))


#: callee-name fragments that mark a call as a blocking/polling wait
#: primitive (the loop body "waits" through them): time.sleep and the
#: injectable sleep/wait seams the service plane uses
_WAIT_NAME_FRAGMENTS = ("sleep", "wait")

#: name fragments that mark a Name/Attribute as a deadline bound
_DEADLINE_FRAGMENTS = ("deadline", "timeout", "expires")

#: callee-name fragments whose call result reads a clock
_CLOCK_FRAGMENTS = ("clock", "monotonic", "time")


def _is_wait_call(node: ast.Call) -> bool:
    name = _callee_name(node.func)
    if name is None:
        return False
    ident = name.strip("_").lower()
    return ("sleep" in ident or ident == "wait"
            or ident.startswith("wait_") or ident.endswith("_wait"))


def _names_deadline(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        ident = node.id.lower()
    elif isinstance(node, ast.Attribute):
        ident = node.attr.lower()
    else:
        return False
    return any(f in ident for f in _DEADLINE_FRAGMENTS)


def _reads_clock(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _callee_name(node.func)
    if name is None:
        return False
    ident = name.lower()
    return any(f in ident for f in _CLOCK_FRAGMENTS)


def _has_deadline_bound(loop: ast.While) -> bool:
    """A comparison anywhere in the loop (test or body) where either
    side names a deadline/timeout or reads a clock — the shape
    ``if self.clock() >= deadline: ...`` the fixed barrier carries."""
    for node in ast.walk(loop):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left, *node.comparators]
        if any(_names_deadline(s) or _reads_clock(s) for s in sides):
            return True
    return False


def _check_blocking_wait(src: SourceFile, module: str,
                         findings: list) -> None:
    quals: dict[ast.AST, str] = {}
    for cls in ast.walk(src.tree):
        if isinstance(cls, ast.ClassDef):
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    quals[item] = f"{cls.name}.{item.name}"
    parents: dict = {}
    for parent in ast.walk(src.tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent

    def enclosing_scope(node) -> str:
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef,
                                ast.AsyncFunctionDef)):
                return quals.get(cur, cur.name)
            cur = parents.get(cur)
        return "<module>"

    hits: dict[str, int] = {}
    for loop in ast.walk(src.tree):
        if not isinstance(loop, ast.While):
            continue
        waits = any(isinstance(n, ast.Call) and _is_wait_call(n)
                    for stmt in loop.body for n in ast.walk(stmt))
        if not waits:
            continue
        if _has_deadline_bound(loop):
            continue
        qual = enclosing_scope(loop)
        n = hits.get(qual, 0) + 1
        hits[qual] = n
        suffix = "" if n == 1 else str(n)
        findings.append(Finding(
            rule="unbounded-blocking-wait",
            path=src.relpath, line=loop.lineno,
            message=(
                "blocking wait loop with no deadline in the service "
                "plane: a vanished peer set (netsplit, dead "
                "followers) hangs every caller forever — bound the "
                "wait on an injectable clock (`if clock() >= "
                "deadline: refuse`) and answer with a retriable "
                "unavailable nack (docs/ROBUSTNESS.md)"
            ),
            key=f"{module}:{qual}.blockwait{suffix}",
        ))


def check(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in files:
        if src.tree is None:
            continue
        if _in_retry_scope(src.relpath):
            _check_retry_jitter(
                src, _import_aliases(src.tree),
                src.relpath.rsplit("/", 1)[-1], findings)
        if not _in_scope(src.relpath):
            continue
        aliases = _import_aliases(src.tree)
        module = src.relpath.rsplit("/", 1)[-1]
        _check_fence_before_fanout(src, module, findings)
        _check_blocking_wait(src, module, findings)
        parents: dict = {}
        for parent in ast.walk(src.tree):
            for child in ast.iter_child_nodes(parent):
                parents[child] = parent

        def scope_stack(node) -> list[str]:
            out: list[str] = []
            cur = parents.get(node)
            while cur is not None:
                if isinstance(cur, (ast.FunctionDef,
                                    ast.AsyncFunctionDef,
                                    ast.ClassDef)):
                    out.append(cur.name)
                cur = parents.get(cur)
            return list(reversed(out))

        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func, aliases)
            if dotted is None:
                continue
            spec = _bound_spec(dotted)
            if spec is None or _has_bound(node, spec):
                continue
            qual = _qualname_of(scope_stack(node), node, parents)
            findings.append(Finding(
                rule="service-unbounded-queue",
                path=src.relpath, line=node.lineno,
                message=(
                    f"unbounded {dotted}() in the service layer: one "
                    "slow consumer / hot tenant buffers the server "
                    "into the ground — pass a bound "
                    f"({spec[0]}=...) and an explicit overflow "
                    "policy, or justify with '# fluidlint: "
                    "disable=service-unbounded-queue' (docs/QOS.md)"
                ),
                key=f"{module}:{qual}",
            ))
    return findings
