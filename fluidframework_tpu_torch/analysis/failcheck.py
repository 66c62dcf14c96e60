"""failcheck: exception-flow analysis for the serving planes.

Every worst bug this repo has shipped was a *silent* error path: the
PR2 dispatch thread that died quietly and blackholed acks, the PR14
resubmits swallowed by stale-csn dedupe, the silent pool-route
fallback PR8 had to make loud. The sequenced order per document is
single-sourced ("On Coordinating Collaborative Objects", arXiv
1007.5093), so an op or ack that vanishes without a signal forks
client state three hops downstream where it's unattributable. This
family statically proves the property every one of those fixes
retrofitted by hand: **error handlers in the serving paths are loud**.

Four rules:

- ``swallowed-exception`` — an ``except`` handler in a
  drivers/service/qos/runtime/loader path component whose body
  neither re-raises, returns/emits an error value (nack/error frame),
  increments a metric, flight-records, nor writes stderr. The
  reviewed per-handler ``SILENT_HANDLERS`` registry (the
  WALL_CLOCK_SINKS discipline: justified entries, gate-checked for
  staleness) is the escape hatch — NOT the allowlist.
- ``broad-except-in-dispatch-loop`` — a bare/``except Exception``
  inside a function the DISPATCH_LOOPS registry names, without loud
  teardown: the exact shape of the PR2 quietly-dead dispatch thread.
- ``exception-context-dropped`` — ``raise New(...)`` without
  ``from e`` inside an except in serving paths: severs the causal
  chain flight-recorder dumps and nack attribution rely on
  (``from None`` is an explicit, reviewed severing and passes).
- ``return-in-finally`` — ``return``/``break``/``continue`` in a
  ``finally`` block swallows the in-flight exception entirely
  (language semantics — the loudest handler upstream never runs).

Loudness resolves over the shared callgraph: a handler delegating to
a repo helper that itself re-raises or emits a signal (metric inc,
stderr write, flight record, nack/error-named call) is loud. Known FN
shape: a handler calling a recovery helper that only raises on
*failed* recovery counts as loud even when successful recovery emits
nothing — the runtime half (testing/failsan.py: fault-to-signal
accounting over the fluidchaos plane) is the backstop that catches
the actually-silent outcome.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from .callgraph import CallGraph, build_callgraph
from .core import Finding, SourceFile, import_aliases
from .determinism import _OrdinalKeys, _scope_map
from .synccheck import DISPATCH_LOOPS

# Path components where the handler rules apply: the serving planes.
# obs/ and utils/ are telemetry (their handlers ARE the signal
# emitters); tests/ and examples/ are out of scope.
FAIL_SCOPE_COMPONENTS = ("drivers", "service", "qos", "runtime",
                         "loader")

# Reviewed silent handlers: (relpath suffix, handler key) ->
# justification. A handler key is ``<qualname>:except-<Type>`` with
# the same ordinal suffixing as the finding keys. This is a REGISTRY,
# not an allowlist: every entry is a reviewed design decision, the
# gate test fails if an entry goes stale (no statically-silent handler
# left at the site), and a new silent handler anywhere else still
# fails the gate.
SILENT_HANDLERS: dict[tuple[str, str], str] = {
    # --- EOF / peer-hangup absorbs: the disconnect itself is the
    # signal, accounted by the reconnect/teardown machinery upstream
    ("drivers/socket_driver.py",
     "SocketDocumentService._recv_exact:except-OSError"):
        "socket died mid-read: returns None, the EOF sentinel the "
        "dispatch loop maps to reconnect-or-teardown (both loud "
        "paths — dispatch-fault metric + flight dump live there)",
    ("drivers/socket_driver.py",
     "SocketDocumentService._recv_header:except-OSError+ValueError"):
        "select()/header read on a socket torn down concurrently: "
        "same None EOF sentinel as _recv_exact, same loud upstream",
    ("service/ingress.py",
     "read_frame_sized:except-IncompleteReadError"
     "+ConnectionResetError"):
        "client hung up mid-header: returns (None, 0), the EOF "
        "sentinel _handle maps to session teardown (connection "
        "gauges account the disconnect)",
    ("service/ingress.py",
     "read_frame_sized:except-IncompleteReadError"
     "+ConnectionResetError2"):
        "client hung up mid-payload: same (None, 0) EOF sentinel "
        "as the header read",
    ("service/ingress.py",
     "_ClientSession.writer_loop:except-ConnectionResetError"
     "+BrokenPipeError+OSError"):
        "peer hung up while we were flushing to it: the reader "
        "side observes the same EOF and tears the session down "
        "through the loud path; double-reporting here would count "
        "every disconnect twice",
    ("service/ingress.py",
     "AlfredServer._handle:except-ConnectionResetError"
     "+BrokenPipeError"):
        "client disconnect race during frame dispatch: falls "
        "through to the finally teardown that decrements the "
        "connection gauges — the disconnect IS accounted",
    ("service/moira.py",
     "MaterializedHistoryServer._handle:except-ConnectionResetError"
     "+BrokenPipeError+RuntimeError"):
        "history client hung up mid-response: per-request service, "
        "nothing sequenced is in flight; teardown closes the writer",
    ("service/broker.py",
     "BrokerServer._handle:except-ConnectionResetError"
     "+BrokenPipeError+RuntimeError"):
        "broker client hung up: the consumer lease reaper "
        "re-queues anything the dead consumer held (the loud, "
        "accounted path for lost work)",
    # --- idempotent close()/teardown: already-gone is the goal state
    ("drivers/socket_driver.py",
     "SocketDocumentService.close:except-OSError"):
        "shutdown() on an already-dead socket during close(): "
        "already-gone is the goal state of close()",
    ("drivers/socket_driver.py",
     "SocketDocumentService.close:except-OSError2"):
        "close() after failed shutdown(): same double-close race",
    ("drivers/socket_driver.py",
     "SocketDeltaConnection.disconnect:except-OSError"):
        "disconnect frame to a server that is already gone: the "
        "goal state (no connection) already holds",
    ("drivers/caching_driver.py",
     "_DocumentFacade.close:except-OSError"):
        "best-effort disconnect_document on facade close: the "
        "snapshot was already persisted before this; a dead inner "
        "driver at close() loses nothing cached",
    ("service/ingress.py", "_ClientSession.close:except-QueueFull"):
        "displacing one outbound frame to enqueue the goodbye on a "
        "full queue: the session is closing, undelivered frames "
        "are the documented cost, and out_dropped counts the "
        "displacement on the non-closing path",
    ("service/ingress.py",
     "_ClientSession.close:except-OSError+RuntimeError"):
        "writer.close() on a transport torn down concurrently: "
        "idempotent teardown",
    ("service/broker.py", "BrokerServer.stop:except-Exception"):
        "writer close during server-wide stop fan-in: shutdown "
        "teardown, every queue is being dropped deliberately",
    ("service/broker.py",
     "RemoteOrderingQueue._close_sock:except-OSError"):
        "closing a socket that is already dead: _close_sock exists "
        "to make teardown idempotent for the reconnect path, which "
        "counts its own retries",
    # --- operator interrupt at a CLI entry point
    ("service/broker.py", "run_broker:except-KeyboardInterrupt"):
        "operator ^C on the blocking CLI entry point: exits the "
        "serve loop into the shutdown sequence; stderr noise here "
        "would garble the operator's own terminal",
    ("service/ingress.py", "run_server:except-KeyboardInterrupt"):
        "operator ^C on the blocking CLI entry point (same shape "
        "as run_broker)",
    ("service/moira.py", "run_mh_server:except-KeyboardInterrupt"):
        "operator ^C on the blocking CLI entry point (same shape "
        "as run_broker)",
    # --- absorbs whose accounting lives in the callee/report by design
    ("service/local_orderer.py",
     "LocalOrderer.disconnect:except-FencedWriteError"):
        "deposed-primary teardown: the fence refusal was already "
        "counted by the fence check that raised; the deposed node "
        "is shutting down and must not double-report",
    ("service/local_orderer.py",
     "LocalOrderer.disconnect:except-<dynamic>"):
        "owed-leave absorb under quorum loss: the leave is parked "
        "in _owed_leaves and settled (sequenced first) at the "
        "client's next join — the op is deferred, not lost",
    ("service/local_orderer.py",
     "LocalOrderer.disconnect:except-<dynamic>2"):
        "owed-leave absorb, replicated-path twin of the above",
    ("service/local_orderer.py",
     "LocalOrderer._write_checkpoint_guarded:except-BreakerOpenError"):
        "checkpoint skipped while the storage breaker is open: the "
        "breaker counts every refusal itself; the op log still "
        "holds every op (degraded durability, not loss)",
    ("service/partitioning.py",
     "ReplicatedFileOrderingQueue.scrub.fetch:except-ValueError"):
        "scrub falling back to the next peer on a torn remote "
        "read: the scrub report carries the per-peer corruption "
        "accounting for the sweep",
    ("service/replication.py",
     "ReplicatedSequencerGroup.scrub.fetch:except-CorruptRecordError"):
        "scrub falling back to the next peer on a corrupt record: "
        "the scrub report carries the accounting (and the storage "
        "layer already bumped the torn/scrub metrics)",
    # --- crash-debris cleanup where ENOENT is the common case
    ("service/partitioning.py",
     "FileOrderingQueue.__init__:except-OSError"):
        "os.remove of a stale .tmp from a crashed predecessor: "
        "ENOENT (no debris) is the normal case; the recovery "
        "itself is what this cleanup enables",
    ("service/storage.py", "DocumentStorage.__init__:except-OSError"):
        "same stale-.tmp crash-debris cleanup as "
        "FileOrderingQueue.__init__",
    # --- in-proc fast path: non-wire-encodable envelopes skip the
    # wire transforms BY CONTRACT (they never cross a socket)
    ("runtime/op_lifecycle.py",
     "OpCompressor.maybe_compress:except-TypeError"):
        "a non-JSON-serializable envelope is in-proc-only traffic: "
        "compression is a wire optimization, skipping it for an "
        "object that never crosses the wire loses nothing",
    ("runtime/op_lifecycle.py", "OpSplitter.split:except-TypeError"):
        "same in-proc envelope contract as maybe_compress: size "
        "cannot be measured, so the op rides unsplit",
    ("runtime/op_lifecycle.py", "stage_outbound:except-TypeError"):
        "same in-proc envelope contract at the staging seam",
}


def _in_fail_scope(relpath: str) -> bool:
    parts = relpath.split("/")
    return any(p in FAIL_SCOPE_COMPONENTS for p in parts[:-1])


def silent_handler_registered(relpath: str, handler_key: str) -> bool:
    for (suffix, key), _just in SILENT_HANDLERS.items():
        if relpath.endswith(suffix) and key == handler_key:
            return True
    return False


# ---------------------------------------------------------------------------
# handler enumeration (shared with testing/failsan.py: the runtime
# half maps caught-exception line events back onto these same sites,
# so the two halves cannot drift on what a "handler site" is)


@dataclasses.dataclass
class HandlerSite:
    """One ``except`` clause, with the line-free key both halves use."""

    node: ast.ExceptHandler
    qual: str                   # enclosing scope ("<module>" at top)
    type_display: str           # "bare", "OSError", "A+B"
    handler_key: str            # "<qual>:except-<Type>[ordinal]"
    key: str                    # "<module leaf>:<handler_key>"
    lineno: int                 # the except clause's line
    body_start: int
    body_end: int
    broad: bool                 # bare / Exception / BaseException


def _type_display(type_node: Optional[ast.expr]) -> str:
    def leaf(node) -> str:
        if isinstance(node, ast.Attribute):
            return node.attr
        if isinstance(node, ast.Name):
            return node.id
        return "<dynamic>"

    if type_node is None:
        return "bare"
    if isinstance(type_node, ast.Tuple):
        return "+".join(leaf(e) for e in type_node.elts)
    return leaf(type_node)


_BROAD_NAMES = frozenset(("Exception", "BaseException"))


def _is_broad(type_node: Optional[ast.expr]) -> bool:
    if type_node is None:
        return True
    names = type_node.elts if isinstance(type_node, ast.Tuple) \
        else [type_node]
    for n in names:
        if isinstance(n, ast.Attribute):
            n_id = n.attr
        elif isinstance(n, ast.Name):
            n_id = n.id
        else:
            continue
        if n_id in _BROAD_NAMES:
            return True
    return False


def module_handlers(tree: ast.AST, relpath: str) -> list[HandlerSite]:
    """Every except clause in one module, in source order, with the
    stable ordinal keys (two same-typed handlers in one scope get
    distinct keys that survive line insertions — the _OrdinalKeys
    contract every family shares)."""
    scope = _scope_map(tree)
    module = relpath.rsplit("/", 1)[-1]
    handlers = [
        n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)
    ]
    handlers.sort(key=lambda n: (n.lineno, n.col_offset))
    keys = _OrdinalKeys()
    out: list[HandlerSite] = []
    for node in handlers:
        qual = scope.get(id(node), "<module>")
        disp = _type_display(node.type)
        full = keys.key(module, qual, f"except-{disp}")
        handler_key = full.split(":", 1)[1]
        body_end = max(
            getattr(stmt, "end_lineno", stmt.lineno) or stmt.lineno
            for stmt in node.body
        )
        out.append(HandlerSite(
            node=node, qual=qual, type_display=disp,
            handler_key=handler_key, key=full, lineno=node.lineno,
            body_start=node.body[0].lineno, body_end=body_end,
            broad=_is_broad(node.type),
        ))
    return out


# ---------------------------------------------------------------------------
# the loudness predicate


# call leaves that emit an observable signal by construction: metric
# bumps, histogram observes, flight-recorder records/dumps, logging's
# error lanes, traceback printers
_LOUD_LEAVES = frozenset((
    "inc", "observe", "dump", "dump_to", "record", "exception",
    "warning", "warn", "critical", "log", "print_exc",
    "print_exception",
))

# a name containing one of these is an error-signal emitter/value by
# naming convention (send_nack, _emit_error, mark_failed, reject_op,
# report.corrupt, torn_tail)
_ERRORISH = ("nack", "error", "fail", "reject", "alert", "corrupt",
             "torn")


def _errorish(name: str) -> bool:
    low = name.lower()
    return any(s in low for s in _ERRORISH)


def _call_leaf(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _dotted(node, aliases: dict) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _writes_stderr(call: ast.Call, aliases: dict) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in ("write",
                                                   "writelines"):
        target = _dotted(f.value, aliases)
        if target is not None and target.endswith("stderr"):
            return True
    if isinstance(f, ast.Name) and f.id == "print":
        for kw in call.keywords:
            if kw.arg == "file":
                target = _dotted(kw.value, aliases)
                if target is not None and target.endswith("stderr"):
                    return True
    return False


def _errorish_expr(expr: ast.expr) -> bool:
    """Does a returned value *name* an error? (``return nack``,
    ``return self._make_error(...)`` — the emitted-error-value arm of
    the loudness predicate; ``return default`` is the PR8 silent
    fallback and does NOT count.)"""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and _errorish(node.id):
            return True
        if isinstance(node, ast.Attribute) and _errorish(node.attr):
            return True
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and _errorish(node.value):
            return True
    return False


def _walk_own_stmts(stmts):
    """ast.walk over a statement list EXCLUDING nested def subtrees
    (a nested def's raise runs when the closure runs, not when the
    handler does)."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _node_loud(node: ast.AST, aliases: dict) -> bool:
    """One statement/expression's intrinsic loudness (no callgraph)."""
    if isinstance(node, ast.Raise):
        return True
    if isinstance(node, ast.Call):
        leaf = _call_leaf(node)
        if leaf is not None and (leaf in _LOUD_LEAVES
                                 or _errorish(leaf)):
            return True
        if _writes_stderr(node, aliases):
            return True
        # an errorish name ANYWHERE in the call — the receiver chain
        # (``report.corrupt.append(i)``) or an argument
        # (``session.send({"type": "connect_document_error"})``): the
        # handler is emitting/recording an error value
        if _errorish_expr(node):
            return True
    if isinstance(node, ast.Return) and node.value is not None and \
            not (isinstance(node.value, ast.Constant)
                 and node.value.value is None) and \
            _errorish_expr(node.value):
        return True
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and _errorish(t.id):
                return True
            if isinstance(t, ast.Attribute) and _errorish(t.attr):
                return True
        # building an error value counts too: ``resp = {"type":
        # "error", ...}`` IS the emitted error frame
        value = getattr(node, "value", None)
        if value is not None and _errorish_expr(value):
            return True
    return False


class _Loudness:
    """Callgraph-propagated loudness, memoized per function node: a
    handler delegating to ``self._note_fault(e)`` is loud when the
    helper (transitively) re-raises or emits a signal."""

    def __init__(self, files: list, graph: CallGraph):
        self.graph = graph
        self._aliases: dict[str, dict] = {}
        self._by_rel = {f.relpath: f for f in files}
        self._memo: dict[int, bool] = {}

    def aliases_for(self, relpath: str) -> dict:
        cached = self._aliases.get(relpath)
        if cached is None:
            src = self._by_rel.get(relpath)
            cached = import_aliases(src.tree) \
                if src is not None and src.tree is not None else {}
            self._aliases[relpath] = cached
        return cached

    def fn_loud(self, info, _stack: Optional[set] = None) -> bool:
        cached = self._memo.get(id(info.node))
        if cached is not None:
            return cached
        _stack = _stack if _stack is not None else set()
        if id(info.node) in _stack:
            return False        # cycle: resolves on the outer frame
        _stack.add(id(info.node))
        aliases = self.aliases_for(info.relpath)
        loud = False
        for node in _walk_own_stmts(info.node.body):
            if _node_loud(node, aliases):
                loud = True
                break
        if not loud:
            for node in _walk_own_stmts(info.node.body):
                if not isinstance(node, ast.Call):
                    continue
                for target in self.graph.resolve_call(
                        node, info, info.src):
                    if self.fn_loud(target, _stack):
                        loud = True
                        break
                if loud:
                    break
        _stack.discard(id(info.node))
        self._memo[id(info.node)] = loud
        return loud

    def handler_loud(self, site: HandlerSite, src: SourceFile,
                     enclosing_def: Optional[ast.AST]) -> bool:
        aliases = self.aliases_for(src.relpath)
        for node in _walk_own_stmts(site.node.body):
            if _node_loud(node, aliases):
                return True
        caller = self.graph.info_for_node(enclosing_def) \
            if enclosing_def is not None else None
        for node in _walk_own_stmts(site.node.body):
            if not isinstance(node, ast.Call):
                continue
            for target in self.graph.resolve_call(node, caller, src):
                if self.fn_loud(target):
                    return True
        return False


def _enclosing_defs(tree: ast.AST) -> dict[int, ast.AST]:
    """ExceptHandler id -> nearest enclosing def node (for callgraph
    caller resolution); module-level handlers are absent."""
    out: dict[int, ast.AST] = {}

    def rec(node, owner):
        for sub in ast.iter_child_nodes(node):
            nxt = sub if isinstance(
                sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                else owner
            if isinstance(sub, ast.ExceptHandler) and owner is not None:
                out[id(sub)] = owner
            rec(sub, nxt)

    rec(tree, None)
    return out


# ---------------------------------------------------------------------------
# rules 1–3: one pass over every handler


def _dispatch_loop_fns(relpath: str) -> frozenset:
    for suffix, (loop_fns, boundary_fns) in DISPATCH_LOOPS.items():
        if relpath.endswith(suffix):
            return frozenset(loop_fns) | frozenset(boundary_fns)
    return frozenset()


def _check_handlers(files: list[SourceFile],
                    graph: CallGraph) -> list[Finding]:
    loudness = _Loudness(files, graph)
    findings: list[Finding] = []
    for src in files:
        if src.tree is None:
            continue
        in_scope = _in_fail_scope(src.relpath)
        loop_fns = _dispatch_loop_fns(src.relpath)
        if not in_scope and not loop_fns:
            continue
        owners = _enclosing_defs(src.tree)
        keys = _OrdinalKeys()
        module = src.relpath.rsplit("/", 1)[-1]
        for site in module_handlers(src.tree, src.relpath):
            owner = owners.get(id(site.node))
            in_loop = bool(loop_fns) and \
                site.qual.rsplit(".", 1)[-1] in loop_fns
            # --- exception-context-dropped (scope: serving paths) ---
            if in_scope:
                bound = site.node.name  # "e" in "except X as e"
                for node in _walk_own_stmts(site.node.body):
                    if not isinstance(node, ast.Raise) or \
                            node.exc is None or node.cause is not None:
                        continue
                    if isinstance(node.exc, ast.Name) and \
                            node.exc.id == bound:
                        continue    # ``raise e``: same exception
                    exc_leaf = _call_leaf(node.exc) if isinstance(
                        node.exc, ast.Call) else (
                        node.exc.id if isinstance(node.exc, ast.Name)
                        else getattr(node.exc, "attr", "<dynamic>"))
                    findings.append(Finding(
                        rule="exception-context-dropped",
                        path=src.relpath, line=node.lineno,
                        message=(
                            f"raise {exc_leaf}(...) inside "
                            f"``except {site.type_display}`` without "
                            "``from e``: the causal chain flight "
                            "dumps and nack attribution walk is "
                            "severed — chain it (``from e``) or "
                            "sever explicitly (``from None``)"
                        ),
                        key=keys.key(module, site.qual,
                                     f"raise-{exc_leaf}"),
                    ))
            if not (in_scope or in_loop):
                continue
            loud = loudness.handler_loud(site, src, owner)
            if loud:
                continue
            # --- broad-except-in-dispatch-loop (wins the dedup: the
            # dispatch-loop shape is the more specific diagnosis) ---
            if in_loop and site.broad:
                findings.append(Finding(
                    rule="broad-except-in-dispatch-loop",
                    path=src.relpath, line=site.lineno,
                    message=(
                        f"``except {site.type_display}`` inside "
                        f"dispatch-loop function {site.qual}() "
                        "(DISPATCH_LOOPS registry) with no loud "
                        "teardown: a swallowed error here kills the "
                        "loop quietly and blackholes every ack "
                        "behind it (the PR2 bug) — re-raise, or "
                        "emit a metric/stderr/flight signal before "
                        "recovering"
                    ),
                    key=keys.key(module, site.qual, "broad-except"),
                ))
                continue
            # --- swallowed-exception ---
            if in_scope:
                if silent_handler_registered(src.relpath,
                                             site.handler_key):
                    continue
                findings.append(Finding(
                    rule="swallowed-exception",
                    path=src.relpath, line=site.lineno,
                    message=(
                        f"``except {site.type_display}`` in "
                        f"{site.qual}() neither re-raises, returns "
                        "an error value, increments a metric, "
                        "flight-records, nor writes stderr: a "
                        "sequenced op or ack dying here vanishes "
                        "without a signal — make the handler loud, "
                        "or register it in "
                        "failcheck.SILENT_HANDLERS with a reviewed "
                        "justification"
                    ),
                    key=site.key,
                ))
    return findings


# ---------------------------------------------------------------------------
# rule 4: return-in-finally (everywhere — language semantics, not a
# serving-plane convention: the in-flight exception is DISCARDED)


def _check_return_in_finally(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in files:
        if src.tree is None:
            continue
        scope = _scope_map(src.tree)
        keys = _OrdinalKeys()
        module = src.relpath.rsplit("/", 1)[-1]
        hits: list[tuple] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Try) or not node.finalbody:
                continue
            hits.extend(_finally_escapes(node.finalbody))
        # source order so ordinal suffixes are line-insertion stable
        hits.sort(key=lambda pair: (pair[0].lineno,
                                    pair[0].col_offset))
        for stmt, kind in hits:
            qual = scope.get(id(stmt), "<module>")
            findings.append(Finding(
                rule="return-in-finally",
                path=src.relpath, line=stmt.lineno,
                message=(
                    f"``{kind}`` inside a ``finally`` block discards "
                    "any in-flight exception (language semantics): "
                    "the error neither propagates nor signals — move "
                    f"the ``{kind}`` out of the finally, or handle "
                    "the exception explicitly first"
                ),
                key=keys.key(module, qual, f"finally-{kind}"),
            ))
    return findings


def _finally_escapes(finalbody) -> list[tuple]:
    """(stmt, kind) for every return/break/continue that escapes the
    finally block itself: a break/continue bound to a loop INSIDE the
    finalbody is that loop's business, and nested defs are their own
    scope."""
    out: list[tuple] = []

    def rec(stmts, in_loop: bool):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.Return):
                out.append((stmt, "return"))
            elif isinstance(stmt, ast.Break) and not in_loop:
                out.append((stmt, "break"))
            elif isinstance(stmt, ast.Continue) and not in_loop:
                out.append((stmt, "continue"))
            for name in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, name, None)
                if sub:
                    rec(sub, in_loop or isinstance(
                        stmt, (ast.While, ast.For, ast.AsyncFor)))
            for handler in getattr(stmt, "handlers", []) or []:
                rec(handler.body, in_loop)

    rec(finalbody, False)
    return out


# ---------------------------------------------------------------------------
# registry staleness (the WALL_CLOCK_SINKS non-vacuity contract)


def stale_silent_handlers(files: list[SourceFile],
                          registry: Optional[dict] = None
                          ) -> list[tuple[str, str]]:
    """SILENT_HANDLERS entries that no longer match a statically
    SILENT handler (the site vanished, or became loud — either way
    the justification describes nothing and must be deleted).
    Intrinsic loudness only: an entry whose handler went loud via a
    helper the callgraph resolves stays conservatively live."""
    registry = SILENT_HANDLERS if registry is None else registry
    stale = []
    for (suffix, handler_key) in registry:
        live = False
        for src in files:
            if src.tree is None or not src.relpath.endswith(suffix):
                continue
            aliases = import_aliases(src.tree)
            for site in module_handlers(src.tree, src.relpath):
                if site.handler_key != handler_key:
                    continue
                if not any(_node_loud(n, aliases) for n in
                           _walk_own_stmts(site.node.body)):
                    live = True
                break
            if live:
                break
        if not live:
            stale.append((suffix, handler_key))
    return stale


# ---------------------------------------------------------------------------
# entry point


def check(files: list[SourceFile],
          graph: Optional[CallGraph] = None) -> list[Finding]:
    graph = graph or build_callgraph(files)
    findings: list[Finding] = []
    findings += _check_handlers(files, graph)
    findings += _check_return_in_finally(files)
    return findings
