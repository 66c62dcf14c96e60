"""shapecheck — static shape, dtype and donation analysis over the port's
device roots.

The counterpart of the reference's ``analysis/shapecheck.py``, for torch
code. The port's device half runs under the same four conventions the
reference's kernel layer does: a donated table is never read again, the
bucket ladder is the ONE source of launch shapes, kernel state stays
32-bit, and ``prewarm`` walks every root the dispatch loop can reach.
Eager torch compiles nothing per shape, so where the reference found its
roots by collecting ``jax.jit`` objects, a "device root" here is one of
the functions ``testing/jitsan.py`` wraps (its ``_WRAPPED``), with the
argument it donates. This module keeps its own copy of that registry
(``DEVICE_ROOTS``; a lint module imports nothing it lints), and
``tests/test_torch_shapecheck.py`` holds the two equal.

The five rules keep the reference's ids, so that ``FAMILY_RULES`` and
finding keys read alike (jitsan kept ``jax_compiles_total`` for the
same reason); their messages speak of launches:

- ``donated-buffer-reuse``: a name passed as a twin's donated argument
  and read on any later path, or a donated table that is also a live
  input of the same call. Rebinding (the sidecar's rotate idiom) and
  tail calls are allowed; donation propagates through wrapper
  parameters.
- ``unladdered-jit-shape``: a launch-shape argument of a device root on
  the serving path (``ops``, ``parallel``, ``service``, ``tools``) that
  does not flow from a ladder source (``LADDER_SOURCES``), from a device
  root's output, or from a reviewed constant (``LADDERED_CALLS``).
- ``kernel-dtype-widen``: a 64-bit dtype inside a function reachable
  from a device root: ``.long()`` / ``.double()``, ``torch.int64`` /
  ``float64`` / ``long`` / ``double`` (also as ``dtype=`` or ``.to(...)``),
  an integer reduction (``sum`` / ``cumsum`` / ``cumprod`` / ``prod``)
  without ``dtype=`` (torch widens it to int64), and
  ``torch.tensor(<python number>)`` without ``dtype=``. An int64 value
  that reaches only the index arguments of torch's indexing calls
  (``INDEX_CALLS``: they take int64 indices only) is an index, not
  state; reviewed widens live in ``REVIEWED_WIDENS``.
- ``shape-mismatch``: ``torch.cat`` / ``torch.stack`` / ``torch.where``
  operands whose literal constructor shapes disagree.
- ``prewarm-coverage``: a device root reachable from a sidecar's
  dispatch loop (``DISPATCH_ROOTS``) but not from its prewarm
  (``PREWARM_ROOTS``); attribute-held edges are declared in
  ``PREWARM_INDIRECT``.

The runtime half is ``testing/jitsan.py``: its launch signatures stay
within ``ops/bucket_ladder.ladder_bounds``, and after ``prewarm`` the
serving rounds reach none the walk missed. ``infer_kernel_output`` is
this family's abstract (shape, dtype) signature of each root's output,
held against the plain versions' real outputs on the CPU.
"""
from __future__ import annotations

import ast
from typing import Optional

from .callgraph import CallGraph, build_callgraph
from .core import (
    Finding,
    SourceFile,
    dotted_path as _dotted,
)

# ---------------------------------------------------------------------------
# reviewed registries (every entry a deliberate, justified exception or
# blessing; widen with review only)

# (relpath suffix, qualname) -> (jitsan root, donated parameter or None,
# launch-shape parameters). The first two columns are jitsan's
# ``_WRAPPED``; the third names the arguments its launch signature reads
# (the tree window's is (route, docs, capacity): its program's steps are
# trimmed to the real ones, so only the table's shape counts).
DEVICE_ROOTS = {
    ("ops/merge_kernel.py", "apply_window"):
        ("apply_window", None, ("table", "batch")),
    ("ops/merge_kernel.py", "apply_window_pingpong"):
        ("apply_window_pingpong", "dead", ("dead", "table", "batch")),
    ("ops/merge_kernel.py", "pad_capacity"):
        ("pad_capacity", None, ("table", "new_capacity")),
    ("ops/merge_kernel.py", "compact"):
        ("compact", None, ("table",)),
    ("ops/merge_chunk.py", "apply_window_chunked"):
        ("chunked", None, ("table", "chunked", "K")),
    ("ops/merge_chunk.py", "apply_window_chunked_pingpong"):
        ("chunked_pingpong", "dead", ("dead", "table", "chunked", "K")),
    ("ops/event_graph.py", "apply_window_egwalker"):
        ("egwalker", None, ("table", "prefix", "K")),
    ("ops/event_graph.py", "apply_window_egwalker_pingpong"):
        ("egwalker_pingpong", "dead", ("dead", "table", "prefix", "K")),
    ("parallel/mesh_pool.py", "apply_window_mesh_sharded"):
        ("mesh_pool", None, ("table", "batch")),
    ("ops/shard_moves.py", "migrate_rows"):
        ("mesh_move", "table", ("table",)),
    ("parallel/seq_shard.py", "apply_window_seq_sharded"):
        ("seq_shard", None, ("table", "batch")),
    ("ops/tree_apply.py", "apply_tree_window"):
        ("tree_window", None, ("table",)),
    ("ops/tree_apply.py", "pad_tree_capacity"):
        ("tree_pad", None, ("table", "new_slots")),
}

# Path components where unladdered-jit-shape applies: the serving path.
# tests/ and chip_smoke.py launch deliberately exact-fit shapes (sweeps,
# shape-cliff measurements), a bounded number each; the storm the rule
# stops is an unladdered shape source where windows vary per flush.
LADDER_SCOPE_COMPONENTS = ("ops", "parallel", "service", "tools")

# (relpath suffix, qualname) whose RESULTS carry ladder-governed shapes:
# pack_rows buckets windows through BucketLadder; compile_chunks and
# build_event_graph rewrite a packed window shape for shape (the walker's
# prefix and suffix re-bucket through the ladder); lower_columns' block
# reaches the device only through pack_rows' block path; make_table's
# capacities are the ladder's rungs at every serving site (prewarm and
# the regrow walk capacity_rungs). The tree plane's pack_tree_window and
# make_tree_table are the same pair for the forest slab.
LADDER_SOURCES = (
    ("ops/host_bridge.py", "pack_rows"),
    ("ops/merge_chunk.py", "compile_chunks"),
    ("ops/event_graph.py", "build_event_graph"),
    ("ops/host_bridge.py", "lower_columns"),
    ("ops/segment_table.py", "make_table"),
    ("ops/tree_apply.py", "pack_tree_window"),
    ("ops/tree_apply.py", "make_tree_table"),
)

# Reviewed per-call-site exceptions: (module, caller qualname,
# "<root>[<slot>]") -> justification; each entry is exactly one
# suppressed finding key.
LADDERED_CALLS: dict[tuple[str, str, str], str] = {
    # K is the macro-step route's program-selection constant, not a
    # per-dispatch shape: these sites pass the module constant CHUNK_K
    # (or EG_K), one value per route, and prewarm launches through the
    # same K. A data-dependent K elsewhere is still flagged.
    ("gpu_sidecar.py", "SeqShardedPool._apply",
     "apply_window_chunked[K]"):
        "K=CHUNK_K module constant; SeqShardedPool.prewarm walks it",
    ("gpu_sidecar.py", "GpuMergeSidecar._apply_program",
     "apply_window_chunked_pingpong[K]"):
        "K=CHUNK_K module constant; prewarm walks the chunked route",
    ("gpu_sidecar.py", "GpuMergeSidecar._apply_program",
     "apply_window_egwalker_pingpong[K]"):
        "K=EG_K module constant; prewarm walks the egwalker route",
    ("mesh_pool.py", "MeshShardedPool._apply",
     "apply_window_chunked[K]"):
        "K=CHUNK_K module constant (one-shard chunked path); "
        "MeshShardedPool.prewarm walks it",
}

# Calls whose result is freshly allocated (never aliases an argument):
# names passed INTO them are not donated when the result is.
FRESH_CONSTRUCTORS = ("make_table", "make_tree_table")

# ---------------------------------------------------------------------------
# prewarm-coverage registries

# Dispatch-loop roots (relpath suffix -> qualnames): every device root
# reachable from these must also be reachable from the prewarm roots.
DISPATCH_ROOTS = {
    "service/gpu_sidecar.py": (
        "GpuMergeSidecar._dispatch",
        "GpuMergeSidecar._apply_program",
        "GpuMergeSidecar._settle",
        "GpuMergeSidecar._recover",
        "GpuMergeSidecar._grow",
        "GpuMergeSidecar.apply",
    ),
    "service/tree_sidecar.py": (
        "TreeSidecar._dispatch",
        "TreeSidecar._apply_dispatch",
        "TreeSidecar._settle",
        "TreeSidecar._recover",
        "TreeSidecar._grow",
        "TreeSidecar.apply",
    ),
}

PREWARM_ROOTS = {
    "service/gpu_sidecar.py": ("GpuMergeSidecar.prewarm",),
    "service/tree_sidecar.py": ("TreeSidecar.prewarm",),
}

# Edges the call graph cannot resolve syntactically (attribute-held
# objects, callbacks, methods of a local): (relpath suffix, caller
# qualname) -> ((relpath suffix, qualname), ...).
PREWARM_INDIRECT = {
    # the merge sidecar's pool, EITHER tier select_pool returns:
    # settle-boundary dispatch, recovery admission, the prewarm walk
    ("service/gpu_sidecar.py", "GpuMergeSidecar._settle"): (
        ("service/gpu_sidecar.py", "SeqShardedPool.dispatch_pending"),
        ("parallel/mesh_pool.py", "MeshShardedPool.dispatch_pending"),
    ),
    ("service/gpu_sidecar.py", "GpuMergeSidecar._admit_with_retry"): (
        ("service/gpu_sidecar.py", "SeqShardedPool.admit"),
        ("parallel/mesh_pool.py", "MeshShardedPool.admit"),
    ),
    ("service/gpu_sidecar.py", "GpuMergeSidecar._evict"): (
        ("service/gpu_sidecar.py", "SeqShardedPool.rebuild"),
        ("parallel/mesh_pool.py", "MeshShardedPool.rebuild"),
    ),
    ("service/gpu_sidecar.py", "GpuMergeSidecar._warm_pool"): (
        ("service/gpu_sidecar.py", "SeqShardedPool.prewarm"),
        ("parallel/mesh_pool.py", "MeshShardedPool.prewarm"),
    ),
    # replay_chunked receives a pool's _apply as a callback value
    ("ops/host_bridge.py", "replay_chunked"): (
        ("service/gpu_sidecar.py", "SeqShardedPool._apply"),
        ("parallel/mesh_pool.py", "MeshShardedPool._apply"),
    ),
    # the tree plane's pool, the same three edges
    ("service/tree_sidecar.py", "TreeSidecar._settle"): (
        ("service/tree_sidecar.py", "TreeSeqPool.dispatch_pending"),
    ),
    ("service/tree_sidecar.py", "TreeSidecar._admit_to_pool"): (
        ("service/tree_sidecar.py", "TreeSeqPool.admit"),
    ),
    ("service/tree_sidecar.py", "TreeSidecar._evict"): (
        ("service/tree_sidecar.py", "TreeSeqPool.rebuild"),
    ),
    ("service/tree_sidecar.py", "TreeSidecar._warm_pool"): (
        ("service/tree_sidecar.py", "TreeSeqPool.prewarm"),
    ),
    # a tree window launches through a _Dispatch held in a local or an
    # attribute (``dispatch.apply(table, route)``)
    ("service/tree_sidecar.py", "TreeSidecar._apply_dispatch"): (
        ("service/tree_sidecar.py", "_Dispatch.apply"),
    ),
    ("service/tree_sidecar.py", "TreeSidecar.prewarm"): (
        ("service/tree_sidecar.py", "_Dispatch.apply"),
    ),
    ("service/tree_sidecar.py", "TreeSeqPool._apply"): (
        ("service/tree_sidecar.py", "_Dispatch.apply"),
    ),
    ("service/tree_sidecar.py", "TreeSeqPool.prewarm"): (
        ("service/tree_sidecar.py", "_Dispatch.apply"),
    ),
}

# ---------------------------------------------------------------------------
# dtype-widen registry

WIDE_DTYPE_SUFFIXES = ("int64", "uint64", "float64", "complex128",
                       "long", "double", "longlong")
WIDE_DTYPE_STRINGS = ("int64", "uint64", "float64", "complex128")
# ``.to(int)`` / ``dtype=float``: the Python builtins mean 64 bits
WIDE_BUILTINS = ("int", "float")
# methods that cast to a 64-bit dtype
WIDE_CAST_METHODS = {"long": "long", "double": "double"}
# integer reductions torch widens to int64 unless given ``dtype=``
WIDENING_REDUCTIONS = ("sum", "cumsum", "cumprod", "prod")

# torch's indexing calls take int64 indices only: a widen whose value
# reaches nothing but their index arguments is an index, not state
INDEX_CALLS = ("gather", "scatter", "scatter_add", "scatter_reduce",
               "index_select", "index_fill", "index_copy", "index_add",
               "index_put", "take_along_dim", "take")

# Reviewed widens inside device-reachable code: finding key ->
# justification.
REVIEWED_WIDENS: dict[str, str] = {
    "merge_chunk.py:_finish:long":
        "the row sort key is a 64-bit composite (slot << 40 | offset, "
        "base and rank): one transient [D, R] key per macro-step, never "
        "table state",
    "merge_chunk.py:_macro_step:int64":
        "the remover-bit union is the reference's uint32 sum of "
        "distinct client bits: summed in int64 (dtype=torch.int64) and "
        "wrapped back to the int32 bit pattern of the removers field on "
        "the next lines; the table field stays int32",
    "merge_chunk.py:_macro_step:long":
        "the shift count of the same remover-bit union (a client "
        "ordinal, 0..31) widened to match its int64 operand",
}


# ===========================================================================
# shared helpers


def _functions(tree: ast.AST):
    """(qualname, node) for every def, class methods qualified."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, node))
            for sub in ast.walk(node):
                if sub is not node and isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append((f"{node.name}.{sub.name}", sub))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    out.append((f"{node.name}.{sub.name}", sub))
    return out


def _param_names(fn) -> list[str]:
    args = fn.args
    return [a.arg for a in
            list(args.posonlyargs) + list(args.args)
            + list(args.kwonlyargs)]


def _names_loaded(node: ast.AST) -> set[str]:
    return {
        n.id for n in ast.walk(node)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    }


def _call_target_names(call: ast.Call) -> list[str]:
    """The bare name or attribute tail a call dispatches through."""
    func = call.func
    if isinstance(func, ast.Name):
        return [func.id]
    if isinstance(func, ast.Attribute):
        return [func.attr]
    return []


def _target_names(tgt) -> set[str]:
    if isinstance(tgt, ast.Name):
        return {tgt.id}
    if isinstance(tgt, (ast.Tuple, ast.List)):
        out: set[str] = set()
        for e in tgt.elts:
            out |= _target_names(e)
        return out
    return set()


def _assigned_names(stmt: ast.stmt) -> set[str]:
    out: set[str] = set()
    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            out |= _target_names(tgt)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        if isinstance(stmt.target, ast.Name):
            out.add(stmt.target.id)
    elif isinstance(stmt, ast.For):
        out |= _target_names(stmt.target)
    return out


def _literal(node):
    if node is None:
        return None
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None


def _module(relpath: str) -> str:
    return relpath.rsplit("/", 1)[-1]


class _Index:
    """Per-run parse products, computed once per file: import aliases,
    the function list with qualified names, and each function's call
    sites."""

    def __init__(self, files: list[SourceFile], graph: CallGraph):
        self.files = files
        self.graph = graph
        self.aliases: dict[str, dict] = {}
        self.functions: dict[str, list] = {}
        self.calls: dict[int, list] = {}
        self.quals: dict[str, dict] = {}
        for src in files:
            if src.tree is None:
                continue
            # the graph's import map, relative imports made absolute
            self.aliases[src.relpath] = graph.module_aliases(src.relpath)
            fns = _functions(src.tree)
            self.functions[src.relpath] = fns
            self.quals[src.relpath] = {id(fn): qual for qual, fn in fns}
            for _, fn in fns:
                self.calls[id(fn)] = [
                    n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        # the fixpoints ask the same call sites again every iteration
        self._resolved: dict[tuple, list] = {}
        self._roots: dict[tuple, Optional[tuple]] = {}
        # root entries by bare name, for sites the graph cannot resolve
        self.root_by_name: dict[str, list] = {}
        for (suffix, qual), entry in DEVICE_ROOTS.items():
            self.root_by_name.setdefault(qual, []).append(
                (suffix, qual, entry))

    def resolve(self, call: ast.Call, caller, src: SourceFile) -> list:
        """``graph.resolve_call``, memoized per (call site, caller)."""
        key = (id(call), id(caller))
        out = self._resolved.get(key)
        if out is None:
            out = self._resolved[key] = self.graph.resolve_call(
                call, caller, src)
        return out

    def root_of(self, call: ast.Call, src: SourceFile,
                caller) -> Optional[tuple]:
        """(relpath suffix, qualname, registry entry, def node or None)
        of the device root a call launches, else None (memoized)."""
        key = (id(call), id(caller))
        if key not in self._roots:
            self._roots[key] = self._root_of(call, src, caller)
        return self._roots[key]

    def _root_of(self, call: ast.Call, src: SourceFile,
                 caller) -> Optional[tuple]:
        for target in self.resolve(call, caller, src):
            for (suffix, qual), entry in DEVICE_ROOTS.items():
                if target.qualname == qual and \
                        target.relpath.endswith(suffix):
                    return suffix, qual, entry, target.node
        for name in _call_target_names(call):
            for suffix, qual, entry in self.root_by_name.get(name, ()):
                module = suffix.rsplit("/", 1)[-1][:-3]
                if isinstance(call.func, ast.Name) and \
                        src.relpath.endswith(suffix):
                    return suffix, qual, entry, None
                dotted = _dotted(call.func, self.aliases.get(
                    src.relpath, {}))
                if dotted is not None and (
                        dotted.endswith(f"{module}.{qual}")):
                    return suffix, qual, entry, None
        return None


def _root_params(root: tuple) -> Optional[list[str]]:
    node = root[3]
    return _param_names(node) if node is not None else None


def _arg_for(call: ast.Call, params: Optional[list[str]], name: str,
             offset: int = 0) -> list[tuple[ast.expr, str]]:
    """The (expression, slot) a call passes for parameter ``name``."""
    out = [(kw.value, kw.arg) for kw in call.keywords if kw.arg == name]
    if params is not None and name in params:
        i = params.index(name) - offset
        if 0 <= i < len(call.args):
            out.append((call.args[i], str(i)))
    return out


# ===========================================================================
# rule: donated-buffer-reuse


class _DonationAnalysis:
    """Fixpoint over the call graph: which callables donate which
    parameters (the roots' donated argument, then every wrapper that
    forwards a parameter into one), then read-after-donation checks at
    every call site."""

    def __init__(self, idx: _Index):
        self.idx = idx
        self.graph = idx.graph
        # donating param names per (relpath, qualname)
        self.fn_donors: dict[tuple, set] = {}

    def donated_exprs(self, call: ast.Call, src: SourceFile,
                      caller_info) -> tuple[list, list]:
        """(donated argument expressions, the call's other argument
        expressions)."""
        donated: list = []
        root = self.idx.root_of(call, src, caller_info)
        if root is not None and root[2][1] is not None:
            params = _root_params(root)
            if params is None:
                # unresolved definition: the donated argument leads
                params = [root[2][1]]
            donated += [e for e, _ in _arg_for(call, params, root[2][1])]
        for target in self.idx.resolve(call, caller_info, src):
            names = self.fn_donors.get(target.key)
            if not names:
                continue
            params = _param_names(target.node)
            offset = 1 if params[:1] in (["self"], ["cls"]) else 0
            for name in names:
                donated += [e for e, _ in _arg_for(call, params, name,
                                                   offset)]
        ids = {id(e) for e in donated}
        others = [a for a in call.args if id(a) not in ids] + [
            kw.value for kw in call.keywords if id(kw.value) not in ids]
        return donated, others

    @staticmethod
    def donated_names(exprs: list) -> tuple[set, int]:
        """Names feeding donated argument expressions (a
        FRESH_CONSTRUCTORS call's subtree excluded, a called name, and a
        name that is only an attribute base: ``self._dead`` donates the
        attribute, which the pass treats as attribute-held state), with
        the line of the first donated argument."""
        names: set[str] = set()
        line = exprs[0].lineno if exprs else 0
        for expr in exprs:
            attr_bases = {
                id(n.value) for n in ast.walk(expr)
                if isinstance(n, ast.Attribute)
            }
            fresh_ids: set[int] = set()
            for node in ast.walk(expr):
                if isinstance(node, ast.Call) and \
                        id(node) not in fresh_ids and any(
                            t in FRESH_CONSTRUCTORS
                            for t in _call_target_names(node)):
                    fresh_ids.update(id(sub) for sub in ast.walk(node))
            # a name called (``ShardedTable([...])``) is a callable, not
            # a donated value: its arguments still are
            callees = {id(n.func) for n in ast.walk(expr)
                       if isinstance(n, ast.Call)}
            for node in ast.walk(expr):
                if id(node) in fresh_ids or id(node) in callees:
                    continue
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Load) and \
                        id(node) not in attr_bases:
                    names.add(node.id)
        return names, line

    def solve(self) -> None:
        changed = True
        while changed:
            changed = False
            for src in self.idx.files:
                if src.tree is None:
                    continue
                for qual, fn in self.idx.functions[src.relpath]:
                    params = set(_param_names(fn))
                    info = self.graph.info_for_node(fn)
                    for node in self.idx.calls[id(fn)]:
                        exprs, _ = self.donated_exprs(node, src, info)
                        if not exprs:
                            continue
                        names, _ = self.donated_names(exprs)
                        donated_params = names & params
                        if donated_params:
                            key = (src.relpath, qual)
                            have = self.fn_donors.setdefault(key, set())
                            if not donated_params <= have:
                                have |= donated_params
                                changed = True


def _reads_after_call(fn, call: ast.Call, names: set,
                      ) -> Optional[ast.Name]:
    """First Load of a donated name on any path after ``call`` inside
    ``fn``: sibling statements after the containing statement at every
    enclosing block level; when the call sits in a ``try`` body, the
    handlers, ``else`` and ``finally``; when it sits inside a loop, the
    loop body from the top (the wrap-around path). A top-level rebinding
    of a name kills its taint; rebindings inside nested branches do not
    (any-path semantics, a documented conservative approximation)."""
    spine: list[tuple[list, int]] = []

    def find(block: list) -> bool:
        for i, stmt in enumerate(block):
            if not any(n is call for n in ast.walk(stmt)):
                continue
            spine.append((block, i))
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub and find(sub):
                    return True
            for handler in getattr(stmt, "handlers", []):
                if find(handler.body):
                    return True
            return True
        return False

    if not find(fn.body):
        return None

    def scan(stmts, live: set) -> Optional[ast.Name]:
        for stmt in stmts:
            if not live:
                return None
            for node in ast.walk(stmt):
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Load) and \
                        node.id in live:
                    return node
            live.difference_update(_assigned_names(stmt))
        return None

    # a call in a ``return`` / ``raise`` ends the function: no sibling
    # runs after it (enclosing ``finally`` blocks and handlers still do)
    inner_block, inner_i = spine[-1]
    terminal = isinstance(inner_block[inner_i], (ast.Return, ast.Raise))
    is_raise = isinstance(inner_block[inner_i], ast.Raise)

    live = set(names)
    loops: list = []
    child_block: Optional[list] = None
    for block, i in reversed(spine):
        live.difference_update(_assigned_names(block[i]))
        stmt = block[i]
        if isinstance(stmt, ast.Try) and child_block is not None:
            in_handler = any(child_block is h.body for h in stmt.handlers)
            if child_block is stmt.body:
                if terminal and not is_raise:
                    post = [stmt.finalbody]
                elif is_raise:
                    post = [h.body for h in stmt.handlers] + \
                        [stmt.finalbody]
                else:
                    post = [h.body for h in stmt.handlers] + \
                        [stmt.orelse, stmt.finalbody]
            elif in_handler or child_block is stmt.orelse:
                post = [stmt.finalbody]
            else:
                post = []
            for branch in post:
                hit = scan(branch, set(live))
                if hit is not None:
                    return hit
        if not terminal:
            hit = scan(block[i + 1:], live)
            if hit is not None:
                return hit
        owner = next(
            (st for st in ast.walk(fn)
             if getattr(st, "body", None) is block
             or getattr(st, "orelse", None) is block
             or getattr(st, "finalbody", None) is block
             or any(getattr(h, "body", None) is block
                    for h in getattr(st, "handlers", []))),
            None,
        )
        if not terminal and isinstance(
                owner, (ast.For, ast.While, ast.AsyncFor)):
            # the taint that survives to the end of the loop body (the
            # rotate idiom ``dead = pingpong(dead, ...)`` has killed it)
            loops.append((block, i, set(live)))
        child_block = block
    for block, i, survived in loops:
        hit = scan(block[:i], survived)
        if hit is not None:
            return hit
    return None


def _check_donated(idx: _Index) -> list[Finding]:
    ana = _DonationAnalysis(idx)
    ana.solve()
    findings: list[Finding] = []
    for src in idx.files:
        if src.tree is None:
            continue
        module = _module(src.relpath)
        for qual, fn in idx.functions[src.relpath]:
            info = idx.graph.info_for_node(fn)
            for node in idx.calls[id(fn)]:
                exprs, others = ana.donated_exprs(node, src, info)
                if not exprs:
                    continue
                names, line = ana.donated_names(exprs)
                if not names:
                    continue
                other_names: set[str] = set()
                for expr in others:
                    other_names |= _names_loaded(expr)
                overlap = names & other_names
                if overlap:
                    nm = sorted(overlap)[0]
                    findings.append(Finding(
                        rule="donated-buffer-reuse",
                        path=src.relpath, line=line,
                        message=(
                            f"{nm!r} is passed both as a DONATED "
                            "argument and as a live input in the same "
                            "launch: the twin writes its output over "
                            "storage the kernel still reads"
                        ),
                        key=f"{module}:{qual}:{nm}",
                    ))
                    continue
                hit = _reads_after_call(fn, node, names)
                if hit is not None:
                    findings.append(Finding(
                        rule="donated-buffer-reuse",
                        path=src.relpath, line=hit.lineno,
                        message=(
                            f"{hit.id!r} is read after being donated to "
                            f"a donating twin (call at line {line}): its "
                            "storage may already hold that launch's "
                            "output; drop every reference after donating"
                        ),
                        key=f"{module}:{qual}:{hit.id}",
                    ))
    return findings


# ===========================================================================
# rule: unladdered-jit-shape


def _in_ladder_scope(relpath: str) -> bool:
    parts = relpath.split("/")
    return any(p in LADDER_SCOPE_COMPONENTS for p in parts[:-1])


_LADDERED = "laddered"
_OK = "ok"      # attribute-held / None / unresolvable: trusted
_RAW = "raw"    # provably not ladder-derived


class _LadderAnalysis:
    def __init__(self, idx: _Index):
        self.idx = idx
        self.graph = idx.graph
        self._env_cache: dict[int, dict] = {}
        # shape-determining param names per (relpath, qualname)
        self.shape_params: dict[tuple, set] = {}

    def _is_source_call(self, call: ast.Call, src: SourceFile,
                        caller_info, aliases: dict) -> bool:
        dotted = _dotted(call.func, aliases)
        if dotted is not None and "BucketLadder" in dotted.split("."):
            return True
        for target in self.idx.resolve(call, caller_info, src):
            for suffix, qual in LADDER_SOURCES:
                if target.relpath.endswith(suffix) and \
                        target.qualname == qual:
                    return True
        # a device root's OUTPUT is launch-shaped
        if self.idx.root_of(call, src, caller_info) is not None:
            return True
        if isinstance(call.func, ast.Name) and any(
                qual == call.func.id for _, qual in LADDER_SOURCES):
            # bare-name fallback for trees the graph cannot resolve
            return True
        return False

    def classify(self, expr: ast.expr, src: SourceFile, fn,
                 caller_info, aliases: dict,
                 env: dict) -> tuple[str, set]:
        """-> (verdict, the parameter names the expression derives
        from)."""
        params: set = set()
        found = {"laddered": False, "raw_leaf": False}
        fn_params = set(_param_names(fn))

        def walk(node, bound: frozenset = frozenset()) -> None:
            if isinstance(node, ast.Call):
                if self._is_source_call(node, src, caller_info, aliases):
                    found["laddered"] = True
                    return
                for sub in list(node.args) + [
                        k.value for k in node.keywords]:
                    walk(sub, bound)
                if isinstance(node.func, ast.Call):
                    walk(node.func, bound)
                elif isinstance(node.func, ast.Attribute):
                    # a method call's result derives from its receiver;
                    # a module attribute's base is an import, not a value
                    root = node.func.value
                    while isinstance(root, ast.Attribute):
                        root = root.value
                    if not (isinstance(root, ast.Name)
                            and root.id in aliases):
                        walk(node.func.value, bound)
                return
            if isinstance(node, ast.Attribute):
                return  # attribute-held state: trusted
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    if node.id in bound:
                        pass
                    elif node.id in fn_params:
                        params.add(node.id)
                    elif node.id in env:
                        verdict, p = env[node.id]
                        if verdict == _LADDERED:
                            found["laddered"] = True
                        elif verdict == _RAW:
                            found["raw_leaf"] = True
                        params.update(p)
                    else:
                        found["raw_leaf"] = True
                return
            if isinstance(node, ast.Constant):
                return
            if isinstance(node, (ast.ListComp, ast.SetComp,
                                 ast.GeneratorExp, ast.DictComp)):
                inner = set(bound)
                for gen in node.generators:
                    walk(gen.iter, frozenset(inner))
                    inner |= {
                        n.id for n in ast.walk(gen.target)
                        if isinstance(n, ast.Name)
                    }
                    for cond in gen.ifs:
                        walk(cond, frozenset(inner))
                if isinstance(node, ast.DictComp):
                    walk(node.key, frozenset(inner))
                    walk(node.value, frozenset(inner))
                else:
                    walk(node.elt, frozenset(inner))
                return
            if isinstance(node, (ast.Tuple, ast.List, ast.Dict,
                                 ast.Set, ast.IfExp, ast.BinOp,
                                 ast.Subscript, ast.Starred,
                                 ast.Compare, ast.BoolOp, ast.UnaryOp,
                                 ast.FormattedValue, ast.JoinedStr,
                                 ast.Slice)):
                for child in ast.iter_child_nodes(node):
                    walk(child, bound)
                return
            return  # anything else: trusted rather than misflagged

        walk(expr)
        if found["laddered"]:
            return _LADDERED, set()
        if params:
            return "param", params
        if found["raw_leaf"]:
            return _RAW, set()
        return _OK, set()

    def _local_env(self, fn, src: SourceFile, caller_info,
                   aliases: dict) -> dict:
        """name -> (verdict, params) from assignments, loop targets and
        comprehension targets in textual order (last binding wins).
        Memoized per def."""
        cached = self._env_cache.get(id(fn))
        if cached is not None:
            return cached
        env: dict = {}
        binds = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                binds.append((node, node.value, node.targets))
            elif isinstance(node, ast.For):
                binds.append((node, node.iter, [node.target]))
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.GeneratorExp, ast.DictComp)):
                # a launch inside a comprehension reads its targets
                for gen in node.generators:
                    binds.append((node, gen.iter, [gen.target]))
        binds.sort(key=lambda b: (b[0].lineno, b[0].col_offset))
        for _node, value, targets in binds:
            verdict, params = self.classify(
                value, src, fn, caller_info, aliases, env)
            for tgt in targets:
                for name in _target_names(tgt):
                    env[name] = (verdict, params)
        self._env_cache[id(fn)] = env
        return env

    def shape_slots(self, call: ast.Call, src: SourceFile, caller_info
                    ) -> tuple[list, Optional[str]]:
        """([(argument expression, slot)], display name) of a call's
        launch-shape arguments; ([], None) when the target launches
        nothing shape-constrained."""
        root = self.idx.root_of(call, src, caller_info)
        if root is not None:
            params = _root_params(root)
            slots = []
            for name in root[2][2]:
                slots += _arg_for(call, params, name)
            return slots, root[1]
        slots, display = [], None
        for target in self.idx.resolve(call, caller_info, src):
            names = self.shape_params.get(target.key)
            if not names:
                continue
            display = target.name
            tparams = _param_names(target.node)
            offset = 1 if tparams[:1] in (["self"], ["cls"]) else 0
            for name in sorted(names):
                slots += _arg_for(call, tparams, name, offset)
        return slots, display

    def solve(self) -> None:
        changed = True
        while changed:
            changed = False
            for src in self.idx.files:
                if src.tree is None:
                    continue
                aliases = self.idx.aliases[src.relpath]
                for qual, fn in self.idx.functions[src.relpath]:
                    info = self.graph.info_for_node(fn)
                    for node in self.idx.calls[id(fn)]:
                        slots, _ = self.shape_slots(node, src, info)
                        for arg, _slot in slots:
                            env = self._local_env(fn, src, info, aliases)
                            verdict, params = self.classify(
                                arg, src, fn, info, aliases, env)
                            if verdict != "param":
                                continue
                            key = (src.relpath, qual)
                            have = self.shape_params.setdefault(key, set())
                            if not params <= have:
                                have |= params
                                changed = True


def _check_unladdered(idx: _Index) -> list[Finding]:
    ana = _LadderAnalysis(idx)
    ana.solve()
    findings: list[Finding] = []
    for src in idx.files:
        if src.tree is None or not _in_ladder_scope(src.relpath):
            continue
        aliases = idx.aliases[src.relpath]
        module = _module(src.relpath)
        for qual, fn in idx.functions[src.relpath]:
            info = idx.graph.info_for_node(fn)
            for node in idx.calls[id(fn)]:
                slots, display = ana.shape_slots(node, src, info)
                for arg, slot in slots:
                    env = ana._local_env(fn, src, info, aliases)
                    verdict, _p = ana.classify(
                        arg, src, fn, info, aliases, env)
                    if verdict != _RAW:
                        continue
                    entry = f"{display}[{slot}]"
                    if (module, qual, entry) in LADDERED_CALLS:
                        continue
                    findings.append(Finding(
                        rule="unladdered-jit-shape",
                        path=src.relpath, line=arg.lineno,
                        message=(
                            f"argument {slot} of the device root "
                            f"{display}() does not flow from the "
                            "BucketLadder: every distinct shape here is "
                            "a launch signature prewarm never walked "
                            "(and that the ladder bounds do not hold); "
                            "pack through pack_rows / compile_chunks or a "
                            "BucketLadder bucket, or register a reviewed "
                            "exception in shapecheck.LADDERED_CALLS"
                        ),
                        key=f"{module}:{qual}:{entry}",
                    ))
    return findings


# ===========================================================================
# rules: kernel-dtype-widen + shape-mismatch (device-reachable bodies)


def _device_reachable(idx: _Index) -> list:
    """(src, fn, aliases) for every function reachable from a device
    root through the shared call graph (roots included) or passed as a
    value by one it reaches."""
    graph = idx.graph
    queue = [info for info in graph.functions()
             if any(info.qualname == qual and info.relpath.endswith(suffix)
                    for suffix, qual in DEVICE_ROOTS)]
    seen: dict[int, object] = {}
    while queue:
        info = queue.pop()
        if id(info.node) in seen:
            continue
        seen[id(info.node)] = info
        queue.extend(graph.callees(info))
        # a function passed as a value (``run_macro_steps(..., _macro_step,
        # ...)``) runs on the device path too
        called = {id(n.func) for n in ast.walk(info.node)
                  if isinstance(n, ast.Call)}
        for node in ast.walk(info.node):
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Load) and \
                    id(node) not in called:
                queue.extend(graph.resolve_call(
                    ast.Call(func=node, args=[], keywords=[]), info,
                    info.src))
    return [(info.src, info.node, idx.aliases[info.relpath])
            for info in seen.values() if info.src.tree is not None]


def _wide_dtype_of(node: ast.expr, aliases: dict,
                   builtins: bool = False) -> Optional[str]:
    """The 64-bit dtype a node denotes, if any. The bare ``int`` /
    ``float`` builtins count only in dtype positions (``.to(int)``,
    ``dtype=float``): a plain ``int(x)`` is host scalar arithmetic."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in WIDE_DTYPE_STRINGS else None
    if isinstance(node, ast.Name) and node.id in WIDE_BUILTINS:
        return node.id if builtins else None
    dotted = _dotted(node, aliases)
    if dotted is not None and "." in dotted and \
            dotted.rsplit(".", 1)[-1] in WIDE_DTYPE_SUFFIXES:
        return dotted
    return None


def _number(node) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Constant) and \
        type(node.value) in (int, float)


def _widens(node: ast.Call, aliases: dict) -> list[str]:
    """The 64-bit dtypes one call produces (short names)."""
    hits: list[str] = []
    has_dtype = any(kw.arg == "dtype" for kw in node.keywords)
    # torch.int64(x) / np.float64(x) cast-call forms (not the builtins)
    wide = _wide_dtype_of(node.func, aliases)
    if wide is not None:
        hits.append(wide)
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in WIDE_CAST_METHODS and not node.args:
            hits.append(WIDE_CAST_METHODS[attr])
        if attr in ("to", "type", "astype") and node.args:
            for arg in node.args:
                wide = _wide_dtype_of(arg, aliases, builtins=True)
                if wide is not None:
                    hits.append(wide)
        if attr in WIDENING_REDUCTIONS and not has_dtype:
            hits.append(attr)
        dotted = _dotted(node.func, aliases)
        if dotted == "torch.tensor" and node.args and \
                _number(node.args[0]) and not has_dtype:
            hits.append("tensor")
    for kw in node.keywords:
        if kw.arg == "dtype":
            wide = _wide_dtype_of(kw.value, aliases, builtins=True)
            if wide is not None:
                hits.append(wide)
    return [h.rsplit(".", 1)[-1] for h in hits]


def _index_only(fn) -> set[int]:
    """Ids of the nodes in ``fn`` whose value reaches nothing but the
    index arguments of torch's indexing calls (``INDEX_CALLS``): the
    nodes inside those arguments, and the value of a name every read of
    which lies inside one."""
    inside: set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                _call_target_names(node)[:1] and \
                _call_target_names(node)[0] in INDEX_CALLS:
            for arg in list(node.args) + [k.value for k in node.keywords]:
                inside.update(id(sub) for sub in ast.walk(arg))
    loads: dict[str, list] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            loads.setdefault(node.id, []).append(node)
    out = set(inside)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            uses = loads.get(node.targets[0].id, [])
            if uses and all(id(u) in inside for u in uses):
                out.update(id(sub) for sub in ast.walk(node.value))
    return out


def _check_dtype_widen(reachable: list, quals: dict) -> list[Finding]:
    findings: list[Finding] = []
    emitted: set = set()
    for src, fn, aliases in reachable:
        module = _module(src.relpath)
        qual = quals.get(src.relpath, {}).get(id(fn), fn.name)
        index_only = _index_only(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or id(node) in index_only:
                continue
            for short in _widens(node, aliases):
                key = f"{module}:{qual}:{short}"
                if key in emitted or key in REVIEWED_WIDENS:
                    continue
                emitted.add(key)
                what = (f"{short}() without dtype= (an integer "
                        "reduction torch widens to int64)"
                        if short in WIDENING_REDUCTIONS
                        else "torch.tensor() of a python number without "
                        "dtype= (int64 / float64)" if short == "tensor"
                        else f"64-bit dtype {short}")
                findings.append(Finding(
                    rule="kernel-dtype-widen",
                    path=src.relpath, line=node.lineno,
                    message=(
                        f"{what} inside {qual}(), reachable from a device "
                        "root: a widened table field doubles the bytes "
                        "every launch that touches it moves (and upcasts "
                        "whatever mixes with it); keep kernel state "
                        "int32 / float32, or register a reviewed widen "
                        "in shapecheck.REVIEWED_WIDENS"
                    ),
                    key=key,
                ))
    return findings


_SHAPE_CTORS = ("zeros", "ones", "full", "empty")
_CONCATS = ("cat", "concat", "concatenate", "stack")


def _dim_desc(node: ast.expr):
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return ("lit", node.value)
    return ("sym", ast.dump(node))


def _shape_of_call(call: ast.Call, aliases: dict) -> Optional[tuple]:
    dotted = _dotted(call.func, aliases)
    if dotted is None:
        return None
    leaf = dotted.rsplit(".", 1)[-1]
    if leaf == "arange":
        # only the one-argument form's length is its argument
        return (_dim_desc(call.args[0]),) if len(call.args) == 1 else None
    if leaf not in _SHAPE_CTORS or not call.args:
        return None
    first = call.args[0]
    if isinstance(first, (ast.Tuple, ast.List)):
        return tuple(_dim_desc(e) for e in first.elts)
    if leaf == "full":
        return (_dim_desc(first),)
    # torch's varargs form: torch.zeros(4, 8)
    return tuple(_dim_desc(e) for e in call.args)


def _lit_conflict(a, b) -> bool:
    return a[0] == "lit" and b[0] == "lit" and a[1] != b[1]


def _check_shape_mismatch(reachable: list, quals: dict) -> list[Finding]:
    findings: list[Finding] = []
    for src, fn, aliases in reachable:
        module = _module(src.relpath)
        qual = quals.get(src.relpath, {}).get(id(fn), fn.name)
        env: dict[str, tuple] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                shape = _shape_of_call(node.value, aliases)
                if shape is not None:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            env[tgt.id] = shape

        def known(e: ast.expr) -> Optional[tuple]:
            if isinstance(e, ast.Call):
                return _shape_of_call(e, aliases)
            if isinstance(e, ast.Name):
                return env.get(e.id)
            return None

        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func, aliases)
            leaf = dotted.rsplit(".", 1)[-1] if dotted else None
            if leaf in _CONCATS and node.args and \
                    isinstance(node.args[0], (ast.Tuple, ast.List)):
                # the axis arrives by keyword (dim= / axis=) or
                # positionally; a non-literal axis skips the per-axis
                # comparison (the rank check stands)
                axis_expr = next(
                    (k.value for k in node.keywords
                     if k.arg in ("dim", "axis")),
                    node.args[1] if len(node.args) > 1 else None)
                axis = 0 if axis_expr is None else _literal(axis_expr)
                joins = leaf != "stack"
                shapes = [(e, known(e)) for e in node.args[0].elts]
                shapes = [(e, s) for e, s in shapes if s is not None]
                for (_e1, s1), (_e2, s2) in zip(shapes, shapes[1:]):
                    if len(s1) != len(s2):
                        findings.append(Finding(
                            rule="shape-mismatch",
                            path=src.relpath, line=node.lineno,
                            message=(
                                f"{leaf}() operands have rank {len(s1)} "
                                f"vs {len(s2)}: inferred operand shapes "
                                "disagree"
                            ),
                            key=(f"{module}:{qual}:{leaf}:"
                                 f"rank{len(s1)}v{len(s2)}"),
                        ))
                        break
                    if joins and not isinstance(axis, int):
                        continue
                    norm = axis % max(len(s1), 1) \
                        if s1 and isinstance(axis, int) else 0
                    for d, (da, db) in enumerate(zip(s1, s2)):
                        if joins and d == norm:
                            continue
                        if _lit_conflict(da, db):
                            findings.append(Finding(
                                rule="shape-mismatch",
                                path=src.relpath, line=node.lineno,
                                message=(
                                    f"{leaf}() operands disagree on axis "
                                    f"{d}: {da[1]} vs {db[1]} (inferred "
                                    "from their constructors)"
                                ),
                                key=(f"{module}:{qual}:{leaf}:"
                                     f"ax{d}:{da[1]}v{db[1]}"),
                            ))
                            break
            elif leaf == "where" and len(node.args) == 3:
                s2, s3 = known(node.args[1]), known(node.args[2])
                if s2 is None or s3 is None:
                    continue
                for off in range(1, min(len(s2), len(s3)) + 1):
                    da, db = s2[-off], s3[-off]
                    if _lit_conflict(da, db) and 1 not in (da[1], db[1]):
                        findings.append(Finding(
                            rule="shape-mismatch",
                            path=src.relpath, line=node.lineno,
                            message=(
                                "where() branches do not broadcast: "
                                f"trailing axis -{off} is {da[1]} vs "
                                f"{db[1]}"
                            ),
                            key=(f"{module}:{qual}:where:"
                                 f"{da[1]}v{db[1]}"),
                        ))
                        break
    return findings


# ===========================================================================
# rule: prewarm-coverage


def _reachable_roots(idx: _Index, registry: dict) -> set[tuple]:
    """(relpath, qualname) of the device roots a path from the registry's
    functions reaches, through the shared call graph plus the declared
    ``PREWARM_INDIRECT`` edges."""
    graph = idx.graph
    fn_index: dict[tuple, list] = {}
    for info in graph.functions():
        fn_index.setdefault(info.qualname, []).append(info)

    def lookup(suffix: str, qual: str) -> list:
        return [info for info in fn_index.get(qual, ())
                if info.relpath.endswith(suffix)]

    queue = [info for suffix, quals in registry.items()
             for qual in quals for info in lookup(suffix, qual)]
    indirect: dict[str, list] = {}
    for (suffix, qual), targets in PREWARM_INDIRECT.items():
        indirect.setdefault(qual, []).append((suffix, targets))
    roots: set[tuple] = set()
    seen: set[int] = set()
    while queue:
        info = queue.pop()
        if id(info.node) in seen:
            continue
        seen.add(id(info.node))
        for suffix, qual in DEVICE_ROOTS:
            if info.qualname == qual and info.relpath.endswith(suffix):
                roots.add(info.key)
        queue.extend(graph.callees(info))
        for suffix, targets in indirect.get(info.qualname, ()):
            if info.relpath.endswith(suffix):
                for tsuffix, tqual in targets:
                    queue.extend(lookup(tsuffix, tqual))
    return roots


def _check_prewarm_coverage(idx: _Index) -> list[Finding]:
    # only when a registered dispatch-loop module is in the scan
    if not any(src.relpath.endswith(suffix)
               for src in idx.files for suffix in DISPATCH_ROOTS):
        return []
    dispatch = _reachable_roots(idx, DISPATCH_ROOTS)
    warmed = _reachable_roots(idx, PREWARM_ROOTS)
    by_key = {info.key: info for info in idx.graph.functions()}
    findings: list[Finding] = []
    for relpath, qual in sorted(dispatch - warmed):
        info = by_key.get((relpath, qual))
        findings.append(Finding(
            rule="prewarm-coverage",
            path=relpath, line=info.node.lineno if info else 1,
            message=(
                f"device root {qual!r} is reachable from a sidecar's "
                "dispatch loop but NOT from its BucketLadder prewarm: its "
                "first launch signature is reached mid-serve, where the "
                "walk never built or warmed it; walk it in prewarm or "
                "route it through a walked root"
            ),
            key=f"{_module(relpath)}:{qual}",
        ))
    return findings


def prewarm_reach(files: list[SourceFile],
                  graph=None) -> tuple[set, set]:
    """The jitsan root names a dispatch loop can reach and those a
    prewarm walks (a donating twin counts with its plain form, the name
    jitsan gives it when it is handed no table to donate): what a
    runtime run's launch signatures are held to."""
    idx = _Index(files, graph or build_callgraph(files))

    def names(keys: set) -> set:
        out: set = set()
        for relpath, qual in keys:
            for (suffix, q), (root, _d, _s) in DEVICE_ROOTS.items():
                if q == qual and relpath.endswith(suffix):
                    out |= {root, root.replace("_pingpong", "")}
        return out

    return (names(_reachable_roots(idx, DISPATCH_ROOTS)),
            names(_reachable_roots(idx, PREWARM_ROOTS)))


# ===========================================================================
# the abstract output signature the static-signature tests pin


# roots whose output has the input table's shapes and dtypes
_IDENTITY_ROOTS = (
    "apply_window", "apply_window_pingpong", "chunked", "chunked_pingpong",
    "egwalker", "egwalker_pingpong", "compact", "seq_shard", "mesh_pool",
    "mesh_move", "tree_window",
)
# pad roots: (the field whose axis 1 is the capacity, the fields it
# widens; None: every field whose axis 1 is the capacity)
_PAD_ROOTS = {
    "pad_capacity": ("length", None),
    "tree_pad": ("content", ("content", "value")),
}


def infer_kernel_output(root: str, spec: dict,
                        new_capacity: Optional[int] = None) -> dict:
    """Abstract output signature of one device root. ``spec`` maps field
    name -> (shape tuple, dtype string) for the root's table input; the
    return value is the same structure for its output. The window roots
    are shape- and dtype-preserving by contract; ``pad_capacity`` and
    ``tree_pad`` widen the slot axis (axis 1) to ``new_capacity``."""
    if root in _IDENTITY_ROOTS:
        return {f: (tuple(shape), dtype)
                for f, (shape, dtype) in spec.items()}
    if root in _PAD_ROOTS:
        if new_capacity is None:
            raise ValueError(f"{root} needs new_capacity")
        field, widened = _PAD_ROOTS[root]
        old = spec[field][0][1]
        out = {}
        for f, (shape, dtype) in spec.items():
            shape = tuple(shape)
            if len(shape) >= 2 and shape[1] == old and (
                    widened is None or f in widened):
                shape = shape[:1] + (new_capacity,) + shape[2:]
            out[f] = (shape, dtype)
        return out
    raise ValueError(f"unknown kernel root {root!r}")


# ===========================================================================
# entry point


def check(files: list[SourceFile], graph=None) -> list[Finding]:
    graph = graph or build_callgraph(files)
    idx = _Index(files, graph)
    reach = _device_reachable(idx)
    findings = []
    findings += _check_donated(idx)
    findings += _check_unladdered(idx)
    # findings key on qualified names: same-named methods of two classes
    # must not collapse
    findings += _check_dtype_widen(reach, idx.quals)
    findings += _check_shape_mismatch(reach, idx.quals)
    findings += _check_prewarm_coverage(idx)
    return findings
