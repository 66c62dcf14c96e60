"""detcheck — determinism-provenance analysis over the service plane.

Every proof this repo ships — the 20-seed chaos convergence
differentials, bit-equal storm reruns, config9's five-run equality,
the failover oracle — depends on one unstated invariant: no wall-clock
read and no unseeded RNG draw on a deterministic-contract path. The
qos/slo layers already model the discipline (``clock=`` injection,
``FaultSchedule.rng_for`` seed streams); this family makes the
invariant machine-checked everywhere, by a clock/RNG-provenance pass
over the shared callgraph:

- **wall-clock-unrouted** — a direct ``time.time()`` /
  ``time.monotonic()`` / ``time.perf_counter()`` /
  ``datetime.now()``-family call in a function reachable from the
  deterministic-contract roots (sequencer ticketing, qos/slo grading,
  replication/lease, the chaos harness, serve_bench, partitioning)
  that does not flow from an injectable ``clock=`` parameter.
  Telemetry/obs timestamps are legitimately wall-clock — they live in
  the reviewed :data:`WALL_CLOCK_SINKS` registry (per function, with
  justification), NOT in the allowlist.
- **unseeded-rng** — ``random.Random()`` with no seed, module-level
  ``random.*`` draws (the process-global unseeded stream), or
  ``np.random.*`` without seed provenance, anywhere in a
  deterministic-plane component.
- **iteration-order-leak** — a ``set`` (or a value derived from set
  ops) iterated into an order-sensitive sink: a fan-out/append/send
  loop, ``list()``/``tuple()`` materialization, a ``join`` or an
  ordered comprehension. Set iteration order varies per process
  (PYTHONHASHSEED); ``sorted(...)`` is the one-word fix and kills the
  taint.
- **hash-order-dependence** — builtin ``hash()`` of str/bytes feeding
  ordering or partition selection (``hash(x) % n``). str/bytes hashes
  are salted per process since PEP 456; use ``zlib.crc32`` / hashlib
  (the ``partitioning.partition_for`` idiom). ``__hash__``
  implementations are exempt — in-process dict identity is fine, the
  hazard is cross-run ordering.

The runtime cross-check is ``testing/detsan.py`` (the
concheck<->fluidsan pattern): patched
``time``/``random`` entry points observe the reads that actually
happen, and the differential test (tests/test_detsan.py) pins every
runtime-observed un-routed site to a static finding or a registry
entry while driving the real chaos sweep and a serve_bench slice — a
gap fails BY NAME as an analyzer-resolution gap.

Like every fluidlint pass, this module imports NOTHING it lints:
resolution is pure AST over the shared callgraph.
"""
from __future__ import annotations

import ast
from typing import Optional

from .callgraph import CallGraph, build_callgraph
from .core import (
    Finding,
    SourceFile,
    dotted_path as _dotted,
    import_aliases,
)

# ---------------------------------------------------------------------------
# reviewed registries

# Direct wall-clock reads the pass recognizes (absolute stdlib dotted
# paths after alias substitution, matching import_aliases
# relative="skip").
WALL_CLOCK_CALLS = frozenset((
    "time.time", "time.monotonic", "time.perf_counter",
    "time.time_ns", "time.monotonic_ns", "time.perf_counter_ns",
    "time.process_time", "time.process_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
))

# Deterministic-contract roots (relpath suffix -> qualnames, "*" =
# every function in the module): the entry points whose transitive
# callees must never read the wall clock un-routed. These are the
# planes the convergence proofs pin: sequencer ticketing (python and
# native), the ordering/replication/partitioning stack, qos/slo
# grading, the chaos harness, and the serving benchmark.
DETERMINISTIC_ROOTS = {
    "service/sequencer.py": ("*",),
    "native/sequencer_core.py": ("*",),
    "service/local_orderer.py": ("*",),
    "service/local_server.py": ("*",),
    "service/replication.py": ("*",),
    "service/partitioning.py": ("*",),
    # the client half of the replay contract: crash-recovery
    # differentials replay THROUGH Containers (batch integrity, msn
    # heartbeats, slice deadlines), and the callgraph cannot see the
    # harness's attribute-held dispatch into them — roots, not edges
    "loader/container.py": ("*",),
    "loader/collab_window.py": ("*",),
    "loader/scheduler.py": ("*",),
    "obs/slo.py": ("*",),
    "qos/admission.py": ("*",),
    "qos/breaker.py": ("*",),
    "qos/pressure.py": ("*",),
    "qos/rate_limiter.py": ("*",),
    "qos/policy.py": ("*",),
    "testing/chaos.py": ("*",),
    "tools/serve_bench.py": ("*",),
}

# Call edges the shared graph cannot resolve syntactically
# (attribute-held objects), declared like concurrency.INDIRECT_CALLS:
#   (relpath suffix, caller qualname) -> ((relpath suffix, qualname), ...)
DETERMINISTIC_INDIRECT = {
    # the chaos harness replays the durable log into the sidecar it
    # holds by attribute; serve_bench drives its sidecar rounds the
    # same way
    ("testing/chaos.py", "ChaosHarness.crash"): (
        ("service/gpu_sidecar.py", "GpuMergeSidecar.ingest"),
    ),
    ("testing/chaos.py", "ChaosHarness._build_sidecar"): (
        ("service/gpu_sidecar.py", "GpuMergeSidecar.subscribe"),
    ),
    ("tools/serve_bench.py", "run_serve_bench"): (
        ("service/gpu_sidecar.py", "GpuMergeSidecar.ingest"),
        ("service/gpu_sidecar.py", "GpuMergeSidecar.apply"),
        ("service/gpu_sidecar.py", "GpuMergeSidecar.prewarm"),
    ),
}

# Reviewed wall-clock sinks: (relpath suffix, qualname or "*") ->
# justification. Telemetry and observability TIMESTAMP/duration reads
# are legitimately wall-clock — the contract is that nothing
# deterministic derives from them (deterministic_fields excludes
# them, trace timestamps never feed ordering). This is a REGISTRY,
# not an allowlist: every entry is a reviewed design decision, the
# gate test fails if an entry goes stale (no wall-clock call left at
# the site), and a new un-routed read anywhere else still fails the
# gate.
WALL_CLOCK_SINKS: dict[tuple[str, str], str] = {
    ("obs/trace.py", "stamp"):
        "wire-hop trace timestamps are observability metadata; "
        "deterministic callers (sequencer, sidecar) pass timestamp= "
        "from their injected clock",
    ("obs/profiler.py", "*"):
        "the sampling profiler measures wall time by definition",
    ("utils/telemetry.py", "*"):
        "duration telemetry (PerformanceEvent timers) measures wall "
        "time by definition",
    ("service/telemetry.py", "*"):
        "Lumberjack event timestamps/durations are log metadata",
    ("service/tenancy.py", "sign_token"):
        "token iat/exp are wall-clock validity by protocol design",
    ("service/tenancy.py", "TenantManager.validate_token"):
        "token expiry check is wall-clock validity by design",
    ("drivers/caching_driver.py", "SnapshotCache.put"):
        "cache entry freshness (cached_at) is wall-clock by design",
    ("drivers/caching_driver.py",
     "CachingDocumentService.get_latest_summary"):
        "cache age check against max_age_s is wall-clock by design",
    ("service/gpu_sidecar.py", "GpuMergeSidecar.prewarm"):
        "prewarm returns measured warmup wall seconds (obs only)",
    ("service/gpu_sidecar.py", "GpuMergeSidecar._dispatch"):
        "pack_ms histogram + sidecar:pack trace timestamp (obs only; "
        "never feeds ordering)",
    ("service/gpu_sidecar.py", "GpuMergeSidecar._admit_to_pool"):
        "the admit_s stat measures a pool admission's host seconds "
        "(obs only; never feeds ordering)",
    ("ops/cuda_merge.py", "prewarm"):
        "returns the kernel library's build-and-load wall seconds "
        "(obs only)",
    ("service/gpu_sidecar.py", "GpuMergeSidecar._settle"):
        "settle_ms histogram + sidecar:settle trace timestamp (obs "
        "only; never feeds ordering)",
    ("service/tree_sidecar.py", "TreeSidecar._dispatch"):
        "tree pack_ms histogram (obs only; never feeds ordering)",
    ("service/tree_sidecar.py", "TreeSidecar._settle"):
        "tree settle_ms histogram (obs only; never feeds ordering)",
    ("service/ingress.py", "AlfredServer._dispatch"):
        "dispatch_ms histogram measures wall latency (obs only)",
    ("service/ingress.py", "AlfredServer._handle_upload_chunk"):
        "abandoned-upload reclaim TTL is transport hygiene on real "
        "wall time, outside the ordering contract",
    ("loader/container.py", "Container._process"):
        "submit->ack roundtrip_ms telemetry (obs only; convergence "
        "state never derives from it)",
    ("loader/container.py", "Container._submit_runtime_op"):
        "records send time for the roundtrip_ms telemetry pair",
    ("tools/serve_bench.py", "run_serve_bench"):
        "wall_s / sidecar round timing ride the report's NON-"
        "deterministic fields (deterministic_fields excludes them)",
    ("tools/benchmark.py", "*"):
        "a benchmark measures wall time by definition",
    ("tools/net_stress.py", "*"):
        "real-socket stress deadlines wait on actual network "
        "progress",
    ("native/replay_baseline.py", "*"):
        "the native replay baseline measures wall time by definition",
}

# Entries of the registries above that name reference code the port
# has not copied yet; the staleness check skips them. Empty: every
# entry names code of the port, and a test pins the set.
AWAITING_PORT: frozenset = frozenset()

# Path components where the unseeded-rng / iteration-order-leak /
# hash-order-dependence rules apply: the deterministic planes. obs/
# and utils/ are the telemetry layers (wall-clock by design, no RNG);
# tests/ and examples/ are out of scope — a test's wall-clock
# deadline loop or demo RNG is not the contract's business.
DET_SCOPE_COMPONENTS = (
    "drivers", "loader", "service", "qos", "runtime", "parallel",
    "ops", "native", "protocol", "framework", "models", "testing",
    "tools",
)

# module-level random.* draws that ride the process-global unseeded
# stream (random.seed included: seeding the GLOBAL stream is itself
# cross-component order dependence — whoever seeds last wins)
_GLOBAL_RNG_FNS = frozenset((
    "random", "uniform", "randint", "randrange", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "lognormvariate",
    "expovariate", "betavariate", "gammavariate", "triangular",
    "vonmisesvariate", "paretovariate", "weibullvariate",
    "getrandbits", "randbytes", "seed",
))

# np.random constructors that ARE seedable — fine when an explicit
# non-None seed argument is present
_NP_SEEDABLE = frozenset((
    "default_rng", "RandomState", "Generator", "SeedSequence",
))

# calls inside a set-iterating fan-out loop that make the iteration
# order observable (wire writes, queue/log appends, fan-out sends)
_ORDER_SINK_CALLS = frozenset((
    "append", "appendleft", "extend", "send", "sendall", "write",
    "writelines", "emit", "publish", "put", "put_nowait", "submit",
    "dispatch", "broadcast", "produce",
))


def _in_det_scope(relpath: str) -> bool:
    parts = relpath.split("/")
    return any(p in DET_SCOPE_COMPONENTS for p in parts[:-1])


class _OrdinalKeys:
    """Stable line-free finding keys: ``module:qual:leaf`` with an
    ordinal suffix for repeats in one scope (the retry-without-jitter
    precedent — two raw reads in one function get distinct keys that
    both survive line insertions above them)."""

    def __init__(self) -> None:
        self._seen: dict[tuple, int] = {}

    def key(self, module: str, qual: str, leaf: str) -> str:
        slot = (module, qual, leaf)
        n = self._seen.get(slot, 0) + 1
        self._seen[slot] = n
        return f"{module}:{qual}:{leaf}" + ("" if n == 1 else str(n))


# ===========================================================================
# rule: wall-clock-unrouted


def wall_clock_calls_in(tree: ast.AST, aliases: dict) -> list[ast.Call]:
    """Direct wall-clock Call nodes in ``tree`` (shared with detsan's
    routed/un-routed site classifier: a read whose call site is NOT
    one of these lines arrived through an injected ``clock()`` — the
    routing the static rule credits)."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                _dotted(node.func, aliases) in WALL_CLOCK_CALLS:
            out.append(node)
    return out


def sink_registered(relpath: str, qualname: str,
                    by_code_name: bool = False) -> bool:
    """Whether a (file, function) pair is a reviewed wall-clock sink.

    The static pass has full dotted qualnames and matches them
    EXACTLY (or ``"*"``): a leaf fallback there would silently exempt
    an unrelated same-named method in the same file. detsan only has
    the code object's bare name, so it passes ``by_code_name=True``
    and matches an entry's tail — the runtime backstop trades that
    precision for coverage, the static half never does."""
    leaf = qualname.rsplit(".", 1)[-1]
    for (suffix, qual), _just in WALL_CLOCK_SINKS.items():
        if not relpath.endswith(suffix):
            continue
        if qual == "*" or qual == qualname:
            return True
        if by_code_name and qual.rsplit(".", 1)[-1] == leaf:
            return True
    return False


def _det_root_infos(graph: CallGraph) -> list:
    roots = []
    for info in graph.functions():
        for suffix, quals in DETERMINISTIC_ROOTS.items():
            if not info.relpath.endswith(suffix):
                continue
            if "*" in quals or info.qualname in quals:
                roots.append(info)
    return roots


def _det_reachable(files: list[SourceFile], graph: CallGraph) -> list:
    """FunctionInfos reachable from the deterministic roots through
    resolved edges plus the declared DETERMINISTIC_INDIRECT edges."""
    fn_index: dict[tuple, object] = {}
    for info in graph.functions():
        fn_index.setdefault((info.relpath, info.qualname), info)

    def lookup(suffix: str, qual: str):
        for (rel, q), info in fn_index.items():
            if q == qual and rel.endswith(suffix):
                yield info

    seen: dict[int, object] = {}
    queue = _det_root_infos(graph)
    while queue:
        info = queue.pop()
        if info is None or id(info.node) in seen:
            continue
        seen[id(info.node)] = info
        queue.extend(graph.callees(info))
        for (suffix, qual), targets in DETERMINISTIC_INDIRECT.items():
            if info.relpath.endswith(suffix) and \
                    info.qualname == qual:
                for tsuffix, tqual in targets:
                    queue.extend(lookup(tsuffix, tqual))
    return list(seen.values())


def _check_wall_clock(files: list[SourceFile],
                      graph: CallGraph) -> list[Finding]:
    by_rel = {src.relpath: src for src in files}
    aliases_cache: dict[str, dict] = {}
    findings: list[Finding] = []
    # per-FILE ordinal counters: keys carry the module basename only,
    # so a shared counter would couple same-named modules' ordinals
    # (service/telemetry.py vs utils/telemetry.py) across files —
    # exactly the key churn the line-free contract forbids
    keys_by_file: dict[str, _OrdinalKeys] = {}
    reachable = sorted(
        _det_reachable(files, graph),
        key=lambda info: (info.relpath,
                          info.node.lineno, info.qualname),
    )
    for info in reachable:
        src = by_rel.get(info.relpath)
        if src is None or src.tree is None:
            continue
        aliases = aliases_cache.get(info.relpath)
        if aliases is None:
            aliases = import_aliases(src.tree, relative="skip")
            aliases_cache[info.relpath] = aliases
        if sink_registered(info.relpath, info.qualname):
            continue
        module = info.relpath.rsplit("/", 1)[-1]
        keys = keys_by_file.setdefault(info.relpath, _OrdinalKeys())
        # source order, not ast.walk's BFS order: a nested read must
        # not swap ordinals with a later top-level one when a
        # refactor wraps/unwraps a call (key churn the line-free
        # contract forbids) — the other three rules sort the same way
        for call in sorted(wall_clock_calls_in(info.node, aliases),
                           key=lambda c: (c.lineno, c.col_offset)):
            leaf = _dotted(call.func, aliases)
            findings.append(Finding(
                rule="wall-clock-unrouted",
                path=info.relpath, line=call.lineno,
                message=(
                    f"{leaf}() inside {info.qualname}(), which is "
                    "reachable from a deterministic-contract root "
                    "(sequencer/qos/replication/chaos/serve_bench): "
                    "every convergence differential assumes this "
                    "path is replayable — inject the clock "
                    "(``clock=`` defaulting to the wall, the "
                    "qos/slo idiom) or, for telemetry timestamps, "
                    "register the function in "
                    "determinism.WALL_CLOCK_SINKS with a "
                    "justification"
                ),
                key=keys.key(module, info.qualname, leaf),
            ))
    return findings


def stale_wall_clock_sinks(files: list[SourceFile]
                           ) -> list[tuple[str, str]]:
    """Registry entries that no longer resolve to a real wall-clock
    call site (the FANOUT_GATES non-vacuity contract: a stale entry
    fails the gate test — the registry only describes live code)."""
    stale = []
    for (suffix, qual) in WALL_CLOCK_SINKS:
        if (suffix, qual) in AWAITING_PORT:
            continue
        live = False
        for src in files:
            if src.tree is None or not src.relpath.endswith(suffix):
                continue
            aliases = import_aliases(src.tree, relative="skip")
            if qual == "*":
                live = bool(wall_clock_calls_in(src.tree, aliases))
            else:
                for fn_qual, fn in _functions(src.tree):
                    if fn_qual == qual and \
                            wall_clock_calls_in(fn, aliases):
                        live = True
                        break
            if live:
                break
        if not live:
            stale.append((suffix, qual))
    return stale


# ===========================================================================
# shared per-module scope map (module-level code attributes to
# "<module>"; nested defs to their qualified name)


def _functions(tree: ast.AST) -> list:
    """(qualname, node) for EVERY def at any nesting depth — class
    methods, functions nested inside methods, classes inside
    functions. The per-function rules here must see a def nested in a
    method as its own scope (one finding, its own key) rather than
    missing it entirely."""
    out: list = []

    def rec(node, prefix: str) -> None:
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + sub.name
                out.append((qual, sub))
                rec(sub, qual + ".")
            elif isinstance(sub, ast.ClassDef):
                rec(sub, prefix + sub.name + ".")
            else:
                rec(sub, prefix)

    rec(tree, "")
    return out


def _scope_map(tree: ast.AST) -> dict[int, str]:
    scope: dict[int, str] = {}
    # outermost first so nested defs override their enclosing scope
    for qual, fn in _functions(tree):
        for sub in ast.walk(fn):
            scope[id(sub)] = qual
    return scope


def _walk_own(fn):
    """``ast.walk`` over one function EXCLUDING nested def subtrees:
    ``_functions`` yields nested defs as their own entries, so a rule
    walking both would report one defect twice under two keys
    (lambdas stay in — they have no ``_functions`` entry)."""
    stack = [fn]
    while stack:
        node = stack.pop()
        if node is not fn and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _scoped_calls(src: SourceFile):
    """(qualname, Call) for every call in the module, module-level
    statements attributed to "<module>"."""
    scope = _scope_map(src.tree)
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            yield scope.get(id(node), "<module>"), node


# ===========================================================================
# rule: unseeded-rng


def _is_none(node: Optional[ast.expr]) -> bool:
    return node is None or (
        isinstance(node, ast.Constant) and node.value is None)


def _check_unseeded_rng(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in files:
        if src.tree is None or not _in_det_scope(src.relpath):
            continue
        aliases = import_aliases(src.tree, relative="skip")
        module = src.relpath.rsplit("/", 1)[-1]
        keys = _OrdinalKeys()
        hits: list[tuple] = []
        for qual, call in _scoped_calls(src):
            dotted = _dotted(call.func, aliases)
            if dotted is None:
                continue
            if dotted == "random.Random":
                if (not call.args and not call.keywords) or \
                        (call.args and _is_none(call.args[0])):
                    hits.append((qual, call, "Random", (
                        "random.Random() without a seed draws its "
                        "state from OS entropy: a failing run cannot "
                        "be replayed. Thread a seed through (the "
                        "FFTPU_SEED / FaultSchedule.rng_for idiom) "
                        "or accept an injected rng parameter"
                    )))
            elif dotted == "random.SystemRandom":
                hits.append((qual, call, "SystemRandom", (
                    "random.SystemRandom draws from the OS entropy "
                    "pool on every call — unreplayable by "
                    "construction; use a seeded random.Random"
                )))
            elif dotted.startswith("random.") and \
                    dotted.split(".", 1)[1] in _GLOBAL_RNG_FNS:
                hits.append((qual, call, dotted, (
                    f"{dotted}() rides the process-global unseeded "
                    "stream shared by every module in the process: "
                    "draws interleave across components, so even a "
                    "global random.seed() cannot make one "
                    "component's schedule reproducible — use an "
                    "injected/seeded random.Random instance"
                )))
            elif dotted.startswith("numpy.random."):
                leaf = dotted.rsplit(".", 1)[-1]
                seeded = (
                    leaf in _NP_SEEDABLE
                    and call.args and not _is_none(call.args[0])
                ) or any(
                    kw.arg == "seed" and not _is_none(kw.value)
                    for kw in call.keywords
                )
                if not seeded:
                    hits.append((qual, call, dotted, (
                        f"{dotted}() without seed provenance: "
                        "np.random's global state (or a fresh "
                        "unseeded generator) is unreplayable — pass "
                        "an explicit seed or a seeded Generator"
                    )))
        for qual, call, leaf, msg in sorted(
                hits, key=lambda h: (h[1].lineno, h[1].col_offset)):
            short = leaf.rsplit(".", 1)[-1] if leaf.startswith(
                "numpy.") else leaf
            findings.append(Finding(
                rule="unseeded-rng",
                path=src.relpath, line=call.lineno,
                message=msg,
                key=keys.key(module, qual, short),
            ))
    return findings


# ===========================================================================
# rule: iteration-order-leak


_SET_METHODS = frozenset((
    "union", "intersection", "difference", "symmetric_difference",
    "copy",
))


class _SetTaint:
    """Per-module set-provenance: which class attributes and local
    names provably hold sets. Straight-line, last-assignment-wins."""

    def __init__(self, src: SourceFile):
        self.src = src
        # class name -> attr names assigned set-valued expressions
        self.class_attrs: dict[str, set] = {}
        for node in src.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            attrs: set = set()
            for sub in ast.walk(node):
                target = None
                value = None
                if isinstance(sub, ast.Assign) and len(
                        sub.targets) == 1:
                    target, value = sub.targets[0], sub.value
                elif isinstance(sub, ast.AnnAssign):
                    target, value = sub.target, sub.value
                if not (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    continue
                ann = getattr(sub, "annotation", None)
                # the annotation's NAMES must say set ("Dataset" or
                # an "offset" field name must not)
                ann_names = {
                    n.id for n in ast.walk(ann)
                    if isinstance(n, ast.Name)
                } | {
                    n.attr for n in ast.walk(ann)
                    if isinstance(n, ast.Attribute)
                } if ann is not None else set()
                ann_set = bool(ann_names & {
                    "set", "Set", "frozenset", "FrozenSet",
                    "MutableSet", "AbstractSet",
                })
                if ann_set or (value is not None
                               and self._is_set(value, {}, attrs)):
                    attrs.add(target.attr)
            if attrs:
                self.class_attrs[node.name] = attrs

    def _is_set(self, expr: ast.expr, env: dict,
                self_attrs: set) -> bool:
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return True
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Name) and \
                    expr.func.id in ("set", "frozenset"):
                return True
            if isinstance(expr.func, ast.Attribute) and \
                    expr.func.attr in _SET_METHODS and \
                    self._is_set(expr.func.value, env, self_attrs):
                return True
            return False
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            return (self._is_set(expr.left, env, self_attrs)
                    or self._is_set(expr.right, env, self_attrs))
        if isinstance(expr, ast.Name):
            return env.get(expr.id, False)
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            return expr.attr in self_attrs
        return False

    def env_for(self, fn, class_name: Optional[str]) -> tuple:
        self_attrs = self.class_attrs.get(class_name or "", set())
        env: dict = {}
        assigns = sorted(
            (n for n in _walk_own(fn) if isinstance(n, ast.Assign)),
            key=lambda n: (n.lineno, n.col_offset),
        )
        for node in assigns:
            verdict = self._is_set(node.value, env, self_attrs)
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    env[tgt.id] = verdict
        return env, self_attrs


def _display_of(expr: ast.expr) -> str:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return "<set>"


def _check_iteration_order(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in files:
        if src.tree is None or not _in_det_scope(src.relpath):
            continue
        module = src.relpath.rsplit("/", 1)[-1]
        taint = _SetTaint(src)
        keys = _OrdinalKeys()
        class_of: dict[int, Optional[str]] = {}
        for node in src.tree.body:
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        class_of[id(sub)] = node.name
        for qual, fn in _functions(src.tree):
            env, self_attrs = taint.env_for(
                fn, class_of.get(id(fn)))

            def is_set(expr) -> bool:
                return taint._is_set(expr, env, self_attrs)

            hits: list[tuple] = []
            for node in _walk_own(fn):
                if isinstance(node, (ast.For, ast.AsyncFor)) and \
                        is_set(node.iter):
                    sink = None
                    for sub in ast.walk(node):
                        if isinstance(sub, (ast.Yield, ast.YieldFrom)):
                            sink = "yield"
                            break
                        if isinstance(sub, ast.Call) and isinstance(
                                sub.func, ast.Attribute) and \
                                sub.func.attr in _ORDER_SINK_CALLS:
                            sink = sub.func.attr
                            break
                    if sink is not None:
                        hits.append((node, node.iter, (
                            f"set iterated into an order-sensitive "
                            f"sink ({sink}): set order varies per "
                            "process (PYTHONHASHSEED) — iterate "
                            "sorted(...) or keep an insertion-"
                            "ordered dict"
                        )))
                elif isinstance(node, ast.Call):
                    func = node.func
                    if isinstance(func, ast.Name) and \
                            func.id in ("list", "tuple") and \
                            len(node.args) == 1 and \
                            is_set(node.args[0]):
                        hits.append((node, node.args[0], (
                            f"{func.id}() materializes a set in "
                            "arbitrary per-process order — use "
                            "sorted(...) (or an insertion-ordered "
                            "dict) so downstream consumers see a "
                            "stable order"
                        )))
                    elif isinstance(func, ast.Attribute) and \
                            func.attr == "join" and node.args:
                        arg = node.args[0]
                        leaky = is_set(arg) or (
                            isinstance(arg, ast.GeneratorExp)
                            and arg.generators
                            and is_set(arg.generators[0].iter)
                        )
                        if leaky:
                            hits.append((node, arg, (
                                "join() over a set serializes it in "
                                "arbitrary per-process order — "
                                "join over sorted(...)"
                            )))
                elif isinstance(node, ast.ListComp) and \
                        node.generators and \
                        is_set(node.generators[0].iter):
                    hits.append((node, node.generators[0].iter, (
                        "list comprehension over a set builds an "
                        "arbitrarily-ordered list — comprehend over "
                        "sorted(...)"
                    )))
            for node, src_expr, msg in sorted(
                    hits, key=lambda h: (h[0].lineno,
                                         h[0].col_offset)):
                findings.append(Finding(
                    rule="iteration-order-leak",
                    path=src.relpath, line=node.lineno,
                    message=msg,
                    key=keys.key(module, qual, _display_of(src_expr)),
                ))
    return findings


# ===========================================================================
# rule: hash-order-dependence


def _provably_strlike(expr: ast.expr, env: dict) -> bool:
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, (str, bytes))
    if isinstance(expr, ast.JoinedStr):
        return True
    if isinstance(expr, ast.BinOp) and isinstance(
            expr.op, (ast.Add, ast.Mod)):
        return (_provably_strlike(expr.left, env)
                or _provably_strlike(expr.right, env))
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Name) and \
                expr.func.id in ("str", "repr", "format"):
            return True
        if isinstance(expr.func, ast.Attribute) and expr.func.attr in (
                "encode", "decode", "format", "join", "lower",
                "upper", "strip"):
            return True
        return False
    if isinstance(expr, (ast.Tuple, ast.List)):
        return any(_provably_strlike(e, env) for e in expr.elts)
    if isinstance(expr, ast.Name):
        return env.get(expr.id, False)
    return False


def _check_hash_order(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in files:
        if src.tree is None or not _in_det_scope(src.relpath):
            continue
        module = src.relpath.rsplit("/", 1)[-1]
        keys = _OrdinalKeys()
        for qual, fn in _functions(src.tree):
            if qual.rsplit(".", 1)[-1] == "__hash__":
                # dict/set identity inside one process is fine; the
                # hazard is cross-run ordering, which __hash__ alone
                # does not create
                continue
            env: dict = {}
            for node in sorted(
                    (n for n in _walk_own(fn)
                     if isinstance(n, ast.Assign)),
                    key=lambda n: (n.lineno, n.col_offset)):
                verdict = _provably_strlike(node.value, env)
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        env[tgt.id] = verdict
            flagged: set[int] = set()
            hits: list[tuple] = []

            def is_hash(call) -> bool:
                return (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Name)
                        and call.func.id == "hash" and call.args)

            for node in _walk_own(fn):
                if isinstance(node, ast.BinOp) and isinstance(
                        node.op, ast.Mod) and is_hash(node.left):
                    flagged.add(id(node.left))
                    hits.append((node.left, (
                        "hash(x) % n selects a partition/slot from "
                        "the builtin hash: for str/bytes keys the "
                        "hash is salted per process "
                        "(PYTHONHASHSEED), so placement diverges "
                        "across runs and hosts — use zlib.crc32 "
                        "(the partitioning.partition_for idiom) or "
                        "hashlib"
                    )))
            for node in _walk_own(fn):
                if is_hash(node) and id(node) not in flagged and \
                        _provably_strlike(node.args[0], env):
                    hits.append((node, (
                        "builtin hash() of str/bytes is salted per "
                        "process (PYTHONHASHSEED): any ordering or "
                        "selection derived from it diverges across "
                        "runs — use zlib.crc32/hashlib for stable "
                        "keys (dict membership inside one process "
                        "does not need this rule; __hash__ methods "
                        "are exempt)"
                    )))
            for node, msg in sorted(
                    hits, key=lambda h: (h[0].lineno,
                                         h[0].col_offset)):
                findings.append(Finding(
                    rule="hash-order-dependence",
                    path=src.relpath, line=node.lineno,
                    message=msg,
                    key=keys.key(module, qual, "hash"),
                ))
    return findings


# ===========================================================================
# entry point


def check(files: list[SourceFile],
          graph: Optional[CallGraph] = None) -> list[Finding]:
    graph = graph or build_callgraph(files)
    findings: list[Finding] = []
    findings += _check_wall_clock(files, graph)
    findings += _check_unseeded_rng(files)
    findings += _check_iteration_order(files)
    findings += _check_hash_order(files)
    return findings
