"""obscheck — observability-contract rules.

``obs-untimed-hop``: every trace hop a module registers must come
from the canonical hop table in ``fluidframework_tpu_torch/obs/trace.py``
(``CANONICAL_HOPS``). An unregistered hop name fragments the
vocabulary that per-op breakdowns, dashboards and the docs group on —
and would silently dodge the runtime ``ValueError`` only where the
stamp call is built dynamically. Checked statically at every
``stamp(...)`` call and every direct ``Trace(service, action)``
construction whose service/action are string literals; dynamic
arguments are left to the runtime check.

The canonical table is read from the obs source with
``ast.literal_eval`` — the linter keeps its "depends on nothing it
lints" property (no runtime import of the package under analysis),
and the table is required to stay a pure literal for exactly this
reason.

``slo-unbound-objective``: every declared SLO objective must bind to
a metric family registered in ``obs.metrics`` — a latency objective
to a HISTOGRAM, a goodput objective's good/total pair to COUNTERS.
The runtime half (``SloEngine.add_objective`` raising ``ValueError``
on an unregistered family) only fires when the engine is actually
constructed on that code path; the static half catches the
misspelled-metric / renamed-family drift at lint time, on every
declaration. Registered names are collected from ``.counter(...)`` /
``.gauge(...)`` / ``.histogram(...)`` registration calls with
literal names — first across the scanned files, then (so a
partial-path scan of a module whose objectives bind to families
registered elsewhere stays clean) across the real package tree.
Dynamic metric names are left to the runtime check.

``undocumented-metric``: every metric family the live tree registers
must have a row in the repo's metric family index
(``docs/OBSERVABILITY.md`` — any markdown table whose header has a
``family`` column), and — staleness both ways, the CANONICAL_HOPS
contract applied to the doc — every documented family must still be
registered somewhere: a documented ghost family fails too. The doc
is discovered by ascending from each scanned file to the nearest
enclosing directory holding ``docs/OBSERVABILITY.md`` (no doc above
the scan roots — e.g. a fixture tree — keeps the rule silent), and
parsed as text, never imported. Files under the doc root's
``tests/`` and ``examples/`` trees are out of scope: their synthetic
registries exercise the metrics plane, they are not the serving
surface the doc indexes.
"""
from __future__ import annotations

import ast
import os
from typing import Optional

from .core import (
    Finding,
    PKG_ROOT,
    REPO_ROOT,
    SourceFile,
    dotted_path as _dotted,
    import_aliases,
)

_TRACE_PATH = os.path.join(PKG_ROOT, "obs", "trace.py")

# call targets that register a hop: obs.trace.stamp (any import
# spelling) and the protocol Trace dataclass constructed directly
_STAMP_SUFFIXES = ("obs.trace.stamp", "obs.stamp")
_TRACE_SUFFIXES = ("protocol.messages.Trace", "messages.Trace",
                   "protocol.Trace")


def load_canonical_hops(path: str = _TRACE_PATH) -> set[tuple]:
    """Extract CANONICAL_HOPS from the obs source as data."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "CANONICAL_HOPS"
            for t in node.targets
        ):
            table = ast.literal_eval(node.value)
            return set(table)
    raise ValueError(
        f"CANONICAL_HOPS literal not found in {path}; the obs hop "
        "table must stay a pure literal (obscheck reads it statically)"
    )


def _import_aliases(tree: ast.AST) -> dict[str, str]:
    # relative imports keep the module tail (``..obs.trace`` ->
    # ``obs.trace``): suffix matching below doesn't need the absolute
    # package prefix
    return import_aliases(tree, relative="tail")


def _matches_suffix(dotted: str, suffixes: tuple[str, ...]) -> bool:
    # the resolved path must END in a known suffix (exact for the
    # relative-import spelling, dotted-prefix for the absolute one).
    # Deliberately NOT the reverse: a module's own unrelated function
    # that happens to be named ``stamp`` (or class named ``Trace``)
    # resolves to a bare name with no import alias and must not
    # false-positive the tier-1 gate — real obs/protocol usage always
    # arrives through an import, which gives the dotted path.
    return any(
        dotted == s or dotted.endswith("." + s) for s in suffixes
    )


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ------------------------------------------------------- slo objectives

# import spellings of the Objective dataclass (obs/slo.py). Bare
# ``Objective`` with no import alias deliberately does NOT match —
# same reasoning as _matches_suffix above.
_OBJECTIVE_SUFFIXES = ("obs.slo.Objective", "obs.Objective",
                       "slo.Objective")
# registry factory method names: ``<anything>.histogram("name", ...)``
# registers a family. Matching on the attribute name alone is
# deliberate — registries travel under many local names (the
# process-wide REGISTRY, get_registry(), an injected instance) and a
# too-narrow match would silently un-enforce the rule.
_METRIC_FACTORIES = ("counter", "gauge", "histogram")

_REAL_REGISTRATIONS: Optional[dict] = None


def collect_registrations(files: list[SourceFile]) -> dict[str, str]:
    """metric family name -> kind, from every registration call with
    a literal name in ``files``."""
    out: dict[str, str] = {}
    for src in files:
        if src.tree is None:
            continue
        for node in ast.walk(src.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_FACTORIES
                and node.args
            ):
                name = _literal_str(node.args[0])
                if name is not None:
                    out[name] = node.func.attr
    return out


def _package_registrations() -> dict[str, str]:
    """Registrations across the real package tree (memoized): the
    fallback universe for partial-path scans, where the scanned files
    may declare objectives whose families are registered in modules
    outside the scan."""
    global _REAL_REGISTRATIONS
    if _REAL_REGISTRATIONS is None:
        from .core import walk_python_files

        _REAL_REGISTRATIONS = collect_registrations(
            walk_python_files([PKG_ROOT])
        )
    return _REAL_REGISTRATIONS


def _kind_of(name: str, local: dict[str, str]) -> Optional[str]:
    kind = local.get(name)
    if kind is None:
        kind = _package_registrations().get(name)
    return kind


def _objective_kwargs(node: ast.Call) -> dict[str, ast.AST]:
    """Objective(...) arguments by parameter name (positional forms
    mapped through the dataclass field order)."""
    params = ("name", "metric", "threshold_ms", "target", "kind",
              "good_metric", "total_metric", "labels")
    out = dict(zip(params, node.args))
    for kw in node.keywords:
        if kw.arg is not None:
            out[kw.arg] = kw.value
    return out


def _check_objectives(src: SourceFile, aliases: dict,
                      registered: dict[str, str],
                      findings: list) -> None:
    module = src.relpath.rsplit("/", 1)[-1]
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func, aliases)
        if dotted is None or not _matches_suffix(
                dotted, _OBJECTIVE_SUFFIXES):
            continue
        kwargs = _objective_kwargs(node)
        name_node = kwargs.get("name")
        obj_name = (_literal_str(name_node)
                    if name_node is not None else None) or "?"
        kind_node = kwargs.get("kind")
        kind = (_literal_str(kind_node) if kind_node is not None
                else "latency")
        if kind == "goodput":
            wanted = [("good_metric", "counter"),
                      ("total_metric", "counter")]
        elif kind == "latency":
            wanted = [("metric", "histogram")]
        else:
            continue  # dynamic/unknown kind: runtime ValueError
        for param, want_kind in wanted:
            arg = kwargs.get(param)
            metric = _literal_str(arg) if arg is not None else None
            if metric is None:
                continue  # dynamic name: left to the runtime check
            have = _kind_of(metric, registered)
            if have == want_kind:
                continue
            problem = (
                "is not registered in obs.metrics"
                if have is None
                else f"is registered as a {have}, not a {want_kind}"
            )
            findings.append(Finding(
                rule="slo-unbound-objective",
                path=src.relpath, line=node.lineno,
                message=(
                    f"SLO objective {obj_name!r}: {param}="
                    f"{metric!r} {problem} — a {kind} objective "
                    f"must bind to a registered {want_kind} "
                    "(obs/slo.py; register the family before "
                    "declaring the objective)"
                ),
                key=f"{module}:{obj_name}:{metric}",
            ))


def _hop_literals(tree: ast.AST, aliases: dict):
    """Yield ``(service, action, lineno)`` for every ``stamp(...)``
    call and direct ``Trace(...)`` construction whose service/action
    are string literals — the shared extraction behind the
    obs-untimed-hop rule AND the canonical-table staleness check
    (:func:`stale_canonical_hops`). Dynamic arguments are skipped:
    the runtime ValueError covers them."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func, aliases)
        if dotted is None:
            continue
        if _matches_suffix(dotted, _STAMP_SUFFIXES):
            # stamp(traces, service, action, ...)
            args = node.args[1:3]
        elif _matches_suffix(dotted, _TRACE_SUFFIXES):
            # Trace(service, action, ...) — keyword form included
            args = list(node.args[:2])
            kw = {k.arg: k.value for k in node.keywords}
            while len(args) < 2:
                name = ("service", "action")[len(args)]
                if name not in kw:
                    break
                args.append(kw[name])
        else:
            continue
        if len(args) < 2:
            continue
        service = _literal_str(args[0])
        action = _literal_str(args[1])
        if service is None or action is None:
            continue
        yield service, action, node.lineno


def collect_stamped_hops(files: list[SourceFile]) -> set[tuple]:
    """Every (service, action) pair stamped with literals anywhere in
    ``files`` — the live-call-site universe the staleness check
    compares the canonical table against."""
    out: set[tuple] = set()
    for src in files:
        if src.tree is None or src.relpath.endswith("obs/trace.py"):
            continue
        aliases = _import_aliases(src.tree)
        for service, action, _lineno in _hop_literals(src.tree,
                                                      aliases):
            out.add((service, action))
    return out


def stale_canonical_hops(files: list[SourceFile],
                         hops: Optional[set] = None) -> list[tuple]:
    """CANONICAL_HOPS entries no real ``stamp()``/``Trace()`` call
    site reaches — ghost vocabulary (the WALL_CLOCK_SINKS staleness
    contract): every hop the table registers must be stamped
    somewhere in the live tree, or breakdowns/dashboards group on a
    name nothing ever emits. The gate test asserts this is empty."""
    if hops is None:
        hops = load_canonical_hops()
    return sorted(hops - collect_stamped_hops(files))


# ------------------------------------------------- metric family index

# the index document, relative to the repo/fixture root it describes
_OBS_DOC_PARTS = ("docs", "OBSERVABILITY.md")


def find_metrics_doc(files: list[SourceFile]) -> Optional[str]:
    """Nearest enclosing ``docs/OBSERVABILITY.md`` above any scanned
    file — the ascent is what lets fixture trees carry their own doc
    (or none, which keeps the rule silent)."""
    visited: set[str] = set()
    for src in files:
        d = os.path.dirname(os.path.abspath(src.abspath))
        while d not in visited:
            visited.add(d)
            cand = os.path.join(d, *_OBS_DOC_PARTS)
            if os.path.isfile(cand):
                return cand
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
    return None


def _row_cells(line: str) -> Optional[list[str]]:
    stripped = line.strip()
    if not (stripped.startswith("|") and stripped.endswith("|")):
        return None
    return [c.strip() for c in stripped[1:-1].split("|")]


def documented_families(doc_path: str) -> dict[str, int]:
    """family name -> line number, from every row of every markdown
    table in the doc whose header has a ``family`` column. The first
    cell is the family reference: backticks stripped, a ``{labels}``
    suffix dropped (rows document the labelled series shape)."""
    out: dict[str, int] = {}
    in_table = False
    with open(doc_path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            cells = _row_cells(line)
            if cells is None:
                in_table = False
                continue
            first = cells[0].strip("`").lower()
            if not in_table:
                in_table = first == "family"
                continue
            if set(first) <= {"-", ":", " "}:
                continue  # the header/body separator row
            name = cells[0].strip("`").split("{", 1)[0].strip()
            if name:
                out.setdefault(name, lineno)
    return out


def _doc_scope(files: list[SourceFile],
               doc_path: str) -> list[SourceFile]:
    doc_root = os.path.dirname(os.path.dirname(doc_path))
    out = []
    for src in files:
        if src.tree is None:
            continue
        rel = os.path.relpath(os.path.abspath(src.abspath), doc_root)
        parts = rel.replace(os.sep, "/").split("/")
        if parts[0] in ("..", "tests", "examples"):
            continue
        out.append(src)
    return out


_ROOT_REGISTRATIONS: dict[str, set] = {}


def _root_registrations(doc_root: str) -> set[str]:
    """Every literal-name family registered anywhere under the doc
    root (tests/examples excluded, memoized): the ghost-row universe
    for PARTIAL scans, where the scanned files alone would make every
    family registered elsewhere in the same repo look like a ghost."""
    cached = _ROOT_REGISTRATIONS.get(doc_root)
    if cached is not None:
        return cached
    sources = []
    for dirpath, dirs, fnames in os.walk(doc_root):
        dirs[:] = [
            d for d in dirs
            if not d.startswith(".") and d != "__pycache__"
            and not (dirpath == doc_root
                     and d in ("tests", "examples"))
        ]
        for fn in sorted(fnames):
            if fn.endswith(".py"):
                sources.append(SourceFile(
                    os.path.join(dirpath, fn), repo_root=doc_root))
    names = set(collect_registrations(sources))
    _ROOT_REGISTRATIONS[doc_root] = names
    return names


def _check_documented(files: list[SourceFile],
                      findings: list) -> None:
    doc_path = find_metrics_doc(files)
    if doc_path is None:
        return
    scope = _doc_scope(files, doc_path)
    if not scope:
        return  # nothing scanned is the doc's business
    documented = documented_families(doc_path)
    sites: dict[str, tuple[SourceFile, int]] = {}
    for src in scope:
        for node in ast.walk(src.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_FACTORIES
                and node.args
            ):
                name = _literal_str(node.args[0])
                if name is not None:
                    sites.setdefault(name, (src, node.lineno))
    doc_rel = os.path.relpath(doc_path, REPO_ROOT).replace(
        os.sep, "/")
    for name in sorted(sites):
        if name in documented:
            continue
        src, lineno = sites[name]
        findings.append(Finding(
            rule="undocumented-metric",
            path=src.relpath, line=lineno,
            message=(
                f"metric family {name!r} is registered here but has "
                f"no row in {doc_rel}'s metric family index — add a "
                "| family | type | meaning | row (operators alert on "
                "what the doc names; an unindexed family is invisible "
                "to them)"
            ),
            key=name,
        ))
    doc_root = os.path.dirname(os.path.dirname(doc_path))
    universe = set(sites) | _root_registrations(doc_root)
    for name in sorted(documented):
        if name in universe:
            continue
        findings.append(Finding(
            rule="undocumented-metric",
            path=doc_rel, line=documented[name],
            message=(
                f"documented metric family {name!r} is registered "
                "nowhere in the live tree — a ghost row describes "
                "telemetry nothing emits; delete it or restore the "
                "registration (staleness is checked both ways)"
            ),
            key=name,
        ))


def check(files: list[SourceFile]) -> list[Finding]:
    hops = load_canonical_hops()
    registered = collect_registrations(files)
    findings: list[Finding] = []
    _check_documented(files, findings)
    for src in files:
        if src.tree is None:
            continue
        if src.relpath.endswith("obs/trace.py"):
            continue  # the table's own module
        aliases = _import_aliases(src.tree)
        if not src.relpath.endswith("obs/slo.py"):
            # (slo.py owns the dataclass; its docstrings/defaults
            # construct no live objectives)
            _check_objectives(src, aliases, registered, findings)
        module = src.relpath.rsplit("/", 1)[-1]
        for service, action, lineno in _hop_literals(src.tree,
                                                     aliases):
            if (service, action) not in hops:
                findings.append(Finding(
                    rule="obs-untimed-hop",
                    path=src.relpath, line=lineno,
                    message=(
                        f"trace hop {service}:{action} is not in the "
                        "canonical hop table (fluidframework_tpu_torch/obs/"
                        "trace.py CANONICAL_HOPS) — register it there "
                        "so breakdowns and dashboards can group on it"
                    ),
                    key=f"{module}:{service}:{action}",
                ))
    return findings
