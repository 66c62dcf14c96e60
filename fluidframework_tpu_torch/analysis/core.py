"""Shared fluidlint infrastructure: findings, suppressions, file
walking, the allowlist, and the pass registry."""
from __future__ import annotations

import ast
import dataclasses
import glob
import os
import re
from typing import Iterable, Optional

# comma-separated rule ids, optional spaces after commas; stops before
# any justification text ("rule-a, rule-b  -- why")
_RULE_LIST = re.compile(r"[\w-]+(?:\s*,\s*[\w-]+)*")

# repo root = parent of the fluidframework_tpu_torch package
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PKG_ROOT)

# what the gate scans by default, relative to the repo root: the port's
# package, the script that drives it on the card and the port's own
# tests. The JAX package, its tests, bench.py and examples/ belong to
# the reference's gate. A root holding ``*`` is a glob, expanded by
# ``walk_python_files``. layercheck only constrains modules inside the
# package; lockcheck applies everywhere — a test that mutates a
# lock-guarded attribute without the lock is exactly the race shape
# the pass exists to catch.
DEFAULT_ROOTS = (
    "fluidframework_tpu_torch",
    "chip_smoke.py",
    "tests/test_torch_*.py",
)

ALLOWLIST_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "allowlist.txt"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit.

    ``key`` is the STABLE identity used by suppressions and the
    allowlist — rule-specific and line-number-free so entries survive
    unrelated edits (e.g. ``drivers->service`` for layercheck,
    ``ClassName.attr`` for lockcheck).
    """

    rule: str          # rule id, e.g. "lock-unlocked-write"
    path: str          # repo-relative posix path
    line: int
    message: str
    key: str

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class SourceFile:
    """A parsed python file plus its per-line suppressions."""

    def __init__(self, abspath: str, repo_root: str = REPO_ROOT):
        self.abspath = abspath
        self.relpath = os.path.relpath(abspath, repo_root).replace(
            os.sep, "/"
        )
        with open(abspath, encoding="utf-8") as f:
            self.source = f.read()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(self.source, filename=abspath)
        except SyntaxError as e:
            self.parse_error = e
        # line -> set of disabled rule ids; line 0 = whole file
        self.suppressions: dict[int, set[str]] = {}
        for i, text in enumerate(self.source.splitlines(), start=1):
            marker = "# fluidlint:"
            idx = text.find(marker)
            if idx < 0:
                continue
            directive = text[idx + len(marker):].strip()
            if directive.startswith("disable-file="):
                rules = directive[len("disable-file="):]
                scope = 0
            elif directive.startswith("disable="):
                rules = directive[len("disable="):]
                scope = i
            else:
                continue
            # the rule list is comma-separated ids (spaces after
            # commas allowed); it ends where the justification
            # comment the policy asks for begins ("disable=rule-a,
            # rule-b  -- why") — the trailing text must neither
            # poison a rule id nor be parsed as one
            m = _RULE_LIST.match(rules.lstrip())
            self.suppressions.setdefault(scope, set()).update(
                r.strip()
                for r in (m.group(0) if m else "").split(",")
                if r.strip()
            )

    def suppressed(self, rule: str, line: int) -> bool:
        for scope in (0, line):
            rules = self.suppressions.get(scope)
            if rules and (rule in rules or "all" in rules):
                return True
        return False


def walk_python_files(roots: Iterable[str],
                      repo_root: str = REPO_ROOT) -> list[SourceFile]:
    out = []
    for root in roots:
        top = root if os.path.isabs(root) else os.path.join(
            repo_root, root
        )
        if "*" in root:
            matches = sorted(glob.glob(top))
            if not matches:
                raise ValueError(f"no file matches {root!r}")
            out.extend(walk_python_files(matches, repo_root))
            continue
        if not os.path.exists(top):
            # a typo'd path silently scanning nothing would report a
            # clean tree with exit 0 — fail loudly instead
            raise ValueError(f"no such file or directory: {root!r}")
        if os.path.isfile(top):
            if not top.endswith(".py"):
                raise ValueError(f"not a python file: {root!r}")
            out.append(SourceFile(top, repo_root))
            continue
        for dirpath, dirs, files in os.walk(top):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(
                        SourceFile(os.path.join(dirpath, f), repo_root)
                    )
    return out


def import_aliases(tree, relative: str = "tail") -> dict:
    """local name -> dotted origin, from every import in the module
    (function-local ones included: analyzed bodies may import
    locally). ONE definition shared by the pass families.

    ``relative`` controls ``from .x import y`` forms: ``"tail"``
    keeps the module tail (``..obs.trace`` -> ``obs.trace`` — the
    suffix-matching registries in obscheck/qoscheck need it);
    ``"skip"`` drops them (detcheck matches ABSOLUTE stdlib
    prefixes, where a relative ``..random`` tail colliding with the
    stdlib ``random.`` prefix would be a false positive)."""
    aliases: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level > 0 and relative == "skip":
                continue
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted_path(node, aliases: dict) -> Optional[str]:
    """Resolve a Name/Attribute chain to a dotted path with import
    aliases substituted; None for anything non-static (calls,
    subscripts). ONE definition — detcheck, obscheck, qoscheck and
    concheck all match registries against the same resolution."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def load_allowlist(path: str = ALLOWLIST_PATH) -> list[tuple[str, str]]:
    """Grandfathered findings: one ``<rule-id> <key>`` pair per line,
    ``#`` comments. The gate test enforces the ratchet: every entry
    must still match a live finding (stale entries fail the gate — the
    list only shrinks) and the total stays under the cap."""
    entries = []
    if not os.path.exists(path):
        return entries
    with open(path, encoding="utf-8") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                raise ValueError(
                    f"malformed allowlist line {raw!r} "
                    "(expected '<rule-id> <key>')"
                )
            entries.append((parts[0], parts[1]))
    return entries


# The reference's jaxhazards family reasons about ``jax.jit``; its one
# rule with a torch meaning, ``dispatch-loop-sync``, is the port's
# ``synccheck`` (analysis/synccheck.py), and its four ``jit-*`` rules
# guard a traced program the port does not have. The reference's
# shapecheck is the port's shapecheck (analysis/shapecheck.py): the same
# five rules over the device roots testing/jitsan.py wraps, jitsan being
# its runtime half.
FAMILIES = ("layercheck", "synccheck", "lockcheck", "obscheck",
            "qoscheck", "concheck", "shapecheck", "detcheck",
            "wirecheck", "failcheck")

# rule id -> owning family: tooling that groups ONE combined run's
# findings per family (bench's fluidlint_findings records) reads
# this instead of re-running the analysis once per family. The gate
# test pins it complete against FAMILIES.
FAMILY_RULES = {
    "layercheck": ("layer-undeclared", "layer-cycle"),
    "synccheck": ("dispatch-loop-sync",),
    "lockcheck": ("lock-unlocked-write", "lock-external-write"),
    "obscheck": ("obs-untimed-hop", "slo-unbound-objective",
                 "undocumented-metric"),
    "qoscheck": ("service-unbounded-queue", "retry-without-jitter",
                 "fence-before-fanout", "unbounded-blocking-wait"),
    "concheck": ("lock-order-cycle", "async-blocking-call",
                 "await-holding-lock"),
    "shapecheck": ("donated-buffer-reuse", "unladdered-jit-shape",
                   "kernel-dtype-widen", "shape-mismatch",
                   "prewarm-coverage"),
    "detcheck": ("wall-clock-unrouted", "unseeded-rng",
                 "iteration-order-leak", "hash-order-dependence"),
    "wirecheck": ("encoder-decoder-drift",
                  "optional-field-unconditional-emit",
                  "ungated-wire-read", "unversioned-frame-field"),
    "failcheck": ("swallowed-exception",
                  "broad-except-in-dispatch-loop",
                  "exception-context-dropped", "return-in-finally"),
}
RULE_FAMILY = {
    rule: fam for fam, rules in FAMILY_RULES.items() for rule in rules
}


def run_analysis(roots: Iterable[str] = DEFAULT_ROOTS,
                 families: Iterable[str] = FAMILIES,
                 repo_root: str = REPO_ROOT,
                 ) -> list[Finding]:
    """Run the selected pass families; returns findings with per-line
    suppressions already applied (allowlist filtering is the caller's
    choice — the CLI and gate apply it, tooling may want raw)."""
    from . import (
        concurrency,
        determinism,
        failcheck,
        layercheck,
        lockcheck,
        obscheck,
        qoscheck,
        shapecheck,
        synccheck,
        wirecheck,
    )

    passes = {
        "layercheck": layercheck.check,
        "synccheck": synccheck.check,
        "lockcheck": lockcheck.check,
        "obscheck": obscheck.check,
        "qoscheck": qoscheck.check,
        "concheck": concurrency.check,
        "shapecheck": shapecheck.check,
        "detcheck": determinism.check,
        "wirecheck": wirecheck.check,
        "failcheck": failcheck.check,
    }
    unknown = [f for f in families if f not in passes]
    if unknown:
        raise ValueError(
            f"unknown rule families {unknown}; pick from {FAMILIES}"
        )
    files = walk_python_files(roots, repo_root)
    findings: list[Finding] = []
    by_path = {f.relpath: f for f in files}
    # one shared call graph per run: concheck, shapecheck, detcheck,
    # wirecheck and failcheck resolve through the same interprocedural
    # edges (and pay for the build once); synccheck's reachability is
    # module-local, as the reference's dispatch-loop-sync rule's is
    GRAPH_FAMILIES = ("concheck", "shapecheck", "detcheck", "wirecheck",
                      "failcheck")
    shared_graph = None
    if set(GRAPH_FAMILIES) & set(families):
        from .callgraph import build_callgraph

        shared_graph = build_callgraph(files)
    for fam in families:
        if fam in GRAPH_FAMILIES:
            findings.extend(passes[fam](files, graph=shared_graph))
        else:
            findings.extend(passes[fam](files))
    kept = []
    for fnd in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        src = by_path.get(fnd.path)
        if src is not None and src.suppressed(fnd.rule, fnd.line):
            continue
        kept.append(fnd)
    return kept


def apply_allowlist(findings: list[Finding],
                    allowlist: list[tuple[str, str]],
                    ) -> tuple[list[Finding], list[tuple[str, str]]]:
    """Split findings into (non-allowlisted, stale-allowlist-entries).
    An entry matches any finding with the same (rule, key)."""
    allowed = set(allowlist)
    live = {(f.rule, f.key) for f in findings}
    kept = [f for f in findings if (f.rule, f.key) not in allowed]
    stale = [e for e in allowlist if e not in live]
    return kept, stale
