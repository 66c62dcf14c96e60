"""wirecheck — static wire-schema extraction and encoder/decoder
symmetry over the frame codecs.

The wire contract — length-prefixed JSON frames between the socket
drivers and the alfred ingress — is the one interface every peer,
recorded corpus and cross-version deployment depends on, and until
this family it was guarded only by hand-written interop cases. The
pass extracts a per-frame-type field schema from the encoder and
decoder ASTs (dict displays carrying a ``"type"`` key, ``out["k"]``
augmentations, ``**helper()`` expansions resolved through the shared
callgraph, and the matching reads on the other side) and checks it
against the reviewed :data:`WIRE_SCHEMA` registry in
``protocol/constants.py`` (frame type -> field -> since-version spec):

- **encoder-decoder-drift** — every field a serializer can emit must
  be consumed somewhere by the matching deserializer side (or be
  explicitly tolerated, the ``~`` flag), and an UNGUARDED decoder read
  of a field no encoder in scope ever emits is the same drift seen
  from the other end.
- **optional-field-unconditional-emit** — a field the registry marks
  optional-presence (``?`` — the post-1.0 byte-stability discipline:
  qos shed attribution, traces, boxcar members) must be emitted only
  under a guard (an ``if`` around the emit, or a non-None constant
  value), never unconditionally with a maybe-None value: a 1.0 peer
  and a recorded corpus must not see keys that carry nothing.
- **ungated-wire-read** — a decoder reading a post-1.0 (or
  optional-presence) field with a bare subscript must ``.get()`` with
  a default, sit behind a presence check on the same field, or be
  version-gated by ``wire_version_lt`` (directly, through a
  gate-providing helper, or inherited from a gate-covered call site —
  the ``upload_summary`` -> ``_doc_upload_summary`` shape), so a 1.0
  peer's frame can never KeyError a newer endpoint.
- **unversioned-frame-field** — an emitted field (or whole frame
  type) absent from the registry fails the gate: schema growth is a
  reviewed registry diff, never an accident.

Scope is the reviewed :data:`WIRE_MODULES` list — the protocol codecs
and the production driver/ingress endpoints. The chaos harness,
serve_bench, stress tools and the broker/moira sidecar planes speak
the same frames but are HARNESSES, not the contract's endpoints; the
runtime half (``testing/wiresan.py``) covers what they actually put
on the wire, and its differential (tests/test_wiresan.py) pins every
observed (frame type, field) back to this registry BY NAME.

Known approximation shapes (docs/ANALYSIS.md has the full list): a
frame dict built under ANY ``if`` counts as guarded for rule 2 (the
guard's condition is not checked), and every callee of a
gate-covered call site inherits the gate for rule 3 — both trade
false positives for false negatives the runtime differential
backstops.

Like every fluidlint pass, this module imports NOTHING it lints: the
registry itself is read from the SCANNED tree's
``protocol/constants.py`` via ``ast.literal_eval``, so linting a
fixture tree uses the fixture's registry, never the live one.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from .callgraph import CallGraph, build_callgraph
from .core import Finding, SourceFile

# ---------------------------------------------------------------------------
# reviewed registries

# The wire contract's endpoints (relpath suffixes). Everything else
# that speaks frames (testing/chaos.py, tools/serve_bench.py,
# tools/stress.py, service/broker.py, service/moira.py, tests/) is a
# harness or a separate protocol plane: runtime wiresan observes their
# traffic instead.
WIRE_MODULES = (
    "protocol/serialization.py",
    "protocol/columnar.py",
    "protocol/tree_payload.py",
    "drivers/socket_driver.py",
    "drivers/caching_driver.py",
    "service/ingress.py",
    "service/__main__.py",
)

# where the WIRE_SCHEMA registry literal lives in the scanned tree
SCHEMA_MODULE = "protocol/constants.py"

# Payload codecs: op payloads ride inside frames ("msg", "msgs",
# "op"/"ops", "operation") with their own field vocabulary; the
# registry models them as ``msg:*`` pseudo-types and these function
# pairs are their single encode/decode definitions. Unlike frame
# dicts, a payload schema KEEPS its "type" field (it is a payload
# field, not the frame discriminator).
PAYLOAD_CODECS = {
    ("protocol/serialization.py", "message_to_json"):
        ("emit", "msg:sequenced"),
    ("protocol/serialization.py", "message_from_json"):
        ("read", "msg:sequenced"),
    ("service/ingress.py", "document_message_to_json"):
        ("emit", "msg:document"),
    ("service/ingress.py", "document_message_from_json"):
        ("read", "msg:document"),
    # the wire-1.3 columnar submitOp payload ("cols"): the payload IS
    # the column layout, so its codec pair registers the column names
    # the same way the row codecs register message fields
    ("protocol/columnar.py", "encode_columns"):
        ("emit", "cols:columnar"),
    ("protocol/columnar.py", "decode_columns"):
        ("read", "cols:columnar"),
    # the wire-1.5 sharedtree channel-op payload: one codec pair for
    # the dict the runtime envelope carries two levels down a msg:*
    # payload (the tree serving plane's ingest feed)
    ("protocol/tree_payload.py", "tree_change_to_json"):
        ("emit", "msg:tree"),
    ("protocol/tree_payload.py", "tree_change_from_json"):
        ("read", "msg:tree"),
}

# request frame type -> the response frame type a ``_request()`` call
# returns (the rid-paired request/response plane)
RESPONSE_OF = {
    "read_ops": "ops",
    "fetch_summary": "summary",
    "upload_summary_chunk": "summary_uploaded",
    "metrics": "metrics",
    "fleet-metrics": "fleet-metrics",
    "slo": "slo",
    "heat": "heat",
}

# leaf method names whose return value is the rid-paired response of
# the request dict they were passed
REQUEST_HELPERS = frozenset(("_request",))

# the one version-gate helper (protocol/constants.py); calling it —
# or a function that transitively calls it — before a read counts as
# version-gating for rule 3
GATE_FN = "wire_version_lt"


def parse_spec(spec: str) -> tuple[str, bool, bool]:
    """``"1.1?"`` -> (since, optional_presence, tolerated). Mirrors
    ``protocol.constants.wire_schema_fields`` — duplicated because a
    fluidlint pass imports nothing it lints."""
    s = str(spec)
    optional = "?" in s
    tolerated = "~" in s
    since = s.replace("?", "").replace("~", "")
    return since, optional, tolerated


def _ver(v: str) -> tuple:
    try:
        return tuple(int(x) for x in v.split("."))
    except ValueError:
        return (9, 9)


def load_registry(files: list[SourceFile]) -> Optional[dict]:
    """The WIRE_SCHEMA dict literal from the scanned tree's
    ``protocol/constants.py`` (None when the scan scope carries no
    registry — the pass then has no contract to check against)."""
    for src in files:
        if src.tree is None or not src.relpath.endswith(SCHEMA_MODULE):
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "WIRE_SCHEMA":
                try:
                    reg = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    continue
                if isinstance(reg, dict):
                    return reg
    return None


class _OrdinalKeys:
    """Stable line-free finding keys (the detcheck discipline):
    ``module:qual:leaf`` with an ordinal suffix for repeats."""

    def __init__(self) -> None:
        self._seen: dict[tuple, int] = {}

    def key(self, module: str, qual: str, leaf: str) -> str:
        slot = (module, qual, leaf)
        n = self._seen.get(slot, 0) + 1
        self._seen[slot] = n
        return f"{module}:{qual}:{leaf}" + ("" if n == 1 else str(n))


# ---------------------------------------------------------------------------
# per-function AST facts


@dataclasses.dataclass
class _Site:
    """One emit or read site."""

    relpath: str
    module: str
    qual: str
    line: int
    col: int
    guarded: bool
    gated: bool = False


def _functions(tree: ast.AST) -> list:
    """(qualname, node) for every def at any nesting depth."""
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


def _walk_own(fn):
    """Walk one function excluding nested def subtrees (lambdas stay
    in: a fanout closure's frame dict belongs to its enclosing
    handler)."""
    stack = [fn]
    while stack:
        node = stack.pop()
        if node is not fn and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _is_terminal(stmts: list) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _type_names(node) -> Optional[tuple]:
    """The frame-type string constants a compare tests against:
    Constant or a Tuple/List of Constants."""
    s = _const_str(node)
    if s is not None:
        return (s,)
    if isinstance(node, (ast.Tuple, ast.List)):
        names = tuple(_const_str(e) for e in node.elts)
        if names and all(n is not None for n in names):
            return names
    return None


def _get_call_field(node, varnames) -> Optional[tuple]:
    """``v.get("f" [, default])`` on a name in ``varnames`` ->
    (varname, field)."""
    if isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            node.func.attr == "get" and \
            isinstance(node.func.value, ast.Name) and \
            (varnames is None or node.func.value.id in varnames) and \
            node.args:
        field = _const_str(node.args[0])
        if field is not None:
            return node.func.value.id, field
    return None


def _subscript_field(node, varnames) -> Optional[tuple]:
    """``v["f"]`` (Load) on a name in ``varnames`` -> (varname,
    field)."""
    if isinstance(node, ast.Subscript) and \
            isinstance(node.ctx, ast.Load) and \
            isinstance(node.value, ast.Name) and \
            (varnames is None or node.value.id in varnames):
        field = _const_str(node.slice)
        if field is not None:
            return node.value.id, field
    return None


def _type_expr_var(node, kind_of: dict) -> Optional[str]:
    """The frame var whose TYPE this expression denotes:
    ``frame.get("type")``, ``frame["type"]``, or a kind-var name."""
    hit = _get_call_field(node, None) or _subscript_field(node, None)
    if hit is not None and hit[1] == "type":
        return hit[0]
    if isinstance(node, ast.Name) and node.id in kind_of:
        return kind_of[node.id]
    return None


@dataclasses.dataclass
class _Region:
    var: str
    types: tuple            # frame types (typed region)
    field: Optional[str]    # presence-guard region when set
    ids: frozenset          # contained node ids

    @property
    def size(self) -> int:
        return len(self.ids)


def _ids_of(stmts: list) -> frozenset:
    out: set = set()
    for stmt in stmts:
        for sub in ast.walk(stmt):
            out.add(id(sub))
    return frozenset(out)


class _FnFacts:
    """Everything the rules need from one function, computed once."""

    def __init__(self, src: SourceFile, qual: str, fn,
                 info, class_name: Optional[str]) -> None:
        self.src = src
        self.relpath = src.relpath
        self.module = src.relpath.rsplit("/", 1)[-1]
        self.qual = qual
        self.fn = fn
        self.info = info
        self.class_name = class_name
        self.params = [a.arg for a in fn.args.args]
        if class_name is not None and self.params and \
                self.params[0] in ("self", "cls"):
            self.params = self.params[1:]
        # filled by the scan below
        self.kind_of: dict[str, str] = {}
        self.dict_types: dict[str, str] = {}
        self.regions: list[_Region] = []
        self.dispatch: dict[str, set] = {}
        self.var_types: dict[str, set] = {}
        self.reads: list[tuple] = []       # (var, field, node, guarded)
        self.frame_dicts: list[tuple] = [] # (type, fields, expands, node)
        self.calls: list[ast.Call] = []
        self.gate_lines: list[int] = []
        self.ret_schema: Optional[dict] = None
        # propagated state
        self.param_types: dict[str, set] = {}
        self.gate_inherited = False
        self._under_if: set = set()
        self._scan()

    # -- scan ----------------------------------------------------------

    def _scan(self) -> None:
        self._mark_conditional(self.fn, False)
        self._scan_kind_vars()
        self._scan_dict_literals()
        self._scan_regions()
        self._scan_calls_and_gates()
        self._scan_response_vars()
        self._scan_reads()
        self.ret_schema = self._return_schema()

    def _mark_conditional(self, node, under: bool) -> None:
        """ids of nodes nested under an If/IfExp within this
        function (nested defs excluded like _walk_own)."""
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            sub_under = under or isinstance(node, (ast.If, ast.IfExp))
            if sub_under:
                self._under_if.add(id(sub))
            self._mark_conditional(sub, sub_under)

    def _scan_kind_vars(self) -> None:
        for node in _walk_own(self.fn):
            if isinstance(node, ast.Assign) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                hit = _get_call_field(node.value, None) or \
                    _subscript_field(node.value, None)
                if hit is not None and hit[1] == "type":
                    self.kind_of[node.targets[0].id] = hit[0]

    def _scan_dict_literals(self) -> None:
        """Frame-typed dict displays + the vars they're assigned to
        (augmentation targets), and the generic literal-var map used
        by the return-schema extractor."""
        assigned: dict[int, str] = {}
        for node in _walk_own(self.fn):
            target = None
            if isinstance(node, ast.Assign) and node.targets and \
                    isinstance(node.targets[0], ast.Name):
                target = node.targets[0].id
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                target = node.target.id
            if target is not None and isinstance(
                    getattr(node, "value", None), ast.Dict):
                assigned[id(node.value)] = target
        self._literal_vars: dict[str, tuple] = {}
        for node in _walk_own(self.fn):
            if not isinstance(node, ast.Dict):
                continue
            fields: list[tuple] = []
            expands: list[ast.Call] = []
            ftype = None
            cond = id(node) in self._under_if
            for key, value in zip(node.keys, node.values):
                if key is None:
                    if isinstance(value, ast.Call):
                        expands.append(value)
                    continue
                name = _const_str(key)
                if name is None:
                    continue
                if name == "type":
                    ftype = _const_str(value)
                guarded = cond or (
                    isinstance(value, ast.Constant)
                    and value.value is not None
                )
                fields.append((name, value.lineno, value.col_offset,
                               guarded))
            var = assigned.get(id(node))
            if var is not None:
                self._literal_vars[var] = (list(fields), node)
                if ftype is not None:
                    self.dict_types[var] = ftype
            if ftype is not None:
                self.frame_dicts.append((ftype, fields, expands, node))
        # subscript augmentations on literal-held vars:
        #   out["k"] = v        and        d["a"], d["b"] = pair
        for node in _walk_own(self.fn):
            if not isinstance(node, ast.Assign):
                continue
            targets = []
            for tgt in node.targets:
                if isinstance(tgt, ast.Tuple):
                    targets.extend(tgt.elts)
                else:
                    targets.append(tgt)
            for tgt in targets:
                if not (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.value, ast.Name)):
                    continue
                field = _const_str(tgt.slice)
                var = tgt.value.id
                if field is None or var not in self._literal_vars:
                    continue
                guarded = id(node) in self._under_if or (
                    isinstance(node.value, ast.Constant)
                    and node.value.value is not None
                    and len(targets) == 1
                )
                entry = (field, tgt.lineno, tgt.col_offset, guarded)
                self._literal_vars[var][0].append(entry)
                ftype = self.dict_types.get(var)
                if ftype is not None:
                    for i, (t, fs, ex, dn) in enumerate(
                            self.frame_dicts):
                        if dn is self._literal_vars[var][1]:
                            fs.append(entry)
                            break

    def _scan_regions(self) -> None:
        """Typed regions from type compares and presence-guard
        regions from ``.get`` tests, including the negative-compare
        (``!= "X"`` + early return) and ``.get(...) is None`` + early
        return shapes used by the dump clients."""
        for node in _walk_own(self.fn):
            for attr in ("body", "orelse", "finalbody"):
                stmts = getattr(node, attr, None)
                if not isinstance(stmts, list) or not stmts:
                    continue
                for i, stmt in enumerate(stmts):
                    if not isinstance(stmt, ast.If):
                        continue
                    self._regions_from_if(stmt, stmts[i + 1:])

    def _regions_from_if(self, stmt: ast.If, siblings: list) -> None:
        for comp in ast.walk(stmt.test):
            if isinstance(comp, ast.Compare) and len(comp.ops) == 1:
                left, op, right = comp.left, comp.ops[0], \
                    comp.comparators[0]
                var = _type_expr_var(left, self.kind_of)
                names = _type_names(right)
                if var is None or names is None:
                    var = _type_expr_var(right, self.kind_of)
                    names = _type_names(left)
                if var is None or names is None:
                    continue
                self.dispatch.setdefault(var, set()).update(names)
                if isinstance(op, (ast.Eq, ast.In)):
                    self._add_region(var, names, None, stmt.body)
                elif isinstance(op, (ast.NotEq, ast.NotIn)):
                    if stmt.orelse:
                        self._add_region(var, names, None, stmt.orelse)
                    if _is_terminal(stmt.body):
                        self._add_region(var, names, None, siblings)
        # presence guards: the If test touches v.get("f")
        for sub in ast.walk(stmt.test):
            hit = _get_call_field(sub, None)
            if hit is None or hit[1] == "type":
                continue
            var, field = hit
            self._add_region(var, (), field, stmt.body)
            if _is_terminal(stmt.body):
                self._add_region(var, (), field, siblings)

    def _add_region(self, var, types, field, stmts) -> None:
        ids = _ids_of(stmts)
        if ids:
            self.regions.append(_Region(var, tuple(types), field, ids))

    def _scan_calls_and_gates(self) -> None:
        for node in _walk_own(self.fn):
            if not isinstance(node, ast.Call):
                continue
            self.calls.append(node)
            func = node.func
            leaf = func.id if isinstance(func, ast.Name) else (
                func.attr if isinstance(func, ast.Attribute) else None)
            if leaf == GATE_FN:
                self.gate_lines.append(node.lineno)

    def _scan_response_vars(self) -> None:
        """``frame = self._request(data)`` types ``frame`` as the
        request dict's response frame type."""
        for node in _walk_own(self.fn):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                continue
            func = node.value.func
            leaf = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None)
            if leaf not in REQUEST_HELPERS or not node.value.args:
                continue
            arg = node.value.args[0]
            rtype = None
            if isinstance(arg, ast.Name):
                rtype = self.dict_types.get(arg.id)
            elif isinstance(arg, ast.Dict):
                for k, v in zip(arg.keys, arg.values):
                    if _const_str(k) == "type":
                        rtype = _const_str(v)
            if rtype in RESPONSE_OF:
                self.var_types.setdefault(
                    node.targets[0].id, set()).add(RESPONSE_OF[rtype])

    def _scan_reads(self) -> None:
        for node in _walk_own(self.fn):
            hit = _subscript_field(node, None)
            if hit is not None:
                self.reads.append((hit[0], hit[1], node, False))
                continue
            hit = _get_call_field(node, None)
            if hit is not None:
                self.reads.append((hit[0], hit[1], node, True))

    def _return_schema(self) -> Optional[dict]:
        """field -> (guarded, line, col) for a function returning a
        dict literal (directly or via an augmented local)."""
        schema: dict = {}
        found = False
        for node in _walk_own(self.fn):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            fields = None
            if isinstance(node.value, ast.Dict):
                fields = []
                cond = id(node.value) in self._under_if
                for key, value in zip(node.value.keys,
                                      node.value.values):
                    name = _const_str(key)
                    if name is None:
                        continue
                    guarded = cond or (
                        isinstance(value, ast.Constant)
                        and value.value is not None
                    )
                    fields.append((name, value.lineno,
                                   value.col_offset, guarded))
            elif isinstance(node.value, ast.Name) and \
                    node.value.id in self._literal_vars:
                fields = self._literal_vars[node.value.id][0]
            if fields is None:
                continue
            found = True
            for name, line, col, guarded in fields:
                prev = schema.get(name)
                if prev is None:
                    schema[name] = (guarded, line, col)
                else:
                    schema[name] = (prev[0] and guarded, prev[1],
                                    prev[2])
        return schema if found else None

    # -- attribution ---------------------------------------------------

    def types_at(self, var: str, node) -> tuple[tuple, bool]:
        """(frame types attributed to ``var`` at ``node``,
        known-frame-var?). Innermost typed region wins; otherwise the
        function-wide var/param typing; otherwise the function's
        dispatch set for that var (reads hoisted above the frame
        switch, like ``doc = frame.get("document_id")``)."""
        best = None
        for region in self.regions:
            if region.field is not None or region.var != var:
                continue
            if id(node) in region.ids and (
                    best is None or region.size < best.size):
                best = region
        if best is not None:
            return best.types, True
        merged: set = set()
        merged.update(self.var_types.get(var, ()))
        merged.update(self.param_types.get(var, ()))
        if merged:
            return tuple(sorted(merged)), True
        disp = self.dispatch.get(var)
        if disp:
            return tuple(sorted(disp)), True
        return (), False

    def presence_guarded(self, var: str, field: str, node) -> bool:
        for region in self.regions:
            if region.var == var and region.field == field and \
                    id(node) in region.ids:
                return True
        return False

    def gate_covered(self, line: int) -> bool:
        return self.gate_inherited or any(
            g <= line for g in self.gate_lines)


# ---------------------------------------------------------------------------
# whole-scope extraction


class Extraction:
    """Merged emit/read tables over the wire modules."""

    def __init__(self) -> None:
        # (frame_type, field) -> [_Site]
        self.emits: dict[tuple, list] = {}
        self.reads: dict[tuple, list] = {}
        # frame types emitted with no registry entry: type -> [_Site]
        self.unknown_types: dict[str, list] = {}

    def add_emit(self, ftype: str, field: str, site: _Site) -> None:
        self.emits.setdefault((ftype, field), []).append(site)

    def add_read(self, ftype: str, field: str, site: _Site) -> None:
        self.reads.setdefault((ftype, field), []).append(site)

    def emitted_fields(self) -> dict:
        """frame type -> {field} actually extracted as emitted —
        what wiresan's differential pins runtime traffic against."""
        out: dict = {}
        for (ftype, field) in self.emits:
            out.setdefault(ftype, set()).add(field)
        return out


def _wire_files(files: list[SourceFile]) -> list[SourceFile]:
    return [
        src for src in files
        if src.tree is not None and any(
            src.relpath.endswith(sfx) for sfx in WIRE_MODULES)
    ]


def _class_hierarchy(files: list[SourceFile]) -> dict:
    """class name -> set of descendant class names (transitive, by
    leaf name) across the wire modules — ``self._on_connected(frame)``
    in the base driver must propagate to the multiplexed override."""
    bases: dict[str, set] = {}
    for src in files:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for b in node.bases:
                leaf = b.id if isinstance(b, ast.Name) else (
                    b.attr if isinstance(b, ast.Attribute) else None)
                if leaf is not None:
                    bases.setdefault(leaf, set()).add(node.name)
    desc: dict[str, set] = {}

    def collect(name: str, seen: set) -> set:
        out: set = set()
        for child in bases.get(name, ()):
            if child in seen:
                continue
            seen.add(child)
            out.add(child)
            out |= collect(child, seen)
        return out

    for name in bases:
        desc[name] = collect(name, {name})
    return desc


def extract(files: list[SourceFile],
            graph: Optional[CallGraph] = None
            ) -> tuple[Extraction, dict]:
    """Run the full emit/read extraction; returns (tables, facts by
    (relpath, qualname)). Shared with wiresan's differential, which
    compares runtime-observed fields against ``emitted_fields()``."""
    graph = graph or build_callgraph(files)
    wire = _wire_files(files)
    hierarchy = _class_hierarchy(wire)

    facts: dict[tuple, _FnFacts] = {}
    by_class: dict[tuple, list] = {}    # (class, leaf) -> [facts]
    for src in wire:
        for qual, fn in _functions(src.tree):
            info = graph.info_for_node(fn)
            class_name = getattr(info, "class_name", None)
            f = _FnFacts(src, qual, fn, info, class_name)
            facts[(src.relpath, qual)] = f
            if class_name is not None:
                leaf = qual.rsplit(".", 1)[-1]
                by_class.setdefault((class_name, leaf), []).append(f)

    # -- gate-providing fixpoint: a call to a function that calls
    # wire_version_lt (transitively) is itself a gate site
    gate_keys = {
        k for k, f in facts.items() if f.gate_lines
    }
    changed = True
    while changed:
        changed = False
        for key, f in facts.items():
            for call in f.calls:
                if f.info is None:
                    continue
                for target in graph.resolve_call(call, f.info, f.src):
                    if tuple(target.key) in gate_keys and \
                            call.lineno not in f.gate_lines:
                        f.gate_lines.append(call.lineno)
                        if key not in gate_keys:
                            gate_keys.add(key)
                        changed = True

    # -- frame-type propagation through calls (+ gate inheritance)
    def callee_facts(call: ast.Call, f: _FnFacts) -> list:
        out = []
        if f.info is not None:
            for target in graph.resolve_call(call, f.info, f.src):
                t = facts.get(tuple(target.key))
                if t is not None:
                    out.append(t)
                # subclass overrides: the callgraph resolves
                # self-methods UP the base chain only
                cls = getattr(target, "class_name", None)
                leaf = target.qualname.rsplit(".", 1)[-1]
                if cls is not None:
                    for sub in hierarchy.get(cls, ()):
                        out.extend(by_class.get((sub, leaf), ()))
        return out

    changed = True
    while changed:
        changed = False
        for f in facts.values():
            for call in f.calls:
                arg_types = []
                for pos, arg in enumerate(call.args):
                    if not isinstance(arg, ast.Name):
                        continue
                    types, known = f.types_at(arg.id, arg)
                    if known and types:
                        arg_types.append((pos, set(types)))
                covered = f.gate_covered(call.lineno)
                if not arg_types and not covered:
                    continue
                for target in callee_facts(call, f):
                    if covered and not target.gate_inherited:
                        target.gate_inherited = True
                        changed = True
                    for pos, types in arg_types:
                        if pos >= len(target.params):
                            continue
                        slot = target.param_types.setdefault(
                            target.params[pos], set())
                        if not types <= slot:
                            slot |= types
                            changed = True

    # -- final tables
    ext = Extraction()
    for f in facts.values():
        codec = None
        for (sfx, qual), spec in PAYLOAD_CODECS.items():
            if f.relpath.endswith(sfx) and f.qual == qual:
                codec = spec
        site = lambda line, col, guarded, gated=False: _Site(  # noqa: E731
            f.relpath, f.module, f.qual, line, col, guarded, gated)

        if codec is not None and codec[0] == "emit":
            if f.ret_schema:
                for field, (guarded, line, col) in f.ret_schema.items():
                    ext.add_emit(codec[1], field,
                                 site(line, col, guarded))
        if codec is not None and codec[0] == "read":
            pvar = f.params[0] if f.params else None
            for var, field, node, guarded in f.reads:
                if var != pvar:
                    continue
                g = guarded or f.presence_guarded(var, field, node)
                ext.add_read(codec[1], field, site(
                    node.lineno, node.col_offset, g,
                    f.gate_covered(node.lineno)))
            continue

        for ftype, fields, expands, dnode in f.frame_dicts:
            for field, line, col, guarded in fields:
                if field == "type":
                    continue
                ext.add_emit(ftype, field, site(line, col, guarded))
            for call in expands:
                for target in callee_facts(call, f):
                    if not target.ret_schema:
                        continue
                    for field, (guarded, line, col) in \
                            target.ret_schema.items():
                        if field == "type":
                            continue
                        ext.add_emit(ftype, field, _Site(
                            target.relpath, target.module,
                            target.qual, line, col, guarded))
            ext.unknown_types.setdefault(ftype, []).append(
                site(dnode.lineno, dnode.col_offset, True))

        for var, field, node, guarded in f.reads:
            if field == "type":
                continue
            if var in f.dict_types or var in f._literal_vars:
                continue    # reading back a dict this code just built
            types, known = f.types_at(var, node)
            if not known:
                continue
            g = guarded or f.presence_guarded(var, field, node)
            gated = f.gate_covered(node.lineno)
            for ftype in types:
                ext.add_read(ftype, field, site(
                    node.lineno, node.col_offset, g, gated))
    return ext, facts


# ---------------------------------------------------------------------------
# rules


def _sorted_sites(sites: list) -> list:
    return sorted(sites, key=lambda s: (s.relpath, s.line, s.col))


def _emit_findings(rule: str, hits: list, message_of) -> list:
    """hits: (leaf, _Site) — sorted per file, keyed per file."""
    findings: list[Finding] = []
    keys_by_file: dict[str, _OrdinalKeys] = {}
    for leaf, s in sorted(
            hits, key=lambda h: (h[1].relpath, h[1].line, h[1].col,
                                 h[0])):
        keys = keys_by_file.setdefault(s.relpath, _OrdinalKeys())
        findings.append(Finding(
            rule=rule, path=s.relpath, line=s.line,
            message=message_of(leaf, s),
            key=keys.key(s.module, s.qual, leaf),
        ))
    return findings


def _check_rules(ext: Extraction, registry: dict) -> list[Finding]:
    findings: list[Finding] = []

    def spec_of(ftype, field):
        fields = registry.get(ftype)
        if fields is None or field not in fields:
            return None
        return parse_spec(fields[field])

    # rule: unversioned-frame-field
    hits = []
    for (ftype, field), sites in ext.emits.items():
        if ftype in registry and field not in registry[ftype]:
            for s in _sorted_sites(sites):
                hits.append((f"{ftype}.{field}", s))
    for ftype, sites in ext.unknown_types.items():
        if ftype not in registry:
            for s in _sorted_sites(sites):
                hits.append((ftype, s))
    findings += _emit_findings(
        "unversioned-frame-field", hits,
        lambda leaf, s: (
            f"emits wire field {leaf!r} that is absent from the "
            "reviewed WIRE_SCHEMA registry "
            "(protocol/constants.py): schema growth is a reviewed "
            "registry diff — add the field with its since-version "
            "(and '?' if its presence is optional), regenerate "
            "protocol/WIRE_SCHEMA.json, and cover it in "
            "test_wire_compat's generative matrix"
        ))

    # rule: optional-field-unconditional-emit
    hits = []
    for (ftype, field), sites in ext.emits.items():
        spec = spec_of(ftype, field)
        if spec is None or not spec[1]:
            continue
        for s in _sorted_sites(sites):
            if not s.guarded:
                hits.append((f"{ftype}.{field}", s))
    findings += _emit_findings(
        "optional-field-unconditional-emit", hits,
        lambda leaf, s: (
            f"optional-presence wire field {leaf!r} is emitted "
            "unconditionally: the registry marks it '?', meaning a "
            "frame must omit the key when there is nothing to say — "
            "an unconditional emit puts maybe-None keys on the wire, "
            "breaking byte-stability with pre-"
            "existing recorded corpora and older peers "
            "(test_wire_compat). Emit under an ``is not None`` / "
            "non-empty guard, the nack_to_json qos-attribution idiom"
        ))

    # rule: encoder-decoder-drift (both directions)
    hits = []
    for (ftype, field), sites in ext.emits.items():
        spec = spec_of(ftype, field)
        if spec is None or spec[2]:
            continue            # unknown = rule 4; '~' = tolerated
        if (ftype, field) in ext.reads:
            continue
        s = _sorted_sites(sites)[0]
        hits.append((f"{ftype}.{field}", s))
    emit_hits = list(hits)
    findings += _emit_findings(
        "encoder-decoder-drift", emit_hits,
        lambda leaf, s: (
            f"wire field {leaf!r} is emitted but no decoder in the "
            "wire modules ever consumes it: either dead freight on "
            "every frame (delete the emit) or a reader the analyzer "
            "cannot see — mark the field '~' (tolerated) in "
            "WIRE_SCHEMA with a comment naming the out-of-scope "
            "consumer"
        ))
    hits = []
    for (ftype, field), sites in ext.reads.items():
        spec = spec_of(ftype, field)
        if spec is not None and spec[2]:
            continue
        if (ftype, field) in ext.emits:
            continue
        for s in _sorted_sites(sites):
            if not s.guarded:
                hits.append((f"{ftype}.{field}", s))
    read_hits = list(hits)
    findings += _emit_findings(
        "encoder-decoder-drift", read_hits,
        lambda leaf, s: (
            f"decoder requires wire field {leaf!r} (bare subscript) "
            "but no encoder in the wire modules ever emits it: a "
            "well-formed peer frame KeyErrors this endpoint — read "
            "it with .get(), or mark the field '~' in WIRE_SCHEMA "
            "with a comment naming the out-of-scope emitter"
        ))

    # rule: ungated-wire-read
    drifted = {(leaf, s.relpath, s.line, s.col)
               for leaf, s in read_hits}
    hits = []
    for (ftype, field), sites in ext.reads.items():
        spec = spec_of(ftype, field)
        if spec is None:
            continue
        since, optional, _tolerated = spec
        if not optional and _ver(since) <= (1, 0):
            continue
        for s in _sorted_sites(sites):
            if s.guarded or s.gated:
                continue
            if (f"{ftype}.{field}", s.relpath, s.line, s.col) \
                    in drifted:
                continue
            hits.append((f"{ftype}.{field}", s))
    findings += _emit_findings(
        "ungated-wire-read", hits,
        lambda leaf, s: (
            f"bare subscript read of post-1.0 wire field {leaf!r}: "
            "a 1.0 peer's frame legitimately omits it, so this "
            "KeyErrors on exactly the cross-version pairing the "
            "compat matrix guarantees — use .get() with a default, "
            "check presence first, or put the read behind the "
            "connection's wire_version_lt gate "
            "(protocol/constants.py)"
        ))
    return findings


def stale_schema_entries(files: list[SourceFile],
                         graph: Optional[CallGraph] = None
                         ) -> list[tuple[str, str]]:
    """Registry entries (frame type, field) that the extractor finds
    NEITHER emitted NOR read anywhere in the wire modules — the
    WALL_CLOCK_SINKS non-vacuity discipline: the registry only
    describes live wire traffic (tolerated ``~`` entries are exempt;
    they exist precisely for out-of-scope traffic)."""
    registry = load_registry(files)
    if registry is None:
        return []
    ext, _facts = extract(files, graph)
    stale = []
    for ftype in sorted(registry):
        for field in sorted(registry[ftype]):
            if parse_spec(registry[ftype][field])[2]:
                continue
            if (ftype, field) not in ext.emits and \
                    (ftype, field) not in ext.reads:
                stale.append((ftype, field))
    return stale


# ---------------------------------------------------------------------------
# entry point


def check(files: list[SourceFile],
          graph: Optional[CallGraph] = None) -> list[Finding]:
    registry = load_registry(files)
    if registry is None:
        # no registry in scope, no contract to check (the live gate
        # always scans protocol/constants.py; fixture trees carry
        # their own mini registry)
        return []
    ext, _facts = extract(files, graph)
    return _check_rules(ext, registry)
