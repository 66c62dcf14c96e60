"""SharedTree changeset algebra: compose / invert / rebase over mark lists.

Reference semantics (not code): the ``ChangeRebaser`` contract at
packages/dds/tree/src/core/rebase/rebaser.ts:138-170 — ``compose(changes)``,
``invert(change)``, ``rebase(change, over)`` with the algebraic laws

- ``rebase(a, compose([b, c])) == rebase(rebase(a, b), c)``
- ``rebase(a, compose([])) == a`` and ``rebase(compose([]), a) == a``
- ``compose([a, invert(a)])`` is a no-op

and the concrete sequence-field mark algebra at
packages/dds/tree/src/feature-libraries/sequence-field/{format.ts,
compose.ts:56, invert.ts:21, rebase.ts:44}.

TPU-native re-design: marks are flat JSON-safe dicts (so changesets ship
on the wire unmodified, land in summaries, and pack into the
``[docs, marks, fields]`` int tensors the batched tree kernel consumes).
A changeset is a *field-change map* ``{field_key: [mark, ...]}``;
node-level changes (``mod`` marks) recurse with the same structure —
the modular-schema composition collapsed to one field kind: sequence.

Mark vocabulary (``t`` discriminates):

- ``{"t": "skip", "n": k}``                 — leave k nodes untouched
- ``{"t": "ins",  "content": [nodes], "iid": [uid, a]}`` — attach new
    subtrees; ``iid`` is the mark's *birth identity* (creating session's
    unique changeset uid + attach-mark walk index), stable across
    rebasing and the wire
- ``{"t": "del",  "n": k, "did": [uid, d]}`` — detach k nodes; ``did``
    is the birth identity (uid + cumulative detached-node walk count)
- ``{"t": "rev",  "n": k, "rev": uid, "idx": d}`` — reattach k nodes
    detached by the del with identity ``[uid, d]`` (the product of
    inverting a del; content comes from the forest's repair store,
    mirroring the reference's ForestRepairDataStore)
- ``{"t": "mod", "value": {"new": v, "old": u} | None,
     "fields": {key: [marks]} | None}``     — change one node in place
- ``{"t": "tomb", "n": k, "key": [...], "was": mark}`` — a *muted*
    mark (0 input, 0 output): ``was`` rebased over a delete covering
    the k nodes identified by ``key``; unmutes if those nodes return

Tombstones are what make the EditManager's inverse/trunk/rebased
sandwich (editManager.ts:241,:277) an exact round-trip — the
reference's equivalent is the ``tomb``/lineage machinery in
sequence-field/format.ts. Node-range identity keys:

- ``["d", uid, i]`` — nodes detached by the del whose birth identity is
  ``[uid, i]`` (matches a ``rev`` with ``rev=uid, idx=i``)
- ``["i", uid, a, j]`` — node j of the ins mark ``[uid, a]``, removed by
  rolling that insert back (matches the ins itself on re-application)

Concurrency decisions (each deterministic, hence convergent through the
EditManager's total-order rebasing):

- concurrent attaches at one position: the later-sequenced attach keeps
  the left slot (merge-tree ``breakTie`` convention, mergeTree.ts:1705)
- a change inside a concurrently-deleted range mutes to a tomb;
  attaches survive, anchored at the collapse point between tombs
- concurrent revives of the same detached range: the second revive
  drops the overlap (nodes are already back)
- concurrent value sets: later sequence number wins (LWW), recording
  the overwritten value as its ``old`` so its inverse restores it
"""
from __future__ import annotations

import copy
import itertools
from typing import Any, Optional

_PAIR_COUNTER = itertools.count()

Mark = dict
MarkList = list
FieldChanges = dict  # {field_key: MarkList}


# ---------------------------------------------------------------------------
# mark constructors

def skip(n: int) -> Mark:
    return {"t": "skip", "n": n}


def ins(content: list) -> Mark:
    return {"t": "ins", "content": content}


def dele(n: int) -> Mark:
    return {"t": "del", "n": n}


def rev(n: int, revision: Any, idx: int, mods: Optional[dict] = None) -> Mark:
    m = {"t": "rev", "n": n, "rev": revision, "idx": idx}
    if mods:
        m["mods"] = mods
    return m


def mod(value: Optional[dict] = None,
        fields: Optional[FieldChanges] = None) -> Mark:
    m: Mark = {"t": "mod"}
    if value is not None:
        m["value"] = value
    if fields:
        m["fields"] = fields
    return m


def tomb(n: int, key: list, was: Mark) -> Mark:
    return {"t": "tomb", "n": n, "key": key, "was": was}


# ---------------------------------------------------------------------------
# register field kind (modular-schema: value / optional fields)
#
# The second FieldKind in the algebra (reference:
# packages/dds/tree/src/feature-libraries/modular-schema/ — FieldKind-
# indexed composition; the value/optional kinds there are LWW
# registers). A register field holds at most one node; its change is a
# DICT (sequence-kind changes are lists, so the kind dispatches on the
# change's own shape):
#
#   {"k": "reg", "opt": bool,
#    "mods": [marks]?,    # changes to the CURRENT node (a <=1-node
#                         # sequence — the whole sequence mark algebra
#                         # is reused for the nested piece)
#    "set":  {"new": node|None, "old": node|None,
#             "sid": [uid, n]?, "undoes": [uid, n]?}?,
#    "post": [marks]?,    # changes to the NEW node (arises from
#                         # inversion/composition; applies after set)
#    "muted": [{"mods": [...], "by": [uid, n]}, ...]?}
#
# Order of application: mods, set, post. Concurrency: sets are LWW by
# sequencing (the later-sequenced set wins — both apply, last writer's
# node stands); nested mods whose target node a concurrent set
# replaced MUTE under the set's identity and unmute when that set's
# inverse rebases over them (the same tombstone discipline the
# sequence kind uses, which is what keeps the EditManager's
# invert/rebase sandwich exact).
#
# Composition note: composing "set A then interior churn then set B"
# collapses the interior churn (net effect preserved through the
# old/new chain — the reference's register kinds likewise do not
# support reviving register-replaced content across a composite).


def is_reg(change: Any) -> bool:
    return isinstance(change, dict) and change.get("k") == "reg"


def reg_set(new: Optional[dict], old: Optional[dict],
            optional: bool = True) -> dict:
    """Author a register write: replace the field's node with ``new``
    (None clears an optional field). ``old`` is the author's current
    view — the inverse restores it."""
    if new is None and not optional:
        raise ValueError("value field cannot be cleared")
    return {"k": "reg", "opt": bool(optional),
            "set": {"new": copy.deepcopy(new),
                    "old": copy.deepcopy(old)}}


def reg_mods(marks: MarkList, optional: bool = True) -> dict:
    """Nested changes to the register field's current node."""
    return {"k": "reg", "opt": bool(optional), "mods": marks}


def _reg_normalize(r: dict) -> Optional[dict]:
    out = {"k": "reg", "opt": r.get("opt", True)}
    mods = normalize(r.get("mods") or [])
    if mods:
        out["mods"] = mods
    if r.get("set") is not None:
        out["set"] = r["set"]
    post = normalize(r.get("post") or [])
    if post:
        out["post"] = post
    muted = [e for e in (r.get("muted") or []) if normalize(
        e.get("mods") or [])]
    if muted:
        out["muted"] = muted
    if len(out) == 2:  # only k + opt: no effect
        return None
    return out


def _reg_lower(r: dict) -> MarkList:
    """Lower a register change to sequence marks over the author's
    view (old tells whether a node was present). CONVERGENCE VALVE for
    mixed-kind concurrent editing of one field (one client used the
    sequence surface, another the register surface — an application
    modeling error, but it must merge deterministically, never wedge
    the document): once kinds clash, the register change joins the
    sequence algebra as delete-then-insert."""
    marks: MarkList = list(r.get("mods") or [])
    s = r.get("set")
    if s is not None:
        lowered: MarkList = []
        if s.get("old") is not None:
            lowered.append(dele(1))
        new = s.get("new")
        if new is not None:
            if r.get("post"):
                for pm in r["post"]:
                    if pm["t"] == "mod":
                        new = _mod_node(new, pm)
            lowered.append(ins([copy.deepcopy(new)]))
        marks = _compose_marks(marks, lowered) if marks else lowered
    # muted pieces stay muted (tomb-equivalent: nothing to lower)
    return normalize(marks)


def _compose_reg(a: Any, b: Any) -> Optional[dict]:
    """Net effect of register change ``a`` followed by ``b``."""
    if (a and not is_reg(a)) or (b and not is_reg(b)):
        # mixed kinds: lower the register side and compose as sequence
        am = _reg_lower(a) if is_reg(a) else (a or [])
        bm = _reg_lower(b) if is_reg(b) else (b or [])
        return _compose_marks(am, bm) or None
    a = a or {"k": "reg"}
    b = b or {"k": "reg"}
    opt = a.get("opt", b.get("opt", True))
    muted = list(a.get("muted") or []) + list(b.get("muted") or [])
    if b.get("set") is not None:
        if a.get("set") is not None:
            # interior churn (a.post, b.mods) is replaced by b's set;
            # the old/new chain preserves the net effect
            out = {"k": "reg", "opt": opt, "mods": a.get("mods"),
                   "set": dict(b["set"], old=a["set"]["old"]),
                   "post": b.get("post")}
        else:
            out = {"k": "reg", "opt": opt,
                   "mods": _compose_marks(a.get("mods") or [],
                                          b.get("mods") or []),
                   "set": b["set"], "post": b.get("post")}
    elif a.get("set") is not None:
        out = {"k": "reg", "opt": opt, "mods": a.get("mods"),
               "set": a["set"],
               "post": _compose_marks(a.get("post") or [],
                                      b.get("mods") or [])}
    else:
        out = {"k": "reg", "opt": opt,
               "mods": _compose_marks(a.get("mods") or [],
                                      b.get("mods") or [])}
    if muted:
        out["muted"] = muted
    return _reg_normalize(out)


def _invert_reg(r: dict, uid: Any, counters: dict) -> Optional[dict]:
    """Pieces invert in reverse order: invert(post), set-back,
    invert(mods). Muted intent never applied — its inverse is
    nothing (same rule as tombs)."""
    out = {"k": "reg", "opt": r.get("opt", True)}
    if r.get("post"):
        out["mods"] = _invert_marks(r["post"], uid, counters)
    if r.get("set") is not None:
        s = r["set"]
        inv = {"new": copy.deepcopy(s.get("old")),
               "old": copy.deepcopy(s.get("new"))}
        if s.get("sid") is not None:
            inv["undoes"] = s["sid"]
        out["set"] = inv
    if r.get("mods"):
        out["post"] = _invert_marks(r["mods"], uid, counters)
    return _reg_normalize(out)


def _rebase_reg(c: Any, o: Any) -> Optional[dict]:
    """Re-express register change ``c`` to apply after ``o``."""
    if (c and not is_reg(c)) or (o and not is_reg(o)):
        # mixed kinds: lower to the sequence algebra (see _reg_lower)
        cm = _reg_lower(c) if is_reg(c) else (c or [])
        om = _reg_lower(o) if is_reg(o) else (o or [])
        return _rebase_marks(cm, om) or None
    c = c or {"k": "reg"}
    o = o or {"k": "reg"}
    out = {"k": "reg", "opt": c.get("opt", o.get("opt", True))}
    o_set = o.get("set")
    muted: list = []
    unmuted: MarkList = []
    # unmute entries whose killer o's set undoes (the node is back);
    # they target the node o RESTORED, so they stay active past the
    # muting step below
    for e in c.get("muted") or []:
        if o_set is not None and o_set.get("undoes") is not None \
                and e.get("by") == o_set["undoes"]:
            back = e.get("mods") or []
            # the restored node may have been touched by o.post
            back = _rebase_marks(back, o.get("post") or [])
            unmuted = _compose_marks(unmuted, back) \
                if unmuted else back
        else:
            muted.append(e)
    active_mods = c.get("mods") or []
    if o_set is not None:
        # o replaced (or cleared) the node c's mods targeted: mute
        # them under o's set identity; c's own set still applies (LWW
        # by sequencing) and c.post rides c's own new node
        if active_mods:
            muted.append({"mods": active_mods, "by": o_set.get("sid")})
            active_mods = []
    else:
        active_mods = _rebase_marks(active_mods, o.get("mods") or [])
    if unmuted:
        active_mods = _compose_marks(active_mods, unmuted) \
            if active_mods else unmuted
    if active_mods:
        out["mods"] = active_mods
    if c.get("set") is not None:
        out["set"] = c["set"]
    if c.get("post"):
        out["post"] = c["post"]
    if muted:
        out["muted"] = muted
    return _reg_normalize(out)


def _reg_apply(seq: list, r: dict, apply_marks) -> list:
    """Apply a register change to the field's (<=1 node) content.
    ``apply_marks(seq, marks)`` applies a nested mark list (callers
    supply their walker so repair hooks ride along)."""
    out = seq
    if r.get("mods"):
        out = apply_marks(out, r["mods"])
    if r.get("set") is not None:
        new = r["set"].get("new")
        out = [copy.deepcopy(new)] if new is not None else []
    if r.get("post"):
        out = apply_marks(out, r["post"])
    return out


def move(src: int, count: int, dst: int, pair: Any = None) -> MarkList:
    """Same-field move of ``count`` nodes from input position ``src``
    to input position ``dst`` (outside the moved range), expressed as
    a paired detach+revive: the del detaches the nodes under a birth
    identity and the rev reattaches exactly those nodes at ``dst``
    (MoveOut/MoveIn, sequence-field/format.ts — here the pairing rides
    the existing del/rev identity machinery, so compose, invert —
    a move's inverse is the move back — and rebasing, including
    muting/unmuting through tombstones, need no new mark kind).
    ``stamp`` resolves the pairing token into real identities.

    Concurrency: DELETE WINS — if another client concurrently deletes
    the source nodes, both halves mute (the nodes stay deleted; they
    return, moved, only if that delete is itself undone)."""
    if not (dst <= src or dst >= src + count):
        raise ValueError("move destination inside the moved range")
    token = pair if pair is not None else (
        f"__pair{next(_PAIR_COUNTER)}"  # unique per authored move:
        # geometry-based tokens collide across fields (stamp resolves
        # pairings changeset-wide)
    )
    d = {"t": "del", "n": count, "mv": token}
    r = {"t": "rev", "n": count, "rev": None, "idx": 0, "mv": token}
    if dst <= src:
        return normalize(
            [skip(dst), r, skip(src - dst), d]
        )
    return normalize(
        [skip(src), d, skip(dst - src - count), r]
    )


# ---------------------------------------------------------------------------
# mark measurements

def in_len(m: Mark) -> int:
    """How many nodes of the input sequence the mark consumes."""
    t = m["t"]
    if t in ("skip", "del"):
        return m["n"]
    if t == "mod":
        return 1
    return 0  # ins / rev attach; tomb is muted


def out_len(m: Mark) -> int:
    """How many nodes the mark contributes to the output sequence."""
    t = m["t"]
    if t == "skip":
        return m["n"]
    if t == "ins":
        return len(m["content"])
    if t == "rev":
        return m["n"]
    if t == "mod":
        return 1
    return 0  # del / tomb


def is_attach(m: Mark) -> bool:
    return m["t"] in ("ins", "rev")


def _split(m: Mark, k: int) -> tuple[Mark, Mark]:
    """Split ``m`` so the first piece covers k of its units, advancing
    every identity the second piece carries."""
    t = m["t"]
    if t in ("skip", "del"):
        a, b = {**m, "n": k}, {**m, "n": m["n"] - k}
        if t == "del" and "did" in m:
            b["did"] = [m["did"][0], m["did"][1] + k]
        if t == "del" and "rbof" in m:
            r = m["rbof"]
            b["rbof"] = [r[0], r[1], (r[2] if len(r) > 2 else 0) + k]
        return a, b
    if t == "ins":
        a = {**m, "content": m["content"][:k]}
        b = {**m, "content": m["content"][k:]}
        if "iid" in m:
            b["ioff"] = m.get("ioff", 0) + k
        return a, b
    if t == "rev":
        a = {**m, "n": k}
        b = {**m, "n": m["n"] - k, "idx": m["idx"] + k}
        for piece, rng in ((a, range(0, k)), (b, range(k, m["n"]))):
            if "mods" in m:
                base = rng.start
                sel = {str(int(o) - base): mm for o, mm in m["mods"].items()
                       if int(o) in rng}
                if sel:
                    piece["mods"] = sel
                else:
                    piece.pop("mods", None)
        return a, b
    if t == "tomb":
        wa, wb = _split(m["was"], k) if m["was"]["t"] != "skip" \
            else (skip(k), skip(m["n"] - k))
        key_b = list(m["key"])
        key_b[-1] += k
        return ({**m, "n": k, "was": wa},
                {**m, "n": m["n"] - k, "key": key_b, "was": wb})
    raise ValueError(f"cannot split mark {t!r}")


class _Queue:
    """A mark stream with piecewise consumption (inputs are deep-copied
    so emitted marks are always fresh — ``normalize`` merges in place)."""

    def __init__(self, marks: MarkList):
        self._marks = [copy.deepcopy(m) for m in marks]
        self._i = 0

    def peek(self) -> Optional[Mark]:
        return self._marks[self._i] if self._i < len(self._marks) else None

    def pop(self) -> Mark:
        m = self._marks[self._i]
        self._i += 1
        return m

    def split_head(self, k: int) -> None:
        first, rest = _split(self._marks[self._i], k)
        self._marks[self._i] = first
        self._marks.insert(self._i + 1, rest)

    def take_input(self, k: int) -> Mark:
        """Pop a piece consuming min(k, in_len(head)) input units."""
        if in_len(self._marks[self._i]) > k:
            self.split_head(k)
        return self.pop()

    def take_output(self, k: int) -> Mark:
        """Pop a piece contributing min(k, out_len(head)) output units."""
        if out_len(self._marks[self._i]) > k:
            self.split_head(k)
        return self.pop()

    @property
    def empty(self) -> bool:
        return self._i >= len(self._marks)


def normalize(marks: MarkList) -> MarkList:
    """Merge adjacent same-kind contiguous marks, drop empties and
    trailing skips (incl. muted skips — implicit position)."""
    out: MarkList = []
    for m in marks:
        t = m["t"]
        if t in ("skip", "del", "rev", "tomb") and m["n"] == 0:
            continue
        if t == "ins" and not m["content"]:
            continue
        if t == "mod" and "value" not in m and not m.get("fields"):
            m = skip(1)
            t = "skip"
        if out:
            p = out[-1]
            if p["t"] == t == "skip":
                p["n"] += m["n"]
                continue
            if (p["t"] == t == "del" and "did" not in p and "did" not in m
                    and "rbof" not in p and "rbof" not in m
                    and "mv" not in p and "mv" not in m):
                p["n"] += m["n"]
                continue
            if (p["t"] == t == "del" and "did" in p and "did" in m
                    and p["did"][0] == m["did"][0]
                    and p["did"][1] + p["n"] == m["did"][1]
                    and "rbof" not in p and "rbof" not in m):
                p["n"] += m["n"]
                continue
            if (p["t"] == t == "rev" and p["rev"] == m["rev"]
                    and p["rev"] is not None
                    and p["idx"] + p["n"] == m["idx"]
                    and "mods" not in p and "mods" not in m):
                p["n"] += m["n"]
                continue
            if (p["t"] == t == "ins" and "iid" not in p and "iid" not in m):
                p["content"] = p["content"] + m["content"]
                continue
            if (p["t"] == t == "tomb"
                    and p["was"]["t"] == m["was"]["t"] == "skip"
                    and p["key"][:-1] == m["key"][:-1]
                    and p["key"][-1] + p["n"] == m["key"][-1]):
                p["n"] += m["n"]
                p["was"]["n"] = p["n"]
                continue
        out.append(m)
    while out and (out[-1]["t"] == "skip"
                   or (out[-1]["t"] == "tomb"
                       and out[-1]["was"]["t"] == "skip")):
        out.pop()
    return out


def normalize_fields(changes: FieldChanges) -> FieldChanges:
    out = {}
    for key, marks in changes.items():
        nm = _reg_normalize(marks) if is_reg(marks) else \
            normalize(marks)
        if nm:
            out[key] = nm
    return out


# ---------------------------------------------------------------------------
# birth identity stamping

def stamp(changes: FieldChanges, uid: str) -> FieldChanges:
    """Stamp birth identities (``iid`` on ins, ``did`` on del) into a
    freshly authored changeset, in the canonical walk order (marks in
    list order, ``mod`` nested fields sorted by key). Already-stamped
    marks keep their identity (resubmits must not re-identify).
    Move pairings (``mv`` tokens from :func:`move`) resolve here: the
    rev half adopts its del half's freshly assigned identity."""
    counters = {"a": 0, "d": 0}
    pairs: dict = {}
    _stamp_fields(changes, uid, counters, pairs)
    _resolve_moves(changes, pairs)
    return changes


def _resolve_moves(changes: FieldChanges, pairs: dict) -> None:
    for key in sorted(changes):
        if is_reg(changes[key]):
            for piece in ("mods", "post"):
                if changes[key].get(piece):
                    _resolve_moves({key: changes[key][piece]}, pairs)
            continue
        for m in changes[key]:
            if m["t"] == "rev" and m.get("rev") is None:
                did = pairs.get(m.get("mv"))
                if did is None:
                    raise ValueError(
                        f"unpaired move revive {m.get('mv')!r}"
                    )
                m["rev"], m["idx"] = did[0], did[1]
            elif m["t"] == "mod" and m.get("fields"):
                _resolve_moves(m["fields"], pairs)


def _stamp_fields(changes: FieldChanges, uid: str, counters: dict,
                  pairs: Optional[dict] = None) -> None:
    for key in sorted(changes):
        if is_reg(changes[key]):
            r = changes[key]
            if r.get("set") is not None and "sid" not in r["set"]:
                r["set"]["sid"] = [uid, counters.setdefault("s", 0)]
                counters["s"] += 1
            for piece in ("mods", "post"):
                if r.get(piece):
                    _stamp_fields({key: r[piece]}, uid, counters,
                                  pairs)
            continue
        for m in changes[key]:
            t = m["t"]
            if t == "ins":
                if "iid" not in m:
                    m["iid"] = [uid, counters["a"]]
                counters["a"] += 1
            elif t == "del":
                if "did" not in m and "rbof" not in m:
                    m["did"] = [uid, counters["d"]]
                if pairs is not None and "mv" in m:
                    pairs[m["mv"]] = m["did"]
                counters["d"] += m["n"]
            elif t == "mod" and m.get("fields"):
                _stamp_fields(m["fields"], uid, counters, pairs)


# ---------------------------------------------------------------------------
# compose

def compose(changes: list[FieldChanges]) -> FieldChanges:
    """rebaser.ts:143 — fold changesets into one with the same net
    effect. ``compose([])`` is the identity changeset ``{}``."""
    acc: FieldChanges = {}
    for c in changes:
        acc = _compose2(acc, c)
    return acc


def _compose2(a: FieldChanges, b: FieldChanges) -> FieldChanges:
    out: FieldChanges = {}
    for key in sorted(set(a) | set(b)):
        av, bv = a.get(key), b.get(key)
        if is_reg(av) or is_reg(bv):
            reg = _compose_reg(av, bv)
            if reg:
                out[key] = reg
            continue
        marks = _compose_marks(av or [], bv or [])
        if marks:
            out[key] = marks
    return out


def _merge_mod(am: Mark, bm: Mark) -> Mark:
    """Net effect of node change ``am`` followed by ``bm``."""
    value = None
    if "value" in bm and "value" in am:
        value = {"new": bm["value"]["new"], "old": am["value"]["old"]}
    elif "value" in bm:
        value = bm["value"]
    elif "value" in am:
        value = am["value"]
    fields = _compose2(am.get("fields") or {}, bm.get("fields") or {})
    return mod(value=value, fields=fields or None)


def _mod_node(node: dict, m: Mark) -> dict:
    """Apply a mod mark directly to a fresh (inserted) subtree."""
    node = copy.deepcopy(node)
    if "value" in m:
        node["value"] = m["value"]["new"]
    for key, marks in (m.get("fields") or {}).items():
        seq = node.setdefault("fields", {}).get(key, [])
        if is_reg(marks):
            node["fields"][key] = _reg_apply(
                seq, marks, _apply_marks_to_content)
        else:
            node["fields"][key] = _apply_marks_to_content(seq, marks)
    return node


def walk_apply(seq: list, marks: MarkList, *,
               on_del=None, on_rev=None, mod_node=None) -> list:
    """The one mark-list interpreter: apply ``marks`` to node sequence
    ``seq``. Hooks let callers attach side effects without a second
    hand-synchronized walker (Forest captures/fetches repair data;
    content application inside compose needs neither):

    - ``on_del(mark, nodes)`` — observe detached nodes (repair capture)
    - ``on_rev(mark) -> [nodes]`` — produce restored nodes; revives are
      invalid where no repair source exists (fresh inserted content)
    - ``mod_node(node, mark) -> node`` — apply a mod to one node
    """
    mod_node = mod_node or _mod_node
    out: list = []
    pos = 0
    for m in marks:
        t = m["t"]
        if t == "skip":
            out.extend(seq[pos:pos + m["n"]])
            pos += m["n"]
        elif t == "ins":
            out.extend(copy.deepcopy(m["content"]))
        elif t == "del":
            if on_del is not None:
                on_del(m, seq[pos:pos + m["n"]])
            pos += m["n"]
        elif t == "rev":
            if on_rev is None:
                raise ValueError("revive inside inserted content")
            for i, restored in enumerate(on_rev(m)):
                mm = (m.get("mods") or {}).get(str(i))
                out.append(mod_node(restored, mm) if mm else restored)
        elif t == "mod":
            target = copy.deepcopy(seq[pos]) if pos < len(seq) \
                else {"type": "repair-missing"}
            out.append(mod_node(target, m))
            pos += 1
        elif t == "tomb":
            pass  # muted: no effect
        else:
            raise ValueError(f"unknown mark {t!r}")
    out.extend(seq[pos:])
    return out


def _apply_marks_to_content(seq: list, marks: MarkList) -> list:
    """Apply a mark list to literal content (no repair store)."""
    return walk_apply(seq, marks)


def _compose_marks(a_marks: MarkList, b_marks: MarkList) -> MarkList:
    """``a`` then ``b``: b consumes a's output sequence."""
    a = _Queue(a_marks)
    out: MarkList = []
    # b-del erasing an a-attach (ins+del -> never existed; rev+del ->
    # stays detached) also erases that del's IDENTITY — a rev in b
    # paired to it (b moving nodes a just attached) would orphan.
    # Record what each erased-del node really was so the post-pass can
    # rewrite such revs into direct attaches of the source.
    erased: dict = {}
    for bm in copy.deepcopy(b_marks):
        if bm["t"] == "tomb" or is_attach(bm):
            out.append(bm)
            continue
        need = in_len(bm)
        while need > 0:
            am = a.peek()
            if am is None:
                # b extends past a's explicit output: applies verbatim
                out.append(bm)
                need = 0
                break
            if out_len(am) == 0:  # a's del / tomb: pass through
                out.append(a.pop())
                continue
            apiece = a.take_output(need)
            m = out_len(apiece)
            if in_len(bm) > m:
                bpiece, bm = _split(bm, m)
            else:
                bpiece, bm = bm, None
            out.extend(_compose_pair(apiece, bpiece, erased))
            need -= in_len(bpiece)
            if bm is None:
                break
    while not a.empty:
        out.append(a.pop())
    if erased:
        out = _reroute_erased_revs(out, erased)
    return normalize(out)


def _reroute_erased_revs(marks: MarkList, erased: dict) -> MarkList:
    """Rewrite rev pieces whose source del was erased in composition:
    nodes born of an erased ins attach as fresh content; nodes that
    were a re-detach of an older revive re-attach under the ORIGINAL
    detach identity."""
    out: MarkList = []
    for m in marks:
        if m["t"] != "rev":
            out.append(m)
            continue
        i = 0
        while i < m["n"]:
            src = erased.get((m["rev"], m["idx"] + i))
            if src is None:
                j = i
                while j < m["n"] and erased.get(
                    (m["rev"], m["idx"] + j)
                ) is None:
                    j += 1
                keep = {**m, "n": j - i, "idx": m["idx"] + i}
                if "mods" in m:
                    sel = {str(int(o) - i): mm
                           for o, mm in m["mods"].items()
                           if i <= int(o) < j}
                    if sel:
                        keep["mods"] = sel
                    else:
                        keep.pop("mods", None)
                out.append(keep)
                i = j
                continue
            kind, payload = src[0], src[1:]
            if kind == "content":
                nd = copy.deepcopy(payload[0])
                mm = (m.get("mods") or {}).get(str(i))
                out.append(ins([_mod_node(nd, mm) if mm else nd]))
            else:  # ("rev", orig_u, orig_idx)
                piece = {"t": "rev", "n": 1, "rev": payload[0],
                         "idx": payload[1]}
                mm = (m.get("mods") or {}).get(str(i))
                if mm is not None:
                    piece["mods"] = {"0": mm}
                out.append(piece)
            i += 1
    return out


def _compose_pair(am: Mark, bm: Mark,
                  erased: Optional[dict] = None) -> MarkList:
    """Net marks for an aligned (a output piece, b sized piece)."""
    bt = bm["t"]
    at = am["t"]
    if bt == "skip":
        return [am]
    if bt == "del":
        if at == "skip":
            return [bm]
        if at == "ins":
            # inserted then deleted: never existed — but record the
            # erased identity's true content for paired revs (moves)
            if erased is not None and "did" in bm:
                u, b0 = bm["did"]
                for j, nd in enumerate(am["content"]):
                    erased[(u, b0 + j)] = ("content", nd)
            return []
        if at == "rev":
            # revived then re-deleted: stays detached under the
            # ORIGINAL identity; paired revs re-point there
            if erased is not None and "did" in bm:
                u, b0 = bm["did"]
                for j in range(am["n"]):
                    erased[(u, b0 + j)] = (
                        "rev", am["rev"], am["idx"] + j
                    )
            return []
        if at == "mod":
            return [{**bm, "n": 1}]  # changed then deleted: net delete
    if bt == "mod":
        if at == "skip":
            return [bm]
        if at == "ins":
            return [{**am, "content": [_mod_node(am["content"][0], bm)]}]
        if at == "rev":
            mods = dict(am.get("mods") or {})
            prior = mods.get("0")
            mods["0"] = _merge_mod(prior, bm) if prior else bm
            return [rev(am["n"], am["rev"], am["idx"], mods=mods)]
        if at == "mod":
            return [_merge_mod(am, bm)]
    raise ValueError(f"unhandled compose pair {at}/{bt}")


# ---------------------------------------------------------------------------
# invert

def invert(changes: FieldChanges, uid: Any) -> FieldChanges:
    """rebaser.ts:151 — the changeset undoing ``changes``. ``uid``
    names the inverse itself (its dels fall back to it when the source
    mark carries no birth identity). Dels become revs pointing at the
    source del's birth identity; inserts become rollback-dels carrying
    ``rbof`` (the ins identity) so marks muted by the rollback unmute
    when the insert is re-applied."""
    counters = {"d": 0, "a": 0}
    return _invert_fields(changes, uid, counters)


def _invert_fields(changes: FieldChanges, uid: Any,
                   counters: dict) -> FieldChanges:
    out: FieldChanges = {}
    for key in sorted(changes):
        if is_reg(changes[key]):
            inv = _invert_reg(changes[key], uid, counters)
            if inv:
                out[key] = inv
            continue
        out[key] = _invert_marks(changes[key], uid, counters)
    return normalize_fields(out)


def _invert_marks(marks: MarkList, uid: Any, counters: dict) -> MarkList:
    out: MarkList = []
    for m in marks:
        t = m["t"]
        if t == "skip":
            out.append(skip(m["n"]))
        elif t == "ins":
            iid = m.get("iid", [uid, counters["a"]])
            base = m.get("ioff", 0)
            d = dele(len(m["content"]))
            d["rbof"] = [iid[0], iid[1], base]
            out.append(d)
            counters["a"] += 1
        elif t == "del":
            if "did" in m:
                u, i = m["did"]
            else:
                u, i = uid, counters["d"]
            out.append(rev(m["n"], u, i))
            counters["d"] += m["n"]
        elif t == "rev":
            d = dele(m["n"])
            d["did"] = [m["rev"], m["idx"]]  # re-detach the same nodes
            out.append(d)
        elif t == "mod":
            value = None
            if "value" in m:
                value = {"new": m["value"]["old"], "old": m["value"]["new"]}
            fields = _invert_fields(m.get("fields") or {}, uid, counters) \
                if m.get("fields") else None
            out.append(mod(value=value, fields=fields))
        elif t == "tomb":
            pass  # muted intent never applied; its inverse is nothing
    return normalize(out)


# ---------------------------------------------------------------------------
# rebase

def rebase(change: FieldChanges, over: FieldChanges) -> FieldChanges:
    """rebaser.ts:156 — re-express ``change`` (authored against the
    same base as ``over``) so it applies after ``over``."""
    out: FieldChanges = {}
    for key in sorted(set(change) | set(over)):
        cv, ov = change.get(key), over.get(key)
        if is_reg(cv) or is_reg(ov):
            reg = _rebase_reg(cv, ov)
            if reg:
                out[key] = reg
            continue
        marks = _rebase_marks(cv or [], ov or [])
        if marks:
            out[key] = marks
    return out


def _attach_identity(om: Mark) -> Optional[list]:
    """Identity key base for the nodes an over-attach (re)creates."""
    if om["t"] == "rev":
        return ["d", om["rev"], om["idx"]]
    if om["t"] == "ins" and "iid" in om:
        return ["i", om["iid"][0], om["iid"][1], om.get("ioff", 0)]
    return None


def _del_identity(om: Mark, offset: int) -> list:
    """Identity key for node ``offset`` within an over-delete."""
    if "rbof" in om:
        r = om["rbof"]
        return ["i", r[0], r[1], (r[2] if len(r) > 2 else 0) + offset]
    if "did" in om:
        return ["d", om["did"][0], om["did"][1] + offset]
    return ["d", None, offset]  # unstamped: unmatchable but harmless


def _mute(cpiece: Mark, om: Mark, offset: int) -> Mark:
    """Mute a sized change piece whose target nodes ``over`` deleted."""
    k = in_len(cpiece)
    was = cpiece if cpiece["t"] != "skip" else skip(k)
    return tomb(k, _del_identity(om, offset), was)


def _rebase_marks(c_marks: MarkList, o_marks: MarkList) -> MarkList:
    c = _Queue(c_marks)
    out: MarkList = []
    # (uid, idx) of change-del nodes muted by an over-delete -> the
    # over-delete's identity for that node; a rev half paired to them
    # (a move whose source was concurrently deleted) mutes too —
    # DELETE WINS — keyed so undoing the over-delete unmutes the move
    dead: dict = {}
    for om in copy.deepcopy(o_marks):
        t = om["t"]
        if t == "tomb":
            continue  # over's muted marks changed nothing
        if is_attach(om):
            _rebase_over_attach(c, om, out)
            continue
        total = in_len(om)
        need = total
        while need > 0:
            cm = c.peek()
            if cm is None:
                break  # change's implicit trailing skip
            if cm["t"] == "tomb":
                out.append(c.pop())
                continue
            if is_attach(cm):
                # change's attach binds here; the later-sequenced change
                # keeps the left slot at a tied position (breakTie)
                out.append(c.pop())
                continue
            cpiece = c.take_input(need)
            k = in_len(cpiece)
            if t == "skip":
                out.append(cpiece)
            elif t == "del":
                offset = total - need
                if cpiece["t"] == "del" and "did" in cpiece:
                    u, base = cpiece["did"]
                    for i in range(k):
                        dead[(u, base + i)] = _del_identity(
                            om, offset + i
                        )
                out.append(_mute(cpiece, om, offset))
            elif t == "mod":
                if cpiece["t"] == "mod":
                    out.append(_rebase_mod(cpiece, om))
                else:
                    out.append(cpiece)
            else:
                raise ValueError(f"unhandled rebase over {t}")
            need -= k
    while not c.empty:
        out.append(c.pop())
    if dead:
        out = _mute_paired_revs(out, dead)
    return normalize(out)


def _mute_paired_revs(marks: MarkList, dead: dict) -> MarkList:
    """Mute rev pieces whose source nodes an over-delete took (the
    rev half of a move whose del half just muted): tomb them under the
    over-delete's identity so a revive of THOSE nodes unmutes the move
    too."""
    out: MarkList = []
    for m in marks:
        if m["t"] != "rev":
            out.append(m)
            continue
        i = 0
        while i < m["n"]:
            key = dead.get((m["rev"], m["idx"] + i))
            j = i
            while j < m["n"] and (
                (dead.get((m["rev"], m["idx"] + j)) is None)
                == (key is None)
            ):
                j += 1
            piece = {**m, "n": j - i, "idx": m["idx"] + i}
            if "mods" in m:
                sel = {str(int(o) - i): mm
                       for o, mm in m["mods"].items()
                       if i <= int(o) < j}
                if sel:
                    piece["mods"] = sel
                else:
                    piece.pop("mods", None)
            if key is None:
                out.append(piece)
            else:
                # per-node tombs: the over-delete identities need not
                # be contiguous across the run
                for off in range(i, j):
                    p1 = {**piece, "n": 1, "idx": m["idx"] + off}
                    mm = (m.get("mods") or {}).get(str(off))
                    if mm is not None:
                        p1["mods"] = {"0": mm}
                    else:
                        p1.pop("mods", None)
                    out.append(tomb(
                        1, dead[(m["rev"], m["idx"] + off)], p1
                    ))
            i = j
    return out


def _tomb_match_offset(cm: Mark, ident: Optional[list],
                       width: int) -> Optional[int]:
    """If tomb ``cm`` names nodes the over-attach restores, return the
    tomb's start offset within the attach span."""
    if ident is None or cm["t"] != "tomb":
        return None
    key = cm["key"]
    if key[:-1] != ident[:-1]:
        return None
    off = key[-1] - ident[-1]
    if 0 <= off < width:
        return off
    return None


def _rebase_over_attach(c: _Queue, om: Mark, out: MarkList) -> None:
    """Over attached ``out_len(om)`` nodes here. The rebased change
    steps over them — except tombs matching the restored nodes unmute
    back into live marks, and the change's own attaches keep their
    position among the tombs."""
    width = out_len(om)
    ident = _attach_identity(om)
    pos = 0
    while pos < width:
        cm = c.peek()
        if cm is None:
            break
        if is_attach(cm):
            if (cm["t"] == "rev" and om["t"] == "rev"
                    and cm["rev"] == om["rev"]):
                # concurrent revive of the same detached range: drop
                # the overlap (those nodes are already back)
                lo = max(cm["idx"], om["idx"])
                hi = min(cm["idx"] + cm["n"], om["idx"] + om["n"])
                if hi > lo:
                    cm = c.pop()
                    if cm["idx"] < lo:
                        out.append(_split(cm, lo - cm["idx"])[0])
                    if cm["idx"] + cm["n"] > hi:
                        out.append(_split(cm, hi - cm["idx"])[1])
                    continue
            out.append(c.pop())
            continue
        off = _tomb_match_offset(cm, ident, width)
        if off is not None and off >= pos:
            if off > pos:
                out.append(skip(off - pos))
                pos = off
            k = min(cm["n"], width - off)
            if cm["n"] > k:
                c.split_head(k)
            t = c.pop()
            out.append(t["was"])  # unmute
            pos += k
            continue
        if cm["t"] == "tomb":
            out.append(c.pop())  # unrelated mute: carry it along
            continue
        break  # sized mark: belongs after the attach span
    if pos < width:
        out.append(skip(width - pos))


def _rebase_mod(cm: Mark, om: Mark) -> Mark:
    value = cm.get("value")
    if value is not None and "value" in om:
        # over set the value first; our set still wins (later seq) but
        # must record over's value as the one it overwrote.
        value = {"new": value["new"], "old": om["value"]["new"]}
    fields = None
    if cm.get("fields"):
        fields = rebase(cm["fields"], om.get("fields") or {}) or None
    return mod(value=value, fields=fields)
