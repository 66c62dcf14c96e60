"""Legacy SharedTree — the anchor-based tree DDS (previous generation).

Reference: experimental/dds/tree/src — ``SharedTree.ts``,
``TransactionInternal.ts`` (edit = atomic sequence of change atoms
validated against the current view), ``ChangeTypes.ts`` (Insert /
Detach / Build / SetValue / Constraint over ``StablePlace`` /
``StableRange`` anchors), ``EditLog.ts`` + ``LogViewer.ts`` (edit
history + view reconstruction), ``HistoryEditFactory.ts`` (undo =
inverse edit built from repair data).

Where the NEW SharedTree (models/tree/) rebases changesets, the legacy
design anchors every edit to stable NODE IDS and re-resolves the
anchors at apply time: concurrency is handled by dropping whole edits
whose anchors no longer resolve (EditStatus Malformed/Invalid) rather
than by rebasing marks. That makes the merge rule trivially
commutative per edit and is why this DDS family survived long enough
to ship — and why it lost to the rebasing design for fidelity.

This implementation is state-of-the-art for the repo's runtime: the
sequenced path applies edits to a ``_global`` node store; the local
optimistic view is ``_global`` + pending edits re-applied (the same
global/local split as the OT bridge, ot.ts:42), so interleaved remote
edits implicitly "rebase" pending anchors by re-resolution.
"""
from __future__ import annotations

import copy
import itertools
from typing import Any, Optional

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter

ROOT = "root"

# EditStatus (persisted-types / TransactionInternal.ts)
APPLIED = "applied"
INVALID = "invalid"       # well-formed but anchors/constraints fail
MALFORMED = "malformed"   # structurally bad


# ----------------------------------------------------------------------
# anchors (ChangeTypes.ts StablePlace/StableRange)


def place_before(node_id: str) -> dict:
    return {"side": "before", "sibling": node_id}


def place_after(node_id: str) -> dict:
    return {"side": "after", "sibling": node_id}


def place_at_start(parent: str, label: str) -> dict:
    return {"side": "after", "trait": {"parent": parent, "label": label}}


def place_at_end(parent: str, label: str) -> dict:
    return {"side": "before", "trait": {"parent": parent, "label": label}}


def range_of(start: dict, end: dict) -> dict:
    return {"start": start, "end": end}


def range_all(parent: str, label: str) -> dict:
    return range_of(place_at_start(parent, label),
                    place_at_end(parent, label))


# change atom constructors (ChangeTypes.ts Change.*)


def build(source: int, nodes: list) -> dict:
    """Create a detached subtree under DetachedSequenceId ``source``.
    Node spec: {"definition", "identifier", "payload"?, "traits"?}."""
    return {"type": "build", "source": source, "nodes": nodes}


def insert(source: int, destination: dict) -> dict:
    return {"type": "insert", "source": source,
            "destination": destination}


def detach(source: dict, destination: Optional[int] = None) -> dict:
    return {"type": "detach", "source": source,
            "destination": destination}


def set_value(node_id: str, payload: Any) -> dict:
    return {"type": "set_value", "node": node_id, "payload": payload}


def constraint(range_: dict, length: Optional[int] = None) -> dict:
    """Edit precondition: the range must resolve (and optionally have
    ``length`` nodes) or the whole edit is dropped."""
    return {"type": "constraint", "range": range_, "length": length}


def delete_(range_: dict) -> dict:
    return detach(range_)


def move(source: dict, destination: dict, seq: int = 0) -> list:
    return [detach(source, destination=seq),
            insert(seq, destination)]


def insert_tree(nodes: list, destination: dict, seq: int = 0) -> list:
    return [build(seq, nodes), insert(seq, destination)]


# ----------------------------------------------------------------------
# the view: a node store


class _View:
    """Mutable tree state: node id -> record. Traits are ordered child
    id lists; parents tracked for range resolution (TreeView.ts)."""

    def __init__(self):
        self.nodes: dict[str, dict] = {
            ROOT: {"definition": ROOT, "payload": None, "traits": {},
                   "parent": None},
        }

    def clone(self) -> "_View":
        v = _View.__new__(_View)
        v.nodes = copy.deepcopy(self.nodes)
        return v

    def has(self, node_id: str) -> bool:
        return node_id in self.nodes

    def trait(self, parent: str, label: str) -> list:
        return self.nodes[parent]["traits"].get(label, [])

    def _materialize(self, spec: dict, out: dict) -> str:
        nid = spec["identifier"]
        if nid in self.nodes or nid in out:
            raise _Malformed(f"duplicate node id {nid!r}")
        out[nid] = {
            "definition": spec["definition"],
            "payload": spec.get("payload"),
            "traits": {},
            "parent": None,
        }
        for label, kids in (spec.get("traits") or {}).items():
            ids = [self._materialize(k, out) for k in kids]
            out[nid]["traits"][label] = ids
            for k in ids:
                out[k]["parent"] = (nid, label)
        return nid

    # -- anchor resolution (EditUtilities.ts validateStablePlace) ------

    def resolve_place(self, place: dict) -> tuple[str, str, int]:
        """-> (parent, label, index) where index is the insertion gap
        position in the trait."""
        sib = place.get("sibling")
        if sib is not None:
            rec = self.nodes.get(sib)
            if rec is None or rec["parent"] is None:
                raise _Invalid(f"sibling {sib!r} not in tree")
            parent, label = rec["parent"]
            idx = self.trait(parent, label).index(sib)
            return parent, label, idx + (1 if place["side"] == "after"
                                         else 0)
        tr = place.get("trait")
        if tr is None:
            raise _Malformed("place needs sibling or trait")
        if tr["parent"] not in self.nodes:
            raise _Invalid(f"trait parent {tr['parent']!r} not in tree")
        n = len(self.trait(tr["parent"], tr["label"]))
        return tr["parent"], tr["label"], (0 if place["side"] == "after"
                                           else n)

    def resolve_range(self, rng: dict) -> tuple[str, str, int, int]:
        p1, l1, i1 = self.resolve_place(rng["start"])
        p2, l2, i2 = self.resolve_place(rng["end"])
        if (p1, l1) != (p2, l2):
            raise _Invalid("range endpoints in different traits")
        if i1 > i2:
            raise _Invalid("inverted range")
        return p1, l1, i1, i2


class _Invalid(Exception):
    pass


class _Malformed(Exception):
    pass


# ----------------------------------------------------------------------
# transaction (TransactionInternal.ts)


def apply_edit(view: _View, changes: list) -> tuple[str, dict]:
    """Apply one edit's change atoms ATOMICALLY to ``view``. Returns
    (status, repair): on APPLIED the view is mutated and ``repair``
    holds everything needed to invert (HistoryEditFactory.ts); on
    INVALID/MALFORMED the view is untouched."""
    work = view.clone()
    detached: dict[int, list[str]] = {}
    # origin anchor per detached-sequence id: set by a
    # detach-with-destination (a move's first half) so the matching
    # insert's inverse can move the nodes BACK instead of deleting them
    origins: dict[int, Optional[dict]] = {}
    repair: dict = {"detached_subtrees": [], "inserted": [],
                    "values": []}
    try:
        for ch in changes:
            t = ch.get("type")
            if t == "build":
                if ch["source"] in detached:
                    raise _Malformed("detached id in use")
                created: dict = {}
                ids = [work._materialize(spec, created)
                       for spec in ch["nodes"]]
                work.nodes.update(created)
                detached[ch["source"]] = ids
                origins[ch["source"]] = None  # built, not moved
            elif t == "insert":
                ids = detached.pop(ch["source"], None)
                if ids is None:
                    raise _Malformed(
                        f"unknown detached id {ch['source']}")
                parent, label, idx = work.resolve_place(
                    ch["destination"])
                seq = work.nodes[parent]["traits"].setdefault(label, [])
                seq[idx:idx] = ids
                for nid in ids:
                    work.nodes[nid]["parent"] = (parent, label)
                repair["inserted"].append(
                    {"ids": ids,
                     "origin": origins.pop(ch["source"], None)})
            elif t == "detach":
                parent, label, i1, i2 = work.resolve_range(ch["source"])
                seq = work.nodes[parent]["traits"].get(label, [])
                cut = seq[i1:i2]
                del seq[i1:i2]
                for nid in cut:
                    work.nodes[nid]["parent"] = None
                if ch.get("destination") is not None:
                    if ch["destination"] in detached:
                        raise _Malformed("detached id in use")
                    detached[ch["destination"]] = cut
                    origins[ch["destination"]] = {
                        "parent": parent, "label": label,
                        "prev_sibling": seq[i1 - 1] if i1 > 0 else None,
                    }
                else:
                    # deleted: remember full subtrees for undo, plus a
                    # SIBLING anchor (the node just left of the cut at
                    # detach time) so the inverse re-resolves like any
                    # other anchor — and drops if that sibling is gone
                    anchor = {"parent": parent, "label": label,
                              "prev_sibling": seq[i1 - 1] if i1 > 0
                              else None}
                    repair["detached_subtrees"].append(
                        [_extract(work, nid) for nid in cut] + [anchor]
                    )
                    for nid in cut:
                        _delete_subtree(work, nid)
            elif t == "set_value":
                rec = work.nodes.get(ch["node"])
                if rec is None:
                    raise _Invalid(f"node {ch['node']!r} not in tree")
                repair["values"].append(
                    (ch["node"], rec["payload"]))
                rec["payload"] = ch["payload"]
            elif t == "constraint":
                parent, label, i1, i2 = work.resolve_range(ch["range"])
                if ch.get("length") is not None \
                        and i2 - i1 != ch["length"]:
                    raise _Invalid("constraint length violated")
            else:
                raise _Malformed(f"unknown change type {t!r}")
        if detached:
            raise _Malformed("edit left detached sequences behind")
    except _Invalid as e:
        return INVALID, {"reason": str(e)}
    except _Malformed as e:
        return MALFORMED, {"reason": str(e)}
    view.nodes = work.nodes
    return APPLIED, repair


def _extract(view: _View, nid: str) -> dict:
    rec = view.nodes[nid]
    return {
        "definition": rec["definition"],
        "identifier": nid,
        "payload": rec["payload"],
        "traits": {
            label: [_extract(view, k) for k in kids]
            for label, kids in rec["traits"].items()
        },
    }


def _delete_subtree(view: _View, nid: str) -> None:
    for kids in view.nodes[nid]["traits"].values():
        for k in kids:
            _delete_subtree(view, k)
    del view.nodes[nid]


def invert_edit(changes: list, repair: dict) -> list:
    """Inverse edit from repair data (HistoryEditFactory.ts): undo in
    reverse atom order. Only APPLIED edits are invertible."""
    out: list = []
    ids = itertools.count(1000)
    del_iter = iter(reversed(repair["detached_subtrees"]))
    ins_iter = iter(reversed(repair["inserted"]))
    val_iter = iter(reversed(repair["values"]))
    for ch in reversed(changes):
        t = ch["type"]
        if t == "insert":
            entry = next(ins_iter)
            inserted, origin = entry["ids"], entry["origin"]
            if not inserted:
                # insert consumed an empty detached sequence (move or
                # build of zero nodes): nothing to undo
                continue
            rng = range_of(place_before(inserted[0]),
                           place_after(inserted[-1]))
            if origin is None:
                # built content: the inverse deletes it
                out.append(detach(rng))
            else:
                # a move's second half: move the nodes BACK to where
                # the paired detach took them from
                seq = next(ids)
                out.append(detach(rng, destination=seq))
                if origin["prev_sibling"] is not None:
                    back = place_after(origin["prev_sibling"])
                else:
                    back = place_at_start(origin["parent"],
                                          origin["label"])
                out.append(insert(seq, back))
        elif t == "detach" and ch.get("destination") is None:
            entry = next(del_iter)
            subtrees, anchor = entry[:-1], entry[-1]
            if not subtrees:
                continue
            seq = next(ids)
            out.append(build(seq, subtrees))
            if anchor["prev_sibling"] is not None:
                dest = place_after(anchor["prev_sibling"])
            else:
                dest = place_at_start(anchor["parent"],
                                      anchor["label"])
            out.append(insert(seq, dest))
        elif t == "set_value":
            node_id, old = next(val_iter)
            out.append(set_value(node_id, old))
        # build with a consumed source inverts via its insert; builds
        # that errored never applied; constraints have no inverse
    return out


# ----------------------------------------------------------------------
# the DDS


class LegacySharedTree(SharedObject, EventEmitter):
    """experimental/dds/tree SharedTree.ts: an EditLog of atomic
    anchor-based edits over a node-id tree."""

    type_name = "legacysharedtree"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self._global = _View()
        self._pending: list[list] = []   # local unacked edits
        self._local: Optional[_View] = None  # lazy optimistic cache
        self.edit_log: list[dict] = []   # {"changes", "status", "id"}
        self._edit_ids = itertools.count()
        # repair data keyed by GLOBAL sequence number (edit_id is a
        # per-client counter — two clients' edit 0 would collide);
        # _local_edit_seq maps this client's edit ids to their seq
        self._repairs: dict[int, tuple[list, dict]] = {}
        self._local_edit_seq: dict[int, int] = {}

    # ---- views

    @property
    def view(self) -> _View:
        """Current optimistic view (EagerCheckout semantics)."""
        if self._local is None:
            v = self._global.clone()
            for changes in self._pending:
                apply_edit(v, changes)
            self._local = v
        return self._local

    def snapshot(self) -> dict:
        return _extract(self.view, ROOT)

    # ---- editing (SharedTree.applyEdit)

    def apply(self, *changes) -> int:
        """Submit one atomic edit; returns a local edit id usable for
        revert()."""
        flat: list = []
        for c in changes:
            flat.extend(c if isinstance(c, list) else [c])
        edit_id = next(self._edit_ids)
        self._pending.append(flat)
        self._local = None
        self.submit_local_message(
            {"type": "edit", "changes": flat, "edit_id": edit_id})
        return edit_id

    def revert(self, edit_id: int) -> Optional[int]:
        """Submit the inverse of one of OUR previously APPLIED
        sequenced edits (UndoRedoHandler.ts path)."""
        seq = self._local_edit_seq.get(edit_id)
        return self.revert_seq(seq) if seq is not None else None

    def revert_seq(self, seq: int) -> Optional[int]:
        """Submit the inverse of ANY applied sequenced edit by its
        sequence number (HistoryEditFactory over the EditLog)."""
        entry = self._repairs.get(seq)
        if entry is None:
            return None
        changes, repair = entry
        inv = invert_edit(changes, repair)
        return self.apply(*inv) if inv else None

    # ---- SharedObject contract

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        op = msg.contents
        changes = op["changes"]
        status, repair = apply_edit(self._global, changes)
        self.edit_log.append({
            "changes": changes, "status": status,
            "edit_id": op.get("edit_id"), "seq": msg.sequence_number,
        })
        if status == APPLIED:
            self._repairs[msg.sequence_number] = (changes, repair)
            if local and op.get("edit_id") is not None:
                self._local_edit_seq[op["edit_id"]] = \
                    msg.sequence_number
        if local and self._pending:
            self._pending.pop(0)
        self._local = None
        self.emit("editApplied", status, local)

    def resubmit_core(self, contents: Any, metadata: Any = None) -> None:
        # anchors re-resolve at apply time: resubmit verbatim
        self.submit_local_message(contents, metadata)

    def apply_stashed_op(self, contents: Any) -> Any:
        self._pending.append(contents["changes"])
        self._local = None
        return contents

    def summarize_core(self) -> dict:
        assert not self._pending, "summarize with pending local edits"
        return {
            "version": 1,
            "tree": _extract(self._global, ROOT),
            "edit_count": len(self.edit_log),
        }

    def load_core(self, summary: dict) -> None:
        v = _View()
        spec = summary["tree"]
        v.nodes[ROOT]["payload"] = spec.get("payload")
        for label, kids in (spec.get("traits") or {}).items():
            created: dict = {}
            ids = [v._materialize(k, created) for k in kids]
            v.nodes.update(created)
            v.nodes[ROOT]["traits"][label] = ids
            for k in ids:
                v.nodes[k]["parent"] = (ROOT, label)
        self._global = v
        self._local = None

    def signature(self) -> Any:
        return _extract(self._global, ROOT)
