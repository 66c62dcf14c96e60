"""Forest: the tree state changesets apply to, plus repair data.

Reference semantics: packages/dds/tree/src/core/forest (IForest, 305 LoC)
with the object-forest implementation
(feature-libraries/object-forest) and the repair-data store
(feature-libraries/forestRepairDataStore.ts) that captures detached
subtrees so inverted deletes (``rev`` marks) can reattach real content.

TPU-native re-design: nodes are plain JSON-safe dicts
``{"type": str, "value": any, "fields": {key: [child nodes]}}`` — the
same shape the wire format and summaries use, and the shape the batched
tree kernel flattens into (parent, field, position, type, value) columns.
A forest is a root field map. Applying a changeset walks marks in list
order with nested fields sorted by key; every ``del`` stores its
detached subtrees in ``repair[(revision, running_index)]``, the exact
order :func:`changeset.invert` assigns detach indexes, so a later
``rev`` mark can fetch them by ``(rev, idx)``.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Optional

from .changeset import (
    FieldChanges,
    MarkList,
    _reg_apply as reg_apply,
    is_reg,
    walk_apply,
)


def node(type_: str, value: Any = None,
         fields: Optional[dict] = None) -> dict:
    n: dict = {"type": type_}
    if value is not None:
        n["value"] = value
    if fields:
        n["fields"] = fields
    return n


def root_signature(nodes: list) -> str:
    """Signature of a root field's node list, in ``Forest.signature``'s
    convention (sorted-key JSON of ``{"root": nodes}``): what the tree
    sidecar serves and its oracles are held to."""
    return json.dumps({"root": nodes}, sort_keys=True, default=str)


class Forest:
    """Mutable tree state for one SharedTree."""

    def __init__(self, fields: Optional[dict] = None):
        self.fields: dict[str, list] = fields or {}
        # (revision, detach_index) -> detached subtree, one per node
        self.repair: dict[tuple, dict] = {}

    # ------------------------------------------------------------------

    def clone(self) -> "Forest":
        f = Forest(copy.deepcopy(self.fields))
        f.repair = dict(self.repair)
        return f

    def content(self) -> dict:
        """Canonical user-visible state (no repair data)."""
        return copy.deepcopy(self.fields)

    def signature(self) -> str:
        return json.dumps(self.fields, sort_keys=True, default=str)

    # ------------------------------------------------------------------

    def apply(self, changes: FieldChanges, revision: Any) -> None:
        """Apply a changeset, capturing repair data under
        ``revision``. Capture runs as a PRE-PASS over the whole
        changeset so a rev may reference a del of the SAME changeset
        regardless of mark order — that is exactly a move
        (changeset.move: detach+revive pair)."""
        counter = [0]
        self._capture_fields(self.fields, changes, revision, counter)
        counter[0] = 0
        self._apply_fields(self.fields, changes, revision, counter)

    def _capture_fields(self, fields: dict, changes: FieldChanges,
                        revision: Any, counter: list) -> None:
        for key in sorted(changes):
            ch = changes[key]
            if is_reg(ch):
                # register fields: only the nested mods touch existing
                # content (the set's old rides inline; post applies to
                # fresh content and captures late, during apply)
                if ch.get("mods"):
                    self._capture_marks(
                        fields.get(key, []), ch["mods"], revision,
                        counter,
                    )
                continue
            self._capture_marks(
                fields.get(key, []), ch, revision, counter
            )

    def _capture_marks(self, seq: list, marks: MarkList,
                       revision: Any, counter: list) -> None:
        pos = 0
        for m in marks:
            t = m["t"]
            if t == "del":
                u, base = m["did"] if "did" in m \
                    else (revision, counter[0])
                for i, nd in enumerate(seq[pos:pos + m["n"]]):
                    self.repair[(u, base + i)] = copy.deepcopy(nd)
                counter[0] += m["n"]
                pos += m["n"]
            elif t == "skip":
                pos += m["n"]
            elif t == "mod":
                if m.get("fields"):
                    # recurse even when pos is past the end of the
                    # field (the apply walk mods a dummy node there):
                    # nested dels must still consume counter slots or
                    # the pre-pass keys desynchronize from the walk's
                    # — and from changeset.invert's — del numbering
                    sub = seq[pos].get("fields", {}) \
                        if pos < len(seq) else {}
                    self._capture_fields(
                        sub, m["fields"], revision, counter,
                    )
                pos += 1
            # ins / rev / tomb consume no input

    def _apply_fields(self, fields: dict, changes: FieldChanges,
                      revision: Any, counter: list) -> None:
        for key in sorted(changes):
            ch = changes[key]
            if is_reg(ch):
                fields[key] = reg_apply(
                    fields.get(key, []), ch,
                    lambda seq, marks: self._apply_marks(
                        seq, marks, revision, counter),
                )
                continue
            fields[key] = self._apply_marks(
                fields.get(key, []), ch, revision, counter)

    def _apply_marks(self, seq: list, marks: MarkList,
                     revision: Any, counter: list) -> list:
        """One shared walker (``changeset.walk_apply``) with repair
        hooks attached."""

        def on_del(m, nodes):
            # capture already ran in the pre-pass (Forest.apply); the
            # hook only keeps the unstamped-del counter in step with
            # the canonical walk order
            counter[0] += m["n"]

        def on_rev(m):
            out = []
            for i in range(m["n"]):
                sub = self.repair.get((m["rev"], m["idx"] + i))
                out.append(copy.deepcopy(sub) if sub is not None
                           else node("repair-missing"))
            return out

        def mod_node(nd, m):
            if "value" in m:
                nd["value"] = m["value"]["new"]
            if m.get("fields"):
                nd.setdefault("fields", {})
                self._apply_fields(nd["fields"], m["fields"],
                                   revision, counter)
            return nd

        return walk_apply(seq, marks, on_del=on_del, on_rev=on_rev,
                          mod_node=mod_node)
