"""SharedTree: the op-based tree DDS with rebasing merge semantics.

Reference: packages/dds/tree/src/shared-tree-core/sharedTreeCore.ts:73
(SharedObject glue: ``processCore`` -> ``editManager.addSequencedChange``
:209,:234; summaries from pluggable indexes — here a forest index and an
edit-manager index, mirroring feature-libraries/editManagerIndex.ts) and
shared-tree/ (the public editing facade).

Re-design: edits are path-addressed mark-list changesets
(``changeset.py``); the per-client path runs the EditManager replay;
the service-side batched path (totally ordered, no sandwich needed)
runs in ``ops.tree_kernel`` (the tree plane).

Paths: a field is addressed by alternating (field_key, node_index)
pairs ending in a field key, e.g. ``("children",)`` is the root field
"children" and ``("children", 2, "items")`` is field "items" of the
third root child.
"""
from __future__ import annotations

import copy
from typing import Any, Optional, Sequence

from ...protocol.messages import SequencedMessage
from ...protocol.tree_payload import (
    tree_change_from_json,
    tree_change_to_json,
)
from ...runtime.shared_object import SharedObject
from ...utils.events import EventEmitter
from . import changeset as cs
from .changeset import FieldChanges
from .editmanager import Commit, EditManager
from .forest import Forest, node
from .schema import SchemaViolation, StoredSchema


def wrap_path(path: Sequence, leaf_marks: list) -> FieldChanges:
    """Nest a mark list under a (field, index, field, index, ...) path
    by wrapping it in ``mod`` marks."""
    if len(path) % 2 != 1:
        raise ValueError("path must end on a field key")
    changes: FieldChanges = {path[-1]: leaf_marks}
    for i in range(len(path) - 3, -1, -2):
        key, idx = path[i], path[i + 1]
        changes = {key: [cs.skip(idx), cs.mod(fields=changes)]
                   if idx else [cs.mod(fields=changes)]}
    return changes


class SharedTree(SharedObject, EventEmitter):
    type_name = "sharedtree"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self._em = EditManager(session_id="detached")
        # stored schema (core/schema-stored): None = unconstrained
        self._schema: Optional[StoredSchema] = None
        # open transaction: list of local revision tags (core/
        # transaction; edits buffer locally, commit squashes + submits)
        self._txn: Optional[list] = None

    # ------------------------------------------------------------------

    def _on_connect(self) -> None:
        if self.client_id:
            self._em.session_id = self.client_id

    # ------------------------------------------------------------------
    # reading

    @property
    def forest(self) -> Forest:
        return self._em.forest()

    def root(self) -> dict:
        """Canonical content: {field: [nodes]}."""
        return self._em.forest().content()

    def get_field(self, path: Sequence) -> list:
        fields = self._em.forest().fields
        i = 0
        while i < len(path) - 1:
            fields = fields[path[i]][path[i + 1]].get("fields", {})
            i += 2
        return fields.get(path[-1], [])

    def _parent_type(self, path: Sequence) -> Optional[str]:
        """Node type owning field ``path[-1]`` (None at the root)."""
        if len(path) == 1:
            return None
        from .schema import SchemaViolation

        fields = self._em.forest().fields
        i = 0
        try:
            while i < len(path) - 3:
                fields = fields[path[i]][path[i + 1]].get("fields", {})
                i += 2
            return fields[path[i]][path[i + 1]].get("type")
        except (KeyError, IndexError):
            raise SchemaViolation(
                f"edit path {tuple(path)!r} does not resolve to an "
                "existing node under the stored schema"
            ) from None

    def editable(self):
        """Typed editing surface (feature-libraries/editable-tree)."""
        from .editable import EditableRoot

        return EditableRoot(self)

    # ------------------------------------------------------------------
    # stored schema (modular-schema / schema-stored)

    @property
    def stored_schema(self) -> Optional[StoredSchema]:
        return self._schema

    def set_stored_schema(self, schema: StoredSchema) -> None:
        """Propose a stored schema: current content must conform; the
        schema activates when its op SEQUENCES (on every client,
        deterministically) — adopting it optimistically would let a
        concurrent edit that sequences first leave replicas holding a
        schema the document violates. If the tree no longer conforms
        at sequencing time the op is dropped everywhere
        (schemaRejected event) — the same deterministic-outcome rule
        consensus DDSes use."""
        schema.validate_tree(self._em.forest().fields)
        self.submit_local_message({
            "type": "tree-schema", "schema": schema.to_json(),
        })

    # ------------------------------------------------------------------
    # transactions (core/transaction + core/checkout)

    def begin_transaction(self) -> None:
        assert self._txn is None, "transactions do not nest"
        self._txn = []

    def commit_transaction(self) -> None:
        assert self._txn is not None, "no open transaction"
        tags, self._txn = self._txn, None
        if not tags:
            return
        composed, tag = self._em.squash_local(tags)
        self.submit_local_message(
            tree_change_to_json(composed), metadata={"tag": tag},
        )
        self.emit("changed", local=True)

    def abort_transaction(self) -> None:
        """Roll every edit of the transaction back (repair data makes
        deleted subtrees reattachable — forestRepairDataStore)."""
        assert self._txn is not None, "no open transaction"
        tags, self._txn = self._txn, None
        if tags:
            self._em.drop_local(tags)
        self.emit("changed", local=True)

    class _Transaction:
        def __init__(self, tree: "SharedTree"):
            self._tree = tree

        def __enter__(self):
            self._tree.begin_transaction()
            return self._tree

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None:
                self._tree.commit_transaction()
            else:
                self._tree.abort_transaction()
            return False

    def transaction(self) -> "SharedTree._Transaction":
        """``with tree.transaction(): ...`` — commits on success,
        aborts (exact rollback) on exception."""
        return SharedTree._Transaction(self)

    # ------------------------------------------------------------------
    # anchors (core/tree/anchorSet.ts)

    def track_anchor(self, path: Sequence, index: int):
        """Stable reference to the node at ``path``[``index``]; use
        ``locate_anchor`` to read its current position (None once the
        node is deleted)."""
        return self._em.anchors.track(tuple(path) + (index,))

    def locate_anchor(self, anchor):
        return self._em.anchors.locate(anchor)

    def forget_anchor(self, anchor) -> None:
        self._em.anchors.forget(anchor)

    # ------------------------------------------------------------------
    # editing (the sequence-field editor surface)

    def insert_nodes(self, path: Sequence, index: int,
                     content: list) -> None:
        if self._schema is not None:
            self._schema.validate_insert(
                self._parent_type(path), path[-1], content,
                len(self.get_field(path)) + len(content),
            )
        marks = ([cs.skip(index)] if index else []) + [cs.ins(content)]
        self._apply_local(wrap_path(path, marks))

    def delete_nodes(self, path: Sequence, index: int, count: int) -> None:
        if self._schema is not None:
            self._schema.validate_insert(
                self._parent_type(path), path[-1], [],
                len(self.get_field(path)) - count,
            )
        marks = ([cs.skip(index)] if index else []) + [cs.dele(count)]
        self._apply_local(wrap_path(path, marks))

    def move_nodes(self, path: Sequence, src: int, count: int,
                   dst: int) -> None:
        """Move ``count`` nodes within the field at ``path`` from
        input position ``src`` to input position ``dst`` (expressed
        against the CURRENT view; dst outside the moved range).
        Same-field, so the stored schema's type/cardinality
        constraints are unaffected. Concurrency: delete wins — see
        changeset.move."""
        self._apply_local(wrap_path(path, cs.move(src, count, dst)))

    def set_register(self, path: Sequence, content: Optional[dict]
                     ) -> None:
        """Write a value/optional REGISTER field (modular-schema's
        second field kind): replace the field's single node with
        ``content`` (None clears an optional field). Concurrent
        writes are LWW by sequencing — two clients filling the same
        optional field converge to ONE winner, closing the
        concurrent-fill drift the sequence-kind collapse had
        (schema.py's old known-limitation note)."""
        kind = None
        if self._schema is not None:
            fs = self._schema.field_schema(
                self._parent_type(path), path[-1])
            kind = fs.kind if fs is not None else None
            if kind not in (None, "value", "optional"):
                raise SchemaViolation(
                    f"set_register on a {kind!r} field")
            if content is None and kind == "value":
                raise SchemaViolation("value field cannot be cleared")
            if content is not None:
                self._schema.validate_insert(
                    self._parent_type(path), path[-1], [content], 1,
                )
        current = self.get_field(path)
        old = current[0] if current else None
        change = cs.reg_set(content, old,
                            optional=(kind != "value"))
        self._apply_local(wrap_path(path, change))

    def set_value(self, path: Sequence, index: int, value: Any) -> None:
        seq = self.get_field(path)
        old = seq[index].get("value") if index < len(seq) else None
        if self._schema is not None and index < len(seq):
            self._schema.validate_value(seq[index].get("type"), value)
        m = cs.mod(value={"new": value, "old": old})
        marks = ([cs.skip(index)] if index else []) + [m]
        self._apply_local(wrap_path(path, marks))

    def apply_changeset(self, changes: FieldChanges) -> None:
        """Escape hatch: submit a raw changeset."""
        self._apply_local(copy.deepcopy(changes))

    def _apply_local(self, changes: FieldChanges) -> None:
        tag = self._em.add_local_change(changes)
        if self._txn is not None:
            # buffered: commit_transaction squashes + submits once
            self._txn.append(tag)
        else:
            self.submit_local_message(
                tree_change_to_json(changes), metadata={"tag": tag},
            )
        self.emit("changed", local=True)

    # ------------------------------------------------------------------
    # SharedObject contract

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        op = msg.contents
        if isinstance(op, dict) and op.get("type") == "tree-schema":
            # stored-schema evolution: sequenced-order LWW, applied
            # only if the tree conforms AT SEQUENCING TIME (every
            # replica evaluates the same state -> same outcome)
            from .schema import SchemaViolation

            schema = StoredSchema.from_json(op["schema"])
            try:
                schema.validate_tree(self._em.forest().fields)
            except SchemaViolation:
                self.emit("schemaRejected", local=local)
                return
            self._schema = schema
            self.emit("schemaChanged", local=local)
            return
        changes = tree_change_from_json(op)
        if changes is None:
            raise ValueError(f"unexpected tree op: {op!r}")
        commit = Commit(session_id=msg.client_id or "",
                        seq=msg.sequence_number,
                        ref_seq=msg.reference_sequence_number,
                        changes=changes)
        self._em.add_sequenced_change(commit, is_local=local)
        if msg.minimum_sequence_number > self._em.min_seq:
            self._em.advance_minimum_sequence_number(
                msg.minimum_sequence_number)
        self.emit("changed", local=local)

    def resubmit_core(self, contents: Any, metadata: Any = None) -> None:
        """Reconnect rebase (sharedObject.ts:378): the EditManager keeps
        local changes rebased against the trunk tip, so resubmit sends
        the *current* form, found by its local revision tag."""
        if isinstance(contents, dict) and \
                contents.get("type") == "tree-schema":
            self.submit_local_message(contents, metadata)
            return
        tag = (metadata or {}).get("tag")
        for change, t in self._em.local_changes:
            if t == tag:
                self.submit_local_message(tree_change_to_json(change),
                                          metadata={"tag": tag})
                return
        # Unknown tag: the op was already sequenced; nothing to resend.

    def apply_stashed_op(self, contents: Any) -> Any:
        if contents.get("type") == "tree-schema":
            # a stashed schema proposal re-validates and resubmits;
            # activation still happens only at sequencing
            return None
        changes = contents["changes"]
        tag = self._em.add_local_change(changes)
        return {"tag": tag}

    def summarize_core(self) -> dict:
        """Forest index + edit-manager index
        (sharedTreeCore.ts:73 summary composed of indexes)."""
        em = self._em
        return {
            "forest": em.base_forest.content(),
            # repair data for deletes already evicted into the base
            # forest — without it a summary-loaded replica cannot honor
            # rev marks older than min_seq and diverges from live ones
            "repair": [[u, i, copy.deepcopy(n)]
                       for (u, i), n in sorted(
                           em.base_forest.repair.items(),
                           key=lambda kv: (str(kv[0][0]), kv[0][1]))],
            "trunk": [{"session": c.session_id, "seq": c.seq,
                       "ref": c.ref_seq, "changes": c.changes}
                      for c in em.trunk],
            "min_seq": em.min_seq,
            "schema": self._schema.to_json()
            if self._schema is not None else None,
        }

    def load_core(self, summary: dict) -> None:
        em = EditManager(session_id=self._em.session_id,
                         base=Forest(copy.deepcopy(summary["forest"])))
        for u, i, n in summary.get("repair", []):
            em.base_forest.repair[(u, i)] = copy.deepcopy(n)
        for c in summary["trunk"]:
            em.trunk.append(Commit(c["session"], c["seq"], c["ref"],
                                   c["changes"]))
        em.min_seq = summary["min_seq"]
        self._em = em
        schema = summary.get("schema")
        self._schema = (
            StoredSchema.from_json(schema) if schema else None
        )

    def signature(self) -> Any:
        return self._em.forest().signature()
