"""Stored schema for SharedTree: field kinds + node type validation.

Reference: packages/dds/tree/src/feature-libraries/modular-schema/
(FieldKind-indexed composition), core/schema-stored (the document's
persisted schema) and schema-view. The reference registers field kinds
(value / optional / sequence / forbidden) and per-node-type allowed
child types; the stored schema is itself replicated document state.

Re-design: TWO concrete field-kind families — sequence
(the mark algebra) and REGISTER (value/optional fields: LWW
single-node writes, changeset.reg_set — the modular-schema second
kind). JSON-safe schema documents ride ops and summaries unchanged,
and validation happens at the editing surface so a schema violation
fails BEFORE an op is authored.

Cardinality under concurrency: value/optional fields edited through
the register kind (SharedTree.set_register / EditableField.set)
converge LWW — two clients concurrently filling an empty optional
field merge to ONE winner. Sequence-kind editing of a value/optional
field (insert/delete) remains subject to the optimistic-cardinality
caveat (author-local validation), same as any optimistic schema
system; readers can detect drift via ``validate_tree``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

# field multiplicity (modular-schema FieldKinds)
VALUE = "value"        # exactly one node
OPTIONAL = "optional"  # zero or one node
SEQUENCE = "sequence"  # any number of nodes
FORBIDDEN = "forbidden"

_KINDS = (VALUE, OPTIONAL, SEQUENCE, FORBIDDEN)

# node value constraints
VALUE_KINDS = ("none", "number", "string", "boolean", "any")


class SchemaViolation(ValueError):
    """An edit or tree does not conform to the stored schema."""


@dataclass
class FieldSchema:
    kind: str = SEQUENCE
    # None = any node type allowed
    allowed_types: Optional[tuple] = None

    def to_json(self) -> dict:
        out: dict = {"kind": self.kind}
        if self.allowed_types is not None:
            out["types"] = sorted(self.allowed_types)
        return out

    @classmethod
    def from_json(cls, data: dict) -> "FieldSchema":
        if data.get("kind", SEQUENCE) not in _KINDS:
            raise SchemaViolation(f"unknown field kind {data!r}")
        return cls(
            kind=data.get("kind", SEQUENCE),
            allowed_types=tuple(data["types"])
            if "types" in data else None,
        )


@dataclass
class NodeSchema:
    name: str
    value: str = "none"  # VALUE_KINDS
    fields: dict = field(default_factory=dict)  # key -> FieldSchema
    # open node: fields not listed are allowed as free sequences
    extra_fields: bool = False

    def to_json(self) -> dict:
        return {
            "value": self.value,
            "fields": {k: f.to_json() for k, f in self.fields.items()},
            "extraFields": self.extra_fields,
        }

    @classmethod
    def from_json(cls, name: str, data: dict) -> "NodeSchema":
        if data.get("value", "none") not in VALUE_KINDS:
            raise SchemaViolation(f"unknown value kind {data!r}")
        return cls(
            name=name,
            value=data.get("value", "none"),
            fields={
                k: FieldSchema.from_json(f)
                for k, f in data.get("fields", {}).items()
            },
            extra_fields=data.get("extraFields", False),
        )


_VALUE_CHECK = {
    "none": lambda v: v is None,
    "number": lambda v: isinstance(v, (int, float))
    and not isinstance(v, bool),
    "string": lambda v: isinstance(v, str),
    "boolean": lambda v: isinstance(v, bool),
    "any": lambda v: True,
}


class StoredSchema:
    """The document schema: node types + root field constraints.
    ``None`` anywhere means unconstrained (schema-off documents behave
    exactly as before)."""

    def __init__(self, nodes: Optional[dict] = None,
                 root_fields: Optional[dict] = None):
        self.nodes: dict[str, NodeSchema] = nodes or {}
        # root field key -> FieldSchema; None = open roots
        self.root_fields: Optional[dict] = root_fields

    # -- wire/summary form ---------------------------------------------

    def to_json(self) -> dict:
        out: dict = {
            "nodes": {n: s.to_json() for n, s in self.nodes.items()},
        }
        if self.root_fields is not None:
            out["root"] = {
                k: f.to_json() for k, f in self.root_fields.items()
            }
        return out

    @classmethod
    def from_json(cls, data: dict) -> "StoredSchema":
        return cls(
            nodes={
                n: NodeSchema.from_json(n, s)
                for n, s in data.get("nodes", {}).items()
            },
            root_fields={
                k: FieldSchema.from_json(f)
                for k, f in data["root"].items()
            } if "root" in data else None,
        )

    # -- validation ----------------------------------------------------

    def field_schema(self, node_type: Optional[str],
                     key: str) -> Optional[FieldSchema]:
        """Schema of field ``key`` under a node of ``node_type``
        (``None`` node_type = root)."""
        if node_type is None:
            if self.root_fields is None:
                return None  # open roots
            # a present-but-empty dict is a CLOSED root: every key
            # not listed is forbidden
            return self.root_fields.get(key, FieldSchema(FORBIDDEN))
        ns = self.nodes.get(node_type)
        if ns is None:
            return None  # untyped node: unconstrained
        fs = ns.fields.get(key)
        if fs is None:
            return None if ns.extra_fields else FieldSchema(FORBIDDEN)
        return fs

    def validate_node(self, node: dict) -> None:
        ntype = node.get("type")
        ns = self.nodes.get(ntype)
        if ns is None:
            if self.nodes:
                raise SchemaViolation(
                    f"node type {ntype!r} not in stored schema"
                )
            return
        if not _VALUE_CHECK[ns.value](node.get("value")):
            raise SchemaViolation(
                f"{ntype}: value {node.get('value')!r} violates "
                f"value kind {ns.value!r}"
            )
        for key, children in (node.get("fields") or {}).items():
            fs = self.field_schema(ntype, key)
            self._validate_field(fs, ntype, key, children)
            for child in children:
                self.validate_node(child)

    def _validate_field(self, fs: Optional[FieldSchema],
                        owner: Any, key: str, children: list) -> None:
        if fs is None:
            return
        if fs.kind == FORBIDDEN and children:
            raise SchemaViolation(
                f"{owner}: field {key!r} is forbidden"
            )
        if fs.kind == VALUE and len(children) != 1:
            raise SchemaViolation(
                f"{owner}.{key}: value field needs exactly one node, "
                f"got {len(children)}"
            )
        if fs.kind == OPTIONAL and len(children) > 1:
            raise SchemaViolation(
                f"{owner}.{key}: optional field holds at most one "
                f"node, got {len(children)}"
            )
        if fs.allowed_types is not None:
            for child in children:
                if child.get("type") not in fs.allowed_types:
                    raise SchemaViolation(
                        f"{owner}.{key}: type {child.get('type')!r} "
                        f"not in {sorted(fs.allowed_types)}"
                    )

    def validate_tree(self, fields: dict) -> None:
        """Validate a whole forest (used when adopting a schema over
        existing content and when loading summaries)."""
        for key, children in fields.items():
            fs = self.field_schema(None, key)
            self._validate_field(fs, "<root>", key, children)
            for child in children:
                self.validate_node(child)

    def validate_value(self, node_type: Optional[str],
                       value: Any) -> None:
        """Value-kind check alone (set_value path: children were
        validated at insert and cannot change here)."""
        ns = self.nodes.get(node_type)
        if ns is None:
            if self.nodes:
                raise SchemaViolation(
                    f"node type {node_type!r} not in stored schema"
                )
            return
        if not _VALUE_CHECK[ns.value](value):
            raise SchemaViolation(
                f"{node_type}: value {value!r} violates value kind "
                f"{ns.value!r}"
            )

    def validate_insert(self, parent_type: Optional[str], key: str,
                        content: list, resulting_len: int) -> None:
        """Validate inserting ``content`` into field ``key`` of a
        ``parent_type`` node (cardinality checked on the resulting
        length)."""
        fs = self.field_schema(parent_type, key)
        if fs is None:
            for n in content:
                self.validate_node(n)
            return
        if fs.kind == FORBIDDEN:
            raise SchemaViolation(f"field {key!r} is forbidden")
        if fs.kind == VALUE and resulting_len != 1:
            raise SchemaViolation(
                f"value field {key!r} must hold exactly one node"
            )
        if fs.kind == OPTIONAL and resulting_len > 1:
            raise SchemaViolation(
                f"optional field {key!r} overfilled"
            )
        if fs.allowed_types is not None:
            for n in content:
                if n.get("type") not in fs.allowed_types:
                    raise SchemaViolation(
                        f"field {key!r}: {n.get('type')!r} not allowed"
                    )
        for n in content:
            self.validate_node(n)
