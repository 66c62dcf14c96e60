"""PropertyDDS — the typed property-tree DDS family.

Reference: experimental/PropertyDDS/packages — ``property-properties``
(typed property tree: NodeProperty containers, value properties with
typeids, array/map contexts), ``property-changeset`` (ChangeSet with
insert/modify/remove + SQUASH composition), ``property-dds``
(SharedPropertyTree: local edits accumulate into a working changeset
that COMMIT submits as one op).

The distinctive semantics rebuilt here (not shared by map/tree DDSes):

- **Typed schemas**: property templates are registered by typeid and
  validated at insert (property-properties PropertyFactory.register).
- **Commit model**: edits do NOT stream op-per-mutation; they squash
  into a working changeset locally and ship on ``commit()``
  (property-dds SharedPropertyTree.commit). Remote changesets apply
  atomically per commit.
- **ChangeSet squash**: insert∘modify = insert(updated), insert∘remove
  = nothing, modify∘modify = last, modify∘remove = remove, remove∘
  insert = replace-insert (property-changeset ChangeSet.applyChangeSet
  squash rules).
- **Path-addressed merge**: concurrent commits merge per path — LWW on
  modify, remove-wins over nested edits (a modify under a removed
  subtree is a no-op because the path no longer resolves).
"""
from __future__ import annotations

import copy
from typing import Any, Optional

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter

PRIMITIVES = {"Int32", "Float64", "String", "Bool"}
_DEFAULTS = {"Int32": 0, "Float64": 0.0, "String": "", "Bool": False}


class PropertySchemaRegistry:
    """PropertyFactory.register analogue: templates by typeid."""

    def __init__(self):
        self._templates: dict[str, dict] = {}

    def register(self, template: dict) -> None:
        tid = template["typeid"]
        for prop in template.get("properties", []):
            if "id" not in prop or "typeid" not in prop:
                raise ValueError(f"malformed template {tid!r}")
        self._templates[tid] = template

    def get(self, typeid: str) -> Optional[dict]:
        return self._templates.get(typeid)

    def instantiate(self, typeid: str, value: Any = None) -> dict:
        """Build a property node of ``typeid`` (recursively for
        template-typed children)."""
        if typeid in PRIMITIVES:
            v = value if value is not None else _DEFAULTS[typeid]
            _check_primitive(typeid, v)
            return {"typeid": typeid, "value": v}
        if typeid in ("NodeProperty", "map", "array"):
            node = {"typeid": typeid,
                    "children": {} if typeid != "array" else []}
            return node
        template = self.get(typeid)
        if template is None:
            raise ValueError(f"unregistered typeid {typeid!r}")
        children: dict[str, dict] = {}
        for prop in template.get("properties", []):
            ctx = prop.get("context", "single")
            if ctx == "array":
                children[prop["id"]] = {"typeid": "array",
                                        "children": []}
            elif ctx == "map":
                children[prop["id"]] = {"typeid": "map",
                                        "children": {}}
            else:
                children[prop["id"]] = self.instantiate(prop["typeid"])
        node = {"typeid": typeid, "children": children}
        if value:
            for k, v in value.items():
                if k not in children:
                    raise ValueError(
                        f"{typeid!r} has no property {k!r}")
                ch = children[k]
                if ch["typeid"] in PRIMITIVES:
                    _check_primitive(ch["typeid"], v)
                    ch["value"] = v
                else:
                    raise ValueError(
                        f"cannot initialize non-primitive {k!r} inline")
        return node


def _check_primitive(typeid: str, v: Any) -> None:
    ok = {
        "Int32": lambda x: isinstance(x, int)
        and not isinstance(x, bool),
        "Float64": lambda x: isinstance(x, (int, float))
        and not isinstance(x, bool),
        "String": lambda x: isinstance(x, str),
        "Bool": lambda x: isinstance(x, bool),
    }[typeid]
    if not ok(v):
        raise TypeError(f"{v!r} is not a {typeid}")


# ----------------------------------------------------------------------
# changesets: {"insert": {path: node}, "modify": {path: value},
#              "remove": [path]}   (paths are "a.b.c" strings)


def empty_changeset() -> dict:
    return {"insert": {}, "modify": {}, "remove": []}


def is_empty(cs: dict) -> bool:
    return not cs["insert"] and not cs["modify"] and not cs["remove"]


def squash(base: dict, nxt: dict) -> dict:
    """base then nxt, composed (ChangeSet.applyChangeSet squash)."""
    out = copy.deepcopy(base)
    for path in nxt["remove"]:
        if path in out["insert"]:
            # insert∘remove annihilates
            del out["insert"][path]
        else:
            owner = _insert_owning(out["insert"], path)
            if owner is not None:
                # the removed path lives INSIDE a pending insert:
                # delete it from the insert spec (a global remove
                # would no-op — removes apply before inserts)
                ins_path, node = owner
                _remove_in_node(node, _rel(path, ins_path))
            elif path not in out["remove"]:
                out["remove"].append(path)
        # drop any earlier edits at/under the removed path
        out["modify"] = {
            p: v for p, v in out["modify"].items()
            if not _under(p, path)
        }
        out["insert"] = {
            p: v for p, v in out["insert"].items()
            if not _under(p, path)
        }
    for path, node in nxt["insert"].items():
        # remove∘insert = replace (keep the remove so apply clears
        # first), insert wins the slot
        out["insert"][path] = copy.deepcopy(node)
    for path, val in nxt["modify"].items():
        owner = _insert_owning(out["insert"], path)
        if owner is not None:
            ins_path, node = owner
            _modify_in_node(node, _rel(path, ins_path), val)
        else:
            out["modify"][path] = val
    return out


def _under(path: str, prefix: str) -> bool:
    return path == prefix or path.startswith(prefix + ".")


def _insert_owning(inserts: dict, path: str):
    for ip, node in inserts.items():
        if _under(path, ip):
            return ip, node
    return None


def _rel(path: str, prefix: str) -> list[str]:
    if path == prefix:
        return []
    return path[len(prefix) + 1:].split(".")


def _remove_in_node(node: dict, rel: list[str]) -> None:
    cur = node
    for part in rel[:-1]:
        kids = cur.get("children")
        if kids is None:
            return
        cur = kids[int(part)] if isinstance(kids, list) else kids[part]
    kids = cur.get("children")
    leaf = rel[-1]
    if isinstance(kids, list):
        i = int(leaf)
        if 0 <= i < len(kids):
            del kids[i]
    elif kids is not None:
        kids.pop(leaf, None)


def _modify_in_node(node: dict, rel: list[str], val: Any) -> None:
    cur = node
    for part in rel:
        kids = cur.get("children")
        if isinstance(kids, list):
            cur = kids[int(part)]
        else:
            cur = kids[part]
    _check_primitive(cur["typeid"], val) \
        if cur["typeid"] in PRIMITIVES else None
    cur["value"] = val


# ----------------------------------------------------------------------
# the DDS


class SharedPropertyTree(SharedObject, EventEmitter):
    """property-dds SharedPropertyTree: a typed property tree with
    squash-on-commit changesets."""

    type_name = "sharedpropertytree"

    def __init__(self, channel_id: str,
                 schemas: Optional[PropertySchemaRegistry] = None):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self.schemas = schemas or PropertySchemaRegistry()
        self._root: dict = {"typeid": "NodeProperty", "children": {}}
        self._working = empty_changeset()   # uncommitted local edits
        self._pending: list[dict] = []      # committed, unacked

    # ---- navigation

    def _resolve(self, state: dict, path: str,
                 create: bool = False) -> Optional[dict]:
        if path == "":
            return state
        cur = state
        for part in path.split("."):
            kids = cur.get("children")
            if kids is None:
                return None
            if isinstance(kids, list):
                i = int(part)
                if not (0 <= i < len(kids)):
                    return None
                cur = kids[i]
            elif part in kids:
                cur = kids[part]
            else:
                return None
        return cur

    def resolve(self, path: str) -> Optional[dict]:
        """Resolve against the local (optimistic) view."""
        return self._resolve(self._local_view(), path)

    def get_value(self, path: str, default: Any = None) -> Any:
        node = self.resolve(path)
        return default if node is None else node.get("value", default)

    # ---- editing (property-properties mutation API)

    def insert_property(self, path: str, typeid: str,
                        value: Any = None) -> None:
        node = self.schemas.instantiate(typeid, value)
        self._working = squash(
            self._working,
            {"insert": {path: node}, "modify": {}, "remove": []})
        self.emit("changed", path)

    def set_value(self, path: str, value: Any) -> None:
        view = self._local_view()
        target = self._resolve(view, path)
        if target is None:
            raise KeyError(f"no property at {path!r}")
        if target["typeid"] in PRIMITIVES:
            _check_primitive(target["typeid"], value)
        self._working = squash(
            self._working,
            {"insert": {}, "modify": {path: value}, "remove": []})
        self.emit("changed", path)

    def remove_property(self, path: str) -> None:
        self._working = squash(
            self._working,
            {"insert": {}, "modify": {}, "remove": [path]})
        self.emit("changed", path)

    def commit(self) -> None:
        """Ship the squashed working changeset as ONE op
        (SharedPropertyTree.commit)."""
        if is_empty(self._working):
            return
        cs, self._working = self._working, empty_changeset()
        self._pending.append(cs)
        self.submit_local_message({"changeset": cs})

    @property
    def dirty(self) -> bool:
        return not is_empty(self._working)

    # ---- state

    def _apply_changeset(self, state: dict, cs: dict) -> None:
        for path in cs["remove"]:
            self._remove_at(state, path)
        for path, node in cs["insert"].items():
            parent_path, _, leaf = path.rpartition(".")
            parent = self._resolve(state, parent_path)
            if parent is None:
                continue  # parent concurrently removed: edit is moot
            kids = parent.get("children")
            if isinstance(kids, list):
                i = min(int(leaf), len(kids))
                kids.insert(i, copy.deepcopy(node))
            elif kids is not None:
                kids[leaf] = copy.deepcopy(node)
        for path, val in cs["modify"].items():
            target = self._resolve(state, path)
            if target is None:
                continue  # concurrently removed: remove wins
            target["value"] = val

    def _remove_at(self, state: dict, path: str) -> None:
        parent_path, _, leaf = path.rpartition(".")
        parent = self._resolve(state, parent_path)
        if parent is None:
            return
        kids = parent.get("children")
        if isinstance(kids, list):
            i = int(leaf)
            if 0 <= i < len(kids):
                del kids[i]
        elif kids is not None:
            kids.pop(leaf, None)

    def _local_view(self) -> dict:
        view = copy.deepcopy(self._root)
        for cs in self._pending:
            self._apply_changeset(view, cs)
        self._apply_changeset(view, self._working)
        return view

    # ---- SharedObject contract

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        cs = msg.contents["changeset"]
        self._apply_changeset(self._root, cs)
        if local and self._pending:
            self._pending.pop(0)
        self.emit("commitApplied", local)

    def resubmit_core(self, contents: Any, metadata: Any = None) -> None:
        self.submit_local_message(contents, metadata)

    def apply_stashed_op(self, contents: Any) -> Any:
        self._pending.append(contents["changeset"])
        return contents

    def summarize_core(self) -> dict:
        assert not self._pending and is_empty(self._working), \
            "summarize with uncommitted local changes"
        return {"version": 1, "root": copy.deepcopy(self._root)}

    def load_core(self, summary: dict) -> None:
        self._root = copy.deepcopy(summary["root"])

    def signature(self) -> Any:
        return self._root
