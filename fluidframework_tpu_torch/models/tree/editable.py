"""Editable tree: the typed, path-free reading/editing surface.

Reference: packages/dds/tree/src/feature-libraries/editable-tree/
(proxy-based typed reading/editing, 1,964 LoC). This build keeps
the same shape — fields index like sequences, nodes expose value and
child fields, every mutation routes through the SharedTree editor (so
schema validation, transactions and anchors all apply) — with explicit
wrapper classes instead of JS proxies.

    root = tree.editable()
    items = root.field("items")
    items.insert(0, [node("item", value=1)])
    items[0].value = 2
    items[0].field("tags").append([node("tag", value="x")])
    del items[0:1]
"""
from __future__ import annotations

from typing import Any, Iterator, Sequence


class EditableField:
    """One sequence field, live against the tree (reads always reflect
    the current view)."""

    def __init__(self, tree, path: Sequence):
        self._tree = tree
        self._path = tuple(path)

    # -- reads -----------------------------------------------------------

    def _nodes(self) -> list:
        return self._tree.get_field(self._path)

    def __len__(self) -> int:
        return len(self._nodes())

    def __iter__(self) -> Iterator["EditableNode"]:
        for i in range(len(self)):
            yield EditableNode(self._tree, self._path, i)

    def __getitem__(self, i):
        n = len(self._nodes())
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(n))]
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return EditableNode(self._tree, self._path, i)

    @property
    def key(self) -> str:
        return self._path[-1]

    # -- edits -----------------------------------------------------------

    def insert(self, index: int, content: list) -> None:
        self._tree.insert_nodes(self._path, index, content)

    def append(self, content: list) -> None:
        self.insert(len(self), content)

    def delete(self, index: int, count: int = 1) -> None:
        self._tree.delete_nodes(self._path, index, count)

    def move(self, src: int, dst: int, *, count: int = 1) -> None:
        """count is keyword-only: SharedTree.move_nodes orders
        (src, count, dst) and a positionally transposed call would be
        valid-but-wrong."""
        self._tree.move_nodes(self._path, src, count, dst)

    def set(self, content) -> None:
        """Register-field write (value/optional kinds): replace the
        field's single node; concurrent sets converge LWW."""
        self._tree.set_register(self._path, content)

    def clear(self) -> None:
        """Clear an optional register field."""
        self._tree.set_register(self._path, None)

    def __delitem__(self, i) -> None:
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                raise ValueError("only contiguous deletion")
            if stop > start:
                self.delete(start, stop - start)
            return
        self.delete(i if i >= 0 else i + len(self))


class EditableNode:
    """One node; ``value`` writes route through the tree editor."""

    def __init__(self, tree, field_path: Sequence, index: int):
        self._tree = tree
        self._field_path = tuple(field_path)
        self._index = index

    def _node(self) -> dict:
        return self._tree.get_field(self._field_path)[self._index]

    @property
    def type(self) -> str:
        return self._node().get("type")

    @property
    def value(self) -> Any:
        return self._node().get("value")

    @value.setter
    def value(self, v: Any) -> None:
        self._tree.set_value(self._field_path, self._index, v)

    def field(self, key: str) -> EditableField:
        return EditableField(
            self._tree, self._field_path + (self._index, key)
        )

    def field_keys(self) -> list:
        return sorted((self._node().get("fields") or {}).keys())

    def anchor(self):
        """Stable reference to this node (survives sibling edits)."""
        return self._tree.track_anchor(self._field_path, self._index)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<EditableNode {self.type!r} value={self.value!r} "
                f"at {self._field_path}[{self._index}]>")


class EditableRoot:
    """The document root: a map of named root fields."""

    def __init__(self, tree):
        self._tree = tree

    def field(self, key: str) -> EditableField:
        return EditableField(self._tree, (key,))

    def field_keys(self) -> list:
        return sorted(self._tree.root().keys())
