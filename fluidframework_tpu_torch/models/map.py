"""SharedMap / SharedDirectory: optimistic LWW key-value stores.

Reference: packages/dds/map/src — ``SharedMap`` (map.ts:97) over
``MapKernel`` (mapKernel.ts:121): per-key last-writer-wins where a
pending local write shields the key from remote values until its own
ack arrives (consistent because the local op sequences later and wins
LWW anyway); ``SharedDirectory`` (directory.ts:303) layers a
subdirectory tree, each node a map.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter


class MapKernel:
    """mapKernel.ts:121 — the op-application state machine."""

    def __init__(self) -> None:
        self.data: dict[str, Any] = {}
        self._pending_keys: dict[str, int] = {}
        self._pending_clears = 0

    # ---- local ops (optimistic apply; return the op to submit)

    def set_local(self, key: str, value: Any) -> dict:
        self.data[key] = value
        self._pending_keys[key] = self._pending_keys.get(key, 0) + 1
        return {"type": "set", "key": key, "value": value}

    def delete_local(self, key: str) -> dict:
        self.data.pop(key, None)
        self._pending_keys[key] = self._pending_keys.get(key, 0) + 1
        return {"type": "delete", "key": key}

    def clear_local(self) -> dict:
        self.data.clear()
        self._pending_clears += 1
        self._pending_keys.clear()
        return {"type": "clear"}

    # ---- sequenced ops

    def process(self, op: dict, local: bool) -> Optional[str]:
        """Returns the changed key (or '*' for clear) if state changed."""
        kind = op["type"]
        if local:
            if kind == "clear":
                self._pending_clears -= 1
            else:
                key = op["key"]
                count = self._pending_keys.get(key, 0) - 1
                if count <= 0:
                    self._pending_keys.pop(key, None)
                else:
                    self._pending_keys[key] = count
            return None
        if kind == "clear":
            # pending local writes survive a remote clear (they
            # sequence later); everything else goes.
            survivors = {
                k: self.data[k] for k in self._pending_keys
                if k in self.data
            }
            self.data = survivors
            return "*"
        key = op["key"]
        if self._pending_clears > 0 or key in self._pending_keys:
            return None  # local pending state wins until ack
        if kind == "set":
            self.data[key] = op["value"]
        elif kind == "delete":
            self.data.pop(key, None)
        else:
            raise ValueError(f"unknown map op {kind!r}")
        return key


class SharedMap(SharedObject, EventEmitter):
    type_name = "sharedmap"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self._kernel = MapKernel()

    # ---- public API (map.ts surface)

    _MISSING = object()  # "key absent" sentinel in previous-value slots

    def set(self, key: str, value: Any) -> None:
        previous = self._kernel.data.get(key, self._MISSING)
        self.submit_local_message(self._kernel.set_local(key, value))
        self.emit("valueChanged", key, True, previous)

    def get(self, key: str, default: Any = None) -> Any:
        return self._kernel.data.get(key, default)

    def apply_stashed_op(self, contents: Any) -> Any:
        """Offline-stash rehydrate (sharedObject.ts:510): re-apply a
        stashed op as pending local state."""
        kind = contents["type"]
        if kind == "set":
            self._kernel.set_local(contents["key"], contents["value"])
        elif kind == "delete":
            self._kernel.delete_local(contents["key"])
        elif kind == "clear":
            self._kernel.clear_local()
        else:
            raise ValueError(f"unknown stashed map op {kind!r}")
        return None

    def has(self, key: str) -> bool:
        return key in self._kernel.data

    def delete(self, key: str) -> None:
        previous = self._kernel.data.get(key, self._MISSING)
        self.submit_local_message(self._kernel.delete_local(key))
        # deleting an absent key changes nothing locally: no event
        # (the op still travels — the key may exist remotely)
        if previous is not self._MISSING:
            self.emit("valueChanged", key, True, previous)

    def clear(self) -> None:
        previous = dict(self._kernel.data)
        self.submit_local_message(self._kernel.clear_local())
        self.emit("cleared", True, previous)

    def keys(self) -> Iterator[str]:
        return iter(self._kernel.data)

    def items(self):
        return self._kernel.data.items()

    def __len__(self) -> int:
        return len(self._kernel.data)

    # ---- SharedObject contract

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        op = msg.contents
        if local:
            self._kernel.process(op, True)  # pending bookkeeping only
            return
        if op.get("type") == "clear":
            # what a remote clear actually removes: everything except
            # pending-local survivors
            previous = {
                k: v for k, v in self._kernel.data.items()
                if k not in self._kernel._pending_keys
            }
        else:
            previous = self._kernel.data.get(op.get("key"), self._MISSING)
        changed = self._kernel.process(op, False)
        if changed == "*":
            self.emit("cleared", local, previous)
        elif changed is not None:
            self.emit("valueChanged", changed, local, previous)

    def summarize_core(self) -> dict:
        return {"data": dict(self._kernel.data)}

    def load_core(self, summary: dict) -> None:
        self._kernel.data = dict(summary["data"])


class SharedDirectory(SharedObject, EventEmitter):
    """directory.ts:303 — a tree of subdirectories, each a MapKernel;
    ops carry the absolute subdirectory path."""

    type_name = "shareddirectory"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self._nodes: dict[str, MapKernel] = {"/": MapKernel()}
        self._pending_subdirs: dict[str, int] = {}

    # ---- paths

    @staticmethod
    def _join(path: str, name: str) -> str:
        return (path.rstrip("/") + "/" + name) if path != "/" else "/" + name

    def _node(self, path: str) -> MapKernel:
        if path not in self._nodes:
            raise KeyError(f"no subdirectory {path!r}")
        return self._nodes[path]

    # ---- public API

    def set(self, key: str, value: Any, path: str = "/") -> None:
        op = self._node(path).set_local(key, value)
        op["path"] = path
        self.submit_local_message(op)

    def get(self, key: str, default: Any = None, path: str = "/") -> Any:
        return self._node(path).data.get(key, default)

    def delete(self, key: str, path: str = "/") -> None:
        op = self._node(path).delete_local(key)
        op["path"] = path
        self.submit_local_message(op)

    def create_sub_directory(self, name: str, path: str = "/") -> str:
        sub = self._join(path, name)
        if sub not in self._nodes:
            self._nodes[sub] = MapKernel()
        self._pending_subdirs[sub] = self._pending_subdirs.get(sub, 0) + 1
        self.submit_local_message({"type": "createSubdir", "path": sub})
        return sub

    def delete_sub_directory(self, name: str, path: str = "/") -> None:
        sub = self._join(path, name)
        self._drop_subtree(sub)
        self._pending_subdirs[sub] = self._pending_subdirs.get(sub, 0) + 1
        self.submit_local_message({"type": "deleteSubdir", "path": sub})

    def has_sub_directory(self, name: str, path: str = "/") -> bool:
        return self._join(path, name) in self._nodes

    def subdirectories(self, path: str = "/") -> list[str]:
        prefix = path.rstrip("/") + "/"
        return [
            p for p in self._nodes
            if p != "/" and p.startswith(prefix)
            and "/" not in p[len(prefix):]
        ]

    def _drop_subtree(self, path: str) -> None:
        for p in [p for p in self._nodes
                  if p == path or p.startswith(path + "/")]:
            del self._nodes[p]

    # ---- SharedObject contract

    def apply_stashed_op(self, contents: Any) -> Any:
        """Offline-stash rehydrate: replay the directory op as pending
        local state (directory.ts applyStashedOp)."""
        kind = contents["type"]
        if kind == "createSubdir":
            sub = contents["path"]
            self._nodes.setdefault(sub, MapKernel())
            self._pending_subdirs[sub] = \
                self._pending_subdirs.get(sub, 0) + 1
        elif kind == "deleteSubdir":
            sub = contents["path"]
            self._drop_subtree(sub)
            self._pending_subdirs[sub] = \
                self._pending_subdirs.get(sub, 0) + 1
        else:
            node = self._nodes.setdefault(
                contents.get("path", "/"), MapKernel())
            if kind == "set":
                node.set_local(contents["key"], contents["value"])
            elif kind == "delete":
                node.delete_local(contents["key"])
            else:
                raise ValueError(f"unknown stashed dir op {kind!r}")
        return None

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        op = msg.contents
        kind = op["type"]
        if kind in ("createSubdir", "deleteSubdir"):
            path = op["path"]
            if local:
                count = self._pending_subdirs.get(path, 0) - 1
                if count <= 0:
                    self._pending_subdirs.pop(path, None)
                else:
                    self._pending_subdirs[path] = count
                return
            if path in self._pending_subdirs:
                return  # local pending wins until ack
            if kind == "createSubdir":
                self._nodes.setdefault(path, MapKernel())
                # ancestors implicitly exist
                parts = path.strip("/").split("/")
                for i in range(1, len(parts)):
                    self._nodes.setdefault("/" + "/".join(parts[:i]),
                                           MapKernel())
            else:
                self._drop_subtree(path)
            self.emit("subDirectoryChanged", path, local)
            return
        path = op.get("path", "/")
        node = self._nodes.get(path)
        if node is None:
            return  # ops for a deleted subdirectory are dropped
        changed = node.process(op, local)
        if changed is not None:
            self.emit("valueChanged", path, changed, local)

    def summarize_core(self) -> dict:
        return {
            "nodes": {p: dict(k.data) for p, k in self._nodes.items()}
        }

    def load_core(self, summary: dict) -> None:
        self._nodes = {}
        for path, data in summary["nodes"].items():
            kernel = MapKernel()
            kernel.data = dict(data)
            self._nodes[path] = kernel
        self._nodes.setdefault("/", MapKernel())
