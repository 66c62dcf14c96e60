"""AnchorSet: stable node references that slide with edits.

Reference: packages/dds/tree/src/core/tree/anchorSet.ts — anchors are
paths into the tree, rebased over every delta the view applies; a
deleted node's anchor becomes unresolvable.

TPU-native re-design: an anchor is a path of (field_key, index) steps.
The EditManager applies to the AnchorSet exactly the deltas the VIEW
experiences: each local change as authored, and on every peer commit
the inverse/trunk/rebased-locals sandwich it already computes — so
anchor updates are incremental even though the forest itself is
recomputed by replay.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence


class Anchor:
    __slots__ = ("id", "path", "dead")

    def __init__(self, anchor_id: int, path: tuple):
        self.id = anchor_id
        self.path = path  # ((field, index), ...)
        self.dead = False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "dead" if self.dead else "at"
        return f"<Anchor {self.id} {state} {self.path}>"


class AnchorSet:
    def __init__(self) -> None:
        self._anchors: dict[int, Anchor] = {}
        self._ids = itertools.count(1)

    def track(self, path: Sequence) -> Anchor:
        """``path`` alternates field keys and indexes and ends on an
        index: ("children", 2) or ("children", 2, "items", 0)."""
        if len(path) % 2 != 0:
            raise ValueError("anchor path must end on a node index")
        steps = tuple(
            (path[i], path[i + 1]) for i in range(0, len(path), 2)
        )
        anchor = Anchor(next(self._ids), steps)
        self._anchors[anchor.id] = anchor
        return anchor

    def forget(self, anchor: Anchor) -> None:
        self._anchors.pop(anchor.id, None)

    def locate(self, anchor: Anchor) -> Optional[tuple]:
        """Current flat path, or None if the node was deleted."""
        if anchor.dead or anchor.id not in self._anchors:
            return None
        out: list = []
        for key, idx in anchor.path:
            out.extend((key, idx))
        return tuple(out)

    # ------------------------------------------------------------------
    # delta application

    def apply(self, changes: dict) -> None:
        """Rebase every live anchor over one field-changes delta."""
        for anchor in self._anchors.values():
            if not anchor.dead:
                self._apply_one(anchor, changes)

    def _apply_one(self, anchor: Anchor, changes: dict) -> None:
        new_path = []
        fields = changes
        for depth, (key, idx) in enumerate(anchor.path):
            marks = (fields or {}).get(key)
            if not marks:
                new_path.append((key, idx))
                new_path.extend(anchor.path[depth + 1:])
                break
            new_idx, node_mark = self._adjust(marks, idx)
            if new_idx is None:
                anchor.dead = True
                return
            new_path.append((key, new_idx))
            fields = (node_mark or {}).get("fields") \
                if node_mark is not None else None
        anchor.path = tuple(new_path)

    @staticmethod
    def _adjust(marks: list, idx: int):
        """New index of input-node ``idx`` after ``marks``, plus the
        mod mark covering it (for descending). Returns (None, None)
        when a delete covers the node — unless a rev in the same list
        revives that very node (a MOVE: the anchor follows it to the
        destination, anchorSet.ts move semantics)."""
        # pre-pass: output position of every revived node identity
        rev_map: dict = {}
        out_scan = 0
        for m in marks:
            t = m["t"]
            if t == "rev":
                for j in range(m["n"]):
                    rev_map[(m["rev"], m["idx"] + j)] = out_scan + j
                out_scan += m["n"]
            elif t == "skip":
                out_scan += m["n"]
            elif t == "ins":
                out_scan += len(m["content"])
            elif t == "mod":
                out_scan += 1
            # del / tomb contribute no output

        in_pos = 0   # input coordinate walker
        out_pos = 0  # output coordinate walker
        for m in marks:
            t = m["t"]
            if t == "skip":
                if in_pos + m["n"] > idx:
                    return out_pos + (idx - in_pos), None
                in_pos += m["n"]
                out_pos += m["n"]
            elif t == "ins":
                out_pos += len(m["content"])
            elif t == "rev":
                out_pos += m["n"]
            elif t == "del":
                if in_pos + m["n"] > idx:
                    did = m.get("did")
                    if did is not None:
                        dest = rev_map.get(
                            (did[0], did[1] + (idx - in_pos))
                        )
                        if dest is not None:
                            return dest, None  # moved, not deleted
                    return None, None
                in_pos += m["n"]
            elif t == "mod":
                if in_pos == idx:
                    return out_pos, m
                in_pos += 1
                out_pos += 1
            elif t == "tomb":
                pass  # 0 input, 0 output
            else:  # pragma: no cover - forward compat
                raise ValueError(f"unknown mark {t!r}")
        return out_pos + (idx - in_pos), None
