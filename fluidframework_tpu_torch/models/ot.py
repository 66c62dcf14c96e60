"""OT bridge — operational-transform channels.

Reference: experimental/dds/ot/ot/src/ot.ts — the generic
``SharedOT<TState, TOp>`` base keeps (a) a GLOBAL state = every
sequenced op applied in order, (b) the window of sequenced ops above
the msn, and (c) the local pending queue; an incoming sequenced op is
TRANSFORMED over every sequenced op its sender had not seen
(refSeq < seq, different client) before joining the global state
(ot.ts:91-118 processCore). The optimistic local view is global +
pending, rebuilt lazily (ot.ts:42-45). The collab window prune is
ot.ts:93-96 (ops below minSeq can never transform anything again).

The concrete type here is a JSON OT (the reference wraps sharejs
json1): path-addressed components over nested dicts/lists. It is an
original, deliberately small composition of the classic json-OT rules
— list-index shifting, deleted-subtree dropping, commuting numeric
adds — not a port of json1's internals.
"""
from __future__ import annotations

import abc
import copy
from dataclasses import dataclass
from typing import Any, Optional

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter


@dataclass
class _SeqOp:
    seq: int
    client: Optional[str]
    op: Any


class SharedOT(SharedObject, EventEmitter):
    """Generic transform-based channel (ot.ts:22). Subclasses define
    ``apply_core(state, op) -> state`` and ``transform(input, over) ->
    op`` (adjust ``input`` for an earlier-sequenced ``over``)."""

    def __init__(self, channel_id: str, initial: Any):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self._global = initial
        self._sequenced: list[_SeqOp] = []
        self._pending: list[Any] = []
        self._local: Any = initial
        self._dirty = False

    # ---- abstract OT type

    @abc.abstractmethod
    def apply_core(self, state: Any, op: Any) -> Any:
        """Apply ``op`` to ``state``, returning the new state."""

    @abc.abstractmethod
    def transform(self, input_op: Any, over: Any) -> Any:
        """Adjust ``input_op`` to account for the earlier ``over``."""

    # ---- public

    @property
    def state(self) -> Any:
        if self._dirty:
            s = self._global
            for op in self._pending:
                s = self.apply_core(s, op)
            self._local = s
            self._dirty = False
        return self._local

    def apply(self, op: Any) -> None:
        """Optimistically apply + submit (ot.ts:54 apply)."""
        self._local = self.apply_core(self.state, op)
        self._pending.append(op)
        self.submit_local_message({"op": op})

    # ---- SharedObject contract

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        op = msg.contents["op"]
        # transform over concurrent ops the sender had not seen
        for info in self._sequenced:
            if msg.reference_sequence_number < info.seq \
                    and msg.client_id != info.client:
                op = self.transform(op, info.op)
        self._sequenced.append(
            _SeqOp(msg.sequence_number, msg.client_id, op))
        self._global = self.apply_core(self._global, op)
        if local and self._pending:
            self._pending.pop(0)
        else:
            # transform the pending local queue over the remote op so the
            # optimistic view replays against the shifted global state
            # (ot.ts:125-127 pendingOps[i] = transform(pendingOps[i], op))
            self._pending = [self.transform(p, op) for p in self._pending]
        self._dirty = True
        self.emit("op", local)

    def on_sequence_advance(self, seq: int, min_seq: int) -> None:
        while self._sequenced and self._sequenced[0].seq < min_seq:
            self._sequenced.pop(0)

    def resubmit_core(self, contents: Any, metadata: Any = None) -> None:
        self.submit_local_message(contents, metadata)

    def apply_stashed_op(self, contents: Any) -> Any:
        self._pending.append(contents["op"])
        self._dirty = True
        return contents

    def summarize_core(self) -> dict:
        assert not self._pending, "summarize with pending local ops"
        return {"state": copy.deepcopy(self._global)}

    def load_core(self, summary: dict) -> None:
        self._global = copy.deepcopy(summary["state"])
        self._local = self._global
        self._dirty = False

    def signature(self) -> Any:
        return self._global


# ----------------------------------------------------------------------
# JSON OT type
#
# An op is a LIST of components, applied in order. Components:
#   {"p": [...path], "oi": v}            set object key (insert/replace)
#   {"p": [...path], "od": true}         delete object key
#   {"p": [...path, i], "li": v}         list insert at index i
#   {"p": [...path, i], "ld": true}      list delete at index i
#   {"p": [...path], "na": n}            add n to a number
# Paths address into nested dicts (str keys) and lists (int indices).


def _descend(state, path):
    cur = state
    for k in path:
        cur = cur[k]
    return cur


def _apply_component(state, c):
    path = c["p"]
    if "na" in c:
        parent = _descend(state, path[:-1])
        parent[path[-1]] = (parent[path[-1]] or 0) + c["na"]
        return
    if "oi" in c:
        _descend(state, path[:-1])[path[-1]] = copy.deepcopy(c["oi"])
        return
    if "od" in c:
        _descend(state, path[:-1]).pop(path[-1], None)
        return
    if "li" in c:
        seq = _descend(state, path[:-1])
        idx = min(path[-1], len(seq))
        seq.insert(idx, copy.deepcopy(c["li"]))
        return
    if "ld" in c:
        seq = _descend(state, path[:-1])
        if path[-1] < len(seq):
            del seq[path[-1]]
        return
    raise ValueError(f"unknown component {c}")


def _is_prefix(prefix, path):
    return len(prefix) <= len(path) and path[:len(prefix)] == prefix


def _transform_component(c, o):
    """Transform component ``c`` over earlier component ``o``; returns
    the adjusted component or None (dropped)."""
    c = copy.deepcopy(c)
    cp, op_ = c["p"], o["p"]

    if "ld" in o or "li" in o:
        d = len(op_) - 1          # index position within the list path
        same_list = len(cp) > d and cp[:d] == op_[:d] \
            and isinstance(cp[d], int)
        if not same_list:
            return c
        ci, idx = cp[d], op_[d]
        if "ld" in o:
            if ci > idx:
                cp[d] = ci - 1
            elif ci == idx:
                if len(cp) > d + 1:
                    return None     # c addressed inside the deleted one
                if "li" in c:
                    pass            # insert at the vacated index: fine
                else:
                    return None     # element gone (ld/oi/od/na on it)
        else:  # li
            # tie at the same index: the earlier-sequenced insert
            # keeps the left slot, later shifts right
            if ci >= idx:
                cp[d] = ci + 1
        return c

    if "od" in o:
        # key (and subtree) gone: ops inside it drop; a sibling oi on
        # the same key recreates it and survives
        if _is_prefix(op_, cp):
            if len(cp) == len(op_) and "oi" in c:
                return c
            return None
        return c

    if "oi" in o:
        # a replace invalidates ops INSIDE the old subtree — and a
        # numeric add ON the replaced value (the replacement may not
        # be a number; adding to it is meaningless and would poison
        # apply on every replica)
        if _is_prefix(op_, cp):
            if len(cp) > len(op_):
                return None
            if "na" in c:
                return None
        return c

    # na commutes with everything (including another na)
    return c


class SharedJson(SharedOT):
    """Concrete JSON OT channel (the reference's sharejs-json1 wrapper
    class, ot/src/index.ts)."""

    type_name = "sharedjson"

    def __init__(self, channel_id: str):
        super().__init__(channel_id, initial={})

    def apply_core(self, state, op):
        state = copy.deepcopy(state)
        for c in op:
            _apply_component(state, c)
        return state

    def transform(self, input_op, over):
        out = []
        for c in input_op:
            for o in over:
                c = _transform_component(c, o)
                if c is None:
                    break
            if c is not None:
                out.append(c)
        return out

    # convenience API
    def set(self, path: list, value: Any) -> None:
        self.apply([{"p": list(path), "oi": value}])

    def remove(self, path: list) -> None:
        self.apply([{"p": list(path), "od": True}])

    def list_insert(self, path: list, index: int, value: Any) -> None:
        self.apply([{"p": list(path) + [index], "li": value}])

    def list_delete(self, path: list, index: int) -> None:
        self.apply([{"p": list(path) + [index], "ld": True}])

    def add(self, path: list, n: float) -> None:
        self.apply([{"p": list(path), "na": n}])

    def get(self, path: list, default: Any = None) -> Any:
        try:
            return _descend(self.state, path)
        except (KeyError, IndexError, TypeError):
            return default
