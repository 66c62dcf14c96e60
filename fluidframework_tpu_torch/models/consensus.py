"""Consensus DDSes: state changes take effect only on sequencing.

Unlike the optimistic DDSes (map/cell/string), these apply *nothing*
locally at submit time — the total order IS the consensus. Both local
and remote ops mutate state in ``process_core``; the ``local`` flag only
resolves the submitter's completion callbacks.

- ``ConsensusRegisterCollection``: versioned registers. A write carries
  the writer's refSeq; when sequenced it supersedes every version the
  writer had seen (version.seq <= refSeq) and joins the concurrent
  version list otherwise. Reference:
  packages/dds/register-collection/src/consensusRegisterCollection.ts
  (:87) — versions ack'd by sequencing, atomic read = earliest
  surviving version.
- ``ConsensusOrderedCollection``: a distributed work queue with
  acquire/complete/release leasing. Reference:
  packages/dds/ordered-collection/src/consensusOrderedCollection.ts
  (:93).
"""
from __future__ import annotations

import uuid
from typing import Any, Callable, Optional

from ..protocol.messages import SequencedMessage
from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter


class ConsensusRegisterCollection(SharedObject, EventEmitter):
    type_name = "consensusregistercollection"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        # key -> list of concurrent versions [{"value": v, "seq": n}]
        self._versions: dict[str, list[dict]] = {}
        # local writes awaiting sequencing: op-id -> callback
        self._completions: dict[str, Callable[[bool], None]] = {}

    # ---- public API

    def write(self, key: str, value: Any,
              on_complete: Optional[Callable[[bool], None]] = None
              ) -> None:
        """Submit a versioned write; takes effect when sequenced.
        ``on_complete(won)`` fires at ack: ``won`` is True when the
        write is the winning (earliest surviving) version."""
        op_id = uuid.uuid4().hex
        if on_complete is not None:
            self._completions[op_id] = on_complete
        self.submit_local_message({
            "type": "write", "key": key, "value": value, "opId": op_id,
        })

    def read(self, key: str, default: Any = None) -> Any:
        """Atomic read policy: the earliest sequenced surviving
        version (consensusRegisterCollection.ts ReadPolicy.Atomic)."""
        versions = self._versions.get(key)
        return versions[0]["value"] if versions else default

    def read_versions(self, key: str) -> list[Any]:
        """All concurrent (not-superseded) values, sequence order."""
        return [v["value"] for v in self._versions.get(key, [])]

    def keys(self) -> tuple[str, ...]:
        return tuple(self._versions)

    # ---- SharedObject contract

    def apply_stashed_op(self, contents: Any) -> Any:
        """Offline-stash rehydrate: consensus ops carry no optimistic
        local state (their effect lands only when SEQUENCED —
        consensus-register-collection's round-trip contract), so the
        stashed op simply resubmits verbatim. Completion callbacks do
        not survive a restart; the write still resolves."""
        return None

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        op = msg.contents
        assert op["type"] == "write"
        key = op["key"]
        versions = self._versions.setdefault(key, [])
        # Supersede every version the writer had seen when it wrote.
        versions[:] = [
            v for v in versions
            if v["seq"] > msg.reference_sequence_number
        ]
        versions.append({
            "value": op["value"], "seq": msg.sequence_number,
        })
        won = versions[0]["seq"] == msg.sequence_number
        if local:
            cb = self._completions.pop(op["opId"], None)
            if cb is not None:
                cb(won)
        self.emit("atomicChanged", key, versions[0]["value"], local)

    def summarize_core(self) -> dict:
        return {"versions": {
            k: [dict(v) for v in vs] for k, vs in self._versions.items()
        }}

    def load_core(self, summary: dict) -> None:
        self._versions = {
            k: [dict(v) for v in vs]
            for k, vs in summary["versions"].items()
        }


class ConsensusOrderedCollection(SharedObject, EventEmitter):
    """FIFO work queue with consensus leasing (acquire -> complete or
    release). Values live in the queue until acquired; an acquired
    value is leased to the acquiring client until completed (gone) or
    released (returned to the queue head)."""

    type_name = "consensusorderedcollection"

    def __init__(self, channel_id: str):
        SharedObject.__init__(self, channel_id)
        EventEmitter.__init__(self)
        self._data: list[Any] = []
        # acquire_id -> {"value": v, "client": clientId}
        self._in_flight: dict[str, dict] = {}
        self._results: dict[str, Any] = {}

    # ---- public API

    def add(self, value: Any) -> None:
        self.submit_local_message({"type": "add", "value": value})

    def acquire(self) -> str:
        """Request the queue head. Returns an acquire id; when the op
        sequences, ``result_of(acquire_id)`` holds the value (or None
        if the queue was empty) and an ``acquired``/``acquireFailed``
        event fires."""
        acquire_id = uuid.uuid4().hex
        self.submit_local_message({
            "type": "acquire", "acquireId": acquire_id,
        })
        return acquire_id

    def result_of(self, acquire_id: str) -> Any:
        return self._results.get(acquire_id)

    def complete(self, acquire_id: str) -> None:
        self.submit_local_message({
            "type": "complete", "acquireId": acquire_id,
        })

    def release(self, acquire_id: str) -> None:
        self.submit_local_message({
            "type": "release", "acquireId": acquire_id,
        })

    @property
    def size(self) -> int:
        return len(self._data)

    def leases(self) -> dict[str, dict]:
        """Live leases: acquire_id -> {value, client}."""
        return dict(self._in_flight)

    def client_left(self, client_id: str) -> None:
        """Release every lease the departed client held back to the
        queue head, in acquisition order (the reference releases
        in-flight items on quorum removeMember; hosts call this on an
        observed leave, so every replica applies it identically)."""
        released = [
            (aid, lease) for aid, lease in self._in_flight.items()
            if lease["client"] == client_id
        ]
        for aid, lease in reversed(released):
            del self._in_flight[aid]
            self._data.insert(0, lease["value"])
            self.emit("localRelease", aid, lease["value"])

    # ---- SharedObject contract

    def apply_stashed_op(self, contents: Any) -> Any:
        """Offline-stash rehydrate: consensus ops carry no optimistic
        local state (their effect lands only when SEQUENCED —
        consensus-register-collection's round-trip contract), so the
        stashed op simply resubmits verbatim. Completion callbacks do
        not survive a restart; the write still resolves."""
        return None

    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        op = msg.contents
        kind = op["type"]
        if kind == "add":
            self._data.append(op["value"])
            self.emit("add", op["value"], local)
        elif kind == "acquire":
            acquire_id = op["acquireId"]
            if self._data:
                value = self._data.pop(0)
                self._in_flight[acquire_id] = {
                    "value": value, "client": msg.client_id,
                }
                if local:
                    self._results[acquire_id] = value
                self.emit("acquire", acquire_id, value, msg.client_id)
            else:
                if local:
                    self._results[acquire_id] = None
                self.emit("acquireFailed", acquire_id)
        elif kind == "complete":
            lease = self._in_flight.pop(op["acquireId"], None)
            if lease is not None:
                self.emit("complete", op["acquireId"], lease["value"])
        elif kind == "release":
            lease = self._in_flight.pop(op["acquireId"], None)
            if lease is not None:
                # released work goes back to the head: it was dequeued
                # first, so it stays first
                self._data.insert(0, lease["value"])
                self.emit("localRelease", op["acquireId"], lease["value"])
        else:  # pragma: no cover - forward compat
            raise ValueError(f"unknown op {kind!r}")

    def summarize_core(self) -> dict:
        return {
            "data": list(self._data),
            "inFlight": {k: dict(v) for k, v in self._in_flight.items()},
        }

    def load_core(self, summary: dict) -> None:
        self._data = list(summary["data"])
        self._in_flight = {
            k: dict(v) for k, v in summary["inFlight"].items()
        }
