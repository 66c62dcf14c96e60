"""JSON serialization for sequenced streams (recorded corpora, file
driver, wire format).

Type-tagged encoding for op payloads: merge-tree ops are dataclasses,
join payloads are ClientDetail, everything else is plain JSON.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from .messages import ClientDetail, MessageType, SequencedMessage


def _op_vocab():
    # lazy: the codec serves every layer, but layering keeps protocol
    # below models (layer-check); the op classes load on first use
    from ..models.mergetree.ops import (
        AnnotateOp,
        DeltaType,
        GroupOp,
        InsertOp,
        RemoveOp,
    )

    return DeltaType, {
        DeltaType.INSERT: InsertOp,
        DeltaType.REMOVE: RemoveOp,
        DeltaType.ANNOTATE: AnnotateOp,
        DeltaType.GROUP: GroupOp,
    }


def encode_contents(value: Any) -> Any:
    from ..models.intervals import IntervalOp
    from ..models.mergetree.ops import (
        AnnotateOp,
        DeltaType,
        GroupOp,
        InsertOp,
        RemoveOp,
    )
    from ..runtime.handles import FluidHandle
    if isinstance(value, FluidHandle):
        return {"__handle__": value.route}
    if isinstance(value, IntervalOp):
        return {"__intervalop__": dataclasses.asdict(value)}
    if isinstance(value, (InsertOp, RemoveOp, AnnotateOp)):
        d = dataclasses.asdict(value)
        d["type"] = int(value.type)
        return {"__mergeop__": d}
    if isinstance(value, GroupOp):
        return {"__mergeop__": {
            "type": int(DeltaType.GROUP),
            "ops": [encode_contents(sub) for sub in value.ops],
        }}
    if isinstance(value, ClientDetail):
        d = dataclasses.asdict(value)
        d["scopes"] = list(d["scopes"])
        return {"__clientdetail__": d}
    if isinstance(value, dict):
        return {k: encode_contents(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [encode_contents(v) for v in value]
    return value


def decode_contents(value: Any) -> Any:
    if isinstance(value, dict):
        if "__handle__" in value:
            from ..runtime.handles import FluidHandle
            return FluidHandle(value["__handle__"])
        if "__intervalop__" in value:
            from ..models.intervals import IntervalOp
            return IntervalOp(**value["__intervalop__"])
        if "__mergeop__" in value:
            from ..models.mergetree.ops import GroupOp

            DeltaType, op_classes = _op_vocab()
            d = dict(value["__mergeop__"])
            kind = DeltaType(d.pop("type"))
            if kind == DeltaType.GROUP:
                return GroupOp(ops=[decode_contents(o) for o in d["ops"]])
            return op_classes[kind](**d)
        if "__clientdetail__" in value:
            d = dict(value["__clientdetail__"])
            d["scopes"] = tuple(d["scopes"])
            return ClientDetail(**d)
        return {k: decode_contents(v) for k, v in value.items()}
    if isinstance(value, list):
        return [decode_contents(v) for v in value]
    return value


def message_to_json(msg: SequencedMessage) -> dict:
    out = {
        "clientId": msg.client_id,
        "sequenceNumber": msg.sequence_number,
        "minimumSequenceNumber": msg.minimum_sequence_number,
        "clientSequenceNumber": msg.client_sequence_number,
        "referenceSequenceNumber": msg.reference_sequence_number,
        "type": int(msg.type),
        "contents": encode_contents(msg.contents),
        "metadata": encode_contents(msg.metadata),
        "timestamp": msg.timestamp,
    }
    # traces are OPTIONAL on the wire (protocol.ts ITrace is too): an
    # untraced message serializes byte-identically to the pre-tracing
    # format, so recorded corpora and 1.0/1.1 peers are unaffected
    if msg.traces:
        out["traces"] = [dataclasses.asdict(t) for t in msg.traces]
    return out


def message_from_json(data: dict) -> SequencedMessage:
    from .messages import Trace

    return SequencedMessage(
        client_id=data["clientId"],
        sequence_number=data["sequenceNumber"],
        minimum_sequence_number=data["minimumSequenceNumber"],
        client_sequence_number=data["clientSequenceNumber"],
        reference_sequence_number=data["referenceSequenceNumber"],
        type=MessageType(data["type"]),
        contents=decode_contents(data["contents"]),
        metadata=decode_contents(data.get("metadata")),
        timestamp=data.get("timestamp", 0.0),
        traces=[Trace(**t) for t in data.get("traces", [])],
    )


def dump_stream(messages: list[SequencedMessage]) -> str:
    return json.dumps([message_to_json(m) for m in messages])


def load_stream(text: str) -> list[SequencedMessage]:
    return [message_from_json(d) for d in json.loads(text)]
