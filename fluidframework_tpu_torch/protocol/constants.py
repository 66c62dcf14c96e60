"""Sequence-number sentinels shared by the whole framework, the
wire-version order, the reviewed wire-schema registry and the batch
boundary marks: a copy of the reference's ``protocol/constants.py``.
The static wire check and the wire sanitizer that the comments below
name belong to the reference's ``analysis`` and ``testing`` packages.

Reference: packages/dds/merge-tree/src/constants.ts:11-15.
"""

# Seq for content that existed before collaboration started (snapshot load).
UNIVERSAL_SEQ = 0

# Seq for local, not-yet-acked ops/segments.
UNASSIGNED_SEQ = -1

# Seq used for structural tree maintenance that is not an op.
TREE_MAINT_SEQ = -2

# Client id used when not collaborating.
NON_COLLAB_CLIENT = -2

# Normalised comparison values for tie-breaking (mergeTree.ts:1705):
# a local pending *op* compares as the highest possible seq; a local
# pending *segment* as the second highest (the op being placed always
# sequences after segments already in the tree).
MAX_SEQ = 2**53 - 1


def wire_version_lt(a: str, b: str) -> bool:
    """Wire-protocol version ordering — ONE definition shared by the
    server's frame gate (service/ingress) and the driver's client-side
    guard (drivers/socket_driver): numeric dotted compare, so '1.10'
    orders above '1.2'."""
    return tuple(int(x) for x in a.split(".")) < \
        tuple(int(x) for x in b.split("."))


# ---------------------------------------------------------------------------
# The reviewed wire-schema registry: frame type -> field -> spec.
#
# A spec is "<since-version>" plus optional flags:
#   ?  optional presence — the key is omitted when there is nothing to
#      say; emitters must guard it (wirecheck rule
#      optional-field-unconditional-emit) and decoders must .get() it.
#   ~  tolerated-for-drift — the field's peer lives outside the
#      analyzed wire modules (a harness, a test, the rid plumbing
#      that _request() injects), so the encoder/decoder-drift rule
#      does not require a matching in-scope emit/read pair. The flags
#      are independent and combine ("1.1?~").
#
# "type" itself is the frame discriminator and is NOT listed for
# frames; the msg:* pseudo-types describe op payloads (the dicts
# riding "msg"/"msgs"/"op"/"ops"/"operation") where "type" is an
# ordinary payload field. Growing this dict IS the act of growing the
# wire protocol: analysis/wirecheck.py fails the gate on any emitted
# field absent here, tests/test_wire_compat.py derives its generative
# downlevel matrix from the since-versions, testing/wiresan.py trips
# on any runtime frame carrying an unregistered field, and
# protocol/WIRE_SCHEMA.json is the golden snapshot a reviewer diffs.
#
# MUST stay a pure literal: wirecheck reads it from this file's AST
# via ast.literal_eval (a fluidlint pass imports nothing it lints).
WIRE_SCHEMA = {
    "connect_document": {
        "document_id": "1.0",
        "client_id": "1.0",
        "mode": "1.0",
        "versions": "1.0",
        "tenant_id": "1.0?",
        "token": "1.0?",
        # client-detail capability blob; no in-repo driver sends one
        # yet (ingress tolerates and records it)
        "details": "1.0?~",
    },
    "connected": {
        "document_id": "1.0",
        # drivers key the ack on document_id and ignore the echo
        "client_id": "1.0~",
        "version": "1.0",
    },
    "connect_document_error": {
        "document_id": "1.0",
        "message": "1.0",
    },
    "disconnect_document": {
        "document_id": "1.0",
    },
    "submitOp": {
        "document_id": "1.0",
        "op": "1.0",
        # boxcar member list (wire 1.2); mutually exclusive with "op"
        "ops": "1.2?",
        # columnar SoA batch (wire 1.3, protocol/columnar.py); the
        # payload IS the column layout — see the cols:columnar
        # pseudo-type. Mutually exclusive with "op"/"ops".
        "cols": "1.3?",
    },
    "op": {
        "document_id": "1.0",
        "msg": "1.0",
    },
    "nack": {
        "document_id": "1.0",
        "operation": "1.0",
        "sequence_number": "1.0",
        "error_type": "1.0",
        "message": "1.0",
        "retry_after_seconds": "1.1?",
        "pressure_tier": "1.1?",
        "shed_class": "1.1?",
    },
    "read_ops": {
        "document_id": "1.0",
        "from_seq": "1.0",
        "to_seq": "1.0",
        # rid is injected by the driver's _request() plumbing and
        # consumed by the server's reply path, both outside the dict
        # literals the static pass sees
        "rid": "1.0~",
        "tenant_id": "1.0?",
        "token": "1.0?",
    },
    "ops": {
        "rid": "1.0~",
        "msgs": "1.0",
    },
    "fetch_summary": {
        "document_id": "1.0",
        "rid": "1.0~",
        "tenant_id": "1.0?",
        "token": "1.0?",
    },
    "summary": {
        "rid": "1.0~",
        "sequence_number": "1.0",
        "summary": "1.0",
    },
    "upload_summary_chunk": {
        "document_id": "1.1",
        "upload_id": "1.1",
        "chunk": "1.1",
        "total": "1.1",
        "data": "1.1",
        "rid": "1.1~",
        "tenant_id": "1.1?",
        "token": "1.1?",
    },
    "upload_ack": {
        # per-chunk flow-control ack; the driver's rid pairing
        # consumes it generically in _recv_loop
        "rid": "1.1~",
        "received": "1.1~",
    },
    "summary_uploaded": {
        "rid": "1.1~",
        "handle": "1.1",
    },
    "error": {
        "rid": "1.0~",
        "message": "1.0",
        "error_kind": "1.1",
        "retry_after_seconds": "1.1?",
        # qos shed attribution on the error plane: consumed by the
        # qos tests and external dashboards, not by an in-scope
        # driver decoder
        "pressure_tier": "1.1?~",
        "shed_class": "1.1?~",
    },
    "metrics": {
        "rid": "1.0~",
        "text": "1.0",
        "metrics": "1.0",
    },
    "fleet-metrics": {
        "rid": "1.0~",
        "nodes": "1.0",
        "text": "1.0",
        "metrics": "1.0",
    },
    "slo": {
        "rid": "1.0~",
        "report": "1.0",
        "message": "1.0?",
    },
    # cost-attribution plane (wire 1.4): top-k hot documents and
    # tenants off the heat/usage ledgers (obs/heat.py). "k" is the
    # optional requested cut — omitted, the server serves its
    # default.
    "heat": {
        "rid": "1.4~",
        "k": "1.4?",
        "docs": "1.4",
        "tenants": "1.4",
    },
    # op payload vocabularies (not frames; see note above)
    "msg:sequenced": {
        "clientId": "1.0",
        "sequenceNumber": "1.0",
        "minimumSequenceNumber": "1.0",
        "clientSequenceNumber": "1.0",
        "referenceSequenceNumber": "1.0",
        "type": "1.0",
        "contents": "1.0",
        "metadata": "1.0",
        "timestamp": "1.0",
        "traces": "1.1?",
    },
    "msg:document": {
        "client_sequence_number": "1.0",
        "reference_sequence_number": "1.0",
        "type": "1.0",
        "contents": "1.0",
        "metadata": "1.0",
        "traces": "1.0",
    },
    # the columnar submitOp payload (the dict riding "cols"; wire 1.3,
    # protocol/columnar.py is the one codec). Parallel arrays: every
    # column is length n (text_off: n+1 monotone offsets into text).
    "cols:columnar": {
        "n": "1.3",
        "csn": "1.3",
        "refseq": "1.3",
        "kind": "1.3",
        "pos1": "1.3",
        "pos2": "1.3",
        "text_off": "1.3",
        "text": "1.3",
    },
    # the sharedtree channel-op payload (wire 1.5, the tree serving
    # plane): rides the runtime envelope two levels below a msg:*
    # payload ("contents" of the envelope riding "contents").
    # protocol/tree_payload.py is the one codec; "changes" is the
    # FieldChanges changeset vocabulary of models/tree/changeset.py.
    "msg:tree": {
        "type": "1.5",
        "changes": "1.5",
    },
}


def wire_schema_fields(frame_type: str):
    """``{field: (since, optional, tolerated)}`` for one frame type
    (None for an unregistered type) — the runtime-facing spec parser
    used by testing/wiresan and test_wire_compat's generative leg.
    analysis/wirecheck.py duplicates the parse (a pass imports
    nothing it lints)."""
    fields = WIRE_SCHEMA.get(frame_type)
    if fields is None:
        return None
    out = {}
    for name, spec in fields.items():
        out[name] = (
            spec.replace("?", "").replace("~", ""),
            "?" in spec,
            "~" in spec,
        )
    return out


def wire_schema_hash() -> str:
    """Content hash of the registry (canonical JSON, sha256/16) —
    stamped into bench stage records next to fluidlint_findings and
    pinned by the protocol/WIRE_SCHEMA.json golden test, so a wire
    change surfaces both as a bench delta and a reviewed diff."""
    import hashlib
    import json

    blob = json.dumps(WIRE_SCHEMA, sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def mark_batch(metadata, flag: bool) -> dict:
    """Batch boundary marks riding message metadata
    (batchManager.ts batch metadata: first op {batch: true}, last
    {batch: false}; singletons carry no mark). Lives at the protocol
    layer: the marks are a WIRE contract — the runtime writes them,
    the loader's ScheduleManager and the socket driver's boxcar
    batching both read them."""
    out = dict(metadata) if isinstance(metadata, dict) else {}
    out["batch"] = flag
    return out


def batch_flag(metadata):
    """Read a batch boundary mark (None = unmarked / mid-batch)."""
    if isinstance(metadata, dict):
        return metadata.get("batch")
    return None
