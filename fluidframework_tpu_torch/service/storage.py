"""Durable service storage: content-addressed summary trees + a
file-backed op log + checkpoint persistence.

Reference: the storage microservices — historian/gitrest store summary
trees as git trees/blobs (server/historian, server/gitrest), where an
unchanged subtree re-uploaded in a new summary costs nothing because
git is content-addressed; scriptorium's Mongo op collection
(lambdas/src/scriptorium/lambda.ts:20) is the durable sequenced-op
store; deli checkpoints ({sequenceNumber, clients...}) persist so a
restarted partition resumes where it left off
(deli/checkpointContext.ts).

Design notes:
- ``ContentStore`` hashes canonical JSON with sha256. ``write_tree``
  splits a summary dict into one object per node down to
  ``tree_depth`` levels (protocol / runtime / datastores/<id> /
  channels/<cid>), plus one object per element of any ``chunks`` list
  (the chunked merge-tree snapshot format, snapshotChunks.ts) — so the
  SECOND summary of a mostly-unchanged container writes O(changed
  channels) new objects, not O(container).
- ``SummaryType.Handle`` (summary.ts:55-59): client summaries may
  replace an unchanged subtree with {"__summary_handle__":
  "<path/in/previous/summary>"}; the store resolves handles against
  the previous version at write time, exactly like the service
  expanding incremental summaries against the last acked one.

CRASH ATOMICITY (docs/ROBUSTNESS.md "storage seams"): a crash may
land mid-write anywhere, so every durable write here either commits
whole or leaves the previous state intact — the write-temp + fsync +
rename protocol for the checkpoint (without the fsync, the rename
can be durable while the data is not, leaving a prefix-truncated
checkpoint.json that parses as garbage — the exact reordered-write
crash state "All File Systems Are Not Created Equal" enumerates),
fsync-per-append for the op log (the ack barrier: the orderer fans
an op out only after scriptorium's append returns, so a fanned-out
op is durable by construction), and torn-TAIL tolerance on every
JSONL load (a crash inside an append leaves a partial last line;
that op was never fanned out, so discarding it loudly is exact —
the client still holds it pending and resubmits). A torn line
ANYWHERE ELSE is real corruption and still fails loudly. The chaos
plane (qos/faults.py) enumerates these states in
tests/test_chaos.py + tests/test_durable_storage.py.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time
import zlib
from typing import Any, Callable, Optional

from ..obs import metrics as obs_metrics
from ..protocol.messages import SequencedMessage
from ..protocol.serialization import message_from_json, message_to_json
from ..qos.faults import (
    KIND_CORRUPT,
    KIND_ERROR,
    KIND_ERROR_BURST,
    KIND_TORN_WRITE,
    PLANE,
    TransientIOFault,
)
from .lambdas import OpLog

HANDLE_KEY = "__summary_handle__"

_M_TORN = obs_metrics.REGISTRY.counter(
    "storage_torn_recoveries_total",
    "torn on-disk states discarded on load (crash recovery)",
    labelnames=("file",))
_M_SCRUB = obs_metrics.REGISTRY.counter(
    "storage_scrub_repairs_total",
    "bit-rotted records read-repaired from a quorum peer, by log",
    labelnames=("file",))
_M_DEBRIS = obs_metrics.REGISTRY.counter(
    "storage_crash_debris_cleaned_total",
    "leftover write-then-rename tmp files cleared at startup (the "
    "crash-between-write-and-rename state)", labelnames=("file",))

# chaos seams (docs/ROBUSTNESS.md): the checkpoint write consults its
# site per write (error faults exercise the storage breaker); the
# op-log site exists for the harness's crash-time torn-tail
# enumeration (force()d, never fired mid-run — a torn append IS a
# crash, and the process does not survive it)
_SITE_CHECKPOINT = PLANE.site(
    "storage.checkpoint_write",
    (KIND_ERROR, KIND_ERROR_BURST, KIND_TORN_WRITE))
_SITE_OPLOG = PLANE.site("storage.oplog_append", (KIND_TORN_WRITE,))
# bit rot: a record's bytes flip at rest (a disk sector going bad, not
# a crash). force()d by the harness when it plants corruption — like
# the torn states, the injection is a harness decision the plane
# records, never a mid-run fault draw
_SITE_BITROT = PLANE.site("storage.bitrot", (KIND_CORRUPT,))


def atomic_write(path: str, data: str) -> None:
    """THE crash-atomic write barrier — write-temp + fsync + rename —
    with ONE owner, so the checkpoint, the op-log rewrite and the
    versions rewrite cannot silently diverge on the protocol. Without
    the fsync the rename can become durable before the data, leaving
    a prefix-truncated file under the FINAL name (the reordered-write
    crash state the crash-consistency literature enumerates)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # fsync the DIRECTORY too: without it the rename itself is not
    # durable — a crash can leave the directory entry pointing at the
    # pre-rewrite inode while later appends (already fsynced to the
    # NEW inode, and acked) vanish with it. The reordered-METADATA
    # sibling of the data state above.
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    except OSError as e:  # pragma: no cover - exotic fs
        # skipping the directory fsync weakens the crash-durability
        # story for every write through this path — degrade loudly
        print(
            f"atomic_write[{path}]: cannot open directory for fsync "
            f"({e}); rename durability not guaranteed on this fs",
            file=sys.stderr,
        )
        return
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


CRC_KEY = "_crc"


def record_crc(row: dict) -> int:
    """Per-record checksum over the CANONICAL encoding (sorted keys,
    tight separators) of the row WITHOUT its own crc field — so the
    crc survives a round trip through any JSON re-encoder."""
    return zlib.crc32(_canonical(
        {k: v for k, v in row.items() if k != CRC_KEY}))


def jsonl_record(row: dict) -> str:
    """One CRC-stamped JSONL line (op logs, replica logs, queue record
    logs). The crc rides as an OPTIONAL field — the wire-interop
    discipline: readers verify it when present and accept legacy rows
    without one, so pre-existing logs keep loading."""
    return json.dumps(dict(row, **{CRC_KEY: record_crc(row)})) + "\n"


class CorruptRecordError(ValueError):
    """A record whose bytes are wrong AT REST — a crc mismatch, or a
    malformed line that is not the torn tail. NOT a crash state: the
    write barriers rule those out, so this is bit rot (or an operator
    mishap) and must either be read-repaired from a quorum peer
    (:func:`scrub_repair_jsonl`) or fail loudly — never served."""

    def __init__(self, msg: str, path: str = "", index: int = -1):
        super().__init__(msg)
        self.path = path
        self.index = index  # 0-based record index in the file


def _check_record_crc(row: dict, label: str, path: str,
                      line_no: int) -> dict:
    """Verify (and strip) an optional per-record crc; raises
    :class:`CorruptRecordError` on mismatch."""
    if CRC_KEY not in row:
        return row  # legacy record: nothing to verify
    want = row[CRC_KEY]
    got = record_crc(row)
    if want != got:
        raise CorruptRecordError(
            f"{label} crc mismatch at line {line_no} of {path!r}: "
            f"stored {want}, computed {got} — bit rot, not a crash "
            "state; scrub-repair it from a quorum peer "
            "(docs/ROBUSTNESS.md)", path=path, index=line_no - 1)
    return {k: v for k, v in row.items() if k != CRC_KEY}


def read_jsonl_tolerant(path: str, label: str) -> tuple[list, bool]:
    """Parse a JSONL file tolerating ONE torn final line (the crash-
    mid-append state). Returns (parsed rows, tail_was_torn). A
    malformed line anywhere but the end — or a crc mismatch ANYWHERE,
    tail included (a completed fsynced write whose bytes changed is
    rot, not a tear) — is corruption, not a crash state: raised,
    never skipped."""
    rows: list = []
    with open(path) as f:
        lines = f.readlines()
    stripped = [ln.strip() for ln in lines]
    for i, line in enumerate(stripped):
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError as e:
            if any(stripped[i + 1:]):
                raise CorruptRecordError(
                    f"{label} corrupt at line {i + 1} of {path!r}: "
                    "a non-tail torn record is not a crash state",
                    path=path, index=i,
                ) from e
            _M_TORN.labels(file=label).inc()
            print(
                f"storage: discarding torn {label} tail "
                f"(line {i + 1} of {path!r}) — crash mid-append; "
                "the op was never acked, clients resubmit it",
                file=sys.stderr,
            )
            return rows, True
        rows.append(_check_record_crc(row, label, path, i + 1))
    return rows, False


# ----------------------------------------------------------------------
# the scrubber: detect bit rot per record, read-repair from peers


@dataclasses.dataclass
class ScrubReport:
    """One log's scrub outcome. ``corrupt`` holds the 0-based record
    indexes that failed their crc (or tore mid-file); ``torn_tail``
    is the recoverable crash state — left for the loader's
    torn-tail discard, NOT treated as rot."""

    path: str
    records: int = 0
    torn_tail: bool = False
    corrupt: list = dataclasses.field(default_factory=list)
    repaired: int = 0


def _scan_jsonl(path: str) -> tuple[list, list[Optional[dict]],
                                    ScrubReport]:
    """(raw lines, parsed rows with None at corrupt slots, report)."""
    report = ScrubReport(path=path)
    with open(path) as f:
        lines = [ln for ln in f.readlines() if ln.strip()]
    rows: list[Optional[dict]] = []
    for i, line in enumerate(lines):
        try:
            row = json.loads(line)
        except ValueError:
            if i == len(lines) - 1:
                report.torn_tail = True
                rows.append(None)
                continue
            report.corrupt.append(i)
            rows.append(None)
            continue
        if CRC_KEY in row and row[CRC_KEY] != record_crc(row):
            report.corrupt.append(i)
            rows.append(None)
            continue
        rows.append({k: v for k, v in row.items() if k != CRC_KEY})
    report.records = len(lines)
    return lines, rows, report


def scrub_jsonl(path: str, label: str) -> ScrubReport:
    """Detect-only pass: classify every record as intact, bit-rotted
    (``corrupt``), or the torn tail."""
    _, _, report = _scan_jsonl(path)
    return report


def scrub_repair_jsonl(
        path: str, label: str,
        fetch: Callable[[int, list], Optional[dict]]) -> ScrubReport:
    """Read-repair: every corrupt record is replaced by the row
    ``fetch(index, rows)`` supplies (a quorum peer's copy — ``rows``
    gives the caller the intact neighbours to anchor identity, e.g.
    a contiguous op log's sequence numbers). A torn TAIL is left
    byte-for-byte for the loader's torn-tail discard. ``fetch`` returning
    None means no surviving peer holds the record: raised loudly —
    a quorum-acked record with zero intact copies is data loss, and
    pretending otherwise would serve garbage."""
    lines, rows, report = _scan_jsonl(path)
    if not report.corrupt:
        return report
    out: list[str] = []
    for i, (line, row) in enumerate(zip(lines, rows)):
        if i in report.corrupt:
            repaired = fetch(i, rows)
            if repaired is None:
                raise CorruptRecordError(
                    f"{label} record {i} of {path!r} is corrupt and "
                    "no surviving peer holds an intact copy — "
                    "unrepairable bit rot", path=path, index=i)
            out.append(jsonl_record(
                {k: v for k, v in repaired.items() if k != CRC_KEY}))
            report.repaired += 1
            _M_SCRUB.labels(file=label).inc()
        elif row is None:
            out.append(line)  # the torn tail, verbatim
        else:
            out.append(jsonl_record(row))
    atomic_write(path, "".join(out))
    return report


def read_offset_tolerant(path: str, label: str = "offset") -> int:
    """Parse a committed-offset file, degrading LOUDLY to -1 (no
    commit) on garbage. With commits routed through ``atomic_write``
    a torn offset is unreachable going forward, but a pre-barrier
    data dir can still hold one — and re-consuming from scratch is
    exactly what at-least-once delivery absorbs, while a crash here
    would take the partition down for an operator restart."""
    with open(path) as f:
        raw = f.read().strip()
    try:
        return int(raw or -1)
    except ValueError:
        _M_TORN.labels(file=label).inc()
        print(
            f"storage: committed-offset file {path!r} is "
            f"torn/unparseable ({raw[:40]!r}); treating as no commit "
            "— the consumer re-reads from the log head and the "
            "at-least-once dedupe absorbs the replay",
            file=sys.stderr,
        )
        return -1


def _canonical(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")
                      ).encode("utf-8")


class ContentStore:
    """In-memory content-addressed object store (git object database
    analogue)."""

    def __init__(self) -> None:
        self._objects: dict[str, bytes] = {}

    def put(self, obj: Any) -> str:
        data = _canonical(obj)
        sha = hashlib.sha256(data).hexdigest()
        if sha not in self._objects:
            self._store(sha, data)
        return sha

    def get(self, sha: str) -> Any:
        return json.loads(self._load(sha).decode("utf-8"))

    def has(self, sha: str) -> bool:
        return sha in self._objects

    def object_count(self) -> int:
        return len(self._objects)

    # storage hooks (overridden by the file store)
    def _store(self, sha: str, data: bytes) -> None:
        self._objects[sha] = data

    def _load(self, sha: str) -> bytes:
        return self._objects[sha]


class FileContentStore(ContentStore):
    """On-disk object store: objects/<aa>/<sha> (gitrest layout)."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        os.makedirs(os.path.join(root, "objects"), exist_ok=True)
        for shard in os.listdir(os.path.join(root, "objects")):
            shard_dir = os.path.join(root, "objects", shard)
            for name in os.listdir(shard_dir):
                self._objects[shard + name] = None  # lazily loaded

    def _path(self, sha: str) -> str:
        return os.path.join(self.root, "objects", sha[:2], sha[2:])

    def _store(self, sha: str, data: bytes) -> None:
        path = self._path(sha)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        self._objects[sha] = None

    def _load(self, sha: str) -> bytes:
        return open(self._path(sha), "rb").read()

    def has(self, sha: str) -> bool:
        return sha in self._objects or os.path.exists(self._path(sha))


_TREE = "__tree__"
_BLOB = "__blob__"
_CHUNKS = "__chunklist__"


class SummaryTreeStore:
    """Versioned summary storage over a ContentStore (the historian
    facade). Splits summaries into per-subtree objects and resolves
    incremental handles."""

    def __init__(self, store: Optional[ContentStore] = None,
                 tree_depth: int = 6):
        # depth 6 reaches protocol / runtime / datastores/<id> /
        # channels/<cid> / {type, content} — the channel's "content"
        # dict lands at depth 0 where the chunk split below engages
        # (verified: at depth 5 the whole multi-chunk snapshot stored
        # as ONE blob and per-chunk reuse never happened)
        self.store = store or ContentStore()
        self.tree_depth = tree_depth

    # -- write ---------------------------------------------------------

    def write(self, summary: dict,
              previous_root: Optional[str] = None) -> str:
        """Store a summary, resolving {"__summary_handle__": path}
        nodes against ``previous_root``; returns the new root sha."""
        resolved = self._resolve_handles(summary, previous_root)
        return self._write_node(resolved, self.tree_depth)

    def _resolve_handles(self, node: Any,
                         previous_root: Optional[str]) -> Any:
        if isinstance(node, dict):
            if HANDLE_KEY in node:
                if previous_root is None:
                    raise ValueError(
                        "summary handle with no previous summary"
                    )
                return self.read_path(previous_root, node[HANDLE_KEY])
            return {
                k: self._resolve_handles(v, previous_root)
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [self._resolve_handles(v, previous_root)
                    for v in node]
        return node

    def _write_node(self, node: Any, depth: int) -> str:
        if depth > 0 and isinstance(node, dict):
            children = {
                k: self._write_node(v, depth - 1)
                for k, v in node.items()
            }
            return self.store.put({_TREE: children})
        if isinstance(node, dict) and isinstance(
            node.get("chunks"), list
        ):
            # chunked snapshot: one object per chunk so append-mostly
            # documents reuse every unchanged chunk
            rest = {k: v for k, v in node.items() if k != "chunks"}
            chunk_shas = [self.store.put(c) for c in node["chunks"]]
            return self.store.put({
                _CHUNKS: chunk_shas, _BLOB: rest,
            })
        return self.store.put({_BLOB: node})

    # -- read ----------------------------------------------------------

    def read(self, root: str) -> dict:
        return self._read_node(root)

    def _read_node(self, sha: str) -> Any:
        obj = self.store.get(sha)
        if _TREE in obj:
            return {
                k: self._read_node(v) for k, v in obj[_TREE].items()
            }
        if _CHUNKS in obj:
            out = dict(obj[_BLOB])
            out["chunks"] = [
                self.store.get(c) for c in obj[_CHUNKS]
            ]
            return out
        return obj[_BLOB]

    def read_path(self, root: str, path: str) -> Any:
        """Resolve "a/b/c" inside a stored summary without
        materializing the whole tree."""
        sha = root
        parts = [p for p in path.split("/") if p]
        for i, part in enumerate(parts):
            obj = self.store.get(sha)
            if _TREE not in obj:
                # descend into a blob's plain dict remainder
                node = self._read_node(sha)
                for rest in parts[i:]:
                    node = node[rest]
                return node
            sha = obj[_TREE][part]
        return self._read_node(sha)


@dataclasses.dataclass
class SummaryVersion:
    sequence_number: int
    root: str
    timestamp: float = dataclasses.field(default_factory=time.time)


class FileOpLog(OpLog):
    """Durable op log: the in-memory OpLog's semantics (contiguity,
    range reads, truncation) with JSONL persistence via the
    _persist_* hooks — same shape as FileContentStore/ContentStore."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            rows, torn = read_jsonl_tolerant(path, "oplog")
            for row in rows:
                self._ops.append(message_from_json(row))
            if torn:
                # rewrite without the torn tail so a second crash
                # cannot stack a new append onto a half record
                self._rewrite()
        self._fh = open(path, "a")

    def _persist_append(self, msg: SequencedMessage) -> None:
        # crc-stamped record (jsonl_record): load + scrub verify it,
        # so a sector flipping at rest is DETECTED instead of served
        self._fh.write(jsonl_record(message_to_json(msg)))
        self._fh.flush()
        # the ACK BARRIER: the pipeline fans out (and acks) only after
        # this returns, so an op any client ever saw sequenced is
        # durable — the only tearable crash state is an op nobody was
        # told about (read_jsonl_tolerant discards exactly that)
        os.fsync(self._fh.fileno())

    def _persist_truncate(self) -> None:
        self._fh.close()
        self._rewrite()
        self._fh = open(self.path, "a")

    def _rewrite(self) -> None:
        atomic_write(self.path, "".join(
            jsonl_record(message_to_json(m)) for m in self._ops
        ))


class DocumentStorage:
    """Per-document durable state: summary versions + op log +
    service checkpoint, all under one directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.trees = SummaryTreeStore(
            FileContentStore(os.path.join(root, "store"))
        )
        self.op_log = self._make_op_log(
            os.path.join(root, "ops.jsonl"))
        self._versions_path = os.path.join(root, "versions.jsonl")
        self.versions: list[SummaryVersion] = []
        if os.path.exists(self._versions_path):
            rows, torn = read_jsonl_tolerant(
                self._versions_path, "versions")
            self.versions = [SummaryVersion(**row) for row in rows]
            if torn:
                # rewrite without the torn tail, like the op log: the
                # next commit_summary APPENDS, and stacking a fresh
                # record onto the half line would turn a recoverable
                # crash state into mid-file corruption at the load
                # after that
                atomic_write(self._versions_path, "".join(
                    json.dumps(dataclasses.asdict(v)) + "\n"
                    for v in self.versions
                ))
        self._checkpoint_path = os.path.join(root, "checkpoint.json")
        # a leftover checkpoint tmp is the crash-between-write-and-
        # rename state: the rename never happened, so the committed
        # checkpoint (or its absence) is the truth — clear the debris
        try:
            os.remove(self._checkpoint_path + ".tmp")
            _M_DEBRIS.labels(file="checkpoint").inc()
        except OSError:
            pass

    def _make_op_log(self, path: str) -> FileOpLog:
        """Op-log factory hook: the replicated sequencer
        (service/replication.py) swaps in a ReplicatedOpLog whose
        append blocks on the replication quorum."""
        return FileOpLog(path)

    # summaries
    def write_summary(self, sequence_number: int,
                      summary: dict) -> str:
        prev = self.versions[-1].root if self.versions else None
        root = self.trees.write(summary, previous_root=prev)
        return self.commit_summary(sequence_number, root)

    def commit_summary(self, sequence_number: int, root: str) -> str:
        """Durably record a staged tree root as a version (the scribe
        ack of a client-uploaded summary)."""
        version = SummaryVersion(sequence_number, root)
        self.versions.append(version)
        with open(self._versions_path, "a") as f:
            f.write(json.dumps(dataclasses.asdict(version)) + "\n")
            f.flush()
            os.fsync(f.fileno())  # ack barrier, like the op log
        return root

    def latest_summary(self) -> Optional[tuple[int, dict]]:
        if not self.versions:
            return None
        v = self.versions[-1]
        return v.sequence_number, self.trees.read(v.root)

    # service checkpoint (deli/checkpointContext.ts)
    def write_checkpoint(self, state: dict) -> None:
        fault = _SITE_CHECKPOINT.fire(doc=os.path.basename(self.root))
        if fault is not None:
            # both error kinds surface as the OSError shape the
            # storage breaker's recovery contract is keyed on; the
            # torn states themselves are enumerated at crash time by
            # the harness, not mid-run (a torn write IS a crash)
            raise TransientIOFault(
                f"chaos[storage.checkpoint_write]: injected {fault}")
        # the shared barrier (see atomic_write): the torn-final state
        # this rules out is exactly what read_checkpoint used to
        # parse as garbage
        atomic_write(self._checkpoint_path, json.dumps(state))

    def read_checkpoint(self) -> Optional[dict]:
        if not os.path.exists(self._checkpoint_path):
            return None
        with open(self._checkpoint_path) as f:
            raw = f.read()
        try:
            return json.loads(raw)
        except ValueError:
            # a torn/garbage checkpoint must degrade, not detonate:
            # the op log holds every sequenced op, and the orderer's
            # restore path fast-forwards from seq 0 when no
            # checkpoint loads — slower startup, never wrong state
            _M_TORN.labels(file="checkpoint").inc()
            print(
                f"storage: checkpoint {self._checkpoint_path!r} is "
                f"torn/unparseable ({len(raw)} bytes); ignoring it — "
                "restart fast-forwards from the op log",
                file=sys.stderr,
            )
            return None
