"""Moira lambda — PropertyDDS changeset publishing to a Materialized
History service (branch + commit graph).

Reference: server/routerlicious/packages/lambdas/src/moira/lambda.ts
:30 (handler: collect sequenced PropertyDDS changeset ops per branch),
:64 (sendPending: double-buffered pending/current batches, checkpoint
after each published batch), :95 (createDerivedGuid: sha1-derived
uuid), :127 (processMoiraCore: first commit with no referenceGuid
creates the branch with a derived root commit), :154 (createBranch
POST /branch), :183 (createCommit POST /branch/{guid}/commit with
changeSet + rebase flag + seq/msn meta). The reference publishes over
HTTP (Axios) to the Materialized History endpoint; this repo's
service plane is framed TCP (ingress framing), so the MH service here
is a framed-TCP server with the same two verbs and the same record
shapes — drivers/consumers are process-separable exactly like the
broker tier (tests run it in another OS process).

The lambda keeps the reference's batching structure: ``handler``
accumulates sequenced changeset ops per branch; ``flush`` publishes
current batches branch-by-branch IN SEQUENCE ORDER (per-branch
ordering is what the reference's per-branch promise chaining
enforces) and then checkpoints the batch offset via the callback.
Commit guids and the branch root are derived deterministically
(sha1), so every replica of the lambda publishes the identical graph
from the identical stream — determinism-by-sequencing, as everywhere
else in this service tier.
"""
from __future__ import annotations

import asyncio
import hashlib
import json
import os
import socket
import threading
from typing import Any, Callable, Optional

from ..obs import metrics as obs_metrics
from ..protocol.messages import MessageType, SequencedMessage
from .ingress import pack_frame, read_frame, recv_frame_blocking

_COMMITS_PUBLISHED = obs_metrics.REGISTRY.counter(
    "moira_commits_published_total",
    "changeset commits published to materialized history")
_BRANCHES_CREATED = obs_metrics.REGISTRY.counter(
    "moira_branches_created_total", "MH branches created")
_FLUSH_FAILURES = obs_metrics.REGISTRY.counter(
    "moira_flush_failures_total",
    "publish batches restored for at-least-once replay")


def derived_guid(reference_guid: str, identifier: str) -> str:
    """sha1-derived uuid (moira/lambda.ts:95 createDerivedGuid)."""
    h = hashlib.sha1(
        f"{reference_guid}:{identifier}".encode()
    ).hexdigest()
    return f"{h[0:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"


# ======================================================================
# Materialized History service (framed TCP)


class MaterializedHistoryServer:
    """Branch/commit store behind the two moira verbs. In-memory by
    default; ``data_dir`` makes it durable (one JSON log per branch)
    so a restarted MH process serves the published history back."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 data_dir: Optional[str] = None):
        self.host = host
        self.port = port
        self.data_dir = data_dir
        self.branches: dict[str, dict] = {}
        # _dispatch runs on executor threads (its _persist does file
        # I/O, which must never run on the event loop — concheck's
        # async-blocking-call rule); the lock serializes branch-state
        # access across connections exactly as the loop used to
        self._state_lock = threading.Lock()
        self._server: Optional[asyncio.base_events.Server] = None
        if data_dir is not None:
            os.makedirs(data_dir, exist_ok=True)
            for name in os.listdir(data_dir):
                if name.endswith(".json"):
                    with open(os.path.join(data_dir, name)) as f:
                        b = json.load(f)
                    self.branches[b["guid"]] = b

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    def _persist(self, branch: dict) -> None:
        if self.data_dir is None:
            return
        path = os.path.join(self.data_dir, f"{branch['guid']}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(branch, f)
        os.replace(tmp, path)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                try:
                    # executor hop: _persist writes the branch log to
                    # disk, and a disk stall must park only THIS
                    # request, not every connection on the loop
                    resp = await loop.run_in_executor(
                        None, self._dispatch_locked, frame)
                except Exception as e:  # noqa: BLE001 - per frame
                    resp = {"type": "error",
                            "message": f"{type(e).__name__}: {e}"}
                resp["rid"] = frame.get("rid")
                writer.write(pack_frame(resp))
                await writer.drain()
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError,
                    RuntimeError):
                pass

    def _dispatch_locked(self, frame: dict) -> dict:
        with self._state_lock:
            return self._dispatch(frame)

    def _dispatch(self, frame: dict) -> dict:
        kind = frame.get("type")
        if kind == "branch":
            # POST /branch (lambda.ts:154): idempotent — the lambda
            # may republish after a crash-replay
            guid = str(frame["guid"])
            if guid not in self.branches:
                self.branches[guid] = {
                    "guid": guid,
                    "rootCommitGuid": str(frame["rootCommitGuid"]),
                    "meta": frame.get("meta", {}),
                    "commits": [],
                }
                self._persist(self.branches[guid])
            return {"type": "branch_ok",
                    "rootCommitGuid":
                        self.branches[guid]["rootCommitGuid"]}
        if kind == "commit":
            # POST /branch/{guid}/commit (lambda.ts:183); idempotent
            # on commit guid for at-least-once publishing
            branch = self.branches.get(str(frame["branchGuid"]))
            if branch is None:
                raise KeyError(
                    f"unknown branch {frame['branchGuid']!r}")
            guid = str(frame["guid"])
            if all(c["guid"] != guid for c in branch["commits"]):
                heads = ([branch["rootCommitGuid"]]
                         + [c["guid"] for c in branch["commits"]])
                if str(frame["parentGuid"]) not in heads:
                    raise ValueError(
                        f"commit {guid} parent "
                        f"{frame['parentGuid']!r} not in branch")
                branch["commits"].append({
                    "guid": guid,
                    "parentGuid": str(frame["parentGuid"]),
                    "meta": frame.get("meta", {}),
                    "changeSet": frame.get("changeSet"),
                    "rebase": bool(frame.get("rebase", True)),
                })
                self._persist(branch)
            return {"type": "commit_ok", "guid": guid}
        if kind == "branch_get":
            branch = self.branches.get(str(frame["guid"]))
            return {"type": "branch_state", "branch": branch}
        raise ValueError(f"unknown moira frame {kind!r}")


class MaterializedHistoryClient:
    """Blocking request/response client for the MH server (the
    lambda's Axios equivalent over the repo's framed-TCP plane)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._rid = 0
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout
            )
        return self._sock

    def _request(self, data: dict) -> dict:
        with self._lock:
            self._rid += 1
            data = dict(data, rid=self._rid)
            try:
                sock = self._connect()
                sock.sendall(pack_frame(data))
                resp = recv_frame_blocking(sock)
            except Exception:
                # connection faults AND protocol faults (oversized/
                # corrupt frame -> ValueError/JSONDecodeError): in
                # either case the stream position is unusable — drop
                # the socket so the next request reconnects fresh
                self._close_sock()  # already under _lock
                raise
        if resp.get("type") == "error":
            raise RuntimeError(resp.get("message", "MH error"))
        return resp

    def create_branch(self, guid: str, root_commit_guid: str,
                      meta: Optional[dict] = None) -> str:
        resp = self._request({
            "type": "branch", "guid": guid,
            "rootCommitGuid": root_commit_guid,
            "meta": meta or {},
        })
        return resp["rootCommitGuid"]

    def create_commit(self, branch_guid: str, guid: str,
                      parent_guid: str, meta: dict,
                      change_set: Any, rebase: bool = True) -> None:
        self._request({
            "type": "commit", "branchGuid": branch_guid,
            "guid": guid, "parentGuid": parent_guid, "meta": meta,
            "changeSet": change_set, "rebase": rebase,
        })

    def get_branch(self, guid: str) -> Optional[dict]:
        return self._request(
            {"type": "branch_get", "guid": guid}
        )["branch"]

    def _close_sock(self) -> None:
        # caller holds _lock: _sock is swapped under it by _connect
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def close(self) -> None:
        # lock so a close racing an in-flight _request waits for the
        # request instead of yanking its socket mid-recv
        with self._lock:
            self._close_sock()


# ======================================================================
# the lambda


class MoiraLambda:
    """Watches the sequenced stream for PropertyDDS changeset ops and
    publishes them as commits on per-channel branches.

    ``document_id`` scopes branch identity; the branch guid is derived
    from document/datastore/channel (the reference reads the branch
    guid from the op envelope's address — lambda.ts:110). ``handler``
    only collects; ``flush`` publishes and checkpoints, mirroring the
    reference's pending/current swap (lambda.ts:64) — callers drive
    flush from their pump/partition loop.
    """

    def __init__(self, client: MaterializedHistoryClient,
                 document_id: str,
                 checkpoint: Optional[Callable[[Any], None]] = None):
        self.client = client
        self.document_id = document_id
        self._checkpoint = checkpoint
        # branch guid -> list of (seq, msn, changeset)
        self.pending: dict[str, list[tuple[int, int, Any]]] = {}
        self._pending_offset: Any = None
        # branch guid -> head commit guid (created branches only)
        self.heads: dict[str, str] = {}
        self.published = 0

    # -- stream side ---------------------------------------------------

    def handler(self, msg: SequencedMessage,
                offset: Any = None) -> None:
        """Collect a sequenced message (lambda.ts:30). Uncompressed
        channel-op envelopes only — compressed batches are opaque
        here, exactly as the reference's JSON.parse of the raw op
        contents only sees plain PropertyDDS submissions."""
        if msg.type != MessageType.OPERATION:
            return
        env = msg.contents
        if not (isinstance(env, dict) and env.get("kind") == "op"):
            return
        contents = env.get("contents")
        if not (isinstance(contents, dict)
                and "changeset" in contents):
            return
        branch = derived_guid(
            self.document_id,
            f"{env.get('address')}/{env.get('channel')}",
        )
        self.pending.setdefault(branch, []).append((
            msg.sequence_number,
            msg.minimum_sequence_number,
            contents["changeset"],
        ))
        self._pending_offset = offset

    # -- publish side --------------------------------------------------

    def flush(self) -> int:
        """Publish all pending batches (lambda.ts:64 sendPending /
        :127 processMoiraCore), then checkpoint. Returns commits
        published. Per-branch order is sequence order; a failure
        raises with pending intact, so a crash-restart replays
        at-least-once into the idempotent MH verbs."""
        if not self.pending:
            return 0
        current, self.pending = self.pending, {}
        offset, self._pending_offset = self._pending_offset, None
        try:
            n = 0
            for branch in sorted(current):
                for seq, msn, changeset in current[branch]:
                    parent = self.heads.get(branch)
                    if parent is None:
                        # first commit with no reference: create the
                        # branch with the derived root (lambda.ts:145)
                        parent = self.client.create_branch(
                            branch, derived_guid(branch, "root"),
                            meta={"documentId": self.document_id},
                        )
                        _BRANCHES_CREATED.inc()
                    commit = derived_guid(branch, f"commit-{seq}")
                    self.client.create_commit(
                        branch, commit, parent,
                        meta={
                            "sequenceNumber": seq,
                            "minimumSequenceNumber": msn,
                        },
                        change_set=changeset, rebase=True,
                    )
                    self.heads[branch] = commit
                    n += 1
            self.published += n
            _COMMITS_PUBLISHED.inc(n)
        except Exception:
            # restore for replay (context.error(restart) equivalent)
            _FLUSH_FAILURES.inc()
            for b, items in current.items():
                self.pending.setdefault(b, [])[:0] = items
            self._pending_offset = offset
            raise
        if self._checkpoint is not None and offset is not None:
            self._checkpoint(offset)
        return n

    def close(self) -> None:
        self.pending.clear()


def run_mh_server(host: str = "127.0.0.1", port: int = 7091,
                  data_dir: Optional[str] = None) -> None:
    """Blocking MH entry point (`python -m
    fluidframework_tpu_torch.service.moira`)."""
    server = MaterializedHistoryServer(host, port, data_dir)

    async def main():
        await server.start()
        print(f"materialized-history listening on "
              f"{server.host}:{server.port} "
              f"({'durable' if data_dir else 'in-memory'})",
              flush=True)
        await server.serve_forever()

    try:
        asyncio.run(main())
    except KeyboardInterrupt:  # pragma: no cover - operator stop
        pass


if __name__ == "__main__":  # pragma: no cover - CLI
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7091)
    ap.add_argument("--data-dir", default=None)
    a = ap.parse_args()
    run_mh_server(a.host, a.port, a.data_dir)
