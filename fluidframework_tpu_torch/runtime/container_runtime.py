"""Container runtime: datastore management, outbound batching, pending
state, reconnect replay.

Reference: packages/runtime/container-runtime/src/containerRuntime.ts
(``ContainerRuntime`` :631; inbound ``process`` :1701; outbound
``submitDataStoreOp`` :2549 -> ``Outbox``/``BatchManager``
(opLifecycle/outbox.ts:35, batchManager.ts:22); ``flush`` :1852;
``replayPendingStates`` :1573 with ``PendingStateManager``
(pendingStateManager.ts:75); ``orderSequentially`` :1860).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..obs import metrics as obs_metrics
from ..protocol.messages import SequencedMessage
from ..utils.events import EventEmitter
from .datastore import DataStoreRuntime
from .op_lifecycle import (
    OpCompressor,
    OpSplitter,
    RemoteMessageProcessor,
    mark_batch,
    stage_outbound,
)
from .shared_object import ChannelRegistry

_RESUBMITS = obs_metrics.REGISTRY.counter(
    "container_resubmits_total",
    "pending ops replayed (rebased) on reconnect")


@dataclass
class PendingOp:
    """One locally-submitted op awaiting its ack
    (pendingStateManager.ts pending message). ``kind`` is "op" for
    channel ops, "attach" for channel-attach announcements
    (ContainerMessageType.Attach, containerRuntime.ts:1701 switch)."""

    datastore_id: str
    channel_id: str
    contents: Any
    metadata: Any
    kind: str = "op"


class PendingStateManager:
    """Exactly-once resubmit across reconnects
    (pendingStateManager.ts:75): a deque of pending ops; acks pop the
    head; on reconnect every entry replays through its channel's
    ``resubmit_core`` (the rebase hook)."""

    def __init__(self) -> None:
        self._pending: deque[PendingOp] = deque()

    def on_submit(self, op: PendingOp) -> None:
        self._pending.append(op)

    def on_local_ack(self, msg: SequencedMessage) -> PendingOp:
        assert self._pending, "ack with no pending ops"
        return self._pending.popleft()

    def drain(self) -> list[PendingOp]:
        out = list(self._pending)
        self._pending.clear()
        return out

    @property
    def count(self) -> int:
        return len(self._pending)


class ContainerRuntime(EventEmitter):
    """One client's container: datastores + op lifecycle.

    The host (loader/driver/test session) wires ``submit_fn`` — called
    with the container-level op contents for each outbound message —
    and feeds inbound sequenced messages to ``process``.
    """

    def __init__(self, registry: ChannelRegistry,
                 submit_fn: Optional[Callable[[Any, Any], None]] = None):
        super().__init__()
        self.registry = registry
        self._submit_fn = submit_fn
        self.datastores: dict[str, DataStoreRuntime] = {}
        self.pending = PendingStateManager()
        self._outbox: list[PendingOp] = []
        self.client_id: str = ""
        self.connected = False
        self.reconnect_epoch = 0  # bumped on every reconnect
        # op lifecycle stages (opLifecycle/): outbound compress+chunk,
        # inbound reassemble+decompress
        self.compressor = OpCompressor()
        self.splitter = OpSplitter()
        self._inbound = RemoteMessageProcessor()
        # blobs + GC (blobManager.ts:118, garbageCollection.ts:340)
        from .blobs import BlobManager
        self.blobs = BlobManager(self)
        self.tombstones: set[str] = set()
        # GC state: set by an attached GarbageCollector, or loaded
        # from a summary produced by the (summarizer's) collector —
        # this is how GC results reach every replica (§3.4)
        self.gc: Any = None
        self._loaded_gc_state: Optional[dict] = None

    # ------------------------------------------------------------------
    # wiring

    def set_submit_fn(self, fn: Callable[[Any, Any], None]) -> None:
        self._submit_fn = fn

    def set_connection_state(self, connected: bool,
                             client_id: str = "") -> None:
        """containerRuntime.ts:1307 setConnectionState; on reconnect,
        replay pending states (:1573)."""
        was_connected = self.connected
        self.connected = connected
        if client_id:
            self.client_id = client_id
        if connected:
            # (re-)announce identity to every channel — channels created
            # by load() connected before the client id was known
            for ds in self.datastores.values():
                for channel in ds.channels.values():
                    channel._on_connect()
        if connected and not was_connected and self.pending.count:
            self._replay_pending()
        self.emit("connected" if connected else "disconnected")

    # ------------------------------------------------------------------
    # datastores

    def create_datastore(self, datastore_id: str,
                         root: bool = True) -> DataStoreRuntime:
        """``root=True`` (aliased in the reference) makes the store a
        GC root; non-root stores stay alive only while a handle to
        them (or a channel of theirs) is stored somewhere reachable."""
        if datastore_id in self.datastores:
            raise ValueError(f"datastore {datastore_id!r} exists")
        ds = DataStoreRuntime(self, datastore_id, self.registry, root=root)
        self.datastores[datastore_id] = ds
        return ds

    def get_datastore(self, datastore_id: str) -> DataStoreRuntime:
        route = f"/{datastore_id}"
        if route in self.tombstones:
            raise KeyError(
                f"datastore {datastore_id!r} is tombstoned (GC): "
                "it has been unreferenced past the tombstone timeout"
            )
        return self.datastores[datastore_id]

    # ------------------------------------------------------------------
    # outbound (submitDataStoreOp :2549 -> Outbox -> flush :1852)

    def submit_op(self, datastore_id: str, channel_id: str, contents: Any,
                  metadata: Any = None) -> None:
        op = PendingOp(datastore_id, channel_id, contents, metadata)
        self._outbox.append(op)

    def submit_attach(self, datastore_id: str, channel_id: str,
                      channel_type: str, summary: dict) -> None:
        """Announce a locally-created channel so remote containers can
        materialize it (the Attach op: a new channel's type + initial
        snapshot travel in the op stream)."""
        ds = self.datastores[datastore_id]
        self._outbox.append(PendingOp(
            datastore_id, channel_id,
            {"channelType": channel_type, "summary": summary,
             "root": ds.root},
            None, kind="attach",
        ))

    def flush(self) -> int:
        """Send every batched op (outbox.ts:102). Returns count sent.

        Drains atomically up front: with an in-proc synchronous service
        a submit can deliver (and re-enter flush) before this call
        returns, and the op must not be sent twice."""
        ops, self._outbox = self._outbox, []
        # Stage every wire message first (compress -> chunk), so batch
        # boundary marks land on the true first/last wire message.
        staged: list[tuple[dict, Any]] = []
        for op in ops:
            self.pending.on_submit(op)
            envelope = {
                "kind": op.kind,
                "address": op.datastore_id,
                "channel": op.channel_id,
                "contents": op.contents,
            }
            for wire in stage_outbound(
                envelope, self.compressor, self.splitter
            ):
                staged.append((wire, op.metadata))
        if len(staged) > 1:
            staged[0] = (staged[0][0], mark_batch(staged[0][1], True))
            staged[-1] = (staged[-1][0], mark_batch(staged[-1][1], False))
        if self._submit_fn is not None:
            for wire, metadata in staged:
                self._submit_fn(wire, metadata)
        return len(ops)

    def order_sequentially(self, callback: Callable[[], None]) -> None:
        """containerRuntime.ts:1860: run ``callback``, then flush its
        ops as one batch."""
        callback()
        self.flush()

    def submit_blob_attach(self, blob_id: str, data_b64: str) -> None:
        """BlobAttach op (ContainerMessageType.BlobAttach)."""
        self._outbox.append(PendingOp(
            "", "", {"id": blob_id, "data": data_b64}, None,
            kind="blobAttach",
        ))

    # ------------------------------------------------------------------
    # GC surface (garbageCollection.ts:340 consumes this)

    def get_gc_graph(self) -> tuple[dict[str, list[str]], list[str]]:
        """(node -> outbound routes, roots). Nodes: datastores,
        channels, blobs. A channel references its parent store (child
        keeps parent alive, as in the reference's node hierarchy)."""
        graph: dict[str, list[str]] = {}
        roots: list[str] = []
        for ds_id, ds in self.datastores.items():
            ds_route = f"/{ds_id}"
            graph[ds_route] = [
                f"{ds_route}/{cid}" for cid in ds.channels
            ]
            if ds.root:
                roots.append(ds_route)
            for cid, channel in ds.channels.items():
                graph[f"{ds_route}/{cid}"] = (
                    channel.gc_routes() + [ds_route]
                )
        for blob_id in self.blobs.ids():
            graph[f"/_blobs/{blob_id}"] = []
        return graph, roots

    def set_tombstones(self, tombstones: set[str]) -> None:
        self.tombstones = set(tombstones)

    def delete_route(self, route: str) -> bool:
        """Sweep: physically delete an unreferenced node."""
        parts = route.lstrip("/").split("/")
        if parts[0] == "_blobs":
            return self.blobs.delete_blob(parts[1])
        if len(parts) == 1:
            return self.datastores.pop(parts[0], None) is not None
        ds = self.datastores.get(parts[0])
        if ds is None:
            return False
        return ds.channels.pop(parts[1], None) is not None

    # ------------------------------------------------------------------
    # inbound (process :1701)

    def process(self, msg: SequencedMessage) -> None:
        # Inbound lifecycle: chunks buffer until complete, compressed
        # envelopes inflate (remoteMessageProcessor.ts:11). A chunked
        # op takes effect — and acks — at its FINAL chunk's seq.
        envelope = self._inbound.process(msg.client_id, msg.contents)
        if envelope is None:
            self._advance_all(msg)  # mid-chunk: window still advances
            return
        # Own ops are acks even when they arrive during catch-up while
        # reconnecting (the connection flag is down but the op is ours).
        local = bool(self.client_id) and msg.client_id == self.client_id
        local_metadata = None
        if local:
            pending_op = self.pending.on_local_ack(msg)
            local_metadata = pending_op.metadata
        if envelope.get("kind") == "attach":
            if not local:
                self._process_attach(envelope)
            self._advance_all(msg)
            return
        if envelope.get("kind") == "blobAttach":
            contents = envelope["contents"]
            self.blobs.process_attach(contents["id"], contents["data"])
            self._advance_all(msg)
            return
        ds = self.datastores[envelope["address"]]
        ds.process(
            msg, envelope["channel"], envelope["contents"], local,
            local_metadata,
        )
        self._advance_all(msg)
        self.emit("op", msg, local)

    def observe_system(self, msg: SequencedMessage) -> None:
        """Window progression from messages that carry no runtime op
        (joins/leaves/noops): broadcast seq/msn advance to channels."""
        self._advance_all(msg)

    def _advance_all(self, msg: SequencedMessage) -> None:
        for ds in self.datastores.values():
            for channel in ds.channels.values():
                channel.on_sequence_advance(
                    msg.sequence_number, msg.minimum_sequence_number
                )

    def _process_attach(self, envelope: dict) -> None:
        """Materialize a remotely-created channel (lazy realization —
        RemoteChannelContext). A same-id channel both sides created is
        deduplicated: first attach wins, later ones no-op."""
        ds_id, ch_id = envelope["address"], envelope["channel"]
        if ds_id not in self.datastores:
            self.create_datastore(
                ds_id, root=envelope["contents"].get("root", True)
            )
        ds = self.datastores[ds_id]
        if ch_id in ds.channels:
            return
        contents = envelope["contents"]
        ds.load_channel(
            contents["channelType"], ch_id, contents["summary"]
        )

    # ------------------------------------------------------------------
    # reconnect (replayPendingStates :1573)

    def _replay_pending(self) -> None:
        self.reconnect_epoch += 1
        # fold unflushed outbox ops into the pending queue FIRST (they
        # are strictly newer than every flushed-pending entry, so
        # append order is submit order): a reconnect that interrupted
        # a flush — the service refusing the reconnect's join during
        # a quorum-loss degraded window — leaves raw envelopes here,
        # and flushing them AFTER this replay would double-submit ops
        # the channels are about to regenerate (found by the netsplit
        # differential as a merge-tree pending-queue-out-of-order
        # assert on the post-heal resubmit)
        for op in self._outbox:
            self.pending.on_submit(op)
        self._outbox.clear()
        for op in self.pending.drain():
            _RESUBMITS.inc()
            if op.kind in ("attach", "blobAttach"):
                self._outbox.append(op)  # announcements replay verbatim
                continue
            channel = self.datastores[op.datastore_id].channels[
                op.channel_id
            ]
            channel.resubmit_core(op.contents, op.metadata)
        self.flush()

    # ------------------------------------------------------------------
    # offline stash (closeAndGetPendingLocalState / applyStashedOp,
    # container.ts getPendingLocalState + sharedObject.ts:510)

    def get_pending_state(self) -> list:
        """JSON-safe serialization of every pending local op (the
        runtime half of IPendingLocalState)."""
        from ..protocol.serialization import encode_contents

        self.flush()
        return [
            {
                "kind": op.kind,
                "datastore": op.datastore_id,
                "channel": op.channel_id,
                "contents": encode_contents(op.contents),
                "metadata": encode_contents(op.metadata),
            }
            for op in self.pending._pending
        ]

    def apply_stashed_state(self, entries: list) -> None:
        """Rehydrate stashed pending ops into a freshly loaded
        runtime: attaches materialize their channels (dedup applies if
        they sequenced after the stash), channel ops re-apply as
        pending local state via each DDS's applyStashedOp hook; the
        next connect resubmits everything through the normal
        reconnect-rebase path."""
        from ..protocol.serialization import decode_contents

        for entry in entries:
            contents = decode_contents(entry["contents"])
            metadata = decode_contents(entry.get("metadata"))
            op = PendingOp(entry["datastore"], entry["channel"],
                           contents, metadata, kind=entry["kind"])
            if op.kind == "attach":
                self._process_attach({
                    "address": op.datastore_id,
                    "channel": op.channel_id,
                    "contents": contents,
                })
                self.pending.on_submit(op)
                continue
            if op.kind != "op":
                self.pending.on_submit(op)  # e.g. blobAttach: verbatim
                continue
            channel = self.datastores[op.datastore_id].channels[
                op.channel_id
            ]
            new_meta = channel.apply_stashed_op(contents)
            self.pending.on_submit(PendingOp(
                op.datastore_id, op.channel_id, contents,
                new_meta if new_meta is not None else metadata,
            ))

    # ------------------------------------------------------------------
    # summary (§3.4 client side)

    def summarize(self, unchanged: frozenset = frozenset()) -> dict:
        """``unchanged``: (datastore_id, channel_id) pairs to emit as
        summary handles instead of re-serializing (incremental
        summaries — the container tracks which channels are unchanged
        since the last ACKED summary)."""
        out = {
            "datastores": {
                ds_id: ds.summarize(frozenset(
                    cid for d, cid in unchanged if d == ds_id
                ))
                for ds_id, ds in self.datastores.items()
            },
            "blobs": self.blobs.summarize(),
        }
        # GC state rides the summary (garbageCollection.ts gcState in
        # the summary tree): an attached collector contributes fresh
        # state; otherwise loaded state is carried forward verbatim
        if self.gc is not None:
            out["gc"] = self.gc.snapshot()
        elif self._loaded_gc_state is not None:
            out["gc"] = self._loaded_gc_state
        return out

    def load(self, summary: dict) -> None:
        for ds_id, ds_summary in summary.get("datastores", {}).items():
            ds = self.create_datastore(
                ds_id, root=ds_summary.get("root", True)
            )
            ds.load(ds_summary)
        self.blobs.load(summary.get("blobs", {}))
        gc_state = summary.get("gc")
        if gc_state is not None:
            self._loaded_gc_state = gc_state
            self.set_tombstones(set(gc_state.get("tombstones", [])))

    @property
    def is_dirty(self) -> bool:
        """Unacked local state exists (containerRuntime dirty flag)."""
        return bool(self._outbox) or self.pending.count > 0
