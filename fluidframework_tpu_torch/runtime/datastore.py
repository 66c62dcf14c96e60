"""Data-store runtime: hosts channels (DDS instances) and routes ops.

Reference: packages/runtime/datastore/src/dataStoreRuntime.ts
(``FluidDataStoreRuntime`` :101; inbound ``process`` :535 ->
``processChannelOp`` :947; outbound ``submitChannelOp`` :869).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any

from ..protocol.messages import SequencedMessage
from .shared_object import ChannelRegistry, SharedObject

if TYPE_CHECKING:
    from .container_runtime import ContainerRuntime


class _ChannelServices:
    """IChannelServices: binds one channel's submits to the container
    outbox with the right addressing envelope."""

    def __init__(self, datastore: "DataStoreRuntime", channel_id: str):
        self._datastore = datastore
        self._channel_id = channel_id

    def submit(self, contents: Any, metadata: Any = None) -> None:
        self._datastore.submit_channel_op(
            self._channel_id, contents, metadata
        )

    @property
    def client_id(self) -> str:
        return self._datastore.container.client_id

    @property
    def connected(self) -> bool:
        return self._datastore.container.connected

    @property
    def reconnect_epoch(self) -> int:
        return self._datastore.container.reconnect_epoch


class DataStoreRuntime:
    def __init__(self, container: "ContainerRuntime", datastore_id: str,
                 registry: ChannelRegistry, root: bool = True):
        self.container = container
        self.id = datastore_id
        self.registry = registry
        self.root = root  # GC root (aliased store)
        self.channels: dict[str, SharedObject] = {}

    # ------------------------------------------------------------------
    # channel lifecycle

    def create_channel(self, type_name: str, channel_id: str) -> SharedObject:
        if channel_id in self.channels:
            raise ValueError(f"channel {channel_id!r} exists")
        channel = self.registry.get(type_name).create(channel_id)
        self.channels[channel_id] = channel
        channel.connect(_ChannelServices(self, channel_id))
        # announce to remote containers (Attach op)
        self.container.submit_attach(
            self.id, channel_id, type_name, channel.summarize_core()
        )
        return channel

    def load_channel(self, type_name: str, channel_id: str,
                     summary: dict) -> SharedObject:
        channel = self.registry.get(type_name).load(channel_id, summary)
        self.channels[channel_id] = channel
        channel.connect(_ChannelServices(self, channel_id))
        return channel

    def get_channel(self, channel_id: str) -> SharedObject:
        route = f"/{self.id}/{channel_id}"
        if route in self.container.tombstones:
            raise KeyError(
                f"channel {route} is tombstoned (GC): unreferenced "
                "past the tombstone timeout"
            )
        return self.channels[channel_id]

    # ------------------------------------------------------------------
    # op routing

    def submit_channel_op(self, channel_id: str, contents: Any,
                          metadata: Any) -> None:
        """dataStoreRuntime.ts:869."""
        self.container.submit_op(
            self.id, channel_id, contents, metadata
        )

    def process(self, msg: SequencedMessage, channel_id: str, contents: Any,
                local: bool, local_op_metadata: Any) -> None:
        """dataStoreRuntime.ts:535 -> :947."""
        channel = self.channels[channel_id]
        inner = SequencedMessage(
            client_id=msg.client_id,
            sequence_number=msg.sequence_number,
            minimum_sequence_number=msg.minimum_sequence_number,
            client_sequence_number=msg.client_sequence_number,
            reference_sequence_number=msg.reference_sequence_number,
            type=msg.type,
            contents=contents,
            metadata=msg.metadata,
            timestamp=msg.timestamp,
        )
        if not local:
            # remote edits dirty the channel (local ones were counted
            # at submit time)
            channel.change_count += 1
        channel.process_core(inner, local, local_op_metadata)

    # ------------------------------------------------------------------
    # summary

    def summarize(self, skip_channels: frozenset = frozenset()
                  ) -> dict:
        """``skip_channels``: channel ids whose serialization is
        skipped in favor of a summary handle into the previous acked
        summary — the incremental path (SummaryType.Handle); the
        service storage expands them (service/storage.py)."""
        return {
            "root": self.root,
            "channels": {
                cid: (
                    {"__summary_handle__":
                     f"runtime/datastores/{self.id}/channels/{cid}"}
                    if cid in skip_channels else
                    {
                        "type": ch.type_name,
                        "content": ch.summarize_core(),
                    }
                )
                for cid, ch in self.channels.items()
            },
        }

    def load(self, summary: dict) -> None:
        for cid, entry in summary.get("channels", {}).items():
            self.load_channel(entry["type"], cid, entry["content"])
