"""SharedObject base + channel plugin boundary.

Reference: packages/dds/shared-object-base/src/sharedObject.ts
(``SharedObjectCore`` :42 — abstract contract ``loadCore`` :305,
``processCore`` :329, ``reSubmitCore`` :378, ``applyStashedOp`` :510,
``summarizeCore``; submit path ``submitLocalMessage`` :343) and the
``IChannelFactory`` registry (packages/runtime/datastore-definitions) —
the plugin boundary: new channel types (including device-backed ones)
register a factory, nothing else changes.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, Optional, Protocol

from ..protocol.messages import SequencedMessage


class ChannelServices(Protocol):
    """What a connected channel can do (IChannelServices): submit ops
    into the container's outbox."""

    def submit(self, contents: Any, metadata: Any = None) -> None: ...

    @property
    def client_id(self) -> str: ...

    @property
    def connected(self) -> bool: ...


class SharedObject(abc.ABC):
    """A distributed data structure instance (one channel)."""

    # set by subclasses: the factory type name, e.g. "sharedstring"
    type_name: str = ""

    def __init__(self, channel_id: str):
        self.id = channel_id
        self._services: Optional[ChannelServices] = None
        # monotonic edit counter driving incremental summaries: a
        # channel whose count equals its last-ACKED-summary capture is
        # unchanged and summarizes as a SummaryType.Handle
        # (summary.ts:55-59)
        self.change_count = 0

    # ------------------------------------------------------------------
    # wiring

    @property
    def connected(self) -> bool:
        return self._services is not None and self._services.connected

    @property
    def client_id(self) -> Optional[str]:
        return self._services.client_id if self._services else None

    def connect(self, services: ChannelServices) -> None:
        """Attach to a datastore runtime (sharedObject.ts connect)."""
        self._services = services
        self._on_connect()

    def _on_connect(self) -> None:
        """Hook for subclasses (start collaboration etc.)."""

    def submit_local_message(self, contents: Any,
                             metadata: Any = None) -> None:
        """sharedObject.ts:343 — route a local op to the service via
        the runtime; detached objects apply locally only."""
        self.change_count += 1
        if self._services is not None:
            self._services.submit(contents, metadata)

    # ------------------------------------------------------------------
    # the abstract DDS contract (sharedObject.ts:305-510)

    @abc.abstractmethod
    def process_core(self, msg: SequencedMessage, local: bool,
                     local_op_metadata: Any = None) -> None:
        """Apply one sequenced op. ``local`` means our own op came back
        (ack), not a re-application."""

    @abc.abstractmethod
    def summarize_core(self) -> dict:
        """Produce this channel's summary blob (JSON-safe)."""

    @abc.abstractmethod
    def load_core(self, summary: dict) -> None:
        """Initialize state from a summary blob."""

    def resubmit_core(self, contents: Any, metadata: Any = None) -> None:
        """Rebase + resubmit a pending op after reconnect
        (sharedObject.ts:378). Default: resubmit unchanged."""
        self.submit_local_message(contents, metadata)

    def apply_stashed_op(self, contents: Any) -> Any:
        """Apply an op from stashed offline state (sharedObject.ts:510).
        Default: subclasses override."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support stashed ops yet"
        )

    def gc_routes(self) -> list[str]:
        """Outbound GC edges: handle routes stored in this channel's
        data (getGCData, garbageCollection.ts:121). Default scans the
        summary tree for handles; hot channels can override with a
        cheaper direct scan. Raises if the channel cannot summarize —
        a failed GC run must abort rather than silently dropping edges
        (which would eventually sweep live data)."""
        from .handles import collect_handles
        return collect_handles(self.summarize_core())

    def on_sequence_advance(self, seq: int, min_seq: int) -> None:
        """Called for EVERY sequenced message the container processes
        (not just this channel's ops): collab-window progression. The
        reference surfaces this via the runtime's deltaManager events;
        consensus-style DDSes (quorum, register-collection) key their
        accept logic off msn advancing past their op's seq."""

    def signature(self) -> Any:
        """Canonical user-visible content, for convergence checks.
        Replica-local artifacts (tombstone granularity, intern order)
        must not appear. Default: the summary blob."""
        return self.summarize_core()


class ChannelFactory(Protocol):
    """IChannelFactory: how the runtime instantiates channel types."""

    @property
    def type_name(self) -> str: ...

    def create(self, channel_id: str) -> SharedObject: ...

    def load(self, channel_id: str, summary: dict) -> SharedObject: ...


class ChannelRegistry:
    """Maps channel type names to factories (ISharedObjectRegistry)."""

    def __init__(self, factories: Optional[list[ChannelFactory]] = None):
        self._factories: dict[str, ChannelFactory] = {}
        for f in factories or []:
            self.register(f)

    def register(self, factory: ChannelFactory) -> None:
        self._factories[factory.type_name] = factory

    def get(self, type_name: str) -> ChannelFactory:
        if type_name not in self._factories:
            raise KeyError(f"unknown channel type {type_name!r}")
        return self._factories[type_name]

    @property
    def types(self) -> tuple[str, ...]:
        return tuple(self._factories)


def simple_factory(cls) -> ChannelFactory:
    """Factory for SharedObject subclasses with (channel_id) ctor and
    load_core — the common case."""

    class _Factory:
        type_name = cls.type_name

        def create(self, channel_id: str) -> SharedObject:
            return cls(channel_id)

        def load(self, channel_id: str, summary: dict) -> SharedObject:
            obj = cls(channel_id)
            obj.load_core(summary)
            return obj

    return _Factory()
