"""FluidContainer: the simplified schema-first container API.

Reference: packages/framework/fluid-static/src —
``FluidContainer`` (fluidContainer.ts:201): apps declare
``initial_objects`` (name -> DDS type) and get them ready-made;
``create_dds`` makes additional dynamic channels referenced by handle.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from ..runtime.shared_object import SharedObject
from ..utils.events import EventEmitter

if TYPE_CHECKING:  # pragma: no cover
    from ..loader.container import Container

SCHEMA_DATASTORE = "initial-objects"


class FluidContainer(EventEmitter):
    """fluidContainer.ts:201 — schema-first facade over a loaded
    loader-layer Container."""

    def __init__(self, container: "Container", schema: dict[str, str],
                 create: bool):
        super().__init__()
        self._container = container
        self.schema = dict(schema)
        runtime = container.runtime
        if create:
            ds = runtime.create_datastore(SCHEMA_DATASTORE)
            for name, dds_type in schema.items():
                ds.create_channel(dds_type, name)
            container.flush()
        elif SCHEMA_DATASTORE not in runtime.datastores:
            # an empty schema produces no attach traffic, so the
            # store materializes lazily on loading clients
            runtime.create_datastore(SCHEMA_DATASTORE)
        self._datastore = runtime.get_datastore(SCHEMA_DATASTORE)
        container.on("connected", lambda: self.emit("connected"))
        container.on("disconnected", lambda: self.emit("disconnected"))

    @property
    def initial_objects(self) -> dict[str, SharedObject]:
        return {
            name: self._datastore.get_channel(name)
            for name in self.schema
        }

    @property
    def connected(self) -> bool:
        return self._container.connected

    @property
    def container(self) -> "Container":
        """The underlying loader container (advanced escape hatch)."""
        return self._container

    def create_dds(self, dds_type: str, channel_id: str) -> SharedObject:
        """Dynamically create an additional channel; store its handle
        in a reachable place or GC will collect it
        (fluid-static create flow)."""
        return self._datastore.create_channel(dds_type, channel_id)

    def disconnect(self) -> None:
        self._container.disconnect()

    def connect(self) -> None:
        self._container.connect()

    def dispose(self) -> None:
        self._container.close()
