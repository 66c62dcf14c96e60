"""DataObject: the "write a Fluid object" authoring API.

Reference: packages/framework/aqueduct/src/data-objects —
``PureDataObject`` (pureDataObject.ts:33) and ``DataObject``
(dataObject.ts:25): a user subclass over a datastore with a private
root SharedMap, lifecycle hooks, and a factory
(``DataObjectFactory``) that registers it like any channel type.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..models.map import SharedMap

if TYPE_CHECKING:  # pragma: no cover
    from ..runtime.container_runtime import ContainerRuntime
    from ..runtime.datastore import DataStoreRuntime

ROOT_MAP_ID = "root"


class PureDataObject:
    """pureDataObject.ts:33 — lifecycle base. Subclasses override the
    ``initializing_*`` hooks; ``has_initialized`` runs on every load."""

    def __init__(self, datastore: "DataStoreRuntime"):
        self.datastore = datastore

    # ---- lifecycle hooks (subclass surface)

    def initializing_first_time(self) -> None:
        """Called exactly once, on the client that creates the object."""

    def initializing_from_existing(self) -> None:
        """Called when loading an object someone else created."""

    def has_initialized(self) -> None:
        """Called after either initialize path, every load."""


class DataObject(PureDataObject):
    """dataObject.ts:25 — PureDataObject + a root SharedMap."""

    @property
    def root(self) -> SharedMap:
        return self.datastore.get_channel(ROOT_MAP_ID)


class DataObjectFactory:
    """aqueduct's DataObjectFactory: creates/loads the datastore and
    runs the lifecycle. ``object_type`` names the datastore id prefix
    the same way the reference uses registry types."""

    def __init__(self, object_type: str, object_class=DataObject):
        self.object_type = object_type
        self.object_class = object_class

    def create(self, runtime: "ContainerRuntime",
               datastore_id: Optional[str] = None,
               root: bool = True) -> DataObject:
        ds = runtime.create_datastore(
            datastore_id or self.object_type, root=root
        )
        if issubclass(self.object_class, DataObject):
            ds.create_channel("sharedmap", ROOT_MAP_ID)
        obj = self.object_class(ds)
        obj.initializing_first_time()
        obj.has_initialized()
        return obj

    def load(self, runtime: "ContainerRuntime",
             datastore_id: Optional[str] = None) -> DataObject:
        ds = runtime.get_datastore(datastore_id or self.object_type)
        obj = self.object_class(ds)
        obj.initializing_from_existing()
        obj.has_initialized()
        return obj
