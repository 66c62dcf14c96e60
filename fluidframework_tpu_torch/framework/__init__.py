"""Framework/API layer: the app-facing surface.

Reference analogue: packages/framework/* (aqueduct, fluid-static,
undo-redo) + the service clients (tinylicious-client/azure-client).
"""
from .clients import ContainerServices, LocalServiceClient
from .data_object import DataObject, DataObjectFactory, PureDataObject
from .fluid_static import FluidContainer
from .helpers import (
    AgentScheduler,
    OldestClientObserver,
    RequestHandlerError,
    RequestParser,
    build_request_handler,
    create_shared_map_with_interception,
    create_shared_string_with_interception,
    datastore_channel_handler,
)
from .undo_redo import (
    SharedMapUndoRedoHandler,
    SharedStringUndoRedoHandler,
    UndoRedoStackManager,
)

__all__ = [
    "AgentScheduler",
    "ContainerServices",
    "DataObject",
    "DataObjectFactory",
    "FluidContainer",
    "LocalServiceClient",
    "OldestClientObserver",
    "RequestHandlerError",
    "RequestParser",
    "build_request_handler",
    "create_shared_map_with_interception",
    "create_shared_string_with_interception",
    "datastore_channel_handler",
    "PureDataObject",
    "SharedMapUndoRedoHandler",
    "SharedStringUndoRedoHandler",
    "UndoRedoStackManager",
]
