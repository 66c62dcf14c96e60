"""Runtime layers of the port: container/datastore orchestration, op
lifecycle, pending state, the channel plugin boundary (copies of the
reference's ``runtime`` modules; the summarizer, GC and attribution
come later).

Reference analogue: packages/runtime/*, packages/loader.
"""
from .container_runtime import ContainerRuntime, PendingStateManager
from .datastore import DataStoreRuntime
from .shared_object import (
    ChannelFactory,
    ChannelRegistry,
    SharedObject,
    simple_factory,
)

__all__ = [
    "ChannelFactory",
    "ChannelRegistry",
    "ContainerRuntime",
    "DataStoreRuntime",
    "PendingStateManager",
    "SharedObject",
    "simple_factory",
]
