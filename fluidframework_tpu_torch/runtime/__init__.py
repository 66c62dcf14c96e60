"""Runtime layers of the port: container/datastore orchestration, op
lifecycle, pending state, the channel plugin boundary and the summarizer
(copies of the reference's ``runtime`` modules; ``gc`` and
``attribution`` are imported by name, as in the reference).

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
from .summarizer import (
    OrderedClientElection,
    RunningSummarizer,
    SummarizerHeuristics,
    SummaryCollection,
    SummaryManager,
)

__all__ = [
    "ChannelFactory",
    "ChannelRegistry",
    "ContainerRuntime",
    "DataStoreRuntime",
    "OrderedClientElection",
    "PendingStateManager",
    "RunningSummarizer",
    "SharedObject",
    "SummarizerHeuristics",
    "SummaryCollection",
    "SummaryManager",
    "simple_factory",
]
