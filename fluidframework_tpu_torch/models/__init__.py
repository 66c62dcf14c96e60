"""DDS layer: the distributed data structures — every channel type of
the reference's catalogue, the scalar merge tree and the scalar
SharedTree core (the oracles and host-eviction replicas of the device
planes).

Reference analogue: packages/dds/*.
"""
from ..runtime.shared_object import ChannelRegistry, simple_factory
from .cell import SharedCell
from .consensus import (
    ConsensusOrderedCollection,
    ConsensusRegisterCollection,
)
from .counter import SharedCounter
from .ink import Ink
from .intervals import IntervalCollection, SequenceInterval
from .legacy_tree import LegacySharedTree
from .map import MapKernel, SharedDirectory, SharedMap
from .matrix import SharedMatrix
from .ot import SharedJson, SharedOT
from .property_dds import (
    PropertySchemaRegistry,
    SharedPropertyTree,
)
from .quorum_dds import SharedQuorum
from .sharedstring import SharedString
from .summaryblock import SharedSummaryBlock
from .taskmanager import TaskManager
from .tree import SharedTree


def default_registry() -> ChannelRegistry:
    """Registry with every built-in channel type (the IChannelFactory
    catalogue)."""
    return ChannelRegistry([
        simple_factory(SharedString),
        simple_factory(SharedMatrix),
        simple_factory(SharedMap),
        simple_factory(SharedDirectory),
        simple_factory(SharedCell),
        simple_factory(SharedCounter),
        simple_factory(SharedTree),
        simple_factory(LegacySharedTree),
        simple_factory(SharedJson),
        simple_factory(SharedPropertyTree),
        simple_factory(ConsensusRegisterCollection),
        simple_factory(ConsensusOrderedCollection),
        simple_factory(TaskManager),
        simple_factory(SharedQuorum),
        simple_factory(Ink),
        simple_factory(SharedSummaryBlock),
    ])


__all__ = [
    "ConsensusOrderedCollection",
    "ConsensusRegisterCollection",
    "Ink",
    "IntervalCollection",
    "MapKernel",
    "SequenceInterval",
    "SharedCell",
    "SharedCounter",
    "SharedDirectory",
    "SharedJson",
    "SharedMap",
    "SharedMatrix",
    "PropertySchemaRegistry",
    "SharedOT",
    "SharedPropertyTree",
    "SharedQuorum",
    "SharedString",
    "LegacySharedTree",
    "SharedSummaryBlock",
    "SharedTree",
    "TaskManager",
    "default_registry",
]
