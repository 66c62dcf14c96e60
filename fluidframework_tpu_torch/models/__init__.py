"""Host-side models: the scalar merge tree and the scalar SharedTree core
(the oracles and host-eviction replicas), the SharedString DDS with its
interval collections over that merge tree, and SharedMap /
SharedDirectory.

Reference analogue: packages/dds/*. The registry holds the channel types
the port has; the other DDSes are still to port.
"""
from ..runtime.shared_object import ChannelRegistry, simple_factory
from .intervals import IntervalCollection, SequenceInterval
from .map import MapKernel, SharedDirectory, SharedMap
from .sharedstring import SharedString


def default_registry() -> ChannelRegistry:
    """Registry with every channel type of the port (the IChannelFactory
    catalogue)."""
    return ChannelRegistry([
        simple_factory(SharedString),
        simple_factory(SharedMap),
        simple_factory(SharedDirectory),
    ])


__all__ = [
    "IntervalCollection",
    "MapKernel",
    "SequenceInterval",
    "SharedDirectory",
    "SharedMap",
    "SharedString",
    "default_registry",
]
