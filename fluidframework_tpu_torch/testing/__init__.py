"""Seeded traffic for the port: the mock collaboration session and the
op-stream recorders."""
from .fuzz import FuzzConfig, record_op_stream, record_sequential_stream
from .mocks import MockCollabSession

__all__ = [
    "FuzzConfig",
    "MockCollabSession",
    "record_op_stream",
    "record_sequential_stream",
]
