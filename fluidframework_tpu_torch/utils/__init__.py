"""Shared utilities of the port: events, telemetry, config (copies of
the reference's ``utils`` modules the loader and runtime use).

Reference analogue: common/lib/common-utils, packages/utils/telemetry-utils.
"""
from .events import EventEmitter

__all__ = ["EventEmitter"]
