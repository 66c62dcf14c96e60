"""Fluid handles: serializable cross-object references.

Reference: packages/common/core-interfaces (``IFluidHandle``) — handles
are how one DDS's data points at another datastore/channel/blob, and
they are the edges of the GC reference graph (SURVEY §2.1: "handles =
cross-object references, needed for GC").

A handle is just an absolute route (``/datastore``, ``/datastore/channel``
or ``/_blobs/<id>``) plus equality; the wire encoding is the tagged dict
``{"__handle__": route}`` (protocol.serialization round-trips it).
"""
from __future__ import annotations

from typing import Any


class FluidHandle:
    __slots__ = ("route",)

    def __init__(self, route: str):
        assert route.startswith("/"), f"handle route must be absolute: {route!r}"
        self.route = route

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, FluidHandle) and other.route == self.route

    def __hash__(self) -> int:
        return hash(("FluidHandle", self.route))

    def __repr__(self) -> str:
        return f"FluidHandle({self.route!r})"


def handle_to(*parts: str) -> FluidHandle:
    return FluidHandle("/" + "/".join(parts))


def collect_handles(value: Any) -> list[str]:
    """All handle routes reachable inside a JSON-ish value — the
    outbound GC edges of a stored value (getGCData leaf scan)."""
    out: list[str] = []
    _collect(value, out)
    return out


def _collect(value: Any, out: list[str]) -> None:
    if isinstance(value, FluidHandle):
        out.append(value.route)
    elif isinstance(value, dict):
        for v in value.values():
            _collect(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _collect(v, out)
