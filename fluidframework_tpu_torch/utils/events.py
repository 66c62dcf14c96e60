"""Minimal typed event emitter + Deferred.

Reference: common/lib/common-utils (TypedEventEmitter, Deferred).
"""
from __future__ import annotations

from typing import Any, Callable


class EventEmitter:
    def __init__(self) -> None:
        self._listeners: dict[str, list[Callable[..., Any]]] = {}

    def on(self, event: str, listener: Callable[..., Any]) -> Callable[[], None]:
        self._listeners.setdefault(event, []).append(listener)

        def off() -> None:
            self.off(event, listener)

        return off

    def once(self, event: str, listener: Callable[..., Any]) -> Callable[[], None]:
        def wrapper(*args: Any, **kwargs: Any) -> None:
            self.off(event, wrapper)
            listener(*args, **kwargs)

        return self.on(event, wrapper)

    def off(self, event: str, listener: Callable[..., Any]) -> None:
        handlers = self._listeners.get(event, [])
        if listener in handlers:
            handlers.remove(listener)

    def emit(self, event: str, *args: Any, **kwargs: Any) -> None:
        for listener in list(self._listeners.get(event, [])):
            listener(*args, **kwargs)

    def listener_count(self, event: str) -> int:
        return len(self._listeners.get(event, []))
