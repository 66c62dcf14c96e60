"""Framework app-layer helpers: oldest-client observer, DDS
interceptions, request routing.

Reference packages (SURVEY §2.8):
- ``oldest-client-observer``: elects the longest-connected interactive
  client (join order over the quorum) and emits becameOldest /
  lostOldest — apps use it to run singleton work client-side without a
  server lease.
- ``dds-interceptions`` (packages/framework/dds-interceptions): wrap a
  SharedString/SharedMap so every LOCAL edit passes through an
  interception callback (the canonical use: stamping attribution /
  style props onto text as it is typed) while remote ops flow
  untouched.
- ``request-handler``: composable routers over container request
  paths (`/datastore/channel`), the RequestParser utilities.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from ..utils.events import EventEmitter


# ----------------------------------------------------------------------
# oldest-client observer


class OldestClientObserver(EventEmitter):
    """Tracks whether THIS client is the oldest in the quorum
    (oldestClientObserver.ts). Oldest = earliest joined, which is the
    quorum's member insertion order; falls to the next client when the
    current oldest leaves."""

    def __init__(self, quorum, my_client_id: str):
        super().__init__()
        self._quorum = quorum
        self._my_id = my_client_id
        self._was_oldest = self.is_oldest()
        quorum.on("addMember", self._recheck)
        quorum.on("removeMember", self._recheck)

    def oldest_client_id(self) -> Optional[str]:
        members = self._quorum.members
        return next(iter(members), None)

    def is_oldest(self) -> bool:
        return self.oldest_client_id() == self._my_id

    def _recheck(self, *_args) -> None:
        now = self.is_oldest()
        if now and not self._was_oldest:
            self._was_oldest = True
            self.emit("becameOldest")
        elif not now and self._was_oldest:
            self._was_oldest = False
            self.emit("lostOldest")


# ----------------------------------------------------------------------
# DDS interceptions


class InterceptedSharedString:
    """SharedString wrapper applying a props interception to every
    LOCAL edit (createSharedStringWithInterception): e.g. stamp the
    current user/timestamp/style onto typed text. Reads and remote
    processing hit the underlying channel directly."""

    def __init__(self, string,
                 props_interceptor: Callable[[int, Optional[dict]],
                                             Optional[dict]]):
        self._string = string
        self._interceptor = props_interceptor

    def insert_text(self, pos: int, text: str,
                    props: Optional[dict] = None) -> None:
        self._string.insert_text(
            pos, text, self._interceptor(pos, props))

    def annotate_range(self, start: int, end: int,
                       props: dict) -> None:
        merged = self._interceptor(start, props)
        # an interceptor returning {} means "strip the props", not
        # "fall back to the originals" — only None defers
        self._string.annotate_range(
            start, end, merged if merged is not None else props)

    def __getattr__(self, name: str):  # reads + everything else
        return getattr(self._string, name)


class InterceptedSharedMap:
    """SharedMap wrapper passing every local set through the
    interceptor (createDirectoryWithInterception pattern): return a
    replacement value, or raise to veto the write."""

    def __init__(self, map_,
                 set_interceptor: Callable[[str, Any], Any]):
        self._map = map_
        self._interceptor = set_interceptor

    def set(self, key: str, value: Any) -> None:
        self._map.set(key, self._interceptor(key, value))

    def __getattr__(self, name: str):
        return getattr(self._map, name)


def create_shared_string_with_interception(string, props_interceptor):
    return InterceptedSharedString(string, props_interceptor)


def create_shared_map_with_interception(map_, set_interceptor):
    return InterceptedSharedMap(map_, set_interceptor)


# ----------------------------------------------------------------------
# request routing


class RequestParser:
    """Path-segment parser over container request urls
    (runtime-utils RequestParser)."""

    def __init__(self, url: str):
        self.url = url
        self.path_parts = [p for p in url.split("/") if p]

    @staticmethod
    def create(url: str) -> "RequestParser":
        return RequestParser(url)

    def is_leaf(self, elements: int) -> bool:
        return len(self.path_parts) == elements


class RequestHandlerError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def build_request_handler(*handlers: Callable):
    """Compose handlers first-match-wins
    (buildRuntimeRequestHandler). Each handler takes
    (RequestParser, runtime) and returns a result or None."""

    def route(url: str, runtime) -> Any:
        parser = RequestParser(url)
        for handler in handlers:
            result = handler(parser, runtime)
            if result is not None:
                return result
        raise RequestHandlerError(404, f"no handler for {url!r}")

    return route


def datastore_channel_handler(parser: RequestParser, runtime) -> Any:
    """Default `/datastore[/channel]` resolution — the shape
    FluidHandle routes use (runtime/handles.py handle_to)."""
    if not parser.path_parts or len(parser.path_parts) > 2:
        return None  # trailing segments are NOT a match (strict 404)
    try:
        ds = runtime.get_datastore(parser.path_parts[0])
    except KeyError:
        return None
    if parser.is_leaf(1):
        return ds
    try:
        return ds.get_channel(parser.path_parts[1])
    except KeyError:
        return None


# ----------------------------------------------------------------------
# agent scheduler


class AgentScheduler(EventEmitter):
    """packages/framework/agent-scheduler: register named tasks with
    worker callbacks; exactly ONE connected client runs each task at a
    time (election rides the TaskManager DDS's sequenced volunteer
    queue), with automatic re-election when the assignee leaves.

    Events: ``picked(task_id)`` when this client wins a task,
    ``released(task_id)`` when it loses/abandons one.
    """

    def __init__(self, task_manager):
        super().__init__()
        self._tasks = task_manager
        self._workers: dict[str, Callable[[], None]] = {}
        self._running: set[str] = set()
        task_manager.on("assigned", self._on_change)
        task_manager.on("queueChanged", self._on_change)

    def register(self, task_id: str,
                 worker: Callable[[], None]) -> None:
        """Volunteer for ``task_id``; ``worker`` runs when (and only
        while) this client holds the assignment."""
        self._workers[task_id] = worker
        if not self._tasks.queued(task_id) \
                and not self._tasks.have_task(task_id):
            self._tasks.volunteer(task_id)
        self._maybe_start(task_id)

    def unregister(self, task_id: str) -> None:
        self._workers.pop(task_id, None)
        if task_id in self._running:
            self._running.discard(task_id)
            self.emit("released", task_id)
        self._tasks.abandon(task_id)

    def picked_tasks(self) -> list[str]:
        return sorted(self._running)

    def _maybe_start(self, task_id: str) -> None:
        if task_id in self._running:
            return
        if task_id in self._workers and self._tasks.have_task(task_id):
            self._running.add(task_id)
            self.emit("picked", task_id)
            self._workers[task_id]()

    def _on_change(self, task_id: str, *_):
        if task_id in self._running \
                and not self._tasks.have_task(task_id):
            self._running.discard(task_id)
            self.emit("released", task_id)
        else:
            self._maybe_start(task_id)
