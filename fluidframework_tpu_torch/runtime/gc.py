"""Distributed garbage collection: mark, sweep-ready, tombstone.

Reference:
- ``runGarbageCollection`` (packages/runtime/garbage-collector/src/
  garbageCollector.ts:15): BFS over the handle-reference graph.
- ``GarbageCollector`` (packages/runtime/container-runtime/src/
  garbageCollection.ts:340): per-node unreferenced timestamps (mark
  phase), sweep-ready detection after a configurable timeout
  (gcSweepReadyUsageDetection.ts), and tombstones
  (garbageCollectionTombstoneUtils.ts) — tombstoned routes fail on
  access before they are deleted, surfacing use-after-unreference bugs.

GC runs on the summarizer client alongside summaries (§3.4: GC data is
collected with ``getGCData`` during the summary walk) and its results
ride the summary so every client agrees on unreferenced state.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover
    from .container_runtime import ContainerRuntime


def run_garbage_collection(
    graph: dict[str, list[str]], roots: list[str]
) -> tuple[set[str], set[str]]:
    """(referenced, unreferenced) node sets via BFS from ``roots``
    (garbage-collector/src/garbageCollector.ts:15)."""
    referenced: set[str] = set()
    queue = deque(r for r in roots if r in graph)
    referenced.update(queue)
    while queue:
        node = queue.popleft()
        for target in graph.get(node, ()):  # outbound routes
            if target in graph and target not in referenced:
                referenced.add(target)
                queue.append(target)
    return referenced, set(graph) - referenced


@dataclass
class GCResult:
    referenced: set[str] = field(default_factory=set)
    unreferenced: set[str] = field(default_factory=set)
    sweep_ready: set[str] = field(default_factory=set)
    tombstoned: set[str] = field(default_factory=set)
    deleted: set[str] = field(default_factory=set)


class GarbageCollector:
    """garbageCollection.ts:340 — tracks unreferenced-since timestamps
    across GC runs; nodes unreferenced longer than
    ``tombstone_timeout_s`` become tombstones (access traps), and past
    ``sweep_timeout_s`` they are sweep-ready (deletable)."""

    def __init__(self, runtime: "ContainerRuntime",
                 tombstone_timeout_s: float = 7 * 24 * 3600,
                 sweep_timeout_s: Optional[float] = None,
                 clock=None):
        import time as _time
        self.runtime = runtime
        self.tombstone_timeout_s = tombstone_timeout_s
        self.sweep_timeout_s = (
            sweep_timeout_s if sweep_timeout_s is not None
            else tombstone_timeout_s + 24 * 3600
        )
        self._clock = clock or _time.time
        # route -> timestamp first observed unreferenced
        self.unreferenced_since: dict[str, float] = {}
        self.tombstones: set[str] = set()
        runtime.gc = self  # summaries now carry this collector's state
        if runtime._loaded_gc_state is not None:
            self.load(runtime._loaded_gc_state)

    def collect(self, sweep: bool = False) -> GCResult:
        """One mark (+ optional sweep) pass over the live runtime."""
        now = self._clock()
        graph, roots = self.runtime.get_gc_graph()
        referenced, unreferenced = run_garbage_collection(graph, roots)

        # mark phase: maintain unreferenced-since timestamps
        for route in list(self.unreferenced_since):
            if route in referenced or route not in graph:
                del self.unreferenced_since[route]  # revived or gone
                self.tombstones.discard(route)
        for route in unreferenced:
            self.unreferenced_since.setdefault(route, now)

        result = GCResult(referenced=referenced,
                          unreferenced=unreferenced)
        for route, since in self.unreferenced_since.items():
            age = now - since
            if age >= self.tombstone_timeout_s:
                self.tombstones.add(route)
            if age >= self.sweep_timeout_s:
                result.sweep_ready.add(route)
        result.tombstoned = set(self.tombstones)

        if sweep and result.sweep_ready:
            for route in sorted(result.sweep_ready, reverse=True):
                if self.runtime.delete_route(route):
                    result.deleted.add(route)
                self.unreferenced_since.pop(route, None)
                self.tombstones.discard(route)
        self.runtime.set_tombstones(self.tombstones)
        return result

    # ---- summary persistence (GC state rides the summary, §3.4)

    def snapshot(self) -> dict:
        return {
            "unreferencedSince": dict(self.unreferenced_since),
            "tombstones": sorted(self.tombstones),
        }

    def load(self, state: dict) -> None:
        self.unreferenced_since = dict(state.get("unreferencedSince", {}))
        self.tombstones = set(state.get("tombstones", []))
        self.runtime.set_tombstones(self.tombstones)
