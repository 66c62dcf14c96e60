"""The (docs, window, capacity) shape ladder — ONE definition.

``apply_window`` / ``apply_window_chunked`` compile per input shape
(20-40s each on the real chip), so every dispatch pads its window to a
rung of this ladder and every capacity grow doubles along it. The
ladder used to live implicitly in three places (``_pack_rows``'s
bucket loop, ``prewarm``'s nested loops, the regrow doubling) — any
drift between them meant a mid-serve XLA compile that ``prewarm``
never saw. This module is the single source the sidecar's pack path,
``prewarm``, and the bench stages all share: if ``prewarm`` walked it,
steady-state serving cannot hit an uncompiled shape.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BucketLadder:
    """Power-of-two shape ladder for dispatch windows and slab
    capacities.

    ``window_floor``: smallest padded window (small flushes share one
    compiled shape instead of one per width). ``max_bucket``: largest
    window rung ``prewarm`` compiles; a steady-state window above it
    still buckets pow2 (correct, but pays a first-hit compile — keep
    service flush cadence under this).
    """

    window_floor: int = 16
    max_bucket: int = 64

    def window_bucket(self, window: int) -> int:
        """Smallest ladder rung holding ``window`` ops."""
        bucket = self.window_floor
        while bucket < window:
            bucket *= 2
        return bucket

    def window_buckets(self, max_bucket: int | None = None) -> list[int]:
        """Every window rung up to ``max_bucket`` (default: the
        ladder's own) — what ``prewarm`` walks."""
        top = max_bucket or self.max_bucket
        out = []
        bucket = self.window_floor
        while bucket <= top:
            out.append(bucket)
            bucket *= 2
        return out

    @staticmethod
    def capacity_rungs(base: int, max_capacity: int) -> list[int]:
        """Every slab capacity the 2x regrow ladder can reach."""
        out = [base]
        while out[-1] < max_capacity:
            out.append(out[-1] * 2)
        return out

    @staticmethod
    def replay_chunk(capacity: int) -> int:
        """The pool tiers' full-stream replay chunk for a slab of
        ``capacity`` slots — ONE definition (both pools' replay and
        prewarm read it). Leaves headroom for worst-case transient
        growth inside one chunk: each op can add 2 slots and
        compaction only runs between chunks, so chunk=256 against a
        small pool would overflow on history alone even when the
        live set fits. NOTE: ``shapecheck.ladder_bounds`` restates
        this arithmetic import-free by design (the linter imports
        nothing it lints); the jitsan compile-count differential
        pins the two together."""
        return max(16, min(256, capacity // 4))
