"""The (docs, window, capacity) shape ladder — ONE definition — and the
per-root bounds on the launch signatures it allows (``ladder_bounds``).

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
        live set fits. ``ladder_bounds`` reads it for the pools'
        replay windows."""
        return max(16, min(256, capacity // 4))


def ladder_bounds(window_floor: int, max_bucket: int, capacity: int,
                  max_capacity: int, executor: str = "scan",
                  donate: bool = False,
                  pool_capacity: int | None = None,
                  pool_rows: int = 1) -> dict[str, int]:
    """Per-root bounds on the distinct launch signatures a sidecar of
    this ladder (one ``max_docs``) may reach when every dispatch rides
    the ladder — the port's form of the reference's
    ``shapecheck.ladder_bounds``, which ``testing/jitsan.py``'s counts
    must stay within. Eager torch compiles nothing per shape, so a
    "signature" is a distinct launch shape per root: the window kernel's
    (docs, capacity, window), the macro-step routes'
    (docs, capacity, K, window), ``compact``'s and ``pad_capacity``'s
    shapes, the mesh pool's (shards, rows, capacity, window) and its row
    moves' (shards, rows, capacity). One more than the bound means an
    unladdered call site reached the device with a shape the ladder
    does not hold.

    ``pool_capacity`` adds a doc-sharded pool's roots: ``pool_rows`` is
    the largest per-shard row bucket the run may reach, and its windows
    are the ladder's plus the replay chunk when that lies outside it."""
    ladder = BucketLadder(window_floor, max_bucket)
    n_buckets = len(ladder.window_buckets())
    n_rungs = len(BucketLadder.capacity_rungs(capacity, max_capacity))
    shapes = n_buckets * n_rungs
    route_roots = {"scan": ("apply_window",), "chunked": ("chunked",),
                   "egwalker": ("egwalker", "apply_window")}[executor]
    # the donating twin rides the route's own root (an egwalker suffix
    # always dispatches plain)
    donating = {"scan": "apply_window", "chunked": "chunked",
                "egwalker": "egwalker"}[executor]
    bounds = {}
    for root in ("apply_window", "chunked", "egwalker"):
        bounds[root] = shapes if root in route_roots else 0
        bounds[root + "_pingpong"] = (shapes if donate and root == donating
                                      else 0)
    bounds["compact"] = n_rungs
    bounds["pad_capacity"] = n_rungs - 1
    if pool_capacity is not None:
        rows = len(BucketLadder.capacity_rungs(1, max(pool_rows, 1)))
        n_windows = n_buckets
        chunk = BucketLadder.replay_chunk(pool_capacity)
        if not window_floor <= chunk <= max_bucket:
            n_windows += 1
        bounds["mesh_pool"] = rows * n_windows
        if executor in ("chunked", "egwalker"):
            # a one-shard pool follows the route CHUNKED (an egwalker
            # pool too: its dispatches are full-history replays)
            bounds["chunked"] += rows * n_windows
        bounds["mesh_move"] = rows
        bounds["compact"] += rows
    return bounds


def tree_ladder_bounds(capacity: int, max_capacity: int,
                       pool_rows: int | None = None) -> dict[str, int]:
    """The tree plane's counterpart of ``ladder_bounds``: the tree window
    uploads only its real steps (``tree_apply.window_extent``), so its
    launch signature is (route, docs, capacity) — one per capacity rung
    of the primary slab, plus one per pow2 row bucket of the pooled tier
    up to ``pool_rows`` — and the pad step one per rung transition."""
    n_rungs = len(BucketLadder.capacity_rungs(capacity, max_capacity))
    rows = (0 if pool_rows is None
            else len(BucketLadder.capacity_rungs(1, max(pool_rows, 1))))
    return {"tree_window": n_rungs + rows, "tree_pad": n_rungs - 1}
