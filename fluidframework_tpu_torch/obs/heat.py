"""Heat: the per-key EWMA the doc-sharded pool's migration policy reads.

A trimmed copy of the reference's ``obs/heat.py::HeatLedger``: the EWMA
tick, reads, removal and the LRU cap, without the accumulator columns,
the attribution helpers and the metrics registry (ROADMAP A10/A11).

The tick ``heat * decay + depth`` is two correctly-rounded float64 ops
per key, the reference's arithmetic exactly, so a pool fed the same
dispatch depths makes the same migration choices. Determinism: the same
key sequence gives the same values and the same key order. At most
``max_keys`` keys are held; inserting past the cap evicts the
least-recently-WRITTEN key (reads never reorder).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Mapping, Optional


class HeatLedger:
    """Deterministic per-key EWMA, LRU-capped at ``max_keys``."""

    def __init__(self, max_keys: int = 4096, decay: float = 0.8) -> None:
        if max_keys < 1:
            raise ValueError("max_keys must be >= 1")
        self.max_keys = int(max_keys)
        self.decay = float(decay)
        # key -> heat, in least-recently-WRITTEN-first order
        self._heat: OrderedDict = OrderedDict()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._heat)

    def __contains__(self, key) -> bool:
        return key in self._heat

    def keys(self) -> list:
        """Live keys, least-recently-written first."""
        return list(self._heat)

    def _touch(self, key) -> float:
        """The key's heat, moved to the most-recently-written end
        (inserted at 0.0, evicting the least recent past the cap)."""
        if key in self._heat:
            self._heat.move_to_end(key)
            return self._heat[key]
        if len(self._heat) >= self.max_keys:
            self._heat.popitem(last=False)
            self.evictions += 1
        self._heat[key] = 0.0
        return 0.0

    def ewma_tick(self, keys: Iterable, depths: Mapping,
                  decay: Optional[float] = None) -> None:
        """One EWMA step over ``keys`` (unique):
        ``heat[k] = heat[k] * decay + float(depths.get(k, 0))``."""
        d = self.decay if decay is None else float(decay)
        for k in keys:
            self._heat[k] = self._touch(k) * d + float(depths.get(k, 0))

    def pop(self, key, default: float = 0.0) -> float:
        return self._heat.pop(key, default)

    def get(self, key, default: float = 0.0) -> float:
        return self._heat.get(key, default)
