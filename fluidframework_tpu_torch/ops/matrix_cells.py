"""Device-side SharedMatrix cell application: sort + last-wins. A port
of the reference's ``ops/matrix_cells.py`` (ROADMAP B10), plain torch.

Reference semantics: packages/dds/matrix/src/matrix.ts:79 — cell
writes are LWW registers keyed by (rowHandle, colHandle); handles are
stable under any concurrent row/col permutation (permutationvector.ts
:137), so cell conflict resolution never needs the merge tree: the
winner of a key is simply the highest-sequenced write.

Device mapping: an entire WINDOW of setCell ops is one batched sort by
(cell key, window index) followed by a run-end winner mask and one
scatter into the dense handle-space grid — no sequential scan, no
per-op dispatch.

Handles are interned host-side to dense ints (a grid over the
ALLOCATED handle space — removed rows keep their lane, exactly like
the reference's handle table retaining dead handles until GC). The
grid stores the winning WINDOW INDEX; values stay host-side in a
per-matrix table.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def apply_cells_kernel(keys: torch.Tensor, n_rows: int,
                       n_cols: int) -> torch.Tensor:
    """[M, N] cell-write keys -> [M, n_rows, n_cols] int32 LWW grid of
    winning window indices (-1 = never written), on the keys' device.

    keys = row_handle * n_cols + col_handle, or -1 padding. Window
    order IS sequenced order, so the tie-break within a key is the
    window index itself. Callers keep the int32 composite
    ``(n_rows * n_cols) * (N + 1)`` under 2**31 (``CellPack.apply``
    splits the window when it would not)."""
    M, N = keys.shape
    stride = N + 1
    idx = torch.arange(N, dtype=torch.int32, device=keys.device)
    composite = keys.to(torch.int32) * stride + idx
    # composites are unique per row, so an unstable sort is exact
    scomp = torch.sort(composite, dim=-1).values
    # floor division and floor modulo, as the reference's // and %:
    # padding composites are negative
    skey = torch.where(
        scomp >= 0, torch.div(scomp, stride, rounding_mode="floor"), -1)
    swin = torch.remainder(scomp, stride)
    nxt = torch.cat([skey[:, 1:], torch.full_like(skey[:, :1], -2)], dim=-1)
    winner = (skey != nxt) & (skey >= 0)
    # scatter winners; losers and padding go to a dump slot past the
    # end (their writes there race on CUDA; the slot is sliced off, and
    # every winner's index is unique)
    space = n_rows * n_cols
    dest = torch.where(winner, skey, space).long()
    grid = torch.full((M, space + 1), -1, dtype=torch.int32,
                      device=keys.device)
    grid.scatter_(1, dest, swin)
    return grid[:, :space].reshape(M, n_rows, n_cols)


class CellPack:
    """Host-side interning of one batch of matrices' cell streams into
    the kernel's array layout. ``device`` is where ``apply`` runs:
    ``"cuda"`` unless the caller asks for ``"cpu"``."""

    def __init__(self, n_rows: int, n_cols: int,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CellPack needs a CUDA device; pass "
                               "device='cpu' to run on the CPU")
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.row_ids: list[dict[str, int]] = []
        self.col_ids: list[dict[str, int]] = []
        self.val_tables: list[list[Any]] = []
        self.keys: Optional[np.ndarray] = None

    def pack(self, streams) -> None:
        """streams: MatrixStream list; builds the [M, N] key array
        (N = max cell-op count across matrices, -1 padded)."""
        M = len(streams)
        N = max((len(s.cell_vals) for s in streams), default=0)
        keys = np.full((M, max(N, 1)), -1, np.int32)
        self.row_ids, self.col_ids, self.val_tables = [], [], []
        for m, s in enumerate(streams):
            r_ids: dict[str, int] = {}
            c_ids: dict[str, int] = {}
            for i, (rh, ch) in enumerate(zip(s.cell_rows, s.cell_cols)):
                r = r_ids.setdefault(rh, len(r_ids))
                c = c_ids.setdefault(ch, len(c_ids))
                if r >= self.n_rows or c >= self.n_cols:
                    raise ValueError("cell handle space overflow")
                keys[m, i] = r * self.n_cols + c
            self.row_ids.append(r_ids)
            self.col_ids.append(c_ids)
            self.val_tables.append(list(s.cell_vals))
        self.keys = keys

    def apply(self, budget: int = 2**31 - 1) -> torch.Tensor:
        """Device dispatch covering every matrix's whole cell window
        (one host-to-device copy of the keys). One kernel call
        normally; if the int32 composite key would overflow ``budget``,
        the window splits into segments combined LWW (later segment
        wins — same order the single sort respects). ``budget`` exists
        so tests can force the segmentation branch at small sizes."""
        keys = torch.from_numpy(np.asarray(self.keys, np.int32)).to(
            self.device)
        M, N = keys.shape
        space = self.n_rows * self.n_cols
        max_n = max(1, budget // max(space, 1) - 1)
        if N <= max_n:
            return apply_cells_kernel(keys, self.n_rows, self.n_cols)
        grid = None
        for s in range(0, N, max_n):
            part = apply_cells_kernel(keys[:, s:s + max_n], self.n_rows,
                                      self.n_cols)
            part = torch.where(part >= 0, part + s, part)
            grid = part if grid is None else torch.where(
                part >= 0, part, grid)
        return grid

    def lookup(self, grid_np: np.ndarray, m: int, row_handle: str,
               col_handle: str) -> Any:
        """Read one cell's LWW value from the fetched grid."""
        r = self.row_ids[m].get(row_handle)
        c = self.col_ids[m].get(col_handle)
        if r is None or c is None:
            return None
        idx = int(grid_np[m, r, c])
        return None if idx < 0 else self.val_tables[m][idx]
