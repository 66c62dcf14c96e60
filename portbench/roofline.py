"""The least time of each window apply, from the work its data needs:
the larger of its int32 operations over the card's peak int32 rate and
its bytes over the peak memory rate.

- Operations: ``OPS_PER_SLOT_STEP`` per live slot-step, the live
  slot-steps counted by the reference (for every insert, remove or
  annotate step, the document's live slots at that step). 135 is the
  port's own count of one plain step (``ops/window_cost.py`` at the
  benchmark's writing), frozen here so that the yardstick does not move
  with the program.
- Bytes: the segment table read once and written once, the op batch
  read once.
- Peaks of one H100 SXM: int32 132 SMs x 64 lanes x 1.98 GHz (derived
  from NVIDIA's data sheet: 64 INT32 lanes per SM, the boost clock), HBM3
  3.35 TB/s (data sheet). A card set below its 700 W limit runs slower;
  the run records the limit beside the share.
"""
from __future__ import annotations

import numpy as np

OPS_PER_SLOT_STEP = 135
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
SLOT_BYTES = (8 + 4) * 4     # eight int32 slot fields, four prop channels
DOC_BYTES = 3 * 4            # count, min_seq, overflow
OP_BYTES = 12 * 4            # the op batch's twelve int32 fields


def window_bytes(docs: int, capacity: int, win: int) -> int:
    return 2 * docs * (capacity * SLOT_BYTES + DOC_BYTES) + \
        docs * win * OP_BYTES


def least_seconds(live: np.ndarray, tile, docs: int, capacity: int,
                  win: int) -> np.ndarray:
    """Per round of a batch, the least time of its window apply:
    ``live`` is the reference's ``[rounds, sessions]`` live slot-steps,
    ``tile[d]`` the session of document ``d``."""
    per_session = np.bincount(np.asarray(tile), minlength=live.shape[1])
    ops = OPS_PER_SLOT_STEP * (live * per_session[None, :]).sum(axis=1)
    nbytes = window_bytes(docs, capacity, win)
    return np.maximum(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
