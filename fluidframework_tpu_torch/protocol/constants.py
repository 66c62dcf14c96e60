"""Sequence-number sentinels of the merge tree.

Reference: packages/dds/merge-tree/src/constants.ts:11-15. Only the
values the port's modules read are kept here.
"""

# Seq for local, not-yet-acked ops/segments.
UNASSIGNED_SEQ = -1

# Client id used when not collaborating.
NON_COLLAB_CLIENT = -2

# Normalised comparison values for tie-breaking (mergeTree.ts:1705):
# a local pending *op* compares as the highest possible seq; a local
# pending *segment* as the second highest (the op being placed always
# sequences after segments already in the tree).
MAX_SEQ = 2**53 - 1
