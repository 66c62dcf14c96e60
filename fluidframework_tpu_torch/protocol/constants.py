"""Sequence-number sentinels of the merge tree, the wire-version order
and the batch boundary marks.

Reference: packages/dds/merge-tree/src/constants.ts:11-15. Only the
values and helpers the port's modules read are kept here; the
reviewed wire-schema registry comes with the socket ingress.
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


def wire_version_lt(a: str, b: str) -> bool:
    """Wire-protocol version ordering — ONE definition shared by the
    server's frame gate (service/ingress) and the driver's client-side
    guard (drivers/socket_driver): numeric dotted compare, so '1.10'
    orders above '1.2'."""
    return tuple(int(x) for x in a.split(".")) < \
        tuple(int(x) for x in b.split("."))


def mark_batch(metadata, flag: bool) -> dict:
    """Batch boundary marks riding message metadata
    (batchManager.ts batch metadata: first op {batch: true}, last
    {batch: false}; singletons carry no mark). Lives at the protocol
    layer: the marks are a WIRE contract — the runtime writes them,
    the loader's ScheduleManager and the socket driver's boxcar
    batching both read them."""
    out = dict(metadata) if isinstance(metadata, dict) else {}
    out["batch"] = flag
    return out


def batch_flag(metadata):
    """Read a batch boundary mark (None = unmarked / mid-batch)."""
    if isinstance(metadata, dict):
        return metadata.get("batch")
    return None
