"""Sharding and dispatch: documents spread over a device mesh (the
reference's Kafka-partition axis), one long document's slots split over
shards, and the document lanes of many hosts."""
from .distributed import (
    DistributedConfig,
    ensure_initialized,
    local_doc_slice,
    make_global_mesh,
)
from .mesh import (
    DOC_AXIS,
    DeviceMesh,
    global_window_floor,
    make_mesh,
    shard_table,
)
from .mesh_pool import MeshShardedPool, apply_window_mesh_sharded
from .seq_shard import (
    SEQ_AXIS,
    apply_window_seq_sharded,
    make_seq_mesh,
    seq_prims,
)

__all__ = [
    "DOC_AXIS",
    "DeviceMesh",
    "DistributedConfig",
    "MeshShardedPool",
    "SEQ_AXIS",
    "apply_window_mesh_sharded",
    "apply_window_seq_sharded",
    "ensure_initialized",
    "global_window_floor",
    "local_doc_slice",
    "make_global_mesh",
    "make_mesh",
    "make_seq_mesh",
    "seq_prims",
    "shard_table",
]
