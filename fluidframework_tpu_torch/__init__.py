"""PyTorch + CUDA port of fluidframework_tpu, for NVIDIA Hopper.

The SharedString merge plane: encode and pack sequenced ops
(``ops.host_bridge``), apply a window to the ``[docs, capacity]``
segment table with the hand-written Hopper kernel (``ops.cuda_merge``,
plain torch twin in ``ops.merge_step``) or a macro-step route
(``ops.merge_chunk``, ``ops.event_graph``), settle and recover
(``service.gpu_sidecar.GpuMergeSidecar``), and read text back.

The SharedTree plane: encode sequenced changesets as atoms
(``ops.tree_atoms``), rebase them over the device trunk ring
(``ops.tree_kernel``) and apply them to the ``[docs, slots]`` forest
table on the ``atom`` or ``macro`` route (``ops.tree_apply``), served by
``service.tree_sidecar.TreeSidecar`` and held against the scalar
``EditManager`` (``models.tree``).

The pool tiers and sharding: past the slab ladder's top a document
moves to a pool on a ``parallel.DeviceMesh`` of torch devices, driven by
one process (``service.gpu_sidecar.select_pool``): the doc-sharded
``parallel.mesh_pool.MeshShardedPool`` (one window kernel launch per
shard, live migration of hot documents) or the sequence-sharded
``service.gpu_sidecar.SeqShardedPool`` (one document's slots split over
shards, the plain step with cross-shard collectives in threads,
``parallel.seq_shard``).

The package imports torch, numpy and the standard library only.
"""
