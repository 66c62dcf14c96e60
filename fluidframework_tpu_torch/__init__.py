"""PyTorch + CUDA port of fluidframework_tpu, for NVIDIA Hopper.

Slice 1 carries the SharedString merge plane: encode and pack sequenced
ops (``ops.host_bridge``), apply a window to the ``[docs, capacity]``
segment table with the hand-written Hopper kernel (``ops.cuda_merge``,
plain torch twin in ``ops.merge_step``), settle and recover
(``service.gpu_sidecar.GpuMergeSidecar``), and read text back. The
package imports torch, numpy and the standard library only.
"""
