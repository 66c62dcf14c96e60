"""Service plane of the port: the GPU merge sidecar, the tree sidecar
and its pooled tier, the channel-kind router, and the sequencer part the
mock session drives."""
from .gpu_sidecar import GpuMergeSidecar
from .tree_sidecar import ChannelKindRouter, TreeSeqPool, TreeSidecar

__all__ = ["ChannelKindRouter", "GpuMergeSidecar", "TreeSeqPool",
           "TreeSidecar"]
