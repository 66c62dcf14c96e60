"""Service plane of the port: the sequencer (deli), the lambda pipeline,
the in-process orderer and local server, the GPU merge sidecar, the tree
sidecar and its pooled tier, and the channel-kind router."""
from .gpu_sidecar import GpuMergeSidecar
from .lambdas import (
    BroadcasterLambda,
    CopierLambda,
    OpLog,
    ScribeLambda,
    ScriptoriumLambda,
    SummaryStore,
)
from .local_orderer import LocalOrderer
from .local_server import DeltaConnection, LocalServer
from .sequencer import DocumentSequencer, TicketResult
from .tree_sidecar import ChannelKindRouter, TreeSeqPool, TreeSidecar

__all__ = [
    "BroadcasterLambda",
    "ChannelKindRouter",
    "CopierLambda",
    "DeltaConnection",
    "DocumentSequencer",
    "GpuMergeSidecar",
    "LocalOrderer",
    "LocalServer",
    "OpLog",
    "ScribeLambda",
    "ScriptoriumLambda",
    "SummaryStore",
    "TicketResult",
    "TreeSeqPool",
    "TreeSidecar",
]
