"""Service plane of the port: the networked ingress (alfred) and its
tenancy, the sequencer (deli), the lambda pipeline, the in-process
orderer and local server, the GPU merge sidecar, the tree sidecar and
its pooled tier, and the channel-kind router."""
from .gpu_sidecar import GpuMergeSidecar
from .ingress import AlfredServer
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
from .tenancy import AuthError, Tenant, TenantManager, sign_token
from .tree_sidecar import ChannelKindRouter, TreeSeqPool, TreeSidecar

__all__ = [
    "AlfredServer",
    "AuthError",
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
    "Tenant",
    "TenantManager",
    "TicketResult",
    "TreeSeqPool",
    "TreeSidecar",
    "sign_token",
]
