"""Service plane of the port: the networked ingress (alfred) and its
tenancy, the sequencer (deli), the lambda pipeline, the in-process
orderer and local server, the partitioned ordering service and its
networked broker, the replicated sequencer, the GPU merge sidecar, the
tree sidecar and its pooled tier, and the channel-kind router."""
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
from .partitioning import (
    CheckpointManager,
    FileOrderingQueue,
    InMemoryOrderingQueue,
    OrderingQueue,
    Partition,
    PartitionedOrderingService,
    partition_for,
)
from .sequencer import DocumentSequencer, TicketResult
from .tenancy import AuthError, Tenant, TenantManager, sign_token
from .tree_sidecar import ChannelKindRouter, TreeSeqPool, TreeSidecar

__all__ = [
    "AlfredServer",
    "AuthError",
    "BroadcasterLambda",
    "BrokerServer",
    "ChannelKindRouter",
    "CheckpointManager",
    "CopierLambda",
    "DeltaConnection",
    "DocumentSequencer",
    "FileOrderingQueue",
    "GpuMergeSidecar",
    "InMemoryOrderingQueue",
    "LocalOrderer",
    "LocalServer",
    "OpLog",
    "OrderingQueue",
    "Partition",
    "PartitionedOrderingService",
    "RemoteOrderingQueue",
    "ScribeLambda",
    "ScriptoriumLambda",
    "SummaryStore",
    "Tenant",
    "TenantManager",
    "TicketResult",
    "TreeSeqPool",
    "TreeSidecar",
    "partition_for",
    "sign_token",
]


def __getattr__(name):
    # lazy: `python -m fluidframework_tpu_torch.service.broker` runs the
    # broker CLI; an eager import here would pre-load the module and
    # trip runpy's double-import warning
    if name in ("BrokerServer", "RemoteOrderingQueue"):
        from . import broker

        return getattr(broker, name)
    # same lazy treatment: `python -m fluidframework_tpu_torch.service.moira`
    # runs the Materialized History CLI
    if name in ("MaterializedHistoryServer",
                "MaterializedHistoryClient", "MoiraLambda"):
        from . import moira

        return getattr(moira, name)
    raise AttributeError(name)
