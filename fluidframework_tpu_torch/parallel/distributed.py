"""Across hosts: the document lanes of many processes.

The reference's layout policy carries over: the DOCUMENT axis crosses
hosts (document lanes are independent, so they exchange nothing, as two
Kafka partitions never talk), and the SEQUENCE axis stays inside a host,
where its collectives run every step. In the port one process drives
every device of its host as one ``DeviceMesh`` (``make_global_mesh``
lays them out as (docs, seq) lanes); ``torch.distributed`` joins the
processes only for what spans hosts, and ``local_doc_slice`` gives each
rank its documents.

Single-process use (tests, one card, local development) is the default:
``ensure_initialized`` does nothing unless a coordinator and more than
one process are configured.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .mesh import DeviceMesh
from .seq_shard import make_seq_mesh


@dataclass
class DistributedConfig:
    """Read from the environment or passed explicitly. No
    ``coordinator`` means single-process mode."""

    coordinator: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        return cls(
            coordinator=os.environ.get("FFTPU_COORDINATOR") or None,
            num_processes=int(os.environ.get("FFTPU_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("FFTPU_PROCESS_ID", "0")),
        )


def ensure_initialized(config: Optional[DistributedConfig] = None,
                       device: str = "cuda") -> bool:
    """Join the process group if (and only if) a multi-process topology
    is configured: NCCL for CUDA devices, gloo for the CPU. Returns True
    when running multi-process. Idempotent."""
    cfg = config or DistributedConfig.from_env()
    if cfg.coordinator is None or cfg.num_processes <= 1:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    address = cfg.coordinator
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(
        backend="nccl" if torch.device(device).type == "cuda" else "gloo",
        init_method=address, world_size=cfg.num_processes,
        rank=cfg.process_id)
    return True


def _world() -> tuple[int, int]:
    """(process count, this process's rank)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_global_mesh(doc_shards: int = 1,
                     devices: Optional[Sequence] = None) -> DeviceMesh:
    """This process's devices (default: its CUDA devices) as a (docs,
    seq) mesh of ``doc_shards`` lanes, each lane sequence-sharded over
    the rest. Every process drives its own host's mesh; the doc axis
    spans hosts through ``local_doc_slice``."""
    return make_seq_mesh(devices, doc_shards)


def local_doc_slice(n_docs: int) -> slice:
    """The contiguous slice of the global document batch this process
    owns under the one-lane-per-host layout."""
    procs, rank = _world()
    per = -(-n_docs // procs)  # ceil
    return slice(rank * per, min(n_docs, (rank + 1) * per))
