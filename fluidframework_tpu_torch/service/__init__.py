"""Service plane of the port: the GPU merge sidecar and the sequencer
part the mock session drives."""
from .gpu_sidecar import GpuMergeSidecar

__all__ = ["GpuMergeSidecar"]
