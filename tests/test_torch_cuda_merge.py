"""The host side of the Hopper window kernel's build that runs without a
card: reading the ``ptxas -v`` report, and the candidate sources that
``tools/window_candidates.py`` builds from the committed kernel."""
import pytest

from fluidframework_tpu_torch.ops import cuda_merge
from fluidframework_tpu_torch.tools import window_candidates

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119merge_window_kernelILi8ELb0EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119merge_window_kernelILi8ELb0EEEvNS_6ParamsE
    200 bytes stack frame, 784 bytes spill stores, 692 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 200 bytes cumulative stack size, 448 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119merge_window_kernelILi1ELb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119merge_window_kernelILi1ELb1EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 448 bytes smem
"""


# the instantiations since the cluster form replaced the device-memory
# one, as nvcc names them (an anonymous namespace keyed by the file)
PTXAS_CLUSTER_LOG = """\
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__d5bb6679_15_merge_window_cu_61fd491b27merge_window_cluster_kernelILi8ELi1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__d5bb6679_15_merge_window_cu_61fd491b27merge_window_cluster_kernelILi8ELi1EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 3376 bytes smem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__d5bb6679_15_merge_window_cu_61fd491b19merge_window_kernelILi4EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__d5bb6679_15_merge_window_cu_61fd491b19merge_window_kernelILi4EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 99 registers, used 1 barriers, 448 bytes smem
"""


def test_ptxas_report_reads_each_instantiation():
    assert cuda_merge.ptxas_report(PTXAS_LOG) == [
        {"q": 8, "smem": False, "cluster": 1, "registers": 255,
         "spill_stores": 784, "spill_loads": 692},
        {"q": 1, "smem": True, "cluster": 1, "registers": 80,
         "spill_stores": 0, "spill_loads": 0},
    ]
    assert cuda_merge.ptxas_report(PTXAS_CLUSTER_LOG) == [
        {"q": 1, "smem": True, "cluster": 8, "registers": 80,
         "spill_stores": 0, "spill_loads": 0},
        {"q": 4, "smem": True, "cluster": 1, "registers": 99,
         "spill_stores": 0, "spill_loads": 0},
    ]
    assert [cuda_merge.describe(k) for k in cuda_merge.ptxas_report(
        PTXAS_CLUSTER_LOG + PTXAS_LOG)][::2] == [
        "merge_window_cluster_kernel<CL=8, Q=1> (state in distributed "
        "shared memory, 4 slots per thread): 80 registers, spill stores "
        "0 B, spill loads 0 B",
        "merge_window_kernel<Q=8> (state in device memory, 32 slots per "
        "thread): 255 registers, spill stores 784 B, spill loads 692 B"]
    assert cuda_merge.ptxas_report("") == []


def test_cluster_span_follows_the_kernel_source():
    """The binding's copy of the constants that place a document's slots
    equals the source's, and each span covers its capacity in whole
    warps' runs of the cluster form."""
    text = cuda_merge.SOURCE.read_text()
    for name in ("THREADS", "MAX_CAPACITY", "CLUSTER"):
        assert f"constexpr int {name} = {getattr(cuda_merge, name)};" in text
    assert [cuda_merge.cluster_span(c) for c in (4097, 5001, 8192)] == [
        640, 640, 1024]
    for cluster in (2, 4, 8):
        run = 4 * cuda_merge.MAX_CAPACITY // (
            cuda_merge.THREADS * cluster * 4)
        for cap in (4097, 5001, 6144, 8191, 8192):
            span = cuda_merge.cluster_span(cap, cluster)
            assert span * cluster >= cap and span % (32 * run) == 0
            assert span // run <= cuda_merge.THREADS


def test_candidate_source_replaces_tuning_constants():
    committed = cuda_merge.SOURCE.read_text()
    assert window_candidates._source("") == committed
    text = window_candidates._source("THREADS=128,MAIN_MIN_BLOCKS=4")
    assert "constexpr int THREADS = 128;" in text
    assert "constexpr int MAIN_MIN_BLOCKS = 4;" in text
    assert "constexpr int THREADS = 256;" in committed
    with pytest.raises(ValueError, match="NO_SUCH"):
        window_candidates._source("NO_SUCH=1")
