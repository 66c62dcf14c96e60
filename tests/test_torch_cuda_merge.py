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


def test_ptxas_report_reads_each_instantiation():
    assert cuda_merge.ptxas_report(PTXAS_LOG) == [
        {"q": 8, "smem": False, "registers": 255, "spill_stores": 784,
         "spill_loads": 692},
        {"q": 1, "smem": True, "registers": 80, "spill_stores": 0,
         "spill_loads": 0},
    ]
    assert cuda_merge.ptxas_report("") == []


def test_candidate_source_replaces_tuning_constants():
    committed = cuda_merge.SOURCE.read_text()
    assert window_candidates._source("") == committed
    text = window_candidates._source("THREADS=128,MAIN_MIN_BLOCKS=4")
    assert "constexpr int THREADS = 128;" in text
    assert "constexpr int MAIN_MIN_BLOCKS = 4;" in text
    assert "constexpr int THREADS = 256;" in committed
    with pytest.raises(ValueError, match="NO_SUCH"):
        window_candidates._source("NO_SUCH=1")
