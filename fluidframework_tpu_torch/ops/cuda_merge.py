"""Build, binding and launch of the Hopper window kernel
(``csrc/merge_window.cu``), the counterpart of the reference's Pallas
kernel ``ops/pallas_merge.py::_kernel``.

The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, into ``_build/`` beside the
package (keyed by a hash of the source and the flags), and loaded with
``ctypes``. Nothing is built or loaded when this module is imported.

``apply_window_cuda`` launches the kernel on the current CUDA stream or
raises; it never falls back to the plain version. ``LAUNCHES`` counts
the launches this process made, ``BUILDS`` the ``nvcc`` builds per
library (source hash).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .merge_kernel import check_capacity
from .segment_table import PROP_CHANNELS, OpBatch, SegmentTable, check_donated

SOURCE = Path(__file__).resolve().parent / "csrc" / "merge_window.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches of the kernel made by apply_window_cuda in this process
LAUNCHES = 0
# nvcc builds this process made, per library file (named by the hash of
# the source and the flags): at most one each
BUILDS: dict[str, int] = {}

_lock = threading.Lock()
_lib = None
# ptxas report (registers, shared memory, spills) of the build that this
# process made, or "" when the library was already built
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the merge window kernel cannot be "
                       "built (needs the CUDA toolkit)")


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"merge_window-{digest}.so"


def compile_source(source: Path, out: Path) -> str:
    """Compile ``source`` into the shared library ``out`` with
    ``NVCC_FLAGS``; returns nvcc's output (the ptxas report)."""
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source.name}:\n"
            f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the kernel library if this source has not been built
    yet; returns its path."""
    global BUILD_LOG
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    log = compile_source(SOURCE, tmp)
    os.replace(tmp, path)  # atomic: a concurrent build sees all or none
    BUILD_LOG = log
    BUILDS[path.name] = BUILDS.get(path.name, 0) + 1
    return path


def ptxas_report(log: str) -> list:
    """Registers and spills of each kernel instantiation in a ``ptxas
    -v`` log: dicts with ``q`` (4*q slots per thread), ``smem`` (the slot
    state in shared memory), ``cluster`` (CTAs per document: 1, or CL of
    ``merge_window_cluster_kernel<CL, Q>``), ``registers``,
    ``spill_stores`` and ``spill_loads`` (bytes). Also reads the names of
    the earlier ``merge_window_kernel<Q, SMEM>``."""
    out, name, spills = [], "", (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kernel = re.search(
                r"merge_window_(cluster_)?kernelI((?:L[a-z]\d+E)+)E", name)
            args = [int(v) for v in re.findall(
                r"L[a-z](\d+)E", kernel.group(2))] if kernel else []
            q = smem = cluster = None
            if kernel and kernel.group(1):
                cluster, q, smem = args[0], args[1], True
            elif kernel:
                q, smem, cluster = args[0], args[1:] != [0], 1
            out.append({
                "q": q, "smem": smem, "cluster": cluster,
                "registers": int(m.group(1)),
                "spill_stores": spills[0],
                "spill_loads": spills[1],
            })
    return out


def describe(k: dict) -> str:
    """One instantiation of a ``ptxas_report`` in words."""
    if k["cluster"] and k["cluster"] > 1:
        form = (f"merge_window_cluster_kernel<CL={k['cluster']}, "
                f"Q={k['q']}> (state in distributed shared memory")
    else:
        where = "shared memory" if k["smem"] else "device memory"
        form = f"merge_window_kernel<Q={k['q']}> (state in {where}"
    return (f"{form}, {4 * k['q']} slots per thread): {k['registers']} "
            f"registers, spill stores {k['spill_stores']} B, spill loads "
            f"{k['spill_loads']} B")


# the kernel's constants (csrc/merge_window.cu) that place the slots of
# a document of the cluster form (capacity above 4096) on its CTAs
THREADS, MAX_CAPACITY, CLUSTER = 256, 8192, 8


def cluster_span(capacity: int, cluster: int = CLUSTER) -> int:
    """Slots each CTA of the cluster form holds at ``capacity``
    (``cluster_span`` in the source): ceil(capacity / cluster) rounded
    up to whole warps' runs."""
    unit = 32 * MAX_CAPACITY // (THREADS * cluster)  # a warp's runs
    per_cta = -(-capacity // cluster)
    return -(-per_cta // unit) * unit


def bind(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    lib.merge_window_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.merge_window_launch.restype = ctypes.c_int
    # absent from the kernels before the cluster form (tools that time
    # an earlier source bind it too)
    shape = getattr(lib, "merge_window_cluster_shape", None)
    if shape is not None:
        shape.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        shape.restype = ctypes.c_int
    lib.merge_window_error_string.argtypes = [ctypes.c_int]
    lib.merge_window_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def prewarm() -> float:
    """Build (if needed) and load the kernel library; returns the
    seconds it took."""
    t0 = time.perf_counter()
    load_library()
    return time.perf_counter() - t0


def cluster_shape(capacity: int, device=None) -> dict:
    """The cluster form's shape at ``capacity`` (4096 < capacity <= 8192)
    on ``device`` (default: the current CUDA device): CTAs per document,
    slots and threads per CTA, and the clusters that can be resident at
    once (``cudaOccupancyMaxActiveClusters``)."""
    lib = load_library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = lib.merge_window_cluster_shape(capacity, out)
    if rc != 0:
        what = ("bad arguments" if rc < 0
                else lib.merge_window_error_string(rc).decode())
        raise RuntimeError(f"merge_window cluster shape at capacity "
                           f"{capacity} ({rc}): {what}")
    return dict(zip(("cluster", "span", "threads", "max_active_clusters"),
                    out))


def _check(name: str, t: torch.Tensor, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected int32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def apply_window_cuda(table: SegmentTable, batch: OpBatch,
                      out: SegmentTable | None = None) -> SegmentTable:
    """Launch the window kernel: apply ``batch`` to ``table`` into
    ``out`` (a donated table of the same shape, written and never read)
    or, by default, a freshly allocated output table; the input stays
    untouched. Returns at enqueue; raises on any input the kernel does
    not take, on an ``out`` that shares storage with an input, or on a
    refused launch."""
    global LAUNCHES
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"the window kernel needs a CUDA table, got "
                         f"{device}")
    D, C = table.docs, table.capacity
    W = batch.kind.shape[-1] if batch.kind.dim() == 2 else -1
    check_capacity(C)
    if D == 0:
        raise ValueError("the window kernel needs at least one document")
    for f in SegmentTable._fields:
        shape = {"prop": (D, C, PROP_CHANNELS), "count": (D,),
                 "min_seq": (D,), "overflow": (D,)}.get(f, (D, C))
        _check(f"table.{f}", getattr(table, f), shape, device)
    for f in OpBatch._fields:
        _check(f"batch.{f}", getattr(batch, f), (D, W), device)
    if out is not None:
        for f in SegmentTable._fields:
            _check(f"out.{f}", getattr(out, f),
                   tuple(getattr(table, f).shape), device)
        check_donated(out, table, batch)
    out = launch(load_library(), table, batch, out)
    LAUNCHES += 1
    return out


def launch(lib: ctypes.CDLL, table: SegmentTable, batch: OpBatch,
           out: SegmentTable | None = None) -> SegmentTable:
    """Launch ``lib``'s kernel on inputs already checked, into ``out``
    (default: a fresh output table), on the current stream of the
    table's device; raises on a refused launch."""
    D, C, W = table.docs, table.capacity, batch.kind.shape[-1]
    if out is None:
        out = SegmentTable(*(torch.empty_like(t) for t in table))
    ptrs = (ctypes.c_void_p * 36)(
        *(t.data_ptr() for t in table),
        *(t.data_ptr() for t in out),
        *(t.data_ptr() for t in batch),
    )
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.merge_window_launch(ptrs, D, C, W, stream)
    if rc != 0:
        what = ("bad arguments" if rc == -1
                else lib.merge_window_error_string(rc).decode())
        raise RuntimeError(f"merge_window launch failed ({rc}): {what}")
    return out
