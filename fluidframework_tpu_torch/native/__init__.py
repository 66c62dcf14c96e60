"""Native runtime components (C++ via ctypes).

The service plane's host hot loops live here: the deli ticket loop
(``sequencer.cpp``, SURVEY §3.1 marks it one of the three hot loops)
and the scalar merge replayer (``merge_replay.cpp``), the compiled
baseline and host serving tier beside the device kernel. Each shared
library is built at first use with ``g++`` into the git-ignored
``_build/`` beside the package, keyed by a hash of its source and the
flags (as ``ops/cuda_merge.py`` builds the window kernel), and loaded
with ``ctypes``. Nothing is built or loaded when this module is
imported.

A loader returns ``None`` when the toolchain is missing or the build
fails, and the failure is sticky: ``g++`` runs at most once per library
and process. ``FFTPU_DISABLE_NATIVE=1`` makes both loaders return
``None``. Every native component keeps a pure-Python twin as both
fallback and differential oracle.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_SRC = _HERE / "sequencer.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path(src: Path) -> Path:
    """Where ``src``'s library is built: named by the hash of the
    source and the flags, so an edited source builds anew."""
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _compile(src: Path, out: Path) -> Optional[str]:
    """``g++`` build of ``src`` into ``out`` unless it is built already;
    returns an error string or None on success."""
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        return "g++ not found"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return proc.stderr[-2000:]
    os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    return None


def _load(src: Path) -> tuple[Optional[ctypes.CDLL], Optional[str]]:
    """Build (if needed) and load ``src``'s library: (lib, None) or
    (None, error)."""
    out = library_path(src)
    err = _compile(src, out)
    if err is not None:
        return None, err
    try:
        return ctypes.CDLL(str(out)), None
    except OSError as e:  # truncated/wrong-arch cached build
        return None, f"CDLL load failed: {e}"


def load_native_sequencer() -> Optional[ctypes.CDLL]:
    """Build (if needed) + load the native core; None when the
    toolchain is unavailable (callers fall back to Python)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None  # failure is sticky: don't re-run g++ per call
        if os.environ.get("FFTPU_DISABLE_NATIVE") == "1":
            return None
        lib, _build_error = _load(_SRC)
        if lib is None:
            return None
        i64, p_i64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        lib.seq_create.restype = ctypes.c_void_p
        lib.seq_create.argtypes = [i64, i64]
        lib.seq_destroy.argtypes = [ctypes.c_void_p]
        lib.seq_client_join.restype = i64
        lib.seq_client_join.argtypes = [ctypes.c_void_p, i64]
        lib.seq_client_leave.restype = i64
        lib.seq_client_leave.argtypes = [ctypes.c_void_p, i64]
        for fn in ("seq_sequence_number", "seq_minimum_sequence_number",
                   "seq_client_count", "seq_bump"):
            getattr(lib, fn).restype = i64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.seq_ticket_batch.restype = i64
        lib.seq_ticket_batch.argtypes = [
            ctypes.c_void_p, i64, p_i64, p_i64, p_i64,
            p_i64, p_i64, p_i32,
        ]
        lib.seq_ticket_multi.restype = i64
        lib.seq_ticket_multi.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), i64, p_i64,
            p_i64, p_i64, p_i64, p_i64, p_i64, p_i32,
        ]
        lib.seq_export_clients.restype = i64
        lib.seq_export_clients.argtypes = [
            ctypes.c_void_p, i64, p_i64, p_i64, p_i64,
        ]
        lib.seq_restore_client.argtypes = [ctypes.c_void_p, i64, i64, i64]
        _lib = lib
        return _lib


def native_build_error() -> Optional[str]:
    return _build_error


_REPLAY_SRC = _HERE / "merge_replay.cpp"
_replay_lib: Optional[ctypes.CDLL] = None
_replay_error: Optional[str] = None


def load_merge_replay() -> Optional[ctypes.CDLL]:
    """Build + load the C++ scalar merge replayer (the compiled
    baseline and the host serving tier); None when the toolchain is
    unavailable."""
    global _replay_lib, _replay_error
    with _lock:
        if _replay_lib is not None:
            return _replay_lib
        if _replay_error is not None:
            return None
        if os.environ.get("FFTPU_DISABLE_NATIVE") == "1":
            return None
        lib, _replay_error = _load(_REPLAY_SRC)
        if lib is None:
            return None
        i64 = ctypes.c_int64
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.merge_replay.restype = None
        lib.merge_replay.argtypes = [
            i32p, i64, i64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(i64),
        ]
        lib.merge_session_create.restype = ctypes.c_void_p
        lib.merge_session_create.argtypes = [i64]
        lib.merge_session_destroy.restype = None
        lib.merge_session_destroy.argtypes = [ctypes.c_void_p]
        lib.merge_session_apply.restype = None
        lib.merge_session_apply.argtypes = [
            ctypes.c_void_p, i32p, i32p, i64,
        ]
        lib.merge_session_stats.restype = None
        lib.merge_session_stats.argtypes = [
            ctypes.c_void_p, i64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(i64),
        ]
        lib.merge_session_segs.restype = i64
        lib.merge_session_segs.argtypes = [
            ctypes.c_void_p, i64, i32p, i64,
        ]
        _replay_lib = lib
        return _replay_lib


def merge_replay_error() -> Optional[str]:
    return _replay_error


from .sequencer_core import NativeSequencerCore  # noqa: E402

__all__ = [
    "NativeSequencerCore",
    "load_native_sequencer",
    "load_merge_replay",
    "merge_replay_error",
    "native_build_error",
]
