"""The reference's native libraries, loaded race-free by the port's
tests, and the pin of the build race that made that necessary.

The reference's loader (``fluidframework_tpu.native``) writes each
library in place with ``g++ -o``, trusts any file whose mtime is not
older than its source, and keeps its first failure for the whole
process. Under pytest-xdist several workers reach it at once on a
checkout with no ``.so``: a worker that opens a file another worker's
linker is still writing keeps ``CDLL load failed: ... file too short``,
and every reference-replayer case on that worker then fails or skips.

``reference_native()`` is what the port's tests call instead: under a
cross-process ``fcntl.flock`` it builds each library with the
reference's own command into a private name and ``os.replace``s it into
place, trusts only a file that it placed itself and that is not older
than its source (a stamp beside the lock records the inode, size and
mtime), clears the loader's sticky
error and loads again. The reference's own tests still build in place
without the lock; the linker unlinks its output before writing, so such
a writer swaps the inode under us, the stamp no longer matches, and the
next attempt rebuilds.
"""
import fcntl
import hashlib
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ATTEMPTS = 4


def _lock_path():
    return Path(tempfile.gettempdir()) / "fftpu-reference-native.lock"


def _stamp_path(lib):
    key = hashlib.sha1(str(lib).encode()).hexdigest()[:16]
    return Path(tempfile.gettempdir()) / f"fftpu-reference-native-{key}"


def _identity(lib):
    try:
        st = lib.stat()
    except FileNotFoundError:
        return None
    return f"{st.st_ino} {st.st_size} {st.st_mtime_ns}"


def _build_atomically(native, src, lib):
    """The reference's ``_compile`` (its own ``g++`` command) into a
    private name, then one rename into place; returns its error or
    None."""
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    try:
        err = native._compile(src, tmp)
        if err is None:
            os.replace(tmp, lib)
            _stamp_path(lib).write_text(_identity(lib))
        return err
    finally:
        tmp.unlink(missing_ok=True)


def _libraries(native):
    return (
        (native._SRC, native._LIB, "_lib", "_build_error",
         native.load_native_sequencer),
        (native._REPLAY_SRC, native._REPLAY_LIB, "_replay_lib",
         "_replay_error", native.load_merge_replay),
    )


def reference_native(package="fluidframework_tpu"):
    """Both of the reference's libraries loaded in this process (the
    sequencer core's and the merge replayer's); raises with the last
    error if either cannot be built."""
    native = importlib.import_module(f"{package}.native")
    loaded = []
    lock = _lock_path()
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        for src, lib, lib_attr, err_attr, load in _libraries(native):
            error = None
            for _ in range(ATTEMPTS):
                if getattr(native, lib_attr) is not None:
                    break
                stamp = _stamp_path(lib)
                if (not stamp.exists()
                        or stamp.read_text() != _identity(lib)
                        or lib.stat().st_mtime < src.stat().st_mtime):
                    error = _build_atomically(native, src, lib)
                    if error is not None:
                        continue
                with native._lock:
                    setattr(native, err_attr, None)
                if load() is None:
                    error = getattr(native, err_attr)
                    stamp.unlink(missing_ok=True)
            got = getattr(native, lib_attr)
            assert got is not None, f"{lib.name}: {error}"
            loaded.append(got)
    return tuple(loaded)


def _fresh_copy(root):
    """The reference package's git files under ``root``: no ``.so``."""
    shutil.copytree(REPO / "fluidframework_tpu", root / "fluidframework_tpu",
                    ignore=shutil.ignore_patterns("*.so", "__pycache__"))
    return root / "fluidframework_tpu" / "native"


# a child loads the copy's native module without the service package's
# ``__init__`` (the sequencer core imports ``service.sequencer``, and the
# package imports JAX): a child then starts in a fraction of a second,
# so the six contend for the build, not for the CPU
_CHILD = r"""
import sys, time, types
sys.path.insert(0, {tests!r})
import fluidframework_tpu
service = types.ModuleType("fluidframework_tpu.service")
service.__path__ = [{root!r} + "/fluidframework_tpu/service"]
sys.modules["fluidframework_tpu.service"] = service
import fluidframework_tpu.native as native
assert native.__file__.startswith({root!r}), native.__file__
assert "jax" not in sys.modules
start = float(sys.argv[1])
while time.time() < start:
    pass
if sys.argv[2] == "raw":
    native.load_merge_replay()
    print(native.merge_replay_error())
else:
    from test_torch_native_build import reference_native
    reference_native()
    print(native.merge_replay_error(), native.native_build_error())
"""


def _children(root, mode, n, tmpdir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", TMPDIR=str(tmpdir),
               PYTHONPATH=str(root))
    env.pop("FFTPU_DISABLE_NATIVE", None)
    env.pop("FFTPU_SANITIZE", None)
    child = _CHILD.format(tests=str(REPO / "tests"), root=str(root))
    start = str(time.time() + (3.0 if n > 1 else 0.0))
    procs = [subprocess.Popen([sys.executable, "-c", child, start, mode],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(n)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    return [o.strip().splitlines()[-1] for o, _ in outs]


def test_torn_build_sticks_in_the_reference_loader_and_the_helper_heals_it(
        tmp_path):
    """The race's mechanism, made deterministic: a fresh copy whose
    ``_merge_replay.so`` is a torn write (the first 32 bytes of a real
    build, newer than its source). The reference's loader trusts it and
    keeps ``file too short`` for the process; the helper in a second
    process of the same copy rebuilds it and loads both libraries."""
    native_dir = _fresh_copy(tmp_path)
    whole = tmp_path / "whole.so"
    native = importlib.import_module("fluidframework_tpu.native")
    assert native._compile(native._REPLAY_SRC, whole) is None
    (native_dir / "_merge_replay.so").write_bytes(whole.read_bytes()[:32])
    raw = _children(tmp_path, "raw", 1, tmp_path)
    assert "file too short" in raw[0], raw
    healed = _children(tmp_path, "helper", 1, tmp_path)
    assert healed == ["None None"], healed


def test_concurrent_fresh_builds_all_load(tmp_path):
    """Six processes on a fresh copy (no ``.so``) start together and
    each asks for the reference's libraries through the helper: every
    one loads both, and the files in place are whole."""
    native_dir = _fresh_copy(tmp_path)
    got = _children(tmp_path, "helper", 6, tmp_path)
    assert got == ["None None"] * 6, got
    assert sorted(p.name for p in native_dir.glob("*.so")) == [
        "_merge_replay.so", "_sequencer.so"]
    assert not list(native_dir.glob(".*.tmp"))


def test_helper_loads_the_checkouts_reference_libraries():
    """In this process too: both libraries load, and a second call
    returns the same handles."""
    first = reference_native()
    assert reference_native() == first and all(first)
