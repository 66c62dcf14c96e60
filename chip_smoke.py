"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the Hopper window kernel from the sources in this checkout, holds
it bit for bit against its plain torch version on the card, drives the
SharedString merge plane end to end through ``GpuMergeSidecar`` at the
full width of bench config2 (4096 documents x capacity 1024, 4 clients
x 220 steps of seeded traffic) and checks every distinct stream against
the scalar ``MergeTreeClient`` oracle, runs the grow/evict recovery
tiers at a small size, and times the kernel beside its plain version.

The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the kernel
record. Every phase runs on every call; any failure exits non-zero
without those lines, as does a machine with no CUDA device or a
directory without the port package. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# INT32 rate of the CUDA cores (132 SMs x 64 INT32 lanes x 1.98 GHz
# boost) — the window kernel's work is int32 compares, selects and adds.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

MAIN_DOCS, MAIN_CAPACITY = 4096, 1024
KERNEL_SHAPES = [  # (docs, capacity, window)
    (5, 16, 16),          # count near C: the overflow flag
    (64, 128, 64),
    (1000, 1024, 64),
    (64, 4096, 64),       # edge of the shared-memory variant
    (16, 8192, 32),       # device-memory variant
]


def log(*parts) -> None:
    print(*parts, flush=True)


# ----------------------------------------------------------------------
# seeded random state and op windows (kernel vs plain)

def random_table(rng, docs, cap, device):
    from fluidframework_tpu_torch.ops.segment_table import (
        NOT_REMOVED, PROP_CHANNELS, SegmentTable,
    )

    shape = (docs, cap)
    count = rng.integers(0, cap * 3 // 4 + 1, docs)
    count[: max(1, docs // 4)] = cap - rng.integers(0, 3, max(1, docs // 4))
    removed = rng.random(shape) < 0.3
    arrays = dict(
        length=rng.integers(1, 7, shape),
        seq=rng.integers(1, 50, shape),
        client=rng.integers(0, 32, shape),
        removed_seq=np.where(removed, rng.integers(1, 60, shape),
                             int(NOT_REMOVED)),
        removers=np.where(
            removed, rng.integers(-2**31, 2**31, shape, dtype=np.int64), 0),
        op_id=rng.integers(0, 100, shape),
        op_off=rng.integers(0, 1000, shape),
        is_marker=(rng.random(shape) < 0.1),
        prop=rng.integers(0, 4, (docs, cap, PROP_CHANNELS)),
        count=count,
        min_seq=rng.integers(0, 20, docs),
        overflow=np.zeros(docs),
    )
    return SegmentTable(**{
        f: torch.tensor(np.asarray(a).astype(np.int32), device=device)
        for f, a in arrays.items()
    })


def random_batch(rng, table, window, device):
    """Ops drawn around each document's current visible length, so
    inserts, boundary splits, out-of-range ranges and NOOPs all occur."""
    from fluidframework_tpu_torch.ops.segment_table import (
        KIND_INSERT, KIND_REMOVE, NOT_REMOVED, OpBatch,
    )

    docs = table.docs
    count = table.count.cpu().numpy()
    live = np.arange(table.capacity)[None, :] < count[:, None]
    alive = live & (table.removed_seq.cpu().numpy() == int(NOT_REMOVED))
    est = np.where(alive, table.length.cpu().numpy(), 0).sum(axis=1)
    seq = np.full(docs, 60)
    min_seq = table.min_seq.cpu().numpy().astype(np.int64)
    cols = {f: np.zeros((docs, window), np.int64) for f in OpBatch._fields}
    for w in range(window):
        seq += 1
        min_seq += rng.integers(0, 2, docs)
        kind = rng.choice(4, docs, p=[0.45, 0.25, 0.15, 0.15])
        pos1 = (rng.random(docs) * (est + 5)).astype(np.int64)
        pos2 = pos1 + rng.integers(1, 13, docs)
        length = rng.integers(1, 7, docs)
        cols["kind"][:, w] = kind
        cols["pos1"][:, w] = pos1
        cols["pos2"][:, w] = pos2
        cols["seq"][:, w] = seq
        cols["refseq"][:, w] = np.maximum(
            min_seq, seq - rng.integers(1, 16, docs))
        cols["client"][:, w] = rng.integers(0, 32, docs)
        cols["op_id"][:, w] = rng.integers(0, 100, docs)
        cols["length"][:, w] = length
        cols["is_marker"][:, w] = rng.random(docs) < 0.1
        cols["prop_key"][:, w] = rng.integers(0, 4, docs)
        cols["prop_val"][:, w] = rng.integers(0, 5, docs)
        cols["min_seq"][:, w] = min_seq
        est = np.where((kind == KIND_INSERT) & (pos1 <= est), est + length,
                       est)
        cut = np.clip(np.minimum(pos2, est) - pos1, 0, None)
        est = np.where(kind == KIND_REMOVE, est - cut, est)
    return OpBatch(**{
        f: torch.tensor(a.astype(np.int32), device=device)
        for f, a in cols.items()
    })


def max_abs_err(a, b) -> int:
    return max(
        int((x.long() - y.long()).abs().max()) if x.numel() else 0
        for x, y in zip(a, b)
    )


def phase_kernel(seed: int) -> int:
    from fluidframework_tpu_torch.ops.merge_kernel import (
        apply_window, apply_window_plain,
    )

    rng = np.random.default_rng(seed)
    worst = 0
    for docs, cap, window in KERNEL_SHAPES:
        table = random_table(rng, docs, cap, "cuda")
        overflows = 0
        for _ in range(2):  # two chained windows
            batch = random_batch(rng, table, window, "cuda")
            got = apply_window(table, batch)
            want = apply_window_plain(table, batch)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            worst = max(worst, err)
            bad = [f for f, x, y in zip(want._fields, got, want)
                   if not torch.equal(x, y)]
            if bad:
                raise AssertionError(
                    f"kernel != plain at D={docs} C={cap} W={window}: "
                    f"fields {bad}, max abs err {err}")
            overflows += int(want.overflow.sum())
            table = want
        log(f"kernel == plain  D={docs} C={cap} W={window}  "
            f"(2 windows, all fields bit-exact, overflowed docs "
            f"{overflows})")
        if (docs, cap) == (5, 16) and overflows == 0:
            raise AssertionError("the overflow case did not overflow")
    return worst


# ----------------------------------------------------------------------
# main path: GpuMergeSidecar at bench config2's full width

def _wrap(stream):
    """Raw merge-op messages -> the runtime envelope the sidecar reads
    (datastore "d", channel "s")."""
    from fluidframework_tpu_torch.protocol.messages import MessageType

    out = []
    for msg in stream:
        if msg.type == MessageType.OPERATION:
            msg = dataclasses.replace(msg, contents={
                "kind": "op", "address": "d", "channel": "s",
                "contents": msg.contents,
            })
        out.append(msg)
    return out


def _oracle(stream):
    from fluidframework_tpu_torch.models.mergetree import MergeTreeClient
    from fluidframework_tpu_torch.ops.host_bridge import (
        DocStream, interned_signature,
    )

    obs = MergeTreeClient("oracle")
    obs.start_collaboration("oracle")
    # interns as the sidecar's stream does: encoding stops at the first
    # message the tensors cannot express (the sidecar evicts there)
    enc = DocStream()
    expressible = True
    for msg in stream:
        obs.apply_msg(msg)
        if expressible:
            try:
                enc.add_message(msg)
            except ValueError:
                expressible = False
    return obs.get_text(), interned_signature(obs, enc)


def _check_docs(sidecar, docs_streams) -> None:
    for doc, stream in docs_streams:
        text, sig = _oracle(stream)
        got_text = sidecar.text(doc, "d", "s")
        if got_text != text:
            raise AssertionError(f"{doc}: text differs from the oracle")
        if sidecar.signature(doc, "d", "s") != sig:
            raise AssertionError(f"{doc}: signature differs from the oracle")


def phase_main(seed: int) -> dict:
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.service import GpuMergeSidecar
    from fluidframework_tpu_torch.testing import FuzzConfig, record_op_stream

    n_distinct = 16
    raw = []
    for i in range(n_distinct):
        _, stream = record_op_stream(FuzzConfig(
            n_clients=4, n_steps=220, seed=seed * 1000 + i))
        raw.append(stream)
    wrapped = [_wrap(s) for s in raw]
    sidecar = GpuMergeSidecar(max_docs=MAIN_DOCS, capacity=MAIN_CAPACITY,
                              device="cuda")
    doc_ids = [f"doc-{d}" for d in range(MAIN_DOCS)]
    for doc in doc_ids:
        sidecar.track(doc, "d", "s")

    cuda_merge.LAUNCHES = 0
    torch.cuda.synchronize()
    # device activity only: the trace gives the device-busy time of the
    # run (kernels and copies, one stream), no host op events
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        longest = max(len(s) for s in wrapped)
        chunks = (16, 32, 48)  # ~32 per round; windows on the 16/32/64 rungs
        start, rounds, real = 0, 0, 0
        ingest_s = 0.0
        while start < longest:
            stop = start + chunks[rounds % len(chunks)]
            t_in = time.perf_counter()
            for d, doc in enumerate(doc_ids):
                for msg in wrapped[d % n_distinct][start:stop]:
                    sidecar.ingest(doc, msg)
            ingest_s += time.perf_counter() - t_in
            real += sidecar.apply()
            rounds += 1
            start = stop
        sidecar.sync()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = cuda_merge.LAUNCHES
    busy = _device_busy_ms(prof)

    _check_docs(sidecar, [(doc_ids[i], raw[i]) for i in range(n_distinct)])
    if sidecar.host_mode_docs() or sidecar.overflowed():
        raise AssertionError("main path left the device path")
    if launches <= 0:
        raise AssertionError("main path never launched the window kernel")
    log(f"main path: {MAIN_DOCS} docs x capacity {MAIN_CAPACITY}, "
        f"{rounds} rounds, {real} real ops, wall {wall:.3f} s "
        f"(ingest {ingest_s:.3f} s, pack {sidecar.stats['pack_s']:.3f} s, "
        f"settle {sidecar.stats['settle_s']:.3f} s), "
        f"{real / wall:.1f} ops/s, launches {launches}, grows "
        f"{sidecar.grow_count}; {n_distinct} streams == oracle")
    if busy["total"] > 0:
        log(f"main path device trace: busy {busy['total']:.3f} ms of wall "
            f"{wall * 1e3:.3f} ms, idle share "
            f"{1 - busy['total'] / (wall * 1e3):.6f}; by name "
            + ", ".join(f"{n} {ms:.3f} ms" for n, ms in busy["top"]))
    else:
        log("main path device trace: no device time recorded "
            "(idle share not measured)")
    return {"launches": launches, "rounds": rounds, "real_ops": real,
            "wall_s": wall}


def _device_busy_ms(prof) -> dict:
    """Device time of a CUDA-only profiler trace: the total, and the five
    largest event names (kernels and copies)."""
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"total": sum(by_name.values()),
            "top": [(n[:60], ms) for n, ms in top]}


# ----------------------------------------------------------------------
# recovery: grow ladder and host eviction at a small size

def phase_recovery(seed: int) -> None:
    from fluidframework_tpu_torch.service import GpuMergeSidecar
    from fluidframework_tpu_torch.testing import (
        FuzzConfig, MockCollabSession, record_op_stream,
    )

    streams = []
    for i, steps in enumerate((220, 60, 25)):
        _, s = record_op_stream(FuzzConfig(
            n_clients=3, n_steps=steps, seed=seed * 77 + i,
            insert_weight=0.7, remove_weight=0.15))
        streams.append(s)
    props_log: list = []
    session = MockCollabSession(["w"], stream_log=props_log)
    session.do("w", "insert_text_local", 0, "hello world")
    for i, key in enumerate(["k1", "k2", "k3", "k4", "k5"]):
        session.do("w", "annotate_range_local", 0, 5, {key: i + 1})
    session.process_all()
    streams.append(props_log)

    sidecar = GpuMergeSidecar(max_docs=4, capacity=16, max_capacity=64,
                              device="cuda")
    docs = [f"r-{i}" for i in range(len(streams))]
    wrapped = [_wrap(s) for s in streams]
    for doc in docs:
        sidecar.track(doc, "d", "s")
    longest = max(len(s) for s in wrapped)
    for start in range(0, longest, 40):
        for doc, s in zip(docs, wrapped):
            for msg in s[start:start + 40]:
                sidecar.ingest(doc, msg)
        sidecar.apply()
    sidecar.sync()
    _check_docs(sidecar, list(zip(docs, streams)))
    if sidecar.grow_count < 1 or sidecar.evict_count < 2:
        raise AssertionError(
            f"recovery did not grow and evict (grows {sidecar.grow_count}, "
            f"evictions {sidecar.evict_count})")
    log(f"recovery: capacity 16 -> {sidecar.capacity}, grows "
        f"{sidecar.grow_count}, evictions {sidecar.evict_count} (one at "
        f"ingest: 5 property keys), host docs {sidecar.host_mode_docs()}; "
        f"all {len(docs)} docs == oracle")


# ----------------------------------------------------------------------
# times at the main path's shape

def step_ops_per_slot() -> int:
    """int32 ALU operations per slot of one fused_step, counted by running
    the plain version once on a tiny CPU input under a dispatch counter.

    An op counts once when it reads or writes one element per slot (the
    min-reduces of the 12 lookups count by what they read). Not counted:
    views (expand, slice), the zero-fill pads and the dtype casts, which
    are data movement the kernel does as addressing. The plain version
    shifts each field by 1 or 2 slots with two nested selects; the
    kernel does it with one indexed load per field (src = j - m), so the
    two count as one select per field."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from fluidframework_tpu_torch.ops.merge_step import (
        fused_step, table_to_state,
    )
    from fluidframework_tpu_torch.ops.segment_table import make_table

    aten = torch.ops.aten
    movement = {aten.constant_pad_nd.default, aten._to_copy.default}
    D, C = 3, 8
    st = table_to_state(make_table(D, C, "cpu"))
    op = {f: torch.zeros((D, 1), dtype=torch.int32) for f in (
        "kind", "pos1", "pos2", "seq", "refseq", "client", "op_id",
        "length", "is_marker", "prop_key", "prop_val", "min_seq")}

    class Count(TorchDispatchMode):
        ops = 0
        shift_selects = 0
        pads: list = []  # kept alive so their storages stay distinct

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten.constant_pad_nd.default:
                Count.pads.append(out)
            if func.is_view or func in movement:
                return out
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            if isinstance(out, torch.Tensor):
                tensors.append(out)
            if not any(t.numel() >= D * C for t in tensors):
                return out
            shifted = {p.untyped_storage().data_ptr() for p in Count.pads}
            if func is aten.where.self and any(
                    t.untyped_storage().data_ptr() in shifted
                    for t in tensors[1:3]):
                Count.shift_selects += 1
            else:
                Count.ops += 1
            return out

    with Count():
        fused_step(st, op)
    return Count.ops + Count.shift_selects // 2


def _time_ms(fn, reps: int) -> list:
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def phase_time(seed: int) -> dict:
    from fluidframework_tpu_torch.ops.merge_kernel import (
        apply_window, apply_window_plain,
    )

    rng = np.random.default_rng(seed + 1)
    D, C, W = MAIN_DOCS, MAIN_CAPACITY, 64
    table = random_table(rng, D, C, "cuda")
    batch = random_batch(rng, table, W, "cuda")
    got = apply_window(table, batch)
    want = apply_window_plain(table, batch)
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"kernel != plain at the main shape ({err})")
    for _ in range(2):
        apply_window(table, batch)
    kernel = _time_ms(lambda: apply_window(table, batch), 7)
    plain = _time_ms(lambda: apply_window_plain(table, batch), 5)
    ops_per_slot = step_ops_per_slot()
    state_bytes = D * (12 * C + 3) * 4
    op_bytes = 12 * D * W * 4
    nbytes = 2 * state_bytes + op_bytes
    nops = D * C * W * ops_per_slot
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / INT32_OPS_PER_S * 1e3
    rec = {
        "ms": statistics.median(kernel),
        "plain_ms": statistics.median(plain),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": err,
    }
    log(f"times at D={D} C={C} W={W}: kernel median {rec['ms']:.4f} ms "
        f"(runs {[round(t, 4) for t in kernel]}), plain version median "
        f"{rec['plain_ms']:.4f} ms (the plain torch loop, not a "
        f"yardstick); bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
        f"(bytes {nbytes} -> {bytes_ms:.4f} ms, int32 ops {nops} = "
        f"{ops_per_slot}/slot-step -> {ops_ms:.4f} ms)")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device")
        return 2
    try:
        from fluidframework_tpu_torch.ops import cuda_merge
    except ImportError as e:
        log(f"FAIL: the port package is missing ({e})")
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    try:
        build_s = cuda_merge.prewarm()
        log(f"kernel build + load: {build_s:.2f} s")
        if cuda_merge.BUILD_LOG:
            for line in cuda_merge.BUILD_LOG.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")
        worst = phase_kernel(args.seed)
        main_rec = phase_main(args.seed)
        phase_recovery(args.seed)
        time_rec = phase_time(args.seed)
        worst = max(worst, time_rec.pop("max_abs_err"))
    except Exception:  # noqa: BLE001 - report any failed phase, exit 1
        traceback.print_exc()
        log("FAIL")
        return 1
    log(json.dumps({"kernels": [{
        "name": "merge_window",
        "route": "cuda",
        "source": "fluidframework_tpu_torch/ops/csrc/merge_window.cu",
        "replaces": "fluidframework_tpu/ops/pallas_merge.py:58",
        "launches": main_rec["launches"],
        "max_abs_err": worst,
        "ms": time_rec["ms"],
        "plain_ms": time_rec["plain_ms"],
        "bound_ms": time_rec["bound_ms"],
        "bound_by": time_rec["bound_by"],
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
