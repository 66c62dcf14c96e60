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
record. The times lines cover the window rungs 16 / 32 / 64 at the
main shape and the capacities 4096 and 8192, with the NOOP share of
each timed batch. Every phase runs on every call; any failure exits
non-zero without those lines, as does a machine with no CUDA device or a
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
    (4, 3, 8),            # a capacity below one quad of slots
    (7, 100, 16),         # ragged: C not a multiple of a thread's slots
    (64, 128, 64),
    (1000, 1024, 64),
    (128, 2048, 64),      # the first grow rung
    (64, 4096, 64),       # edge of the shared-memory variant
    (3, 5001, 16),        # ragged device-memory variant
    (16, 8192, 32),       # device-memory variant
]
NOOP_SHAPE = (64, 1024, 16)  # a window made only of NOOPs
TIME_WINDOWS = (16, 32, 64)  # the main path's window rungs
TIME_WIDE = ((1024, 4096), (512, 8192))  # (docs, capacity) at W = 64


def log(*parts) -> None:
    print(*parts, flush=True)


# ----------------------------------------------------------------------
# kernel vs plain on seeded random states and op windows

def max_abs_err(a, b) -> int:
    return max(
        int((x.long() - y.long()).abs().max()) if x.numel() else 0
        for x, y in zip(a, b)
    )


def _first_difference(got, want) -> str:
    """Field, document and slot of the first element where two tables
    differ, with both values."""
    for f, x, y in zip(want._fields, got, want):
        diff = (x != y).nonzero()
        if len(diff):
            at = tuple(int(i) for i in diff[0])
            return (f"first at {f}{list(at)}: kernel {int(x[at])}, plain "
                    f"{int(y[at])} ({len(diff)} elements differ)")
    return "none"


def _check_window(table, batch, what: str):
    """Kernel and plain version on the same inputs; returns the plain
    result and the max abs error, raises unless bit-exact."""
    from fluidframework_tpu_torch.ops.merge_kernel import (
        apply_window, apply_window_plain,
    )

    got = apply_window(table, batch)
    want = apply_window_plain(table, batch)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    bad = [f for f, x, y in zip(want._fields, got, want)
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(
            f"kernel != plain at {what}: fields {bad}, max abs err {err}; "
            + _first_difference(got, want))
    return want, err


def phase_kernel(seed: int) -> int:
    from fluidframework_tpu_torch.ops.segment_table import KIND_NOOP
    from fluidframework_tpu_torch.testing import windows

    rng = np.random.default_rng(seed)
    worst = 0
    for docs, cap, window in KERNEL_SHAPES:
        table = windows.random_table(rng, docs, cap, "cuda")
        overflows = 0
        for _ in range(2):  # two chained windows
            batch = windows.random_batch(rng, table, window, "cuda")
            want, err = _check_window(
                table, batch, f"D={docs} C={cap} W={window}")
            worst = max(worst, err)
            overflows += int(want.overflow.sum())
            table = want
        log(f"kernel == plain  D={docs} C={cap} W={window}  "
            f"(2 windows, all fields bit-exact, overflowed docs "
            f"{overflows})")
        if (docs, cap) == (5, 16) and overflows == 0:
            raise AssertionError("the overflow case did not overflow")

    docs, cap, window = NOOP_SHAPE
    table = windows.random_table(rng, docs, cap, "cuda")
    batch = windows.random_batch(rng, table, window, "cuda")
    batch.kind.fill_(KIND_NOOP)
    want, err = _check_window(
        table, batch, f"D={docs} C={cap} W={window} (NOOPs only)")
    worst = max(worst, err)
    moved = [f for f in table._fields
             if f != "min_seq" and not torch.equal(getattr(table, f),
                                                   getattr(want, f))]
    if moved:
        raise AssertionError(f"a NOOP window changed {moved}")
    if not torch.equal(want.min_seq, torch.maximum(
            table.min_seq, batch.min_seq.amax(dim=1))):
        raise AssertionError("a NOOP window did not advance min_seq")
    log(f"kernel == plain  D={docs} C={cap} W={window} NOOPs only  "
        f"(every slot bit-identical to the input, min_seq advanced)")
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


def _time_ms(fn, reps: int, launches: int = 1) -> list:
    """CUDA-event times of ``reps`` runs, each of ``launches`` calls
    enqueued back to back and divided by their number, so that the
    host's time to enqueue a call hides behind the device's work."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return times


def _real(kind):
    """Insert, remove and annotate ops (kinds 0..2); any other kind is a
    NOOP."""
    from fluidframework_tpu_torch.ops.segment_table import KIND_ANNOTATE

    return (kind >= 0) & (kind <= KIND_ANNOTATE)


def _noop_share(batch) -> float:
    return float(1.0 - _real(batch.kind).float().mean())


def _live_slot_steps(table, batch) -> int:
    """Slot-steps this window's data needs: for every insert, remove or
    annotate step, the document's live slots (``count``) at that step,
    from the plain loop's own counts. NOOP steps and slots at or above
    ``count`` do not enter a view."""
    from fluidframework_tpu_torch.ops.merge_step import (
        fused_step, table_to_state,
    )

    st = table_to_state(table)
    live = 0
    for w in range(batch.kind.shape[-1]):
        op = {f: getattr(batch, f)[:, w:w + 1] for f in batch._fields}
        live += int((st["count"].long() * _real(op["kind"])).sum())
        st = fused_step(st, op)
    return live


def phase_time(seed: int) -> dict:
    from fluidframework_tpu_torch.ops.merge_kernel import (
        apply_window, apply_window_plain,
    )
    from fluidframework_tpu_torch.testing import windows

    rng = np.random.default_rng(seed + 1)
    D, C, W = MAIN_DOCS, MAIN_CAPACITY, max(TIME_WINDOWS)
    table = windows.random_table(rng, D, C, "cuda")
    full = windows.random_batch(rng, table, W, "cuda")
    rec = {"max_abs_err": 0}
    for window in TIME_WINDOWS:
        batch = type(full)(*(t[:, :window].contiguous() for t in full))
        _, err = _check_window(table, batch, f"D={D} C={C} W={window}")
        for _ in range(2):
            apply_window(table, batch)
        kernel = _time_ms(lambda: apply_window(table, batch), 7, 10)
        log(f"times at D={D} C={C} W={window}: kernel median "
            f"{statistics.median(kernel):.4f} ms per launch (7 runs of 10 "
            f"back-to-back launches: "
            f"{[round(t, 4) for t in kernel]}), NOOP share of the batch "
            f"{_noop_share(batch):.4f}")
        rec["ms"] = statistics.median(kernel)  # the last: W = 64
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    batch = full
    plain = _time_ms(lambda: apply_window_plain(table, batch), 5)
    ops_per_slot = step_ops_per_slot()
    state_bytes = D * (12 * C + 3) * 4
    op_bytes = 12 * D * W * 4
    nbytes = 2 * state_bytes + op_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # the work this run's data needs: the live slots of the real steps
    live = _live_slot_steps(table, batch)
    nops = live * ops_per_slot
    ops_ms = nops / INT32_OPS_PER_S * 1e3
    # the plain version's count, every slot of every step
    plain_ops_ms = D * C * W * ops_per_slot / INT32_OPS_PER_S * 1e3
    rec.update({
        "plain_ms": statistics.median(plain),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    })
    log(f"times at D={D} C={C} W={W}: kernel median {rec['ms']:.4f} ms, "
        f"plain version median {rec['plain_ms']:.4f} ms (the plain torch "
        f"loop, not a yardstick); bound {rec['bound_ms']:.4f} ms by "
        f"{rec['bound_by']} (bytes {nbytes} -> {bytes_ms:.4f} ms; int32 "
        f"ops {nops} = {ops_per_slot}/slot-step over {live} live "
        f"slot-steps of real steps, {live / (D * C * W):.4f} of D*C*W -> "
        f"{ops_ms:.4f} ms); kernel at {rec['bound_ms'] / rec['ms']:.4f} of "
        f"the bound. Over every slot of every step (the plain version's "
        f"count): {plain_ops_ms:.4f} ms, kernel at "
        f"{plain_ops_ms / rec['ms']:.4f} of that")
    del table, full, batch
    for docs, cap in TIME_WIDE:
        table = windows.random_table(rng, docs, cap, "cuda")
        batch = windows.random_batch(rng, table, W, "cuda")
        _, err = _check_window(table, batch, f"D={docs} C={cap} W={W}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        apply_window(table, batch)
        kernel = _time_ms(lambda: apply_window(table, batch), 5, 10)
        log(f"times at D={docs} C={cap} W={W}: kernel median "
            f"{statistics.median(kernel):.4f} ms per launch (5 runs of 10 "
            f"back-to-back launches: "
            f"{[round(t, 4) for t in kernel]}), NOOP share of the batch "
            f"{_noop_share(batch):.4f}")
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
        for k in cuda_merge.ptxas_report(cuda_merge.BUILD_LOG):
            where = "shared memory" if k["smem"] else "device memory"
            log(f"  ptxas: merge_window_kernel<Q={k['q']}> (state in "
                f"{where}, {4 * k['q']} slots per thread): "
                f"{k['registers']} registers, spill stores "
                f"{k['spill_stores']} B, spill loads {k['spill_loads']} B")
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
