"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the Hopper window kernel from the sources in this checkout, holds
it bit for bit against its plain torch version on the card, drives the
SharedString merge plane end to end through ``GpuMergeSidecar`` at the
full width of bench config2 (4096 documents x capacity 1024, 4 clients
x 220 steps of seeded traffic) and checks every distinct stream against
the scalar ``MergeTreeClient`` oracle, drives the three executor routes
(scan, chunked, egwalker) over bench config14's four corpora at its
full width (1024 documents x capacity 512, rounds of 8 messages) and
holds one egwalker suffix window per corpus, after its walker stage,
kernel against plain, runs
the grow/evict recovery tiers at a small size, drives the SharedTree
plane (``TreeSidecar``) on both routes over 32 recorded three-writer
streams tiled to 1024 documents (capacity 128, grown once to 256)
against the scalar ``EditManager``, drives the pool tiers (16 long
documents of 1024 admitted to a one-shard ``MeshShardedPool`` at
capacity 8192 through the sidecar; bench config10's mesh pool on 1, 2
and 4 shards and its viral-member migration; the sequence-sharded
window at 64 x 4096 x 64 on 2 and 4 shards against the kernel; a
2-shard ``SeqShardedPool`` serving 4 long documents), and times the
kernel beside its plain version.

The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the kernel
record. Each "routes:" line holds one corpus x route: throughput, the
host's and the device's time, macro-steps per round, window-kernel
launches, grows, peak device memory and the host-sync check of the
route's device half; the "device programs" lines time ``compact`` and
``pad_capacity`` at the routes' shape. Each "tree:" line holds one tree
route: commits/s, the host's time, a device trace of the last rounds,
grows, host documents, ring evictions, peak memory and the host-sync
check; the "tree programs" lines time one window step's ring rebase and
each route's forest apply. Each "pool:" line holds one pool cell and
its mesh's device list (a one-card machine repeats ``cuda:0``: shards
on one card, not a scaling figure); the "pool programs" lines time the
doc-sharded dispatch, the row moves and the window floor. The times
lines cover the window
rungs 16 / 32 / 64 at the main shape and the capacities 4096 and 8192,
with the NOOP share of each timed batch. Every phase runs on every
call; any failure exits
non-zero without those lines, as does a machine with no CUDA device or a
directory without the port package. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import gc
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
    (1024, 512, 16),      # the routes phase: config14's table, W = 16 rung
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
                              executor="scan", device="cuda")
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
    log(f"main path: {MAIN_DOCS} docs x capacity {MAIN_CAPACITY}, route "
        f"{sidecar.executor}, {rounds} rounds, {real} real ops, wall {wall:.3f} s "
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
    """Device time of a CUDA-only profiler trace: the total, the number
    of device events (kernel launches and copies), and the five largest
    event names."""
    by_name, events = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
            events += e.count
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"total": sum(by_name.values()), "events": events,
            "top": [(n[:60], ms) for n, ms in top]}


# ----------------------------------------------------------------------
# routes: scan, chunked and egwalker at bench config14's full width

ROUTES = ("scan", "chunked", "egwalker")
ROUTES_DOCS, ROUTES_CAPACITY, ROUTES_MAX_CAPACITY = 1024, 512, 2048
ROUTES_STREAMS, ROUTES_ROUND = 16, 8  # distinct streams; messages per round


def route_corpus(kind: str) -> list:
    """The 16 distinct streams of one config14 corpus (``bench.py``'s
    seeds and weights: 3 clients x 120 steps, 4 for the concurrent)."""
    from fluidframework_tpu_torch.testing import (
        FuzzConfig, record_op_stream, record_sequential_stream,
    )

    out = []
    for i in range(ROUTES_STREAMS):
        if kind == "sequential":
            _, s = record_sequential_stream(seed=14000 + i, n_clients=3,
                                            n_steps=120)
        elif kind == "remove_heavy":
            _, s = record_sequential_stream(seed=14300 + i, n_clients=3,
                                            n_steps=120, remove_weight=0.45)
        elif kind == "concurrent":
            _, s = record_op_stream(FuzzConfig(
                n_clients=4, n_steps=120, seed=14100 + i,
                insert_weight=0.55, remove_weight=0.25,
                annotate_weight=0.05, process_weight=0.05))
        else:
            _, s = record_op_stream(FuzzConfig(
                n_clients=3, n_steps=120, seed=14200 + i,
                insert_weight=0.55, remove_weight=0.25,
                annotate_weight=0.05, process_weight=0.15))
        out.append(s)
    return out


def _guard_device_half(sidecar, attr: str = "_apply_program") -> dict:
    """Run every device half of ``sidecar``'s dispatches (its method
    ``attr``: the program's apply, after its host-to-device copy and
    before the settle) with CUDA sync debugging set to "error", so any
    host<->device sync in it raises. Returns the counter of guarded
    calls."""
    seen = {"calls": 0}
    inner = getattr(sidecar, attr)

    def guarded(table, program):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(table, program)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            seen["calls"] += 1

    setattr(sidecar, attr, guarded)
    return seen


def _hold_suffix_dispatch(sidecar) -> dict:
    """Keep the device inputs and output of one egwalker dispatch whose
    concurrent suffix holds real ops: the first that also runs a walker
    stage, else the first with a suffix. ``_check_suffix`` holds its
    suffix window kernel against plain after the timed run. Costs one
    dispatch's tables kept alive (inside the peak memory)."""
    held = {"rank": 0}
    pending = {"rank": 0, "real": 0}
    compile_inner = sidecar._compile_program
    apply_inner = sidecar._apply_program

    def compile_hook(arrays):
        program = compile_inner(arrays)
        suffix = program.get("suffix")
        real = 0 if suffix is None else int(_real(suffix["kind"]).sum())
        pending["real"] = real
        pending["rank"] = 0 if real == 0 else (
            2 if program["prefix"] is not None else 1)
        return program

    def apply_hook(table, program):
        out = apply_inner(table, program)
        if pending["rank"] > held["rank"]:
            held.update(pending, table=table, program=program, out=out)
        pending["rank"] = 0  # a grow's re-apply is the same dispatch
        return out

    sidecar._compile_program = compile_hook
    sidecar._apply_program = apply_hook
    return held


def _check_suffix(held: dict, what: str) -> str:
    """Re-run the held dispatch's walker stage, then hold its suffix
    window kernel against plain, every field bit for bit, and the
    dispatch's own output against the plain result. Launches here are
    comparisons: the caller has read the route's count already."""
    from fluidframework_tpu_torch.ops.event_graph import (
        EG_K, apply_window_egwalker,
    )

    table, program = held["table"], held["program"]
    walked = program["prefix"] is not None
    if walked:
        table = apply_window_egwalker(table, program["prefix"], K=EG_K,
                                      steps=program["steps"])
    suffix = program["suffix"]
    D, W = suffix.kind.shape
    where = f"{what} suffix D={D} C={table.capacity} W={W}"
    want, _ = _check_window(table, suffix, where)
    bad = [f for f, x, y in zip(want._fields, held["out"], want)
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(
            f"dispatch output != plain at {where}: fields {bad}; "
            + _first_difference(held["out"], want))
    return (f"suffix kernel == plain D={D} C={table.capacity} W={W} "
            f"({held['real']} real ops, "
            + ("after a walker stage" if walked else "no walker stage")
            + "; all fields bit-exact, and the dispatch's own output)")


def run_route(route: str, raw: list) -> dict:
    """One corpus through ``GpuMergeSidecar(executor=route)``: every
    document gets a stream (16 distinct, tiled), fed through ``ingest``
    8 messages per document per round, ``apply`` after each round.
    Returns the sidecar, its table (numpy) and the run's numbers."""
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.host_bridge import fetch
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    wrapped = [_wrap(s) for s in raw]
    sidecar = GpuMergeSidecar(
        max_docs=ROUTES_DOCS, capacity=ROUTES_CAPACITY,
        max_capacity=ROUTES_MAX_CAPACITY, executor=route, device="cuda")
    doc_ids = [f"doc-{d}" for d in range(ROUTES_DOCS)]
    for doc in doc_ids:
        sidecar.track(doc, "d", "s")
    guard = _guard_device_half(sidecar)
    held = _hold_suffix_dispatch(sidecar) if route == "egwalker" else None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_merge.LAUNCHES = 0
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        longest = max(len(s) for s in wrapped)
        rounds, real, ingest_s = 0, 0, 0.0
        for start in range(0, longest, ROUTES_ROUND):
            t_in = time.perf_counter()
            for d, doc in enumerate(doc_ids):
                for msg in wrapped[d % len(raw)][start:start + ROUTES_ROUND]:
                    sidecar.ingest(doc, msg)
            ingest_s += time.perf_counter() - t_in
            real += sidecar.apply()
            rounds += 1
        sidecar.sync()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = cuda_merge.LAUNCHES
    rec = {
        "sidecar": sidecar, "doc_ids": doc_ids, "launches": launches,
        "busy": _device_busy_ms(prof), "rounds": rounds, "real": real,
        "wall": wall, "ingest_s": ingest_s, "guarded": guard["calls"],
        "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
        "table": fetch(sidecar._table), "suffix_check": None,
    }
    if held is not None and held["rank"]:
        rec["suffix_check"] = _check_suffix(held, route)
    return rec


def phase_routes() -> None:
    """Each config14 corpus through the three routes: every distinct
    stream equals the oracle, the macro-step routes' live state equals
    the scan route's, no document leaves the device path unless the
    scan's did, and the egwalker suffix launches the window kernel on
    the corpora that have one."""
    from fluidframework_tpu_torch.testing.windows import live_difference

    for kind in ("sequential", "remove_heavy", "concurrent", "mixed"):
        raw = route_corpus(kind)
        scan = None
        for route in ROUTES:
            rec = run_route(route, raw)
            sidecar = rec.pop("sidecar")
            _check_docs(sidecar, [(rec["doc_ids"][i], raw[i])
                                  for i in range(len(raw))])
            hosted = set(sidecar._host)
            if route == "scan":
                scan = {"table": rec["table"], "hosted": hosted}
            else:
                if not hosted <= scan["hosted"]:
                    raise AssertionError(
                        f"{kind}/{route}: documents {sorted(hosted)} left "
                        f"the device path (scan: {sorted(scan['hosted'])})")
                diff = live_difference(scan["table"], rec["table"])
                if diff is not None:
                    raise AssertionError(
                        f"{kind}/{route}: live state != scan route's: {diff}")
            if route == "egwalker" and kind in ("concurrent", "mixed"):
                if rec["launches"] < 1:
                    raise AssertionError(f"{kind}/egwalker: the suffix "
                                         "never launched merge_window")
                if rec["suffix_check"] is None:
                    raise AssertionError(f"{kind}/egwalker: no suffix "
                                         "window was held against plain")
            st, busy = sidecar.stats, rec["busy"]
            log(f"routes: {kind} {route}: {ROUTES_DOCS} docs x capacity "
                f"{ROUTES_CAPACITY} (now {sidecar.capacity}), "
                f"{rec['rounds']} rounds, {rec['real']} real ops, wall "
                f"{rec['wall']:.3f} s, {rec['real'] / rec['wall']:.1f} ops/s "
                f"(ingest {rec['ingest_s']:.3f} s, pack+compile "
                f"{st['pack_s']:.3f} s, settle {st['settle_s']:.3f} s); "
                f"device busy {busy['total']:.3f} ms "
                f"({busy['total'] / rec['rounds']:.3f} ms and "
                f"{busy['events'] / rec['rounds']:.1f} device events per "
                f"round), top "
                + ", ".join(f"{n} {ms:.3f} ms" for n, ms in busy["top"][:3])
                + f"; macro-steps {st['macro_steps']} "
                f"({st['macro_steps'] / rec['rounds']:.2f} per round); "
                f"merge_window launches {rec['launches']}; grows "
                f"{sidecar.grow_count}; span_splits {st['span_splits']}; "
                f"host docs {len(hosted)}; peak device memory "
                f"{rec['peak_mib']:.1f} MiB; host syncs in the device half: "
                f"none in {rec['guarded']} dispatches (sync debug 'error'); "
                f"{len(raw)} streams == oracle"
                + ("" if route == "scan" else "; live state == scan")
                + ("" if route != "egwalker" else
                   f"; {rec['suffix_check'] or 'no suffix with real ops'}"))
            del sidecar, rec
        if kind == "sequential":
            time_table_programs(scan["table"])


def time_table_programs(arrays: dict) -> None:
    """CUDA-event times of the plain torch table programs the routes
    share, on a routes-phase table: ``compact`` (every 8th apply) and
    ``pad_capacity`` (a grow's first half)."""
    from fluidframework_tpu_torch import convert
    from fluidframework_tpu_torch.ops.merge_kernel import (
        compact, pad_capacity,
    )

    table = convert.table_from_numpy(arrays, "cuda")
    C = table.capacity
    for name, fn in (("compact", lambda: compact(table)),
                     (f"pad_capacity {C} -> {2 * C}",
                      lambda: pad_capacity(table, 2 * C))):
        fn()
        ms = _time_ms(fn, 5, 10)
        log(f"device programs: {name} at D={table.docs} C={C}: median "
            f"{statistics.median(ms):.4f} ms per call (5 runs of 10 "
            f"back-to-back calls: {[round(t, 4) for t in ms]})")


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
                              executor="scan", device="cuda")
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
# tree plane: TreeSidecar on both routes at a thousand-document width

TREE_ROUTES = ("atom", "macro")
TREE_DOCS, TREE_CAPACITY, TREE_MAX_CAPACITY = 1024, 128, 512
TREE_STREAMS, TREE_SEED = 32, 1700  # distinct recorded documents
TREE_PREFIX = 10  # per stream: 3 joins, the attach, 6 seed commits
TREE_ROUND = 3    # per stream: one op per writer per round
TREE_PROFILED_ROUNDS = 8  # the device trace's steady window


def _tree_replay(stream) -> str:
    """Root signature of a fresh scalar ``EditManager`` fed every tree
    op of ``stream`` as a peer commit (the host replica's path)."""
    from fluidframework_tpu_torch.models.tree import (
        Commit, EditManager, root_signature,
    )
    from fluidframework_tpu_torch.protocol import (
        MessageType, tree_change_from_json,
    )

    em = EditManager(session_id="oracle")
    for msg in stream:
        env = msg.contents if isinstance(msg.contents, dict) else {}
        if msg.type != MessageType.OPERATION or env.get("kind") != "op":
            continue
        em.add_sequenced_change(Commit(
            msg.client_id, msg.sequence_number,
            msg.reference_sequence_number,
            copy.deepcopy(tree_change_from_json(env["contents"]))), False)
    return root_signature(em.forest().content().get("root", []))


def tree_corpus() -> list:
    """``(signature, stream)`` of the 32 recorded SharedTree documents
    (``record_tree_stream(1700 + i)``: 3 writers x 24 rounds over 192
    seeded nodes); each recorder's converged writers are held equal to
    a fresh ``EditManager`` replay of its stream."""
    from fluidframework_tpu_torch.testing import record_tree_stream

    out = []
    for i in range(TREE_STREAMS):
        sig, stream = record_tree_stream(TREE_SEED + i)
        if _tree_replay(stream) != sig:
            raise AssertionError(f"tree stream {TREE_SEED + i}: the "
                                 "writers != the EditManager replay")
        out.append((sig, stream))
    return out


def run_tree(route: str, recorded: list) -> dict:
    """The recorded streams, tiled over the 1024 documents, through
    ``TreeSidecar(executor=route)``: the seeding prefix, then one
    authored round (one op per writer) per document, ``apply`` after
    each, then ``sync``. Returns the sidecar, its table (numpy), the
    last dispatch with its input table, and the run's numbers."""
    from fluidframework_tpu_torch import convert
    from fluidframework_tpu_torch.service import TreeSidecar

    sidecar = TreeSidecar(max_docs=TREE_DOCS, capacity=TREE_CAPACITY,
                          max_capacity=TREE_MAX_CAPACITY, executor=route,
                          device="cuda")
    doc_ids = [f"tree-{d}" for d in range(TREE_DOCS)]
    for doc in doc_ids:
        sidecar.track(doc, "d", "t")
    guard = _guard_device_half(sidecar, "_apply_dispatch")
    held = {}
    inner = sidecar._apply_dispatch

    def hold(table, dispatch):
        held.update(table=table, dispatch=dispatch)
        return inner(table, dispatch)

    sidecar._apply_dispatch = hold
    longest = max(len(s) for _, s in recorded)
    bounds = [0] + list(range(TREE_PREFIX, longest, TREE_ROUND)) + [longest]
    steady = len(bounds) - 1 - TREE_PROFILED_ROUNDS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        rounds, real, ingest_s = 0, 0, 0.0
        for start, stop in zip(bounds, bounds[1:]):
            if rounds == steady:
                # the device trace covers the last rounds only: a
                # steady window (capacity 256, one round per apply)
                torch.cuda.synchronize()
                prof = stack.enter_context(torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]))
                t_prof = time.perf_counter()
            t_in = time.perf_counter()
            for d, doc in enumerate(doc_ids):
                for msg in recorded[d % len(recorded)][1][start:stop]:
                    sidecar.ingest(doc, msg)
            ingest_s += time.perf_counter() - t_in
            real += sidecar.apply()
            rounds += 1
        sidecar.sync()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof_wall = time.perf_counter() - t_prof
    return {
        "sidecar": sidecar, "doc_ids": doc_ids, "rounds": rounds,
        "real": real, "wall": wall, "ingest_s": ingest_s,
        "busy": _device_busy_ms(prof), "prof_wall": prof_wall,
        "guarded": guard["calls"],
        "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
        "table": convert.tree_table_to_numpy(sidecar._table),
        "held": held,
    }


def _ring_activity(recorded: list) -> dict:
    """For every tree op of the corpus: how many of its document's last
    ``TRUNK_RING`` earlier ops were sequenced after its ref — the ring
    entries its rebase can act on (the others are muted whole)."""
    from fluidframework_tpu_torch.ops.tree_apply import TRUNK_RING

    counts: dict = {}
    for _, stream in recorded:
        ring: collections.deque = collections.deque(maxlen=TRUNK_RING)
        for msg in stream:
            env = msg.contents if isinstance(msg.contents, dict) else {}
            if env.get("kind") != "op":
                continue
            newer = sum(s > msg.reference_sequence_number for s in ring)
            counts[newer] = counts.get(newer, 0) + 1
            ring.append(msg.sequence_number)
    return dict(sorted(counts.items()))


def _tree_live_difference(a, b):
    """First field, and its first document, where two numpy TreeTables
    differ on ``count``, ``overflow``, every ring field, or the live
    slots ``[0, count)`` of ``content`` / ``value``; None when they
    agree."""
    live = np.arange(a.content.shape[1])[None, :] < a.count[:, None]
    fields = [("count", a.count, b.count),
              ("overflow", a.overflow, b.overflow),
              ("ring_seq", a.ring_seq, b.ring_seq),
              ("ring_session", a.ring_session, b.ring_session)]
    fields += [(f"ring.{name}", x, y)
               for name, x, y in zip(a.ring._fields, a.ring, b.ring)]
    fields += [(f"{name} (live slots)", np.where(live, getattr(a, name), 0),
                np.where(live, getattr(b, name), 0))
               for name in ("content", "value")]
    for name, x, y in fields:
        bad = np.flatnonzero((x != y).reshape(len(x), -1).any(axis=1))
        if bad.size:
            return f"{name}, document {bad[0]}"
    return None


def _check_tree_tiles(sidecar, rec, recorded, route) -> None:
    """Every one of the 1024 documents, not only the first of each
    stream: its signature equals its stream's EditManager replay, and
    its row equals the row of the stream's first document (``d % 32``)
    on count, ring and live slots — a fault that shows only at a high
    document index (a gather, roll or fill over the wrong axis, a leak
    between documents) fails here."""
    from fluidframework_tpu_torch.convert import tree_map

    n = len(recorded)
    for d, doc in enumerate(rec["doc_ids"]):
        if sidecar.signature(doc, "d", "t") != recorded[d % n][0]:
            raise AssertionError(f"tree {route}: document {d} (stream "
                                 f"{d % n}) != its EditManager replay")
    table = rec["table"]
    firsts = tree_map(table, lambda a: a[np.arange(len(a)) % n])
    diff = _tree_live_difference(table, firsts)
    if diff is not None:
        raise AssertionError(f"tree {route}: a tiled row differs from its "
                             f"stream's first row at {diff}")


def phase_tree() -> None:
    """Both tree routes over the recorded corpus at 1024 documents:
    every document equals its stream's EditManager replay, the two
    routes' live tables are equal, the slab grows once (128 -> 256), no
    document leaves the device, and no host sync happens in a device
    half. Then CUDA-event times of one window step's programs."""
    t0 = time.perf_counter()
    recorded = tree_corpus()
    corpus_s = time.perf_counter() - t0
    lines, tables, held = [], {}, None
    for route in TREE_ROUTES:
        t_run = time.perf_counter()
        rec = run_tree(route, recorded)
        run_s = time.perf_counter() - t_run
        sidecar = rec.pop("sidecar")
        _check_tree_tiles(sidecar, rec, recorded, route)
        if sidecar.host_mode_docs() or sidecar.ring_evict_count:
            raise AssertionError(
                f"tree {route}: {sidecar.host_mode_docs()} documents on "
                f"the host, {sidecar.ring_evict_count} ring evictions")
        if (sidecar.grow_count, sidecar.capacity) != (1, 2 * TREE_CAPACITY):
            raise AssertionError(
                f"tree {route}: {sidecar.grow_count} grows to capacity "
                f"{sidecar.capacity}, expected one to {2 * TREE_CAPACITY}")
        if sidecar.overflowed():
            raise AssertionError(f"tree {route}: a document overflowed")
        tables[route] = rec.pop("table")
        if route == "atom":
            held = rec["held"]
        st, busy = sidecar.stats, rec["busy"]
        lines.append(
            f"tree: {route}: {TREE_DOCS} docs x capacity {TREE_CAPACITY} "
            f"-> {sidecar.capacity} (max {TREE_MAX_CAPACITY}), ring "
            f"{sidecar.ring}, {sidecar.width} atoms; {rec['rounds']} "
            f"rounds, {rec['real']} commits, wall {rec['wall']:.3f} s, "
            f"{rec['real'] / rec['wall']:.1f} commits/s (ingest "
            f"{rec['ingest_s']:.3f} s, pack {st['pack_s']:.3f} s, settle "
            f"{st['settle_s']:.3f} s); device trace of the last "
            f"{TREE_PROFILED_ROUNDS} rounds (wall {rec['prof_wall']:.3f} "
            f"s): busy {busy['total']:.3f} ms "
            f"({busy['total'] / TREE_PROFILED_ROUNDS:.3f} ms and "
            f"{busy['events'] / TREE_PROFILED_ROUNDS:.1f} device events "
            f"per round), idle share "
            f"{1 - busy['total'] / (rec['prof_wall'] * 1e3):.6f}, top "
            + ", ".join(f"{n} {ms:.3f} ms" for n, ms in busy["top"][:3])
            + f"; grows {sidecar.grow_count} ({TREE_CAPACITY} -> "
            f"{sidecar.capacity}); host docs {sidecar.host_mode_docs()}; "
            f"ring evictions {sidecar.ring_evict_count}; peak device "
            f"memory {rec['peak_mib']:.1f} MiB; host syncs in the device "
            f"half: none in {rec['guarded']} dispatches (sync debug "
            f"'error'); all {TREE_DOCS} docs ({len(recorded)} streams) "
            f"== EditManager replay, each row == its stream's first; "
            f"{run_s - rec['wall']:.3f} s around the run (profiler, "
            f"table copy)")
        del sidecar, rec
    diff = _tree_live_difference(tables["atom"], tables["macro"])
    if diff is not None:
        raise AssertionError(f"tree: atom and macro tables differ at {diff}")
    for line in lines:
        log(line + "; live table == the other route's")
    log(f"tree: corpus of {len(recorded)} streams recorded and replayed "
        f"in {corpus_s:.3f} s (host); commits by the number of ring "
        f"entries newer than their ref (of {held['table'].ring_seq.shape[1]}"
        f"): {_ring_activity(recorded)}")
    time_tree_programs(held)


def time_tree_programs(held: dict) -> None:
    """Times of one window step's device programs on the tree phase's
    last dispatch (its first step, on the table it was applied to): the
    ring rebase (16 over-steps), and the forest apply on each route,
    whose outputs are held equal first. Each gets CUDA-event times of
    back-to-back calls (which carry the host's issue rate) and its
    device time per call from a profiler trace of 10 calls (the sum of
    its kernels and copies, what a hand kernel would replace)."""
    from fluidframework_tpu_torch.ops.tree_apply import (
        TreeAtoms, apply_atom_route, apply_macro_route, move_payloads,
        rebase_over_ring,
    )

    table, dispatch = held["table"], held["dispatch"]
    prog = dispatch.program
    atoms = TreeAtoms(*(f[0] for f in prog.atoms))
    step = (prog.seq[0], prog.ref[0], prog.session[0])
    rebased = rebase_over_ring(table, atoms, *step)
    moves = move_payloads(table, rebased)
    rows = dispatch.rows[0]
    apply_args = (table.content, table.value, table.count, rebased,
                  prog.payload[0], *moves, rows)
    outs = [fn(*apply_args) for fn in (apply_atom_route, apply_macro_route)]
    live = torch.arange(table.slots, device=table.content.device) \
        < outs[0][2].unsqueeze(1)
    for x, y in zip(outs[0], outs[1]):
        if x.dim() == 2:
            x, y = torch.where(live, x, 0), torch.where(live, y, 0)
        if not torch.equal(x, y):
            raise AssertionError("tree programs: atom != macro apply")
    for name, fn in (
            ("ring rebase (16 over-steps)",
             lambda: rebase_over_ring(table, atoms, *step)),
            (f"atom apply ({rows} rows)",
             lambda: apply_atom_route(*apply_args)),
            ("macro apply", lambda: apply_macro_route(*apply_args))):
        fn()
        ms = _time_ms(fn, 5, 10)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        busy = _device_busy_ms(prof)
        log(f"tree programs: {name} at D={table.docs} S={table.slots} "
            f"A={atoms.kind.shape[1]}: median {statistics.median(ms):.4f} "
            f"ms per call (5 runs of 10 back-to-back calls: "
            f"{[round(t, 4) for t in ms]}); device "
            f"{busy['total'] / 10:.4f} ms and {busy['events'] / 10:.1f} "
            f"device events per call (trace of 10 calls), top "
            + ", ".join(f"{n} {t / 10:.4f} ms" for n, t in busy["top"][:3]))


# ----------------------------------------------------------------------
# pool: the pool tiers and sharding, every mesh on the card

POOL_DOCS, POOL_CAPACITY, POOL_MAX_CAPACITY = 1024, 1024, 2048
POOL_LONG_DOCS, POOL_LONG_DISTINCT, POOL_LONG_STEPS = 16, 4, 2000
# bench config10 "full" (bench.py:1909-1914): members per shard, rounds,
# ops per member per round, steps per stream; pool capacity 128
MIG_MEMBERS, MIG_ROUNDS, MIG_OPS, MIG_STEPS, MIG_CAPACITY = 16, 40, 4, 80, 128
SEQ_DOCS, SEQ_CAPACITY, SEQ_WINDOW = 64, 4096, 64
SEQ_TIER_SHARE = 0.7  # of each long stream, for the 2-shard seq tier


def long_corpus(seed: int) -> list:
    """The long documents' distinct recorded streams: config2's recorder
    with more steps, longer inserts and no removes, so each ends with
    2048 to 8192 live segments (past the primary ladder's top)."""
    from fluidframework_tpu_torch.testing import FuzzConfig, record_op_stream

    return [record_op_stream(FuzzConfig(
        n_clients=2, n_steps=POOL_LONG_STEPS, insert_weight=0.89,
        remove_weight=0.0, annotate_weight=0.03, process_weight=0.08,
        max_insert_len=12, seed=seed * 1000 + 500 + i))[1]
        for i in range(POOL_LONG_DISTINCT)]


def _check_tiled(sidecar, doc_ids, stream_of, oracles) -> None:
    """Every document's text and signature equal its stream's oracle
    (``oracles[stream_of[d]]``, one replay per distinct stream)."""
    for d, doc in enumerate(doc_ids):
        text, sig = oracles[stream_of[d]]
        if sidecar.text(doc, "d", "s") != text:
            raise AssertionError(f"{doc}: text differs from the oracle")
        if sidecar.signature(doc, "d", "s") != sig:
            raise AssertionError(f"{doc}: signature differs from the oracle")


def _hook_pool(pool) -> dict:
    """Count the window-kernel launches of ``pool``'s dispatches and
    keep the inputs of its last dispatch with real ops."""
    from fluidframework_tpu_torch.ops import cuda_merge

    seen = {"launches": 0, "calls": 0}
    inner = pool._apply

    def hooked(table, arrays):
        before = cuda_merge.LAUNCHES
        out = inner(table, arrays)
        seen["launches"] += cuda_merge.LAUNCHES - before
        seen["calls"] += 1
        if _real(arrays["kind"]).any():
            seen.update(table=table, arrays=arrays)
        return out

    pool._apply = hooked
    return seen


def _shard_devices(n: int) -> list:
    """``n`` shard devices: distinct cards where the machine has them,
    else the one card repeated (same-device shards)."""
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def phase_pool_longdoc(seed: int, long_raw: list) -> dict:
    """The long-document tier through the sidecar at its default width:
    1008 documents of config2's streams and 16 long ones on a
    [1024, 1024 -> 2048] slab whose pool is a one-shard MeshShardedPool
    at capacity 8192; the long documents must land in the pool, none on
    the host, every document equal to its oracle, and one captured pool
    dispatch at capacity 8192 kernel against plain on every field."""
    from fluidframework_tpu_torch import convert
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.parallel import MeshShardedPool, make_mesh
    from fluidframework_tpu_torch.service import GpuMergeSidecar
    from fluidframework_tpu_torch.testing import FuzzConfig, record_op_stream

    short_raw = [record_op_stream(FuzzConfig(
        n_clients=4, n_steps=220, seed=seed * 1000 + i))[1]
        for i in range(16)]
    distinct = short_raw + long_raw
    n_short = POOL_DOCS - POOL_LONG_DOCS
    stream_of = [d % 16 for d in range(n_short)] + [
        16 + d % len(long_raw) for d in range(POOL_LONG_DOCS)]
    wrapped = [_wrap(s) for s in distinct]
    mesh = make_mesh(_shard_devices(1))
    sidecar = GpuMergeSidecar(
        max_docs=POOL_DOCS, capacity=POOL_CAPACITY,
        max_capacity=POOL_MAX_CAPACITY, seq_mesh=mesh, executor="scan",
        device="cuda")
    pool = sidecar._pool
    if not isinstance(pool, MeshShardedPool) or \
            pool.capacity != min(4 * POOL_MAX_CAPACITY, 8192):
        raise AssertionError(f"select_pool built {type(pool).__name__} at "
                             f"capacity {pool.capacity}")
    doc_ids = [f"pool-{d}" for d in range(POOL_DOCS)]
    for doc in doc_ids:
        sidecar.track(doc, "d", "s")
    seen = _hook_pool(pool)
    cuda_merge.LAUNCHES = 0
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        longest = max(len(s) for s in wrapped)
        chunks = (16, 32, 48)
        start, rounds, real, ingest_s = 0, 0, 0, 0.0
        while start < longest:
            stop = start + chunks[rounds % len(chunks)]
            t_in = time.perf_counter()
            for d, doc in enumerate(doc_ids):
                for msg in wrapped[stream_of[d]][start:stop]:
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
    t_or = time.perf_counter()
    oracles = [_oracle(s) for s in distinct]
    _check_tiled(sidecar, doc_ids, stream_of, oracles)
    check_s = time.perf_counter() - t_or
    counts = (sidecar.pool_admit_count, sidecar.pooled_docs(),
              sidecar.host_mode_docs())
    if counts != (POOL_LONG_DOCS, POOL_LONG_DOCS, 0) or sidecar.overflowed():
        raise AssertionError(f"pool admissions / pooled / host documents "
                             f"{counts}, expected ({POOL_LONG_DOCS}, "
                             f"{POOL_LONG_DOCS}, 0)")
    live = pool.fetch()["count"][[pool.row_of[s] for s in pool.members]]
    if live.min() < POOL_MAX_CAPACITY or live.max() > pool.capacity:
        raise AssertionError(f"long documents end with {live.min()}-"
                             f"{live.max()} live segments")
    if seen["launches"] <= 0 or launches < seen["launches"]:
        raise AssertionError(f"merge_window launches: {launches} on the "
                             f"path, {seen['launches']} by the pool")
    table = seen["table"].shards[0]
    batch = convert.batch_from_numpy(seen["arrays"], "cuda")
    W = batch.kind.shape[-1]
    _, err = _check_window(table, batch,
                           f"pool dispatch D={table.docs} C={table.capacity} "
                           f"W={W}")
    st = sidecar.stats
    log(f"pool: long-document tier: mesh {[str(d) for d in mesh.device_list()]}"
        f", {POOL_DOCS} docs ({n_short} config2 streams tiled, "
        f"{POOL_LONG_DOCS} long docs of {len(long_raw)} distinct "
        f"{POOL_LONG_STEPS}-step streams, {live.min()}-{live.max()} live "
        f"segments at the end) x capacity {POOL_CAPACITY} -> "
        f"{sidecar.capacity} (max {POOL_MAX_CAPACITY}), pool "
        f"{type(pool).__name__} at capacity {pool.capacity}; {rounds} "
        f"rounds, {real} real ops, wall {wall:.3f} s, {real / wall:.1f} "
        f"ops/s (ingest {ingest_s:.3f} s, pack {st['pack_s']:.3f} s, settle "
        f"{st['settle_s']:.3f} s, pool dispatches {st['pool_s']:.3f} s, "
        f"admission replay {st['admit_s']:.3f} s); grows "
        f"{sidecar.grow_count}, pool admissions {sidecar.pool_admit_count}, "
        f"pooled docs {sidecar.pooled_docs()}, host docs "
        f"{sidecar.host_mode_docs()}; pool dispatches "
        f"{pool.dispatch_count} incremental + replay chunks "
        f"{seen['calls'] - pool.dispatch_count}, merge_window launches "
        f"{launches} on this path, {seen['launches']} of them by the pool; "
        f"device busy {busy['total']:.3f} ms, "
        f"idle share {1 - busy['total'] / (wall * 1e3):.6f}, top "
        + ", ".join(f"{n} {ms:.3f} ms" for n, ms in busy["top"][:3])
        + f"; all {POOL_DOCS} docs == oracle ({check_s:.3f} s); pool "
        f"dispatch kernel == plain at D={table.docs} C={table.capacity} "
        f"W={W}, all fields")
    return {"max_abs_err": err, "pool_launches": seen["launches"]}


def _prefixed(encs: list, n: int, rounds: int, per_round: int):
    """config10's feed: fresh streams truncated to a base prefix, and
    the full op lists to feed ``per_round`` ops at a time."""
    streams, fulls = [], []
    for i in range(n):
        full = list(encs[i % len(encs)].ops)
        base = max(8, len(full) - rounds * per_round)
        streams.append(dataclasses.replace(encs[i % len(encs)],
                                           ops=full[:base]))
        fulls.append(full)
    return streams, fulls


def _feed(streams, fulls, per_member: int) -> bool:
    moved = False
    for stream, full in zip(streams, fulls):
        nxt = full[len(stream.ops):len(stream.ops) + per_member]
        if nxt:
            stream.ops.extend(nxt)
            moved = True
    return moved


def phase_pool_migration():
    """bench config10 at its full scale on MeshShardedPool: 16 members
    per shard on meshes of 1, 2 and 4 shards (rounds per second), then
    the viral-member phase on 4 shards against a never-migrated
    one-shard pool and the oracle. Returns the migrated pool."""
    from fluidframework_tpu_torch.models.mergetree import MergeTreeClient
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.host_bridge import (
        decode_stream, encode_stream, extract_text,
    )
    from fluidframework_tpu_torch.parallel import make_mesh
    from fluidframework_tpu_torch.service.gpu_sidecar import select_pool
    from fluidframework_tpu_torch.testing import FuzzConfig, record_op_stream

    kmax = 4
    encs = [encode_stream(record_op_stream(FuzzConfig(
        n_clients=2, n_steps=MIG_STEPS, seed=4200 + i, insert_weight=0.55,
        remove_weight=0.25, annotate_weight=0.05, process_weight=0.15))[1])
        for i in range(MIG_MEMBERS * kmax)]
    rates = []
    for k in (1, 2, kmax):
        devices = _shard_devices(k)
        pool = select_pool(make_mesh(devices), MIG_CAPACITY, route="mesh")
        n = MIG_MEMBERS * k
        streams, fulls = _prefixed(encs, n, MIG_ROUNDS, MIG_OPS)
        pool.admit(list(range(n)), streams)
        _feed(streams, fulls, 1)
        pool.dispatch_pending(streams)
        cuda_merge.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = 0
        while done < MIG_ROUNDS and _feed(streams, fulls, MIG_OPS):
            pool.dispatch_pending(streams)
            done += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # one window-kernel launch per shard per dispatch
        if cuda_merge.LAUNCHES != k * done or done == 0:
            raise AssertionError(f"config10 on {k} shards: merge_window "
                                 f"launches {cuda_merge.LAUNCHES} in {done} "
                                 "dispatches")
        rates.append(f"{k} shard{'s' if k > 1 else ''} "
                     f"{[str(d) for d in devices]}: {n} members, {done} "
                     f"rounds in {wall:.3f} s, {done / wall:.1f} rounds/s "
                     f"({n * done / wall:.1f} member-rounds/s), merge_window "
                     f"launches {cuda_merge.LAUNCHES}")
    shared = len(set(devices)) < kmax
    log(f"pool: config10 mesh pool at capacity {MIG_CAPACITY}, "
        f"{MIG_OPS} ops per member per round, {MIG_STEPS}-step two-client "
        f"streams (the fuzz mix only: the flow-mix quarter needs the "
        f"flowdoc layer, not ported): " + "; ".join(rates)
        + ("; same-device shards (one card), not a scaling figure"
           if shared else ""))

    n_par = MIG_MEMBERS * kmax - 1  # leaves one open row
    pool = select_pool(make_mesh(devices), MIG_CAPACITY, route="mesh")
    oracle = select_pool(make_mesh(devices[:1]), MIG_CAPACITY, route="mesh")
    streams, fulls = _prefixed(encs, n_par, MIG_ROUNDS, MIG_OPS)
    pool.admit(list(range(n_par)), streams)
    oracle.admit(list(range(n_par)), streams)
    rounds = 0
    while pool.migration_count == 0 and rounds < 4 * MIG_ROUNDS:
        _feed(streams[:1], fulls[:1], 2 * MIG_OPS)   # the viral member
        _feed(streams[1:], fulls[1:], 1)
        pool.dispatch_pending(streams)
        oracle.dispatch_pending(streams)
        rounds += 1
    if pool.migration_count == 0 or oracle.migration_count != 0:
        raise AssertionError(f"migrations: {pool.migration_count} on "
                             f"{kmax} shards, {oracle.migration_count} on one")
    fetched, o_fetched = pool.fetch(), oracle.fetch()
    for slot in range(n_par):
        host = MergeTreeClient("oracle")
        host.start_collaboration("oracle")
        for msg in decode_stream(streams[slot]):
            host.apply_msg(msg)
        got = extract_text(fetched, streams[slot], pool.row_of[slot])
        if got != extract_text(o_fetched, streams[slot],
                               oracle.row_of[slot]) or got != host.get_text():
            raise AssertionError(f"config10 member {slot}: the migrated pool "
                                 "!= the one-shard pool or the oracle")
    log(f"pool: config10 viral member on {kmax} shards "
        f"{[str(d) for d in devices]}: {pool.migration_count} migration(s) "
        f"in {rounds} rounds, the one-shard pool {oracle.migration_count}; "
        f"shard members {[len(m) for m in pool.shard_members]}; all {n_par} "
        f"members == the one-shard pool == the oracle")
    return pool


def _program_times(fn, calls: int = 10) -> tuple:
    """CUDA-event median of 5 runs of ``calls`` back-to-back calls, and
    the device time and device events per call from a trace of
    ``calls`` calls."""
    fn()
    ms = statistics.median(_time_ms(fn, 5, calls))
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy = _device_busy_ms(prof)
    return ms, busy["total"] / calls, busy["events"] / calls


def time_pool_programs(pool) -> None:
    """The pool tier's table programs (B6, B7), each held against a host
    gather or loop first: on the migrated config10 pool's 4-shard table,
    the doc-sharded dispatch of a 4-op window (one window-kernel launch
    per shard, the ops' upload included), ``migrate_rows`` with the
    pool's one-document move and with a random permutation, ``take_rows``
    on one shard and ``global_window_floor``; then the two row programs
    on a 4-shard table at the pool's top capacity (8192)."""
    from fluidframework_tpu_torch.convert import sharded_table_to_numpy
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.merge_kernel import apply_window_plain
    from fluidframework_tpu_torch.ops.segment_table import (
        SegmentTable, ShardedTable,
    )
    from fluidframework_tpu_torch.ops.shard_moves import (
        migrate_rows, take_rows,
    )
    from fluidframework_tpu_torch.parallel import (
        apply_window_mesh_sharded, global_window_floor, shard_table,
    )
    from fluidframework_tpu_torch.testing import windows

    rng = np.random.default_rng(10)

    def joined(table):
        return SegmentTable(*(torch.cat(f) for f in zip(*table.shards)))

    def row_programs(table, label):
        host = sharded_table_to_numpy(table)
        n = table.docs
        R = table.rows_per_shard
        one = np.arange(n)
        one[n - 1] = 0  # shard 0's first row into the last shard's last
        perm = rng.permutation(n)
        for name, idx in (("one-document move", one),
                          ("random permutation", perm)):
            got = sharded_table_to_numpy(
                migrate_rows(ShardedTable(list(table.shards)), idx))
            if any(not np.array_equal(got[f], host[f][idx]) for f in host):
                raise AssertionError(f"migrate_rows ({name}) != host gather")
            ms, dev, ev = _program_times(
                lambda: migrate_rows(ShardedTable(list(table.shards)), idx))
            log(f"pool programs: migrate_rows ({name}) at {label}: median "
                f"{ms:.4f} ms per call; device {dev:.4f} ms and {ev:.1f} "
                "device events per call (trace of 10 calls)")
        rev = np.arange(R)[::-1].copy()
        shard = table.shards[0]
        got = take_rows(shard, rev)
        if not torch.equal(got.length.cpu(), shard.length.cpu()[rev]):
            raise AssertionError("take_rows != host gather")
        ms, dev, ev = _program_times(lambda: take_rows(shard, rev))
        log(f"pool programs: take_rows (one shard, rows reversed) at "
            f"{R} x {table.capacity}: median {ms:.4f} ms per call; device "
            f"{dev:.4f} ms and {ev:.1f} device events per call")

    table = pool._table
    label = (f"{table.docs} rows ({len(table.shards)} shards x "
             f"{table.rows_per_shard}) x {table.capacity}")
    batch = windows.random_batch(rng, joined(table), 4, "cpu")
    arrays = {f: getattr(batch, f).numpy() for f in batch._fields}
    want = apply_window_plain(joined(table), type(batch)(
        *(t.cuda() for t in batch)))
    before = cuda_merge.LAUNCHES
    got = joined(apply_window_mesh_sharded(table, arrays, pool.mesh))
    per_call = cuda_merge.LAUNCHES - before
    if any(not torch.equal(a, b) for a, b in zip(want, got)):
        raise AssertionError("doc-sharded dispatch != the plain step")
    ms, dev, ev = _program_times(
        lambda: apply_window_mesh_sharded(table, arrays, pool.mesh))
    log(f"pool programs: apply_window_mesh_sharded (W=4) at {label} on "
        f"{[str(d) for d in pool.mesh.device_list()]}: median {ms:.4f} ms "
        f"per call; device {dev:.4f} ms and {ev:.1f} device events per "
        f"call; merge_window launches per call {per_call}; == the plain "
        "step on the joined table, every field")
    floor = int(global_window_floor(table))
    if floor != int(joined(table).min_seq.min()):
        raise AssertionError("global_window_floor != the host minimum")
    ms, dev, ev = _program_times(lambda: global_window_floor(table))
    log(f"pool programs: global_window_floor at {label}: median {ms:.4f} "
        f"ms per call; device {dev:.4f} ms and {ev:.1f} device events per "
        "call")
    row_programs(table, label)
    wide = shard_table(windows.random_table(rng, 64, 8192, "cuda"),
                       pool.mesh)
    row_programs(wide, f"64 rows (4 shards x 16) x 8192")


def phase_pool_seq(long_raw: list) -> None:
    """The sequence-sharded window at 64 documents x capacity 4096 x 64
    ops on 2 and 4 same-card shards against B1, then a sidecar whose
    pool is a 2-shard SeqShardedPool serving 4 long documents."""
    from fluidframework_tpu_torch import convert
    from fluidframework_tpu_torch.ops.host_bridge import (
        coalesce_noops, encode_stream, fetch, pack_rows, replay_chunked,
    )
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.merge_kernel import (
        apply_window, apply_window_plain, compact,
    )
    from fluidframework_tpu_torch.ops.segment_table import make_table
    from fluidframework_tpu_torch.parallel import (
        apply_window_seq_sharded, make_seq_mesh,
    )
    from fluidframework_tpu_torch.service import GpuMergeSidecar
    from fluidframework_tpu_torch.service.gpu_sidecar import SeqShardedPool
    from fluidframework_tpu_torch.testing.windows import live_difference

    ops = [coalesce_noops(encode_stream(s).ops) for s in long_raw]
    prefix = {d: ops[d % len(ops)][:-SEQ_WINDOW] for d in range(SEQ_DOCS)}
    window = {d: ops[d % len(ops)][-SEQ_WINDOW:] for d in range(SEQ_DOCS)}

    def b1(table, arrays):
        return compact(apply_window(table, convert.batch_from_numpy(
            arrays, "cuda")))

    table = replay_chunked(b1, make_table(SEQ_DOCS, SEQ_CAPACITY, "cuda"),
                           prefix, chunk=256)
    batch = convert.batch_from_numpy(
        pack_rows(SEQ_DOCS, window, bucket_floor=SEQ_WINDOW), "cuda")
    want = fetch(apply_window(table, batch))
    times = []
    for n in (1, 2, 4):
        devices = _shard_devices(n)
        mesh = make_seq_mesh(devices)
        # the checked 2-shard window runs under a device trace (kernels
        # from every shard thread); an untraced one gives the wall
        torch.cuda.synchronize()
        with (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
              if n == 2 else contextlib.nullcontext()) as prof:
            out = apply_window_seq_sharded(table, batch, mesh)
            torch.cuda.synchronize()
        diff = live_difference(want, fetch(out))
        if diff is not None:
            raise AssertionError(f"seq-sharded window on {n} shards != B1: "
                                 f"{diff}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply_window_seq_sharded(table, batch, mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        busy = "" if prof is None else (
            " (device {total:.3f} ms, {events} device events)".format(
                **_device_busy_ms(prof)))
        times.append(f"{n} {'(B1)' if n == 1 else 'shards'} "
                     f"{[str(d) for d in devices]} {ms:.3f} ms{busy}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apply_window_plain(table, batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    counts = fetch(table)["count"]
    log(f"pool: seq-sharded window at D={SEQ_DOCS} C={SEQ_CAPACITY} "
        f"W={SEQ_WINDOW} (live slots before the window "
        f"{counts.min()}-{counts.max()}): live slots, count, min_seq, "
        f"overflow == B1 on 2 and 4 shards; ms per window (host wall "
        f"with a device sync): " + "; ".join(times)
        + f"; the unsharded plain step on one thread {plain_ms:.3f} ms"
        + ("; same-device shards" if len(set(devices)) < 4 else ""))

    mesh = make_seq_mesh(_shard_devices(2))
    sidecar = GpuMergeSidecar(max_docs=len(long_raw), capacity=POOL_CAPACITY,
                              max_capacity=POOL_MAX_CAPACITY, seq_mesh=mesh,
                              executor="scan", device="cuda")
    pool = sidecar._pool
    if not isinstance(pool, SeqShardedPool) or \
            pool.capacity != 2 * POOL_MAX_CAPACITY:
        raise AssertionError("select_pool did not build the 2-shard seq pool")
    # depth cut: a prefix of each long stream, still past max_capacity
    raws = [s[:int(len(s) * SEQ_TIER_SHARE)] for s in long_raw]
    wrapped = [_wrap(s) for s in raws]
    docs = [f"seq-{d}" for d in range(len(raws))]
    for doc in docs:
        sidecar.track(doc, "d", "s")
    seq_windows = [0]
    inner = pool._apply

    def counted(table, arrays):
        seq_windows[0] += 1
        return inner(table, arrays)

    pool._apply = counted
    longest = max(len(s) for s in wrapped)
    bounds = [0, longest - 96, longest - 64, longest - 32, longest]
    cuda_merge.LAUNCHES = 0
    t0 = time.perf_counter()
    for start, stop in zip(bounds, bounds[1:]):
        for doc, s in zip(docs, wrapped):
            for msg in s[start:stop]:
                sidecar.ingest(doc, msg)
        sidecar.apply()
    sidecar.sync()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_merge.LAUNCHES
    _check_docs(sidecar, list(zip(docs, raws)))
    counts = (sidecar.pool_admit_count, sidecar.pooled_docs(),
              sidecar.host_mode_docs())
    if counts != (len(docs), len(docs), 0) or launches == 0:
        raise AssertionError(f"seq pool admissions / pooled / host {counts}, "
                             f"merge_window launches {launches}")
    live = pool.fetch()["count"][:len(docs)]
    st = sidecar.stats
    log(f"pool: seq tier: mesh {[str(d) for d in mesh.device_list()]}, "
        f"SeqShardedPool at capacity {pool.capacity}; {len(docs)} long docs "
        f"(the first {SEQ_TIER_SHARE} of each long stream's messages, a "
        f"depth cut; {live.min()}-{live.max()} live segments at the end) in "
        f"4 applies, wall {wall:.3f} s (admission replay "
        f"{st['admit_s']:.3f} s, pool dispatches {st['pool_s']:.3f} s, "
        f"{pool.dispatch_count} incremental); sequence-sharded windows "
        f"{seq_windows[0]}, merge_window launches {launches} (the primary "
        f"slab's); pooled docs {sidecar.pooled_docs()}, host docs "
        f"{sidecar.host_mode_docs()}; all == oracle")


def phase_pool(seed: int) -> dict:
    marks = [("start", time.perf_counter())]
    long_raw = long_corpus(seed)
    marks.append(("long corpus", time.perf_counter()))
    log(f"pool: long corpus: {len(long_raw)} streams of {POOL_LONG_STEPS} "
        f"steps recorded in {marks[-1][1] - marks[0][1]:.3f} s (host)")
    rec = phase_pool_longdoc(seed, long_raw)
    marks.append(("long-document tier", time.perf_counter()))
    pool = phase_pool_migration()
    marks.append(("config10", time.perf_counter()))
    time_pool_programs(pool)
    marks.append(("pool programs", time.perf_counter()))
    phase_pool_seq(long_raw)
    marks.append(("seq window and tier", time.perf_counter()))
    log(f"pool: phase wall {marks[-1][1] - marks[0][1]:.3f} s ("
        + ", ".join(f"{name} {t - marks[i][1]:.3f} s"
                    for i, (name, t) in enumerate(marks[1:])) + ")")
    return rec


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
        phase_routes()
        phase_recovery(args.seed)
        phase_tree()
        pool_rec = phase_pool(args.seed)
        time_rec = phase_time(args.seed)
        worst = max(worst, time_rec.pop("max_abs_err"),
                    pool_rec["max_abs_err"])
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
