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
2-shard ``SeqShardedPool`` serving 4 long documents), drives the
SharedMatrix plane at bench config3's full width (64 matrices of 10250
rows x 16 cols: the axes as one 128 x 1024 window of the kernel, the
cells as one LWW sort and scatter) against the host replay, a host LWW
and a host materialization of every matrix, runs the main path and
config14's mixed corpus on both macro-step routes with the donated
double buffer on and off, walks ``prewarm``'s capacity x window ladder
at the main path's shape, reruns the main path with every observability
and protection hook on under one torch.profiler trace and drives chaos
at the merge sidecar's, a mesh pool's and the tree sidecar's seams, and
times the kernel beside its plain version.

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
doc-sharded dispatch, the row moves and the window floor. The
"matrix:" lines hold the pack, end-to-end and check results and the
times of the axis window and the cells' sort and scatter; each
"donation:" line one run with donation on or off (wall, device time,
peak memory, allocator requests per round) and the last one a donated
window's and a copy's times; the "prewarm:" line the walk's seconds and
shapes and the first round after it beside the steady ones. The "obs:"
lines hold the registry's counters after the earlier phases, the main
path with the hooks on (its wall beside the hooks-off one, the host
profiler's overhead, and the checks: oracle, the hooks-off run, one
dispatch range per round around every kernel launch, registry ==
counters, heat conserved, hops, the sanitizer's bounds, no host sync in
the device half) and one line per chaos run. The times lines cover the
window rungs 16 / 32 / 64 at the main shape and the capacities 4096 and
8192, with the NOOP share and the bound of each timed batch. Every phase
runs on every call; any failure exits non-zero without those lines, as
does a machine with no CUDA device or a directory without the port
package. Imports nothing of JAX.
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


def config2_corpus(seed: int) -> list:
    """The main path's 16 distinct streams (4 clients x 220 steps)."""
    from fluidframework_tpu_torch.testing import FuzzConfig, record_op_stream

    return [record_op_stream(FuzzConfig(
        n_clients=4, n_steps=220, seed=seed * 1000 + i))[1]
        for i in range(16)]


def _alloc_count() -> int:
    """The caching allocator's allocation requests so far."""
    return torch.cuda.memory_stats().get("allocation.all.allocated", 0)


def drive_config2(raw: list, donate=None, **hooks) -> dict:
    """bench config2 at full width through ``GpuMergeSidecar`` on the
    scan route: every document a tile of ``raw``, rounds of 16 / 32 / 48
    messages. Returns the sidecar and the run's numbers: wall, ingest,
    rounds, real ops, window-kernel launches, the device trace, peak
    device memory and the allocator's allocation requests. ``hooks``
    (the obs phase's) go to the sidecar, with its messages; the run then
    takes no CUDA-only trace of its own (the caller's device trace covers
    it, and only one profiler runs at a time)."""
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    n_distinct = len(raw)
    wrapped = [_wrap(s) for s in raw]
    sidecar = GpuMergeSidecar(max_docs=MAIN_DOCS, capacity=MAIN_CAPACITY,
                              executor="scan", donate=donate, device="cuda",
                              **hooks)
    doc_ids = [f"doc-{d}" for d in range(MAIN_DOCS)]
    for doc in doc_ids:
        sidecar.track(doc, "d", "s")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocs = _alloc_count()
    cuda_merge.LAUNCHES = 0
    torch.cuda.synchronize()
    # device activity only: the trace gives the device-busy time of the
    # run (kernels and copies, one stream), no host op events
    with (contextlib.nullcontext() if hooks else torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])) as prof:
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
    return {"sidecar": sidecar, "doc_ids": doc_ids, "wall": wall,
            "ingest_s": ingest_s, "rounds": rounds, "real": real,
            "launches": cuda_merge.LAUNCHES,
            "busy": None if hooks else _device_busy_ms(prof),
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "allocs": _alloc_count() - allocs, "wrapped": wrapped}


def _served(sidecar, doc_ids: list) -> dict:
    """The live table (numpy) and each listed document's text and
    signature."""
    from fluidframework_tpu_torch.ops.host_bridge import fetch

    return {"table": fetch(sidecar._table),
            "docs": [(sidecar.text(d, "d", "s"),
                      sidecar.signature(d, "d", "s")) for d in doc_ids]}


def phase_main(seed: int) -> dict:
    raw = config2_corpus(seed)
    n_distinct = len(raw)
    run = drive_config2(raw)
    sidecar, doc_ids = run.pop("sidecar"), run["doc_ids"]
    wall, ingest_s, rounds, real = (run["wall"], run["ingest_s"],
                                    run["rounds"], run["real"])
    launches, busy = run["launches"], run["busy"]

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
        f"{sidecar.grow_count}, donate {sidecar.donate}; peak device "
        f"memory {run['peak_mib']:.1f} MiB, allocator requests "
        f"{run['allocs']}; {n_distinct} streams == oracle")
    if busy["total"] > 0:
        log(f"main path device trace: busy {busy['total']:.3f} ms of wall "
            f"{wall * 1e3:.3f} ms, idle share "
            f"{1 - busy['total'] / (wall * 1e3):.6f}; by name "
            + ", ".join(f"{n} {ms:.3f} ms" for n, ms in busy["top"]))
    else:
        log("main path device trace: no device time recorded "
            "(idle share not measured)")
    return {"launches": launches, "rounds": rounds, "real_ops": real,
            "wall_s": wall, "raw": raw, "run": run,
            "served": _served(sidecar, doc_ids[:n_distinct])}


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

    def guarded(table, program, *donated):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(table, program, *donated)
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

    def compile_hook(arrays, base_head):
        program = compile_inner(arrays, base_head)
        suffix = program.get("suffix")
        real = 0 if suffix is None else int(_real(suffix["kind"]).sum())
        pending["real"] = real
        pending["rank"] = 0 if real == 0 else (
            2 if program["prefix"] is not None else 1)
        return program

    def apply_hook(table, program, dead=None):
        out = apply_inner(table, program, dead)
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


def run_route(route: str, raw: list, donate=None) -> dict:
    """One corpus through ``GpuMergeSidecar(executor=route,
    donate=donate)``: every document gets a stream (16 distinct,
    tiled), fed through ``ingest`` 8 messages per document per round,
    ``apply`` after each round. Returns the sidecar, its table (numpy)
    and the run's numbers."""
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.host_bridge import fetch
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    wrapped = [_wrap(s) for s in raw]
    sidecar = GpuMergeSidecar(
        max_docs=ROUTES_DOCS, capacity=ROUTES_CAPACITY,
        max_capacity=ROUTES_MAX_CAPACITY, executor=route, donate=donate,
        device="cuda")
    doc_ids = [f"doc-{d}" for d in range(ROUTES_DOCS)]
    for doc in doc_ids:
        sidecar.track(doc, "d", "s")
    guard = _guard_device_half(sidecar)
    # a donated run writes later rounds into the held input: hold none
    held = (_hold_suffix_dispatch(sidecar)
            if route == "egwalker" and not sidecar.donate else None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocs = _alloc_count()
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
        "allocs": _alloc_count() - allocs,
        "table": fetch(sidecar._table), "suffix_check": None,
    }
    if held is not None and held["rank"]:
        rec["suffix_check"] = _check_suffix(held, route)
    return rec


DONATION_CORPUS = "mixed"  # the config14 corpus the donation phase reruns


def phase_routes() -> dict:
    """Each config14 corpus through the three routes: every distinct
    stream equals the oracle, the macro-step routes' live state equals
    the scan route's, no document leaves the device path unless the
    scan's did, and the egwalker suffix launches the window kernel on
    the corpora that have one. Returns the macro-step routes' runs of
    ``DONATION_CORPUS``, the donation phase's runs with donation off."""
    from fluidframework_tpu_torch.testing.windows import live_difference

    undonated = {}
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
            if kind == DONATION_CORPUS and route != "scan":
                rec["served"] = _served(sidecar, rec["doc_ids"][:len(raw)])
                undonated[route] = rec
            del sidecar, rec
        if kind == "sequential":
            time_table_programs(scan["table"])
    return undonated


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

def phase_recovery(seed: int, donate: bool = False) -> None:
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
                              executor="scan", donate=donate, device="cuda")
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
    log(f"recovery: donate {donate}: capacity 16 -> {sidecar.capacity}, grows "
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


def phase_tree() -> list:
    """Both tree routes over the recorded corpus at 1024 documents:
    every document equals its stream's EditManager replay, the two
    routes' live tables are equal, the slab grows once (128 -> 256), no
    document leaves the device, and no host sync happens in a device
    half. Then CUDA-event times of one window step's programs. Returns
    the recorded corpus."""
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
    return recorded


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
    from fluidframework_tpu_torch.ops.merge_kernel import compiled_window
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
    cost = compiled_window(table, batch)[2]
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
        f"W={W}, all fields; that window's " + _bound_line(cost))
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
# matrix plane: bench config3 at full width

def _host_cells(keys: np.ndarray, space: int) -> np.ndarray:
    """The cells' LWW grid on the host: for every matrix and written
    cell the largest window index (the last write), -1 elsewhere."""
    M, N = keys.shape
    grid = np.full((M, space), -1, np.int64)
    valid = keys >= 0
    rows = np.broadcast_to(np.arange(M)[:, None], keys.shape)[valid]
    idx = np.broadcast_to(np.arange(N)[None, :], keys.shape)[valid]
    np.maximum.at(grid, (rows, keys[valid]), idx)
    return grid


def _host_matrix(ms, rows: list, cols: list) -> list:
    """One matrix materialized on the host: the axes' handle orders and
    a dict LWW of the cell writes in sequenced order."""
    cells = {}
    for rh, ch, v in zip(ms.cell_rows, ms.cell_cols, ms.cell_vals):
        cells[(rh, ch)] = v
    return [[cells.get((rh, ch)) for ch in cols] for rh in rows]


def phase_matrix() -> dict:
    """SharedMatrix at bench config3's full width: the axes of 64
    matrices as one 128-document window (B1), the cells as one LWW sort
    and scatter; held against the plain window, the host replay of
    every axis, a host LWW scatter and a host materialization of every
    matrix."""
    from fluidframework_tpu_torch.convert import batch_from_numpy
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.host_bridge import fetch
    from fluidframework_tpu_torch.ops.host_replay import replay_encoded
    from fluidframework_tpu_torch.ops.matrix_bridge import (
        _visible_handles, dispatch_matrix_batch, extract_matrix,
        pack_matrix_batch,
    )
    from fluidframework_tpu_torch.ops.matrix_cells import (
        CellPack, apply_cells_kernel,
    )
    from fluidframework_tpu_torch.ops.merge_kernel import apply_window
    from fluidframework_tpu_torch.ops.segment_table import make_table
    from fluidframework_tpu_torch.testing import record_matrix_streams

    t0 = time.perf_counter()
    cfg, streams = record_matrix_streams("full")
    record_s = time.perf_counter() - t0
    messages = cfg.matrices * (cfg.row_runs + cfg.cols + cfg.removes
                               + cfg.cells)
    op_count = sum(ms.op_count for ms in streams)
    space = cfg.rows * cfg.cols
    log(f"matrix: config3 full: {cfg.matrices} matrices x {cfg.rows} rows "
        f"({cfg.row_runs} runs of {cfg.run_len}) x {cfg.cols} cols, "
        f"{cfg.cells} cell writes and {cfg.removes} row removes each: "
        f"{messages} sequenced messages ({op_count} axis and cell ops); "
        f"axis table {2 * cfg.matrices} x {cfg.capacity}, cell grid "
        f"{cfg.matrices} x {cfg.rows} x {cfg.cols} int32 "
        f"({cfg.matrices * space * 4 / 1e6:.1f} MB); streams recorded in "
        f"{record_s:.3f} s (host)")

    # pack -> dispatch -> cells -> sync, three times
    gc.collect()
    cuda_merge.LAUNCHES = 0
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch = pack_matrix_batch(streams)
        cells = CellPack(cfg.rows, cfg.cols, device="cuda")
        cells.pack(streams)
        packed = time.perf_counter()
        table = dispatch_matrix_batch(batch, cfg.matrices, cfg.capacity,
                                      device="cuda")
        grid = cells.apply()
        torch.cuda.synchronize()
        runs.append((packed - t0, time.perf_counter() - t0))
    launches = cuda_merge.LAUNCHES
    if launches < 1:
        raise AssertionError("the matrix axes never launched merge_window")
    e2e = statistics.median(r[1] for r in runs)
    log(f"matrix: pack {[round(r[0], 3) for r in runs]} s (axis batch and "
        f"cell keys, host); end to end pack -> dispatch -> cells -> sync "
        f"{[round(r[1], 3) for r in runs]} s, median {e2e:.3f} s: "
        f"{cfg.matrices / e2e:.1f} matrices/s, {messages / e2e:.1f} "
        f"sequenced messages/s ({op_count / e2e:.1f} axis and cell ops/s); "
        f"merge_window launches {launches} in {len(runs)} runs")

    # the axes: B1 == plain on the card, every field
    axes = batch_from_numpy(batch, "cuda")
    D, W = axes.kind.shape
    empty = make_table(D, cfg.capacity, "cuda")
    where = f"matrix axes D={D} C={cfg.capacity} W={W}"
    want, err = _check_window(empty, axes, where)
    bad = [f for f, x, y in zip(want._fields, table, want)
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"dispatch output != plain at {where}: fields "
                             f"{bad}; " + _first_difference(table, want))
    np_table = fetch(table)
    if np_table["overflow"].any():
        raise AssertionError("config3 axis capacity overflow")

    # every axis against the host replay
    t0 = time.perf_counter()
    host_axes = [
        (_visible_handles(replay_encoded(ms.rows.ops).as_table(), 0,
                          ms.row_allocs),
         _visible_handles(replay_encoded(ms.cols.ops).as_table(), 0,
                          ms.col_allocs))
        for ms in streams]
    replay_s = time.perf_counter() - t0
    for m, (ms, (rows, cols)) in enumerate(zip(streams, host_axes)):
        if _visible_handles(np_table, 2 * m, ms.row_allocs) != rows:
            raise AssertionError(f"matrix {m}: row axis != host replay")
        if _visible_handles(np_table, 2 * m + 1, ms.col_allocs) != cols:
            raise AssertionError(f"matrix {m}: col axis != host replay")

    # every grid against a host LWW scatter, and every written cell's
    # value against a dict LWW
    got_grid = grid.cpu().numpy().reshape(cfg.matrices, space)
    want_grid = _host_cells(cells.keys, space)
    diff = np.argwhere(got_grid != want_grid)
    if diff.size:
        m, k = (int(i) for i in diff[0])
        raise AssertionError(
            f"cell grid != host LWW at matrix {m} cell {k}: device "
            f"{got_grid[m, k]}, host {want_grid[m, k]} ({len(diff)} differ)")
    grid_np = got_grid.reshape(cfg.matrices, cfg.rows, cfg.cols)
    for m, ms in enumerate(streams):
        lww = {}
        for rh, ch, v in zip(ms.cell_rows, ms.cell_cols, ms.cell_vals):
            lww[(rh, ch)] = v
        for (rh, ch), v in lww.items():
            if cells.lookup(grid_np, m, rh, ch) != v:
                raise AssertionError(f"matrix {m}: cell {rh},{ch} != LWW")

    # every matrix materialized against the host
    t0 = time.perf_counter()
    extracted = [extract_matrix(np_table, ms, m)
                 for m, ms in enumerate(streams)]
    extract_s = time.perf_counter() - t0
    for m, (ms, (rows, cols)) in enumerate(zip(streams, host_axes)):
        if extracted[m] != _host_matrix(ms, rows, cols):
            raise AssertionError(f"matrix {m}: extract_matrix != host")
    log(f"matrix: checks: kernel == plain on the axis batch D={D} "
        f"C={cfg.capacity} W={W} (all fields bit-exact, and the dispatch's "
        f"own output); all {cfg.matrices} matrices' row and col axes == "
        f"host_replay through _visible_handles (replay {replay_s:.3f} s, "
        f"host); every grid == the host LWW scatter "
        f"({int((want_grid >= 0).sum())} written cells, -1 elsewhere) and "
        f"every written cell's value == the dict LWW; extract_matrix of "
        f"every matrix ({sum(len(h[0]) for h in host_axes)} live rows in "
        f"all) == the host materialization; extract {extract_s:.3f} s for "
        f"{cfg.matrices} matrices (host)")

    # times: B1 on the axis batch, the cells' sort and scatter
    apply_window(empty, axes)
    b1 = _time_ms(lambda: apply_window(empty, axes), 5, 10)
    keys = torch.from_numpy(cells.keys).to("cuda")
    cells_ms, cells_dev, cells_events = _program_times(
        lambda: apply_cells_kernel(keys, cfg.rows, cfg.cols))
    floor_ms = ((keys.numel() + cfg.matrices * space) * 4 / HBM_BYTES_PER_S
                * 1e3)
    log(f"matrix: B1 on the axis batch D={D} C={cfg.capacity} W={W}: median "
        f"{statistics.median(b1):.4f} ms per launch (5 runs of 10 "
        f"back-to-back launches: {[round(t, 4) for t in b1]}), NOOP share "
        f"{_noop_share(axes):.4f}; apply_cells_kernel keys "
        f"{list(keys.shape)} -> grid {cfg.matrices} x {cfg.rows} x "
        f"{cfg.cols}: CUDA events median {cells_ms:.4f} ms per call, device "
        f"{cells_dev:.4f} ms and {cells_events:.1f} device events per call "
        f"(trace of 10 calls); bytes floor (keys read once, grid written "
        f"once) {floor_ms:.4f} ms")
    return {"launches": launches, "max_abs_err": err}


# ----------------------------------------------------------------------
# donation: the double buffer on and off

TWINS = ("apply_window_pingpong", "apply_window_chunked_pingpong",
         "apply_window_egwalker_pingpong")


def _storage(table) -> list:
    return [t.untyped_storage().data_ptr() for t in table]


def _watch_twins() -> dict:
    """Wrap the sidecar's donating twins: a call given a donated table
    must return a table on that table's storage, and the donated table
    must share none with the live input. Returns the counter of donated
    calls and the originals (``_unwatch_twins`` puts them back)."""
    from fluidframework_tpu_torch.service import gpu_sidecar

    seen = {"donated": 0, "inner": {}}
    for name in TWINS:
        inner = getattr(gpu_sidecar, name)
        seen["inner"][name] = inner

        def watched(dead, table, *args, _inner=inner, _name=name, **kw):
            if dead is not None and not set(_storage(dead)).isdisjoint(
                    _storage(table)):
                raise AssertionError(f"{_name}: the donated table aliases "
                                     "the live input")
            out = _inner(dead, table, *args, **kw)
            if dead is not None:
                if _storage(out) != _storage(dead):
                    raise AssertionError(f"{_name}: the output is not in "
                                         "the donated table's storage")
                seen["donated"] += 1
            return out

        setattr(gpu_sidecar, name, watched)
    return seen


def _unwatch_twins(seen: dict) -> None:
    from fluidframework_tpu_torch.service import gpu_sidecar

    for name, inner in seen["inner"].items():
        setattr(gpu_sidecar, name, inner)


def _same_served(a: dict, b: dict, what: str) -> None:
    bad = [f for f in a["table"]
           if not np.array_equal(a["table"][f], b["table"][f])]
    if bad:
        raise AssertionError(f"{what}: live tables differ in {bad}")
    for i, (x, y) in enumerate(zip(a["docs"], b["docs"])):
        if x != y:
            raise AssertionError(f"{what}: stream {i} text or signature "
                                 "differs")


def _donation_line(what: str, donate: bool, rec: dict, donated: int) -> str:
    busy = rec["busy"]
    return (f"donation: {what} donate {donate}: {rec['rounds']} rounds, wall "
            f"{rec['wall'] / rec['rounds'] * 1e3:.3f} ms per round (ingest "
            f"{rec['ingest_s'] / rec['rounds'] * 1e3:.3f} of it), device "
            f"{busy['total'] / rec['rounds']:.3f} ms and "
            f"{busy['events'] / rec['rounds']:.1f} events per round (trace), "
            f"peak device memory {rec['peak_mib']:.1f} MiB, allocator "
            f"requests {rec['allocs']} ({rec['allocs'] / rec['rounds']:.1f} "
            f"per round), donated dispatches {donated}, merge_window "
            f"launches {rec['launches']}")


def phase_donation(seed: int, main_rec: dict, undonated: dict) -> dict:
    """The main path (config2-full, scan) and config14's mixed corpus on
    each macro-step route with donation on, against their runs with
    donation off (the main phase's and the routes phase's,
    ``undonated``): equal live tables, texts and signatures, every
    donated output on the retired table's storage and none aliasing its
    live input; then the recovery phase's grow with donation on, and
    what a donated dispatch costs on the card."""
    from fluidframework_tpu_torch.ops.merge_kernel import (
        apply_window, apply_window_pingpong,
    )
    from fluidframework_tpu_torch.ops.segment_table import (
        copy_into, make_table,
    )
    from fluidframework_tpu_torch.testing import windows

    seen = _watch_twins()
    try:
        raw = main_rec["raw"]
        run = drive_config2(raw, donate=True)
        sidecar = run.pop("sidecar")
        _same_served(main_rec["served"],
                     _served(sidecar, run["doc_ids"][:len(raw)]),
                     "config2-full scan")
        donated = seen["donated"]
        if donated < 1:
            raise AssertionError("config2-full: no dispatch was donated")
        launches = run["launches"]
        del sidecar
        log(_donation_line("config2-full scan", False, main_rec["run"], 0))
        log(_donation_line("config2-full scan", True, run, donated)
            + f"; live table, {len(raw)} streams' text and signature == "
            "donate off")
        corpus = route_corpus(DONATION_CORPUS)
        for route in ("chunked", "egwalker"):
            before = seen["donated"]
            rec = run_route(route, corpus, donate=True)
            sidecar = rec.pop("sidecar")
            _check_docs(sidecar, [(rec["doc_ids"][i], corpus[i])
                                  for i in range(len(corpus))])
            _same_served(undonated[route]["served"],
                         _served(sidecar, rec["doc_ids"][:len(corpus)]),
                         f"config14 {DONATION_CORPUS} {route}")
            del sidecar
            donated = seen["donated"] - before
            if donated < 1:
                raise AssertionError(f"{route}: no dispatch was donated")
            what = f"config14 {DONATION_CORPUS} {route}"
            log(_donation_line(what, False, undonated[route], 0)
                + " (the routes phase's run)")
            log(_donation_line(what, True, rec, donated)
                + f"; live table, {len(corpus)} streams' text and "
                "signature == donate off, == oracle")
            launches += rec["launches"]
        phase_recovery(seed, donate=True)
    finally:
        _unwatch_twins(seen)

    # a donated window against a fresh output, in turns, and the copy a
    # macro-step twin adds per round
    rng = np.random.default_rng(seed + 2)
    table = windows.random_table(rng, MAIN_DOCS, MAIN_CAPACITY, "cuda")
    batch = windows.random_batch(rng, table, 64, "cuda")
    dead = make_table(MAIN_DOCS, MAIN_CAPACITY, "cuda")
    calls = {"fresh": lambda: apply_window(table, batch),
             "donated": lambda: apply_window_pingpong(dead, table, batch)}
    want = calls["fresh"]()
    got = calls["donated"]()
    torch.cuda.synchronize()
    if any(not torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("the donated window != the fresh one")
    times = {"fresh": [], "donated": []}
    for name in ("fresh", "donated", "donated", "fresh"):
        times[name] += _time_ms(calls[name], 3, 10)
    parts = [f"B1 at D={MAIN_DOCS} C={MAIN_CAPACITY} W=64 into a fresh "
             f"table median {statistics.median(times['fresh']):.4f} ms, "
             f"into the retired one (apply_window_pingpong) "
             f"{statistics.median(times['donated']):.4f} ms per launch "
             "(in turns fresh, donated, donated, fresh; 3 runs of 10 each)"]
    for docs, cap in ((ROUTES_DOCS, ROUTES_CAPACITY),
                      (MAIN_DOCS, MAIN_CAPACITY)):
        src = make_table(docs, cap, "cuda")
        dst = make_table(docs, cap, "cuda")
        ms = _time_ms(lambda: copy_into(dst, src), 5, 10)
        nbytes = 2 * sum(t.numel() for t in src) * 4
        parts.append(f"copy_into at D={docs} C={cap} median "
                     f"{statistics.median(ms):.4f} ms ({nbytes} bytes moved, "
                     f"floor {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    log("donation: " + "; ".join(parts))
    return {"launches": launches}


# ----------------------------------------------------------------------
# prewarm: the ladder walk, then traffic

PREWARM_MAX_CAPACITY = 8192  # the capacity ceiling (ROADMAP section C)
PREWARM_ROUNDS, PREWARM_ROUND = 6, 30  # within every 184+ stream


def phase_prewarm(raw: list) -> dict:
    """A sidecar at the main path's shape whose ladder tops at 8192:
    ``prewarm`` walks every capacity rung x window bucket (counted at
    the device half) and leaves the live table alone; then rounds of
    the main path's traffic, the first after the walk beside the steady
    ones, every stream's prefix == the oracle."""
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.bucket_ladder import BucketLadder
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    gc.collect()
    torch.cuda.empty_cache()
    sidecar = GpuMergeSidecar(
        max_docs=MAIN_DOCS, capacity=MAIN_CAPACITY,
        max_capacity=PREWARM_MAX_CAPACITY, executor="scan", device="cuda")
    live = sidecar._table
    walked = []
    inner = sidecar._apply_program

    def hook(table, program, dead=None):
        walked.append((table.capacity, program["scan"].kind.shape[-1]))
        return inner(table, program, dead)

    sidecar._apply_program = hook
    seconds = sidecar.prewarm()
    sidecar._apply_program = inner
    shapes = [(rung, bucket) for rung in BucketLadder.capacity_rungs(
                  MAIN_CAPACITY, PREWARM_MAX_CAPACITY)
              for bucket in sidecar.ladder.window_buckets()]
    if walked != shapes:
        raise AssertionError(f"prewarm walked {walked}, the ladder is "
                             f"{shapes}")
    if sidecar._table is not live or any(t.any() for t in (
            live.count, live.length, live.overflow)):
        raise AssertionError("prewarm touched the live table")

    wrapped = [_wrap(s) for s in raw]
    doc_ids = [f"doc-{d}" for d in range(MAIN_DOCS)]
    for doc in doc_ids:
        sidecar.track(doc, "d", "s")
    cuda_merge.LAUNCHES = 0
    walls = []
    for r in range(PREWARM_ROUNDS):
        lo, hi = r * PREWARM_ROUND, (r + 1) * PREWARM_ROUND
        for d, doc in enumerate(doc_ids):
            for msg in wrapped[d % len(raw)][lo:hi]:
                sidecar.ingest(doc, msg)
        t0 = time.perf_counter()
        sidecar.apply()
        sidecar.sync()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = cuda_merge.LAUNCHES
    if launches < 1:
        raise AssertionError("the prewarmed sidecar never launched "
                             "merge_window")
    n = PREWARM_ROUNDS * PREWARM_ROUND
    _check_docs(sidecar, [(doc_ids[i], raw[i][:n]) for i in range(len(raw))])
    rungs = len({c for c, _ in shapes})
    log(f"prewarm: route {sidecar.executor}, {MAIN_DOCS} docs, capacity "
        f"{MAIN_CAPACITY} -> max {PREWARM_MAX_CAPACITY}: {seconds:.3f} s for "
        f"{rungs} rungs x {len(shapes) // rungs} buckets = {len(shapes)} "
        f"shapes walked {shapes}, live table untouched; then "
        f"{PREWARM_ROUNDS} rounds of {PREWARM_ROUND} messages per document: "
        f"first round {walls[0] * 1e3:.3f} ms (apply + sync), median "
        f"steady round {statistics.median(walls[1:]) * 1e3:.3f} ms (rounds "
        f"{[round(w * 1e3, 3) for w in walls]} ms), merge_window launches "
        f"{launches}; {len(raw)} streams' first {n} messages == oracle")
    return {"launches": launches}


# ----------------------------------------------------------------------
# obs: the observability and protection hooks on the main path, and chaos

OBS_HOPS = ("sidecar:pack", "sidecar:settle")
OBS_CHAOS_SEED = 7


def _registry_line(prefixes: tuple) -> str:
    """The nonzero counters and gauges of the port's registry whose
    names start with ``prefixes``, as ``name{labels}=value``."""
    from fluidframework_tpu_torch.obs import REGISTRY

    flat = REGISTRY.flat()
    return ", ".join(f"{k}={v:g}" for k, v in sorted(flat.items())
                     if k.startswith(prefixes) and v and "_ms_" not in k)


def _guard_device_trace() -> dict:
    """Run every ``device_trace`` range of the merge sidecar (the device
    half of a dispatch, entry and exit included) with CUDA sync debugging
    set to "error": any host<->device sync in it raises. Returns the
    counter of guarded ranges; ``seen["restore"]()`` puts the hook
    back."""
    from fluidframework_tpu_torch.service import gpu_sidecar

    seen = {"calls": 0}
    inner = gpu_sidecar.device_trace

    @contextlib.contextmanager
    def guarded(name, device=None):
        torch.cuda.set_sync_debug_mode("error")
        try:
            with inner(name, device):
                yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
            seen["calls"] += 1

    gpu_sidecar.device_trace = guarded
    seen["restore"] = lambda: setattr(gpu_sidecar, "device_trace", inner)
    return seen


def _check_dispatch_trace(events: list, rounds: int, launches: int) -> str:
    """One ``sidecar:dispatch:r{n}`` range per round in the device trace,
    and every window-kernel launch inside one: its launch call (matched
    by correlation id) within a range on the host's timeline."""
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("sidecar:dispatch:r")]
    names = sorted(e["name"] for e in ranges)
    want = sorted(f"sidecar:dispatch:r{n}" for n in range(1, rounds + 1))
    if names != want:
        raise AssertionError(f"dispatch ranges {names[:8]}..., expected one "
                             f"per round: {want[:8]}...")
    launch_of = {e["args"]["correlation"]: e for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "merge_window" in e.get("name", "")]
    if len(kernels) != launches:
        raise AssertionError(f"{len(kernels)} window kernels in the trace, "
                             f"{launches} launches counted")
    for k in kernels:
        launch = launch_of.get(k.get("args", {}).get("correlation"))
        if launch is None:
            raise AssertionError(f"window kernel at ts {k['ts']}: the trace "
                                 "holds no launch call for it")
        if not any(r["ts"] <= launch["ts"] and launch["ts"] +
                   launch.get("dur", 0) <= r["ts"] + r["dur"]
                   for r in ranges):
            raise AssertionError(f"window kernel at ts {k['ts']}: its launch "
                                 f"call at ts {launch['ts']} lies outside "
                                 "every sidecar:dispatch range")
    return (f"{len(ranges)} sidecar:dispatch ranges (one per round); all "
            f"{len(kernels)} window kernels launched inside one")


def _obs_config2(main_rec: dict) -> dict:
    """config2-full with every hook on, under one device trace."""
    import os
    import tempfile

    from fluidframework_tpu_torch.obs import (
        REGISTRY, ContinuousProfiler, HeatLedger, profiler,
    )
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.bucket_ladder import ladder_bounds
    from fluidframework_tpu_torch.qos import CircuitBreaker
    from fluidframework_tpu_torch.service import gpu_sidecar
    from fluidframework_tpu_torch.testing import jitsan

    raw = main_rec["raw"]
    charges = []
    attribute = gpu_sidecar.attribute_round

    def counted(ledger, counts, round_ms, **kw):
        charged = attribute(ledger, counts, round_ms, **kw)
        charges.append((round_ms, charged, len(counts)))
        return charged

    gpu_sidecar.attribute_round = counted
    guard = _guard_device_trace()
    os.environ["FFTPU_DEVICE_TRACE"] = "1"
    heat = HeatLedger(max_keys=MAIN_DOCS)
    brk = CircuitBreaker("obs-dispatch")
    before = REGISTRY.flat()
    sampler = ContinuousProfiler()
    jitsan.install()
    try:
        with tempfile.TemporaryDirectory() as logdir:
            sampler.start()
            if not profiler.start_device_trace(logdir):
                raise AssertionError("the device trace did not start")
            run = drive_config2(raw, trace_ops=True, heat=heat, breaker=brk)
            if not profiler.stop_device_trace():
                raise AssertionError("the device trace did not stop")
            sampler.stop()
            with open(os.path.join(logdir, profiler.TRACE_FILE)) as f:
                events = json.load(f)["traceEvents"]
        counts = jitsan.compile_counts()
        builds = jitsan.nvcc_builds()
        jitsan.publish_compiles()
    finally:
        jitsan.uninstall()
        os.environ.pop("FFTPU_DEVICE_TRACE", None)
        guard["restore"]()
        gpu_sidecar.attribute_round = attribute
    sidecar = run.pop("sidecar")
    rounds = sidecar.stats["rounds"]
    _check_docs(sidecar, [(run["doc_ids"][i], raw[i])
                          for i in range(len(raw))])
    _same_served(main_rec["served"],
                 _served(sidecar, run["doc_ids"][:len(raw)]),
                 "config2-full with the hooks on")
    trace_line = _check_dispatch_trace(events, rounds, run["launches"])
    if guard["calls"] != rounds:
        raise AssertionError(f"{guard['calls']} guarded device halves in "
                             f"{rounds} rounds")
    delta = REGISTRY.delta(before)
    got = {k: delta.get(k, 0) for k in ("sidecar_rounds_total",
                                        "sidecar_real_ops_total",
                                        "sidecar_grow_total")}
    want = {"sidecar_rounds_total": rounds,
            "sidecar_real_ops_total": run["real"],
            "sidecar_grow_total": sidecar.grow_count}
    if got != want:
        raise AssertionError(f"registry {got} != the sidecar's {want}")
    if len(charges) != rounds:
        raise AssertionError(f"{len(charges)} rounds charged of {rounds}")
    for n, (ms, charged, docs) in enumerate(charges, 1):
        if abs(charged - ms) > 1e-9 * ms:
            raise AssertionError(f"round {n}: {charged!r} ms charged to "
                                 f"{docs} documents of {ms!r}")
    total = sum(heat.get(k) for k in heat.keys())
    round_ms = sum(ms for ms, _, _ in charges)
    if len(heat) != MAIN_DOCS or abs(total - round_ms) > 1e-9 * round_ms:
        raise AssertionError(f"heat over {len(heat)} documents, {total!r} "
                             f"of {round_ms!r} ms")
    tiles = MAIN_DOCS // len(raw)
    want_hops = [OBS_HOPS[0]] * tiles + [OBS_HOPS[1]] * tiles
    for s, stream in enumerate(run["wrapped"]):
        for i, msg in enumerate(stream):
            hops = [f"{t.service}:{t.action}" for t in msg.traces]
            if hops != want_hops:
                raise AssertionError(
                    f"stream {s} message {i}: hops {hops[:3]}... x "
                    f"{len(hops)}, expected pack then settle, once per "
                    f"document of its {tiles} tiles")
    bounds = ladder_bounds(16, 64, MAIN_CAPACITY, sidecar.max_capacity)
    over = {r: (counts[r], b) for r, b in bounds.items() if counts[r] > b}
    lib = cuda_merge.library_path()
    loaded = getattr(cuda_merge._lib, "_name", None)
    if over or counts["apply_window"] < 1 or set(builds) - {lib.name} or \
            any(n > 1 for n in builds.values()) or loaded != str(lib):
        raise AssertionError(f"jitsan: signatures over the ladder bounds "
                             f"{over}, window signatures "
                             f"{counts['apply_window']}, nvcc builds "
                             f"{builds} (at most one, of {lib.name}), "
                             f"loaded {loaded}")
    if brk.state != "closed" or sidecar.last_flight_dump is not None:
        raise AssertionError(f"breaker {brk.state}, a flight dump")
    run.update(rounds_checked=rounds, trace_line=trace_line,
               overhead=sampler.overhead_fraction, samples=sampler.samples,
               counts={r: n for r, n in counts.items() if n},
               builds=builds, top=heat.top_k(3),
               built=("built in this process" if builds
                      else "found built in the checkout"),
               guarded=guard["calls"])
    return run


def _chaos_merge() -> dict:
    """config14's mixed corpus at its width on the scan route, with a
    one-shot error_burst armed at sidecar.dispatch behind a breaker."""
    from fluidframework_tpu_torch.obs import REGISTRY
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.qos import (
        PLANE, CircuitBreaker, FaultSchedule, TransientFault,
    )
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    raw = route_corpus("mixed")
    wrapped = [_wrap(s) for s in raw]
    clock = {"t": 0.0}
    brk = CircuitBreaker("chaos-dispatch", failure_threshold=3,
                         reset_timeout_s=5.0, clock=lambda: clock["t"])
    moves = []
    inner = brk._transition

    def transition(to):
        if to != brk._state:
            moves.append(to)
        inner(to)

    brk._transition = transition
    sidecar = GpuMergeSidecar(
        max_docs=ROUTES_DOCS, capacity=ROUTES_CAPACITY,
        max_capacity=ROUTES_MAX_CAPACITY, executor="scan", breaker=brk,
        device="cuda")
    doc_ids = [f"chaos-{d}" for d in range(ROUTES_DOCS)]
    for doc in doc_ids:
        sidecar.track(doc, "d", "s")
    before = REGISTRY.flat()
    cuda_merge.LAUNCHES = 0
    faults, trips = 0, []
    schedule = FaultSchedule(OBS_CHAOS_SEED, max_per_site=1, rates={
        "sidecar.dispatch": {"error_burst": 1.0}})
    t0 = time.perf_counter()
    with PLANE.while_armed(schedule):
        for start in range(0, max(len(s) for s in wrapped), ROUTES_ROUND):
            for d, doc in enumerate(doc_ids):
                for msg in wrapped[d % len(raw)][start:start + ROUTES_ROUND]:
                    sidecar.ingest(doc, msg)
            opened = len([m for m in moves if m == "open"])
            try:
                sidecar.apply()
            except TransientFault:
                faults += 1
            if len([m for m in moves if m == "open"]) > opened:
                trips.append(sidecar.last_flight_dump)
            if brk.state == "open":
                clock["t"] += 10.0  # past the reset timeout
        fired = list(PLANE.fired)
    while sidecar.queued_ops:
        sidecar.apply()
    sidecar.sync()
    wall = time.perf_counter() - t0
    _check_docs(sidecar, [(doc_ids[i], raw[i]) for i in range(len(raw))])
    if moves != ["open", "half_open", "open", "half_open", "closed"]:
        raise AssertionError(f"breaker transitions {moves}")
    for dump in trips:
        if "circuit breaker 'chaos-dispatch' opened" not in dump or \
                "chaos[sidecar.dispatch]" not in dump:
            raise AssertionError(f"the flight dump does not name the "
                                 f"trip: {dump[:300]}")
    if len(trips) != 2 or sidecar.host_mode_docs():
        raise AssertionError(f"{len(trips)} trip dumps, "
                             f"{sidecar.host_mode_docs()} host docs")
    delta = REGISTRY.delta(before)
    return {"line": (
        f"sidecar.dispatch error_burst at config14 mixed {ROUTES_DOCS} x "
        f"{ROUTES_CAPACITY} (scan): injected {fired}, {faults} failed "
        f"dispatches (sidecar_dispatch_faults_total "
        f"{delta.get('sidecar_dispatch_faults_total', 0):g}); breaker "
        f"{' -> '.join(moves)} (the clock stepped past the reset timeout "
        f"after each trip); both "
        f"trip dumps name the breaker and the injected fault; "
        f"{sidecar.stats['rounds']} rounds, {len(raw)} streams == oracle "
        f"after the retries, wall {wall:.3f} s"),
        "launches": cuda_merge.LAUNCHES}


def _chaos_pool() -> str:
    """config10's viral member on a 4-shard MeshShardedPool (16 members
    per shard at capacity 128) with defers armed at sidecar.pool_dispatch
    and sidecar.pool_migrate: every member equals its oracle after the
    deferred tails land, and a migration still happens."""
    from fluidframework_tpu_torch.models.mergetree import MergeTreeClient
    from fluidframework_tpu_torch.obs import REGISTRY
    from fluidframework_tpu_torch.ops.host_bridge import (
        decode_stream, encode_stream, extract_text,
    )
    from fluidframework_tpu_torch.parallel import make_mesh
    from fluidframework_tpu_torch.qos import PLANE, FaultSchedule
    from fluidframework_tpu_torch.service.gpu_sidecar import select_pool
    from fluidframework_tpu_torch.testing import FuzzConfig, record_op_stream

    kmax = 4
    encs = [encode_stream(record_op_stream(FuzzConfig(
        n_clients=2, n_steps=MIG_STEPS, seed=4200 + i, insert_weight=0.55,
        remove_weight=0.25, annotate_weight=0.05, process_weight=0.15))[1])
        for i in range(MIG_MEMBERS * kmax)]
    devices = _shard_devices(kmax)
    pool = select_pool(make_mesh(devices), MIG_CAPACITY, route="mesh")
    n = MIG_MEMBERS * kmax - 1  # leaves one open row
    streams, fulls = _prefixed(encs, n, MIG_ROUNDS, MIG_OPS)
    pool.admit(list(range(n)), streams)
    before = REGISTRY.flat()
    schedule = FaultSchedule(OBS_CHAOS_SEED, rates={
        "sidecar.pool_dispatch": {"defer": 0.3},
        "sidecar.pool_migrate": {"defer": 0.5}})
    t0 = time.perf_counter()
    with PLANE.while_armed(schedule):
        for _ in range(2 * MIG_ROUNDS):
            _feed(streams[:1], fulls[:1], 2 * MIG_OPS)   # the viral member
            _feed(streams[1:], fulls[1:], 1)
            pool.dispatch_pending(streams)
        fired = list(PLANE.fired)
    pool.dispatch_pending(streams)  # the deferred tails land
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = REGISTRY.delta(before)
    defers = {k: len([f for f in fired if f[0] == k])
              for k in ("sidecar.pool_dispatch", "sidecar.pool_migrate")}
    if not all(defers.values()) or pool.migration_count == 0:
        raise AssertionError(f"defers {defers}, migrations "
                             f"{pool.migration_count}")
    fetched = pool.fetch()
    for slot in range(n):
        host = MergeTreeClient("oracle")
        host.start_collaboration("oracle")
        for msg in decode_stream(streams[slot]):
            host.apply_msg(msg)
        if pool.applied_upto[slot] != len(streams[slot].ops) or \
                extract_text(fetched, streams[slot], pool.row_of[slot]) \
                != host.get_text():
            raise AssertionError(f"config10 member {slot} != its oracle "
                                 "after the deferred dispatches")
    return (f"sidecar.pool_dispatch / pool_migrate defer on config10's "
            f"MeshShardedPool ({kmax} shards {[str(d) for d in devices]}, "
            f"{n} members at {MIG_CAPACITY}): {2 * MIG_ROUNDS} rounds, "
            f"deferred dispatches {defers['sidecar.pool_dispatch']}, "
            f"deferred migrations {defers['sidecar.pool_migrate']} "
            f"(pool_faults_total "
            + ", ".join(f"{k.split('{')[1][:-1]} {v:g}"
                        for k, v in sorted(delta.items())
                        if k.startswith("pool_faults_total"))
            + f"), {pool.dispatch_count} dispatches, "
            f"{pool.migration_count} migration(s); all {n} members == "
            f"oracle, wall {wall:.3f} s")


# authored rounds after the seeding prefix: the burst fails the first
# BURST_LENGTH dispatches, the next replays their backlog, and three
# rounds run after the recovery
OBS_TREE_ROUNDS = 7


def _chaos_tree(recorded: list) -> str:
    """The tree plane at tree-full's 1024 documents (macro) over the
    recorded corpus cut to its seeding prefix and OBS_TREE_ROUNDS
    authored rounds, with a one-shot error_burst armed at
    tree_sidecar.dispatch: every document equals its cut stream's
    EditManager replay after the retries."""
    from fluidframework_tpu_torch.qos import (
        PLANE, FaultSchedule, TransientFault,
    )
    from fluidframework_tpu_torch.qos.faults import BURST_LENGTH
    from fluidframework_tpu_torch.service import TreeSidecar

    cut = TREE_PREFIX + OBS_TREE_ROUNDS * TREE_ROUND
    streams = [stream[:cut] for _sig, stream in recorded]
    oracle = [_tree_replay(s) for s in streams]
    sidecar = TreeSidecar(max_docs=TREE_DOCS, capacity=TREE_CAPACITY,
                          max_capacity=TREE_MAX_CAPACITY, executor="macro",
                          device="cuda")
    doc_ids = [f"chaos-tree-{d}" for d in range(TREE_DOCS)]
    for doc in doc_ids:
        sidecar.track(doc, "d", "t")
    failed, after = 0, []
    bounds = [0] + list(range(TREE_PREFIX, cut, TREE_ROUND)) + [cut]
    schedule = FaultSchedule(OBS_CHAOS_SEED, max_per_site=1, rates={
        "tree_sidecar.dispatch": {"error_burst": 1.0}})
    t0 = time.perf_counter()
    with PLANE.while_armed(schedule):
        for start, stop in zip(bounds, bounds[1:]):
            for d, doc in enumerate(doc_ids):
                for msg in streams[d % len(streams)][start:stop]:
                    sidecar.ingest(doc, msg)
            rounds = sidecar.stats["rounds"]
            try:
                sidecar.apply()
            except TransientFault:
                failed += 1
                continue
            if failed:
                after.append(sidecar.stats["rounds"] - rounds)
        fired = list(PLANE.fired)
    while sidecar.queued_commits:
        sidecar.apply()
    sidecar.sync()
    wall = time.perf_counter() - t0
    if failed != BURST_LENGTH or len(after) < 4 or 0 in after:
        raise AssertionError(f"{failed} failed tree dispatches (the burst "
                             f"is {BURST_LENGTH}), rounds per apply after "
                             f"them {after}: the retry and at least three "
                             "rounds after it must each dispatch")
    for d, doc in enumerate(doc_ids):
        if sidecar.signature(doc, "d", "t") != oracle[d % len(streams)]:
            raise AssertionError(f"{doc} != its stream's EditManager "
                                 "replay after the retries")
    return (f"tree_sidecar.dispatch error_burst at tree-full's "
            f"{TREE_DOCS} docs (macro, streams cut to {cut} messages): "
            f"injected {fired}, {failed} failed dispatches, then "
            f"{len(after)} applies (the retry of the backlog and "
            f"{len(after) - 1} rounds after it) dispatching {after} rounds, "
            f"{sidecar.stats['rounds']} rounds in all, all {TREE_DOCS} "
            f"docs == EditManager replay after the retries, wall {wall:.3f} s")


def phase_obs(main_rec: dict, recorded: list) -> dict:
    """The observability and protection hooks: config2-full with every
    hook on (trace_ops, a heat ledger, a breaker, the device trace, the
    sanitizer, the host profiler) under one torch.profiler trace, held to
    the oracle and to the hooks-off run; then chaos at three seams."""
    log("obs: the registry after the earlier phases: " + _registry_line((
        "sidecar_", "pool_", "mesh_pool_", "tree_sidecar_", "tree_pool_",
        "heat_", "egwalker_")))
    t0 = time.perf_counter()
    run = _obs_config2(main_rec)
    obs_s = time.perf_counter() - t0
    log(f"obs: config2-full with the hooks on (trace_ops, heat, breaker, "
        f"FFTPU_DEVICE_TRACE=1, jitsan, ContinuousProfiler, one "
        f"torch.profiler trace of CPU and CUDA): {run['rounds']} rounds, "
        f"{run['real']} real ops, wall {run['wall']:.3f} s against the "
        f"main phase's hooks-off {main_rec['wall_s']:.3f} s "
        f"({run['wall'] / main_rec['wall_s']:.3f}x; ingest "
        f"{run['ingest_s']:.3f} s), {run['real'] / run['wall']:.1f} ops/s; "
        f"host profiler {run['samples']} samples, overhead_fraction "
        f"{run['overhead']:.6f}; {len(main_rec['raw'])} streams == oracle, "
        f"live table and served texts and signatures == the hooks-off run; "
        f"{run['trace_line']}; registry rounds / ops / grows == the "
        f"sidecar's; attribute_round conserved every round's ms over "
        f"{MAIN_DOCS} documents (top {run['top']}); every message "
        f"sidecar:pack then sidecar:settle, once per tile; jitsan launch "
        f"signatures {run['counts']} within the ladder bounds, nvcc "
        f"builds {run['builds']} (at most one: the library was "
        f"{run['built']}); device half under sync debug 'error' in "
        f"{run['guarded']} dispatches, device_trace inside the guard; "
        f"{time.perf_counter() - t0 - run['wall']:.3f} s of checks")
    chaos = _chaos_merge()
    log("obs: chaos: " + chaos["line"])
    log("obs: chaos: " + _chaos_pool())
    log("obs: chaos: " + _chaos_tree(recorded))
    log(f"obs: phase wall {time.perf_counter() - t0:.3f} s (config2 with "
        f"hooks {obs_s:.3f} s)")
    return {"launches": run["launches"] + chaos["launches"]}


# ----------------------------------------------------------------------
# times at the main path's shape

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
    from fluidframework_tpu_torch.ops.window_cost import real_ops

    return real_ops(kind)


def _noop_share(batch) -> float:
    return float(1.0 - _real(batch.kind).float().mean())


def phase_time(seed: int) -> dict:
    from fluidframework_tpu_torch.ops.merge_kernel import (
        apply_window, apply_window_plain, compiled_window,
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
    # the work this run's data needs: the live slots of the real steps
    # (the package's reckoning, compiled_window's cost)
    _, _, cost = compiled_window(table, batch)
    bytes_ms = cost.nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = cost.live_ops / INT32_OPS_PER_S * 1e3
    # the plain version's count, every slot of every step
    plain_ops_ms = cost.ops / INT32_OPS_PER_S * 1e3
    rec["plain_ms"] = statistics.median(plain)
    rec["bound_ms"], rec["bound_by"] = cost.bound_ms(HBM_BYTES_PER_S,
                                                     INT32_OPS_PER_S)
    log(f"times at D={D} C={C} W={W}: kernel median {rec['ms']:.4f} ms, "
        f"plain version median {rec['plain_ms']:.4f} ms (the plain torch "
        f"loop, not a yardstick); bound {rec['bound_ms']:.4f} ms by "
        f"{rec['bound_by']} (bytes {cost.nbytes} -> {bytes_ms:.4f} ms; "
        f"int32 ops {cost.live_ops} = {cost.ops_per_slot_step}/slot-step "
        f"over {cost.live_slot_steps} live slot-steps of real steps, "
        f"{cost.live_slot_steps / cost.slot_steps:.4f} of D*C*W -> "
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
            f"{_noop_share(batch):.4f}; "
            + _bound_line(compiled_window(table, batch)[2],
                          statistics.median(kernel)))
    return rec


def _bound_line(cost, ms=None) -> str:
    """A window's bound over its live slot-steps and over every slot, from
    the package's reckoning, beside the kernel's time ``ms``."""
    live_ms, live_by = cost.bound_ms(HBM_BYTES_PER_S, INT32_OPS_PER_S)
    all_ms, all_by = cost.bound_ms(HBM_BYTES_PER_S, INT32_OPS_PER_S,
                                   live=False)
    at = "" if ms is None else (f", kernel at {live_ms / ms:.4f} / "
                                f"{all_ms / ms:.4f} of them")
    return (f"bound {live_ms:.4f} ms by {live_by} over "
            f"{cost.live_slot_steps} live slot-steps "
            f"({cost.live_slot_steps / cost.slot_steps:.4f} of D*C*W), "
            f"{all_ms:.4f} ms by {all_by} over every slot{at}")


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
        walls = [("start", time.perf_counter())]

        def mark(name):
            walls.append((name, time.perf_counter()))

        worst = phase_kernel(args.seed)
        mark("kernel")
        main_rec = phase_main(args.seed)
        mark("main")
        undonated = phase_routes()
        mark("routes")
        phase_recovery(args.seed)
        mark("recovery")
        recorded = phase_tree()
        mark("tree")
        pool_rec = phase_pool(args.seed)
        mark("pool")
        matrix_rec = phase_matrix()
        mark("matrix")
        donation_rec = phase_donation(args.seed, main_rec, undonated)
        mark("donation")
        prewarm_rec = phase_prewarm(main_rec["raw"])
        mark("prewarm")
        obs_rec = phase_obs(main_rec, recorded)
        mark("obs")
        time_rec = phase_time(args.seed)
        mark("times")
        log("phase walls: " + ", ".join(
            f"{name} {t - walls[i][1]:.3f} s"
            for i, (name, t) in enumerate(walls[1:])))
        worst = max(worst, time_rec.pop("max_abs_err"),
                    pool_rec["max_abs_err"], matrix_rec["max_abs_err"])
        paths = {"main path": main_rec["launches"],
                 "matrix": matrix_rec["launches"],
                 "donated runs": donation_rec["launches"],
                 "prewarmed rounds": prewarm_rec["launches"],
                 "obs runs": obs_rec["launches"]}
    except Exception:  # noqa: BLE001 - report any failed phase, exit 1
        traceback.print_exc()
        log("FAIL")
        return 1
    log("merge_window launches on the driven paths: "
        + ", ".join(f"{k} {v}" for k, v in paths.items()))
    log(json.dumps({"kernels": [{
        "name": "merge_window",
        "route": "cuda",
        "source": "fluidframework_tpu_torch/ops/csrc/merge_window.cu",
        "replaces": "fluidframework_tpu/ops/pallas_merge.py:58",
        "launches": sum(paths.values()),
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
