"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the Hopper window kernel from the sources in this checkout, holds
it bit for bit against its plain torch version on the card, drives the
SharedString merge plane end to end through ``GpuMergeSidecar`` at the
full width of bench config2 (4096 documents x capacity 1024, bench's
own corpus: 16 streams of 4 clients x 220 steps, every fourth a
webflow-mix stream of tag-pair markers) and checks every distinct stream
against the scalar ``MergeTreeClient`` oracle, runs the reference's
adversarial fuzz (four storms over every seed of their sweeps and five
directed merge-tree scenarios) through the kernel against its plain
version and the oracle, drives the three executor routes
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
and 4 shards and its viral-member migration, on bench's corpus; the sequence-sharded
window at 64 x 4096 x 64 on 2 and 4 shards against the kernel; a
2-shard ``SeqShardedPool`` serving 4 long documents), drives the
SharedMatrix plane at bench config3's full width (64 matrices of 10250
rows x 16 cols: the axes as one 128 x 1024 window of the kernel, the
cells as one LWW sort and scatter) against the host replay, a host LWW
and a host materialization of every matrix, runs the main path and
config14's mixed corpus on both macro-step routes with the donated
double buffer on and off, walks ``prewarm``'s capacity x window ladder
at the main path's shape (these and the obs phase rerun the main path's
corpus), reruns the main path with every observability
and protection hook on under one torch.profiler trace and drives chaos
at the merge sidecar's, a mesh pool's and the tree sidecar's seams,
serves a live collaborative session through the port's own
``LocalServer``, local driver and ``Container``s into
``GpuMergeSidecar`` (1024 documents x 2 writers x 4 rounds of 8 edits,
a ``SummaryManager`` on every writer, a ``GarbageCollector`` on every
runtime, an ``OpStreamAttributor`` on writer B, late joins from the
elected writer's summary), serves the same traffic live
over TCP through the port's ``AlfredServer`` (tenancy, qos admission,
the SLO engine, the heat ledger) and multiplexed socket drivers into
``GpuMergeSidecar``, starts ``python -m fluidframework_tpu_torch.service``
and asks its ``--dump-metrics`` and ``--dump-slo``, runs the open-loop
``tools/serve_bench`` at bench config9's full width with its sidecar on
the card and the heat plane's per-tenant rollup on, drives the DDS
catalogue live through the port's own
``LocalServer`` and ``Container``s (bench config3's matrices authored
through real SharedMatrix channels into the matrix plane; bench
config17's corpus through real SharedTree channels into the tree plane
on both routes, served live and tiled to 1024 documents; every channel
type of the registry in one datastore of 128 documents, the string and
tree channels routed to their planes, late joiners after a summarize),
serves 1024 documents made through the framework's
``LocalServiceClient`` to two editors each (rich text with undo/redo,
webflow) into ``GpuMergeSidecar``, serves the service traffic through
the partitioned ordering service (``PartitionedServer``, 4 partitions:
the in-memory queue; the fsynced file queue with two partitions paused
and resumed from their committed offsets mid-run, the sidecar
re-attached and dropping the replayed duplicates; 64 documents through
a ``BrokerServer`` over TCP) and through the replicated sequencer
(``ReplicatedSequencerGroup``, quorum 2 of 3, the leader killed and a
follower promoted mid-run, the sidecar re-attached and held against a
shadow fed the new leader's logs), replays bench config5 at its full
width through the array lane (16384 documents x 4 clients, one native
``MultiDocSequencer.ticket_boxcar`` call and one kernel dispatch per
round; the C++ host tier and scalar replayer beside it), runs bench
config11-13's chaos storms and the reference's three 20-seed chaos
sweeps through the port's chaos harness with ``GpuMergeSidecar`` on
the card (failsan accounting every fault of config11's and config13's
storms), runs the port's runtime sanitizers over a chaos sweep and a
serve_bench slice on the card against the port's static fluidlint
families, replays the service cell's 1024 recorded documents and 16
documents fetched over TCP through the port's tools (``replay_tool``,
``fluid_runner``, ``fetch_tool``) into ``GpuMergeSidecar``, times that
round with ``tools.benchmark``, runs ``tools.net_stress`` and the two
examples that build a merge sidecar (``heat_dump``, ``op_trace``) on
the card, and times the kernel beside its plain version.

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
the device half) and one line per chaos run. The "service:" line holds
the session's edits and sequenced messages, its edits per wall second,
the host's seconds split into client, orderer, sidecar ingest and
apply, the B1 launches, the device's busy time and idle share over the
last two rounds, grows and evictions, and the checks (every document
== both writers == its op log's scalar replay, late joins, one dispatch
kernel == plain, no host sync in the device half). The "ingress:" line
holds the same for the TCP session, with the host's seconds over all
threads split into client, ingress dispatch, orderer, sidecar ingest
and apply, and the metrics, slo and heat frames' checks; the "ingress
CLI:" line the service subprocess and its dump commands. Each "serve"
line holds one open-loop run (offered, acked and shed ops, latency,
backlog, pressure tier, the sidecar's round times on the card, the SLO
verdicts); the "serve:" line the checks and the profiler's overhead.
Each "dds:" line holds one leg (matrix; tree live and each tiled route;
mixed): documents, edits or commits and sequenced messages, the rate,
the host's seconds split into client (authoring, flush, delivery),
orderer and sidecar or bridge ingest, pack seconds, B1 launches, the
device's busy time, B1's share of it and idle share over a trace of
the leg, and the checks. The "fuzz:" line holds each batch's shape and
the checks; the "framework:" line the documents, workload steps and
sequenced messages, the undo / redo counts, the comments skipped (an
interval op into a merge sidecar raises in both packages), steps per
wall second, the host split, the device trace and the checks. The
"fsync:" line holds the temp directory's fsync latency; each
"partitioned" line one queue (edits/s, the host split into client,
produce, pump and sidecar, B1 launches, the device trace, the resume's
redelivered records and dropped duplicates, the checks); the
"replicated:" line the failover (its phases, edits/s before and after,
quorum waits, the host split with the quorum barrier, the checks).
The "config5" line (with the card's name and power limit) holds the
pipeline's ops/s (best of two passes), the synced pass's round p50 /
p99 and host ms per round (ticket, scatters, upload, dispatch), B1's
time and live bound per round, the device's idle share, the chip
machine's CPU on the C++ host tier and scalar replayer, and the checks
(no overflow, every document == its tile's first document on the
device, checksums == the host tier, text == the oracle, B1 == plain on
the first round's window). The "chaos" line (with the card) holds each
storm (goodput, recovery, failover or netsplit times, faults per site,
its runs equal on the card and on the CPU), each sweep (every seed ==
the fault-free oracle, tiers, faults per site) and each leg's B1
launches, wall and fsync share, and failsan's fault-to-signal
accounting on config11's and config13's storms. The "sanitizers" line
(with the card) holds fluidsan, detsan, wiresan and jitsan over a chaos
sweep and a serve_bench slice with the sidecar on the card: trips (none),
the runtime lock edges, un-routed clock sites and frame fields beside
the port's static families' graph, findings and schema, B1's launches,
and the static run's and the phase's walls. The "tools" line (with the
card) holds each leg: the recorded documents (edits, ops replayed and
the checkpointed replays' ops/s, the session's, save's and replay
passes' seconds, the sidecar's applied ops, the harness's iterations
and p50 / p95 / mean of the apply + sync round), the fetched documents
(ops fetched and the fetch's seconds, replay ops/s), net_stress
(workers, converged length, wall), each example's B1 launches and wall,
and the checks (every replay, validation, export and served text ==
the live writers', every served signature == its log's scalar replay,
each leg's first dispatch == plain); the "tools harness" lines before
it are ``BenchmarkReporter.render_table()`` and ``render_json()``.
The times lines cover the
window rungs 16 / 32 / 64 at the main shape, the capacities 4096 and
8192 and the long-document pool's 16 x 8192 x 32 (the cluster form
above capacity 4096: its shape and resident clusters print after the
ptxas lines), with the NOOP share, the time per real step and the bound
of each timed batch. Every phase
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
import importlib
import json
import math
import random
import statistics
import subprocess
import sys
import threading
import time
import traceback
import types

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
    (64, 4096, 64),       # edge of the one-block form
    (4, 4097, 16),        # the cluster form's first capacity
    (3, 5001, 16),        # ragged cluster form: a partial last span
    (16, 8192, 32),       # the cluster form at the pool's window
]
NOOP_SHAPES = ((64, 1024, 16), (16, 8192, 16))  # windows only of NOOPs
# (docs, capacity, window) of the cluster form's span-boundary windows
# (testing/windows.span_window): every lookup on the slots around each
# span boundary, a document filled to capacity; then one whose documents
# all fill and overflow
SPAN_SHAPES = ((16, 8192, 32), (64, 8192, 64))
SPAN_OVERFLOW_SHAPE = (8, 8192, 32)
TIME_WINDOWS = (16, 32, 64)  # the main path's window rungs
TIME_WIDE = ((1024, 4096, 64), (512, 8192, 64),  # (docs, capacity,
              (16, 8192, 32))  # window); the last, the long-doc pool's


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

    for docs, cap, window in NOOP_SHAPES:
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
    return max(worst, _span_windows(rng))


def _span_windows(rng) -> int:
    """The cluster form's span-boundary windows, kernel against plain on
    every field; the last shape's documents must all end overflowed."""
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.testing import windows

    worst = 0
    for docs, cap, window in SPAN_SHAPES + (SPAN_OVERFLOW_SHAPE,):
        over = docs if (docs, cap, window) == SPAN_OVERFLOW_SHAPE else 0
        span = cuda_merge.cluster_span(cap)
        table, batch = windows.span_window(
            rng, docs, cap, window, span, "cuda", fill_docs=1 - bool(over),
            overflow_docs=over)
        want, err = _check_window(
            table, batch, f"D={docs} C={cap} W={window} (span boundaries)")
        worst = max(worst, err)
        ended = want.count.cpu()
        if over and int(want.overflow.sum()) != docs:
            raise AssertionError(f"{docs - int(want.overflow.sum())} "
                                 f"documents of the overflow window did "
                                 f"not overflow")
        if not over and int((ended == cap).sum()) < 1:
            raise AssertionError("no document of the span window filled")
        log(f"kernel == plain  D={docs} C={cap} W={window} span boundaries "
            f"every {span} slots (insert target and both splits on slots "
            f"span-2 .. span+1 of each; documents full at the end "
            f"{int((ended == cap).sum())}, overflowed "
            f"{int(want.overflow.sum())}; all fields bit-exact)")
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


def bench_streams(n_streams: int, steps: int, clients: int,
                  seed0: int) -> list:
    """bench.py's corpus (``_build_streams``, bench.py:111-139), the raw
    recorded streams: stream ``i`` is a webflow-mix stream
    (``record_flow_stream``: tag-pair markers with ``pairId`` props,
    pair-consistent removes, css token-list annotates, block markers)
    when ``i % 4 == 3``, else the fuzz mix at bench's weights (insert
    0.55, remove 0.25, annotate 0.05, process 0.15); seeds ``seed0 +
    i``."""
    from fluidframework_tpu_torch.testing import (
        FuzzConfig, record_flow_stream, record_op_stream,
    )

    return [record_flow_stream(seed=seed0 + i, n_clients=clients,
                               n_steps=steps)[1] if i % 4 == 3
            else record_op_stream(FuzzConfig(
                n_clients=clients, n_steps=steps, seed=seed0 + i,
                insert_weight=0.55, remove_weight=0.25,
                annotate_weight=0.05, process_weight=0.15))[1]
            for i in range(n_streams)]


def config2_corpus(seed: int) -> list:
    """The main path's 16 distinct streams: bench config2's corpus
    (``_build_streams(16, 220, 4, seed0=31337)``, bench.py:672-674) at
    ``--seed 0``, its seeds moved by 1000 per seed otherwise."""
    return bench_streams(16, 220, 4, 31337 + 1000 * seed)


def _flow_line(raw: list) -> str:
    """The flow streams' (every fourth) marker share of their ops and
    the property keys the corpus uses."""
    from fluidframework_tpu_torch.ops.host_bridge import encode_stream
    from fluidframework_tpu_torch.protocol.messages import MessageType

    ops = markers = 0
    for stream in raw[3::4]:
        for msg in stream:
            if msg.type == MessageType.OPERATION:
                ops += 1
                markers += getattr(msg.contents, "marker", None) is not None
    keys = sorted({k for stream in raw
                   for k in encode_stream(stream).prop_keys})
    return (f"{len(raw[3::4])} flow streams (every fourth): {markers} of "
            f"{ops} ops insert a marker ({markers / ops:.4f}); property "
            f"keys of the corpus {keys}")


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
    log(f"main path corpus: bench config2's, {_flow_line(raw)}")
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


# ----------------------------------------------------------------------
# fuzz: the main path's adversarial fuzz (the reference's
# tests/test_adversarial_fuzz.py:78-194) through B1 on the card

# (name, seeds, stream seed = base + seed * step, FuzzConfig fields)
FUZZ_STORMS = (
    ("eight clients, deep concurrency", 40, 10_000, 13, dict(
        n_clients=8, n_steps=220, insert_weight=0.45, remove_weight=0.3,
        annotate_weight=0.1, process_weight=0.15)),
    ("overlap-remove storm", 30, 20_000, 7, dict(
        n_clients=6, n_steps=200, insert_weight=0.3, remove_weight=0.55,
        annotate_weight=0.05, process_weight=0.1)),
    ("annotate storm with insert props", 30, 30_000, 11, dict(
        n_clients=5, n_steps=200, insert_weight=0.35, remove_weight=0.15,
        annotate_weight=0.35, process_weight=0.15,
        insert_props_weight=0.5)),
    ("msn-boundary churn", 20, 40_000, 3, dict(
        n_clients=4, n_steps=250, insert_weight=0.4, remove_weight=0.25,
        annotate_weight=0.05, process_weight=0.3)),
)
# the directed scenarios, clients A, B, C; None is a process_all
FUZZ_DIRECTED = (
    ("same-position insert storm", (
        ("A", "insert_text_local", 0, "a1"), ("B", "insert_text_local", 0,
                                              "b1"),
        ("C", "insert_text_local", 0, "c1"), None,
        ("A", "insert_text_local", 0, "a2"), ("B", "insert_text_local", 0,
                                              "b2"),
        ("C", "insert_text_local", 0, "c2"), None)),
    ("overlapping removes with an interleaved insert", (
        ("A", "insert_text_local", 0, "0123456789"), None,
        ("A", "remove_range_local", 2, 8), ("B", "remove_range_local", 4,
                                            10),
        ("C", "insert_text_local", 5, "XYZ"), None)),
    ("annotate vs a concurrent remove", (
        ("A", "insert_text_local", 0, "hello world"), None,
        ("A", "annotate_range_local", 0, 11, {"bold": 1}),
        ("B", "remove_range_local", 5, 11), None)),
    ("insert at the zamboni boundary", (
        ("A", "insert_text_local", 0, "abcdef"), None,
        ("A", "remove_range_local", 0, 3), None,
        ("B", "insert_text_local", 0, "B"), ("C", "insert_text_local", 3,
                                             "C"), None)),
    ("remove, then a same-spot insert race", (
        ("A", "insert_text_local", 0, "0123456789"), None,
        ("A", "remove_range_local", 3, 7), ("B", "insert_text_local", 5,
                                            "!!"),
        ("C", "remove_range_local", 6, 9), None)),
)
FUZZ_CAPACITY = 1024  # the reference test's table


def _directed_stream(steps) -> list:
    from fluidframework_tpu_torch.testing import MockCollabSession

    log_msgs = []
    session = MockCollabSession(["A", "B", "C"], stream_log=log_msgs)
    for step in steps:
        if step is None:
            session.process_all()
        else:
            session.do(*step)
    session.assert_converged()
    return log_msgs


def _fuzz_batch(streams: list, what: str) -> tuple:
    """One batch of ``streams`` (a document each) through B1 on the card:
    every field == the plain version, every document's text and interned
    signature == its ``MergeTreeClient`` oracle. Returns B1's launches
    and the window."""
    from fluidframework_tpu_torch.convert import batch_from_numpy
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.host_bridge import (
        build_batch, encode_stream, extract_signature, extract_text, fetch,
    )
    from fluidframework_tpu_torch.ops.merge_kernel import (
        apply_window, apply_window_plain,
    )
    from fluidframework_tpu_torch.ops.segment_table import make_table

    encs = [encode_stream(s) for s in streams]
    batch = batch_from_numpy(build_batch(encs), "cuda")
    table = make_table(len(encs), FUZZ_CAPACITY, "cuda")
    before = cuda_merge.LAUNCHES
    got = apply_window(table, batch)
    launches = cuda_merge.LAUNCHES - before
    want = apply_window_plain(table, batch)
    torch.cuda.synchronize()
    bad = [f for f, x, y in zip(want._fields, got, want)
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"fuzz {what}: kernel != plain at {bad}; "
                             + _first_difference(got, want))
    err = max_abs_err(got, want)
    table_np = fetch(got)
    if table_np["overflow"].any():
        raise AssertionError(f"fuzz {what}: a document overflowed")
    for d, (stream, enc) in enumerate(zip(streams, encs)):
        if (extract_text(table_np, enc, d),
                extract_signature(table_np, enc, d)) != _oracle(stream):
            raise AssertionError(f"fuzz {what}: document {d} differs from "
                                 f"its oracle")
    return launches, batch.kind.shape[1], err


def phase_fuzz() -> dict:
    """The four adversarial storms over every seed of the reference's
    sweeps (120 streams) and the five directed merge-tree scenarios, one
    B1 batch each, held to the plain version and the oracle."""
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.testing import FuzzConfig, record_op_stream

    t0 = time.perf_counter()
    cuda_merge.LAUNCHES = 0
    launches, worst, lines = 0, 0, []
    for name, seeds, base, step, fields in FUZZ_STORMS:
        streams = [record_op_stream(FuzzConfig(
            seed=base + s * step, **fields))[1] for s in range(seeds)]
        n, window, err = _fuzz_batch(streams, name)
        launches, worst = launches + n, max(worst, err)
        lines.append(f"{name} {seeds} x {FUZZ_CAPACITY} x {window}")
    streams = [_directed_stream(steps) for _, steps in FUZZ_DIRECTED]
    n, window, err = _fuzz_batch(streams, "directed scenarios")
    launches, worst = launches + n, max(worst, err)
    lines.append(f"directed {len(streams)} x {FUZZ_CAPACITY} x {window}")
    if launches != len(FUZZ_STORMS) + 1:
        raise AssertionError(f"fuzz: B1 launches {launches}")
    log(f"fuzz: the reference's adversarial fuzz on the card, one B1 batch "
        f"each ({'; '.join(lines)}): "
        f"{sum(s for _, s, _, _, _ in FUZZ_STORMS)} storm streams and "
        f"{len(FUZZ_DIRECTED)} directed scenarios ("
        + ", ".join(n for n, _ in FUZZ_DIRECTED)
        + f"); every batch's B1 output == the plain version's, every "
        f"field; every document's text and interned signature == its "
        f"MergeTreeClient oracle; no overflow; B1 launches {launches}; "
        f"wall {time.perf_counter() - t0:.3f} s")
    return {"launches": launches, "max_abs_err": worst}


def _device_busy_ms(prof) -> dict:
    """Device time of a CUDA-only profiler trace: the total, the number
    of device events (kernel launches and copies), the five largest
    event names and the time of every name."""
    by_name, events = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
            events += e.count
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"total": sum(by_name.values()), "events": events,
            "top": [(n[:60], ms) for n, ms in top], "by_name": by_name}


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


def _check_tree_run(sidecar, rec, recorded, route) -> None:
    """``run_tree``'s checks: every tile (``_check_tree_tiles``), no
    document on the host, no ring eviction, one grow (128 -> 256) and no
    overflow."""
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
        _check_tree_run(sidecar, rec, recorded, route)
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
    # B1 at the pool's capacity: the cluster form's kernel
    b1 = [(e.self_device_time_total / 1e3, e.count)
          for e in prof.key_averages()
          if "merge_window_cluster_kernel" in e.key]
    b1_ms, b1_n = sum(ms for ms, _ in b1), sum(n for _, n in b1)
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
        + f"; B1 at C={pool.capacity} (the cluster form) {b1_ms:.3f} ms "
        f"of device busy in {b1_n} launches; all {POOL_DOCS} docs == "
        f"oracle ({check_s:.3f} s); pool "
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

    kmax = 4
    # bench config10's corpus (bench.py:1922-1923), its flow quarter too
    raw = bench_streams(MIG_MEMBERS * kmax, MIG_STEPS, 2, 4200)
    encs = [encode_stream(stream) for stream in raw]
    rates, launches = [], 0
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
        launches += cuda_merge.LAUNCHES
        rates.append(f"{k} shard{'s' if k > 1 else ''} "
                     f"{[str(d) for d in devices]}: {n} members, {done} "
                     f"rounds in {wall:.3f} s, {done / wall:.1f} rounds/s "
                     f"({n * done / wall:.1f} member-rounds/s), merge_window "
                     f"launches {cuda_merge.LAUNCHES}")
    shared = len(set(devices)) < kmax
    log(f"pool: config10 mesh pool at capacity {MIG_CAPACITY}, "
        f"{MIG_OPS} ops per member per round, {MIG_STEPS}-step two-client "
        f"streams (bench's corpus: {_flow_line(raw)}): " + "; ".join(rates)
        + ("; same-device shards (one card), not a scaling figure"
           if shared else ""))

    n_par = MIG_MEMBERS * kmax - 1  # leaves one open row
    pool = select_pool(make_mesh(devices), MIG_CAPACITY, route="mesh")
    oracle = select_pool(make_mesh(devices[:1]), MIG_CAPACITY, route="mesh")
    streams, fulls = _prefixed(encs, n_par, MIG_ROUNDS, MIG_OPS)
    cuda_merge.LAUNCHES = 0
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
    launches += cuda_merge.LAUNCHES
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
        f"members == the one-shard pool == the oracle; B1 launches of "
        f"config10's runs {launches}")
    return pool, launches


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
    pool, rec["config10_launches"] = phase_pool_migration()
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
    from fluidframework_tpu_torch.protocol.messages import MessageType
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
            # the recording sequencer stamped its ticket on each op
            ticket = (["sequencer:ticket"]
                      if msg.type == MessageType.OPERATION else [])
            if hops != ticket + want_hops:
                raise AssertionError(
                    f"stream {s} message {i}: hops {hops[:3]}... x "
                    f"{len(hops)}, expected the ticket (ops), then pack "
                    f"then settle, once per document of its {tiles} tiles")
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
# service: a real collaborative session through the port's own
# LocalServer and Containers into GpuMergeSidecar

SERVICE_DOCS, SERVICE_CAPACITY, SERVICE_MAX_CAPACITY = 1024, 512, 8192
SERVICE_WRITERS, SERVICE_ROUNDS, SERVICE_EDITS = ("a", "b"), 4, 8
SERVICE_SUMMARY_ROUND = 2  # the elected writer summarizes after it
SERVICE_PROFILED_ROUNDS = 2  # the device trace's last rounds
SERVICE_LATE_EVERY = 8  # a third Container loads every 8th document


class _SelfTimes:
    """Exclusive host seconds per part: the time a wrapped call takes,
    less the time of the wrapped calls inside it (the orderer's
    broadcast runs the clients' and the sidecar's callbacks). Each
    thread nests its own calls; the sums are host seconds of all
    threads."""

    def __init__(self):
        self.s = collections.Counter()
        self._local = threading.local()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def part(self, name: str):
        stack = self._local.__dict__.setdefault("inner", [])
        start = time.perf_counter()
        stack.append(0.0)
        try:
            yield
        finally:
            inner = stack.pop()
            took = time.perf_counter() - start
            with self._lock:
                self.s[name] += took - inner
            if stack:
                stack[-1] += took

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            with self.part(name):
                return fn(*args, **kwargs)
        return timed


def session_api(package) -> types.SimpleNamespace:
    """The entry points a live session drives, taken from ``package``
    (an imported top-level package; this script hands in the port)."""
    def mod(name):
        return importlib.import_module(f"{package.__name__}.{name}")

    tree_fuzz = mod("testing.tree_fuzz")
    return types.SimpleNamespace(
        LocalServer=mod("service").LocalServer,
        factory=mod("drivers").LocalDocumentServiceFactory,
        Container=mod("loader").Container,
        types=mod("models").default_registry().types,
        ACTIONS=mod("testing.dds_fuzz").ACTIONS,
        node=mod("models.tree").node,
        random_change_with_moves=tree_fuzz.random_change_with_moves,
    )


def _time_connect(server, times) -> None:
    """Count the clients' message and nack callbacks of ``server``'s
    connections as "client" host time."""
    connect = server.connect

    def timed_connect(document_id, client_id, on_message, on_nack=None,
                      **kw):
        return connect(document_id, client_id,
                       times.wrap("client", on_message),
                       on_nack and times.wrap("client", on_nack), **kw)

    server.connect = timed_connect


def _timed_server(api, times, seed: int):
    """A ``LocalServer`` on a manual clock whose clients' message and
    nack callbacks count as "client" host time."""
    tick = {"t": 1_000_000.0 + seed}

    def clock():
        tick["t"] += 0.001
        return tick["t"]

    server = api.LocalServer(clock=clock)
    _time_connect(server, times)
    return server, api.factory(server)


def _time_orderer(server, doc: str, times, captured=None) -> None:
    """Time ``doc``'s orderer as "orderer" (its broadcast's callbacks
    excluded); with ``captured``, a list, capture every message its
    broadcaster sends into it."""
    orderer = server.get_orderer(doc)
    for name in ("submit", "connect", "disconnect"):
        setattr(orderer, name, times.wrap("orderer", getattr(orderer, name)))
    if captured is not None:
        orderer.broadcaster.subscribe(f"capture/{doc}", captured.append)


def _service_edit(rng, s) -> None:
    """One edit of the service traffic: insert 4-8 characters (0.6),
    remove at most 8 (0.3), annotate bold (0.1)."""
    n = s.get_length()
    r = rng.random()
    if r < 0.6 or n == 0:
        s.insert_text(rng.randint(0, n), "".join(
            rng.choice("abcdefghij ") for _ in range(rng.randint(4, 8))))
    elif r < 0.9:
        start = rng.randrange(n)
        s.remove_text(start, min(n, start + rng.randint(1, 8)))
    else:
        start = rng.randrange(n)
        s.annotate_range(start, min(n, start + rng.randint(1, 8)),
                         {"bold": rng.randint(0, 3)})


def _log_stream(log_msgs: list, ds_id: str = "d", ch_id: str = "s") -> list:
    """A document's op log (or broadcast messages) as one channel's
    stream, the merge stream the oracle replays: the channel's ops out of
    the runtime envelope, other runtime ops (the attaches, other
    channels) as NOOPs, system messages as they are."""
    from fluidframework_tpu_torch.protocol.messages import MessageType

    out = []
    for msg in log_msgs:
        if msg.type == MessageType.OPERATION:
            env = msg.contents if isinstance(msg.contents, dict) else {}
            if (env.get("kind", "op") == "op" and env.get("address") == ds_id
                    and env.get("channel") == ch_id):
                msg = dataclasses.replace(msg, contents=env["contents"])
            else:
                msg = dataclasses.replace(msg, type=MessageType.NO_OP,
                                          contents=None)
        out.append(msg)
    return out


def _hold_scan_dispatch(sidecar) -> dict:
    """Keep the inputs and a copy of the output of the first scan
    dispatch that holds real ops (the device half's call)."""
    from fluidframework_tpu_torch.ops.window_cost import real_ops

    held = {}
    inner = sidecar._apply_program

    def holding(table, program, *donated):
        out = inner(table, program, *donated)
        if not held and "scan" in program and bool(
                real_ops(program["scan"].kind).any()):
            held.update(table=table, batch=program["scan"],
                        out=type(out)(*(t.clone() for t in out)))
        return out

    sidecar._apply_program = holding
    return held


def phase_service(seed: int) -> dict:
    """bench config14-full's table width as a live service: 1024
    documents, two writer Containers each on the port's LocalServer and
    local driver, GpuMergeSidecar subscribed to every document's
    ("d", "s") channel; 4 rounds of 8 edits per writer, a flush per
    writer per round, an apply per round, late joins from the summary.
    Every writer runs a ``SummaryManager`` whose heuristics fire on a
    session clock that moves once, after round 2, so the elected writer
    (A, the first to join) summarizes there; every runtime has a
    ``GarbageCollector`` (writer A also attaches an unreferenced
    datastore, whose unreferenced-since time the summaries carry), and
    writer B an ``OpStreamAttributor``. Every document held to both
    writers, to a scalar replay of its op log and (every 8th) to a late
    joiner."""
    import fluidframework_tpu_torch
    from fluidframework_tpu_torch.loader import Container
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.protocol.messages import MessageType
    from fluidframework_tpu_torch.runtime import (
        SummarizerHeuristics, SummaryManager,
    )
    from fluidframework_tpu_torch.runtime.attribution import (
        Attributor, OpStreamAttributor,
    )
    from fluidframework_tpu_torch.runtime.gc import GarbageCollector
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    rng = random.Random(seed)
    times = _SelfTimes()
    t0 = time.perf_counter()
    server, factory = _timed_server(session_api(fluidframework_tpu_torch),
                                    times, seed)
    sidecar = GpuMergeSidecar(device="cuda", executor="scan",
                              max_docs=SERVICE_DOCS,
                              capacity=SERVICE_CAPACITY,
                              max_capacity=SERVICE_MAX_CAPACITY)
    guard = _guard_device_half(sidecar)
    held = _hold_scan_dispatch(sidecar)
    # the sidecar's ingest runs inside the orderer's broadcast
    sidecar.ingest = times.wrap("sidecar ingest", sidecar.ingest)
    docs = [f"svc-{d}" for d in range(SERVICE_DOCS)]
    # the summarizers' clock: still until the summary point
    session_clock = {"t": 0.0}

    def heuristics():
        return SummarizerHeuristics(
            max_ops=1 << 30, max_time_s=1.0,
            clock=lambda: session_clock["t"])

    writers, acks, managers, collectors, attributors = {}, [], {}, {}, {}
    for doc in docs:
        sidecar.subscribe(server, doc, "d", "s")
        _time_orderer(server, doc, times)
        with times.part("client"):
            pair = [Container.load(factory.create_document_service(doc),
                                   client_id=f"{doc}-{who}")
                    for who in SERVICE_WRITERS]
            managers[doc] = [SummaryManager(c, heuristics_factory=heuristics)
                             for c in pair]
            collectors[doc] = [GarbageCollector(
                c.runtime, clock=lambda: session_clock["t"]) for c in pair]
            attributors[doc] = OpStreamAttributor(pair[1])
            pair[0].runtime.create_datastore("d").create_channel(
                "sharedstring", "s")
            pair[0].runtime.create_datastore("side", root=False)
            pair[0].flush()
            pair[0].on("summaryAck", acks.append)
        writers[doc] = pair
    setup_s = time.perf_counter() - t0

    def string(c):
        return c.runtime.get_datastore("d").get_channel("s")

    first_profiled = SERVICE_ROUNDS - SERVICE_PROFILED_ROUNDS + 1
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    cuda_merge.LAUNCHES = 0
    torch.cuda.synchronize()
    before = dict(times.s)
    t1 = time.perf_counter()
    edits, apply_s, logged = 0, 0.0, {}
    for rnd in range(1, SERVICE_ROUNDS + 1):
        if rnd == first_profiled:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            prof.start()
            t_prof = time.perf_counter()
            start_s = t_prof - t_start  # left out of the rounds' wall
        for doc in docs:
            with times.part("client"):
                for c in writers[doc]:
                    s = string(c)
                    for _ in range(SERVICE_EDITS):
                        _service_edit(rng, s)
                        edits += 1
                for c in writers[doc]:
                    c.flush()
        t_apply = time.perf_counter()
        sidecar.apply()
        apply_s += time.perf_counter() - t_apply
        if rnd == SERVICE_SUMMARY_ROUND:
            session_clock["t"] = 1.0
            for doc in docs:
                # the op log up to here: the summary's ack truncates it
                logged[doc] = server.read_ops(doc, 0)
                with times.part("client"):
                    for collector in collectors[doc]:
                        collector.collect()
                    for manager in managers[doc]:
                        manager.tick()
    t_sync = time.perf_counter()
    sidecar.sync()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    prof.stop()
    sync_s, profiled_s = t_end - t_sync, t_end - t_prof
    rounds_s = t_end - t1 - start_s
    # the rounds' host seconds by part; "other" is the rest of the wall
    host = {k: v - before.get(k, 0.0) for k, v in times.s.items()}
    host["sidecar apply"], host["sync"] = apply_s, sync_s
    host["other"] = rounds_s - sum(host.values())
    busy = _device_busy_ms(prof)

    # late joins from the scribe's summary plus the tail; a late joiner's
    # collector starts from the summary's GC state
    late_equal = 0
    for doc in docs[::SERVICE_LATE_EVERY]:
        if server.latest_summary(doc) is None:
            raise AssertionError(f"{doc}: no summary in the scribe's store")
        with times.part("client"):
            late = Container.load(factory.create_document_service(doc),
                                  client_id=f"{doc}-late")
        want = string(writers[doc][0])
        if (string(late).get_text(), string(late).signature()) != \
                (want.get_text(), want.signature()):
            raise AssertionError(f"{doc}: the late joiner differs")
        if GarbageCollector(late.runtime).snapshot() != \
                server.latest_summary(doc).summary["runtime"]["gc"]:
            raise AssertionError(f"{doc}: the late joiner's GC state "
                                 f"differs from the summary's")
        late_equal += 1
    sidecar.apply()  # the late joins' sequenced joins
    sidecar.sync()
    torch.cuda.synchronize()
    launches = cuda_merge.LAUNCHES
    phase_s = time.perf_counter() - t0

    t_check = time.perf_counter()
    messages = attributed = 0
    for doc in docs:
        texts = {string(c).get_text() for c in writers[doc]}
        served = sidecar.text(doc, "d", "s")
        if texts != {served}:
            raise AssertionError(f"{doc}: sidecar text differs from the "
                                 f"writers'")
        log_msgs = logged[doc] + server.read_ops(
            doc, logged[doc][-1].sequence_number)
        seqs = [m.sequence_number for m in log_msgs]
        if seqs != list(range(1, len(seqs) + 1)):
            raise AssertionError(f"{doc}: the op log is not contiguous")
        messages += len(log_msgs)
        text, sig = _oracle(_log_stream(log_msgs))
        if text != served or sidecar.signature(doc, "d", "s") != sig:
            raise AssertionError(f"{doc}: sidecar differs from the "
                                 f"op log's replay")
        manager_a, manager_b = managers[doc]
        if (manager_a.election.elected, manager_b.election.elected) != \
                (f"{doc}-a",) * 2 or manager_b.is_summarizer or \
                manager_a.running.summaries_produced != 1:
            raise AssertionError(f"{doc}: writer A is not the one elected "
                                 f"summarizer with one summary")
        gc_state = server.latest_summary(doc).summary["runtime"].get("gc")
        if gc_state != collectors[doc][0].snapshot() or \
                "/side" not in gc_state["unreferencedSince"]:
            raise AssertionError(f"{doc}: the summary's GC state "
                                 f"{gc_state} is not writer A's collector's")
        ops = [m for m in log_msgs if m.type == MessageType.OPERATION]
        attributor = attributors[doc]
        decoded = Attributor.decode(attributor.encode())
        if len(attributor) != len(ops) or len(decoded) != len(ops) or any(
                attributor.get(m.sequence_number) is None
                or attributor.get(m.sequence_number).user != m.client_id
                or decoded.get(m.sequence_number)
                != attributor.get(m.sequence_number) for m in ops):
            raise AssertionError(f"{doc}: writer B's attributor does not "
                                 f"hold one entry per sequenced op, or its "
                                 f"encoding does not round-trip")
        attributed += len(attributor)
    if len(acks) != SERVICE_DOCS:
        raise AssertionError(f"{len(acks)} summaries acked of "
                             f"{SERVICE_DOCS}")
    if launches <= 0 or not held or guard["calls"] <= 0:
        raise AssertionError(f"B1 launches {launches}, held dispatch "
                             f"{bool(held)}, guarded {guard['calls']}")
    if sidecar.overflowed():
        raise AssertionError("the service phase left an overflowed document")
    want, err = _check_window(held["table"], held["batch"],
                              "the service phase's dispatch")
    bad = [f for f, x, y in zip(want._fields, held["out"], want)
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"the service dispatch's output differs from "
                             f"the plain version's at {bad}")
    shape = (f"{want.docs} x {want.capacity} x "
             f"{held['batch'].kind.shape[1]}")
    check_s = time.perf_counter() - t_check
    log(f"service: {SERVICE_DOCS} docs x {len(SERVICE_WRITERS)} writers "
        f"(port LocalServer -> local driver -> Container, "
        f"GpuMergeSidecar scan {SERVICE_DOCS} x {SERVICE_CAPACITY}, max "
        f"{SERVICE_MAX_CAPACITY}), {SERVICE_ROUNDS} rounds x "
        f"{SERVICE_EDITS} edits per writer: {edits} edits, {messages} "
        f"sequenced messages; rounds wall {rounds_s:.3f} s, "
        f"{edits / rounds_s:.1f} edits/s (phase wall {phase_s:.3f} s with "
        f"setup {setup_s:.3f} s: {SERVICE_DOCS * len(SERVICE_WRITERS)} loads "
        f"and attaches; {late_equal} late joins); the rounds' host s: "
        f"client {host['client']:.3f} (Container edit, submit, flush, "
        f"process, summarize), orderer {host['orderer']:.3f} (submit -> "
        f"broadcast, the callbacks excluded), sidecar ingest "
        f"{host['sidecar ingest']:.3f}, sidecar apply "
        f"{host['sidecar apply']:.3f} (pack {sidecar.stats['pack_s']:.3f}, "
        f"settle {sidecar.stats['settle_s']:.3f}), sync {host['sync']:.3f}, "
        f"other {host['other']:.3f}; B1 "
        f"launches {launches}; device trace of the last "
        f"{SERVICE_PROFILED_ROUNDS} rounds (its start, {start_s:.3f} s, "
        f"left out of the rounds' wall): busy {busy['total']:.3f} ms of "
        f"{profiled_s * 1e3:.3f} ms, idle share "
        f"{1 - busy['total'] / (profiled_s * 1e3):.6f}, {busy['events']} "
        f"device events; grows {sidecar.grow_count}, host evictions "
        f"{sidecar.evict_count} (host docs {sidecar.host_mode_docs()}); "
        f"summaries acked {len(acks)}, each by writer A, every document's "
        f"elected summarizer (SummaryManager on both writers, its time "
        f"heuristic on a session clock that moves once, after round "
        f"{SERVICE_SUMMARY_ROUND}), each carrying writer A's GC state (an "
        f"unreferenced datastore's time); late joins equal {late_equal}/"
        f"{len(docs[::SERVICE_LATE_EVERY])}, their GC state == the "
        f"summary's; writer B's attributors hold {attributed} entries, one "
        f"per sequenced op, and round-trip encode/decode; every document's "
        f"sidecar text == both writers' == its op log's scalar replay "
        f"(signature too); one dispatch "
        f"({shape}) kernel == plain, every field, and == the "
        f"dispatch's own output; device half under sync debug 'error' in "
        f"{guard['calls']} dispatches; checks {check_s:.3f} s")
    return {"launches": launches, "max_abs_err": err}


# ----------------------------------------------------------------------
# ingress: the networked front door, live over TCP

INGRESS_CONNECTIONS = 8  # TCP connections per writer group
# rounds of the TCP session: a depth cut of the service cell's 4, made to
# fit the config5 and chaos phases (PERF.md section 4)
INGRESS_ROUNDS = 2
INGRESS_COLUMNAR_DOCS = 64  # documents of the raw wire-1.3 columnar leg
INGRESS_COLUMNAR_OPS = 8  # ops per columnar batch, one batch per round
INGRESS_QOS_OPS = 100_000.0  # default_limits' per-connection op rate
INGRESS_TENANT = "smoke"
INGRESS_WAIT_S = 300.0  # the longest a barrier of the phase may take
CLI_EDITS = 4


class _Loop:
    """An asyncio event loop on a thread of its own, the shape of the
    tests' ``alfred`` fixture: ``run`` waits for a coroutine there."""

    def __init__(self):
        import asyncio

        self.asyncio = asyncio
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="ingress-loop")
        self.thread.start()

    def _run(self):
        self.asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout: float = INGRESS_WAIT_S):
        return self.asyncio.run_coroutine_threadsafe(
            coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _until(pred, what: str, timeout: float = INGRESS_WAIT_S) -> None:
    deadline = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


_THREAD_GROUPS = (("socket-recv-", "socket recv"),
                  ("socket-dispatch-", "socket dispatch"),
                  ("ingress-loop", "event loop"), ("MainThread", "main"))


def _thread_cpu_s() -> collections.Counter:
    """CPU seconds each group of this process's threads has used so far
    (utime + stime of /proc/self/task/<tid>/stat; Linux)."""
    import os

    tick = os.sysconf("SC_CLK_TCK")
    out = collections.Counter()
    for t in threading.enumerate():
        try:
            with open(f"/proc/self/task/{t.native_id}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:  # the thread ended meanwhile
            continue
        group = next((g for prefix, g in _THREAD_GROUPS
                      if t.name.startswith(prefix)), "other")
        out[group] += (int(fields[11]) + int(fields[12])) / tick
    return out


def _ask(port: int, frame: dict) -> dict:
    """One request frame on a connection of its own, the way the
    service's ``--dump-*`` commands ask."""
    import socket

    from fluidframework_tpu_torch.service.ingress import (
        pack_frame, recv_frame_blocking,
    )

    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall(pack_frame(dict(frame, rid=1)))
        return recv_frame_blocking(sock)


def _counters(snapshot: dict, names) -> dict:
    """Each counter family's sum over its label sets."""
    return {n: sum(snapshot.get(n, {}).get("values", {}).values())
            for n in names}


class _ColumnarWriter:
    """A raw delta connection that submits untraced batches of plain
    text inserts and removes: the wire-1.3 columnar path (a
    ``Container`` stamps ``client:submit`` on every op, so its batches
    ride the row boxcar). Its own text is what the log must replay to."""

    def __init__(self, facade, doc: str):
        self.doc, self.client_id = doc, f"{doc}-cols"
        self.seen, self.text, self.csn = [], "", 0
        self.conn = facade.connect_to_delta_stream(self.client_id,
                                                   self.seen.append)

    def own(self) -> int:
        return sum(m.client_id == self.client_id and m.type == 2
                   for m in self.seen)

    def send(self, rng) -> None:
        from fluidframework_tpu_torch.models.mergetree.ops import (
            InsertOp, RemoveOp,
        )
        from fluidframework_tpu_torch.protocol.constants import mark_batch
        from fluidframework_tpu_torch.protocol.messages import (
            DocumentMessage, MessageType,
        )

        ref = self.seen[-1].sequence_number
        for i in range(INGRESS_COLUMNAR_OPS):
            n = len(self.text)
            if n > 8 and rng.random() < 0.3:
                start = rng.randrange(n - 1)
                end = min(n, start + rng.randint(1, 6))
                op = RemoveOp(pos1=start, pos2=end)
                self.text = self.text[:start] + self.text[end:]
            else:
                pos = rng.randint(0, n)
                chars = "".join(rng.choice("klmnop ")
                                for _ in range(rng.randint(2, 6)))
                op = InsertOp(pos1=pos, text=chars)
                self.text = self.text[:pos] + chars + self.text[pos:]
            self.csn += 1
            last = i == INGRESS_COLUMNAR_OPS - 1
            self.conn.submit(DocumentMessage(
                client_sequence_number=self.csn,
                reference_sequence_number=ref,
                type=MessageType.OPERATION, contents=op,
                metadata=mark_batch(None, True) if i == 0
                else mark_batch(None, False) if last else None))


def _cli_leg() -> dict:
    """The normal entry point as a user starts it: ``python -m
    fluidframework_tpu_torch.service --port 0 --qos --slo`` in a
    subprocess, one ``Container`` over ``SocketDocumentServiceFactory``,
    then ``--dump-metrics`` and ``--dump-slo`` against it."""
    import os
    import re

    from fluidframework_tpu_torch.drivers import SocketDocumentServiceFactory
    from fluidframework_tpu_torch.loader import Container

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "fluidframework_tpu_torch.service"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd + ["--port", "0", "--qos", "--slo"],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=root)
    try:
        line = proc.stdout.readline()
        found = re.search(r"listening on [\w.]+:(\d+)", line)
        if not found:
            raise AssertionError(f"the service printed {line!r}")
        port = int(found.group(1))
        start_s = time.perf_counter() - t0
        svc = SocketDocumentServiceFactory(
            "127.0.0.1", port).create_document_service("cli-doc")
        try:
            with svc.lock:
                c = Container.load(svc, client_id="cli-writer")
                s = c.runtime.create_datastore("d").create_channel(
                    "sharedstring", "s")
                for i in range(CLI_EDITS):
                    s.insert_text(s.get_length(), f"edit {i}; ")
                c.flush()

            def acked():
                with svc.lock:
                    return c.runtime.pending.count == 0
            _until(acked, "the CLI service's acks", 60)
            with svc.lock:
                text = s.get_text()
                c.close()
        finally:
            svc.close()
        want = "".join(f"edit {i}; " for i in range(CLI_EDITS))
        if text != want:
            raise AssertionError(f"the CLI session's text {text!r}")
        dumps = {}
        for flag, must in (("--dump-metrics", ("ingress_frames_total",
                                               "ingress_ops_ticketed_total",
                                               "qos_admitted_total")),
                           ("--dump-slo", ("ingress-dispatch-p99",
                                           "ingress-goodput"))):
            out = subprocess.run(cmd + [flag, f"127.0.0.1:{port}"],
                                 capture_output=True, text=True,
                                 timeout=120, cwd=root)
            missing = [m for m in must if m not in out.stdout]
            if out.returncode != 0 or missing:
                raise AssertionError(f"{flag}: rc {out.returncode}, "
                                     f"missing {missing}: "
                                     f"{out.stderr[-500:]}")
            dumps[flag] = len(out.stdout.splitlines())
    finally:
        proc.terminate()
        try:
            rc = proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
            raise AssertionError("the service did not stop on SIGTERM")
        proc.stdout.close()
    if rc != -15:
        raise AssertionError(f"the service exited {rc} on SIGTERM")
    return {"start_s": start_s, "port": port, "dumps": dumps,
            "wall_s": time.perf_counter() - t0, "rc": rc}


def phase_ingress(seed: int) -> dict:
    """The service's normal entry point, live over TCP, at the service
    cell's width: ``AlfredServer`` (tenancy, qos admission with its
    pressure monitor, the SLO engine, the heat ledger) over the port's
    ``LocalServer`` on an event-loop thread; 1024 documents, two writer
    ``Container``s each, every writer group over
    ``INGRESS_CONNECTIONS`` multiplexed TCP connections with a signed
    token per document; ``GpuMergeSidecar`` subscribed to every
    document's ("d", "s") channel, applied on the loop thread once every
    writer has its acks; ``INGRESS_ROUNDS`` rounds of 8 edits per
    writer, a summarize through the chunked upload plane after round 2,
    late joiners
    through the snapshot cache; a raw columnar leg on 64 more
    documents; then the CLI leg. Every document held to both writers,
    to a scalar replay of its op log and (every 8th) to a late joiner;
    the metrics, slo and heat frames held to the phase's own counts.
    The server carries a usage ledger as ``run_server`` does, so the
    tenant counters count."""
    import random

    from fluidframework_tpu_torch.drivers import CachingMultiplexFactory
    from fluidframework_tpu_torch.loader import Container
    from fluidframework_tpu_torch.obs import (
        HeatLedger, SloEngine, usage_ledger,
    )
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.qos import (
        AdmissionController, Budget, PressureMonitor, default_limits,
    )
    from fluidframework_tpu_torch.service import (
        AlfredServer, GpuMergeSidecar, LocalServer, TenantManager,
        gpu_sidecar, sign_token,
    )
    from fluidframework_tpu_torch.service.ingress import (
        default_slo_objectives,
    )

    rng = random.Random(seed)
    tick = {"t": 2_000_000.0 + seed}

    def clock():  # the server's manual clock
        tick["t"] += 0.001
        return tick["t"]

    times = _SelfTimes()
    t0 = time.perf_counter()
    local = LocalServer(clock=clock)
    tenants = TenantManager()
    key = tenants.create_tenant(INGRESS_TENANT, key=f"smoke-{seed}").key
    # default_limits' op and byte budgets; the bulk classes' budgets are
    # raised to this phase's bursts (1024 summaries and 2048 loads in
    # seconds), so admission runs on every frame and sheds nothing
    big = Budget(1e7)
    limits = dataclasses.replace(
        default_limits(INGRESS_QOS_OPS), summary_uploads=big,
        summary_bytes=Budget(1e12), catchup_reads=big)
    pressure = PressureMonitor(min_interval_s=0.05)
    heat = HeatLedger(max_keys=SERVICE_DOCS)
    alfred = AlfredServer(
        local, tenants=tenants,
        qos=AdmissionController(limits, pressure=pressure),
        slo=SloEngine(default_slo_objectives()), heat=heat,
        usage=usage_ledger())
    alfred._dispatch = times.wrap("ingress dispatch", alfred._dispatch)
    loop = _Loop()
    charges = []
    inner_attr = gpu_sidecar.attribute_round

    def counted(ledger, counts, round_ms, *a, **kw):
        charged = inner_attr(ledger, counts, round_ms, *a, **kw)
        charges.append((round_ms, charged))
        return charged

    gpu_sidecar.attribute_round = counted
    factories = []
    try:
        loop.run(alfred.start())
        port = alfred.port
        sidecar = GpuMergeSidecar(device="cuda", executor="scan",
                                  max_docs=SERVICE_DOCS,
                                  capacity=SERVICE_CAPACITY,
                                  max_capacity=SERVICE_MAX_CAPACITY,
                                  heat=heat)
        guard = _guard_device_half(sidecar)
        held = _hold_scan_dispatch(sidecar)
        sidecar.ingest = times.wrap("sidecar ingest", sidecar.ingest)
        docs = [f"tcp-{d}" for d in range(SERVICE_DOCS)]
        col_docs = [f"cols-{d}" for d in range(INGRESS_COLUMNAR_DOCS)]

        def token_for(doc):
            return sign_token(key, INGRESS_TENANT, doc, "smoke-user")

        groups = [[CachingMultiplexFactory(
            "127.0.0.1", port, tenant_id=INGRESS_TENANT,
            token_for=token_for) for _ in range(INGRESS_CONNECTIONS)]
            for _ in SERVICE_WRITERS]
        factories += [f for g in groups for f in g]
        for doc in docs:
            sidecar.subscribe(local, doc, "d", "s")
            orderer = local.get_orderer(doc)
            for name in ("submit", "connect", "disconnect"):
                setattr(orderer, name,
                        times.wrap("orderer", getattr(orderer, name)))
        writers, acks = {}, []
        for d, doc in enumerate(docs):
            with times.part("client"):
                pair = []
                for g, who in enumerate(SERVICE_WRITERS):
                    svc = groups[g][d % INGRESS_CONNECTIONS] \
                        .create_document_service(doc)
                    with svc.lock:
                        pair.append((svc, Container.load(
                            svc, client_id=f"{doc}-{who}")))
                (sa, ca) = pair[0]
                with sa.lock:
                    ca.runtime.create_datastore("d").create_channel(
                        "sharedstring", "s")
                    ca.flush()
                    ca.on("summaryAck", acks.append)
            writers[doc] = pair
        clients = {id(f._client): f._client for g in groups for f in g}
        for client in clients.values():  # the dispatch threads' deliveries
            client._deliver = times.wrap("client", client._deliver)
        col_writers = [_ColumnarWriter(
            groups[0][d % INGRESS_CONNECTIONS]._shared_client()
            .document_service(doc, tenant_id=INGRESS_TENANT,
                              token=token_for(doc)), doc)
            for d, doc in enumerate(col_docs)]

        flat = [p for pair in writers.values() for p in pair]
        cursor = [0]

        def all_acked():
            # resumes at the first writer the last poll found pending (a
            # writer stays acked until its next edits), so polling takes
            # the locks and the interpreter from the pipeline only briefly
            while cursor[0] < len(flat):
                svc, c = flat[cursor[0]]
                with svc.lock:
                    if c.runtime.pending.count:
                        return False
                cursor[0] += 1
            return all(w.own() == w.csn and w.seen for w in col_writers)

        _until(all_acked, "the loads and attaches")
        setup_s = time.perf_counter() - t0

        def string(c):
            return c.runtime.get_datastore("d").get_channel("s")

        async def apply_round():
            with times.part("sidecar apply"):
                return sidecar.apply()

        async def settle():
            sidecar.sync()
            torch.cuda.synchronize()

        first_profiled = INGRESS_ROUNDS - SERVICE_PROFILED_ROUNDS + 1
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        frames0 = _ask(port, {"type": "metrics"})["metrics"]
        seq0 = {doc: local.get_orderer(doc).sequencer.sequence_number
                for doc in docs + col_docs}
        cuda_merge.LAUNCHES = 0
        torch.cuda.synchronize()
        before = dict(times.s)
        cpu0 = _thread_cpu_s()
        t1 = time.perf_counter()
        edits, wait_s, logged, col_batches = 0, 0.0, {}, 0
        for rnd in range(1, INGRESS_ROUNDS + 1):
            if rnd == first_profiled:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                prof.start()
                t_prof = time.perf_counter()
                start_s = t_prof - t_start  # left out of the rounds' wall
            for doc in docs:
                with times.part("client"):
                    for svc, c in writers[doc]:
                        with svc.lock:
                            s = string(c)
                            for _ in range(SERVICE_EDITS):
                                _service_edit(rng, s)
                                edits += 1
                            c.flush()
            for w in col_writers:
                w.send(rng)
                col_batches += 1
            t_wait = time.perf_counter()
            cursor[0] = 0
            _until(all_acked, f"round {rnd}'s acks")
            wait_s += time.perf_counter() - t_wait
            loop.run(apply_round())
            if rnd == SERVICE_SUMMARY_ROUND:
                for doc in docs:
                    # the op log up to here: the summary's ack truncates it
                    logged[doc] = local.read_ops(doc, 0)
                    svc, c = writers[doc][0]
                    with times.part("client"), svc.lock:
                        c.summarize()
                _until(lambda: len(acks) == SERVICE_DOCS,
                       "the summary acks")
        t_sync = time.perf_counter()
        loop.run(settle())
        t_end = time.perf_counter()
        prof.stop()
        sync_s, profiled_s = t_end - t_sync, t_end - t_prof
        rounds_s = t_end - t1 - start_s
        host = {k: v - before.get(k, 0.0) for k, v in times.s.items()}
        host["sync"], host["acks wait"] = sync_s, wait_s
        cpu = _thread_cpu_s()
        cpu.subtract(cpu0)
        busy = _device_busy_ms(prof)
        frames1 = _ask(port, {"type": "metrics"})["metrics"]
        seq1 = {doc: local.get_orderer(doc).sequencer.sequence_number
                for doc in docs + col_docs}

        # late joiners on every 8th document: the summary fetched into
        # the snapshot cache, the load served from it plus the tail
        late_factory = CachingMultiplexFactory(
            "127.0.0.1", port, tenant_id=INGRESS_TENANT,
            token_for=token_for)
        factories.append(late_factory)
        late_docs = docs[::SERVICE_LATE_EVERY]
        late = []
        for doc in late_docs:
            svc = late_factory.create_document_service(doc)
            if svc.get_latest_summary() is None:
                raise AssertionError(f"{doc}: no summary to cache")
            with times.part("client"), svc.lock:
                late.append((doc, svc, Container.load(
                    svc, client_id=f"{doc}-late")))
        for doc, svc, c in late:
            if svc.last_load_source != "cache":
                raise AssertionError(f"{doc}: the late load came from "
                                     f"{svc.last_load_source}")
        _until(lambda: all(
            c.last_processed_seq ==
            local.get_orderer(doc).sequencer.sequence_number
            for doc, _, c in late), "the late joiners' catch-up")
        late_equal = 0
        for doc, svc, c in late:
            want = string(writers[doc][0][1])
            with svc.lock:
                got = (string(c).get_text(), string(c).signature())
            if got != (want.get_text(), want.signature()):
                raise AssertionError(f"{doc}: the late joiner differs")
            late_equal += 1
        loop.run(apply_round())  # the late joins' sequenced joins
        loop.run(settle())
        launches = cuda_merge.LAUNCHES
        slo = _ask(port, {"type": "slo"})
        heat_frame = _ask(port, {"type": "heat", "k": SERVICE_DOCS})
        phase_s = time.perf_counter() - t0

        t_check = time.perf_counter()
        messages = 0
        for doc in docs:
            texts = set()
            for svc, c in writers[doc]:
                with svc.lock:
                    texts.add(string(c).get_text())
            served = sidecar.text(doc, "d", "s")
            if texts != {served}:
                raise AssertionError(f"{doc}: sidecar text differs from "
                                     f"the writers'")
            log_msgs = logged[doc] + local.read_ops(
                doc, logged[doc][-1].sequence_number)
            seqs = [m.sequence_number for m in log_msgs]
            if seqs != list(range(1, len(seqs) + 1)):
                raise AssertionError(f"{doc}: the op log is not contiguous")
            messages += len(log_msgs)
            text, sig = _oracle(_log_stream(log_msgs))
            if text != served or sidecar.signature(doc, "d", "s") != sig:
                raise AssertionError(f"{doc}: sidecar differs from the "
                                     f"op log's replay")
        col_ops = 0
        for w in col_writers:
            log_msgs = local.read_ops(w.doc, 0)
            col_ops += sum(m.client_id == w.client_id for m in log_msgs)
            if _oracle(log_msgs)[0] != w.text:
                raise AssertionError(f"{w.doc}: the columnar log's replay "
                                     f"differs from its writer")
        if len(acks) != SERVICE_DOCS:
            raise AssertionError(f"{len(acks)} summaries acked of "
                                 f"{SERVICE_DOCS}")
        if launches <= 0 or not held or guard["calls"] <= 0:
            raise AssertionError(f"B1 launches {launches}, held dispatch "
                                 f"{bool(held)}, guarded {guard['calls']}")
        if sidecar.overflowed():
            raise AssertionError("the ingress phase left an overflowed "
                                 "document")
        want, err = _check_window(held["table"], held["batch"],
                                  "the ingress phase's dispatch")
        bad = [f for f, x, y in zip(want._fields, held["out"], want)
               if not torch.equal(x, y)]
        if bad:
            raise AssertionError(f"the ingress dispatch's output differs "
                                 f"from the plain version's at {bad}")
        shape = (f"{want.docs} x {want.capacity} x "
                 f"{held['batch'].kind.shape[1]}")

        # the metrics frame's counters over the rounds against the
        # phase's own counts: every client op of the rounds offered and
        # ticketed once, the summaries through the upload plane, the
        # columnar batches decoded as such, nothing shed or nacked
        names = ("ingress_ops_offered_total", "ingress_ops_ticketed_total",
                 "ingress_columnar_batches_total", "ingress_nacks_sent_total",
                 "ingress_throttle_nacks_total", "ingress_errors_sent_total",
                 "ingress_outbound_dropped_total", "tenant_sheds_total",
                 "tenant_summary_uploads_total", "qos_shed_total")
        c0, c1 = _counters(frames0, names), _counters(frames1, names)
        got = {n: c1[n] - c0[n] for n in names}
        client_ops = 0
        for doc in docs + col_docs:
            log_msgs = (logged[doc] + local.read_ops(
                doc, logged[doc][-1].sequence_number)
                if doc in logged else local.read_ops(doc, 0))
            client_ops += sum(
                seq0[doc] < m.sequence_number <= seq1[doc]
                and m.client_id is not None for m in log_msgs)
        want = dict.fromkeys(names, 0)
        want.update({"ingress_ops_offered_total": client_ops,
                     "ingress_ops_ticketed_total": client_ops,
                     "ingress_columnar_batches_total": col_batches,
                     "tenant_summary_uploads_total": SERVICE_DOCS})
        if got != want:
            raise AssertionError(f"the metrics frame's counters {got} != "
                                 f"the phase's {want}")
        report = slo.get("report") or {}
        graded = {o["name"]: o["verdict"]
                  for o in report.get("objectives", [])
                  if o["slow"]["total"] > 0}
        objectives = {o.name for o in default_slo_objectives()}
        if set(graded) != objectives or not set(graded.values()) <= {
                "ok", "warn", "breach"}:
            raise AssertionError(f"the slo frame graded {graded}")
        for ms, charged in charges:
            if abs(charged - ms) > 1e-9 * ms:
                raise AssertionError(f"{charged!r} ms charged of {ms!r}")
        charged_ms = sum(ms for ms, _ in charges)
        framed_ms = sum(ms for _, ms in heat_frame["docs"])
        if len(heat_frame["docs"]) != SERVICE_DOCS or \
                abs(framed_ms - charged_ms) > 1e-9 * charged_ms:
            raise AssertionError(
                f"the heat frame holds {len(heat_frame['docs'])} documents "
                f"and {framed_ms!r} ms of the sidecar's {charged_ms!r}")
        check_s = time.perf_counter() - t_check
        cli = _cli_leg()
    finally:
        gpu_sidecar.attribute_round = inner_attr
        for f in factories:
            f.close()
        try:
            loop.run(alfred.stop(), 60)
        finally:
            loop.close()
    log(f"ingress: {SERVICE_DOCS} docs x {len(SERVICE_WRITERS)} writers "
        f"over TCP (AlfredServer with tenancy, qos admission + pressure, "
        f"SLO engine and heat ledger on an event-loop thread -> port "
        f"LocalServer; each writer group on {INGRESS_CONNECTIONS} "
        f"multiplexed connections, a signed token per document; "
        f"GpuMergeSidecar scan {SERVICE_DOCS} x {SERVICE_CAPACITY}, max "
        f"{SERVICE_MAX_CAPACITY}, applied on the loop thread), "
        f"{INGRESS_ROUNDS} rounds x {SERVICE_EDITS} edits per writer: "
        f"{edits} edits, {messages} sequenced messages, plus "
        f"{col_batches} columnar batches ({col_ops} ops) on "
        f"{INGRESS_COLUMNAR_DOCS} documents; rounds wall {rounds_s:.3f} s, "
        f"{edits / rounds_s:.1f} edits/s (phase wall {phase_s:.3f} s with "
        f"setup {setup_s:.3f} s: {SERVICE_DOCS * len(SERVICE_WRITERS)} "
        f"loads and attaches over TCP; {late_equal} late joins); the "
        f"rounds' exclusive wall s inside each part, summed over threads "
        f"(waits for the interpreter lock included): client "
        f"{host['client']:.3f} "
        f"(Container edit, flush, summarize on the main thread; the "
        f"socket dispatch threads' deliveries), ingress dispatch "
        f"{host['ingress dispatch']:.3f} (frame decode, auth, admission, "
        f"the orderer excluded), orderer {host['orderer']:.3f} (the "
        f"callbacks excluded), sidecar ingest "
        f"{host['sidecar ingest']:.3f}, sidecar apply "
        f"{host['sidecar apply']:.3f} (pack {sidecar.stats['pack_s']:.3f}, "
        f"settle {sidecar.stats['settle_s']:.3f}), main thread waiting for "
        f"acks {host['acks wait']:.3f}, sync {host['sync']:.3f}; the "
        f"rounds' thread CPU s: main {cpu['main']:.2f}, socket recv "
        f"{cpu['socket recv']:.2f}, socket dispatch "
        f"{cpu['socket dispatch']:.2f}, event loop {cpu['event loop']:.2f}, "
        f"other {cpu['other']:.2f}; sum {sum(cpu.values()):.2f} of the "
        f"{rounds_s:.2f} s wall; B1 "
        f"launches {launches}; device trace of the last "
        f"{SERVICE_PROFILED_ROUNDS} rounds (its start, {start_s:.3f} s, "
        f"left out of the rounds' wall): busy {busy['total']:.3f} ms of "
        f"{profiled_s * 1e3:.3f} ms, idle share "
        f"{1 - busy['total'] / (profiled_s * 1e3):.6f}, {busy['events']} "
        f"device events; grows {sidecar.grow_count}, host evictions "
        f"{sidecar.evict_count}; metrics frame over the rounds: "
        f"{json.dumps(got, sort_keys=True)}; slo frame "
        f"{json.dumps(graded, sort_keys=True)}; heat frame "
        f"{len(heat_frame['docs'])} documents, {framed_ms:.3f} ms == the "
        f"sidecar's {len(charges)} charged rounds; summaries acked "
        f"{len(acks)} through the upload plane; late joins from the "
        f"snapshot cache equal {late_equal}/{len(late_docs)}; every "
        f"document's sidecar text == both writers' == its op log's scalar "
        f"replay (signature too), every columnar log's replay == its "
        f"writer; one dispatch ({shape}) kernel == plain, every field, "
        f"and == the dispatch's own output; device half under sync debug "
        f"'error' in {guard['calls']} dispatches; checks {check_s:.3f} s")
    log(f"ingress CLI: python -m fluidframework_tpu_torch.service --port 0 "
        f"--qos --slo listening after {cli['start_s']:.3f} s; one "
        f"Container over SocketDocumentServiceFactory, {CLI_EDITS} edits "
        f"acked and read back; --dump-metrics ({cli['dumps']['--dump-metrics']}"
        f" lines) and --dump-slo ({cli['dumps']['--dump-slo']} lines) exit "
        f"0 with the expected families; SIGTERM -> exit {cli['rc']}; leg "
        f"{cli['wall_s']:.3f} s")
    return {"launches": launches, "max_abs_err": err}


# ----------------------------------------------------------------------
# serve: the open-loop serving harness at bench config9's full shape

# cut in depth: config9 runs 6.0 simulated seconds, but the harness's
# pressure monitor samples on every admitted op (min_interval_s 0 on
# the manual clock) and each sample scans all 24,000 sessions, so the
# host cost grows as ops x sessions (0.5 s took 45-49 s per run on the
# H100 machine's host); the width stays whole
SERVE_DOCS, SERVE_READERS, SERVE_DURATION_S = 6000, 3, 0.25
SERVE_CAPACITY_OPS, SERVE_SEED, SERVE_SIDECAR_DOCS = 3000.0, 90, 256
SERVE_RUNS = (("steady", 0.8, False), ("steady, profiler on", 0.8, True),
              ("overload", 3.0, False))


def _fed_replay(enc, fed: int):
    """A scalar replay of the first ``fed`` encoded ops of a stream."""
    from fluidframework_tpu_torch.ops.host_bridge import decode_stream

    prefix = copy.copy(enc)
    prefix.ops = enc.ops[:fed]
    return _oracle(decode_stream(prefix))


def phase_serve() -> dict:
    """``tools/serve_bench`` at bench config9's full width (6000
    documents x (1 writer + 3 readers) = 24,000 sessions, capacity 3000
    ops/s, seed 90; ``SERVE_DURATION_S`` simulated seconds of its 6)
    with its sidecar route on
    the card (256 documents, capacity 256, 8 ops per round): steady
    (0.8x) with the profiler off and on, and overload (3x). The steady
    runs' deterministic fields equal each other, the overload breaches
    the goodput and latency objectives, and every sidecar document
    equals a scalar replay of the prefix of its stream it was fed."""
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.tools import serve_bench

    built = []
    build = serve_bench._build_sidecar

    def holding(cfg, **kw):
        sidecar, encs = build(cfg, **kw)
        built.append((sidecar, encs, _guard_device_half(sidecar),
                      _hold_scan_dispatch(sidecar), kw["usage"]))
        return sidecar, encs

    t0 = time.perf_counter()
    serve_bench._build_sidecar = holding
    cuda_merge.LAUNCHES = 0
    try:
        reports = [serve_bench.run_serve_bench(serve_bench.ServeBenchConfig(
            n_docs=SERVE_DOCS, readers_per_doc=SERVE_READERS,
            duration_s=SERVE_DURATION_S,
            capacity_ops_per_s=SERVE_CAPACITY_OPS,
            offered_multiple=multiple, seed=SERVE_SEED, profile=profile,
            sidecar_docs=SERVE_SIDECAR_DOCS, sidecar_device="cuda",
            heat=True))
            for _, multiple, profile in SERVE_RUNS]
    finally:
        serve_bench._build_sidecar = build
    torch.cuda.synchronize()
    launches = cuda_merge.LAUNCHES
    phase_s = time.perf_counter() - t0

    steady, profiled, overload = reports
    if profiled.deterministic_fields() != steady.deterministic_fields():
        raise AssertionError("serve: the steady runs differ: "
                             f"{steady.deterministic_fields()} != "
                             f"{profiled.deterministic_fields()}")
    verdicts = [{o["name"]: o["verdict"] for o in r.slo_report["objectives"]}
                for r in reports]
    if (verdicts[2]["goodput-floor"], verdicts[2]["submit-ack-p99"]) != \
            ("breach", "breach"):
        raise AssertionError(f"serve: the 3x overload graded {verdicts[2]}")
    replays = {}
    for (sidecar, encs, guard, held, usage), rep in zip(built, reports):
        if guard["calls"] != rep.sidecar_rounds or not held:
            raise AssertionError(f"serve: {guard['calls']} guarded "
                                 f"dispatches of {rep.sidecar_rounds}")
        # the sidecar's per-tenant rollup: every attributed ms billed
        tenant_ms = sum(usage.column(t, "device_ms") for t in usage.keys())
        if not rep.heat_top_tenants or not rep.heat_attributed_ms > 0 or \
                not math.isclose(tenant_ms, rep.heat_attributed_ms,
                                 rel_tol=1e-9):
            raise AssertionError(
                f"serve: heat tenants {rep.heat_top_tenants}, tenants' "
                f"device_ms {tenant_ms} against {rep.heat_attributed_ms} "
                f"attributed")
        fed_ops = rep.sidecar_rounds * serve_bench.ServeBenchConfig \
            .sidecar_round_ops
        for d in range(SERVE_SIDECAR_DOCS):
            enc = encs[d % len(encs)]
            key = (d % len(encs), min(len(enc.ops), fed_ops))
            if key not in replays:
                replays[key] = _fed_replay(enc, key[1])
            doc = f"sdoc-{d}"
            if (sidecar.text(doc, "ds", "ch"),
                    sidecar.signature(doc, "ds", "ch")) != replays[key]:
                raise AssertionError(f"serve: {doc} differs from the "
                                     f"replay of its first {key[1]} ops")
    if launches <= 0:
        raise AssertionError(f"serve: B1 launches {launches}")
    sidecar, _, _, held, _ = built[0]
    want, err = _check_window(held["table"], held["batch"],
                              "the serve sidecar's dispatch")
    bad = [f for f, x, y in zip(want._fields, held["out"], want)
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"the serve dispatch's output differs from "
                             f"the plain version's at {bad}")
    overhead = (profiled.wall_s - steady.wall_s) / steady.wall_s
    for (name, multiple, _), rep, verdict in zip(SERVE_RUNS, reports,
                                                 verdicts):
        log(f"serve {name} ({multiple}x): {rep.sessions} sessions, "
            f"offered {rep.offered_ops}, acked {rep.acked_ops}, shed "
            f"{rep.shed_ops} ops; p50 {rep.latency_p50_ms} / p99 "
            f"{rep.latency_p99_ms} simulated ms; peak backlog "
            f"{rep.backlog_peak}; highest pressure tier "
            f"{rep.max_pressure_tier}; sidecar {rep.sidecar_rounds} rounds, "
            f"{rep.sidecar_ops} ops, round p50 / p99 "
            f"{rep.sidecar_round_p50_ms:.3f} / {rep.sidecar_round_p99_ms:.3f}"
            f" wall ms on the card; heat {rep.heat_attributed_ms} step-clock "
            f"ms attributed, top tenants "
            f"{json.dumps(rep.heat_top_tenants)}; SLO "
            f"{json.dumps(verdict, sort_keys=True)}"
            f" ({rep.slo_breach_evaluations} of {rep.slo_evaluations} "
            f"evaluations breached); wall {rep.wall_s:.3f} s")
    log(f"serve: config9 at full width ({SERVE_DOCS} docs x (1 writer + "
        f"{SERVE_READERS} readers), {SERVE_DURATION_S} simulated s of its "
        f"6, "
        f"capacity {SERVE_CAPACITY_OPS} ops/s, seed {SERVE_SEED}; sidecar "
        f"GpuMergeSidecar on cuda, {SERVE_SIDECAR_DOCS} docs x 256); the "
        f"steady runs' deterministic fields equal; the overload breaches "
        f"goodput-floor and submit-ack-p99; heat=True, every run's "
        f"heat_top_tenants filled and its tenants' device_ms summing to "
        f"its heat_attributed_ms; every sidecar document of the "
        f"3 runs == the scalar replay of its fed prefix; B1 launches "
        f"{launches}; one dispatch "
        f"({want.docs} x {want.capacity} x {held['batch'].kind.shape[1]}) "
        f"kernel == plain, every field; the profiler's overhead "
        f"{overhead:.4f} of the steady wall ({profiled.wall_s:.3f} vs "
        f"{steady.wall_s:.3f} s); phase wall {phase_s:.3f} s")
    return {"launches": launches, "max_abs_err": err}


# ----------------------------------------------------------------------
# dds: the DDS catalogue's live sessions into the matrix and tree planes

DDS_MATRIX_MATRICES = 8  # of config3 full's 64: a depth cut (48 until the
# config5 and chaos phases came, 16 until the script neared its time
# limit on a slow host) that keeps the script's time (PERF.md section 4)
DDS_MATRIX_SEED = 1337  # config3's generator seed
DDS_MATRIX_ROUND_OPS = 64  # ops each writer authors before the flushes
DDS_TREE_DOCS, DDS_TREE_WRITERS, DDS_TREE_ROUNDS = 32, 3, 24  # config17
DDS_TREE_SEED = 1700  # config17's generator seed
DDS_TREE_SEED_NODES, DDS_TREE_SEED_CHUNK = 192, 32  # record_tree_stream's
DDS_MIXED_DOCS, DDS_MIXED_ROUNDS, DDS_MIXED_SEED = 128, 4, 10
DDS_MIXED_SUMMARY_ROUND = 2  # writer A of every document summarizes after it
DDS_MIXED_TREE_NODES = 16  # the mixed leg's tree is seeded with these
DDS_MIXED_CAPACITY = 256


def _tree_sig(tree) -> str:
    """A SharedTree's root field in the tree sidecar's signature form."""
    from fluidframework_tpu_torch.models.tree import root_signature

    return root_signature(tree.root().get("root", []))


def _matrix_edit(rng, m, kind: str, view: list, run_len: int) -> None:
    """One SharedMatrix edit at a position drawn against the writer's
    view; ``view`` is ``[row_count, col_count]``, kept current here (a
    count read walks the axis)."""
    rows, cols = view
    if kind == "rows":
        m.insert_rows(rng.randint(0, rows), run_len)
        view[0] += run_len
    elif kind == "cols":
        m.insert_cols(rng.randint(0, cols), 1)
        view[1] += 1
    elif kind == "remove":
        m.remove_rows(rng.randrange(rows), 1)
        view[0] -= 1
    else:
        m.set_cell(rng.randrange(rows), rng.randrange(cols),
                   rng.randint(0, 9999))


def matrix_session(api, cfg, seed: int, times) -> list:
    """bench config3's per-matrix shape authored through live SharedMatrix
    channels: each of ``cfg.matrices`` documents holds one "sharedmatrix"
    channel and two writer Containers. Writer A authors config3's axis
    sequence (``row_runs`` inserts of ``run_len`` rows, ``cols`` single
    columns, ``removes`` single-row removes) and the first half of the
    ``cells`` writes, writer B the other half; every position is drawn
    from ``random.Random(seed)`` against the writer's own view. Each
    round both writers author up to ``DDS_MATRIX_ROUND_OPS`` ops before
    either flushes, in an order the seed shuffles, so cell writes race
    row removes and each other. Returns per matrix its document id, the
    messages its broadcaster sent, both writers' visible grid (held
    equal: ``signature()``, the grid ``to_lists()`` gives, read in one
    walk of each axis rather than one per cell) and the two
    SharedMatrix channels."""
    rng = random.Random(seed)
    server, factory = _timed_server(api, times, seed)
    out = []
    for m in range(cfg.matrices):
        doc = f"matrix-{m}"
        captured: list = []
        _time_orderer(server, doc, times, captured)
        with times.part("client"):
            a = api.Container.load(factory.create_document_service(doc),
                                   client_id=f"{doc}-a")
            ma = a.runtime.create_datastore("d").create_channel(
                "sharedmatrix", "m")
            a.flush()
            b = api.Container.load(factory.create_document_service(doc),
                                   client_id=f"{doc}-b")
            mb = b.runtime.get_datastore("d").get_channel("m")
        half = cfg.cells // 2
        plans = [
            (ma, collections.deque(
                ["rows"] * cfg.row_runs + ["cols"] * cfg.cols
                + ["remove"] * cfg.removes + ["cell"] * half)),
            (mb, collections.deque(["cell"] * (cfg.cells - half)))]
        while plans[0][1] or plans[1][1]:
            with times.part("client"):
                authored = 0
                for mx, plan in plans:
                    view = [mx.row_count, mx.col_count]
                    for _ in range(DDS_MATRIX_ROUND_OPS):
                        if not plan or (plan[0] == "cell" and not (
                                view[0] and view[1])):
                            break
                        _matrix_edit(rng, mx, plan.popleft(), view,
                                     cfg.run_len)
                        authored += 1
                if not authored:
                    raise AssertionError(f"{doc}: a round authored nothing")
                order = [a, b]
                rng.shuffle(order)
                for c in order:
                    c.flush()
        grid = [list(row) for row in ma.signature()]
        if [list(row) for row in mb.signature()] != grid:
            raise AssertionError(f"{doc}: the two writers' matrices differ")
        out.append({"doc": doc, "messages": captured, "grid": grid,
                    "writers": (ma, mb)})
    return out


def tree_session(api, docs: int, writers: int, rounds: int, seed: int,
                 times, on_document=None, on_round=None) -> list:
    """bench config17's corpus through live SharedTree channels: each of
    ``docs`` documents holds one "sharedtree" channel; writer ``w0``
    attaches it and seeds ``DDS_TREE_SEED_NODES`` nodes in flushed
    commits of ``DDS_TREE_SEED_CHUNK`` (as ``record_tree_stream`` does:
    config17 left its trees empty), then ``writers - 1`` more Containers
    join. Each of ``rounds`` rounds, document by document, every writer
    authors ``random_change_with_moves`` (one ``random.Random(seed)``)
    against its own view before any of them flushes, in a shuffled
    order. ``on_document(server, doc)`` runs before a document's first
    edit, ``on_round()`` after the seeding and after every round.
    Returns per document its id, its broadcast messages, its writers
    and their converged root signature."""
    rng = random.Random(seed)
    server, factory = _timed_server(api, times, seed)
    sessions = []
    for d in range(docs):
        doc = f"tree-{d}"
        captured: list = []
        _time_orderer(server, doc, times, captured)
        if on_document is not None:
            on_document(server, doc)
        with times.part("client"):
            c0 = api.Container.load(factory.create_document_service(doc),
                                    client_id=f"{doc}-w0")
            t0 = c0.runtime.create_datastore("d").create_channel(
                "sharedtree", "t")
            for start in range(0, DDS_TREE_SEED_NODES, DDS_TREE_SEED_CHUNK):
                t0.insert_nodes(("root",), start, [
                    api.node("n", value=v) for v in range(
                        start, min(start + DDS_TREE_SEED_CHUNK,
                                   DDS_TREE_SEED_NODES))])
                c0.flush()
            pairs = [(c0, t0)]
            for w in range(1, writers):
                cw = api.Container.load(
                    factory.create_document_service(doc),
                    client_id=f"{doc}-w{w}")
                pairs.append(
                    (cw, cw.runtime.get_datastore("d").get_channel("t")))
        sessions.append({"doc": doc, "messages": captured, "writers": pairs})
    if on_round is not None:
        on_round()
    for rnd in range(rounds):
        for s in sessions:
            with times.part("client"):
                for i, (_c, t) in enumerate(s["writers"]):
                    t.apply_changeset(api.random_change_with_moves(
                        rng, t.get_field(("root",)), f"{s['doc']}-r{rnd}w{i}"))
                order = list(s["writers"])
                rng.shuffle(order)
                for c, _t in order:
                    c.flush()
        if on_round is not None:
            on_round()
    for s in sessions:
        sigs = {_tree_sig(t) for _c, t in s["writers"]}
        if len(sigs) != 1:
            raise AssertionError(f"{s['doc']}: the writers' trees differ")
        s["signature"] = sigs.pop()
    return sessions


def _mixed_edit(api, rng, type_name: str, ch, cid: str, tag: str,
                leases: list) -> bool:
    """One writer's edit of one channel in a mixed round: the DDS fuzz
    action of its type, or a call of its own API for the types without
    one. The SharedString takes the service phase's edits and the
    SharedTree root-field changesets, so that both stay on their device
    planes (see ``mixed_session``). Returns whether the edit left a
    SharedDirectory holding "/a/b" but not "/a": the state in which the
    missing-parent fault (ROADMAP section C) drops remote writes."""
    if type_name == "shareddirectory":
        api.ACTIONS[type_name](rng, ch, cid)
        return (ch.has_sub_directory("b", "/a")
                and not ch.has_sub_directory("a", "/"))
    if type_name == "sharedstring":
        _service_edit(rng, ch)
    elif type_name == "sharedtree":
        ch.apply_changeset(api.random_change_with_moves(
            rng, ch.get_field(("root",)), tag))
    elif type_name in api.ACTIONS:
        api.ACTIONS[type_name](rng, ch, cid)
    elif type_name == "sharedquorum":
        ch.set(f"q{rng.randrange(4)}", f"{cid}:{rng.randrange(100)}")
    elif type_name == "taskmanager":
        task = f"task{rng.randrange(3)}"
        if ch.queued(task) and rng.random() < 0.5:
            ch.abandon(task)
        else:
            ch.volunteer(task)
    elif type_name == "consensusorderedcollection":
        # last round's acquires are sequenced: complete the granted ones
        for acquire_id in leases:
            if ch.result_of(acquire_id) is not None:
                ch.complete(acquire_id)
        leases.clear()
        ch.add(rng.randrange(100))
        leases.append(ch.acquire())
    elif type_name != "sharedsummaryblock":  # write-once pre-attach
        raise AssertionError(f"no mixed edit for {type_name!r}")
    return False


def mixed_session(api, docs: int, rounds: int, seed: int, times,
                  on_document=None, on_round=None) -> dict:
    """Every channel type of the registry in one datastore: each of
    ``docs`` documents holds one channel of each type (the channel id is
    the type name) and two writer Containers. Writer A creates them: the
    summary block written before its attach (it is write-once pre-attach
    and has no op path), the tree seeded with ``DDS_MIXED_TREE_NODES``
    root nodes. Each of ``rounds`` rounds every writer edits every
    channel once (``_mixed_edit``) before the two flush in a shuffled
    order; writer A summarizes after round ``DDS_MIXED_SUMMARY_ROUND``;
    a late joiner loads after the last round. ``on_document(server,
    doc)`` runs before a document's first message, ``on_round(rnd)``
    after every round and once more (``rnd = rounds + 1``) after the
    late joins. The SharedString takes the service phase's edits rather
    than the fuzz action, whose interval ops a merge sidecar cannot
    ingest (ROADMAP section C), and the SharedTree root-field changesets
    rather than the fuzz action's edits of fields the tree plane does
    not hold (it would serve them from the host). Returns per document
    its broadcast messages, its three Containers, writer A's summary
    acks and whether a writer's SharedDirectory ever held a
    subdirectory without its parent (``orphan_dir``)."""
    rng = random.Random(seed)
    server, factory = _timed_server(api, times, seed)
    sessions = {}
    for d in range(docs):
        doc = f"mixed-{d}"
        captured: list = []
        _time_orderer(server, doc, times, captured)
        if on_document is not None:
            on_document(server, doc)
        with times.part("client"):
            a = api.Container.load(factory.create_document_service(doc),
                                   client_id=f"{doc}-a")
            ds = a.runtime.create_datastore("d")
            for type_name in api.types:
                if type_name == "sharedsummaryblock":
                    block = ds.registry.get(type_name).create(type_name)
                    block.set("document", doc)
                    block.set("seed", seed)
                    ds.load_channel(type_name, type_name,
                                    block.summarize_core())
                    a.runtime.submit_attach("d", type_name, type_name,
                                            block.summarize_core())
                else:
                    ds.create_channel(type_name, type_name)
            ds.get_channel("sharedtree").insert_nodes(("root",), 0, [
                api.node("n", value=v) for v in range(DDS_MIXED_TREE_NODES)])
            a.flush()
            b = api.Container.load(factory.create_document_service(doc),
                                   client_id=f"{doc}-b")
        acks: list = []
        a.on("summaryAck", acks.append)
        sessions[doc] = {"messages": captured, "containers": [a, b],
                         "acks": acks, "leases": {}, "orphan_dir": False}
    for rnd in range(1, rounds + 1):
        for doc, s in sessions.items():
            with times.part("client"):
                for c in s["containers"]:
                    ds = c.runtime.get_datastore("d")
                    leases = s["leases"].setdefault(c.client_id, [])
                    for type_name in api.types:
                        if _mixed_edit(api, rng, type_name,
                                       ds.get_channel(type_name),
                                       c.client_id, f"{c.client_id}-r{rnd}",
                                       leases):
                            s["orphan_dir"] = True
                order = list(s["containers"])
                rng.shuffle(order)
                for c in order:
                    c.flush()
        if on_round is not None:
            on_round(rnd)
        if rnd == DDS_MIXED_SUMMARY_ROUND:
            for s in sessions.values():
                with times.part("client"):
                    s["containers"][0].summarize()
    for doc, s in sessions.items():
        if server.latest_summary(doc) is None:
            raise AssertionError(f"{doc}: no summary in the scribe's store")
        with times.part("client"):
            s["containers"].append(api.Container.load(
                factory.create_document_service(doc),
                client_id=f"{doc}-late"))
    if on_round is not None:
        on_round(rounds + 1)
    return sessions


def _mixed_form(type_name: str, ch):
    """What replicas of a channel agree on: its ``summarize_core()`` as
    sorted-key JSON, but a SharedString's ``signature()`` (text, props,
    intervals: its summary's segment layout and per-segment seq and
    attribution form are each replica's own) and a LegacySharedTree's
    summary without ``edit_count`` (the edits this replica processed,
    which a load does not restore: ROADMAP section C)."""
    if type_name == "sharedstring":
        return repr(ch.signature())
    summary = json.loads(json.dumps(ch.summarize_core(), default=str))
    if type_name == "legacysharedtree":
        summary.pop("edit_count")
    return json.dumps(summary, sort_keys=True)


def _busy_line(busy: dict, wall_s: float) -> str:
    b1 = sum(ms for name, ms in busy["by_name"].items()
             if "merge_window" in name)
    return (f"device trace: busy {busy['total']:.3f} ms of "
            f"{wall_s * 1e3:.3f} ms, idle share "
            f"{1 - busy['total'] / (wall_s * 1e3):.6f}, {busy['events']} "
            f"device events, B1 {b1:.4f} ms")


def _dds_matrix(api) -> dict:
    """The matrix leg: config3's per-matrix shape through live
    SharedMatrix channels, then the matrix plane on the card."""
    from fluidframework_tpu_torch.convert import batch_from_numpy
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.host_bridge import fetch
    from fluidframework_tpu_torch.ops.host_replay import replay_encoded
    from fluidframework_tpu_torch.ops.matrix_bridge import (
        MatrixStream, _visible_handles, dispatch_matrix_batch,
        extract_matrix, pack_matrix_batch,
    )
    from fluidframework_tpu_torch.ops.matrix_cells import CellPack
    from fluidframework_tpu_torch.ops.segment_table import make_table
    from fluidframework_tpu_torch.testing import MATRIX_SCALES

    cfg = dataclasses.replace(MATRIX_SCALES["full"],
                              matrices=DDS_MATRIX_MATRICES)
    times = _SelfTimes()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.start()
    t1 = time.perf_counter()
    docs = matrix_session(api, cfg, DDS_MATRIX_SEED, times)
    session_s = time.perf_counter() - t1
    with times.part("bridge ingest"):
        streams = []
        for d in docs:
            ms = MatrixStream()
            for msg in _log_stream(d["messages"], "d", "m"):
                ms.add_message(msg)
            streams.append(ms)
    t_pack = time.perf_counter()
    batch = pack_matrix_batch(streams)
    cells = CellPack(cfg.rows, cfg.cols, device="cuda")
    cells.pack(streams)
    pack_s = time.perf_counter() - t_pack
    cuda_merge.LAUNCHES = 0
    t_dev = time.perf_counter()
    table = dispatch_matrix_batch(batch, cfg.matrices, capacity=cfg.capacity,
                                  device="cuda")
    grid = cells.apply()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = cuda_merge.LAUNCHES
    prof.stop()
    device_s, wall_s = t_end - t_dev, t_end - t1
    busy = _device_busy_ms(prof)
    host = dict(times.s)
    messages = sum(len(d["messages"]) for d in docs)
    edits = cfg.matrices * (cfg.row_runs + cfg.cols + cfg.removes
                            + cfg.cells)
    np_table = fetch(table)
    peak = int(np_table["count"].max())
    if np_table["overflow"].any():
        raise AssertionError(
            f"dds matrix: {int(np_table['overflow'].sum())} axes overflow "
            f"capacity {cfg.capacity}; peak live segment count {peak}")
    if launches < 1:
        raise AssertionError("dds matrix: the axes never launched B1")

    # B1 == plain on the same batch, every field
    axes = batch_from_numpy(batch, "cuda")
    D, W = axes.kind.shape
    where = f"dds matrix axes D={D} C={cfg.capacity} W={W}"
    want, err = _check_window(make_table(D, cfg.capacity, "cuda"), axes,
                              where)
    bad = [f for f, x, y in zip(want._fields, table, want)
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"dispatch output != plain at {where}: fields "
                             f"{bad}; " + _first_difference(table, want))
    # every axis == the host replay, every grid == a host LWW, every
    # matrix == both writers and the host materialization
    space = cfg.rows * cfg.cols
    got_grid = grid.cpu().numpy().reshape(cfg.matrices, space)
    if not np.array_equal(got_grid, _host_cells(cells.keys, space)):
        raise AssertionError("dds matrix: a cell grid != the host LWW")
    live_rows = 0
    for m, (d, ms) in enumerate(zip(docs, streams)):
        rows = _visible_handles(replay_encoded(ms.rows.ops).as_table(), 0,
                                ms.row_allocs)
        cols = _visible_handles(replay_encoded(ms.cols.ops).as_table(), 0,
                                ms.col_allocs)
        if (_visible_handles(np_table, 2 * m, ms.row_allocs) != rows
                or _visible_handles(np_table, 2 * m + 1,
                                    ms.col_allocs) != cols):
            raise AssertionError(f"{d['doc']}: an axis != the host replay")
        got = extract_matrix(np_table, ms, m)
        if got != d["grid"] or got != _host_matrix(ms, rows, cols):
            raise AssertionError(f"{d['doc']}: the served matrix != its "
                                 f"writers' / the host's")
        live_rows += len(rows)
    log(f"dds: matrix: {cfg.matrices} documents (config3 full, cut to "
        f"{cfg.matrices} of 64 matrices) x 2 writer Containers on one "
        f"sharedmatrix channel, {cfg.row_runs} insert_rows of "
        f"{cfg.run_len} + {cfg.cols} insert_cols + {cfg.removes} "
        f"remove_rows by A, {cfg.cells} set_cell split A / B, rounds of "
        f"{DDS_MATRIX_ROUND_OPS} ops per writer, shuffled flushes: {edits} "
        f"edits, {messages} sequenced messages; session wall "
        f"{session_s:.3f} s, {edits / session_s:.1f} edits/s; host s: client "
        f"{host.get('client', 0.0):.3f} (authoring, flush, delivery), "
        f"orderer {host.get('orderer', 0.0):.3f}, bridge ingest "
        f"{host.get('bridge ingest', 0.0):.3f} (envelope rule -> "
        f"MatrixStream); pack {pack_s:.3f} s (axis batch {D} x "
        f"{cfg.capacity} x {W}, cell keys {list(cells.keys.shape)}); B1 "
        f"launches {launches}, dispatch -> cells -> sync {device_s:.3f} s; "
        + "the leg's " + _busy_line(busy, wall_s)
        + f"; grid {cfg.matrices} x {cfg.rows} "
        f"x {cfg.cols}; peak live segments {peak} of {cfg.capacity}, no "
        f"axis overflow; checks: kernel == plain on the axis batch (every "
        f"field), every axis == host replay, every grid == host LWW, every "
        f"matrix ({live_rows} live rows) == both writers' grid "
        f"(signature()) == the host materialization; leg wall "
        f"{time.perf_counter() - t0:.3f} s with the checks")
    return {"launches": launches, "max_abs_err": err}


def _dds_tree(api) -> None:
    """The tree leg: config17's corpus through live SharedTree channels,
    served live on both routes, then tiled to tree-full's width."""
    from fluidframework_tpu_torch.service import (
        ChannelKindRouter, TreeSidecar,
    )

    times = _SelfTimes()
    routers = {route: ChannelKindRouter(tree=TreeSidecar(
        device="cuda", executor=route, max_docs=DDS_TREE_DOCS,
        capacity=TREE_CAPACITY, max_capacity=TREE_MAX_CAPACITY))
        for route in TREE_ROUTES}
    for r in routers.values():
        r.tree.ingest = times.wrap("sidecar ingest", r.tree.ingest)

    def on_document(server, doc):
        for r in routers.values():
            r.subscribe(server, doc)

    # the device trace covers the last rounds only (reading a trace of
    # every round's 200k device events costs tens of seconds)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    applies = {"n": 0}

    def on_round():
        if applies["n"] == 1 + DDS_TREE_ROUNDS - TREE_PROFILED_ROUNDS:
            torch.cuda.synchronize()
            prof.start()
            applies["t_prof"] = time.perf_counter()
        applies["n"] += 1
        with times.part("sidecar apply"):
            for r in routers.values():
                r.tree.apply()

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sessions = tree_session(api, DDS_TREE_DOCS, DDS_TREE_WRITERS,
                            DDS_TREE_ROUNDS, DDS_TREE_SEED, times,
                            on_document, on_round)
    with times.part("sidecar apply"):
        for r in routers.values():
            r.tree.sync()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    live_s, prof_s = t_end - t1, t_end - applies["t_prof"]
    prof.stop()
    busy = _device_busy_ms(prof)
    host = dict(times.s)
    commits = DDS_TREE_DOCS * DDS_TREE_WRITERS * DDS_TREE_ROUNDS
    messages = sum(len(s["messages"]) for s in sessions)
    for s in sessions:
        if _tree_replay(s["messages"]) != s["signature"]:
            raise AssertionError(f"{s['doc']}: the writers != the "
                                 f"EditManager replay of its stream")
        sigs = {r.tree.signature(s["doc"], "d", "t")
                for r in routers.values()}
        if sigs != {s["signature"]}:
            raise AssertionError(f"{s['doc']}: a live route != the writers")
    for route, r in routers.items():
        sc = r.tree
        if sc.host_mode_docs() or sc.ring_evict_count or sc.overflowed():
            raise AssertionError(
                f"dds tree live {route}: {sc.host_mode_docs()} host docs, "
                f"{sc.ring_evict_count} ring evictions, overflow "
                f"{sc.overflowed()}")
    live = {route: r.tree for route, r in routers.items()}
    log(f"dds: tree live: {DDS_TREE_DOCS} documents (config17 full) x "
        f"{DDS_TREE_WRITERS} writer Containers on one sharedtree channel, "
        f"{DDS_TREE_SEED_NODES} seeded nodes, {DDS_TREE_ROUNDS} rounds of "
        f"random_change_with_moves (Random({DDS_TREE_SEED})), served live "
        f"through ChannelKindRouter -> TreeSidecar on atom and macro "
        f"(capacity {TREE_CAPACITY} -> "
        f"{live['atom'].capacity} / {live['macro'].capacity}): {commits} "
        f"commits, {messages} sequenced messages; wall {live_s:.3f} s, "
        f"{commits / live_s:.1f} commits/s; host s: client "
        f"{host.get('client', 0.0):.3f}, orderer "
        f"{host.get('orderer', 0.0):.3f}, sidecar ingest (both routes) "
        f"{host.get('sidecar ingest', 0.0):.3f}, sidecar apply (both) "
        f"{host.get('sidecar apply', 0.0):.3f} (pack "
        f"{sum(sc.stats['pack_s'] for sc in live.values()):.3f}); B1 "
        f"launches 0 (the tree plane is plain torch); the last "
        f"{TREE_PROFILED_ROUNDS} rounds' "
        + _busy_line(busy, prof_s) + "; checks: writers converge, every "
        "stream's EditManager replay == its writers, both routes' "
        "signature == the writers' on every document, no host document, "
        f"ring eviction or overflow; leg wall {time.perf_counter() - t0:.3f}"
        " s with the checks")
    del routers, live

    # the captured streams tiled to tree-full's width, as "tree:" does
    recorded = [(s["signature"], s["messages"]) for s in sessions]
    want_len = TREE_PREFIX + TREE_ROUND * DDS_TREE_ROUNDS
    if {len(m) for _sig, m in recorded} != {want_len}:
        raise AssertionError(f"dds tree: stream lengths "
                             f"{sorted({len(m) for _s, m in recorded})}, "
                             f"expected {want_len}")
    tables = {}
    for route in TREE_ROUTES:
        t_run = time.perf_counter()
        rec = run_tree(route, recorded)
        sidecar = rec.pop("sidecar")
        _check_tree_run(sidecar, rec, recorded, route)
        tables[route] = rec.pop("table")
        busy = rec["busy"]
        log(f"dds: tree tiled: {route}: the {len(recorded)} live streams "
            f"tiled to {TREE_DOCS} docs x capacity {TREE_CAPACITY} -> "
            f"{sidecar.capacity}, ring {sidecar.ring}: {rec['rounds']} "
            f"rounds, {rec['real']} commits, wall {rec['wall']:.3f} s, "
            f"{rec['real'] / rec['wall']:.1f} commits/s (ingest "
            f"{rec['ingest_s']:.3f} s, pack {sidecar.stats['pack_s']:.3f} "
            f"s); device trace of the last {TREE_PROFILED_ROUNDS} rounds: "
            f"busy {busy['total']:.3f} ms of {rec['prof_wall'] * 1e3:.3f} "
            f"ms, idle share "
            f"{1 - busy['total'] / (rec['prof_wall'] * 1e3):.6f}; every "
            f"document == its writers' root signature, each row == its "
            f"stream's first, one grow, no host document, ring eviction "
            f"or overflow; {time.perf_counter() - t_run:.3f} s with the "
            f"checks")
        del sidecar, rec
    diff = _tree_live_difference(tables["atom"], tables["macro"])
    if diff is not None:
        raise AssertionError(f"dds tree: atom and macro tables differ at "
                             f"{diff}")
    log("dds: tree tiled: the atom and macro live tables are equal")


def _dds_mixed(api) -> dict:
    """The mixed leg: every channel type in one datastore of each
    document, the SharedString routed to B1 and the SharedTree to the
    tree plane, every other type host-side."""
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.service import (
        ChannelKindRouter, GpuMergeSidecar, TreeSidecar,
    )

    times = _SelfTimes()
    merge = GpuMergeSidecar(device="cuda", executor="scan",
                            max_docs=DDS_MIXED_DOCS,
                            capacity=DDS_MIXED_CAPACITY)
    tree = TreeSidecar(device="cuda", max_docs=DDS_MIXED_DOCS,
                       capacity=TREE_CAPACITY,
                       max_capacity=TREE_MAX_CAPACITY)
    guard = _guard_device_half(merge)
    held = _hold_scan_dispatch(merge)
    merge.ingest = times.wrap("sidecar ingest", merge.ingest)
    tree.ingest = times.wrap("sidecar ingest", tree.ingest)
    router = ChannelKindRouter(merge=merge, tree=tree)

    def on_round(_rnd):
        with times.part("sidecar apply"):
            merge.apply()
            tree.apply()

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    cuda_merge.LAUNCHES = 0
    torch.cuda.synchronize()
    prof.start()
    t1 = time.perf_counter()
    sessions = mixed_session(api, DDS_MIXED_DOCS, DDS_MIXED_ROUNDS,
                             DDS_MIXED_SEED, times, router.subscribe,
                             on_round)
    with times.part("sidecar apply"):
        merge.sync()
        tree.sync()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t1
    prof.stop()
    launches = cuda_merge.LAUNCHES
    busy = _device_busy_ms(prof)
    host = dict(times.s)

    messages = missing_parent = 0
    orphaned = sum(s["orphan_dir"] for s in sessions.values())
    for doc, s in sessions.items():
        a, b, late = s["containers"]
        messages += len(s["messages"])
        strings = [c.runtime.get_datastore("d").get_channel("sharedstring")
                   for c in (a, b, late)]
        served = merge.text(doc, "d", "sharedstring")
        if {x.get_text() for x in strings} != {served}:
            raise AssertionError(f"{doc}: the sidecar's text != the writers' "
                                 f"and the late joiner's")
        if len({x.signature() for x in strings}) != 1:
            raise AssertionError(f"{doc}: the SharedStrings' signatures "
                                 f"differ")
        text, sig = _oracle(_log_stream(s["messages"], "d", "sharedstring"))
        if (text, sig) != (served, merge.signature(doc, "d",
                                                   "sharedstring")):
            raise AssertionError(f"{doc}: the sidecar != the replay of its "
                                 f"stream")
        trees = {_tree_sig(c.runtime.get_datastore("d")
                           .get_channel("sharedtree")) for c in (a, b, late)}
        if trees != {tree.signature(doc, "d", "sharedtree")}:
            raise AssertionError(f"{doc}: the tree sidecar != the writers'")
        for t in api.types:
            chans = [c.runtime.get_datastore("d").get_channel(t)
                     for c in (a, b, late)]
            if len({_mixed_form(t, ch) for ch in chans}) == 1:
                continue
            if t == "shareddirectory" and s["orphan_dir"]:
                missing_parent += 1
                continue
            raise AssertionError(f"{doc}: {t} differs across the "
                                 f"Containers")
        edit_counts = {c.runtime.get_datastore("d").get_channel(
            "legacysharedtree").summarize_core()["edit_count"]
            for c in (a, b)}
        if len(edit_counts) != 1:
            raise AssertionError(f"{doc}: the writers' legacy tree edit "
                                 f"counts differ")
        if not s["acks"]:
            raise AssertionError(f"{doc}: writer A's summary was not acked")
    if launches <= 0 or not held or guard["calls"] <= 0:
        raise AssertionError(f"dds mixed: B1 launches {launches}, held "
                             f"dispatch {bool(held)}, guarded "
                             f"{guard['calls']}")
    for name, sc in (("merge", merge), ("tree", tree)):
        if sc.host_mode_docs() or sc.overflowed():
            raise AssertionError(f"dds mixed: the {name} sidecar has "
                                 f"{sc.host_mode_docs()} host documents")
    want, err = _check_window(held["table"], held["batch"],
                              "the dds mixed leg's dispatch")
    bad = [f for f, x, y in zip(want._fields, held["out"], want)
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"the dds mixed dispatch's output differs from "
                             f"the plain version's at {bad}")
    edits = DDS_MIXED_DOCS * DDS_MIXED_ROUNDS * 2 * (len(api.types) - 1)
    log(f"dds: mixed: {DDS_MIXED_DOCS} documents x one channel of each of "
        f"the {len(api.types)} registry types in one datastore, 2 writer "
        f"Containers + a late joiner after writer A's summarize, "
        f"{DDS_MIXED_ROUNDS} rounds of one edit per writer per type (the "
        f"summary block written before its attach only): {edits} edits, "
        f"{messages} sequenced messages; ChannelKindRouter -> "
        f"GpuMergeSidecar scan {DDS_MIXED_DOCS} x {DDS_MIXED_CAPACITY} "
        f"(sharedstring) and TreeSidecar {DDS_MIXED_DOCS} x "
        f"{tree.capacity} (sharedtree), every other type host-side; wall "
        f"{wall_s:.3f} s, {edits / wall_s:.1f} edits/s; host s: client "
        f"{host.get('client', 0.0):.3f} (authoring, flush, delivery, "
        f"summarize, loads), orderer {host.get('orderer', 0.0):.3f}, "
        f"sidecar ingest {host.get('sidecar ingest', 0.0):.3f}, sidecar "
        f"apply {host.get('sidecar apply', 0.0):.3f} (merge pack "
        f"{merge.stats['pack_s']:.3f}, tree pack "
        f"{tree.stats['pack_s']:.3f}); B1 launches {launches}; "
        + "the leg's " + _busy_line(busy, wall_s)
        + f"; checks: on every document the "
        f"sidecar's text == both writers' == the late joiner's, its "
        f"signature == the stream's scalar replay, the tree sidecar == the "
        f"three root signatures, all {len(api.types)} channels equal "
        f"across the three Containers (summarize_core(); SharedString "
        f"signature(); LegacySharedTree less edit_count) but the "
        f"SharedDirectory of {missing_parent} of the {orphaned} documents "
        f"where a writer held \"/a/b\" without \"/a\" (the reference's "
        f"missing-parent fault, ROADMAP section C), a summary acked; one "
        f"dispatch kernel == plain, every field; device half "
        f"under sync debug 'error' in {guard['calls']} dispatches; leg wall "
        f"{time.perf_counter() - t0:.3f} s with the checks")
    return {"launches": launches, "max_abs_err": err}


def phase_dds() -> dict:
    """The DDS catalogue's live sessions on the card: config3's matrices
    through real SharedMatrix channels into the matrix plane, config17's
    corpus through real SharedTree channels into the tree plane on both
    routes (live, then tiled to 1024 documents), and every channel type
    of the registry in one datastore with the string and tree channels
    routed to their planes."""
    import fluidframework_tpu_torch

    api = session_api(fluidframework_tpu_torch)
    matrix = _dds_matrix(api)
    _dds_tree(api)
    mixed = _dds_mixed(api)
    return {"launches": matrix["launches"] + mixed["launches"],
            "max_abs_err": max(matrix["max_abs_err"], mixed["max_abs_err"])}


# ----------------------------------------------------------------------
# framework: the app-facing client and the editor bindings, live

FRAMEWORK_DOCS, FRAMEWORK_CAPACITY, FRAMEWORK_MAX_CAPACITY = 1024, 512, 8192
FRAMEWORK_ROUNDS, FRAMEWORK_STEPS = 4, 8  # workload steps per editor
FRAMEWORK_UNDO_ROUND, FRAMEWORK_UNDO, FRAMEWORK_REDO = 3, 4, 2
FRAMEWORK_SCHEMA = {"text": "sharedstring", "meta": "sharedmap"}
FRAMEWORK_SEED = 11


def phase_framework() -> dict:
    """1024 documents made through ``LocalServiceClient.create_container``
    (schema: a SharedString "text" and a SharedMap "meta"), a second
    editor on each through ``get_container``; ``GpuMergeSidecar`` serves
    every document's ``initial-objects/text``, subscribed as the orderer
    of a new document is made, before its first op. Half the documents
    run ``richtext.editor_workload`` on two ``RichTextEditor``s (editor
    A with an ``UndoRedoStackManager``: one operation per workload step,
    4 undone and 2 redone after round 3), the other half
    ``flowdoc.flow_workload`` on two ``FlowDocument``s; 4 rounds of 8
    steps per editor, a flush per editor and an apply per round. Both
    workloads' comments are interval ops, which a merge sidecar cannot
    ingest (ROADMAP section C): ``add_comment`` is a no-op here, the
    rng draws unchanged, and the skipped comments are counted."""
    import fluidframework_tpu_torch
    from fluidframework_tpu_torch.framework import (
        LocalServiceClient, SharedStringUndoRedoHandler,
        UndoRedoStackManager, flowdoc, richtext,
    )
    from fluidframework_tpu_torch.framework.fluid_static import (
        SCHEMA_DATASTORE,
    )
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    rng = random.Random(FRAMEWORK_SEED)
    times = _SelfTimes()
    t0 = time.perf_counter()
    server, _ = _timed_server(session_api(fluidframework_tpu_torch), times,
                              FRAMEWORK_SEED)
    sidecar = GpuMergeSidecar(device="cuda", executor="scan",
                              max_docs=FRAMEWORK_DOCS,
                              capacity=FRAMEWORK_CAPACITY,
                              max_capacity=FRAMEWORK_MAX_CAPACITY)
    guard = _guard_device_half(sidecar)
    held = _hold_scan_dispatch(sidecar)
    sidecar.ingest = times.wrap("sidecar ingest", sidecar.ingest)
    # create_container draws a uuid document id and attaches at once:
    # the sidecar taps each document's orderer as the server makes it
    captured = {}
    get_orderer = server.get_orderer

    def serving(doc):
        made = doc not in server.documents
        orderer = get_orderer(doc)
        if made:
            captured[doc] = []
            _time_orderer(server, doc, times, captured[doc])
            sidecar.subscribe(server, doc, SCHEMA_DATASTORE, "text")
        return orderer

    server.get_orderer = serving
    skipped = collections.Counter()

    def no_comment(kind):
        def add_comment(self, start, end, text):
            skipped[kind] += 1
        return add_comment

    saved = (richtext.RichTextEditor.add_comment,
             flowdoc.FlowDocument.add_comment)
    richtext.RichTextEditor.add_comment = no_comment("richtext")
    flowdoc.FlowDocument.add_comment = no_comment("flowdoc")
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    try:
        clients = [LocalServiceClient(server, user_id=u)
                   for u in ("alice", "bob")]
        sessions = []
        with times.part("client"):
            for i in range(FRAMEWORK_DOCS):
                fa, _, doc = clients[0].create_container(FRAMEWORK_SCHEMA)
                fb, _ = clients[1].get_container(doc, FRAMEWORK_SCHEMA)
                texts = [f.initial_objects["text"] for f in (fa, fb)]
                if i % 2 == 0:
                    kind, work = "richtext", richtext.editor_workload
                    editors = [richtext.RichTextEditor(t, user=u)
                               for t, u in zip(texts, ("alice", "bob"))]
                    stack = UndoRedoStackManager()
                    SharedStringUndoRedoHandler(stack, texts[0])
                else:
                    kind, work = "flowdoc", flowdoc.flow_workload
                    editors = [flowdoc.FlowDocument(t, user=u)
                               for t, u in zip(texts, ("alice", "bob"))]
                    stack = None
                sessions.append(dict(doc=doc, kind=kind, work=work,
                                     fluid=(fa, fb), texts=texts,
                                     editors=editors, stack=stack))
        setup_s = time.perf_counter() - t0
        cuda_merge.LAUNCHES = 0
        torch.cuda.synchronize()
        prof.start()
        before = dict(times.s)
        t1 = time.perf_counter()
        undone = redone = 0
        for rnd in range(1, FRAMEWORK_ROUNDS + 1):
            for ses in sessions:
                with times.part("client"):
                    ea, eb = ses["editors"]
                    for _ in range(FRAMEWORK_STEPS):
                        ses["work"](ea, rng, 1)
                        if ses["stack"] is not None:
                            ses["stack"].close_current_operation()
                    ses["work"](eb, rng, FRAMEWORK_STEPS)
                    for f in ses["fluid"]:
                        f.container.flush()
            with times.part("sidecar apply"):
                sidecar.apply()
            if rnd == FRAMEWORK_UNDO_ROUND:
                for ses in sessions:
                    if ses["stack"] is None:
                        continue
                    with times.part("client"):
                        undone += sum(ses["stack"].undo_operation()
                                      for _ in range(FRAMEWORK_UNDO))
                        redone += sum(ses["stack"].redo_operation()
                                      for _ in range(FRAMEWORK_REDO))
                        ses["fluid"][0].container.flush()
        with times.part("sidecar apply"):
            sidecar.apply()
            sidecar.sync()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t1
        prof.stop()
    finally:
        (richtext.RichTextEditor.add_comment,
         flowdoc.FlowDocument.add_comment) = saved
    launches = cuda_merge.LAUNCHES
    busy = _device_busy_ms(prof)
    # the rounds' host seconds by part (the setup's loads excluded)
    host = {k: v - before.get(k, 0.0) for k, v in times.s.items()}

    t_check = time.perf_counter()
    messages = 0
    for ses in sessions:
        doc, (ea, eb) = ses["doc"], ses["editors"]
        served = sidecar.text(doc, SCHEMA_DATASTORE, "text")
        if {t.get_text() for t in ses["texts"]} != {served}:
            raise AssertionError(f"framework {doc}: the sidecar's text != "
                                 f"both editors' strings")
        if len({t.signature() for t in ses["texts"]}) != 1:
            raise AssertionError(f"framework {doc}: the editors' string "
                                 f"signatures differ")
        messages += len(captured[doc])
        if _oracle(_log_stream(captured[doc], SCHEMA_DATASTORE, "text")) != (
                served, sidecar.signature(doc, SCHEMA_DATASTORE, "text")):
            raise AssertionError(f"framework {doc}: the sidecar != the "
                                 f"replay of its stream")
        if ses["kind"] == "richtext":
            forms = [[(p.style, p.runs) for p in e.render()]
                     for e in (ea, eb)]
        else:
            forms = [[(b.kind, b.heading, b.runs) for b in e.render()]
                     for e in (ea, eb)]
        if forms[0] != forms[1]:
            raise AssertionError(f"framework {doc}: render() differs "
                                 f"between the editors")
    if sidecar.host_mode_docs() or sidecar.overflowed():
        raise AssertionError(f"framework: {sidecar.host_mode_docs()} host "
                             f"documents")
    if launches <= 0 or not held or guard["calls"] <= 0:
        raise AssertionError(f"framework: B1 launches {launches}, held "
                             f"dispatch {bool(held)}, guarded "
                             f"{guard['calls']}")
    if undone != FRAMEWORK_UNDO * FRAMEWORK_DOCS // 2 or \
            redone != FRAMEWORK_REDO * FRAMEWORK_DOCS // 2:
        raise AssertionError(f"framework: {undone} undone, {redone} redone")
    want, err = _check_window(held["table"], held["batch"],
                              "the framework leg's dispatch")
    bad = [f for f, x, y in zip(want._fields, held["out"], want)
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"the framework dispatch's output differs "
                             f"from the plain version's at {bad}")
    steps = FRAMEWORK_DOCS * 2 * FRAMEWORK_ROUNDS * FRAMEWORK_STEPS
    log(f"framework: {FRAMEWORK_DOCS} documents (an app's small rich-text "
        f"and webflow documents, two co-editors each) made by "
        f"LocalServiceClient.create_container({FRAMEWORK_SCHEMA}) and "
        f"joined by get_container; GpuMergeSidecar scan "
        f"{FRAMEWORK_DOCS} x {FRAMEWORK_CAPACITY} (max "
        f"{FRAMEWORK_MAX_CAPACITY}) on {SCHEMA_DATASTORE}/text, "
        f"subscribed as each document's orderer is made; "
        f"{FRAMEWORK_DOCS // 2} richtext.editor_workload documents (editor "
        f"A's UndoRedoStackManager: {undone} operations undone, {redone} "
        f"redone after round {FRAMEWORK_UNDO_ROUND}) and "
        f"{FRAMEWORK_DOCS // 2} flowdoc.flow_workload documents, "
        f"{FRAMEWORK_ROUNDS} rounds of {FRAMEWORK_STEPS} steps per editor: "
        f"{steps} workload steps, {messages} sequenced messages; comments "
        f"skipped (interval ops, ROADMAP section C): richtext "
        f"{skipped['richtext']}, flowdoc {skipped['flowdoc']}; wall "
        f"{wall_s:.3f} s, {steps / wall_s:.1f} steps/s (setup "
        f"{setup_s:.3f} s); the rounds' host s: client "
        f"{host.get('client', 0.0):.3f} (editors, flush, delivery), orderer "
        f"{host.get('orderer', 0.0):.3f}, sidecar ingest "
        f"{host.get('sidecar ingest', 0.0):.3f}, sidecar apply "
        f"{host.get('sidecar apply', 0.0):.3f} (pack "
        f"{sidecar.stats['pack_s']:.3f}); B1 launches {launches}; the "
        f"leg's " + _busy_line(busy, wall_s)
        + f"; grows {sidecar.grow_count}; checks: every document's sidecar "
        f"text == both editors' strings, their signatures equal, the "
        f"sidecar == its stream's scalar replay, render() equal across the "
        f"editors; one dispatch kernel == plain, every field; device half "
        f"under sync debug 'error' in {guard['calls']} dispatches; leg "
        f"wall {time.perf_counter() - t0:.3f} s with the checks "
        f"({time.perf_counter() - t_check:.3f} s)")
    return {"launches": launches, "max_abs_err": err}


# ----------------------------------------------------------------------
# partitioned and replicated: the ordering plane's scale-out and
# replication layer in front of the merge sidecar

PART_PARTITIONS = 4
PART_RESUMED = (0, 1)  # the partitions the durable sub-leg pauses and resumes
PART_BROKER_DOCS = 64
# depth cut of the durable and replicated legs: 1 of the service cell's
# 4 rounds, the resume or the failover at its midpoint (before the
# document SERVICE_DOCS // 2 edits); every message there fsyncs several
# files (see the fsync line)
PART_DURABLE_ROUNDS = REPL_ROUNDS = 1
# depth cuts made to fit the later phases in the script's time (PERF.md
# section 4): the in-memory and broker legs run 2 of the cell's 4 rounds,
# the durable and replicated legs 2 of its 8 edits per writer (each of
# their messages costs several fsyncs and renames)
PART_ROUNDS = 2
DURABLE_EDITS = 2
REPL_FOLLOWERS = 2  # leader + 2 followers, quorum 2 of 3
ROUND_STEP_S = 0.05  # the injected clocks move this much per round (< lease TTL)
FSYNC_PROBES = 400


class StepClock:
    """A clock that moves only when the session moves it: the sequencer
    stamps, the queue's route stamps, the lease and the fleet timeline
    read it, so two runs of one session are equal message for message."""

    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def ordering_api(package) -> types.SimpleNamespace:
    """``session_api`` plus the ordering plane's entry points, taken from
    ``package``."""
    def mod(name):
        return importlib.import_module(f"{package.__name__}.{name}")

    api = session_api(package)
    part, broker = mod("service.partitioning"), mod("service.broker")
    api.PartitionedServer = part.PartitionedServer
    api.InMemoryOrderingQueue = part.InMemoryOrderingQueue
    api.FileOrderingQueue = part.FileOrderingQueue
    api.BrokerServer = broker.BrokerServer
    api.RemoteOrderingQueue = broker.RemoteOrderingQueue
    api.ReplicatedSequencerGroup = \
        mod("service.replication").ReplicatedSequencerGroup
    api.FleetTimeline = mod("obs.timeline").FleetTimeline
    api.REGISTRY = mod("obs.metrics").REGISTRY
    api.message_to_json = mod("protocol.serialization").message_to_json
    return api


def _string(c):
    return c.runtime.get_datastore("d").get_channel("s")


def _load_pair(api, server, doc: str, times, suffix: str = "",
               create: bool = False) -> list:
    """The document's two writer Containers (client ids ``<doc>-a`` and
    ``<doc>-b`` plus ``suffix``); with ``create`` writer A attaches the
    ("d", "s") SharedString."""
    factory = api.factory(server)
    with times.part("client"):
        pair = [api.Container.load(factory.create_document_service(doc),
                                   client_id=f"{doc}-{who}{suffix}")
                for who in SERVICE_WRITERS]
        if create:
            pair[0].runtime.create_datastore("d").create_channel(
                "sharedstring", "s")
            pair[0].flush()
    return pair


def _dup_drops(api) -> float:
    return api.REGISTRY.flat().get("sidecar_duplicate_drops_total", 0.0)


def ordering_rounds(writers: dict, docs: list, rounds: int, rng, times,
                    sidecar, clock, pump=None, event=None, event_at=None,
                    after_doc=None, on_start=None,
                    edits_per_writer: int = SERVICE_EDITS) -> dict:
    """The service cell's rounds: every writer makes ``edits_per_writer``
    edits and flushes, document by document, then ``pump()`` and the
    sidecar's ``apply()``; the clock moves one step per round.
    ``on_start()`` runs once, before the first round; ``event()`` runs
    once, before document ``event_at[1]`` of round ``event_at[0]`` (the
    leg's midpoint), and splits the rounds into the part before it and
    the part after it; ``after_doc(rnd, doc)`` runs after a document's
    flushes. Returns the edits and each part's edits and wall seconds
    (the event's own time in neither)."""
    edits, walls = [0, 0], [0.0, 0.0]
    part = 0
    if on_start is not None:
        on_start()
    for rnd in range(1, rounds + 1):
        clock.t += ROUND_STEP_S
        t0 = time.perf_counter()
        for i, doc in enumerate(docs):
            if event is not None and (rnd, i) == event_at:
                walls[part] += time.perf_counter() - t0
                event()
                part = 1
                t0 = time.perf_counter()
            with times.part("client"):
                for c in writers[doc]:
                    s = _string(c)
                    for _ in range(edits_per_writer):
                        _service_edit(rng, s)
                        edits[part] += 1
                for c in writers[doc]:
                    c.flush()
            if after_doc is not None:
                after_doc(rnd, doc)
        if pump is not None:
            pump()
        if sidecar is not None:
            with times.part("sidecar apply"):
                sidecar.apply()
        walls[part] += time.perf_counter() - t0
    return {"edits": sum(edits), "part_edits": edits, "part_walls": walls}


def partitioned_leg(api, server, docs: list, rounds: int, seed: int,
                    times, sidecar, clock, resume_at=None, resume=(),
                    on_start=None,
                    edits_per_writer: int = SERVICE_EDITS) -> dict:
    """Two writers per document on a ``PartitionedServer`` (every submit
    produces a record into the ordering queue and pumps the document's
    partition), ``sidecar`` (or None) subscribed to every document's
    ("d", "s") before its first op; ``ordering_rounds`` with a
    ``svc.pump()`` per round. At ``resume_at`` (round, document index)
    the partitions ``resume`` are paused, their documents' writers close
    (their leaves queue behind the paused consumers), and the partitions
    are resumed: new consumers read from the committed offsets and
    rebuild each document's orderer from its durable checkpoint, which
    sequences a leave for every checkpointed client. The sidecar then
    re-attaches to each rebuilt orderer and replays the document's
    durable op log from seq 0, so everything it already holds drops as
    a duplicate, and fresh writers finish the rounds."""
    svc = server.svc
    _time_connect(server, times)
    for name in ("produce_op", "produce_join", "produce_leave"):
        setattr(svc, name, times.wrap("produce", getattr(svc, name)))
    svc.pump = times.wrap("pump", svc.pump)
    server.pump_document = times.wrap("pump", server.pump_document)
    rng = random.Random(seed)
    writers = {}
    for doc in docs:
        if sidecar is not None:
            sidecar.subscribe(server, doc, "d", "s")
        writers[doc] = _load_pair(api, server, doc, times, create=True)
    rec = {"moved": [], "redelivered": 0, "dropped": 0, "resume_s": 0.0}

    def resume_partitions():
        t0 = time.perf_counter()
        moved = [d for d in docs if svc.partition_of(d) in resume]
        for p in resume:
            svc.pause_partition(p)
        with times.part("client"):
            for d in moved:
                for c in writers[d]:
                    c.close()
        committed = {p: svc.queue.committed(p) for p in resume}
        for p in resume:
            svc.resume_partition(p)
        with times.part("pump"):
            redelivered = sum(svc.partitions[p].pump() for p in resume)
        drops = _dup_drops(api)
        for d in moved:
            if sidecar is not None:
                sidecar.subscribe(server, d, "d", "s")
                for msg in server.read_ops(d, 0):
                    sidecar.ingest(d, msg)
            writers[d] = _load_pair(api, server, d, times, suffix="2")
        rec.update(moved=moved, committed=committed,
                   redelivered=redelivered,
                   dropped=_dup_drops(api) - drops,
                   resume_s=time.perf_counter() - t0)

    rec.update(ordering_rounds(writers, docs, rounds, rng, times, sidecar,
                               clock, pump=svc.pump,
                               event=resume_partitions if resume else None,
                               event_at=resume_at, on_start=on_start,
                               edits_per_writer=edits_per_writer))
    rec["writers"] = writers
    return rec


def replicated_leg(api, group, docs: list, rounds: int, seed: int, times,
                   sidecar, clock, timeline, fail_at: tuple,
                   on_start=None,
                   edits_per_writer: int = SERVICE_EDITS) -> dict:
    """Two writers per document through ``LocalDocumentServiceFactory(
    group.server)``, ``sidecar`` subscribed to every document's ("d",
    "s"); ``ordering_rounds``. At ``fail_at`` (round, document index)
    the leader dies (``leader_kill`` on ``timeline``, ``kill_leader()``),
    the clock moves past the lease TTL, ``failover()`` promotes the
    best-replicated follower, the old writers close (the deposed
    server's fence absorbs their leaves), the sidecar re-attaches to
    every document's new orderer, fresh writers load and the clock
    moves one step; the first flush after that records ``first_ack``."""
    _time_connect(group.server, times)
    barrier = {"calls": 0}
    replicate = group.replicate_before_fanout

    def counted(*args, **kw):
        barrier["calls"] += 1
        with times.part("quorum barrier"):
            return replicate(*args, **kw)

    group.replicate_before_fanout = counted
    rng = random.Random(seed)
    writers = {}
    for doc in docs:
        sidecar.subscribe(group.server, doc, "d", "s")
        _time_orderer(group.server, doc, times)
        writers[doc] = _load_pair(api, group.server, doc, times, create=True)
    rec = {"barrier": barrier}

    def fail_over():
        t0 = time.perf_counter()
        rec["killed"] = group.leader_id
        rec["head_at_kill"] = {d: group.server.get_orderer(d).op_log.last_seq
                               for d in docs}
        timeline.record("leader_kill", node=group.leader_id)
        group.kill_leader()
        clock.t += group.lease.ttl + 0.01
        group.failover()
        _time_connect(group.server, times)
        with times.part("client"):
            for d in docs:
                for c in writers[d]:
                    c.close()
        resumed = {}
        for d in docs:
            sidecar.subscribe(group.server, d, "d", "s")
            orderer = group.server.get_orderer(d)
            resumed[d] = (orderer.sequencer.sequence_number,
                          orderer.op_log.last_seq)
            _time_orderer(group.server, d, times)
        rec.update(resumed=resumed, failover_s=time.perf_counter() - t0)
        for d in docs:
            writers[d] = _load_pair(api, group.server, d, times, suffix="2")
        rec["reload_s"] = time.perf_counter() - t0 - rec["failover_s"]
        clock.t += ROUND_STEP_S

    def after_doc(rnd, doc):
        if "killed" in rec and "phases" not in rec:
            timeline.record("first_ack", node=group.leader_id)
            rec["phases"] = timeline.failover_phases()

    rec.update(ordering_rounds(writers, docs, rounds, rng, times, sidecar,
                               clock, event=fail_over, event_at=fail_at,
                               after_doc=after_doc, on_start=on_start,
                               edits_per_writer=edits_per_writer))
    rec["writers"] = writers
    return rec


def fsync_probe(root: str) -> dict:
    """The fsync latency of a jsonl append in ``root`` (the durable
    roots' directory), and the filesystem it is on."""
    import os
    import tempfile

    lat = []
    with tempfile.NamedTemporaryFile("w", dir=root, suffix=".jsonl") as f:
        for i in range(FSYNC_PROBES):
            f.write(json.dumps({"sequenceNumber": i, "pad": "x" * 200})
                    + "\n")
            f.flush()
            t0 = time.perf_counter()
            os.fsync(f.fileno())
            lat.append(time.perf_counter() - t0)
    lat.sort()
    fs, best = "unknown", ""
    with open("/proc/mounts") as mounts:
        for line in mounts:
            parts = line.split()
            if len(parts) > 2 and os.path.realpath(root).startswith(
                    parts[1]) and len(parts[1]) > len(best):
                best, fs = parts[1], f"{parts[2]} on {parts[1]}"
    return {"median_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[int(len(lat) * 0.99)] * 1e3,
            "mean_ms": statistics.mean(lat) * 1e3, "fs": fs}


def _raise_nofile() -> tuple:
    """Lift this process's open-file limit to its hard limit: every
    durable document keeps its op log open, and a replicated one keeps
    one per follower too (1024 documents: thousands of files)."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard == resource.RLIM_INFINITY or hard > soft:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    return soft, resource.getrlimit(resource.RLIMIT_NOFILE)[0]


def _ordering_sidecar(docs: int):
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    return GpuMergeSidecar(device="cuda", executor="scan", max_docs=docs,
                           capacity=SERVICE_CAPACITY,
                           max_capacity=SERVICE_MAX_CAPACITY)


def _check_served(server, docs: list, writers: dict, sidecar,
                  what: str) -> int:
    """Every document: both writers equal, the sidecar equal to them and
    to its op log's scalar replay, and a second sidecar fed every op log
    once, in order, equal to the live one. Returns the messages."""
    shadow = _ordering_sidecar(len(docs))
    messages = 0
    for doc in docs:
        texts = {_string(c).get_text() for c in writers[doc]}
        sigs = {_string(c).signature() for c in writers[doc]}
        served = sidecar.text(doc, "d", "s")
        if texts != {served} or len(sigs) != 1:
            raise AssertionError(f"{what} {doc}: the sidecar's text != both "
                                 f"writers'")
        log_msgs = server.read_ops(doc, 0)
        seqs = [m.sequence_number for m in log_msgs]
        if seqs != list(range(1, len(seqs) + 1)):
            raise AssertionError(f"{what} {doc}: the op log is not "
                                 f"contiguous")
        messages += len(log_msgs)
        if _oracle(_log_stream(log_msgs)) != (
                served, sidecar.signature(doc, "d", "s")):
            raise AssertionError(f"{what} {doc}: the sidecar != its op "
                                 f"log's scalar replay")
        shadow.track(doc, "d", "s")
        for msg in log_msgs:
            shadow.ingest(doc, msg)
    shadow.apply()
    shadow.sync()
    for doc in docs:
        if (shadow.text(doc, "d", "s"), shadow.signature(doc, "d", "s")) \
                != (sidecar.text(doc, "d", "s"),
                    sidecar.signature(doc, "d", "s")):
            raise AssertionError(f"{what} {doc}: the live sidecar != a "
                                 f"sidecar fed its op log once, in order")
    if sidecar.host_mode_docs() or sidecar.overflowed():
        raise AssertionError(f"{what}: {sidecar.host_mode_docs()} host "
                             f"documents")
    return messages


def _canon_json(rec: dict) -> dict:
    """A sequenced message's record without what reads the wall clock
    (the client's and the driver's hops, a join's client-detail time)
    and the crc that covers them."""
    rec = {k: v for k, v in rec.items() if k != "_crc"}
    rec["traces"] = [t for t in rec.get("traces") or []
                     if t["service"] not in ("client", "driver")]
    contents = rec.get("contents")
    if isinstance(contents, dict) and "__clientdetail__" in contents:
        detail = dict(contents["__clientdetail__"])
        detail.pop("timestamp", None)
        rec["contents"] = {**contents, "__clientdetail__": detail}
    return rec


def _host_split(times, before: dict, parts) -> str:
    host = {k: v - before.get(k, 0.0) for k, v in times.s.items()}
    return ", ".join(f"{p} {host.get(p, 0.0):.3f}" for p in parts)


def _broker_leg(api, seed: int) -> dict:
    """``PART_BROKER_DOCS`` documents through an in-process
    ``BrokerServer`` and ``RemoteOrderingQueue`` over TCP, a sidecar on
    each document; the same session on an ``InMemoryOrderingQueue``
    gives the same sequenced streams."""
    from fluidframework_tpu_torch.ops import cuda_merge

    docs = [f"brk-{d}" for d in range(PART_BROKER_DOCS)]
    loop = _Loop()
    broker = api.BrokerServer(PART_PARTITIONS)
    queue = None
    try:
        loop.run(broker.start(), 30)
        queue = api.RemoteOrderingQueue("127.0.0.1", broker.port)
        times = _SelfTimes()
        clock = StepClock()
        server = api.PartitionedServer(n_partitions=PART_PARTITIONS,
                                       queue=queue, clock=clock)
        sidecar = _ordering_sidecar(len(docs))
        sidecar.ingest = times.wrap("sidecar ingest", sidecar.ingest)
        launches = cuda_merge.LAUNCHES
        t0 = time.perf_counter()
        rec = partitioned_leg(api, server, docs, PART_ROUNDS, seed + 7,
                              times, sidecar, clock)
        sidecar.sync()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = cuda_merge.LAUNCHES - launches
        streams = {d: [_canon_json(api.message_to_json(m))
                       for m in server.read_ops(d, 0)] for d in docs}
        committed = [queue.committed(p) for p in range(PART_PARTITIONS)]
        lag = queue.fanout_lag()
    finally:
        if queue is not None:
            queue.close()
        loop.run(broker.stop(), 30)
        loop.close()
    twin_clock = StepClock()
    twin = api.PartitionedServer(n_partitions=PART_PARTITIONS,
                                 queue=api.InMemoryOrderingQueue(
                                     PART_PARTITIONS), clock=twin_clock)
    partitioned_leg(api, twin, docs, PART_ROUNDS, seed + 7, _SelfTimes(),
                    None, twin_clock)
    for d in docs:
        if streams[d] != [_canon_json(api.message_to_json(m))
                          for m in twin.read_ops(d, 0)]:
            raise AssertionError(f"broker {d}: the sequenced stream over "
                                 f"TCP != the in-memory queue's")
    if committed != [twin.queue.committed(p) for p in range(PART_PARTITIONS)] \
            or lag != 0:
        raise AssertionError(f"broker: committed {committed}, lag {lag}")
    if server.svc.nacks or twin.svc.nacks:
        raise AssertionError("broker: nacks")
    messages = _check_served(server, docs, rec["writers"], sidecar, "broker")
    return {"launches": launches, "edits": rec["edits"], "wall_s": wall_s,
            "messages": messages, "committed": committed}


def phase_partitioned(seed: int) -> dict:
    """The service cell's traffic through the partitioned ordering
    service: ``PartitionedServer(n_partitions=4)``, every submit a record
    of the ordering queue that the document's partition consumer
    sequences, ``GpuMergeSidecar`` subscribed to every document. Three
    sub-legs: the in-memory queue (1024 documents, ``PART_ROUNDS`` of the
    cell's 4 rounds);
    the durable queue (``FileOrderingQueue`` with fsync, a
    ``durable_dir`` op log and checkpoint per document; partitions 0 and
    1 paused and resumed from their committed offsets at the midpoint,
    the sidecar re-attached and replaying the durable logs, its
    duplicates dropped); the networked broker (``_broker_leg``)."""
    import os
    import tempfile

    import fluidframework_tpu_torch
    from fluidframework_tpu_torch.ops import cuda_merge

    api = ordering_api(fluidframework_tpu_torch)
    docs = [f"part-{d}" for d in range(SERVICE_DOCS)]
    out = {"launches": 0, "max_abs_err": 0}
    soft, nofile = _raise_nofile()
    probe = fsync_probe(tempfile.gettempdir())
    log(f"fsync: {FSYNC_PROBES} appends of a 230-byte jsonl record in the "
        f"temp directory {tempfile.gettempdir()} ({probe['fs']}): median "
        f"{probe['median_ms']:.4f} ms, p99 {probe['p99_ms']:.4f} ms, mean "
        f"{probe['mean_ms']:.4f} ms per fsync; the durable and replicated "
        f"legs fsync every queue record, op-log append, checkpoint and "
        f"follower append, and run {PART_DURABLE_ROUNDS} / {REPL_ROUNDS} of "
        f"the cell's {SERVICE_ROUNDS} rounds with {DURABLE_EDITS} of its "
        f"{SERVICE_EDITS} edits per writer, the resume / failover at its "
        f"midpoint (depth cut); open-file limit "
        f"{soft} -> {nofile}")
    for leg in ("in-memory", "durable"):
        times = _SelfTimes()
        clock = StepClock()
        t0 = time.perf_counter()
        with (tempfile.TemporaryDirectory(prefix="ffpart-")
              if leg == "durable" else contextlib.nullcontext()) as root:
            if leg == "in-memory":
                queue, durable_dir, rounds = (
                    api.InMemoryOrderingQueue(PART_PARTITIONS), None,
                    PART_ROUNDS)
                edits_per_writer = SERVICE_EDITS
            else:
                durable_dir = root
                queue = api.FileOrderingQueue(
                    os.path.join(root, "queue"), PART_PARTITIONS, fsync=True)
                rounds = PART_DURABLE_ROUNDS
                edits_per_writer = DURABLE_EDITS
            server = api.PartitionedServer(n_partitions=PART_PARTITIONS,
                                           durable_dir=durable_dir,
                                           queue=queue, clock=clock)
            sidecar = _ordering_sidecar(SERVICE_DOCS)
            guard = _guard_device_half(sidecar)
            held = _hold_scan_dispatch(sidecar)
            sidecar.ingest = times.wrap("sidecar ingest", sidecar.ingest)
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            before = {}

            def start_rounds():
                before.update(times.s)
                cuda_merge.LAUNCHES = 0
                torch.cuda.synchronize()
                prof.start()
                before["t"] = time.perf_counter()

            midpoint = (1, len(docs) // 2)
            rec = partitioned_leg(
                api, server, docs, rounds, seed, times, sidecar, clock,
                resume_at=midpoint,
                resume=PART_RESUMED if leg == "durable" else (),
                on_start=start_rounds, edits_per_writer=edits_per_writer)
            with times.part("sidecar apply"):
                sidecar.sync()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - before["t"]
            prof.stop()
            launches = cuda_merge.LAUNCHES
            busy = _device_busy_ms(prof)
            split = _host_split(times, before, (
                "client", "produce", "pump", "sidecar ingest",
                "sidecar apply"))
            t_check = time.perf_counter()
            if server.svc.nacks:
                raise AssertionError(f"partitioned {leg}: "
                                     f"{len(server.svc.nacks)} nacks")
            messages = _check_served(server, docs, rec["writers"], sidecar,
                                     f"partitioned {leg}")
            if launches <= 0 or not held or guard["calls"] <= 0:
                raise AssertionError(f"partitioned {leg}: B1 launches "
                                     f"{launches}, held {bool(held)}")
            want, err = _check_window(held["table"], held["batch"],
                                      f"the partitioned {leg} dispatch")
            if [f for f, x, y in zip(want._fields, held["out"], want)
                    if not torch.equal(x, y)]:
                raise AssertionError(f"the partitioned {leg} dispatch's "
                                     f"output differs from the plain "
                                     f"version's")
            extra = ""
            if leg == "durable":
                moved = rec["moved"]
                if not moved or rec["dropped"] <= 0:
                    raise AssertionError(f"partitioned durable: resumed "
                                         f"{len(moved)} documents, dropped "
                                         f"{rec['dropped']}")
                counts = [queue._counts[p] for p in range(PART_PARTITIONS)]
                committed = [queue.committed(p)
                             for p in range(PART_PARTITIONS)]
                if committed != [c - 1 for c in counts]:
                    raise AssertionError(f"partitioned durable: committed "
                                         f"{committed} of {counts}")
                extra = (f"; partitions {list(PART_RESUMED)} paused and "
                         f"resumed at the midpoint, before document "
                         f"{midpoint[1]} of round {midpoint[0]} edits "
                         f"({len(moved)} documents, committed offsets "
                         f"{rec['committed']}): the new consumers read "
                         f"{rec['redelivered']} queued records from the "
                         f"committed offsets, the rebuilt orderers "
                         f"sequenced the checkpointed clients' leaves, the "
                         f"sidecar re-attached and replayed the durable op "
                         f"logs from seq 0: sidecar_duplicate_drops_total "
                         f"+{rec['dropped']:.0f}, fresh writers finished "
                         f"the round ({rec['resume_s']:.3f} s); queue "
                         f"records {counts}, committed {committed}; depth "
                         f"cut: {rounds} of the cell's {SERVICE_ROUNDS} "
                         f"rounds, {edits_per_writer} of its {SERVICE_EDITS} "
                         f"edits per writer (an fsync per queue record and "
                         f"op-log append, a write-temp + fsync + rename "
                         f"per checkpoint and committed offset)")
            log(f"partitioned {leg}: {SERVICE_DOCS} docs x "
                f"{len(SERVICE_WRITERS)} writers, PartitionedServer("
                f"{PART_PARTITIONS} partitions, "
                f"{type(queue).__name__}"
                f"{', fsync' if leg == 'durable' else ''}) -> "
                f"GpuMergeSidecar scan {SERVICE_DOCS} x {SERVICE_CAPACITY}; "
                f"{rounds} round(s) x {edits_per_writer} edits per writer: "
                f"{rec['edits']} edits, {messages} sequenced messages; "
                f"rounds wall {wall_s:.3f} s"
                + (f" ({rec['resume_s']:.3f} s of it the resume)"
                   if leg == "durable" else "")
                + f", {rec['edits'] / sum(rec['part_walls']):.1f} edits/s "
                f"(leg wall {time.perf_counter() - t0:.3f} s); the "
                f"rounds' host s: {split}; B1 launches {launches}; "
                + _busy_line(busy, wall_s) + extra
                + f"; checks: no nacks, every document == both writers == "
                f"its op log's scalar replay, the sidecar == a second "
                f"sidecar fed the op logs once, in order; one dispatch "
                f"kernel == plain ({time.perf_counter() - t_check:.3f} s)")
            out["launches"] += launches
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out[leg] = rec["edits"] / sum(rec["part_walls"])
    brk = _broker_leg(api, seed)
    log(f"partitioned broker: {PART_BROKER_DOCS} docs x "
        f"{len(SERVICE_WRITERS)} writers through an in-process BrokerServer "
        f"and RemoteOrderingQueue over TCP, {PART_ROUNDS} of the cell's "
        f"{SERVICE_ROUNDS} rounds: "
        f"{brk['edits']} edits, {brk['messages']} sequenced messages, "
        f"{brk['edits'] / brk['wall_s']:.1f} edits/s; committed offsets "
        f"{brk['committed']}; B1 launches {brk['launches']}; checks: every "
        f"sequenced stream == the same session's on an "
        f"InMemoryOrderingQueue, no nacks, every document == both writers "
        f"== its op log's replay == a second sidecar")
    out["launches"] += brk["launches"]
    return out


def phase_replicated(seed: int) -> dict:
    """The service cell's traffic through the replicated sequencer:
    ``ReplicatedSequencerGroup(root, n_followers=2)`` (quorum 2 of 3, an
    injected step clock, a ``FleetTimeline``), writers through
    ``LocalDocumentServiceFactory(group.server)``, ``GpuMergeSidecar``
    subscribed to every document; a leader kill, lease lapse and
    ``failover()`` at the midpoint, then fresh writers on the promoted
    leader."""
    import tempfile

    import fluidframework_tpu_torch
    from fluidframework_tpu_torch.ops import cuda_merge

    api = ordering_api(fluidframework_tpu_torch)
    docs = [f"repl-{d}" for d in range(SERVICE_DOCS)]
    times = _SelfTimes()
    clock = StepClock()
    timeline = api.FleetTimeline(clock=clock)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ffrepl-") as root:
        group = api.ReplicatedSequencerGroup(
            root, n_followers=REPL_FOLLOWERS, clock=clock,
            timeline=timeline, server_kwargs={"clock": clock})
        quorum = group.quorum
        sidecar = _ordering_sidecar(SERVICE_DOCS)
        guard = _guard_device_half(sidecar)
        held = _hold_scan_dispatch(sidecar)
        sidecar.ingest = times.wrap("sidecar ingest", sidecar.ingest)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        before = {}

        def start_rounds():
            before.update(times.s)
            cuda_merge.LAUNCHES = 0
            torch.cuda.synchronize()
            prof.start()
            before["t"] = time.perf_counter()

        fail_at = (1, len(docs) // 2)
        rec = replicated_leg(api, group, docs, REPL_ROUNDS, seed, times,
                             sidecar, clock, timeline, fail_at,
                             on_start=start_rounds,
                             edits_per_writer=DURABLE_EDITS)
        with times.part("sidecar apply"):
            sidecar.sync()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - before["t"]
        prof.stop()
        launches = cuda_merge.LAUNCHES
        busy = _device_busy_ms(prof)
        split = _host_split(times, before, (
            "client", "orderer", "quorum barrier", "sidecar ingest",
            "sidecar apply"))
        t_check = time.perf_counter()
        bad = [d for d, (seq, head) in rec["resumed"].items()
               if seq != head or head < rec["head_at_kill"][d]]
        if bad:
            raise AssertionError(f"replicated: {len(bad)} promoted orderers "
                                 f"off their op log's head, e.g. {bad[0]}")
        phases = rec.get("phases")
        if phases is None or round(sum(
                v for k, v in phases.items() if k != "total_s"), 9) != \
                phases["total_s"]:
            raise AssertionError(f"replicated: failover_phases {phases}")
        messages = _check_served(group.server, docs, rec["writers"],
                                 sidecar, "replicated")
        if launches <= 0 or not held or guard["calls"] <= 0:
            raise AssertionError(f"replicated: B1 launches {launches}")
        want, err = _check_window(held["table"], held["batch"],
                                  "the replicated dispatch")
        if [f for f, x, y in zip(want._fields, held["out"], want)
                if not torch.equal(x, y)]:
            raise AssertionError("the replicated dispatch's output differs "
                                 "from the plain version's")
        heads = [f.total_head() for f in group.followers]
        (pre_edits, post_edits), (pre_s, post_s) = (rec["part_edits"],
                                                    rec["part_walls"])
        pre, post = pre_edits / pre_s, post_edits / post_s
        log(f"replicated: {SERVICE_DOCS} docs x {len(SERVICE_WRITERS)} "
            f"writers, ReplicatedSequencerGroup (leader + {REPL_FOLLOWERS} "
            f"followers, quorum {quorum} of {REPL_FOLLOWERS + 1}, every "
            f"append fsynced on each node, step clock) -> GpuMergeSidecar "
            f"scan {SERVICE_DOCS} x {SERVICE_CAPACITY}; {REPL_ROUNDS} round(s) "
            f"x {DURABLE_EDITS} edits per writer (depth cut of the cell's "
            f"{SERVICE_ROUNDS} x {SERVICE_EDITS}): {rec['edits']} edits, "
            f"{messages} sequenced messages; {rec['killed']} killed at the "
            f"midpoint, before "
            f"document {fail_at[1]} of round {fail_at[0]} edits, "
            f"lease lapsed, {group.leader_id} promoted at epoch "
            f"{group.epoch} (failover {rec['failover_s']:.3f} s host with "
            f"the sidecar's re-attach, fresh writers' loads "
            f"{rec['reload_s']:.3f} s); failover_phases {phases}; edits/s "
            f"before {pre:.1f} ({pre_edits} edits in {pre_s:.3f} s), after "
            f"{post:.1f} ({post_edits} in {post_s:.3f} s) (rounds wall "
            f"{wall_s:.3f} s with the failover, leg wall "
            f"{time.perf_counter() - t0:.3f} s); "
            f"quorum waits {rec['barrier']['calls']}, max follower lag "
            f"{group.max_lag_observed}, surviving follower heads {heads}; "
            f"the rounds' host s: {split}; B1 launches {launches}; "
            + _busy_line(busy, wall_s)
            + f"; checks: every promoted orderer's seq == its op log's "
            f"head, every document == both writers == its op log's scalar "
            f"replay, the live sidecar == a shadow sidecar fed the new "
            f"leader's durable logs from seq 0, the phases sum to total_s; "
            f"one dispatch kernel == plain "
            f"({time.perf_counter() - t_check:.3f} s)")
    return {"launches": launches, "max_abs_err": err, "pre": pre,
            "post": post}


# ----------------------------------------------------------------------
# config5: bench's full-service replay, the array lane, at full width

# bench.stage_config5's scales (bench.py:1040-1044): documents, distinct
# streams, steps, clients, capacity, messages per round
CONFIG5_SCALES = {"full": (16384, 16, 220, 4, 1024, 64),
                  "smoke": (64, 4, 40, 2, 256, 20)}
CONFIG5_SEED0 = 777  # bench's corpus seed for config5
CONFIG5_TIMED_RUNS = 2  # timed pipeline passes after the warm-up
CONFIG5_ORACLE_DOCS = 4  # documents held to the MergeTreeClient oracle


def config5_rounds(raw: list, encoded: list, docs: int,
                   apply_every: int) -> list:
    """bench's columnar prep of config5 (bench.py:1064-1152): document
    ``d`` replays distinct stream ``d % len(raw)``; round ``r`` holds
    each document's operation messages ``[r * apply_every, (r + 1) *
    apply_every)`` as the boxcar's ticket inputs (``doc_start``,
    ``cids`` parsed from ``client-N``, ``csns``, ``refs``, the op rows
    per message ``counts``) and their op rows as ``[docs, win]`` content
    windows (NOOP-padded), ``flat_dst`` the rows' flat slots. Every
    round pads to one window width ``win``, as bench does."""
    from fluidframework_tpu_torch.ops.host_bridge import OP_FIELDS
    from fluidframework_tpu_torch.ops.segment_table import KIND_NOOP
    from fluidframework_tpu_torch.protocol.messages import MessageType

    prep = []
    for enc, stream in zip(encoded, raw):
        msgs = [m for m in stream if m.type == MessageType.OPERATION]
        rows = [op for op in enc.ops if op["kind"] != KIND_NOOP]
        by_seq = collections.Counter(op["seq"] for op in rows)
        counts = np.array([by_seq[m.sequence_number] for m in msgs],
                          np.int64)
        assert counts.sum() == len(rows)
        prep.append({
            "counts": counts,
            "cids": np.array([int(m.client_id.rsplit("-", 1)[1])
                              for m in msgs], np.int64),
            "csns": np.array([m.client_sequence_number for m in msgs],
                             np.int64),
            "refs": np.array([m.reference_sequence_number for m in msgs],
                             np.int64),
            "rows": np.array([[op[f] for f in OP_FIELDS] for op in rows],
                             np.int32).reshape(len(rows), len(OP_FIELDS)),
            "row0": np.concatenate([[0], np.cumsum(counts)]),
        })
    tile = np.arange(docs) % len(prep)
    n_rounds = -(-max(len(p["counts"]) for p in prep) // apply_every)
    spans = [[(min(r * apply_every, len(p["counts"])),
               min((r + 1) * apply_every, len(p["counts"]))) for p in prep]
             for r in range(n_rounds)]
    win = max(1, max(int(p["row0"][m1] - p["row0"][m0])
                     for sp in spans for p, (m0, m1) in zip(prep, sp)))
    rounds = []
    for sp in spans:
        msgs = np.array([m1 - m0 for m0, m1 in sp])[tile]
        if not msgs.sum():
            break
        base = np.zeros((len(prep), win, len(OP_FIELDS)), np.int32)
        base[..., OP_FIELDS.index("kind")] = KIND_NOOP
        n_rows = np.zeros(len(prep), np.int64)
        for b, (p, (m0, m1)) in enumerate(zip(prep, sp)):
            r0, r1 = p["row0"][m0], p["row0"][m1]
            base[b, :r1 - r0] = p["rows"][r0:r1]
            n_rows[b] = r1 - r0
        content = base[tile]
        rows_of = n_rows[tile]
        doc_of_row = np.repeat(np.arange(docs), rows_of)
        starts = np.concatenate([[0], np.cumsum(rows_of)[:-1]])
        row_in_doc = np.arange(len(doc_of_row)) - np.repeat(starts, rows_of)

        def cat(key):
            parts = [p[key][m0:m1] for p, (m0, m1) in zip(prep, sp)]
            return np.concatenate([parts[b] for b in tile])

        rounds.append({
            "doc_start": np.concatenate([[0], np.cumsum(msgs)]),
            "cids": cat("cids"), "csns": cat("csns"), "refs": cat("refs"),
            "counts": cat("counts"),
            "content": {f: np.ascontiguousarray(content[..., j])
                        for j, f in enumerate(OP_FIELDS)},
            "flat_dst": doc_of_row * win + row_in_doc,
            "doc_of_row": doc_of_row.astype(np.int32),
            "win": win,
        })
    return rounds


def _pct(ascending: list, q: float) -> float:
    """Percentile by rank on an ascending sample (bench's ``_pct``)."""
    return ascending[min(len(ascending) - 1, int(len(ascending) * q))]


def config5_sequencer(multi_doc_sequencer, docs: int, clients: int):
    """A ``MultiDocSequencer`` (either package's class) of ``docs``
    documents, clients 0 .. ``clients - 1`` joined to each (bench's
    ``make_seqs``)."""
    seqs = multi_doc_sequencer(docs)
    for d in range(docs):
        for c in range(clients):
            seqs.join(d, c)
    return seqs


def run_config5(seqs, table, rounds: list, upload, apply, parts=None,
                tickets=None, sync=None):
    """One pass of the array lane (bench's ``run_pipeline``): per round
    one ``ticket_boxcar`` call over every document, ``np.repeat`` and
    two scatters stamp ``seq`` / ``min_seq`` on the round's op rows,
    ``upload`` puts the window on the table's device and ``apply``
    dispatches it; ``sync(table)`` after each round, if given. Host
    seconds per part go into ``parts`` and each round's (seq, msn,
    status) into ``tickets``. Returns (table, real ops, round walls)."""
    total, walls = 0, []
    for rd in rounds:
        t0 = time.perf_counter()
        seq, msn, status = seqs.ticket_boxcar(
            rd["doc_start"], rd["cids"], rd["csns"], rd["refs"])
        t1 = time.perf_counter()
        if tickets is not None:
            tickets.append((seq, msn, status))
        if status.any():
            raise AssertionError(f"config5: {int((status != 0).sum())} "
                                 f"tickets refused")
        arrays = dict(rd["content"])
        for f, v in (("seq", seq), ("min_seq", msn)):
            stamped = arrays[f].copy()
            stamped.reshape(-1)[rd["flat_dst"]] = np.repeat(
                v, rd["counts"]).astype(np.int32)
            arrays[f] = stamped
        t2 = time.perf_counter()
        batch = upload(arrays)
        t3 = time.perf_counter()
        table = apply(table, batch)
        if sync is not None:
            sync(table)
        t4 = time.perf_counter()
        total += len(rd["flat_dst"])
        walls.append(t4 - t0)
        if parts is not None:
            for k, dt in (("ticket", t1 - t0), ("scatter", t2 - t1),
                          ("upload", t3 - t2), ("dispatch", t4 - t3)):
                parts[k] = parts.get(k, 0.0) + dt
    return table, total, walls


def run_config5_host(seqs, session, rounds: list) -> tuple:
    """bench's CPU route (bench.py:1172-1225): the same tickets, the
    rows stamped and replayed by the C++ host tier (``MergeHostSession``)
    in per-document sequenced order. Returns (real ops, seconds)."""
    from fluidframework_tpu_torch.ops.host_bridge import OP_FIELDS

    f_seq, f_msn = OP_FIELDS.index("seq"), OP_FIELDS.index("min_seq")
    flat = []
    for rd in rounds:
        doc, row = np.divmod(rd["flat_dst"], rd["win"])
        flat.append(np.stack([rd["content"][f][doc, row]
                              for f in OP_FIELDS], axis=1))
    total, t0 = 0, time.perf_counter()
    for rd, rows in zip(rounds, flat):
        seq, msn, status = seqs.ticket_boxcar(
            rd["doc_start"], rd["cids"], rd["csns"], rd["refs"])
        if status.any():
            raise AssertionError("config5: host tier tickets refused")
        rows[:, f_seq] = np.repeat(seq, rd["counts"])
        rows[:, f_msn] = np.repeat(msn, rd["counts"])
        session.apply(rows, rd["doc_of_row"])
        total += len(rows)
    return total, time.perf_counter() - t0


def _cpp_replay_rate(encoded: list, min_seconds: float = 1.0) -> float:
    """ops/s of the C++ scalar replayer over the distinct streams, reps
    calibrated to fill ``min_seconds`` (bench's ``_cpp_baseline``,
    bench.py:211-235)."""
    from fluidframework_tpu_torch.native.replay_baseline import (
        encode_ops_array, replay,
    )

    arrays = [encode_ops_array(e) for e in encoded]
    probe = replay(arrays[0], reps=1)
    if probe is None:
        raise AssertionError("config5: the C++ replayer did not load")
    reps = max(1, int(min_seconds / (max(probe[2], 1e-6) * len(arrays))))
    ops = secs = 0.0
    for arr in arrays:
        _, _, dt = replay(arr, reps=reps)
        ops += arr.shape[0] * reps
        secs += dt
    return ops / secs


def _check_tiles(table, base: int) -> None:
    """Every document's live slots, on every field, equal those of its
    tile's first document ``d % base``, compared on the device."""
    docs, cap = table.docs, table.capacity
    first = torch.arange(docs, device=table.count.device) % base
    for f in ("count", "min_seq", "overflow"):
        x = getattr(table, f)
        if not torch.equal(x, x[first]):
            raise AssertionError(f"config5: {f} differs from the tile's "
                                 "first document")
    live = (torch.arange(cap, device=table.count.device)[None, :]
            < table.count[:, None])
    for f in table._fields[:-3]:
        x = getattr(table, f)
        mask = live if x.dim() == 2 else live[..., None]
        if not torch.equal(torch.where(mask, x, 0),
                           torch.where(mask, x[first], 0)):
            raise AssertionError(f"config5: live {f} differs from the "
                                 "tile's first document")


def phase_config5(card: str) -> dict:
    """bench config5 at ``full`` (``bench.stage_config5``): 16384
    documents x 4 clients replay bench's corpus through the array lane,
    one native ``MultiDocSequencer.ticket_boxcar`` call and one B1
    dispatch per round of 64 messages per document."""
    from fluidframework_tpu_torch import native
    from fluidframework_tpu_torch.convert import batch_from_numpy
    from fluidframework_tpu_torch.models.mergetree import MergeTreeClient
    from fluidframework_tpu_torch.native.replay_baseline import (
        MergeHostSession, table_checksum,
    )
    from fluidframework_tpu_torch.native.sequencer_core import (
        MultiDocSequencer,
    )
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.host_bridge import (
        encode_stream, extract_text, fetch,
    )
    from fluidframework_tpu_torch.ops.merge_kernel import apply_window
    from fluidframework_tpu_torch.ops.segment_table import make_table
    from fluidframework_tpu_torch.ops.window_cost import window_cost
    from fluidframework_tpu_torch.protocol.messages import MessageType

    docs, base, steps, clients, cap, every = CONFIG5_SCALES["full"]
    t0 = time.perf_counter()
    for lib, err in ((native.load_native_sequencer(),
                      native.native_build_error),
                     (native.load_merge_replay(),
                      native.merge_replay_error)):
        if lib is None:
            raise AssertionError(f"config5: a native library did not "
                                 f"build or load: {err()}")
    raw = bench_streams(base, steps, clients, CONFIG5_SEED0)
    encoded = [encode_stream(s) for s in raw]
    rounds = config5_rounds(raw, encoded, docs, every)
    win = rounds[0]["win"]
    prep_s = time.perf_counter() - t0

    def upload(arrays):
        return batch_from_numpy(arrays, "cuda")

    def sync(table):
        torch.cuda.synchronize()

    # warm-up pass: keep each round's input table and batch
    held = []

    def hold(table, batch):
        held.append((table, batch))
        return apply_window(table, batch)

    run_config5(config5_sequencer(MultiDocSequencer, docs, clients),
                make_table(docs, cap, "cuda"), rounds, upload, hold)
    _, err = _check_window(*held[0], "config5's first round")
    b1_ms, bounds = [], []
    for table_in, batch in held:
        b1_ms.append(statistics.median(
            _time_ms(lambda: apply_window(table_in, batch), 5, 3)))
        bounds.append(window_cost(table_in, batch).bound_ms(
            HBM_BYTES_PER_S, INT32_OPS_PER_S))
    kernel_check_s = time.perf_counter() - t0 - prep_s
    held.clear()
    runs = []
    for _ in range(CONFIG5_TIMED_RUNS):
        seqs = config5_sequencer(MultiDocSequencer, docs, clients)
        table = make_table(docs, cap, "cuda")
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        table, total, _ = run_config5(seqs, table, rounds, upload,
                                      apply_window)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t_run)
        del table
    # the synced pass: round latency, the host split, the device's busy
    # time from a trace and, per round, from CUDA events recorded before
    # the upload and after the dispatch
    seqs = config5_sequencer(MultiDocSequencer, docs, clients)
    table = make_table(docs, cap, "cuda")
    parts, marks = {}, []

    def upload_marked(arrays):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return upload(arrays)

    def apply_marked(table, batch):
        out = apply_window(table, batch)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return out

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    cuda_merge.LAUNCHES = 0
    prof.start()
    t_run = time.perf_counter()
    table, total, lat = run_config5(seqs, table, rounds, upload_marked,
                                    apply_marked, parts=parts, sync=sync)
    synced_s = time.perf_counter() - t_run
    prof.stop()
    launches = cuda_merge.LAUNCHES
    busy = _device_busy_ms(prof)
    marked_ms = sum(a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2]))
    if launches != len(rounds):
        raise AssertionError(f"config5: B1 launches {launches} for "
                             f"{len(rounds)} rounds")
    t_check = time.perf_counter()
    if int(table.overflow.sum()):
        raise AssertionError(f"config5: {int(table.overflow.sum())} "
                             "documents overflowed")
    _check_tiles(table, base)
    head = fetch(type(table)(*(x[:base] for x in table)))
    for d in range(CONFIG5_ORACLE_DOCS):
        obs = MergeTreeClient("obs")
        obs.start_collaboration("obs")
        for msg in raw[d]:
            if msg.type == MessageType.OPERATION:
                obs.apply_msg(msg)
        if extract_text(head, encoded[d], d) != obs.get_text():
            raise AssertionError(f"config5: document {d} differs from "
                                 "the MergeTreeClient oracle")
    session = MergeHostSession(docs)
    host_ops, host_s = run_config5_host(
        config5_sequencer(MultiDocSequencer, docs, clients), session, rounds)
    for d in range(base):
        want, live = session.stats(d)
        if table_checksum(head, d) != want:
            raise AssertionError(f"config5: document {d}'s checksum "
                                 "differs from the C++ host tier's")
    session.close()
    cpp_rate = _cpp_replay_rate(encoded)
    check_s = time.perf_counter() - t_check
    lat_ms = sorted(x * 1e3 for x in lat)
    ops_s = total / min(runs)
    host = " / ".join(f"{k} {1e3 * parts[k] / len(rounds):.3f}"
                      for k in ("ticket", "scatter", "upload", "dispatch"))
    log(f"config5 ({card}): {docs} docs x {clients} clients ({docs * clients} "
        f"sessions), bench's corpus _build_streams({base}, {steps}, "
        f"{clients}, seed0={CONFIG5_SEED0}) tiled, {len(rounds)} rounds of "
        f"{every} messages per document, one window width W = {win}, "
        f"capacity {cap}; native MultiDocSequencer.ticket_boxcar -> "
        f"np.repeat + 2 scatters -> upload -> B1 (scan) on cuda; "
        f"{total} real ops per pass; pipeline {ops_s:.1f} ops/s (best of "
        f"{CONFIG5_TIMED_RUNS} passes after a warm-up: "
        f"{[round(s, 4) for s in runs]} s); synced pass {synced_s:.3f} s, "
        f"round p50 {_pct(lat_ms, 0.5):.3f} / p99 {_pct(lat_ms, 0.99):.3f} "
        f"ms, host ms per round: {host}; B1 at {docs} x {cap} x {win}: "
        f"{[round(m, 4) for m in b1_ms]} ms per round (CUDA events, "
        f"medians of 5 x 3), live bound "
        f"{[round(b, 4) for b, _ in bounds]} ms by "
        f"{sorted({by for _, by in bounds})}, B1 at "
        f"{sum(b for b, _ in bounds) / sum(b1_ms):.4f} of the bound over "
        f"the rounds; B1 launches {launches}; "
        + _busy_line(busy, synced_s)
        + f"; CUDA events from each upload's start to its dispatch's end: "
        f"{marked_ms:.3f} ms of the {synced_s * 1e3:.3f} ms pass, idle "
        f"share {1 - marked_ms / (synced_s * 1e3):.6f}"
        + f"; the chip machine's CPU: C++ host tier (MergeHostSession) "
        f"{host_ops / host_s:.1f} ops/s ({host_ops} ops in "
        f"{host_s:.3f} s, one pass with its tickets), C++ scalar "
        f"replayer {cpp_rate:.1f} ops/s over the {base} distinct streams; "
        f"checks: no overflow, every document's live slots == its "
        f"tile's first document's (every field, on the device), the "
        f"{base} distinct documents' checksums == the host tier's, "
        f"documents 0-{CONFIG5_ORACLE_DOCS - 1} == the MergeTreeClient "
        f"oracle, B1 == plain on the first round's {docs} x {cap} x "
        f"{win} window (prep {prep_s:.3f} s, kernel checks and times "
        f"{kernel_check_s:.3f} s, checks {check_s:.3f} s, phase "
        f"{time.perf_counter() - t0:.3f} s)")
    return {"launches": launches, "max_abs_err": err}


# ----------------------------------------------------------------------
# chaos: bench config11-13's storms and the chaos sweeps, GPU sidecar

CHAOS_STEPS, CHAOS_STORM = 240, (80, 160)  # bench config11-13 at full
CHAOS_SEEDS = 20  # the reference's sweeps (tests/test_chaos.py:47)
CHAOS_CRASH_SEEDS = (0, 3)  # config11's convergence leg (bench.py:2115)
CHAOS_KILL_SEEDS = (1, 2, 6)  # config12's, one per kill mode (:2220)
CHAOS_SPLIT_SEEDS = (0, 1, 2, 3, 7)  # config13's, one per split mode (:2368)
CHAOS_ACCOUNTED = ("config11", "config13")  # failsan rides these storms


class _FileSyncTimes:
    """Wall seconds and calls of ``os.fsync`` and ``os.replace`` (the
    durable store's write-temp + fsync + rename) while installed."""

    def __init__(self):
        self.s = collections.Counter()
        self.n = collections.Counter()
        self._saved = {}

    def __enter__(self):
        import os

        for name in ("fsync", "replace"):
            inner = self._saved[name] = getattr(os, name)

            def timed(*a, _inner=inner, _name=name, **k):
                t = time.perf_counter()
                try:
                    return _inner(*a, **k)
                finally:
                    self.s[_name] += time.perf_counter() - t
                    self.n[_name] += 1

            setattr(os, name, timed)
        return self

    def __exit__(self, *exc):
        import os

        for name, inner in self._saved.items():
            setattr(os, name, inner)


def _sites(fired) -> dict:
    """Faults fired per site: from a storm's ``chaos_counts`` (metric
    keys) or a sweep's ``fired`` list of (site, event, kind)."""
    out = collections.Counter()
    if isinstance(fired, dict):
        for key, n in fired.items():
            out[key.split('site="', 1)[1].split('"', 1)[0]] += n
    else:
        for site, _, _ in fired:
            out[site] += 1
    return dict(sorted(out.items()))


def _chaos_leg(run, files) -> tuple:
    """``run()`` with B1's launches counted and its wall and file-sync
    seconds taken: (result, launches, wall s, fsync s, rename s)."""
    from fluidframework_tpu_torch.ops import cuda_merge

    s0, r0 = files.s["fsync"], files.s["replace"]
    cuda_merge.LAUNCHES = 0
    t = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return (out, cuda_merge.LAUNCHES, time.perf_counter() - t,
            files.s["fsync"] - s0, files.s["replace"] - r0)


def _storm_line(name: str, rep, launches: int, wall: float, fsync: float,
                rename: float, cpu_s: float) -> str:
    extra = ""
    if rep.failover_time_s is not None:
        extra += (f", failover_time_s {rep.failover_time_s} "
                  f"{rep.failover_phases}, repl_lag_max "
                  f"{rep.repl_lag_max}")
    if rep.netsplit_window is not None:
        extra += (f", netsplit {list(rep.netsplit_window)}: "
                  f"unavailability_s {rep.unavailability_s}, "
                  f"degraded_read_s {rep.degraded_read_s}, unavailable "
                  f"nacks {rep.unavailable_nacks}")
    return (f"{name} seed {rep.seed}: {rep.offered_ops} offered / "
            f"{rep.acked_ops} acked ops (the alpha document; no sidecar "
            f"tracks it), goodput_steady "
            f"{rep.goodput_steady:.4f}, goodput_dip {rep.goodput_dip:.4f}, "
            f"recovery_steps {rep.recovery_steps}{extra}; {rep.fired} "
            f"faults, per site {_sites(rep.chaos_counts)}; B1 launches "
            f"{launches}; wall {wall:.3f} s (x2 runs equal, and equal to "
            f"the CPU sidecar's run, {cpu_s:.3f} s), fsync {fsync:.3f} s "
            f"({fsync / wall:.4f} of the wall), rename {rename:.3f} s")


@contextlib.contextmanager
def _held_scan_dispatches():
    """While open, ``GpuMergeSidecar._apply_program`` keeps, per slab
    capacity, the first scan dispatch with real ops: its table, batch
    and a copy of its output (the dict yielded)."""
    from fluidframework_tpu_torch.ops.window_cost import real_ops
    from fluidframework_tpu_torch.service.gpu_sidecar import GpuMergeSidecar

    held = {}
    inner = GpuMergeSidecar._apply_program

    def holding(self, table, program, *dead):
        out = inner(self, table, program, *dead)
        if "scan" in program and table.capacity not in held and bool(
                real_ops(program["scan"].kind).any()):
            held[table.capacity] = (table, program["scan"], type(out)(
                *(t.clone() for t in out)))
        return out

    GpuMergeSidecar._apply_program = holding
    try:
        yield held
    finally:
        GpuMergeSidecar._apply_program = inner


def _check_held(held: dict, what: str) -> int:
    """Each held dispatch's output == the kernel's and the plain
    version's on its inputs; returns the max abs error."""
    err = 0
    for cap, (table, batch, out) in sorted(held.items()):
        want, e = _check_window(table, batch, f"{what}'s {table.docs} x "
                                f"{cap} dispatch")
        err = max(err, e)
        if not all(torch.equal(x, y) for x, y in zip(out, want)):
            raise AssertionError(f"{what}: the sidecar's {cap}-slot "
                                 "dispatch differs from plain")
    return err


def _under_failsan(run, name: str, accounted: dict):
    """``run()`` under failsan (install, reset, run, flush, trips,
    coverage, uninstall, as bench's config11 and config13 legs do);
    raises on a trip or a coverage below 1.0, and puts the fired sites
    and the coverage in ``accounted[name]``."""
    from fluidframework_tpu_torch.testing import failsan

    failsan.install()
    try:
        failsan.reset()
        out = run()
        failsan.flush()
        trips = failsan.trips()
        coverage = failsan.signal_coverage()
        events = failsan._STATE.total_events
    finally:
        failsan.reset()
        failsan.uninstall()
    if trips or coverage != 1.0 or events <= 0:
        raise AssertionError(
            f"chaos: {name}'s fault-to-signal accounting: coverage "
            f"{coverage} over {events} events, trips:\n"
            + "\n".join(t.describe() for t in trips))
    sites = sorted(_sites(out.chaos_counts))
    accounted[name] = (f"{events} fired events at {len(sites)} sites "
                       f"{sites}, signal coverage {coverage}, no trips")
    return out


def phase_chaos(card: str) -> dict:
    """bench config11-13 at ``full`` (bench.py:2058-2420) through the
    port's chaos harness with ``GpuMergeSidecar`` on the card: each
    storm twice (equal ``deterministic_fields()``) and once with the
    sidecar on the CPU (equal again), the fault-free oracles, and the
    reference's three 20-seed convergence sweeps (crash-restart with
    torn states, leader kills, netsplits), each seed equal to its
    oracle; the configs' convergence legs are seeds of the sweeps."""
    from fluidframework_tpu_torch.testing import chaos

    t0 = time.perf_counter()
    total = 0
    lines = []
    with _FileSyncTimes() as files:
        # the fault-free oracles (plain and replicated plane); their
        # first scan dispatch at each slab capacity (16, then 32 after
        # the grow) is held against plain
        with _held_scan_dispatches() as held:
            (oracle, fo), n, wall, fs, rn = _chaos_leg(lambda: (
                chaos.run_chaos(0, faults=False),
                chaos.run_chaos_failover(0, faults=False)), files)
        total += n
        err = _check_held(held, "chaos")
        if sorted(held) != [chaos.ChaosHarness.SIDECAR_CAPACITY,
                            chaos.ChaosHarness.SIDECAR_MAX_CAPACITY]:
            raise AssertionError(f"chaos: held dispatches at {sorted(held)}")
        if not (oracle.converged and fo.converged) or \
                oracle.sidecar_tier != "pool":
            raise AssertionError(f"chaos: the oracles failed "
                                 f"({oracle.failures} {fo.failures}, tier "
                                 f"{oracle.sidecar_tier})")
        want = (oracle.alpha_text, oracle.alpha_kv, oracle.beta_text)
        if (fo.alpha_text, fo.alpha_kv, fo.beta_text) != want:
            raise AssertionError("chaos: the replicated oracle differs "
                                 "from the plain one")
        lines.append(f"oracles: run_chaos(0, faults=False) and "
                     f"run_chaos_failover(0, faults=False) equal, beta "
                     f"document in the {oracle.sidecar_tier} tier; B1 "
                     f"launches {n}; one B1 dispatch at each slab "
                     f"({[(t.docs, t.capacity, b.kind.shape[-1]) for t, b, _ in held.values()]} "
                     f"docs x slots x W) == plain; wall {wall:.3f} s, "
                     f"fsync {fs:.3f} s")
        mid = sum(CHAOS_STORM) // 2
        quarter = (CHAOS_STORM[1] - CHAOS_STORM[0]) // 4
        storms = (("config11", 11, {}),
                  ("config12", 12, {"kill_leader_step": mid}),
                  ("config13", 13, {"netsplit": (CHAOS_STORM[0] + quarter,
                                                 CHAOS_STORM[1] - quarter)}))
        accounted = {}
        for name, seed, kw in storms:
            def storm(device="cuda", seed=seed, kw=kw):
                return chaos.run_chaos_storm(
                    seed=seed, steps=CHAOS_STEPS, storm=CHAOS_STORM,
                    device=device, **kw)

            if name in CHAOS_ACCOUNTED:
                # bench.py:2085-2104 (config11) and :2318-2335 (config13):
                # every fault the storm injects maps to a signal
                rep, n, wall, fs, rn = _chaos_leg(
                    lambda storm=storm, name=name: _under_failsan(
                        storm, name, accounted), files)
            else:
                rep, n, wall, fs, rn = _chaos_leg(storm, files)
            again = storm()
            t_cpu = time.perf_counter()
            cpu = storm("cpu")
            cpu_s = time.perf_counter() - t_cpu
            total += n
            if not rep.converged or rep.fired <= 0:
                raise AssertionError(f"chaos: {name} storm: converged "
                                     f"{rep.converged} {rep.failures}, "
                                     f"faults {rep.fired}")
            for what, other in (("a second run", again),
                                ("the CPU sidecar's run", cpu)):
                if (other.deterministic_fields() != rep.deterministic_fields()
                        or other.chaos_counts != rep.chaos_counts):
                    raise AssertionError(
                        f"chaos: {name}'s storm differs from {what}: "
                        f"{rep.deterministic_fields()} != "
                        f"{other.deterministic_fields()}")
            if "kill_leader_step" in kw:
                phases = rep.failover_phases or {}
                if rep.failovers < 1 or rep.failover_time_s is None or abs(
                        sum(v for k, v in phases.items() if k != "total_s")
                        - rep.failover_time_s) > 0.05 + 1e-9 \
                        or not rep.fleet_metrics:
                    raise AssertionError(f"chaos: config12's failover: "
                                         f"{rep.failover_time_s} {phases}")
            if "netsplit" in kw and not (
                    rep.unavailability_s and rep.degraded_read_s is not None
                    and rep.degraded_read_s >= rep.unavailability_s - 1e-9
                    and rep.unavailable_nacks > 0 and rep.failovers == 0):
                raise AssertionError(f"chaos: config13's netsplit: "
                                     f"{rep.deterministic_fields()}")
            lines.append(_storm_line(name, rep, n, wall, fs, rn, cpu_s))
        # the reference's three sweeps, each seed against the oracle
        sweeps = (("crash", chaos.run_chaos),
                  ("kill", chaos.run_chaos_failover),
                  ("netsplit", chaos.run_chaos_netsplit))
        by_seed = {}
        for kind, run in sweeps:
            reps, n, wall, fs, rn = _chaos_leg(lambda run=run: [
                run(seed) for seed in range(CHAOS_SEEDS)], files)
            total += n
            if n < CHAOS_SEEDS:
                raise AssertionError(f"chaos: {kind} sweep: B1 launches {n}")
            for rep in reps:
                detail = f"{kind} seed {rep.seed}: {rep.failures}"
                if not rep.converged or not rep.fired or (
                        rep.alpha_text, rep.alpha_kv, rep.beta_text) != want:
                    raise AssertionError(f"chaos: {detail} (converged "
                                         f"{rep.converged}, oracle equal "
                                         "False or no faults)")
                if rep.tear is not None and not rep.tear_applied:
                    raise AssertionError(f"chaos: {detail}: the planned "
                                         f"tear {rep.tear} never applied")
                plan = chaos.failover_plan(rep.seed, 40)
                if kind == "kill" and plan[0] is not None and (
                        rep.failovers < 1 or rep.kill_mode != plan[1]):
                    raise AssertionError(f"chaos: {detail}: no failover")
                if kind == "netsplit" and (
                        rep.scrub_repairs < 1 or rep.netsplit_mode
                        != chaos.netsplit_plan(rep.seed, 40)["mode"]):
                    raise AssertionError(f"chaos: {detail}: scrub "
                                         f"{rep.scrub_repairs}")
                by_seed[kind, rep.seed] = rep
            tiers = collections.Counter(r.sidecar_tier for r in reps)
            fired = _sites([f for r in reps for f in r.fired])
            lines.append(
                f"{kind} sweep, seeds 0-{CHAOS_SEEDS - 1}: every seed == "
                f"the oracle; sidecar tiers {dict(tiers)} ({tiers['pool']} "
                f"seeds drove the beta document into the pool tier); "
                f"crashes {sum(r.crashes for r in reps)}, torn states "
                f"applied {sum(bool(r.tear_applied) for r in reps)}, "
                f"failovers {sum(r.failovers for r in reps)}, fenced "
                f"writes {sum(r.fenced_writes for r in reps)}, scrub "
                f"repairs {sum(r.scrub_repairs for r in reps)}; faults "
                f"{sum(fired.values())}, per site {fired}; B1 launches "
                f"{n}; wall {wall:.3f} s, fsync {fs:.3f} s "
                f"({fs / wall:.4f} of the wall), rename {rn:.3f} s")
        # the configs' convergence legs, from the sweeps
        crash = [by_seed["crash", s] for s in CHAOS_CRASH_SEEDS]
        kill = {by_seed["kill", s].kill_mode: by_seed["kill", s]
                for s in CHAOS_KILL_SEEDS}
        split = {by_seed["netsplit", s].netsplit_mode:
                 by_seed["netsplit", s] for s in CHAOS_SPLIT_SEEDS}
        if not (any(r.crashes for r in crash)
                and any(r.tear_applied for r in crash)):
            raise AssertionError("chaos: config11's seeds 0 / 3 applied no "
                                 "crash with a torn state")
        if set(kill) != {"mid_batch", "under_lag", "deposed_race"} or \
                kill["deposed_race"].fenced_writes <= 0:
            raise AssertionError(f"chaos: config12's kill modes {set(kill)}")
        minority = split.get("minority_leader")
        if set(split) != set(chaos.SPLIT_MODES) or minority is None or \
                minority.fenced_writes <= 0 or minority.rejoins < 1:
            raise AssertionError(f"chaos: config13's split modes "
                                 f"{set(split)}")
    wall = time.perf_counter() - t0
    harness = chaos.ChaosHarness
    log(f"chaos ({card}): the port's chaos harness (testing/chaos.py) with "
        f"GpuMergeSidecar on cuda (capacity {harness.SIDECAR_CAPACITY} -> "
        f"{harness.SIDECAR_MAX_CAPACITY}, seq pool "
        f"{harness.SIDECAR_POOL_CAPACITY} on "
        f"make_seq_mesh([cuda])), durable dirs in the temp directory; "
        f"storms at bench's full: {CHAOS_STEPS} steps, storm "
        f"{CHAOS_STORM}; " + "; ".join(lines)
        + f"; config11's convergence leg: seeds {CHAOS_CRASH_SEEDS} "
        f"(crash with tear {[r.tear for r in crash]}, applied); "
        f"config12's: seeds {CHAOS_KILL_SEEDS} = kill modes "
        f"{sorted(kill)}; config13's: seeds {CHAOS_SPLIT_SEEDS} = split "
        f"modes {sorted(split)}; failsan's fault-to-signal accounting "
        f"(testing/failsan.py) on the first card run of "
        + "; ".join(f"{k}'s storm: {v}" for k, v in accounted.items())
        + f"; the file syncs: fsync {files.s['fsync']:.3f} s over "
        f"{files.n['fsync']} calls, rename {files.s['replace']:.3f} s over "
        f"{files.n['replace']}; B1 launches {total}; phase wall "
        f"{wall:.3f} s ({files.s['fsync'] / wall:.4f} of it in fsync)")
    return {"launches": total, "max_abs_err": err}


# ----------------------------------------------------------------------
# the runtime sanitizers beside the static families, on the card

SANITIZER_SEEDS = (0, 1, 2, 3, 4)  # seed 3: crash + torn-state restart
SANITIZER_STEPS = 12  # tests/test_detsan.py's chaos run
SANITIZER_SERVE = dict(n_docs=8, readers_per_doc=2, duration_s=1.0,
                       tick_s=0.05, capacity_ops_per_s=100.0,
                       offered_multiple=0.8, seed=7, sidecar_docs=8)


def _static_side() -> dict:
    """One combined run of the port's families over its default roots
    (every family clean, the allowlist empty), then the surfaces the
    sanitizers are held to: concheck's lock graph by creation site,
    detcheck's findings, wirecheck's extracted emits, and shapecheck's
    device roots reachable from the dispatch loops and from the
    prewarms; with shapecheck's share of the run timed on its own over
    one built call graph."""
    from fluidframework_tpu_torch.analysis import (
        concurrency, core, shapecheck, wirecheck,
    )
    from fluidframework_tpu_torch.analysis.callgraph import build_callgraph

    t = time.perf_counter()
    findings = core.run_analysis()
    run_s = time.perf_counter() - t
    allowlist = core.load_allowlist()
    kept, stale = core.apply_allowlist(findings, allowlist)
    if kept or stale or allowlist:
        raise AssertionError("sanitizers: the port's fluidlint gate is not "
                             "clean: " + "; ".join(f.format() for f in kept)
                             + f" stale {stale}")
    t = time.perf_counter()
    files = core.walk_python_files(core.DEFAULT_ROOTS)
    lock_edges = concurrency.build_analysis(files).lock_edges_by_site()
    ext, _facts = wirecheck.extract(files)
    surfaces_s = time.perf_counter() - t
    graph = build_callgraph(files)
    t = time.perf_counter()
    by_path = {f.relpath: f for f in files}
    shape_findings = [f for f in shapecheck.check(files, graph)
                      if not by_path[f.path].suppressed(f.rule, f.line)]
    shape_s = time.perf_counter() - t
    if shape_findings:
        raise AssertionError("sanitizers: shapecheck is not clean: " + "; "
                             .join(f.format() for f in shape_findings))
    dispatched, warmed = shapecheck.prewarm_reach(files, graph)
    if not dispatched <= warmed:
        raise AssertionError(f"sanitizers: shapecheck finds the roots "
                             f"{sorted(dispatched - warmed)} unwarmed")
    return {"run_s": run_s, "families": len(core.FAMILIES),
            "files": len(files), "surfaces_s": surfaces_s,
            "shape_s": shape_s, "warmed": warmed,
            "lock_edges": lock_edges, "emits": ext.emitted_fields(),
            "det_sites": {(f.path, f.line) for f in findings
                          if f.rule in core.FAMILY_RULES["detcheck"]}}


SANITIZER_PREWARM = dict(docs=1024, capacity=64, max_capacity=512)
SANITIZER_PREWARM_STREAMS = (32, 120, 3, 5600)  # bench_streams' arguments
SANITIZER_PREWARM_ROUND = 16  # messages per document per round


def _walk_then_serve(sidecar, serve, warmed: set, bounds: dict,
                     what: str) -> tuple:
    """``sidecar.prewarm()`` under jitsan, then ``serve()`` (the rounds);
    raises unless every signature either reached is within ``bounds``,
    the rounds reach no signature the walk did not, and every root they
    launch is one shapecheck finds a prewarm walking. Returns the walk's
    seconds, its signatures per root and what ``serve`` returned."""
    from fluidframework_tpu_torch.testing import jitsan

    live = sidecar._table
    jitsan.reset()
    seconds = sidecar.prewarm()
    walked = jitsan.launch_signatures()
    if sidecar._table is not live:
        raise AssertionError(f"sanitizers: {what} prewarm replaced the "
                             "live table")
    jitsan.reset()
    out = serve()
    seen = jitsan.launch_signatures()
    over = {root: (len(walked[root] | seen[root]), bound)
            for root, bound in bounds.items()
            if len(walked[root] | seen[root]) > bound}
    missed = {root: sorted(sigs - walked[root])
              for root, sigs in seen.items() if sigs - walked[root]}
    cold = sorted(root for root, sigs in seen.items()
                  if sigs and root not in warmed)
    if over or missed or cold or not any(seen.values()):
        raise AssertionError(
            f"sanitizers: {what}: signatures over the ladder bounds {over}, "
            f"reached after prewarm but not walked {missed}, roots "
            f"shapecheck finds no prewarm walking {cold}")
    return seconds, {r: len(v) for r, v in walked.items() if v}, out


def _prewarm_merge(warmed: set) -> dict:
    """A GpuMergeSidecar on the card walked by ``prewarm`` (the window
    kernel's build, then every rung x bucket), then bench's corpus in
    rounds that grow the slab; the first dispatch at each slab ==
    plain, the streams == the oracle."""
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.ops.bucket_ladder import ladder_bounds
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    cfg = SANITIZER_PREWARM
    raw = bench_streams(*SANITIZER_PREWARM_STREAMS)
    wrapped = [_wrap(st) for st in raw]
    sidecar = GpuMergeSidecar(max_docs=cfg["docs"],
                              capacity=cfg["capacity"],
                              max_capacity=cfg["max_capacity"],
                              executor="scan", device="cuda")
    doc_ids = [f"san-doc-{d}" for d in range(cfg["docs"])]
    for doc in doc_ids:
        sidecar.track(doc, "d", "s")
    step = SANITIZER_PREWARM_ROUND
    longest = max(len(w) for w in wrapped)

    def serve():
        walls = []
        cuda_merge.LAUNCHES = 0
        with _held_scan_dispatches() as held:
            for lo in range(0, longest, step):
                for d, doc in enumerate(doc_ids):
                    for msg in wrapped[d % len(raw)][lo:lo + step]:
                        sidecar.ingest(doc, msg)
                t = time.perf_counter()
                sidecar.apply()
                sidecar.sync()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
        return walls, cuda_merge.LAUNCHES, held

    bounds = ladder_bounds(16, sidecar.ladder.max_bucket, cfg["capacity"],
                           cfg["max_capacity"])
    seconds, walked, (walls, launches, held) = _walk_then_serve(
        sidecar, serve, warmed, bounds, "merge sidecar")
    if sidecar.grow_count < 1 or launches < 1 or not held:
        raise AssertionError(f"sanitizers: the prewarmed merge sidecar grew "
                             f"{sidecar.grow_count} times, launched B1 "
                             f"{launches} times")
    err = _check_held(held, "sanitizers' prewarmed merge sidecar")
    _check_docs(sidecar, list(zip(doc_ids, raw)))
    return {"seconds": seconds, "walked": walked, "walls": walls,
            "launches": launches, "max_abs_err": err,
            "grows": sidecar.grow_count, "capacity": sidecar.capacity,
            "slabs": sorted(held)}


def _prewarm_tree(warmed: set, recorded: list, route: str) -> dict:
    """A TreeSidecar at the tree phase's shape (1024 documents, capacity
    128 -> 256, ring 16) walked by ``prewarm``, then the recorded corpus
    in the tree phase's rounds; every document == its oracle
    (``_check_tree_run``)."""
    from fluidframework_tpu_torch import convert
    from fluidframework_tpu_torch.ops.bucket_ladder import tree_ladder_bounds
    from fluidframework_tpu_torch.service import TreeSidecar

    sidecar = TreeSidecar(max_docs=TREE_DOCS, capacity=TREE_CAPACITY,
                          max_capacity=2 * TREE_CAPACITY, executor=route,
                          device="cuda")
    doc_ids = [f"tree-{d}" for d in range(TREE_DOCS)]
    for doc in doc_ids:
        sidecar.track(doc, "d", "t")
    longest = max(len(st) for _, st in recorded)
    bounds = [0] + list(range(TREE_PREFIX, longest, TREE_ROUND)) + [longest]

    def serve():
        walls = []
        for start, stop in zip(bounds, bounds[1:]):
            for d, doc in enumerate(doc_ids):
                for msg in recorded[d % len(recorded)][1][start:stop]:
                    sidecar.ingest(doc, msg)
            t = time.perf_counter()
            sidecar.apply()
            sidecar.sync()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        return walls

    # the walk covers both routes: a route-flipped sidecar is warm too
    limits = tree_ladder_bounds(TREE_CAPACITY, 2 * TREE_CAPACITY)
    limits["tree_window"] *= len(TREE_ROUTES)
    seconds, walked, walls = _walk_then_serve(
        sidecar, serve, warmed, limits, f"tree sidecar ({route})")
    rec = {"doc_ids": doc_ids,
           "table": convert.tree_table_to_numpy(sidecar._table)}
    _check_tree_run(sidecar, rec, recorded, route)
    return {"seconds": seconds, "walked": walked, "walls": walls}


def _socket_reentry() -> None:
    """tests/test_sanitizer.py's lock-nesting scenario: a socket
    driver's delivery callback (its dispatch thread holds ``svc.lock``)
    issues a blocking ``read_ops``, which takes ``_pending_lock`` and
    ``_send_lock`` under it."""
    from fluidframework_tpu_torch.drivers.socket_driver import (
        SocketDocumentService,
    )
    from fluidframework_tpu_torch.service.ingress import AlfredServer

    loop = _Loop()
    server = AlfredServer()
    try:
        loop.run(server.start())
        svc = SocketDocumentService("127.0.0.1", server.port, "san-doc")
        refetched = []

        def on_message(msg):
            if not refetched:
                refetched.append(svc.read_ops(0))

        svc.connect_to_delta_stream("sanity", on_message=on_message)
        _until(lambda: refetched, "the delivery callback's read_ops", 30)
        svc.close()
    finally:
        loop.run(server.stop())
        loop.close()


def phase_sanitizers(card: str, recorded: list) -> dict:
    """fluidsan, detsan, wiresan and jitsan installed together (the
    reference conftest's ``FFTPU_SANITIZE=1`` set, failsan riding the
    chaos phase's storms) over the chaos sweep with faults and
    crash-restart and a serve_bench slice, both with ``GpuMergeSidecar``
    on the card; then no trip, and what they observed held to the
    port's static families: runtime lock-order edges within concheck's
    graph, un-routed clock sites within detcheck's findings and
    ``WALL_CLOCK_SINKS``, frame fields within ``WIRE_SCHEMA`` and
    wirecheck's emits. The socket driver's lock-nesting scenario runs
    under them too, so the lock-edge check has edges to hold. The
    first sidecar dispatch at each slab is held against plain. Then,
    under jitsan alone, each sidecar's ``prewarm`` on the card and its
    own traffic after it (``_prewarm_merge``, ``_prewarm_tree``): no
    signature beyond the ladder bounds, none the walk missed, and no
    root shapecheck finds unwarmed."""
    from fluidframework_tpu_torch.analysis import determinism
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.protocol.constants import (
        wire_schema_fields,
    )
    from fluidframework_tpu_torch.testing import (
        detsan, jitsan, sanitizer, wiresan,
    )
    from fluidframework_tpu_torch.testing.chaos import run_chaos
    from fluidframework_tpu_torch.tools.serve_bench import (
        ServeBenchConfig, run_serve_bench,
    )

    t0 = time.perf_counter()
    static = _static_side()
    sans = (("fluidsan", sanitizer), ("detsan", detsan),
            ("wiresan", wiresan), ("jitsan", jitsan))
    for _name, mod in sans:
        mod.install()
        mod.reset()
    try:
        with _held_scan_dispatches() as held:
            t = time.perf_counter()
            cuda_merge.LAUNCHES = 0
            reports = [run_chaos(seed, faults=True,
                                 n_steps=SANITIZER_STEPS)
                       for seed in SANITIZER_SEEDS]
            bench = run_serve_bench(ServeBenchConfig(**SANITIZER_SERVE))
            _socket_reentry()
            torch.cuda.synchronize()
            launches = cuda_merge.LAUNCHES
            run_s = time.perf_counter() - t
        trips = {name: mod.trips() for name, mod in sans}
        edges = sanitizer.edges_by_site()
        unrouted = detsan.unrouted_wall_sites()
        rng_sites = detsan.scoped_rng_sites()
        observed_wall = detsan.observed_sites("wall")
        fields = wiresan.observed()
        seams = wiresan.observed_seams()
        frames = wiresan.observed_frames()
    finally:
        for _name, mod in reversed(sans):
            mod.reset()
            mod.uninstall()
    bad = [r.seed for r in reports if not r.converged]
    if bad or bench.acked_ops <= 0:
        raise AssertionError(f"sanitizers: chaos seeds {bad} diverged or "
                             f"serve_bench acked {bench.acked_ops}")
    tripped = {k: [t.describe() for t in v] for k, v in trips.items() if v}
    if tripped:
        raise AssertionError(f"sanitizers: trips {tripped}")
    if launches <= 0 or not held:
        raise AssertionError(f"sanitizers: B1 launched {launches} times "
                             "under the sanitizers")
    err = _check_held(held, "sanitizers")
    missing_edges = edges - static["lock_edges"]
    gaps = [r for r in unrouted
            if (r.relpath, r.line) not in static["det_sites"]
            and not determinism.sink_registered(r.relpath, r.func,
                                                by_code_name=True)]
    rng_gaps = [r for r in rng_sites
                if (r.relpath, r.line) not in static["det_sites"]]
    unschemed = sorted(k for k in fields
                       if k[1] not in (wire_schema_fields(k[0]) or {}))
    unextracted = sorted(
        (ftype, field) for (ftype, field), seam_set in seams.items()
        if any(x.startswith("pack:") for x in seam_set)
        and field not in static["emits"].get(ftype, set())
        and not (wire_schema_fields(ftype) or {}).get(
            field, (None, None, False))[2])
    if missing_edges or gaps or rng_gaps or unschemed or unextracted:
        raise AssertionError(
            f"sanitizers: runtime beyond the static families: lock edges "
            f"{sorted(missing_edges)}, clock sites "
            f"{[(r.relpath, r.line, r.func) for r in gaps]}, rng "
            f"{[(r.relpath, r.line) for r in rng_gaps]}, fields outside "
            f"WIRE_SCHEMA {unschemed}, pack fields wirecheck does not "
            f"extract {unextracted}")
    sidecar_wall = sorted({r.relpath for r in observed_wall
                           if r.relpath.endswith("service/gpu_sidecar.py")})
    if not sidecar_wall or not edges or not fields:
        raise AssertionError(f"sanitizers: vacuous run (sidecar clock "
                             f"reads {sidecar_wall}, edges {len(edges)}, "
                             f"fields {len(fields)})")
    fired = _sites([f for r in reports for f in r.fired])
    jitsan.install()
    try:
        t = time.perf_counter()
        merge = _prewarm_merge(static["warmed"])
        merge_s = time.perf_counter() - t
        t = time.perf_counter()
        tree = _prewarm_tree(static["warmed"], recorded, TREE_ROUTES[0])
        tree_s = time.perf_counter() - t
    finally:
        jitsan.reset()
        jitsan.uninstall()
    wall = time.perf_counter() - t0
    log(f"sanitizers ({card}): fluidsan, detsan, wiresan and jitsan "
        f"installed over run_chaos(seed, faults=True, n_steps="
        f"{SANITIZER_STEPS}) for seeds {list(SANITIZER_SEEDS)} (crash-"
        f"restart with torn states on the odd seeds) and serve_bench "
        f"{SANITIZER_SERVE}, GpuMergeSidecar on cuda, and the socket "
        f"driver's delivery-callback read_ops: every seed "
        f"converged ({sum(fired.values())} faults fired at {len(fired)} "
        f"sites {sorted(fired)}), serve_bench acked {bench.acked_ops} "
        f"ops; no trips; "
        f"runtime lock-order edges {len(edges)} within concheck's "
        f"{len(static['lock_edges'])} static edges; un-routed clock sites "
        f"{len(unrouted)} (of {len(observed_wall)} observed clock sites, "
        f"the sidecar's among them) within detcheck's "
        f"{len(static['det_sites'])} findings and WALL_CLOCK_SINKS, scoped "
        f"RNG sites {len(rng_sites)}; {len(fields)} (frame type, field) "
        f"pairs over {len(frames)} frame types within WIRE_SCHEMA and "
        f"wirecheck's emits; B1 launches {launches}, the first sidecar "
        f"dispatch at each slab "
        f"({[(t.docs, t.capacity, b.kind.shape[-1]) for t, b, _ in held.values()]}"
        f" docs x slots x W) == plain; static side: one run of the "
        f"port's {static['families']} families over "
        f"{static['files']} files {static['run_s']:.3f} s (clean, empty "
        f"allowlist) + the lock graph and wire extraction "
        f"{static['surfaces_s']:.3f} s, shapecheck's share (one built call "
        f"graph) {static['shape_s']:.3f} s; sanitized run {run_s:.3f} s; "
        f"phase wall {wall:.3f} s")
    cfg = SANITIZER_PREWARM
    log(f"sanitizers ({card}): prewarm on cuda under jitsan: merge sidecar "
        f"{cfg['docs']} docs, capacity {cfg['capacity']} -> max "
        f"{cfg['max_capacity']}: walk {merge['seconds']:.3f} s (the window "
        f"kernel's build included), signatures walked {merge['walked']}; "
        f"{len(merge['walls'])} rounds of bench's corpus "
        f"({SANITIZER_PREWARM_ROUND} messages per document per round, "
        f"{merge['grows']} grows to {merge['capacity']}): first round "
        f"{merge['walls'][0] * 1e3:.3f} ms, median steady round "
        f"{statistics.median(merge['walls'][1:]) * 1e3:.3f} ms, B1 "
        f"launches {merge['launches']}, the first dispatch at each slab "
        f"{merge['slabs']} == plain, no signature beyond ladder_bounds or "
        f"unwalked, every root launched among shapecheck's warmed "
        f"{sorted(static['warmed'])}; {merge_s:.3f} s with the checks")
    log(f"sanitizers ({card}): prewarm on cuda under jitsan: tree sidecar "
        f"({TREE_ROUTES[0]}) {TREE_DOCS} docs, capacity {TREE_CAPACITY} -> "
        f"{2 * TREE_CAPACITY}, ring 16: walk {tree['seconds']:.3f} s "
        f"(both routes), signatures walked {tree['walked']}; "
        f"{len(tree['walls'])} rounds of the recorded corpus: first round "
        f"after prewarm {tree['walls'][0] * 1e3:.3f} ms (apply + sync), "
        f"median steady round "
        f"{statistics.median(tree['walls'][1:]) * 1e3:.3f} ms (rounds "
        f"{[round(w * 1e3, 3) for w in tree['walls']]} ms); no signature "
        f"beyond tree_ladder_bounds or unwalked; every document == its "
        f"EditManager replay; {tree_s:.3f} s with the checks")
    return {"launches": launches, "prewarm_launches": merge["launches"],
            "max_abs_err": max(err, merge["max_abs_err"])}


# ----------------------------------------------------------------------
# tools: recorded and fetched documents replayed through the tools into B1

TOOLS_DOCS, TOOLS_CAPACITY = SERVICE_DOCS, SERVICE_CAPACITY
TOOLS_CHECKPOINT_EVERY = 8  # replay_file's checkpoint cadence, in ops
TOOLS_BENCH_ITERATIONS = 3  # the harness's timed sidecar rounds
FETCH_DOCS = 16  # documents written over TCP and fetched back
NET_STRESS_WORKERS, NET_STRESS_OPS = 3, 30  # run_net_stress's defaults
SIDECAR_EXAMPLES = ("heat_dump", "op_trace")


def _tools_session(api, docs: list, seed: int):
    """The service traffic, one round: two writer Containers per
    document on a ``LocalServer`` (manual clock), 8 edits per writer,
    a flush per writer. Returns the server and the writers."""
    server, factory = _timed_server(api, _SelfTimes(), seed)
    rng = random.Random(seed)
    writers = {}
    for doc in docs:
        pair = [api.Container.load(factory.create_document_service(doc),
                                   client_id=f"{doc}-{who}")
                for who in SERVICE_WRITERS]
        pair[0].runtime.create_datastore("d").create_channel(
            "sharedstring", "s")
        pair[0].flush()
        writers[doc] = pair
    for doc in docs:
        for c in writers[doc]:
            s = _string(c)
            for _ in range(SERVICE_EDITS):
                _service_edit(rng, s)
        for c in writers[doc]:
            c.flush()
    return server, writers


def _live(writers: list) -> tuple:
    """The writers' common (text, signature); raises if they differ."""
    views = {(_string(c).get_text(), tuple(_string(c).signature()))
             for c in writers}
    if len(views) != 1:
        raise AssertionError("tools: the live writers differ")
    return views.pop()


def _replay_checked(path, live: tuple, what: str) -> tuple:
    """``replay_file`` with checkpoints, again in validation mode against
    them, and ``export_file``: each equal to ``live``; returns the ops
    the first replay replayed and its seconds."""
    from fluidframework_tpu_torch.tools import export_file, replay_file

    t = time.perf_counter()
    container, report = replay_file(path,
                                    checkpoint_every=TOOLS_CHECKPOINT_EVERY)
    replay_s = time.perf_counter() - t
    _again, valid = replay_file(path, checkpoint_every=TOOLS_CHECKPOINT_EVERY,
                                expected_checkpoints=report.checkpoints)
    exported = export_file(path)
    s = _string(container)
    if not (report.ok and valid.ok and report.checkpoints
            and (s.get_text(), tuple(s.signature())) == live
            and exported["content"]["d"]["s"]["text"] == live[0]
            and exported["opsReplayed"] == report.ops_replayed):
        raise AssertionError(f"tools: {what}'s replay, validation "
                             f"{valid.mismatches} or export differs from "
                             "the live writers")
    return report.ops_replayed, replay_s


def _serve_logs(logs: dict, capacity: int):
    """A ``GpuMergeSidecar`` on the card with every saved log tracked and
    ingested (channel "d"/"s"), nothing applied yet."""
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    sidecar = GpuMergeSidecar(max_docs=len(logs), capacity=capacity,
                              device="cuda")
    for doc, msgs in logs.items():
        sidecar.track(doc, "d", "s")
        for msg in msgs:
            sidecar.ingest(doc, msg)
    return sidecar


def _check_served_logs(sidecar, logs: dict, live: dict, what: str) -> None:
    """Every served document's text == the live writers'; its signature
    == the scalar replay of its log's."""
    for doc, msgs in logs.items():
        text, sig = _oracle(_log_stream(msgs))
        if sidecar.text(doc, "d", "s") != live[doc][0] or text != live[doc][0]:
            raise AssertionError(f"tools: {what} {doc}: the served text "
                                 "differs from the live writers'")
        if sidecar.signature(doc, "d", "s") != sig:
            raise AssertionError(f"tools: {what} {doc}: the served signature "
                                 "differs from the log's replay")
    if sidecar.overflowed():
        raise AssertionError(f"tools: {what} left an overflowed document")


def _tools_recorded(seed: int, root: str) -> dict:
    """The service cell's documents recorded, saved with
    ``save_document``, replayed, validated and exported, then served from
    the saved logs by a 1024 x 512 sidecar, and that round timed by
    ``tools.benchmark``."""
    import fluidframework_tpu_torch
    from fluidframework_tpu_torch.drivers import save_document
    from fluidframework_tpu_torch.drivers.file_driver import load_document
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.tools import (
        BenchmarkReporter, BenchmarkType, benchmark,
    )

    t0 = time.perf_counter()
    api = session_api(fluidframework_tpu_torch)
    docs = [f"tools-{d}" for d in range(TOOLS_DOCS)]
    server, writers = _tools_session(api, docs, seed)
    live = {doc: _live(writers[doc]) for doc in docs}
    session_s = time.perf_counter() - t0
    t = time.perf_counter()
    paths = {}
    for doc in docs:
        paths[doc] = f"{root}/{doc}.json"
        save_document(paths[doc], doc, server.read_ops(doc, 0))
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    ops, replay_s = np.sum([_replay_checked(paths[doc], live[doc], doc)
                            for doc in docs], axis=0)
    passes_s = time.perf_counter() - t
    logs = {doc: load_document(paths[doc]).read_ops(0) for doc in docs}
    with _held_scan_dispatches() as held:
        cuda_merge.LAUNCHES = 0
        t = time.perf_counter()
        sidecar = _serve_logs(logs, TOOLS_CAPACITY)
        applied = sidecar.apply()
        sidecar.sync()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        served_launches = cuda_merge.LAUNCHES
        reporter = BenchmarkReporter()
        result = reporter.add(benchmark(
            f"sidecar round: {TOOLS_DOCS} replayed docs x {TOOLS_CAPACITY}, "
            "apply + sync", lambda sc: (sc.apply(), sc.sync()),
            setup=lambda: _serve_logs(logs, TOOLS_CAPACITY),
            benchmark_type=BenchmarkType.MEASUREMENT,
            min_iterations=TOOLS_BENCH_ITERATIONS, min_time_s=0.0, warmup=1))
        torch.cuda.synchronize()
        bench_launches = cuda_merge.LAUNCHES - served_launches
    _check_served_logs(sidecar, logs, live, "recorded")
    if served_launches <= 0 or bench_launches <= result.iterations \
            or not held:
        raise AssertionError(f"tools: B1 launched {served_launches} / "
                             f"{bench_launches} times serving / timing the "
                             "replayed documents")
    err = _check_held(held, "tools (recorded)")
    for line in reporter.render_table().splitlines():
        log(f"  tools harness: {line}")
    log(f"  tools harness json: {reporter.render_json()}")
    return {"docs": len(docs), "edits": len(docs) * len(SERVICE_WRITERS)
            * SERVICE_EDITS, "ops": ops, "applied": applied,
            "session_s": session_s, "save_s": save_s, "replay_s": replay_s,
            "passes_s": passes_s,
            "serve_s": serve_s, "result": result,
            "shape": [(tb.docs, tb.capacity, b.kind.shape[-1])
                      for tb, b, _ in held.values()],
            "launches": served_launches + bench_launches,
            "served_launches": served_launches,
            "bench_launches": bench_launches, "max_abs_err": err,
            "wall_s": time.perf_counter() - t0}


def _tools_fetched(seed: int, root: str) -> dict:
    """``FETCH_DOCS`` documents written by two socket writers each to an
    in-process ``AlfredServer`` (op_trace's ``start_server`` shape),
    plus one whose writer summarizes; each fetched with ``fetch_tool``
    (ops == the orderer's log, summary == the server's latest). The
    ``FETCH_DOCS`` are replayed and served by a ``FETCH_DOCS`` x 512
    sidecar on the card. The summarized one is not replayed: its file
    starts after the summarize op, which the summary does not cover, so
    a replay breaks in both packages (a fault of the reference,
    ROADMAP.md section C)."""
    from fluidframework_tpu_torch.drivers.file_driver import load_document
    from fluidframework_tpu_torch.drivers.socket_driver import (
        SocketDocumentService,
    )
    from fluidframework_tpu_torch.loader import Container
    from fluidframework_tpu_torch.ops import cuda_merge
    from fluidframework_tpu_torch.protocol.serialization import (
        encode_contents, message_to_json,
    )
    from fluidframework_tpu_torch.service import LocalServer
    from fluidframework_tpu_torch.service.ingress import AlfredServer
    from fluidframework_tpu_torch.tools.fetch_tool import fetch

    t0 = time.perf_counter()
    rng = random.Random(seed)
    tick = {"t": 2_000_000.0 + seed}

    def clock():
        tick["t"] += 0.001
        return tick["t"]

    loop = _Loop()
    alfred = AlfredServer(LocalServer(clock=clock))
    services = []
    try:
        loop.run(alfred.start())
        docs = [f"fetch-{d}" for d in range(FETCH_DOCS)]
        summarized = "fetch-summarized"
        writers = {}
        for doc in docs + [summarized]:
            pair = []
            for who in SERVICE_WRITERS:
                svc = SocketDocumentService("127.0.0.1", alfred.port, doc)
                services.append(svc)
                with svc.lock:
                    c = Container.load(svc, client_id=f"{doc}-{who}")
                    if not pair:
                        c.runtime.create_datastore("d").create_channel(
                            "sharedstring", "s")
                        c.flush()
                pair.append((svc, c))
                _until(lambda: "d" in c.runtime.datastores
                       and c.runtime.pending.count == 0, f"{doc} attach")
            writers[doc] = pair
        for doc, pair in writers.items():
            for svc, c in pair:
                with svc.lock:
                    for _ in range(SERVICE_EDITS):
                        _service_edit(rng, _string(c))
                    c.flush()

        def quiet(pair):
            with pair[0][0].lock, pair[1][0].lock:
                return all(c.runtime.pending.count == 0 for _s, c in pair) \
                    and len({_string(c).get_text() for _s, c in pair}) == 1

        for doc, pair in writers.items():
            _until(lambda: quiet(pair), f"{doc} converged")
        acks = []
        svc, c = writers[summarized][0]
        with svc.lock:
            c.on("summaryAck", acks.append)
            c.summarize()
        _until(lambda: acks and quiet(writers[summarized]),
               "the summary's ack")
        live = {}
        for doc, pair in writers.items():
            with pair[0][0].lock, pair[1][0].lock:
                live[doc] = _live([c for _s, c in pair])
        session_s = time.perf_counter() - t0
        t = time.perf_counter()
        paths, fetched_ops = {}, 0
        for doc in docs + [summarized]:
            paths[doc] = f"{root}/{doc}.json"
            report = fetch("127.0.0.1", alfred.port, doc, paths[doc])
            fetched_ops += report["ops"]
        fetch_s = time.perf_counter() - t
        for doc in docs + [summarized]:
            blob = json.load(open(paths[doc], encoding="utf-8"))
            summary = alfred.local.latest_summary(doc)
            from_seq = summary.sequence_number if summary else 0
            want = [message_to_json(m)
                    for m in alfred.local.read_ops(doc, from_seq)]
            want_summary = summary and {
                "sequenceNumber": summary.sequence_number,
                "tree": encode_contents(summary.summary)}
            if blob["messages"] != json.loads(json.dumps(want)) or \
                    blob["summary"] != json.loads(json.dumps(want_summary)):
                raise AssertionError(f"tools: fetched {doc} differs from "
                                     "the server's log or summary")
            if (summary is None) != (doc != summarized):
                raise AssertionError(f"tools: {doc}'s summary is "
                                     f"{summary}")
        ops, replay_s = np.sum([_replay_checked(paths[doc], live[doc], doc)
                                for doc in docs], axis=0)
    finally:
        for svc in services:
            svc.close()
        loop.run(alfred.stop())
        loop.close()
    logs = {doc: load_document(paths[doc]).read_ops(0) for doc in docs}
    with _held_scan_dispatches() as held:
        cuda_merge.LAUNCHES = 0
        sidecar = _serve_logs(logs, TOOLS_CAPACITY)
        sidecar.apply()
        sidecar.sync()
        torch.cuda.synchronize()
        launches = cuda_merge.LAUNCHES
    _check_served_logs(sidecar, logs, live, "fetched")
    if launches <= 0 or not held:
        raise AssertionError(f"tools: B1 launched {launches} times serving "
                             "the fetched documents")
    err = _check_held(held, "tools (fetched)")
    return {"docs": len(docs), "ops": ops, "fetched_ops": fetched_ops,
            "shape": [(tb.docs, tb.capacity, b.kind.shape[-1])
                      for tb, b, _ in held.values()],
            "summary_seq":
                alfred.local.latest_summary(summarized).sequence_number,
            "session_s": session_s, "fetch_s": fetch_s,
            "replay_s": replay_s, "launches": launches, "max_abs_err": err,
            "wall_s": time.perf_counter() - t0}


def _run_example(name: str) -> tuple:
    """``python -m fluidframework_tpu_torch.examples.<name> --device
    cuda`` in this process (``runpy``), its standard output captured;
    returns (output, B1 launches). Raises unless it exits 0 and prints
    ``OK``."""
    import io
    import runpy

    from fluidframework_tpu_torch.ops import cuda_merge

    module = f"fluidframework_tpu_torch.examples.{name}"
    out, argv = io.StringIO(), sys.argv
    cuda_merge.LAUNCHES = 0
    sys.argv = [module, "--device", "cuda"]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module(module, run_name="__main__")
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    text = out.getvalue()
    if code not in (0, None) or "OK" not in text:
        raise AssertionError(f"tools: example {name} exited {code}:\n"
                             f"{text[-2000:]}")
    return text, cuda_merge.LAUNCHES


def phase_tools(card: str, seed: int) -> dict:
    """The tools on the card's path: the service cell's documents
    recorded and replayed through ``replay_tool`` / ``fluid_runner`` into
    ``GpuMergeSidecar`` (the round timed by ``tools.benchmark``),
    documents fetched over TCP with ``fetch_tool`` and served the same
    way, one ``run_net_stress`` at its defaults, and the two examples
    that build a merge sidecar run on the card."""
    import tempfile

    from fluidframework_tpu_torch.tools.net_stress import run_net_stress

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tools-") as root:
        rec = _tools_recorded(seed, root)
        fet = _tools_fetched(seed, root)
    t = time.perf_counter()
    stress = run_net_stress(n_workers=NET_STRESS_WORKERS, n_ops=NET_STRESS_OPS,
                            seed=seed)
    stress_s = time.perf_counter() - t
    lengths = {w["length"] for w in stress["workers"]}
    if len({w["text_sha"] for w in stress["workers"]}) != 1 or \
            lengths != {stress["replay_length"]}:
        raise AssertionError(f"tools: net_stress did not converge: {stress}")
    examples = {}
    for name in SIDECAR_EXAMPLES:
        t = time.perf_counter()
        text, launches = _run_example(name)
        examples[name] = (launches, time.perf_counter() - t)
        if launches <= 0:
            raise AssertionError(f"tools: {name} launched B1 {launches} "
                                 "times")
        if name == "op_trace" and "merged with sidecar dispatch hops" \
                not in text:
            raise AssertionError("tools: op_trace found no sidecar hops")
    wall = time.perf_counter() - t0
    result = rec["result"]
    launches = rec["launches"] + fet["launches"] + sum(
        n for n, _s in examples.values())
    log(f"tools ({card}): recorded: {rec['docs']} docs x "
        f"{len(SERVICE_WRITERS)} writers x {SERVICE_EDITS} edits "
        f"({rec['edits']} edits) through the port's LocalServer, saved with "
        f"save_document, each replayed with replay_file(checkpoint_every="
        f"{TOOLS_CHECKPOINT_EVERY}), again in validation mode (no mismatch) "
        f"and exported with export_file: {int(rec['ops'])} ops replayed at "
        f"{rec['ops'] / rec['replay_s']:.1f} ops/s in the checkpointed "
        f"replays (session {rec['session_s']:.3f} s, save "
        f"{rec['save_s']:.3f} s, replay + validate + export "
        f"{rec['passes_s']:.3f} s); served from the saved logs by "
        f"GpuMergeSidecar {TOOLS_DOCS} x {TOOLS_CAPACITY} on cuda "
        f"({rec['applied']} ops applied in {rec['serve_s']:.3f} s, B1 "
        f"{rec['served_launches']}); tools.benchmark of that round "
        f"(setup: a fresh sidecar with the logs ingested; body: apply + "
        f"sync): {result.iterations} iterations, p50 "
        f"{result.p50_s * 1e3:.3f} ms, p95 {result.p95_s * 1e3:.3f} ms, "
        f"mean {result.mean_s * 1e3:.3f} ms, B1 {rec['bench_launches']} "
        f"(warmup included); leg wall {rec['wall_s']:.3f} s; fetched: "
        f"{fet['docs']} docs x {len(SERVICE_WRITERS)} socket writers x "
        f"{SERVICE_EDITS} edits to an in-process AlfredServer, plus one "
        f"summarized at seq {fet['summary_seq']}, each fetched with "
        f"fetch_tool.fetch ({fet['fetched_ops']} ops in "
        f"{fet['fetch_s']:.3f} s; ops == the server's log, summary == its "
        f"latest), the {fet['docs']} unsummarized replayed, validated and "
        f"exported ({int(fet['ops'])} ops at "
        f"{fet['ops'] / fet['replay_s']:.1f} ops/s in the checkpointed "
        f"replays), served by "
        f"GpuMergeSidecar {fet['docs']} x {TOOLS_CAPACITY} on cuda (B1 "
        f"{fet['launches']}); leg wall {fet['wall_s']:.3f} s; net_stress: "
        f"{NET_STRESS_WORKERS} worker processes x {NET_STRESS_OPS} ops "
        f"against python -m fluidframework_tpu_torch.service converged "
        f"at length {stress['replay_length']} == the op log's replay, "
        f"{stress_s:.3f} s; examples on cuda: "
        + ", ".join(f"{name} B1 {n}, {s:.3f} s"
                    for name, (n, s) in examples.items())
        + f" (OK each); every replay, export and served text == the live "
        f"writers', every served signature == its log's scalar replay; the "
        f"first dispatch of each leg ({rec['shape'] + fet['shape']} docs x "
        f"slots x W) == plain; "
        f"B1 launches {launches}; phase wall {wall:.3f} s")
    return {"launches": launches,
            "max_abs_err": max(rec["max_abs_err"], fet["max_abs_err"])}


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
    for docs, cap, window in TIME_WIDE:
        table = windows.random_table(rng, docs, cap, "cuda")
        batch = windows.random_batch(rng, table, window, "cuda")
        _, err = _check_window(table, batch,
                               f"D={docs} C={cap} W={window}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        apply_window(table, batch)
        kernel = _time_ms(lambda: apply_window(table, batch), 5, 10)
        ms = statistics.median(kernel)
        # a document's steps run one after another: the longest chain
        steps = int(_real(batch.kind).sum(dim=1).max())
        log(f"times at D={docs} C={cap} W={window}: kernel median "
            f"{ms:.4f} ms per launch (5 runs of 10 back-to-back launches: "
            f"{[round(t, 4) for t in kernel]}), NOOP share of the batch "
            f"{_noop_share(batch):.4f}, {1e3 * ms / max(1, steps):.3f} us "
            f"per real step of the document with the most ({steps}); "
            + _bound_line(compiled_window(table, batch)[2], ms))
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
            log(f"  ptxas: {cuda_merge.describe(k)}")
        for cap in (4097, 5001, 8192):
            shape = cuda_merge.cluster_shape(cap)
            log(f"  cluster form at C={cap}: {shape['cluster']} CTAs per "
                f"document of {shape['span']} slots and {shape['threads']} "
                f"threads; cudaOccupancyMaxActiveClusters "
                f"{shape['max_active_clusters']}")
        walls = [("start", time.perf_counter())]

        def mark(name):
            walls.append((name, time.perf_counter()))

        worst = phase_kernel(args.seed)
        mark("kernel")
        main_rec = phase_main(args.seed)
        mark("main")
        fuzz_rec = phase_fuzz()
        mark("fuzz")
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
        service_rec = phase_service(args.seed)
        mark("service")
        ingress_rec = phase_ingress(args.seed)
        mark("ingress")
        serve_rec = phase_serve()
        mark("serve")
        dds_rec = phase_dds()
        mark("dds")
        framework_rec = phase_framework()
        mark("framework")
        partitioned_rec = phase_partitioned(args.seed)
        mark("partitioned")
        replicated_rec = phase_replicated(args.seed)
        mark("replicated")
        config5_rec = phase_config5(smi)
        mark("config5")
        chaos_rec = phase_chaos(smi)
        mark("chaos")
        sanitizer_rec = phase_sanitizers(smi, recorded)
        mark("sanitizers")
        tools_rec = phase_tools(smi, args.seed)
        mark("tools")
        time_rec = phase_time(args.seed)
        mark("times")
        log("phase walls: " + ", ".join(
            f"{name} {t - walls[i][1]:.3f} s"
            for i, (name, t) in enumerate(walls[1:])))
        worst = max(worst, time_rec.pop("max_abs_err"),
                    pool_rec["max_abs_err"], matrix_rec["max_abs_err"],
                    service_rec["max_abs_err"], ingress_rec["max_abs_err"],
                    serve_rec["max_abs_err"], dds_rec["max_abs_err"],
                    fuzz_rec["max_abs_err"], framework_rec["max_abs_err"],
                    partitioned_rec["max_abs_err"],
                    replicated_rec["max_abs_err"],
                    config5_rec["max_abs_err"], chaos_rec["max_abs_err"],
                    sanitizer_rec["max_abs_err"], tools_rec["max_abs_err"])
        paths = {"main path": main_rec["launches"],
                 "fuzz": fuzz_rec["launches"],
                 "config10": pool_rec["config10_launches"],
                 "matrix": matrix_rec["launches"],
                 "donated runs": donation_rec["launches"],
                 "prewarmed rounds": prewarm_rec["launches"],
                 "obs runs": obs_rec["launches"],
                 "service": service_rec["launches"],
                 "ingress": ingress_rec["launches"],
                 "serve": serve_rec["launches"],
                 "dds": dds_rec["launches"],
                 "framework": framework_rec["launches"],
                 "partitioned": partitioned_rec["launches"],
                 "replicated": replicated_rec["launches"],
                 "config5": config5_rec["launches"],
                 "chaos": chaos_rec["launches"],
                 "sanitizers": sanitizer_rec["launches"],
                 "prewarmed sanitized rounds":
                     sanitizer_rec["prewarm_launches"],
                 "tools": tools_rec["launches"]}
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
