"""Multi-process network stress: OS-process clients against the
networked dev service over real sockets, asserting convergence.

Reference: packages/test/test-service-load/src/{runner.ts,
nodeStressTest.ts} — the multi-process load runner (SURVEY §4.6), here
pointed at the alfred-equivalent ingress (service/ingress.py) through
the socket driver.

Protocol: the parent starts `python -m fluidframework_tpu_torch.service`,
spawns N worker processes, each of which

  1. loads the Container over the socket driver,
  2. performs ``ops`` random SharedString edits (seeded),
  3. sets ``done/<client>`` in a shared map and waits until every
     worker's done-key is visible and its own ops are acked — at that
     point it has provably processed every edit (each worker's edits
     happen-before its done-key in the total order),
  4. prints a JSON line with its final text hash.

The parent asserts every worker saw the identical text, then loads a
fresh container itself (full op-log replay through storage) and checks
it reproduces the same text — sequencing, broadcast, catch-up reads
and replay all over real TCP.

Run directly:  python -m fluidframework_tpu_torch.tools.net_stress \
                  [--workers 3] [--ops 30]

A copy of the reference's ``tools/net_stress.py``. The server and the
workers it spawns run this package (``fluidframework_tpu_torch``), the
server with no sidecar, as in the reference.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import re
import subprocess
import sys
import time
from typing import Optional


def worker_main(host: str, port: int, document_id: str,
                client_id: str, n_ops: int, n_workers: int,
                seed: int) -> dict:
    """Body of one stress client (runs in its own OS process)."""
    from ..drivers.socket_driver import SocketDocumentService
    from ..loader import Container
    from ..obs import metrics as obs_metrics

    metrics_before = obs_metrics.REGISTRY.flat()
    svc = SocketDocumentService(host, port, document_id)
    # the dispatch thread mutates the container under svc.lock; load
    # (connect, channel collab renames) must hold it too
    with svc.lock:
        container = Container.load(svc, client_id=client_id)
    rng = random.Random(seed)
    alphabet = "abcdefghijklmnopqrstuvwxyz"

    # worker-0 creates the shared structure; everyone else waits for
    # the attach ops to arrive (concurrent creates of the same ids
    # would collide — the reference serializes creation the same way)
    if client_id.endswith("-0"):
        with svc.lock:
            ds = container.runtime.create_datastore("stress")
            text = ds.create_channel("sharedstring", "text")
            meta = ds.create_channel("sharedmap", "meta")
            container.flush()
    else:
        deadline = time.monotonic() + 30
        text = meta = None
        while time.monotonic() < deadline:
            with svc.lock:
                if "stress" in container.runtime.datastores:
                    ds = container.runtime.get_datastore("stress")
                    try:
                        text = ds.get_channel("text")
                        meta = ds.get_channel("meta")
                        break
                    except KeyError:
                        pass
            time.sleep(0.02)
        if text is None or meta is None:
            raise TimeoutError(f"{client_id}: structure never arrived")

    for i in range(n_ops):
        with svc.lock:
            length = len(text.get_text())
            roll = rng.random()
            if roll < 0.65 or length < 4:
                pos = rng.randint(0, length)
                text.insert_text(
                    pos, "".join(rng.choice(alphabet)
                                 for _ in range(rng.randint(1, 4)))
                )
            elif roll < 0.9:
                start = rng.randint(0, length - 2)
                text.remove_text(
                    start, min(length, start + rng.randint(1, 3))
                )
            else:
                start = rng.randint(0, length - 2)
                text.annotate_range(
                    start, min(length, start + 2), {"mark": i % 7}
                )
            container.flush()
        time.sleep(0)  # yield to the dispatch thread

    with svc.lock:
        meta.set(f"done/{client_id}", True)
        container.flush()

    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        with svc.lock:
            done = sum(
                1 for k in meta.keys() if k.startswith("done/")
            )
            quiesced = container.runtime.pending.count == 0
            if done >= n_workers and quiesced:
                break
        time.sleep(0.02)
    else:
        raise TimeoutError(
            f"{client_id}: convergence barrier not reached"
        )

    with svc.lock:
        final = text.get_text()
    container.close()
    svc.close()
    return {
        "client_id": client_id,
        "text_sha": hashlib.sha256(final.encode()).hexdigest(),
        "length": len(final),
        # this worker's registry movement (fresh process, so the
        # delta is its whole story: ops submitted/acked, frames,
        # roundtrip histogram buckets)
        "metrics_delta": obs_metrics.REGISTRY.delta(metrics_before),
    }


def _spawn_server(port: int,
                  partitions: int = 0) -> tuple[subprocess.Popen, int]:
    cmd = [sys.executable, "-m", "fluidframework_tpu_torch.service",
           "--port", str(port)]
    if partitions > 0:
        cmd += ["--partitions", str(partitions)]
    proc = subprocess.Popen(
        cmd,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
    )
    line = proc.stdout.readline()
    m = re.search(r"listening on [\w.]+:(\d+)", line)
    if not m:
        proc.kill()
        raise RuntimeError(f"server failed to start: {line!r}")
    return proc, int(m.group(1))


def run_net_stress(n_workers: int = 3, n_ops: int = 30,
                   port: int = 0, seed: int = 1234,
                   timeout: float = 180.0, partitions: int = 0) -> dict:
    """Full orchestration; returns a report dict, raises on failure.
    ``partitions`` > 0 stresses the partitioned queue pipeline shape
    instead of the inline orderer."""
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    server, port = _spawn_server(port, partitions)
    try:
        workers = []
        for i in range(n_workers):
            code = (
                "import json, sys; "
                "from fluidframework_tpu_torch.tools.net_stress import "
                "worker_main; "
                f"r = worker_main('127.0.0.1', {port}, 'stress-doc', "
                f"'worker-{i}', {n_ops}, {n_workers}, {seed + i}); "
                "print(json.dumps(r))"
            )
            workers.append(subprocess.Popen(
                [sys.executable, "-c", code],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=repo,
            ))
        reports = []
        for i, proc in enumerate(workers):
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"worker-{i} failed rc={proc.returncode}:\n"
                    f"{err[-2000:]}"
                )
            reports.append(json.loads(out.strip().splitlines()[-1]))

        hashes = {r["text_sha"] for r in reports}
        if len(hashes) != 1:
            raise AssertionError(f"workers diverged: {reports}")

        # independent validation: fresh container replays the op log
        from ..drivers.socket_driver import SocketDocumentService
        from ..loader import Container

        svc = SocketDocumentService("127.0.0.1", port, "stress-doc")
        with svc.lock:
            validator = Container.load(svc, client_id="validator")
        with svc.lock:
            replay_text = (validator.runtime.get_datastore("stress")
                           .get_channel("text").get_text())
        validator.close()
        svc.close()
        replay_sha = hashlib.sha256(replay_text.encode()).hexdigest()
        if replay_sha not in hashes:
            raise AssertionError(
                f"op-log replay diverged from live clients: "
                f"replay len {len(replay_text)} "
                f"vs workers {[r['length'] for r in reports]}; "
                f"replay text {replay_text[:80]!r}"
            )
        from ..obs import metrics as obs_metrics

        return {
            "workers": reports,
            "converged_sha": hashes.pop(),
            "replay_length": len(replay_text),
            # the validator's own registry view (per-worker deltas
            # ride inside each worker report); delta({}) = nonzero
            # series only
            "metrics_delta": obs_metrics.REGISTRY.delta({}),
        }
    finally:
        server.kill()
        server.wait()


def main(argv: Optional[list] = None) -> int:  # pragma: no cover
    parser = argparse.ArgumentParser()
    parser.add_argument("--workers", type=int, default=3)
    parser.add_argument("--ops", type=int, default=30)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--partitions", type=int, default=0)
    args = parser.parse_args(argv)
    report = run_net_stress(args.workers, args.ops, args.port,
                            args.seed, partitions=args.partitions)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
