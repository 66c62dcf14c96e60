"""Shared ink whiteboard over the TCP service — the canvas sample
(reference: examples/data-objects/canvas + the ink DDS): two artists
draw concurrent strokes, one clears the board mid-stroke, and an
ASCII render of the converged canvas is printed from both replicas.

Run: python -m fluidframework_tpu_torch.examples.ink_whiteboard
(starts its own service subprocess on a free port)
"""
import math
import os
import re
import signal
import subprocess
import sys
import time

from fluidframework_tpu_torch.drivers.socket_driver import (
    SocketDocumentService,
)
from fluidframework_tpu_torch.loader import Container

W, H = 48, 14


def render(ink) -> str:
    grid = [[" "] * W for _ in range(H)]
    # paint in a replica-independent order: get_strokes() iterates
    # local insertion order, which differs between replicas for
    # concurrent strokes — sort by stroke id for a deterministic
    # z-order
    for stroke in sorted(ink.get_strokes(),
                         key=lambda s: s.get("id", "")):
        mark = stroke["pen"].get("mark", "*")
        for p in stroke["points"]:
            x, y = int(p["x"]), int(p["y"])
            if 0 <= x < W and 0 <= y < H:
                grid[y][x] = mark
    return "\n".join("".join(row) for row in grid)


def wait_converged(svc_a, ia, svc_b, ib, timeout=20.0):
    """Broadcast delivery is async: wait until both replicas hold the
    same stroke/point counts before comparing renders."""
    def counts(ink):
        return sorted((s["pen"].get("mark", "*"), len(s["points"]))
                      for s in ink.get_strokes())
    deadline = time.time() + timeout
    while time.time() < deadline:
        with svc_a.lock, svc_b.lock:
            if counts(ia) == counts(ib):
                return
        time.sleep(0.05)
    raise TimeoutError("replicas never converged")


def pump(svc, container, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with svc.lock:
            if container.runtime.pending.count == 0:
                return
        time.sleep(0.02)
    raise TimeoutError("ops never acked")


def main() -> int:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    server = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=repo,
    )
    line = server.stdout.readline()
    port = int(re.search(r":(\d+)", line).group(1))
    try:
        svc_a = SocketDocumentService("127.0.0.1", port, "board")
        with svc_a.lock:
            ca = Container.load(svc_a, client_id="ana")
            ia = ca.runtime.create_datastore("app").create_channel(
                "ink", "canvas")
            ca.flush()
        pump(svc_a, ca)

        svc_b = SocketDocumentService("127.0.0.1", port, "board")
        with svc_b.lock:
            cb = Container.load(svc_b, client_id="ben")
            ib = cb.runtime.get_datastore("app").get_channel("canvas")

        # ana draws a sine wave while ben draws a box — concurrently
        with svc_a.lock:
            s1 = ia.create_stroke({"mark": "~", "color": "blue"})
            for x in range(2, W - 2):
                ia.append_point(s1, {
                    "x": x, "y": int(H / 2 + 4 * math.sin(x / 4))})
            ca.flush()
        with svc_b.lock:
            s2 = ib.create_stroke({"mark": "#", "color": "red"})
            for x in range(8, 40):
                ib.append_point(s2, {"x": x, "y": 2})
                ib.append_point(s2, {"x": x, "y": H - 3})
            for y in range(2, H - 2):
                ib.append_point(s2, {"x": 8, "y": y})
                ib.append_point(s2, {"x": 39, "y": y})
            cb.flush()
        pump(svc_a, ca)
        pump(svc_b, cb)
        wait_converged(svc_a, ia, svc_b, ib)

        with svc_a.lock, svc_b.lock:
            ra, rb = render(ia), render(ib)
            assert ra == rb, "canvases diverged"
            n_str = len(ia.get_strokes())
        print(f"converged canvas ({n_str} strokes):")
        print(ra)

        # ben clears while ana keeps drawing: clear-wins on the
        # earlier strokes, ana's post-clear points survive
        with svc_b.lock:
            ib.clear()
            cb.flush()
        with svc_a.lock:
            s3 = ia.create_stroke({"mark": "o"})
            for x in range(20, 28):
                ia.append_point(s3, {"x": x, "y": 6})
            ca.flush()
        pump(svc_a, ca)
        pump(svc_b, cb)
        wait_converged(svc_a, ia, svc_b, ib)
        with svc_a.lock, svc_b.lock:
            ra, rb = render(ia), render(ib)
            assert ra == rb, "post-clear canvases diverged"
            assert all(s["pen"].get("mark") == "o"
                       for s in ia.get_strokes())
        print("after ben's clear + ana's new stroke (converged):")
        print(ra)
        print("OK: ink whiteboard converged over the TCP service, "
              "including a concurrent clear.")
        with svc_a.lock:
            ca.close()
        with svc_b.lock:
            cb.close()
        svc_a.close()
        svc_b.close()
        return 0
    finally:
        os.kill(server.pid, signal.SIGKILL)
        server.wait()


if __name__ == "__main__":
    raise SystemExit(main())
