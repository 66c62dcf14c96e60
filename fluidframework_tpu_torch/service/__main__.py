"""Runnable single-process dev service — the tinylicious analogue.

Reference: server/tinylicious (single-tenant, no-Kafka, in-memory
service for development). Usage:

    python -m fluidframework_tpu_torch.service [--host H] [--port P]

Clients connect with
``drivers.socket_driver.SocketDocumentServiceFactory`` and the normal
``loader.Container`` on top.

Observability: a running service answers the ``metrics`` frame with
the process-wide registry (fluidframework_tpu_torch/obs/metrics.py);

    python -m fluidframework_tpu_torch.service --dump-metrics HOST:PORT

is the /metrics-equivalent dump command (Prometheus text exposition;
``--json`` for the structured snapshot). A service started with
``--slo`` additionally grades the default serving objectives
(ingress dispatch p99, goodput floor) with multi-window burn rates;

    python -m fluidframework_tpu_torch.service --dump-slo HOST:PORT

prints the live ``slo_report`` (per-objective verdicts + context);

    python -m fluidframework_tpu_torch.service --dump-fleet HOST:PORT

prints the FEDERATED metrics view (obs/federation.py — leader +
follower + partition-worker registries merged, node-labelled); and

    python -m fluidframework_tpu_torch.service --dump-heat HOST:PORT

prints the cost-attribution view (obs/heat.py — top-k hot documents
by attributed device-ms and top-k tenants off the usage ledger;
``--top-k N`` overrides the server's default cut).

A copy of the reference's ``service/__main__.py``.
"""
from __future__ import annotations

import argparse
from typing import Optional

from .ingress import run_server


def dump_metrics(target: str, as_json: bool) -> int:
    """Connect to a running service and print its metrics registry."""
    import json
    import socket

    from .ingress import _parse_hostport, pack_frame, recv_frame_blocking

    host, port = _parse_hostport(target)
    with socket.create_connection((host, port), timeout=10.0) as sock:
        sock.sendall(pack_frame({"type": "metrics", "rid": 1}))
        frame = recv_frame_blocking(sock)
    if frame.get("type") != "metrics":
        print(f"unexpected response: {frame}")
        return 1
    if as_json:
        print(json.dumps(frame["metrics"], indent=2, sort_keys=True))
    else:
        print(frame["text"], end="")
    return 0


def dump_fleet(target: str, as_json: bool) -> int:
    """Connect to a running service and print its FEDERATED metrics
    view (obs/federation.py: leader + follower + partition-worker
    registries merged — sum counters, node-labelled gauges,
    bucket-wise histograms)."""
    import json
    import socket

    from .ingress import _parse_hostport, pack_frame, recv_frame_blocking

    host, port = _parse_hostport(target)
    with socket.create_connection((host, port), timeout=10.0) as sock:
        sock.sendall(pack_frame({"type": "fleet-metrics", "rid": 1}))
        frame = recv_frame_blocking(sock)
    if frame.get("type") != "fleet-metrics":
        print(f"unexpected response: {frame}")
        return 1
    if as_json:
        print(json.dumps(
            {"nodes": frame["nodes"], "metrics": frame["metrics"]},
            indent=2, sort_keys=True))
    else:
        print(f"# fleet nodes: {', '.join(frame['nodes'])}")
        print(frame["text"], end="")
    return 0


def dump_slo(target: str) -> int:
    """Connect to a running service and print its slo_report."""
    import json
    import socket

    from .ingress import _parse_hostport, pack_frame, recv_frame_blocking

    host, port = _parse_hostport(target)
    with socket.create_connection((host, port), timeout=10.0) as sock:
        sock.sendall(pack_frame({"type": "slo", "rid": 1}))
        frame = recv_frame_blocking(sock)
    if frame.get("type") != "slo":
        print(f"unexpected response: {frame}")
        return 1
    if frame.get("report") is None:
        print(frame.get("message", "no slo report"))
        return 1
    print(json.dumps(frame["report"], indent=2, sort_keys=True))
    return 0


def dump_heat(target: str, k: Optional[int] = None) -> int:
    """Connect to a running service and print its heat view (top-k
    hot documents + tenants off the attribution ledgers)."""
    import json
    import socket

    from .ingress import _parse_hostport, pack_frame, recv_frame_blocking

    host, port = _parse_hostport(target)
    req = {"type": "heat", "rid": 1}
    if k is not None:
        # optional-presence wire field: emitted only when the caller
        # asked for a specific cut (the server serves its default
        # otherwise)
        req["k"] = k
    with socket.create_connection((host, port), timeout=10.0) as sock:
        sock.sendall(pack_frame(req))
        frame = recv_frame_blocking(sock)
    if frame.get("type") != "heat":
        print(f"unexpected response: {frame}")
        return 1
    print(json.dumps(
        {"docs": frame.get("docs", []),
         "tenants": frame.get("tenants", [])},
        indent=2, sort_keys=True))
    return 0


def main() -> None:
    parser = argparse.ArgumentParser(
        prog="python -m fluidframework_tpu_torch.service",
        description="fluidframework-tpu-torch dev ordering service",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7070)
    parser.add_argument("--data-dir", default=None,
                        help="durable storage root (op logs, "
                             "summaries, checkpoints)")
    parser.add_argument("--partitions", type=int, default=0,
                        help="route through N queue partitions (the "
                             "scale-out pipeline shape); 0 = inline "
                             "orderer")
    parser.add_argument("--broker", default=None,
                        help="host:port of a running "
                             "fluidframework_tpu_torch.service.broker — "
                             "the networked ordering queue (partitions "
                             "span hosts)")
    parser.add_argument("--qos", action="store_true",
                        help="enable admission control + "
                             "backpressure (docs/QOS.md): token-"
                             "bucket rate limits, pressure-tier load "
                             "shedding with honest retry-after "
                             "throttle nacks, checkpoint circuit "
                             "breaker")
    parser.add_argument("--qos-ops-per-sec", type=float,
                        default=2000.0,
                        help="per-connection op budget the other "
                             "qos limits scale from (default 2000)")
    parser.add_argument("--slo", action="store_true",
                        help="grade the default serving SLOs "
                             "(ingress dispatch p99, goodput floor) "
                             "with multi-window burn rates; serves "
                             "the `slo` frame for --dump-slo")
    parser.add_argument("--dump-metrics", default=None,
                        metavar="HOST:PORT",
                        help="print a RUNNING service's metrics "
                             "registry (Prometheus text) and exit "
                             "instead of serving")
    parser.add_argument("--dump-slo", default=None,
                        metavar="HOST:PORT",
                        help="print a RUNNING --slo service's "
                             "slo_report (per-objective burn-rate "
                             "verdicts, JSON) and exit")
    parser.add_argument("--dump-fleet", default=None,
                        metavar="HOST:PORT",
                        help="print a RUNNING service's FEDERATED "
                             "metrics view (leader + follower + "
                             "partition-worker registries merged; "
                             "Prometheus text, --json for the "
                             "snapshot) and exit")
    parser.add_argument("--dump-heat", default=None,
                        metavar="HOST:PORT",
                        help="print a RUNNING service's cost-"
                             "attribution view (top-k hot documents "
                             "by attributed device-ms + top-k "
                             "tenants, JSON) and exit")
    parser.add_argument("--top-k", type=int, default=None,
                        help="with --dump-heat: ask for this cut "
                             "instead of the server default")
    parser.add_argument("--json", action="store_true",
                        help="with --dump-metrics/--dump-fleet: emit "
                             "the JSON snapshot instead of text "
                             "exposition")
    args = parser.parse_args()
    if args.dump_metrics is not None:
        raise SystemExit(dump_metrics(args.dump_metrics, args.json))
    if args.dump_slo is not None:
        raise SystemExit(dump_slo(args.dump_slo))
    if args.dump_fleet is not None:
        raise SystemExit(dump_fleet(args.dump_fleet, args.json))
    if args.dump_heat is not None:
        raise SystemExit(dump_heat(args.dump_heat, args.top_k))
    run_server(args.host, args.port, args.data_dir, args.partitions,
               args.broker, qos_enabled=args.qos,
               qos_ops_per_sec=args.qos_ops_per_sec,
               slo_enabled=args.slo)


if __name__ == "__main__":
    main()
