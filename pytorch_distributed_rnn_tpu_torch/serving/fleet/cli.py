"""``python -m pytorch_distributed_rnn_tpu_torch.serving router``: the fleet
router's entry point, the counterpart of the JAX package's
``pdrnn-router`` with every flag it has.  The router is host code and
takes no ``--device``; its replicas are ``serve`` processes with their
own.

::

  python -m pytorch_distributed_rnn_tpu_torch.serving router \\
      --replicas 127.0.0.1:7071,127.0.0.1:7072 --port 7070 \\
      --retries 2 --hedge-after-ms 250 --metrics router-metrics.jsonl \\
      --live 9100

The router is the fleet's observability ANCHOR: with ``--live`` it
hosts the aggregator (``/metrics`` + ``/health`` + ``/events`` +
``/fleet``) the replicas push their digests to - which is also the
router's load signal (a replica's ``serving.active + queue_depth``
rides its digest, so least-loaded dispatch needs no extra channel).

``--replica-port-files`` is the drill/spawn form: each replica writes
``host port`` once listening, the router waits for every file - no
fixed port allocation needed.  Replica ids are 1..N in listed order
(the router itself is rank 0).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
import time
from pathlib import Path


log = logging.getLogger(__name__)


def build_router_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_rnn_tpu_torch.serving router",
        description="fault-tolerant fleet router over serve "
        "replicas (same JSONL protocol as a single server)",
    )
    target = parser.add_mutually_exclusive_group(required=True)
    target.add_argument(
        "--replicas", default=None, metavar="HOST:PORT,...",
        help="static replica pool, comma-separated",
    )
    target.add_argument(
        "--replica-port-files", default=None, metavar="PATH,...",
        help="read each replica's address from a serve "
        "--port-file (waits for the files; the spawn-fleet form)",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument(
        "--port", default=0, type=int,
        help="TCP port (0 = ephemeral; see --port-file)",
    )
    parser.add_argument(
        "--port-file", default=None, type=Path, metavar="PATH",
        help="write 'host port' here once the pool is READY (first "
        "replica pong), so spawners block until the fleet can serve",
    )
    parser.add_argument(
        "--max-inflight", default=64, type=int,
        help="admission budget; QoS classes shed past graduated "
        "shares of it (low at 50%%, normal at 85%%, high at 100%%)",
    )
    parser.add_argument(
        "--retries", default=2, type=int,
        help="sibling re-dispatch budget per request (idempotent "
        "seeded requests only; a started stream is never replayed)",
    )
    parser.add_argument(
        "--hedge-after-ms", default=None, type=float,
        help="tail-latency hedge: dispatch a second replica when the "
        "primary is silent this long (non-stream requests only)",
    )
    parser.add_argument(
        "--deadline-ms", default=None, type=float,
        help="default per-request deadline when the client sends none",
    )
    parser.add_argument(
        "--trace-sample", default=0.0, type=float, metavar="RATE",
        help="head-sample this fraction of untraced requests into "
        "distributed traces (0 = off; requests arriving with a trace "
        "field are always traced; needs --metrics for the spans to "
        "land anywhere)",
    )
    parser.add_argument(
        "--eject-after", default=3, type=int,
        help="consecutive failures (ping or dispatch) opening a "
        "replica's circuit breaker",
    )
    parser.add_argument(
        "--cooldown-s", default=2.0, type=float,
        help="open -> half-open breaker cooldown",
    )
    parser.add_argument(
        "--half-open-probes", default=2, type=int,
        help="ping successes re-admitting a half-open replica (one "
        "successful trial dispatch also re-admits)",
    )
    parser.add_argument("--health-every-s", default=0.5, type=float)
    parser.add_argument("--connect-timeout", default=2.0, type=float,
                        metavar="S")
    parser.add_argument("--io-timeout", default=30.0, type=float,
                        metavar="S")
    parser.add_argument(
        "--ready-timeout", default=60.0, type=float, metavar="S",
        help="max wait for replica port files + the first pong",
    )
    parser.add_argument(
        "--drain-timeout", default=30.0, type=float, metavar="S",
        help="SIGTERM drain bound: in-flight dispatches get this long",
    )
    parser.add_argument("--metrics", default=None, type=Path,
                        metavar="PATH")
    parser.add_argument("--metrics-sample-every", default=None, type=int)
    parser.add_argument(
        "--live", default=None, metavar="[HOST:]PORT",
        help="live observability plane (needs --metrics): the router "
        "ANCHORS the fleet aggregator here - replicas started with "
        "the same --live spec push their digests to it; the anchor "
        "also hosts the time-series store behind GET /series and the "
        "capacity gauges on /metrics",
    )
    parser.add_argument("--live-port-file", default=None, type=Path,
                        metavar="PATH")
    parser.add_argument(
        "--slo", action="append", default=None, metavar="SPEC",
        help="per-QoS SLO objective (repeatable, one per class): "
        "'qos=high:p95_ms=250:availability=99.9'.  Arms per-class SLO "
        "breach alerts and the store's multi-window error-budget burn "
        "alerts (slo_burn fires / slo_burn_cleared on /events)",
    )
    parser.add_argument(
        "--slo-windows", default=None, metavar="FAST,SLOW",
        help="burn-rate window pair in seconds (default 300,3600 - "
        "the Google SRE fast/slow pair); drills shrink it to fit a "
        "burst",
    )
    parser.add_argument("--log", default="INFO")
    return parser


def _parse_host_port(spec: str) -> tuple[str, int]:
    host, _, port = spec.strip().rpartition(":")
    if not host:
        raise SystemExit(f"bad replica spec {spec!r} (want HOST:PORT)")
    return host, int(port)


def _await_port_files(paths: list[Path],
                      timeout_s: float) -> list[tuple[str, int]]:
    """Block until every replica wrote its ``host port`` file."""
    deadline = time.monotonic() + timeout_s
    addrs: list[tuple[str, int]] = []
    for path in paths:
        while True:
            try:
                fields = path.read_text().split()
                if len(fields) == 2:
                    addrs.append((fields[0], int(fields[1])))
                    break
            except (OSError, ValueError):
                pass
            if time.monotonic() > deadline:
                raise SystemExit(
                    f"replica port file {path} not ready after "
                    f"{timeout_s:g}s"
                )
            time.sleep(0.05)
    return addrs


def router_main(argv=None) -> int:
    args = build_router_parser().parse_args(argv)
    logging.basicConfig(level=args.log.upper())

    from pytorch_distributed_rnn_tpu_torch.obs.live import LivePlane
    from pytorch_distributed_rnn_tpu_torch.obs.recorder import MetricsRecorder
    from pytorch_distributed_rnn_tpu_torch.serving.fleet.pool import (
        Replica,
        ReplicaPool,
    )
    from pytorch_distributed_rnn_tpu_torch.serving.fleet.router import (
        RouterCore,
        RouterServer,
    )

    if args.replicas is not None:
        addrs = [_parse_host_port(s) for s in args.replicas.split(",")]
    else:
        paths = [Path(p.strip())
                 for p in args.replica_port_files.split(",")]
        addrs = _await_port_files(paths, args.ready_timeout)
    # ids 1..N: the router is the fleet's rank 0, replicas are ranks
    # 1..N - matching the --replica-id each replica was given
    replicas = [
        Replica(i + 1, host=h, port=p) for i, (h, p) in enumerate(addrs)
    ]

    recorder = MetricsRecorder.resolve(
        args, meta={"role": "router", "argv": sys.argv[1:]},
    )
    plane = LivePlane.resolve(args, recorder, rank=0, role="router")

    def load_hint(replica) -> float:
        # the live plane doubles as the load signal: a replica's digest
        # carries its serving gauges; silence costs nothing (hint 0 -
        # pings still arbitrate liveness)
        if plane is None or plane.aggregator is None:
            return 0.0
        digest = plane.aggregator.peek(f"serve-{replica.replica_id}")
        serving = (digest or {}).get("serving") or {}
        return float((serving.get("active") or 0)
                     + (serving.get("queue_depth") or 0))

    def pool_event(kind: str, **fields) -> None:
        if recorder.enabled:
            recorder.record(kind, **fields)

    pool = ReplicaPool(
        replicas, eject_after=args.eject_after,
        cooldown_s=args.cooldown_s,
        half_open_probes=args.half_open_probes,
        health_every_s=args.health_every_s,
        connect_timeout_s=args.connect_timeout,
        load_hint=load_hint, on_event=pool_event,
    )
    core = RouterCore(
        pool, max_inflight=args.max_inflight, retries=args.retries,
        hedge_after_ms=args.hedge_after_ms,
        default_deadline_ms=args.deadline_ms,
        connect_timeout_s=args.connect_timeout,
        io_timeout_s=args.io_timeout, recorder=recorder,
        trace_sample=args.trace_sample,
    )
    if plane is not None:
        plane.exporter.add_source(core.live_source)
    server = RouterServer(core, host=args.host, port=args.port,
                          recorder=recorder)

    stop = threading.Event()

    def _on_signal(signum, _frame):
        log.info(f"router: signal {signum}, draining")
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    server.start()
    if not server.wait_ready(timeout_s=args.ready_timeout):
        print(
            f"router: no replica answered a ping within "
            f"{args.ready_timeout:g}s", file=sys.stderr,
        )
        server.shutdown(drain_timeout_s=1.0)
        if plane is not None:
            plane.close()
        return 2
    # the port file lands only once the fleet can actually serve, so a
    # spawner reading it never races the first dispatch into a pool of
    # unpinged replicas
    if args.port_file is not None:
        args.port_file.parent.mkdir(parents=True, exist_ok=True)
        args.port_file.write_text(f"{server.host} {server.port}\n")
    print(f"router: listening on {server.host}:{server.port} "
          f"({len(replicas)} replicas)", flush=True)
    while not stop.is_set():
        stop.wait(timeout=0.5)
    server.shutdown(drain_timeout_s=args.drain_timeout)
    if plane is not None:
        plane.close()
    stats = core.stats()
    log.info(
        f"router: routed {stats['done']} "
        f"({stats['rerouted']} rerouted, {stats['retries']} retries, "
        f"{stats['hedges']} hedges), shed {stats['shed_total']}, "
        f"{stats['errors']} errors"
    )
    return 0


if __name__ == "__main__":
    sys.exit(router_main())
