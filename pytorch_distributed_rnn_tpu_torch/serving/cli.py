"""``serve`` and ``loadgen``: the port's serving entry points, the
counterparts of the JAX package's ``pdrnn-serve`` and ``pdrnn-loadgen``
(``serving/cli.py``), with JAX's flag surface plus ``--device {cuda,cpu}``
(default ``cuda``; without a card the server fails and says to pass
``--device cpu``).

Serve::

  python -m pytorch_distributed_rnn_tpu_torch.serving serve --checkpoint models/ \\
      --model char --hidden-units 512 --stacked-layer 2 --port 7071 \\
      --metrics serve-metrics.jsonl --live 0 --live-port-file live.port

The model flags mirror the training CLI's: a checkpoint stores only
tensors, so the server builds the architecture from the flags the
training run used and loads the model section of the newest valid
checkpoint (``--checkpoint`` is the file or the training
``--checkpoint-directory``).  ``--faults`` takes the chaos grammar of
``resilience/faults.py`` (the step index is the decode step): the SLO
drill injects stalls and NaN through it.

Load::

  python -m pytorch_distributed_rnn_tpu_torch.serving loadgen --connect 127.0.0.1:7071 \\
      --requests 100 --rate 40 --slo-p95-ms 500 --report report.json
  python -m pytorch_distributed_rnn_tpu_torch.serving loadgen --spawn-server \\
      "--checkpoint models/ --model char --hidden-units 512" --requests 64

``--spawn-server`` runs the chaos SLO drill: a server subprocess up, load
through it, SIGTERM down, the report (with the degradation window and the
server's exit code) out.  Exit codes: 0 = SLO pass, 1 = SLO fail or
errors, 2 = usage or spawn failure.

``--spawn-fleet N`` runs the kill-mid-burst fleet drill
(``serving/fleet/drill.py``): N supervised replicas behind a router, one
SIGKILLed mid-burst, and the verdict is graceful degradation - rerouting,
exactly-once accounting, a closed degradation window - instead of a bare
SLO pass::

  python -m pytorch_distributed_rnn_tpu_torch.serving loadgen --spawn-fleet 3 \\
      --replica-args "--checkpoint models/ --model char --hidden-units 512" \\
      --fleet-kill-after-s 2 --requests 120 --rate 40

``--model moe`` is parsed and rejected: the MoE LM comes with ROADMAP A9.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shlex
import signal
import sys
import threading
from pathlib import Path

log = logging.getLogger(__name__)

MOE_NOT_PORTED = ("--model moe is not ported yet - the port serves --model char and "
                  "attention; the MoE LM and its adapter come with ROADMAP.md A9")


# ---------------------------------------------------------------------------
# serve


def build_serve_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_rnn_tpu_torch.serving serve",
        description="continuous-batching inference server",
    )
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the engine runs (default cuda; no silent fallback)")
    parser.add_argument(
        "--checkpoint", required=True, type=Path, metavar="PATH",
        help="checkpoint file, or a training --checkpoint-directory (the "
        "newest VALID checkpoint is used, corrupt files skipped)",
    )
    parser.add_argument(
        "--model", default="char", choices=["char", "attention", "moe"],
        help="served family: the char LM (CharRNN) or the attention LM "
        "(AttentionLM - KV-cache decode); moe waits for ROADMAP.md A9",
    )
    parser.add_argument("--vocab-size", default=256, type=int)
    parser.add_argument(
        "--hidden-units", default=32, type=int,
        help="hidden/model width (training-CLI convention: the char "
        "family's embed dim equals this; attention uses it as the block "
        "dim)",
    )
    parser.add_argument("--stacked-layer", default=2, type=int)
    parser.add_argument("--cell", default="lstm", choices=["lstm", "gru"])
    parser.add_argument("--num-heads", default=4, type=int)
    parser.add_argument(
        "--max-len", default=512, type=int,
        help="attention family: KV-cache capacity / positional extent",
    )
    parser.add_argument("--num-experts", default=4, type=int, help="--model moe only")
    parser.add_argument("--moe-top-k", default=1, type=int, choices=[1, 2],
                        help="--model moe only")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument(
        "--port", default=0, type=int,
        help="TCP port (0 = ephemeral; see --port-file)",
    )
    parser.add_argument(
        "--port-file", default=None, type=Path, metavar="PATH",
        help="write 'host port' here once listening (how scripts and "
        "the drill find an ephemeral port)",
    )
    parser.add_argument(
        "--slots", default=8, type=int,
        help="decode batch slots - the continuous batch width",
    )
    parser.add_argument(
        "--prompt-buckets", default="16,32,64,128", metavar="L1,L2,...",
        help="prompt-length pad buckets; one prefill graph is captured per "
        "bucket and the mix can never add one after warm-up",
    )
    parser.add_argument(
        "--max-new-tokens", default=128, type=int,
        help="per-request decode-length cap",
    )
    parser.add_argument(
        "--max-queue", default=64, type=int,
        help="admission-queue depth; requests past it are SHED with an "
        "overload error instead of waiting unboundedly",
    )
    parser.add_argument(
        "--no-warmup", action="store_true",
        help="capture no program at startup (each is captured at its first "
        "use; none is captured after that)",
    )
    parser.add_argument(
        "--faults", default=None, metavar="SPEC",
        help="chaos schedule on the decode loop (resilience/faults.py "
        "grammar; step index = decode step): stall holds the loop, nan "
        "poisons in-flight logits (affected requests fail cleanly), "
        "exc is absorbed, kill preempts the process; net:flap:<s> "
        "drops every open client connection each period",
    )
    parser.add_argument(
        "--replica-id", default=None, type=int, metavar="K",
        help="fleet membership (serving/fleet/): this server is "
        "replica K (1..N) behind a router - it pushes its live digests "
        "to the router's aggregator instead of anchoring one, announces "
        "itself via register/drain heartbeats, and SIGTERM DRAINS "
        "(finish in-flight, reject new) instead of aborting",
    )
    parser.add_argument(
        "--drain-timeout", default=30.0, type=float, metavar="S",
        help="bound on the SIGTERM drain wait (fleet replicas)",
    )
    parser.add_argument("--metrics", default=None, type=Path, metavar="PATH")
    parser.add_argument("--metrics-sample-every", default=None, type=int)
    parser.add_argument(
        "--live", default=None, metavar="[HOST:]PORT",
        help="live observability plane (obs/live.py; needs --metrics): "
        "serve GET /metrics (Prometheus), /health, /events, /fleet and "
        "/series on this address, with the time-series store and the "
        "anomaly watchdog (stall / NaN / SLO breach + budget-burn "
        "alerts, stack dumps) armed; also read from the PDRNN_LIVE env",
    )
    parser.add_argument(
        "--live-port-file", default=None, type=Path, metavar="PATH",
        help="write 'host port' of the live endpoint here once bound "
        "(how scripts find a --live 0 ephemeral port)",
    )
    parser.add_argument(
        "--slo", action="append", default=None, metavar="SPEC",
        help="per-QoS SLO objective (repeatable, one per class): "
        "'qos=high:p95_ms=250:availability=99.9'.  Arms the watchdog's "
        "per-class SLO detector, and - on the live-plane anchor - the "
        "store's multi-window error-budget burn alerts (slo_burn / "
        "slo_burn_cleared on /events)",
    )
    parser.add_argument(
        "--slo-windows", default=None, metavar="FAST,SLOW",
        help="burn-rate window pair in seconds (default 300,3600 - the "
        "Google SRE fast/slow pair); drills shrink it to fit a burst",
    )
    parser.add_argument("--log", default="INFO")
    return parser


def reject_unported_serve(args):
    if args.model == "moe":
        raise SystemExit(MOE_NOT_PORTED)


def build_model(args):
    """The served model from the flags (``--model moe`` is rejected before),
    on the CPU, its weights to come from the checkpoint:
    ``CharRNN(..., impl="scan")`` or ``AttentionLM``."""
    from pytorch_distributed_rnn_tpu_torch.models import AttentionLM, CharRNN

    if args.model == "char":
        return CharRNN(
            vocab_size=args.vocab_size, embed_dim=args.hidden_units,
            hidden_dim=args.hidden_units, layer_dim=args.stacked_layer,
            cell=args.cell, impl="scan",
        )
    return AttentionLM(
        vocab_size=args.vocab_size, dim=args.hidden_units,
        depth=args.stacked_layer, num_heads=args.num_heads,
        max_len=args.max_len,
    )


def resolve_checkpoint(path: Path) -> Path:
    from pytorch_distributed_rnn_tpu_torch.training.checkpoint import find_latest_checkpoint

    if path.is_dir():
        found = find_latest_checkpoint(path)
        if found is None:
            raise SystemExit(
                f"no valid checkpoint under {path} (corrupt files are "
                "skipped; train one first or pass the file directly)"
            )
        return found
    if not path.exists():
        raise SystemExit(f"checkpoint {path} does not exist")
    return path


def load_served_model(args):
    """``(model, meta)``: the model the flags describe with the weights of
    the newest valid checkpoint, on ``--device``, in eval mode."""
    from pytorch_distributed_rnn_tpu_torch.training.checkpoint import load_model_params
    from pytorch_distributed_rnn_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    ckpt = resolve_checkpoint(args.checkpoint)
    model = build_model(args)
    meta = load_model_params(ckpt, model)
    log.info(f"serve: loaded {ckpt} (epoch {meta['epoch']}, loss {meta['loss']:.4f})")
    return model.to(device).eval(), meta


def serve_main(argv=None) -> int:
    args = build_serve_parser().parse_args(argv)
    logging.basicConfig(level=args.log.upper())
    reject_unported_serve(args)

    from pytorch_distributed_rnn_tpu_torch.obs.live import LivePlane
    from pytorch_distributed_rnn_tpu_torch.obs.recorder import MetricsRecorder
    from pytorch_distributed_rnn_tpu_torch.resilience.faults import FaultSchedule
    from pytorch_distributed_rnn_tpu_torch.serving.adapters import adapter_for
    from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
    from pytorch_distributed_rnn_tpu_torch.serving.engine import ServingEngine
    from pytorch_distributed_rnn_tpu_torch.serving.server import ServingServer

    model, _ = load_served_model(args)
    replica_id = args.replica_id
    recorder = MetricsRecorder.resolve(
        args, rank=replica_id or 0,
        meta={"role": "serve", "argv": sys.argv[1:]},
    )
    faults = FaultSchedule.resolve(args)
    if faults is not None:
        log.warning(f"serve: chaos schedule active: {faults}")
    if recorder.enabled:
        # on-demand hang diagnosis: kill -USR2 <pid> dumps all-thread
        # stacks next to the sidecar (obs/watchdog.py)
        from pytorch_distributed_rnn_tpu_torch.obs.watchdog import install_stack_dump_handler

        install_stack_dump_handler(recorder.path)
    engine = ServingEngine(
        adapter_for(model), num_slots=args.slots,
        bucket_spec=BucketSpec.parse(args.prompt_buckets),
        max_new_tokens=args.max_new_tokens, max_queue=args.max_queue,
        recorder=recorder, faults=faults,
    )
    # live plane: /metrics + /health + /events served from this process
    # (the serving engine is the rank-0 anchor), with the engine's gauge
    # block riding every digest.  A fleet replica (--replica-id >= 1)
    # pushes to the router's aggregator instead of anchoring its own -
    # its digest doubles as the router's load signal
    plane = LivePlane.resolve(args, recorder, rank=replica_id or 0, role="serve",
                              faults=faults)
    if plane is not None:
        plane.exporter.add_source(engine.live_source)
    pusher = None
    if replica_id is not None:
        # register/drain heartbeats ride the aggregator's /events feed
        # (an alert-only EventPusher: a distinct id space from the digest
        # exporter, so the announcements never collide with the
        # replica's own gauge digests)
        from pytorch_distributed_rnn_tpu_torch.obs.live import (
            LIVE_ENV,
            EventPusher,
            parse_live_spec,
            resolve_push_url,
        )

        spec = args.live or os.environ.get(LIVE_ENV)
        if spec and recorder.enabled:
            lhost, lport = parse_live_spec(spec)
            pusher = EventPusher(lambda: resolve_push_url(args, lhost, lport),
                                 role="replica", rank=replica_id).push
    if not args.no_warmup:
        engine.warmup()
    server = ServingServer(engine, host=args.host, port=args.port, model_name=args.model,
                           recorder=recorder, pusher=pusher, replica_id=replica_id)
    if args.port_file is not None:
        args.port_file.parent.mkdir(parents=True, exist_ok=True)
        args.port_file.write_text(f"{server.host} {server.port}\n")

    stop = threading.Event()
    received = {"signum": None}

    def _on_signal(signum, _frame):
        log.info(f"serve: signal {signum}, shutting down")
        received["signum"] = signum
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    server.start()
    print(f"serve: listening on {server.host}:{server.port}", flush=True)
    while not stop.is_set():
        stop.wait(timeout=0.5)
    # a fleet replica DRAINS on SIGTERM: finish what it owns, reject new
    # work, and mark its digests drained so the aggregator (and ``obs
    # health``) classifies the coming silence as a voluntary exit
    drain = replica_id is not None and received["signum"] == signal.SIGTERM
    if drain and plane is not None:
        plane.exporter.note_drained()
    server.shutdown(drain=drain, drain_timeout_s=args.drain_timeout)
    if plane is not None:
        # after server.shutdown(): the recorder's close pushed the final
        # finished digest, so the last scrape-able state is honest
        plane.close()
    stats = engine.stats()
    log.info(
        f"serve: served {stats['requests']} requests "
        f"({stats['tokens_out']} tokens), shed {stats['requests_shed']}"
    )
    return 0


# ---------------------------------------------------------------------------
# loadgen


def build_loadgen_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_rnn_tpu_torch.serving loadgen",
        description="Poisson load generator + SLO report for the serving endpoint",
    )
    target = parser.add_mutually_exclusive_group(required=True)
    target.add_argument(
        "--connect", default=None, metavar="HOST:PORT",
        help="an already-running server",
    )
    target.add_argument(
        "--port-file", default=None, type=Path,
        help="read the target from a serve --port-file",
    )
    target.add_argument(
        "--spawn-server", default=None, metavar="ARGS",
        help="chaos SLO drill: spawn `serve ARGS` (shell-quoted string), "
        "load it, SIGTERM it, and report - including the degradation "
        "window and the server's exit code",
    )
    target.add_argument(
        "--spawn-fleet", default=None, type=int, metavar="N",
        help="kill-mid-burst fleet drill: spawn N supervised replicas "
        "(--replica-args) behind a router (--router-args), load "
        "through the router, optionally SIGKILL one replica mid-burst "
        "(--fleet-kill-after-s), and assert rerouting + exactly-once "
        "accounting + a CLOSED degradation window",
    )
    parser.add_argument(
        "--replica-args", default=None, metavar="ARGS",
        help="serve flags shared by every --spawn-fleet replica "
        "(shell-quoted; identity/port flags are added by the drill)",
    )
    parser.add_argument(
        "--router-args", default="", metavar="ARGS",
        help="extra router flags for --spawn-fleet (shell-quoted), e.g. "
        "'--retries 2 --hedge-after-ms 250'",
    )
    parser.add_argument(
        "--fleet-kill-after-s", default=None, type=float, metavar="S",
        help="SIGKILL one replica this long after load start",
    )
    parser.add_argument(
        "--fleet-kill-index", default=1, type=int, metavar="K",
        help="which replica slot (1..N) the kill hits",
    )
    parser.add_argument("--requests", default=50, type=int)
    parser.add_argument(
        "--rate", default=25.0, type=float,
        help="mean Poisson arrival rate, requests/second",
    )
    parser.add_argument("--prompt-len-min", default=2, type=int)
    parser.add_argument("--prompt-len-max", default=24, type=int)
    parser.add_argument("--new-tokens-min", default=4, type=int)
    parser.add_argument("--new-tokens-max", default=24, type=int)
    parser.add_argument(
        "--temperature", default=0.8, type=float,
        help="sampling temperature for the sampled share of the mix",
    )
    parser.add_argument(
        "--sampled-fraction", default=0.5, type=float,
        help="share of requests sampled at --temperature (the rest are "
        "greedy)",
    )
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--stream", action="store_true",
                        help="request streamed tokens")
    parser.add_argument("--timeout", default=120.0, type=float, metavar="S")
    parser.add_argument(
        "--connect-timeout", default=5.0, type=float, metavar="S",
        help="dial bound per request connection (separate from "
        "--timeout so a vanished target fails fast)",
    )
    parser.add_argument(
        "--low-priority-fraction", default=0.0, type=float,
        help="share of requests tagged priority=low (router QoS; a plain "
        "server ignores the tag)",
    )
    parser.add_argument(
        "--deadline-ms", default=None, type=float,
        help="per-request deadline_ms field (router QoS; a plain server "
        "ignores it)",
    )
    parser.add_argument("--slo-p95-ms", default=2000.0, type=float)
    parser.add_argument("--slo-ttft-p95-ms", default=None, type=float)
    parser.add_argument(
        "--trace-sample", default=0.0, type=float, metavar="RATE",
        help="head-sample this fraction of requests into traces "
        "(deterministic, does not shift the seeded plan)",
    )
    parser.add_argument(
        "--report", default=None, type=Path, metavar="PATH",
        help="also write the full JSON report here",
    )
    parser.add_argument("--json", action="store_true",
                        help="print the JSON report instead of the table")
    return parser


def loadgen_main(argv=None) -> int:
    from pytorch_distributed_rnn_tpu_torch.serving.loadgen import (
        LoadConfig,
        format_report,
        run_load,
    )

    args = build_loadgen_parser().parse_args(argv)
    logging.basicConfig(level="INFO")
    cfg = LoadConfig(
        requests=args.requests, rate=args.rate,
        prompt_len_min=args.prompt_len_min,
        prompt_len_max=args.prompt_len_max,
        new_tokens_min=args.new_tokens_min,
        new_tokens_max=args.new_tokens_max,
        temperature=args.temperature,
        sampled_fraction=args.sampled_fraction,
        seed=args.seed, stream=args.stream, timeout_s=args.timeout,
        connect_timeout_s=args.connect_timeout,
        low_priority_fraction=args.low_priority_fraction,
        deadline_ms=args.deadline_ms,
        slo_p95_ms=args.slo_p95_ms, slo_ttft_p95_ms=args.slo_ttft_p95_ms,
        trace_sample=args.trace_sample,
    )

    if args.spawn_fleet is not None:
        return _fleet_drill(args, cfg)

    if args.spawn_server is not None:
        from pytorch_distributed_rnn_tpu_torch.serving.drill import ServerSpawnError, run_drill

        try:
            report, server_exit = run_drill(shlex.split(args.spawn_server), cfg)
        except ServerSpawnError as exc:
            print(f"loadgen: {exc}", file=sys.stderr)
            return 2
    else:
        if args.port_file is not None:
            host, port = args.port_file.read_text().split()
        else:
            host, _, port = args.connect.rpartition(":")
            if not host:
                print("loadgen: --connect needs HOST:PORT", file=sys.stderr)
                return 2
        cfg = LoadConfig(**{**cfg.__dict__, "host": host, "port": int(port)})
        report = run_load(cfg)
        server_exit = None

    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1) + "\n")
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(format_report(report))
        if server_exit is not None:
            print(f"server exit code: {server_exit}")

    ok = (
        report["errors"] == 0
        and report["slo"].get("p95_ok", False)
        and report["slo"].get("ttft_p95_ok", True)
        and (server_exit in (None, 0))
    )
    return 0 if ok else 1


def _fleet_drill(args, cfg) -> int:
    """``loadgen --spawn-fleet N``: the fleet drill's report lines and
    verdict, as JAX's ``pdrnn-loadgen`` prints and judges them."""
    from pytorch_distributed_rnn_tpu_torch.serving.fleet.drill import (
        FleetSpawnError,
        run_fleet_drill,
    )
    from pytorch_distributed_rnn_tpu_torch.serving.loadgen import format_report

    if args.replica_args is None:
        print("loadgen: --spawn-fleet needs --replica-args", file=sys.stderr)
        return 2
    try:
        report = run_fleet_drill(
            shlex.split(args.replica_args), cfg, n=args.spawn_fleet,
            kill_after_s=args.fleet_kill_after_s, kill_index=args.fleet_kill_index,
            router_args=shlex.split(args.router_args),
        )
    except FleetSpawnError as exc:
        print(f"loadgen: {exc}", file=sys.stderr)
        return 2
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1) + "\n")
    fleet = report["fleet"]
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(format_report(report))
        print(
            f"fleet: {fleet['replicas']} replicas, "
            f"{fleet['respawns']} respawn(s), router rerouted "
            f"{fleet['router']['rerouted']} "
            f"({fleet['router']['retries']} retries, "
            f"{fleet['router']['hedges']} hedges), accounting "
            f"{'OK' if fleet['accounting_ok'] else 'BROKEN'}, "
            f"window {'closed' if fleet['window_closed'] else 'OPEN'}"
        )
        if "live" in fleet:
            live = fleet["live"]
            rec = live["recommended_replicas"]
            print(
                f"fleet live: slo_burn "
                f"{'fired' if live['burn_fired'] else 'quiet'}"
                f"{'+cleared' if live['burn_cleared'] else ''}, "
                f"recommended_replicas {rec['min']}->{rec['peak']} "
                f"({rec['samples']} samples), series scrape "
                f"{'ok' if live['series_scrape_ok'] else 'MISSING'}"
            )
    # the drill's gate: degradation bounded + nothing lost or duplicated
    # + the kill actually respawned + clean teardown (a killed stream may
    # legitimately error, so errors == 0 is not part of this verdict -
    # accounting is)
    ok = (
        fleet["accounting_ok"] and fleet["window_closed"]
        and fleet["router_exit"] == 0
        and (args.fleet_kill_after_s is None or fleet["respawns"] >= 1)
    )
    return 0 if ok else 1
