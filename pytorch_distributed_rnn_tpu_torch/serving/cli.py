"""``serve`` and ``loadgen``: the port's serving entry points, the
counterparts of the JAX package's ``pdrnn-serve`` and ``pdrnn-loadgen``
(``serving/cli.py``), with JAX's flag surface plus ``--device {cuda,cpu}``
(default ``cuda``; without a card the server fails and says to pass
``--device cpu``).

Serve::

  python -m pytorch_distributed_rnn_tpu_torch.serving serve --checkpoint models/ \\
      --model char --hidden-units 512 --stacked-layer 2 --port 7071

The model flags mirror the training CLI's: a checkpoint stores only
tensors, so the server builds the architecture from the flags the
training run used and loads the model section of the newest valid
checkpoint (``--checkpoint`` is the file or the training
``--checkpoint-directory``).

Load::

  python -m pytorch_distributed_rnn_tpu_torch.serving loadgen --connect 127.0.0.1:7071 \\
      --requests 100 --rate 40 --slo-p95-ms 500 --report report.json
  python -m pytorch_distributed_rnn_tpu_torch.serving loadgen --spawn-server \\
      "--checkpoint models/ --model char --hidden-units 512" --requests 64

``--spawn-server`` runs the drill: a server subprocess up, load through
it, SIGTERM down, the report (with the server's exit code) out.  Exit
codes: 0 = SLO pass, 1 = SLO fail or errors, 2 = usage or spawn failure.

Flags whose machinery is not ported yet are parsed and rejected when set:
the telemetry and chaos flags (``--metrics``, ``--live``, ``--slo``,
``--faults``, ...) with ROADMAP A5, the fleet's (``--replica-id``,
``--drain-timeout``, loadgen's ``--spawn-fleet`` and its options, the
``router`` subcommand) with the serving fleet, ``--model moe`` with A9.
"""

from __future__ import annotations

import argparse
import json
import logging
import shlex
import signal
import sys
import threading
from pathlib import Path

log = logging.getLogger(__name__)

NOT_PORTED_TELEMETRY = "not ported yet (ROADMAP.md A5: the telemetry, chaos and live plane)"
NOT_PORTED_FLEET = "not ported yet (ROADMAP.md A4: the serving fleet and its router)"
MOE_NOT_PORTED = ("--model moe is not ported yet - the port serves --model char and "
                  "attention; the MoE LM and its adapter come with ROADMAP.md A9")


def _reject(chosen: dict, reason: str):
    flags = [flag for flag, on in chosen.items() if on]
    if flags:
        raise SystemExit(f"{', '.join(flags)}: {reason}")


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
    parser.add_argument("--faults", default=None, metavar="SPEC", help=NOT_PORTED_TELEMETRY)
    parser.add_argument("--replica-id", default=None, type=int, metavar="K",
                        help=NOT_PORTED_FLEET)
    parser.add_argument("--drain-timeout", default=30.0, type=float, metavar="S",
                        help=NOT_PORTED_FLEET)
    parser.add_argument("--metrics", default=None, type=Path, metavar="PATH",
                        help=NOT_PORTED_TELEMETRY)
    parser.add_argument("--metrics-sample-every", default=None, type=int,
                        help=NOT_PORTED_TELEMETRY)
    parser.add_argument("--live", default=None, metavar="[HOST:]PORT", help=NOT_PORTED_TELEMETRY)
    parser.add_argument("--live-port-file", default=None, type=Path, metavar="PATH",
                        help=NOT_PORTED_TELEMETRY)
    parser.add_argument("--slo", action="append", default=None, metavar="SPEC",
                        help=NOT_PORTED_TELEMETRY)
    parser.add_argument("--slo-windows", default=None, metavar="FAST,SLOW",
                        help=NOT_PORTED_TELEMETRY)
    parser.add_argument("--log", default="INFO")
    return parser


def reject_unported_serve(args):
    _reject({
        "--metrics": args.metrics is not None,
        "--metrics-sample-every": args.metrics_sample_every is not None,
        "--live": args.live is not None,
        "--live-port-file": args.live_port_file is not None,
        "--slo": args.slo is not None,
        "--slo-windows": args.slo_windows is not None,
        "--faults": args.faults is not None,
    }, NOT_PORTED_TELEMETRY)
    _reject({
        "--replica-id": args.replica_id is not None,
        "--drain-timeout": args.drain_timeout != 30.0,
    }, NOT_PORTED_FLEET)
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

    from pytorch_distributed_rnn_tpu_torch.serving.adapters import adapter_for
    from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
    from pytorch_distributed_rnn_tpu_torch.serving.engine import ServingEngine
    from pytorch_distributed_rnn_tpu_torch.serving.server import ServingServer

    model, _ = load_served_model(args)
    engine = ServingEngine(
        adapter_for(model), num_slots=args.slots,
        bucket_spec=BucketSpec.parse(args.prompt_buckets),
        max_new_tokens=args.max_new_tokens, max_queue=args.max_queue,
    )
    if not args.no_warmup:
        engine.warmup()
    server = ServingServer(engine, host=args.host, port=args.port, model_name=args.model)
    if args.port_file is not None:
        args.port_file.parent.mkdir(parents=True, exist_ok=True)
        args.port_file.write_text(f"{server.host} {server.port}\n")

    stop = threading.Event()

    def _on_signal(signum, _frame):
        log.info(f"serve: signal {signum}, shutting down")
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    server.start()
    print(f"serve: listening on {server.host}:{server.port}", flush=True)
    while not stop.is_set():
        stop.wait(timeout=0.5)
    server.shutdown()
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
        help="drill: spawn `serve ARGS` (shell-quoted string), load it, "
        "SIGTERM it, and report - including the server's exit code",
    )
    target.add_argument("--spawn-fleet", default=None, type=int, metavar="N",
                        help=NOT_PORTED_FLEET)
    parser.add_argument("--replica-args", default=None, metavar="ARGS", help=NOT_PORTED_FLEET)
    parser.add_argument("--router-args", default="", metavar="ARGS", help=NOT_PORTED_FLEET)
    parser.add_argument("--fleet-kill-after-s", default=None, type=float, metavar="S",
                        help=NOT_PORTED_FLEET)
    parser.add_argument("--fleet-kill-index", default=1, type=int, metavar="K",
                        help=NOT_PORTED_FLEET)
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
    _reject({
        "--spawn-fleet": args.spawn_fleet is not None,
        "--replica-args": args.replica_args is not None,
        "--router-args": args.router_args != "",
        "--fleet-kill-after-s": args.fleet_kill_after_s is not None,
        "--fleet-kill-index": args.fleet_kill_index != 1,
    }, NOT_PORTED_FLEET)
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
