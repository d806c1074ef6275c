"""The TCP serving front end: connections in, engine slots out (the
counterpart of the JAX package's ``serving/server.py``).

Thread layout: one accept loop, one engine loop
(``ServingEngine.serve_forever``, the only thread that touches the
device), and one reader thread per client connection.  Connection
threads only PARSE and ENQUEUE, so a slow or hostile client can never
stall decode.  Responses are written from the engine thread via
per-connection locked callbacks; a dead client's writes are dropped (the
request still completes and is accounted - its slot must free either
way).

Graceful shutdown (``shutdown()``, wired to SIGTERM/SIGINT by the CLI):
stop accepting, fail queued requests, finish nothing mid-step, emit the
``run_summary`` telemetry event and close the recorder - so a drill's
``kill -TERM`` still yields a summarizable metrics sidecar.  Fleet
replicas drain instead (``shutdown(drain=True)``): stop accepting and
reject new generates, but let the engine finish everything already
queued or decoding before the loop stops - the router reroutes fresh
traffic while this replica completes what it owns.

Fleet membership (``serving/fleet/``): with a ``pusher`` (the live
plane's :class:`~pytorch_distributed_rnn_tpu_torch.obs.live.EventPusher`
``push``) the server announces ``replica_register`` on start and
``replica_drain`` on teardown through the aggregator's ``/events``, so
the router's pool view and ``obs watch`` agree on who is in the fleet.
``flap_s`` (the ``net:flap:<s>`` chaos action via ``PDRNN_FAULT_FLAP_S``)
drops every open client connection each period - the flaky-replica mode,
distinct from kill: the process and its engine survive, its connections
do not.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import socket
import threading
import time

from pytorch_distributed_rnn_tpu_torch.obs.tracectx import TraceContext
from pytorch_distributed_rnn_tpu_torch.resilience.faults import FAULT_FLAP_ENV
from pytorch_distributed_rnn_tpu_torch.serving.protocol import (
    encode_line,
    text_to_tokens,
    tokens_to_text,
)
from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ServeRequest

log = logging.getLogger(__name__)


class ServingServer:
    """JSONL-over-TCP front end for one :class:`ServingEngine`."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 model_name: str = "?", recorder=None, pusher=None,
                 replica_id: int | None = None, flap_s: float | None = None):
        self.engine = engine
        self.model_name = model_name
        self.recorder = recorder
        self.pusher = pusher
        self.replica_id = replica_id
        if flap_s is None:
            flap_s = float(os.environ.get(FAULT_FLAP_ENV, 0) or 0)
        self.flap_s = float(flap_s)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self._listener.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
            self._listener.listen(128)
            self.host, self.port = self._listener.getsockname()[:2]
        except Exception:
            self._listener.close()
            raise
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._conns_lock = threading.Lock()  # guards: _conns
        self._conns: set[socket.socket] = set()
        self._threads: list[threading.Thread] = []
        self._ids = itertools.count()
        self._started = False

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Spawn the engine and accept threads; returns immediately."""
        if self._started:
            return
        self._started = True
        engine_thread = threading.Thread(
            target=self.engine.serve_forever, args=(self._stop,),
            name="pdrnn-serve-engine", daemon=True,
        )
        accept_thread = threading.Thread(
            target=self._accept_loop, name="pdrnn-serve-accept", daemon=True,
        )
        self._threads = [engine_thread, accept_thread]
        if self.flap_s > 0:
            log.warning(f"serve: net:flap:{self.flap_s:g} active - dropping every open "
                        f"connection each {self.flap_s:g}s")
            self._threads.append(threading.Thread(
                target=self._flap_loop, name="pdrnn-serve-flap", daemon=True,
            ))
        for thread in self._threads:
            thread.start()
        if self.pusher is not None:
            self.pusher(
                "replica_register", severity="info",
                replica=self.replica_id, host=self.host, port=self.port,
                model=self.model_name,
            )
        log.info(f"serve: listening on {self.host}:{self.port}")

    def shutdown(self, drain: bool = False,
                 drain_timeout_s: float = 30.0):
        """Stop accepting, stop the engine loop, flush telemetry;
        idempotent and safe from signal handlers' main thread.

        With ``drain=True`` (the fleet replica's SIGTERM path): reject
        new generates, keep the engine stepping until everything queued
        or in-flight completes (bounded by ``drain_timeout_s``), then
        stop - and deregister through the ``replica_drain`` heartbeat."""
        if self._stop.is_set():
            return
        self._draining.set()
        # shutdown() wakes the accept loop's blocked accept(); close()
        # alone leaves it waiting on Linux
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:  # not connected/listening: nothing to wake
            pass
        self._listener.close()
        if drain:
            deadline = time.monotonic() + float(drain_timeout_s)
            while self.engine.batcher.has_work \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
        drained_clean = not self.engine.batcher.has_work
        self._stop.set()
        for thread in self._threads:
            thread.join(timeout=10.0)
        self.engine.close()
        # force-drop any client connection whose reader has not exited
        # yet: after this, nothing of ours may still hold a socket
        with self._conns_lock:
            victims = list(self._conns)
            self._conns.clear()
        for sock in victims:
            try:
                sock.close()
            except OSError:  # pragma: no cover - already closed
                pass
        if self.pusher is not None:
            self.pusher(
                "replica_drain", severity="info",
                replica=self.replica_id, host=self.host, port=self.port,
                drained_clean=drained_clean,
            )
        if self.recorder is not None:
            self.recorder.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- accept / connection side --------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                # deadline-free by contract: shutdown() closing the
                # listener unblocks this accept with OSError
                conn, _addr = self._listener.accept()
            except OSError:  # listener closed = shutdown
                return
            handler = threading.Thread(
                target=self._handle, args=(conn,),
                name="pdrnn-serve-conn", daemon=True,
            )
            handler.start()

    def _flap_loop(self):
        """The ``net:flap:<s>`` chaos action: every period, drop every open
        client connection (mid-request or idle) while the listener keeps
        accepting - peers see ECONNRESET/EOF, what a flaky replica or link
        looks like from the router's side."""
        while not self._stop.wait(timeout=self.flap_s):
            with self._conns_lock:
                victims = list(self._conns)
            for sock in victims:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            if victims:
                log.warning(f"serve: net:flap dropped {len(victims)} connection(s)")

    def _handle(self, conn: socket.socket):
        wlock = threading.Lock()
        alive = {"ok": True}
        with self._conns_lock:
            self._conns.add(conn)

        def send(obj: dict):
            # engine-thread callbacks and the reader both write here; a
            # vanished client must not take the engine down with it
            with wlock:
                if not alive["ok"]:
                    return
                try:
                    # client-paced by contract: a timeout here would
                    # drop slow-but-alive clients; dead peers surface
                    # as OSError and just mark the conn down
                    conn.sendall(encode_line(obj))
                except OSError:
                    alive["ok"] = False

        rfile = conn.makefile("r", encoding="utf-8")
        try:
            for line in rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                    if not isinstance(msg, dict):
                        raise ValueError("messages are JSON objects")
                except ValueError as exc:
                    send({"event": "error", "error": f"bad request: {exc}"})
                    continue
                self._dispatch(msg, send)
                if self._stop.is_set():
                    break
        except OSError:
            pass
        finally:
            alive["ok"] = False
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                rfile.close()
            finally:
                conn.close()

    # -- ops -----------------------------------------------------------------

    def _dispatch(self, msg: dict, send):
        op = msg.get("op")
        if op == "ping":
            send({
                "event": "pong", "model": self.model_name,
                "vocab_size": self.engine.adapter.vocab_size,
                "max_prompt_len": self.engine.buckets.max_prompt_len,
                "prompt_buckets": list(self.engine.buckets.prompt_buckets),
                "max_new_tokens": self.engine.max_new_tokens,
                "slots": self.engine.batcher.num_slots,
            })
        elif op == "stats":
            stats = self.engine.stats()
            stats.pop("trace_counts", None)
            send({"event": "stats", **stats})
        elif op == "generate":
            if self._draining.is_set():
                # a draining server finishes what it owns but accepts
                # nothing new - an EXPLICIT rejection, never a silent drop
                send({
                    "id": str(msg.get("id", "")), "event": "error",
                    "error": "replica draining - not accepting requests",
                    "draining": True,
                })
                return
            self._generate(msg, send)
        else:
            send({
                "id": msg.get("id"), "event": "error",
                "error": f"unknown op {op!r} (generate|ping|stats)",
            })

    def _generate(self, msg: dict, send):
        request_id = str(msg.get("id", next(self._ids)))
        used_text = "text" in msg
        try:
            if used_text:
                if self.engine.adapter.vocab_size < 256:
                    raise ValueError(
                        "text prompts need a byte vocab (>= 256 ids); "
                        "this model serves token-id prompts only"
                    )
                prompt = text_to_tokens(str(msg["text"]))
            else:
                prompt = [int(t) for t in msg.get("prompt", [])]
            if any(not 0 <= t < self.engine.adapter.vocab_size
                   for t in prompt):
                raise ValueError(
                    f"prompt ids must be in [0, "
                    f"{self.engine.adapter.vocab_size})"
                )
            max_new = int(msg.get("max_new_tokens", 16))
            temperature = float(msg.get("temperature", 0.0))
            seed = int(msg.get("seed", next(self._ids)))
            stream = bool(msg.get("stream", False))
        except (TypeError, ValueError) as exc:
            send({"id": request_id, "event": "error",
                  "error": f"bad generate request: {exc}"})
            return

        def on_token(request: ServeRequest, token: int):
            if request.stream:
                send({
                    "id": request_id, "event": "token",
                    "index": len(request.tokens) - 1, "token": token,
                })

        def on_done(request: ServeRequest):
            if request.status != "done":
                send({
                    "id": request_id, "event": "error",
                    "error": request.error or request.status,
                    "shed": request.status == "shed",
                })
                return
            payload = {
                "id": request_id, "event": "done", "status": "done",
                "tokens": request.tokens,
                "token_count": len(request.tokens),
                "latency_ms": _ms(request.latency_s),
                "ttft_ms": _ms(request.ttft_s),
                "queue_ms": _ms(request.queue_wait_s),
                "seed": seed,
            }
            if used_text:
                payload["text"] = tokens_to_text(request.tokens)
            send(payload)

        # distributed tracing: the sender's context rides the request (its
        # trace id marks the latency histogram's exemplars); an untraced
        # request constructs no TraceContext, and a malformed context
        # parses to None and never fails the request
        trace = None
        if "trace" in msg:
            trace = TraceContext.from_wire(msg.get("trace"))
        request = ServeRequest(
            prompt=prompt, max_new_tokens=max_new, temperature=temperature,
            seed=seed, id=request_id, stream=stream, trace=trace,
            on_token=on_token, on_done=on_done,
        )
        if not self.engine.submit(request):
            send({
                "id": request_id, "event": "error",
                "error": request.error or "queue full - request shed",
                "shed": request.status == "shed",
            })


def _ms(seconds: float | None) -> float | None:
    return None if seconds is None else round(seconds * 1e3, 3)
