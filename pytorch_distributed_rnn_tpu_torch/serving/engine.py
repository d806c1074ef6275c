"""Continuous-batching decode engine, the counterpart of the JAX package's
``serving/engine.py`` (without its recorder, chaos schedule and live
source, which come with the port's telemetry).

The engine owns a fixed batch of ``num_slots`` decode slots whose device
state is allocated once: the adapter's slot state (RNN carries or KV
caches), ``logits (S, V)`` float32, and ``pos``, ``temps``, ``sampled``
and the ``(tok, ok)`` output row, each ``(S,)``.  Nothing the programs
read is ever rebound: a join writes one slot in place, a recovery zeroes
the buffers in place.  Its device programs are the JAX engine's jitted
ones as CUDA graphs:

- ``prefill``: one request's bucket-padded prompt -> its sequence state
  and last-step logits; one graph a prompt bucket;
- ``step``: every slot one token - the sampled or greedy token from the
  current logits (``decode_step_program`` in JAX), the adapter's decode
  step, the ``ok`` flags; one graph;
- ``join``: the prefilled sequence written into its slot, eager (a few
  copies), counted once when it first runs.

On ``cuda`` the first use of a program runs its body eagerly on a side
stream (the capture's warm-up and a real call) and then captures it
(``utils/graphs.py:CountedGraph``); later uses replay.  :meth:`warmup`
makes those first uses for every bucket before serving.  On ``cpu`` the
same bodies run eagerly.  ``retrace_snapshot``/``retraces_since`` keep
the JAX names and count captures (``cpu``: first runs of each program
and shape): after warm-up ``{"prefill": len(buckets), "step": 1, "join":
1}``, and no request mix adds one.

Sampling follows ``CharRNN.generate`` at batch 1: a slot at temperature 0
takes the argmax (inside the step graph); a slot at temperature T > 0
draws ``torch.multinomial(softmax(logits[s:s+1] / T), 1, generator=g_s)``
before the replay, from its own generator seeded with the request's seed
at join.  So a request served in the batch gets the tokens of its
single-request ``generate`` (the logits of a batched product and a
single-row one may differ in the last bits).  Only the engine thread
touches the device; ``submit`` and ``stats`` are host-only.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

import numpy as np
import torch

from pytorch_distributed_rnn_tpu_torch.obs.live import (
    RATE_HORIZON_S,
    RollingWindow,
    request_latency_histogram,
)
from pytorch_distributed_rnn_tpu_torch.obs.summary import percentile
from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ContinuousBatcher, ServeRequest
from pytorch_distributed_rnn_tpu_torch.utils.graphs import CountedGraph

log = logging.getLogger(__name__)

_IDLE_WAIT_S = 0.05

# percentile windows: a long-lived server must not grow host memory with
# its request history (totals stay exact)
_REQUEST_WINDOW = 4096
_DEPTH_WINDOW = 16384


def _flat(state) -> list:
    """A slot state's tensors in a fixed order (dict keys sorted, lists and
    tuples in order)."""
    if isinstance(state, torch.Tensor):
        return [state]
    items = [state[key] for key in sorted(state)] if isinstance(state, dict) else state
    return [t for item in items for t in _flat(item)]


class ServingEngine:
    """Continuous-batching executor for one model family; the device is
    the model's."""

    def __init__(self, adapter, *, num_slots: int = 4, bucket_spec: BucketSpec | None = None,
                 max_new_tokens: int = 64, max_queue: int = 64):
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.adapter = adapter
        self.buckets = bucket_spec or BucketSpec()
        self.max_new_tokens = int(max_new_tokens)
        if adapter.max_context is not None:
            budget = self.buckets.max_prompt_len + self.max_new_tokens
            if budget > adapter.max_context:
                raise ValueError(
                    f"largest prompt bucket ({self.buckets.max_prompt_len})"
                    f" + max_new_tokens ({self.max_new_tokens}) exceeds the"
                    f" {adapter.family} family's context bound "
                    f"{adapter.max_context}"
                )
        self.batcher = ContinuousBatcher(num_slots, max_queue)
        self._work = threading.Condition(threading.Lock())
        self._closed = False
        self.device = next(adapter.model.parameters()).device

        # captures (cpu: first runs) a program; retraces_since() reads them
        self._trace_counts = {"prefill": 0, "step": 0, "join": 0}
        self.graphs: dict = {}  # ("prefill", bucket) | ("step",) -> CountedGraph
        self._graph_out: dict = {}
        self._ran: set = set()
        self._capture_stream = None
        self._alloc_buffers()

        self._steps = 0
        self._tokens_out = 0
        self._requests_done = 0
        self._requests_failed = 0
        self._started_tm = time.perf_counter()
        # guards the stat deques and counters below: the engine thread
        # appends while connection threads read in stats()
        self._stats_lock = threading.Lock()
        self._latencies: deque[float] = deque(maxlen=_REQUEST_WINDOW)
        self._ttfts: deque[float] = deque(maxlen=_REQUEST_WINDOW)
        self._queue_waits: deque[float] = deque(maxlen=_REQUEST_WINDOW)
        self._queue_depths: deque[int] = deque(maxlen=_DEPTH_WINDOW)
        self._completions = RollingWindow(RATE_HORIZON_S)
        self._sheds = RollingWindow(RATE_HORIZON_S)
        self._latency_hist = request_latency_histogram()

    # -- device state --------------------------------------------------------

    def _alloc_buffers(self):
        slots, device = self.batcher.num_slots, self.device
        self.state = self.adapter.state_template(slots)
        self.logits = torch.zeros((slots, self.adapter.vocab_size), device=device)
        self.pos = torch.zeros((slots,), dtype=torch.long, device=device)
        self.temps = torch.zeros((slots,), device=device)
        self.sampled = torch.zeros((slots,), dtype=torch.long, device=device)
        self.out = torch.zeros((2, slots), dtype=torch.long, device=device)  # (tok, ok)
        self._prompts = {b: torch.zeros((1, b), dtype=torch.long, device=device)
                         for b in self.buckets.prompt_buckets}
        self._length = torch.zeros((1,), dtype=torch.long, device=device)
        self._generators = [torch.Generator(device=device) for _ in range(slots)]

    def _zero_buffers(self):
        for buf in (*_flat(self.state), self.logits, self.pos, self.temps, self.sampled,
                    self.out):
            buf.zero_()

    # -- programs ------------------------------------------------------------

    def _program(self, key: tuple, body):
        """Run program ``key``: replay its graph, or on first use run
        ``body`` eagerly on the capture stream and capture it; on the CPU
        run ``body``.  Returns the outputs of this run."""
        if self.device.type != "cuda":
            if key not in self._ran:
                self._ran.add(key)
                self._trace_counts[key[0]] += 1
            return body()
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            return self._graph_out[key]
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            out = body()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = CountedGraph()
        self._graph_out[key] = graph.capture(body, stream)
        self.graphs[key] = graph
        self._trace_counts[key[0]] += 1
        return out

    def _prefill(self, prompt: list) -> tuple:
        """One prompt through its bucket's prefill: ``(seq_state,
        logits (1, V))``."""
        padded = torch.from_numpy(self.buckets.pad(prompt).astype(np.int64))
        buf = self._prompts[padded.shape[1]]
        buf.copy_(padded)
        self._length.fill_(len(prompt))
        return self._program(("prefill", buf.shape[1]),
                             lambda: self.adapter.prefill(buf, self._length))

    def _join(self, slot: int, seq_state, seq_logits, length: int, temperature: float,
              seed: int):
        """Write a prefilled sequence into ``slot`` in place."""
        if ("join",) not in self._ran:
            self._ran.add(("join",))
            self._trace_counts["join"] += 1
        for buf, one in zip(_flat(self.state), _flat(seq_state)):
            buf[slot].copy_(one[0])
        self.logits[slot].copy_(seq_logits[0])
        self.pos[slot] = length
        self.temps[slot] = temperature
        self._generators[slot].manual_seed(seed)

    def _step_body(self):
        """Every slot one token: the token from the current logits (the
        argmax, or at temperature > 0 the host's draw in ``sampled``), the
        adapter's step, the ``ok`` flags (current and new logits finite);
        results written into the static buffers."""
        tok = torch.where(self.temps > 0, self.sampled, self.logits.argmax(dim=-1))
        new_state, new_logits = self.adapter.step(self.state, tok, self.pos)
        ok = torch.isfinite(self.logits).all(dim=-1) & torch.isfinite(new_logits).all(dim=-1)
        for buf, new in zip(_flat(self.state), _flat(new_state)):
            if new is not buf:
                buf.copy_(new)
        self.logits.copy_(new_logits)
        self.pos.add_(1)
        self.out[0].copy_(tok)
        self.out[1].copy_(ok)

    def _draw(self, slot: int, temperature: float):
        """``generate``'s draw at batch 1 from slot ``slot``'s logits into
        ``sampled``.  Non-finite logits (which fail the request through
        the step's ``ok`` flag) are zeroed first so that multinomial sees a
        valid distribution; on finite logits that is the identity."""
        logits = torch.nan_to_num(self.logits[slot:slot + 1], nan=0.0, posinf=0.0, neginf=0.0)
        probs = torch.softmax(logits / temperature, dim=-1)
        draw = torch.multinomial(probs, 1, generator=self._generators[slot])
        self.sampled[slot:slot + 1].copy_(draw[:, 0])

    @torch.no_grad()
    def warmup(self):
        """Make the first use of every program the serve loop can need (one
        prefill a prompt bucket, the join, the step, a draw), so that
        serving captures nothing; then blank the slots."""
        for bucket in self.buckets.prompt_buckets:
            seq_state, logits = self._prefill([0] * bucket)
            self._join(0, seq_state, logits, bucket, 0.0, 0)
        self._program(("step",), self._step_body)
        self._draw(0, 1.0)  # the sampling kernels' first launch, too
        self.out.cpu()
        self._zero_buffers()

    # -- capture accounting --------------------------------------------------

    def retrace_snapshot(self) -> dict:
        return dict(self._trace_counts)

    def retraces_since(self, snapshot: dict) -> dict:
        """Programs captured (cpu: first run) since ``snapshot`` (empty
        dict = none)."""
        return {
            name: count - snapshot.get(name, 0)
            for name, count in self._trace_counts.items()
            if count != snapshot.get(name, 0)
        }

    # -- request side (any thread) -------------------------------------------

    def submit(self, request: ServeRequest) -> bool:
        """Queue ``request``; False = shed (queue full) or rejected
        (malformed), with ``request.status``/``error`` set."""
        try:
            request.bucket = self.buckets.bucket_for(len(request.prompt))
        except ValueError as exc:
            request.status = "error"
            request.error = str(exc)
            return False
        if not 1 <= request.max_new_tokens <= self.max_new_tokens:
            request.status = "error"
            request.error = (
                f"max_new_tokens must be in [1, {self.max_new_tokens}], "
                f"got {request.max_new_tokens}"
            )
            return False
        if request.temperature < 0:
            request.status = "error"
            request.error = "temperature must be >= 0"
            return False
        # a generator takes a 64-bit seed; an unchecked client bigint would
        # raise on the engine thread at join time
        if not -(2 ** 63) <= request.seed < 2 ** 63:
            request.status = "error"
            request.error = "seed must fit in a signed 64-bit integer"
            return False
        if request.arrival_tm is None:
            request.arrival_tm = time.perf_counter()
        with self._work:
            admitted = self.batcher.admit(request)
            if admitted:
                self._work.notify_all()
        if not admitted and request.status == "shed":
            self._sheds.observe(1.0)
        return admitted

    # -- serve loop (one thread) ---------------------------------------------

    @torch.no_grad()
    def run_step(self, wait_s: float = _IDLE_WAIT_S) -> bool:
        """One scheduler iteration: join waiting requests into free slots,
        advance the batch one decode step, deliver tokens and retire
        finished sequences.  Blocks up to ``wait_s`` for work when idle;
        returns whether a decode step ran."""
        with self._work:
            if not self.batcher.has_work:
                self._work.wait(timeout=wait_s)
            joins = self.batcher.take_joins()
        for slot, request in joins:
            self._do_join(slot, request)
        with self._work:
            active = self.batcher.active()
        if not active:
            return False

        with self._stats_lock:
            self._steps += 1
        for slot, request in active:
            if request.temperature > 0:
                self._draw(slot, request.temperature)
        self._program(("step",), self._step_body)
        toks, ok = self.out.cpu().tolist()  # one copy: serving needs the values
        with self._stats_lock:
            self._queue_depths.append(self.batcher.queue_depth)

        now = time.perf_counter()
        for slot, request in active:
            if not ok[slot]:
                self._finish(slot, request, now,
                             error="non-finite logits during decode (poisoned checkpoint)")
                continue
            token = toks[slot]
            request.tokens.append(token)
            if request.first_token_tm is None:
                request.first_token_tm = now
            if request.on_token is not None:
                request.on_token(request, token)
            if request.finished:
                self._finish(slot, request, now)
        return True

    def _do_join(self, slot: int, request: ServeRequest):
        request.service_tm = time.perf_counter()
        seq_state, logits = self._prefill(request.prompt)
        self._join(slot, seq_state, logits, len(request.prompt), request.temperature,
                   request.seed)
        request.prefill_done_tm = time.perf_counter()

    def _finish(self, slot: int, request: ServeRequest, now: float, error: str | None = None):
        with self._work:
            self.batcher.release(slot)
        request.done_tm = now
        if error is not None:
            request.status = "error"
            request.error = error
        else:
            request.status = "done"
        self._completions.observe(len(request.tokens))
        with self._stats_lock:
            if error is not None:
                self._requests_failed += 1
            self._requests_done += 1
            self._tokens_out += len(request.tokens)
            if request.latency_s is not None:
                self._latencies.append(request.latency_s)
            if request.ttft_s is not None:
                self._ttfts.append(request.ttft_s)
            if request.queue_wait_s is not None:
                self._queue_waits.append(request.queue_wait_s)
        if request.latency_s is not None:
            self._latency_hist.observe(
                request.latency_s,
                trace_id=None if request.trace is None else request.trace.trace_id,
            )
        if request.on_done is not None:
            request.on_done(request)

    def serve_forever(self, stop_event: threading.Event):
        """The engine loop: one request's failure fails that request,
        never the serve thread (a dead engine behind a live TCP front end
        would hang every client).  The engine thread is the only one that
        touches the device."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not stop_event.is_set():
            try:
                self.run_step()
            except Exception:
                log.exception("serving: decode loop error; failing the in-flight batch and "
                              "continuing")
                self._recover()

    def _recover(self):
        """Fail every active request and zero the batch state in place (a
        loop exception may have left it partly updated); queued requests
        are untouched and decode next."""
        now = time.perf_counter()
        with self._work:
            active = self.batcher.active()
        for slot, request in active:
            self._finish(slot, request, now, error="internal decode error (see server log)")
        with torch.no_grad():
            self._zero_buffers()

    def drain(self):
        """Run until queue and slots are empty (tests, shutdown)."""
        while self.batcher.has_work:
            self.run_step(wait_s=0.0)

    # -- shutdown / stats ----------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self._latencies)
            ttft = sorted(self._ttfts)
            waits = sorted(self._queue_waits)
            depths = sorted(self._queue_depths)
            steps = self._steps
            requests_done = self._requests_done
            requests_failed = self._requests_failed
            tokens_out = self._tokens_out
        elapsed = time.perf_counter() - self._started_tm
        return {
            "steps": steps,
            "requests": requests_done,
            "requests_shed": self.batcher.shed,
            # every errored completion: non-finite logits, decode-loop
            # recovery, shutdown mid-decode
            "requests_failed": requests_failed,
            "queue_depth": self.batcher.queue_depth,
            "active": self.batcher.active_count,
            "tokens_out": tokens_out,
            "tokens_per_s": tokens_out / elapsed if elapsed > 0 else None,
            "req_per_s_60s": self._completions.count_rate(),
            "tokens_per_s_60s": self._completions.sum_rate(),
            "shed_per_s_60s": self._sheds.count_rate(),
            "latency_s_p50": percentile(lat, 0.50) if lat else None,
            "latency_s_p95": percentile(lat, 0.95) if lat else None,
            "ttft_s_p50": percentile(ttft, 0.50) if ttft else None,
            "ttft_s_p95": percentile(ttft, 0.95) if ttft else None,
            "queue_s_p50": percentile(waits, 0.50) if waits else None,
            "queue_s_p95": percentile(waits, 0.95) if waits else None,
            "queue_depth_p50": percentile(depths, 0.50) if depths else None,
            "queue_depth_p95": percentile(depths, 0.95) if depths else None,
            "queue_depth_max": depths[-1] if depths else None,
            "trace_counts": dict(self._trace_counts),
        }

    def close(self):
        """Abort queued and in-flight requests (their clients get an error
        event, not a dead socket); idempotent."""
        if self._closed:
            return
        self._closed = True
        with self._work:
            aborted = self.batcher.abort_pending("server shutting down")
            active = self.batcher.active()
        for request in aborted:
            if request.on_done is not None:
                request.on_done(request)
        now = time.perf_counter()
        for slot, request in active:
            self._finish(slot, request, now, error="server shut down mid-decode")
