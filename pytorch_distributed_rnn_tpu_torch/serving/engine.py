"""Continuous-batching decode engine, the counterpart of the JAX package's
``serving/engine.py``.

The engine owns a fixed batch of ``num_slots`` decode slots whose device
state is allocated once: the adapter's slot state (RNN carries or KV
caches), ``logits (S, V)`` float32, the sampling noise ``noise (S, V)``,
``pos``, ``temps`` and the ``(tok, ok)`` output row, each ``(S,)``, and
one sequence's prefill result.  Nothing the programs read is ever
rebound: a join writes one slot in place, a recovery zeroes the buffers
in place.  Its device programs are the JAX engine's jitted ones:

- ``prefill``: one request's bucket-padded prompt -> its sequence state
  and last-step logits, written into the sequence buffers; one program a
  prompt bucket;
- ``join``: the sequence buffers written into the request's slot, with
  its position and temperature; one program;
- ``step``: every slot one token - the sampled or greedy token from the
  current logits (``decode_step_program`` in JAX), the adapter's decode
  step, the ``ok`` flags; one program.

A program's inputs are all device buffers: a join's prompt, length, slot
and temperature go through one float64 staging row (on the card a
pinned host row copied up with one call).  On ``cuda`` the first use of a
program runs its body eagerly on a side stream (the capture's warm-up
and a real call) and then captures it (``utils/graphs.py:CountedGraph``);
later uses replay.  On ``cpu`` the first use traces the body
(``torch.jit.trace``, which runs it) and later uses call the trace.
Either way a program is one Python->torch call: an eager body gives the
interpreter lock up at each of its torch calls, and a thread that never
blocks then holds it for a switch interval (5 ms) each time, which
starves the engine.  :meth:`warmup` makes every first use before
serving.  ``retrace_snapshot``/``retraces_since`` keep the JAX names and
count captures (``cpu``: traces): after warm-up ``{"prefill":
len(buckets), "step": 1, "join": 1}``, and no request mix adds one.

Sampling follows ``CharRNN.generate`` at batch 1: a slot at temperature 0
takes the argmax; a slot at temperature T > 0 takes ``torch.multinomial(
softmax(logits[s:s+1] / T), 1, generator=g_s)``, from its own generator
seeded with the request's seed at join.  For one sample ``multinomial``
is ``argmax(probs / q)`` with ``q`` drawn by ``exponential_`` from the
generator, and the engine computes that form: on the card the draws run
inside the step graph, with every slot's generator registered with it
(``multinomial`` itself synchronises with the host and cannot be
captured); on the CPU one scripted call draws the sampled slots' rows of
``noise`` before the step.  So a request served in the batch gets the
tokens of its single-request ``generate`` (the logits of a batched
product and a single-row one may differ in the last bits).  Only the
engine thread touches the device; ``submit`` and ``stats`` are
host-only.  :class:`TorchCalls` counts the engine's Python->torch calls
by phase.

Telemetry rides the ``obs/`` recorder as in JAX: a ``step`` event a
decode step (``dispatch_s``, which the step's copy of ``(tok, ok)`` to
the host fences, ``fenced_s`` on sampled steps, the pre-step wait as
``data_wait_s``, queue depth, active slots), ``prefill`` spans, a
``request`` event a completion, a traced request's ``queue_wait``,
``decode`` and ``stream_emit`` spans, and a ``run_summary`` at
:meth:`close`.  The recorder is host-only, so telemetry adds no torch call
to a step.  :meth:`live_source` gives the live plane the ``serving``
block; it runs on the exporter's thread and reads host counters only.

Chaos (``resilience/faults.py``) plugs in as on a trainer: ``stall``
holds the decode loop, ``exc`` is absorbed and counted
(``chaos_absorbed``), ``nan`` writes NaN into the persistent ``logits``
buffer that the step program reads (so the poisoned slots fail their
requests through ``ok``), ``kill`` preempts the process.  A step where no
fault fires makes no extra torch call.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import threading
import time
import warnings
from collections import Counter, deque

import torch
from torch import nn
from torch.overrides import TorchFunctionMode

from pytorch_distributed_rnn_tpu_torch.obs.live import (
    RATE_HORIZON_S,
    RollingWindow,
    request_latency_histogram,
)
from pytorch_distributed_rnn_tpu_torch.obs.recorder import NULL_RECORDER
from pytorch_distributed_rnn_tpu_torch.obs.summary import percentile
from pytorch_distributed_rnn_tpu_torch.resilience.faults import ChaosError
from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ContinuousBatcher, ServeRequest
from pytorch_distributed_rnn_tpu_torch.utils.graphs import CountedGraph
from pytorch_distributed_rnn_tpu_torch.utils.profiling import _rss_mb

log = logging.getLogger(__name__)

_IDLE_WAIT_S = 0.05

# percentile windows: a long-lived server must not grow host memory with
# its request history (totals stay exact)
_REQUEST_WINDOW = 4096
_DEPTH_WINDOW = 16384

def _no_grad():
    """Autograd off, where it is on: entering and leaving ``no_grad`` are
    torch calls, which a loop already without autograd need not make."""
    return torch.no_grad() if torch.is_grad_enabled() else contextlib.nullcontext()


def _flat(state) -> list:
    """A slot state's tensors in a fixed order (dict keys sorted, lists and
    tuples in order)."""
    if isinstance(state, torch.Tensor):
        return [state]
    items = [state[key] for key in sorted(state)] if isinstance(state, dict) else state
    return [t for item in items for t in _flat(item)]


def _unflat(template, leaves):
    """``template``'s structure holding ``leaves`` (an iterator over
    :func:`_flat`'s order)."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    if isinstance(template, dict):
        return {key: _unflat(template[key], leaves) for key in sorted(template)}
    return type(template)(_unflat(item, leaves) for item in template)


class _Traced(nn.Module):
    """A program body with the model as a submodule, so that a trace reads
    the parameters as attributes rather than freezing them as constants."""

    def __init__(self, model, body):
        super().__init__()
        self.model = model
        self.body = body

    def forward(self, *args):
        return self.body(*args)


@functools.cache
def _scripted_draw():
    """The CPU's draws as one scripted call: row ``slots[i]`` of ``noise``
    drawn by ``exponential_`` from ``generators[i]``."""

    def draw(noise: torch.Tensor, slots: list[int], generators: list[torch.Generator]):
        for i in range(len(slots)):
            noise[slots[i]].exponential_(1.0, generator=generators[i])

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return torch.jit.script(draw)


class TorchCalls(TorchFunctionMode):
    """Counts the Python->torch calls an engine makes while the mode is on
    (on the engine's thread), by the engine's phase (``join``, ``draw``,
    ``step``, ``result``): every torch function and tensor method the
    mode sees, and every program run (a graph replay, a traced program,
    the CPU's scripted draw), which the engine reports because they run
    past the mode.  Each such call may give the interpreter lock up and
    take it back."""

    def __init__(self, engine):
        super().__init__()
        self.engine = engine
        self.counts = Counter()

    def __enter__(self):
        self.engine._calls = self
        return super().__enter__()

    def __exit__(self, *exc):
        self.engine._calls = None
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.counts[self.engine._phase] += 1
        return func(*args, **(kwargs or {}))

    def program(self) -> None:
        self.counts[self.engine._phase] += 1


class ServingEngine:
    """Continuous-batching executor for one model family; the device is
    the model's."""

    def __init__(self, adapter, *, num_slots: int = 4, bucket_spec: BucketSpec | None = None,
                 max_new_tokens: int = 64, max_queue: int = 64, recorder=NULL_RECORDER,
                 faults=None):
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
        self.recorder = recorder
        self.faults = faults
        if faults is not None and getattr(recorder, "enabled", False):
            faults.recorder = recorder
        self._work = threading.Condition(threading.Lock())
        self._closed = False
        self.device = next(adapter.model.parameters()).device

        # captures (cpu: traces) a program; retraces_since() reads them
        self._trace_counts = {"prefill": 0, "step": 0, "join": 0}
        self.graphs: dict = {}  # ("prefill", bucket) | ("join",) | ("step",) -> CountedGraph
        self._traced: dict = {}  # the same keys -> the CPU's traced programs
        self._capture_stream = None
        self._phase = "join"  # what the engine thread is doing, for TorchCalls
        self._calls = None  # the TorchCalls counting now, if any
        self._alloc_buffers()

        self._steps = 0
        self._tokens_out = 0
        self._requests_done = 0
        self._requests_failed = 0
        self._chaos_exceptions = 0
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
        vocab = self.adapter.vocab_size
        self.state = self.adapter.state_template(slots)
        self.logits = torch.zeros((slots, vocab), device=device)
        self.noise = torch.ones((slots, vocab), device=device)
        self.pos = torch.zeros((slots,), dtype=torch.long, device=device)
        self.temps = torch.zeros((slots,), device=device)
        self.out = torch.zeros((2, slots), dtype=torch.long, device=device)  # (tok, ok)
        self.seq_state = self.adapter.state_template(1)
        self.seq_logits = torch.zeros((1, vocab), device=device)
        # the staging row: prompt tokens (padded to the largest bucket),
        # then the join's length, slot and temperature
        self._meta = self.buckets.max_prompt_len
        width = self._meta + 3
        self._stage = torch.zeros((1, width), dtype=torch.float64, device=device)
        self._stage_host = (torch.zeros((1, width), dtype=torch.float64, pin_memory=True)
                            if device.type == "cuda" else self._stage)
        self._stage_np = self._stage_host.numpy()
        self._staged = None  # the (slot, length, temperature) on the device's row
        self._generators = [torch.Generator(device=device) for _ in range(slots)]
        self._args = {
            "prefill": (self._stage, *_flat(self.seq_state), self.seq_logits),
            "join": (self._stage, *_flat(self.state), *_flat(self.seq_state), self.logits,
                     self.seq_logits, self.pos, self.temps),
            "step": (*_flat(self.state), self.logits, self.noise, self.pos, self.temps,
                     self.out),
        }

    def _zero_buffers(self):
        for buf in (*_flat(self.state), *_flat(self.seq_state), self.logits, self.seq_logits,
                    self.pos, self.temps, self.out):
            buf.zero_()
        self.noise.fill_(1.0)

    # -- programs ------------------------------------------------------------

    def _program(self, key: tuple, body):
        """Run program ``key`` on its buffers (``_args[key[0]]``): replay
        its graph, or on first use run ``body`` eagerly on the capture
        stream and capture it; on the CPU call its trace, or on first use
        trace ``body`` (which runs it).  Returns the program's output
        buffer."""
        args = self._args[key[0]]
        if self._calls is not None:
            self._calls.program()
        if self.device.type != "cuda":
            traced = self._traced.get(key)
            if traced is not None:
                # the traced ops as they are: no profiling run and no
                # optimising pass on the first calls (this thread only)
                with torch.jit.optimized_execution(False):
                    return traced(*args)
            with warnings.catch_warnings():
                # a trace that read a tensor's value on the host would
                # replay that value: refuse it
                warnings.simplefilter("error", torch.jit.TracerWarning)
                warnings.simplefilter("ignore", DeprecationWarning)
                traced = torch.jit.trace(_Traced(self.adapter.model, body), args,
                                         check_trace=False)
            self._traced[key] = traced
            self._trace_counts[key[0]] += 1
            return args[-1]
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            return args[-1]
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            out = body(*args)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = CountedGraph(self._generators if key[0] == "step" else ())
        graph.capture(lambda: body(*args), stream)
        self.graphs[key] = graph
        self._trace_counts[key[0]] += 1
        return out

    def _stage_meta(self, slot: int, length: int, temperature: float) -> None:
        self._stage_np[0, self._meta:] = (length, slot, temperature)

    def _upload(self) -> None:
        """The staging row on the device (the card: one synchronous copy,
        after which the host row may be rewritten)."""
        if self._stage_host is not self._stage:
            self._stage.copy_(self._stage_host)

    def _prefill(self, prompt: list, slot: int = 0, temperature: float = 0.0) -> tuple:
        """One prompt through its bucket's prefill, staged with the join
        it is for: ``(seq_state, seq_logits (1, V))``, the sequence
        buffers."""
        padded = self.buckets.pad(prompt)
        bucket = padded.shape[1]
        self._stage_np[0, :bucket] = padded[0]
        self._stage_meta(slot, len(prompt), temperature)
        self._upload()
        self._staged = (slot, len(prompt), temperature)
        M = self._meta

        def body(stage, *bufs):
            seq_bufs, seq_logits = bufs[:-1], bufs[-1]
            seq_state, logits = self.adapter.prefill(stage[:, :bucket].long(),
                                                     stage[0, M:M + 1].long())
            for buf, new in zip(seq_bufs, _flat(seq_state)):
                buf.copy_(new)
            seq_logits.copy_(logits)
            return seq_logits

        self._program(("prefill", bucket), body)
        return self.seq_state, self.seq_logits

    def _join(self, slot: int, seq_state, seq_logits, length: int, temperature: float,
              seed: int):
        """Write the prefilled sequence (the sequence buffers
        ``seq_state``, ``seq_logits``) into ``slot`` in place, and seed the
        slot's generator."""
        if self._staged != (slot, length, temperature):
            self._stage_meta(slot, length, temperature)
            self._upload()
            self._staged = (slot, length, temperature)
        leaves = len(_flat(self.state))
        M = self._meta

        def body(stage, *bufs):
            state_bufs, seq_bufs = bufs[:leaves], bufs[leaves:2 * leaves]
            logits, seq_logits, pos, temps = bufs[2 * leaves:]
            at = stage[0, M + 1:M + 2].long()
            for buf, one in zip(state_bufs, seq_bufs):
                buf.index_copy_(0, at, one)
            logits.index_copy_(0, at, seq_logits)
            pos.index_copy_(0, at, stage[0, M:M + 1].long())
            temps.index_copy_(0, at, stage[0, M + 2:M + 3].float())
            return temps

        self._program(("join",), body)
        self._generators[slot].manual_seed(seed)

    def _step_body(self, *bufs):
        """Every slot one token: the draw (on the card: every slot's noise
        row from its generator), the token from the current logits (the
        argmax, or at temperature > 0 ``argmax(softmax(logits / T) /
        noise)``), the adapter's step, the ``ok`` flags (current and new
        logits finite); results written into the static buffers.
        Non-finite logits (which fail the request through ``ok``) are
        zeroed for the draw so that it sees a valid distribution; on
        finite logits that is the identity."""
        leaves = len(bufs) - 5
        logits, noise, pos, temps, out = bufs[leaves:]
        state = _unflat(self.state, iter(bufs[:leaves]))
        cuda = logits.is_cuda
        if cuda:
            for s, generator in enumerate(self._generators):
                noise[s:s + 1].exponential_(1.0, generator=generator)
        safe = torch.nan_to_num(logits, nan=0.0, posinf=0.0, neginf=0.0)
        temperature = torch.where(temps > 0, temps, 1.0)[:, None]
        # generate divides by a Python float: the card multiplies by its
        # float32 reciprocal there, the CPU divides
        scaled = safe * temperature.reciprocal() if cuda else safe / temperature
        drawn = (torch.softmax(scaled, dim=-1) / noise).argmax(dim=-1)
        tok = torch.where(temps > 0, drawn, logits.argmax(dim=-1))
        new_state, new_logits = self.adapter.step(state, tok, pos)
        ok = torch.isfinite(logits).all(dim=-1) & torch.isfinite(new_logits).all(dim=-1)
        for buf, new in zip(bufs[:leaves], _flat(new_state)):
            if new is not buf:
                buf.copy_(new)
        logits.copy_(new_logits)
        pos.add_(1)
        out[0].copy_(tok)
        out[1].copy_(ok)
        return out

    def _advance(self, sampled: list) -> list:
        """One decode step of every slot; ``sampled`` the slots at
        temperature > 0.  Returns ``[toks, ok]`` on the host."""
        if sampled and self.device.type != "cuda":
            self._phase = "draw"
            if self._calls is not None:
                self._calls.program()
            with torch.jit.optimized_execution(False):
                _scripted_draw()(self.noise, sampled, [self._generators[s] for s in sampled])
        self._phase = "step"
        self._program(("step",), self._step_body)
        self._phase = "result"
        return self.out.tolist()  # one copy: serving needs the values

    @torch.no_grad()
    def warmup(self):
        """Make the first use of every program the serve loop can need (one
        prefill a prompt bucket, the join, the step, the CPU's draw), so
        that serving captures nothing, and a second (on the CPU the first
        call of a trace makes its execution plan); then blank the
        slots."""
        for _ in range(2):
            for bucket in self.buckets.prompt_buckets:
                seq_state, logits = self._prefill([0] * bucket)
                self._join(0, seq_state, logits, bucket, 0.0, 0)
            self._advance([0])
        self._zero_buffers()
        self._phase = "join"

    # -- capture accounting --------------------------------------------------

    def retrace_snapshot(self) -> dict:
        return dict(self._trace_counts)

    def retraces_since(self, snapshot: dict) -> dict:
        """Programs captured (cpu: traced) since ``snapshot`` (empty
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

    def run_step(self, wait_s: float = _IDLE_WAIT_S) -> bool:
        """One scheduler iteration: join waiting requests into free slots,
        advance the batch one decode step, deliver tokens and retire
        finished sequences.  Blocks up to ``wait_s`` for work when idle;
        returns whether a decode step ran.  Runs without autograd
        (``serve_forever`` and ``drain`` turn it off once for their whole
        loop rather than twice a step)."""
        with _no_grad():
            return self._run_step(wait_s)

    def _run_step(self, wait_s: float) -> bool:
        wait_t0 = time.perf_counter()
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
            step_index = self._steps
            self._steps += 1
        if self.faults is not None:
            self._apply_faults(step_index)
        t0 = time.perf_counter()
        toks, ok = self._advance([slot for slot, request in active if request.temperature > 0])
        step_s = time.perf_counter() - t0  # fenced: _advance copied (tok, ok) to the host
        self._phase = "join"
        depth = self.batcher.queue_depth
        with self._stats_lock:
            self._queue_depths.append(depth)
        rec = self.recorder
        if rec.enabled:
            rec.record(
                "step", step=step_index, dispatch_s=step_s,
                fenced_s=step_s if rec.is_sample_step(step_index) else None,
                # pre-step wait: idle + joins (prefill is serving's input
                # pipeline, so it lands in the data phase)
                data_wait_s=max(0.0, t0 - wait_t0), tm=t0,
                queue_depth=depth, active=len(active),
            )
            rec.note_progress(step_index)

        now = time.perf_counter()
        for slot, request in active:
            if not ok[slot]:
                self._finish(slot, request, now,
                             error="non-finite logits during decode (chaos fault or poisoned "
                                   "checkpoint)")
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
        t0 = time.perf_counter()
        request.service_tm = t0
        seq_state, logits = self._prefill(request.prompt, slot, request.temperature)
        self._join(slot, seq_state, logits, len(request.prompt), request.temperature,
                   request.seed)
        request.prefill_done_tm = time.perf_counter()
        if self.recorder.enabled:
            # a traced request threads its context into the span so the
            # cross-process assembler (obs/trace.py) can re-join it
            extra = {} if request.trace is None else request.trace.child().span_fields()
            self.recorder.emit_span(
                "prefill", t0, request.prefill_done_tm - t0, cat="serving",
                request=request.id or request.seq, bucket=request.bucket,
                prompt_len=len(request.prompt), slot=slot, **extra,
            )

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
        if self.recorder.enabled:
            self.recorder.record(
                "request", request=request.id or request.seq,
                status=request.status, tokens=len(request.tokens),
                latency_s=request.latency_s, ttft_s=request.ttft_s,
                queue_s=request.queue_wait_s, bucket=request.bucket,
                error=request.error,
            )
            if request.trace is not None:
                self._emit_trace_spans(request, now)
        if request.on_done is not None:
            request.on_done(request)

    def _emit_trace_spans(self, request: ServeRequest, now: float):
        """The replica's lifecycle spans of one traced request, emitted at
        completion as children of the router's dispatch-attempt span
        (``request.trace``): queue_wait (admission -> slot), decode
        (prefill end -> done; prefill itself is the cat="serving" span
        ``_do_join`` stamps with its own child context), and stream_emit
        (first token -> done) under decode for streamed requests.  Only
        reachable when the request arrived traced and the engine records,
        so the untraced path allocates nothing."""
        ctx = request.trace
        ident = request.id or request.seq
        if request.arrival_tm is not None and request.service_tm is not None:
            self.recorder.emit_span(
                "queue_wait", request.arrival_tm,
                request.service_tm - request.arrival_tm, cat="trace",
                request=ident, **ctx.child().span_fields(),
            )
        decode_start = (request.prefill_done_tm if request.prefill_done_tm is not None
                        else request.service_tm)
        if decode_start is not None:
            decode_ctx = ctx.child()
            self.recorder.emit_span(
                "decode", decode_start, max(0.0, now - decode_start),
                cat="trace", request=ident, slot=request.slot,
                tokens=len(request.tokens), status=request.status,
                **decode_ctx.span_fields(),
            )
            if request.stream and request.first_token_tm is not None:
                self.recorder.emit_span(
                    "stream_emit", request.first_token_tm,
                    max(0.0, now - request.first_token_tm), cat="trace",
                    request=ident, tokens=len(request.tokens),
                    **decode_ctx.child().span_fields(),
                )

    def _apply_faults(self, step_index: int):
        """Trainer-style chaos hooks on the decode loop: stall holds the
        loop, exc is absorbed (the server must survive), nan poisons the
        in-flight logits (caught per slot by this step's ``ok``), kill
        preempts.  The poison is written into ``self.logits`` in place:
        the step program reads that buffer, never a new tensor.  Torch
        calls happen only where a fault fires (phase ``faults``)."""
        self._phase = "faults"
        try:
            self.faults.on_producer_item(step_index)
        except ChaosError as exc:
            with self._stats_lock:
                self._chaos_exceptions += 1
            log.warning(f"serving: absorbed injected failure: {exc}")
        if self.faults.has_step_events:
            logits, _ = self.faults.corrupt_batch(step_index, (self.logits, None))
            if logits is not self.logits:
                self.logits.copy_(logits)
        self.faults.maybe_kill(step=step_index)

    def serve_forever(self, stop_event: threading.Event):
        """The engine loop: one request's failure fails that request,
        never the serve thread (a dead engine behind a live TCP front end
        would hang every client).  The engine thread is the only one that
        touches the device."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with _no_grad():
            while not stop_event.is_set():
                try:
                    self.run_step()
                except Exception:
                    log.exception("serving: decode loop error; failing the in-flight batch "
                                  "and continuing")
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
        with _no_grad():
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
            chaos_absorbed = self._chaos_exceptions
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
            "chaos_absorbed": chaos_absorbed,
            "trace_counts": dict(self._trace_counts),
        }

    def live_source(self) -> dict:
        """Digest contribution for the live exporter
        (``LiveExporter.add_source``): the serving gauge block behind the
        aggregator's ``pdrnn_serving_*`` series and the watchdog's SLO
        detector - the numbers the ``stats`` op serves, under one
        ``serving`` key.  Runs on the exporter's thread: host counters
        only, no device access."""
        stats = self.stats()
        block = {
            k: stats.get(k) for k in (
                "requests", "requests_shed", "requests_failed",
                "tokens_out", "queue_depth", "active",
                "req_per_s_60s", "tokens_per_s_60s", "shed_per_s_60s",
                "latency_s_p50", "latency_s_p95",
                "ttft_s_p50", "ttft_s_p95",
            )
        }
        # the slot count rides the digest so the store can derive slot
        # utilization and size the fleet (recommended_replicas)
        block["num_slots"] = self.batcher.num_slots
        hist = self._latency_hist.snapshot()
        if hist is not None:
            block["latency_hist"] = hist
        return {"serving": block}

    def close(self):
        """Abort queued and in-flight requests (their clients get an error
        event, not a dead socket), emit the run summary; idempotent."""
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
        if self.recorder.enabled:
            stats = self.stats()
            self.recorder.record(
                "run_summary",
                duration_s=time.perf_counter() - self._started_tm,
                memory_mb=_rss_mb() or None,
                **{k: v for k, v in stats.items()
                   if k not in ("queue_depth", "active", "trace_counts")},
            )
            self.recorder.flush()
