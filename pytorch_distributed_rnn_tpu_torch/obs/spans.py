"""Span primitives for the trace timeline (`obs/timeline.py`).

A *span* is a duration event: ``kind="span"`` with a ``name``, a
subsystem ``cat`` (which becomes the Perfetto thread row), a monotonic
start ``tm``, a wall-clock start ``t`` and a ``dur_s``.  Two emission
styles share one wire format:

- :class:`Span` — the context-manager form
  (``with recorder.span("eval", cat="eval"): ...``) for phases whose
  extent IS a Python block;
- ``recorder.emit_span(name, tm_start, dur_s, ...)`` — the deferred
  form for phases timed inside a hot loop and emitted afterwards (the
  trainer's post-loop step flush), or whose start was captured before
  the recorder could know the outcome (a parameter-server round).

Per-step *sub*-spans (data_wait / dispatch / fenced-device) are NOT
emitted as span events at all: the ``step`` event already carries
``tm`` + the three durations, and the timeline exporter synthesizes
the nested spans from it — one JSONL line per step instead of four.
The same synthesis covers every event that carries a duration
(``checkpoint_save``/``restore`` seconds, ``ps_exchange`` seconds,
``epoch`` wall_s), so explicit span events are reserved for phases no
existing event times.

Zero-overhead contract: a disabled recorder returns :data:`NULL_SPAN`,
a shared no-op context manager — no clock reads, no allocation beyond
the method call (pinned by the guard tests next to the no-fence /
no-thread pins).
"""

from __future__ import annotations

import time

# subsystem categories -> stable Perfetto tids (one thread row per
# subsystem inside each rank's process row).  The timeline exporter and
# validator both key off this table, so an unknown cat falls back to
# "train" rather than inventing an unmapped tid.
SUBSYSTEM_TIDS = {
    "run": 0,
    "train": 1,
    "step": 2,
    "data": 3,
    "ckpt": 4,
    "ps": 5,
    "eval": 6,
    "resilience": 7,
    "sys": 8,
    "serving": 9,  # inference-server spans (prefill, serve-loop phases)
    # elastic membership lane: member_join/drain/dead instants and
    # state_sync spans (resilience/membership.py roster transitions)
    "member": 10,
    # MPMD pipeline lane: stage_restart/replay instants (parallel/mpmd.py
    # + runtime/stage.py link recovery)
    "stage": 11,
    # streaming actor/learner lane: experience pushes, params refreshes,
    # staleness rejections (streaming/actor.py + streaming/learner.py)
    "actor": 12,
    # host-collective lane: per-bucket reduce_scatter/allgather spans of
    # the overlapped native-ring step (training/native_ddp.py) - stacked
    # against the train lane they show comm riding under compute
    "comm": 13,
    # serving-fleet router lane: dispatch spans plus breaker transitions
    # (replica_eject / replica_readmit), shed and drain instants
    # (serving/fleet/router.py)
    "router": 14,
    # distributed-tracing lane: per-request route/attempt/queue_wait/
    # decode spans carrying TraceContext ids (obs/tracectx.py).  These
    # overlap freely - concurrent requests share the row - so the
    # timeline exporter renders them as ASYNC events (ph b/e keyed by
    # trace id), not complete-event spans
    "trace": 15,
}


class Span:
    """Context manager emitting one ``span`` event on exit.

    The wall start is derived from the recorder's construction-time
    wall<->monotonic anchor rather than a second ``time.time()`` call,
    so a mid-run NTP step cannot tear a span's ``t`` away from its
    ``tm`` (the alignment in ``obs/timeline.py`` depends on the two
    describing the same instant).
    """

    __slots__ = ("_recorder", "_name", "_cat", "_attrs", "_tm0")

    def __init__(self, recorder, name: str, cat: str, attrs: dict):
        self._recorder = recorder
        self._name = name
        self._cat = cat
        self._attrs = attrs
        self._tm0 = None

    def __enter__(self) -> "Span":
        self._tm0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._recorder.emit_span(
            self._name,
            self._tm0,
            time.perf_counter() - self._tm0,
            cat=self._cat,
            **self._attrs,
        )


class NullSpan:
    """The disabled-telemetry span: enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:  # noqa: PD105
        pass


NULL_SPAN = NullSpan()
