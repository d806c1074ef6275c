"""The continuous-batching core: pure request/slot bookkeeping (a copy
of the JAX package's ``serving/scheduler.py``).

This module is deliberately device-free and thread-unaware: the engine
serializes calls under its own lock and runs the device work.  Keeping
the scheduling DECISIONS (admission, shedding, FIFO slot assignment,
join/leave at step boundaries) in plain Python makes the core a pure
unit - ``tests/test_torch_serving_scheduler.py`` drives the scheduling
decisions without touching a device.

Invariants (tested):

- admission is FIFO and shedding is tail-drop: a request is either
  queued in arrival order or rejected immediately (``admit`` returns
  False past ``max_queue``) - never silently dropped later;
- joins happen only through :meth:`take_joins` - the engine calls it at
  step boundaries, so a request can never enter mid-step;
- slot assignment is starvation-free: free slots are filled strictly
  from the queue head, so the wait of the oldest queued request is
  bounded by the remaining tokens of the requests already decoding;
- a slot is reused only after :meth:`release`.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class ServeRequest:
    """One generation request plus its lifecycle bookkeeping.

    Timing fields are monotonic stamps (``time.perf_counter``) set by
    the engine; the scheduler never reads a clock.
    """

    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    id: str = ""
    stream: bool = False
    # engine-facing callbacks (server wires the connection here)
    on_token: Callable | None = None
    on_done: Callable | None = None
    # distributed-tracing context (obs/tracectx.TraceContext) - set by
    # the server only when the request arrived traced AND the engine
    # records; None everywhere else (the zero-overhead-off contract)
    trace: object | None = None
    # lifecycle
    status: str = "queued"  # queued | active | done | shed | error
    error: str | None = None
    tokens: list[int] = field(default_factory=list)
    slot: int | None = None
    bucket: int | None = None
    seq: int | None = None  # admission order, engine-assigned
    arrival_tm: float | None = None
    service_tm: float | None = None  # joined a slot
    prefill_done_tm: float | None = None
    first_token_tm: float | None = None
    done_tm: float | None = None

    @property
    def queue_wait_s(self) -> float | None:
        if self.arrival_tm is None or self.service_tm is None:
            return None
        return self.service_tm - self.arrival_tm

    @property
    def latency_s(self) -> float | None:
        if self.arrival_tm is None or self.done_tm is None:
            return None
        return self.done_tm - self.arrival_tm

    @property
    def ttft_s(self) -> float | None:
        if self.arrival_tm is None or self.first_token_tm is None:
            return None
        return self.first_token_tm - self.arrival_tm

    @property
    def finished(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens


class ContinuousBatcher:
    """Slot/queue bookkeeping for a fixed batch of decode slots."""

    def __init__(self, num_slots: int, max_queue: int = 64):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.num_slots = int(num_slots)
        self.max_queue = int(max_queue)
        self._pending: deque[ServeRequest] = deque()
        self._slots: list[ServeRequest | None] = [None] * self.num_slots
        self._seq = itertools.count()
        # observability counters (the engine folds them into run_summary)
        self.admitted = 0
        self.shed = 0
        self.completed = 0

    # -- queue side ----------------------------------------------------------

    def admit(self, request: ServeRequest) -> bool:
        """Queue ``request`` (FIFO) or shed it when the backlog is
        full.  Returns whether it was admitted; a shed request is
        marked so the caller can answer immediately.

        The admission budget is ``max_queue`` PLUS the currently free
        slots: requests destined for an idle slot are not "queued" in
        any meaningful sense (they join at the next step boundary), so
        ``max_queue=0`` means direct-to-slot admission with no waiting
        line - not a server that sheds everything."""
        if len(self._pending) >= self.max_queue + len(self.free_slots()):
            request.status = "shed"
            self.shed += 1
            return False
        request.seq = next(self._seq)
        request.status = "queued"
        self._pending.append(request)
        self.admitted += 1
        return True

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    @property
    def active_count(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or self.active_count > 0

    # -- slot side (engine calls, at step boundaries only) -------------------

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def take_joins(self) -> list[tuple[int, ServeRequest]]:
        """Pop queued requests into free slots, FIFO into ascending slot
        ids.  Called by the engine BETWEEN decode steps - the only path
        from queue to slot, so joins always land on step boundaries."""
        joins = []
        for slot in self.free_slots():
            if not self._pending:
                break
            request = self._pending.popleft()
            request.slot = slot
            request.status = "active"
            self._slots[slot] = request
            joins.append((slot, request))
        return joins

    def active(self) -> list[tuple[int, ServeRequest]]:
        return [
            (i, r) for i, r in enumerate(self._slots) if r is not None
        ]

    def release(self, slot: int) -> ServeRequest:
        """Free ``slot`` after its request finished (or errored); the
        next :meth:`take_joins` may refill it."""
        request = self._slots[slot]
        if request is None:
            raise ValueError(f"slot {slot} is not occupied")
        self._slots[slot] = None
        request.slot = None
        self.completed += 1
        return request

    def abort_pending(self, error: str) -> list[ServeRequest]:
        """Fail every queued request (shutdown path); active slots are
        the engine's to finish or fail."""
        aborted = []
        while self._pending:
            request = self._pending.popleft()
            request.status = "error"
            request.error = error
            aborted.append(request)
        return aborted
