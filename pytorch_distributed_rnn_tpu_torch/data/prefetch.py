"""Host-path input pipeline: bounded lookahead over a batch iterator.

A copy of the JAX package's ``data/prefetch.py``.  The torch-DataLoader-
worker analogue for the per-batch loop
(``training/base.py:Trainer._train_epoch_eager``): a producer THREAD pulls
items ``depth`` ahead of the consumer, so batch preparation, and the data
faults of a ``--faults`` schedule (``resilience/faults.py``), run where a
real loader's would.

Lifecycle is explicit because chaos runs exit early by design
(``resilience/faults.py`` kills, injected exceptions, guard aborts): a
consumer that abandons the stream - ``close()``, ``with``-exit, garbage
collection, or just breaking out of its ``for`` loop - stops and joins
the producer thread instead of leaking it.  (The producer thread
deliberately holds no reference to the iterator, only to the shared
channel state - otherwise an abandoned iterator could never be
collected and its ``__del__`` cleanup would never run.)  A
producer-side exception is re-raised in the consumer AT ITS POSITION in
the stream, carrying the original traceback (the producer frames), so
loader bugs debug the same as they would un-prefetched.

Ordering is strict FIFO and the lookahead bound is exact: when the
consumer holds item ``i``, the producer has pulled at most items
``i+1 .. i+depth`` (a token semaphore, released as the consumer takes
each item, gates every source pull).
"""

from __future__ import annotations

import threading
from collections import deque
from collections.abc import Iterable, Iterator
from typing import Generic, TypeVar

T = TypeVar("T")

_JOIN_TIMEOUT_S = 5.0


class _Done:
    """Stream-end sentinel."""


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


class _Channel:
    """The producer/consumer state, shared by the thread and the
    iterator.  Kept separate so the THREAD references only the channel:
    the iterator stays collectable while the thread runs, and its GC
    finalizer can stop the thread."""

    def __init__(self, depth: int):
        # producer acquires one token per source pull; consumer releases
        # one per item taken - so pulled <= consumed + depth, exactly
        self.tokens = threading.Semaphore(depth)
        self.buffer: deque = deque()
        self.available = threading.Semaphore(0)  # items in buffer
        self.stop = threading.Event()

    def emit(self, item):
        self.buffer.append(item)
        self.available.release()


def _produce(source, chan: _Channel, stage):
    try:
        while True:
            # poll the token so an abandoned consumer (stopped with a
            # full buffer) releases the thread promptly
            while not chan.tokens.acquire(timeout=0.1):
                if chan.stop.is_set():
                    return
            if chan.stop.is_set():
                return
            try:
                item = next(source)
                # staging runs HERE, on the producer thread, inside the
                # same try: a stage failure (device OOM, bad transfer)
                # re-raises at the consumer's position like any other
                # producer-side error
                if stage is not None:
                    item = stage(item)
            except StopIteration:
                chan.emit(_Done)
                return
            except BaseException as exc:  # noqa: BLE001 - re-raised in consumer
                # ship the exception OBJECT: its __traceback__ already
                # points at the producer frames, so the consumer-side
                # raise shows the original failure site
                chan.emit(_Raised(exc))
                return
            chan.emit(item)
    finally:
        close = getattr(source, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # pragma: no cover - best-effort cleanup
                pass


def prefetch(
    iterable: Iterable[T], depth: int = 2, stage=None
) -> "PrefetchIterator[T]":
    """Yield from ``iterable`` in order, pulling up to ``depth`` items
    ahead on a producer thread.

    When the consumer holds item ``i``, items up to ``i+depth`` have
    already been pulled from the source (and, for device batches, their
    uploads dispatched).  ``depth`` must be >= 1.

    ``stage`` (optional) is applied to every item ON THE PRODUCER
    THREAD before it enters the channel - the device-staging hook (the
    JAX trainer passes a blocking ``device_put`` there; the port's
    trainer passes nothing yet: its batches are gathered on the device
    from index vectors).  A ``stage``
    exception propagates to the consumer at that item's position, same
    as a source error.
    """
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    return PrefetchIterator(iterable, depth, stage)


class PrefetchIterator(Generic[T]):
    """Iterator over a producer-thread-fed bounded channel."""

    def __init__(self, iterable: Iterable[T], depth: int, stage=None):
        self._chan = _Channel(depth)
        self._closed = False
        self._thread = threading.Thread(
            target=_produce, args=(iter(iterable), self._chan, stage),
            name="pdrnn-prefetch", daemon=True,
        )
        self._thread.start()

    def __iter__(self) -> Iterator[T]:
        return self

    def __next__(self) -> T:
        if self._closed:
            raise StopIteration
        self._chan.available.acquire()
        item = self._chan.buffer.popleft()
        if item is _Done:
            # latch exhaustion: the sentinel was consumed, so further
            # __next__ calls must short-circuit on _closed (re-acquiring
            # `available` on a dead producer would block forever)
            self._closed = True
            self._chan.available.release()
            raise StopIteration
        if isinstance(item, _Raised):
            self._chan.available.release()
            self._closed = True
            raise item.exc
        self._chan.tokens.release()
        return item

    def close(self):
        """Stop and join the producer thread; idempotent.  Called on
        ``with``-exit and GC too, so an early-exiting consumer (chaos
        kill path excepted - SIGKILL joins nothing) never leaks the
        thread.  A producer blocked inside the source (a stalled loader)
        is abandoned after a bounded join timeout; the thread is a
        daemon, so it cannot hold the process open either way."""
        self._closed = True
        self._chan.stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=_JOIN_TIMEOUT_S)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC timing is interpreter-specific
        try:
            self.close()
        except Exception:
            pass
