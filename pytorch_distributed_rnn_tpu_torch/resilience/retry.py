"""Exponential backoff with deterministic jitter for transport calls (a copy
of the JAX package's ``resilience/retry.py``).

The parameter-server worker's push/pull rides the native TCP transport;
under injected faults (and on real preemptible clusters) an exchange can
fail transiently.  ``retry_transport`` re-runs the exchange with
exponential backoff plus seeded jitter - deterministic for a given
(seed, attempt), so chaos runs replay exactly, while distinct workers
(distinct seeds) still decorrelate their retry storms.

Two independent caps bound a storm:

- the ATTEMPT cap (``retries``): how many re-runs before giving up;
- the DEADLINE budget (``deadline_s``): total wall clock the storm may
  consume.  The backoff schedule is pre-trimmed so its sleep sum stays
  under the budget, and elapsed time (the attempts themselves cost
  wall clock too) is checked before every sleep.  The PS worker derives
  it from ``--ps-sync-timeout``, so a retry storm can never outlive the
  sync round it is retrying into - without it, worst-case retries could
  keep a zombie exchange alive long after the master's round degraded
  past this worker.
"""

from __future__ import annotations

import logging
import random
import time

log = logging.getLogger(__name__)


def backoff_delays(retries: int, base_delay: float = 0.05,
                   max_delay: float = 2.0, seed: int = 0,
                   deadline_s: float | None = None):
    """The retry sleep sequence: ``base * 2**attempt`` capped at
    ``max_delay``, plus up to 50 % seeded jitter.  With ``deadline_s``
    the sequence is TRIMMED so its cumulative sum never exceeds the
    budget - the property the deadline contract rests on (sleeping the
    full schedule can never outlive the round being retried into)."""
    rng = random.Random(seed)
    delays = [
        min(base_delay * (2 ** attempt), max_delay) * (1.0 + 0.5 * rng.random())
        for attempt in range(retries)
    ]
    if deadline_s is None:
        return delays
    trimmed, total = [], 0.0
    for delay in delays:
        if total + delay > deadline_s:
            break
        trimmed.append(delay)
        total += delay
    return trimmed


def retry_transport(fn, *, retries: int = 3, base_delay: float = 0.05,
                    max_delay: float = 2.0, seed: int = 0,
                    retryable=(RuntimeError, OSError), what: str = "exchange",
                    sleep=time.sleep, on_retry=None,
                    deadline_s: float | None = None,
                    clock=time.monotonic):
    """Run ``fn()``; on a retryable transport error, back off and re-run.

    Raises the FIRST error (the diagnostic one, matching the trainer's
    compile-retry convention) once ``retries`` re-attempts are exhausted
    OR the ``deadline_s`` wall-clock budget is spent - whichever comes
    first.  ``on_retry(attempt, exc)`` (if given) is called before each
    backoff sleep - the telemetry hook counting retries per exchange.
    """
    delays = backoff_delays(retries, base_delay, max_delay, seed,
                            deadline_s=deadline_s)
    t_start = clock() if deadline_s is not None else 0.0
    first_exc = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except retryable as exc:
            first_exc = first_exc or exc
            if attempt >= len(delays):
                # attempt cap, or the deadline trimmed the schedule
                raise first_exc
            delay = delays[attempt]
            if deadline_s is not None and (
                clock() - t_start + delay > deadline_s
            ):
                # the attempts themselves burned the budget: stop now
                # rather than sleep past the round being retried into
                log.warning(
                    f"transport {what} retry deadline ({deadline_s:g}s) "
                    f"exhausted after {attempt + 1} attempt(s); giving up"
                )
                raise first_exc
            log.warning(
                f"transport {what} failed ({type(exc).__name__}: {exc}); "
                f"retry {attempt + 1}/{retries} in {delay:.3f}s"
            )
            if on_retry is not None:
                on_retry(attempt + 1, exc)
            sleep(delay)