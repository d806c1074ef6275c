"""CUDA-graph capture and replay, with kernel launch counts per execution.

The port's kernel wrappers count their launches on the host
(``ops/fused_rnn.py:LAUNCHES``, ``ops/fused_attention.py:LAUNCHES``), so
that a run can show that its main path went through the kernels.  A
captured kernel is launched once on the host, during the capture, and
then runs on every replay.  :func:`count_launch` is where a wrapper
counts: inside a capture that a :class:`CountedGraph` opened, the launch
goes to that graph's tally, and each :meth:`CountedGraph.replay` adds the
tally to the counts, so they count executions as the eager path does.
"""

from __future__ import annotations

import time

import torch

# the tallies of the captures open now, innermost last: (counts, name) a launch
_TALLIES: list = []


def count_launch(launches: dict, name: str) -> None:
    """Count one launch of kernel ``name`` in ``launches``: now, or, while
    a :class:`CountedGraph` captures on the current stream, at each of its
    replays."""
    if _TALLIES and torch.cuda.is_current_stream_capturing():
        _TALLIES[-1].append((launches, name))
    else:
        launches[name] += 1


class CountedGraph:
    """One ``torch.cuda.CUDAGraph`` captured from a function, whose kernel
    launches count at each replay.  ``generators`` are the CUDA generators
    the function draws from besides the default one: each is registered
    with the graph, so each replay draws the numbers the next eager call
    would (the generator's offset moves on by the capture's draws a
    replay).  ``capture_s`` is the wall time of the capture."""

    def __init__(self, generators=()):
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        self.tally: list = []
        self.replays = 0
        self.capture_s = None

    def capture(self, fn, stream: torch.cuda.Stream):
        """Capture ``fn()`` on ``stream`` (no kernel runs); returns its
        result, whose tensors each replay rewrites.  A capture that fails
        raises."""
        t0 = time.perf_counter()
        _TALLIES.append(self.tally)
        try:
            # "thread_local": only this thread's unsafe calls break the
            # capture.  Under the default "global", a CUDA call from any
            # thread would: NCCL's watchdog thread queries the events of
            # the collectives that ran before (the warm-up's), which
            # torch.cuda.graph's synchronize has finished but the watchdog
            # may not have dropped yet.
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
                out = fn()
        finally:
            _TALLIES.pop()
        self.capture_s = time.perf_counter() - t0
        return out

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        for launches, name in self.tally:
            launches[name] += 1
