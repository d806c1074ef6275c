"""The serving engine's Python->torch calls, and its pace beside a busy thread.

    python -m pytorch_distributed_rnn_tpu_torch.utils.engine_calls [--tree DIR]

A thread that runs Python and never blocks takes the interpreter lock
from the engine thread at each call the engine makes into torch (each
gives the lock up) and keeps it for up to a switch interval (5 ms), so an
engine that makes many calls a step starves beside it.  This measures,
on the CPU, the serving engine of the package under DIR (another
checkout, for example a ``git archive`` of an older commit; default this
one) in a child process whose ``sys.path[0]`` is DIR, at the setup of
``tests/test_torch_serving.py``'s thread tests: the char GRU (vocab 48,
embed 16, hidden 24, 2 layers, seeded weights), 2 slots, prompt buckets
(8, 16), 10 mixed requests (greedy and sampled):

- ``calls``: the calls of the whole drained run, a decode step's on
  average, and one join of a 16-token prompt.  Counted by the engine's
  ``TorchCalls`` where the tree has it (by phase, programs included),
  else by a ``TorchFunctionMode`` that sees every call of an eager
  engine;
- ``serve_s``: the 10 requests through ``serve_forever`` on its thread,
  submitted from another, the main thread waiting on ``stats()`` with no
  pause (the test's loop), alone and with one more thread spinning in
  Python beside them; each run is cut at 60 s and says how many requests
  it served.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

CUT_S = 60.0


def _setup():
    import numpy as np
    import torch

    from pytorch_distributed_rnn_tpu_torch.models import CharRNN
    from pytorch_distributed_rnn_tpu_torch.serving.adapters import adapter_for
    from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
    from pytorch_distributed_rnn_tpu_torch.serving.engine import ServingEngine
    from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ServeRequest

    torch.manual_seed(1)
    model = CharRNN(vocab_size=48, embed_dim=16, hidden_dim=24, layer_dim=2, cell="gru",
                    impl="scan").eval()

    def engine():
        e = ServingEngine(adapter_for(model), num_slots=2, bucket_spec=BucketSpec((8, 16)),
                          max_new_tokens=12, max_queue=64)
        e.warmup()
        return e

    def requests():
        rng = np.random.RandomState(12)
        out = []
        for i in range(10):
            plen = int(rng.randint(1, 16))
            out.append(ServeRequest(prompt=rng.randint(0, 48, size=plen).tolist(),
                                    max_new_tokens=int(rng.randint(1, 13)),
                                    temperature=[0.0, 0.7, 1.0][i % 3], seed=1000 + i,
                                    id=str(i)))
        return out

    return engine, requests, ServeRequest


def _counter(engine):
    """The engine's own counter, or one that sees every call of an eager
    engine (``phase`` "all")."""
    from torch.overrides import TorchFunctionMode

    from pytorch_distributed_rnn_tpu_torch.serving import engine as engine_module

    if hasattr(engine_module, "TorchCalls"):
        return engine_module.TorchCalls(engine)

    class AllCalls(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.counts = Counter()

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.counts["all"] += 1
            return func(*args, **(kwargs or {}))

    return AllCalls()


def _calls(make_engine, make_requests, request_cls) -> dict:
    import torch

    engine = make_engine()
    for r in make_requests():
        engine.submit(r)
    steps = 0
    with torch.no_grad(), _counter(engine) as calls:
        while engine.batcher.has_work:
            steps += engine.run_step(wait_s=0.0)
    run = dict(calls.counts)
    engine = make_engine()
    engine.submit(request_cls(prompt=list(range(1, 17)), max_new_tokens=1, id="join"))
    with torch.no_grad():
        with _counter(engine) as joining:
            engine._do_join(*engine.batcher.take_joins()[0])
    total = sum(run.values())
    return {"run": run, "steps": steps, "a_step": total / steps,
            "join_16": dict(joining.counts)}


def _serve(make_engine, make_requests, spin: bool) -> dict:
    engine = make_engine()
    requests = make_requests()
    stop = threading.Event()
    threads = []
    if spin:
        def spin_loop():
            n = 0
            while not stop.is_set():
                n += 1

        threads.append(threading.Thread(target=spin_loop, daemon=True))
    threads.append(threading.Thread(target=engine.serve_forever, args=(stop,), daemon=True))
    threads.append(threading.Thread(target=lambda: [engine.submit(r) for r in requests],
                                    daemon=True))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while engine.stats()["requests"] < len(requests) and time.perf_counter() - t0 < CUT_S:
        pass
    seconds = time.perf_counter() - t0
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    return {"seconds": seconds, "served": engine.stats()["requests"], "of": len(requests),
            "steps": engine.stats()["steps"]}


def measure() -> dict:
    make_engine, make_requests, request_cls = _setup()
    return {"tree": str(Path(sys.path[0]).resolve()),
            "calls": _calls(make_engine, make_requests, request_cls),
            "serve_s": {"alone": _serve(make_engine, make_requests, spin=False),
                        "spinner": _serve(make_engine, make_requests, spin=True)}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[2])
    args = parser.parse_args(argv)
    code = ("import json, runpy, sys; sys.path.insert(0, sys.argv[1]); "
            "m = runpy.run_path(sys.argv[2]); print(json.dumps(m['measure']()))")
    proc = subprocess.run([sys.executable, "-c", code, str(args.tree.resolve()),
                           str(Path(__file__).resolve())], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        return proc.returncode
    print(proc.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
