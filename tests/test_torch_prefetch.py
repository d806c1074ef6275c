"""The port's ``data/prefetch.py`` against the JAX package's: the bounded
FIFO lookahead on a producer thread, the exact bound, a producer-side
exception re-raised at its position with its traceback, and ``close()``,
``with``-exit and abandonment joining the thread.  Every lifecycle case
runs on both copies (``impl``) and must behave alike; then the port's
per-batch loop, whose batches come through the prefetch thread, against
its graph path bit for bit.
"""

import gc
import threading
import time
import traceback

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu.data.prefetch import prefetch as jax_prefetch
from pytorch_distributed_rnn_tpu_torch.data import MotionDataset
from pytorch_distributed_rnn_tpu_torch.data.prefetch import prefetch as port_prefetch
from pytorch_distributed_rnn_tpu_torch.data.synthetic import generate_har_arrays
from pytorch_distributed_rnn_tpu_torch.models import MotionModel
from pytorch_distributed_rnn_tpu_torch.training import Trainer
from pytorch_distributed_rnn_tpu_torch.training.formatter import TrainingMessageFormatter

SEED = 123456789
IMPLS = {"port": port_prefetch, "jax": jax_prefetch}


@pytest.fixture(params=sorted(IMPLS))
def prefetch(request):
    return IMPLS[request.param]


def _wait_until(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return predicate()


def _no_prefetch_threads():
    return not any(t.name == "pdrnn-prefetch" and t.is_alive() for t in threading.enumerate())


def test_yields_in_order_and_exhausts(prefetch):
    assert list(prefetch(iter(range(7)), depth=2)) == list(range(7))
    assert list(prefetch(iter([]), depth=3)) == []


def test_pulls_ahead_of_consumer_and_bound_is_exact(prefetch):
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield i

    with prefetch(source(), depth=2) as stream:
        assert next(stream) == 0
        # the consumer holds item 0: the producer pulls exactly depth more
        assert _wait_until(lambda: len(pulled) == 3)
        time.sleep(0.05)
        assert pulled == [0, 1, 2]
        assert next(stream) == 1
        assert _wait_until(lambda: len(pulled) == 4)
        time.sleep(0.05)
        assert pulled == [0, 1, 2, 3]
    assert _wait_until(_no_prefetch_threads)


def test_depth_must_be_positive(prefetch):
    with pytest.raises(ValueError, match="depth"):
        list(prefetch(iter([1]), depth=0))


def test_exhausted_stream_stays_exhausted(prefetch):
    stream = prefetch(iter(range(3)), depth=2)
    assert list(stream) == [0, 1, 2]
    assert list(stream) == []
    with pytest.raises(StopIteration):
        next(stream)


def test_stage_runs_on_producer_thread_in_order(prefetch):
    threads = []

    def stage(item):
        threads.append(threading.current_thread().name)
        return item * 10

    assert list(prefetch(iter(range(4)), depth=2, stage=stage)) == [0, 10, 20, 30]
    assert threads and all(name == "pdrnn-prefetch" for name in threads)


def test_stage_exception_propagates_at_item_position(prefetch):
    def stage(item):
        if item == 2:
            raise RuntimeError("stage blew up")
        return item

    stream = prefetch(iter(range(5)), depth=2, stage=stage)
    assert [next(stream), next(stream)] == [0, 1]
    with pytest.raises(RuntimeError, match="stage blew up"):
        next(stream)
    stream.close()
    assert _wait_until(_no_prefetch_threads)


def test_close_joins_producer_thread(prefetch):
    stream = prefetch(iter(range(1000)), depth=2)
    assert next(stream) == 0
    stream.close()
    assert _wait_until(_no_prefetch_threads)
    assert list(stream) == []


def test_abandoning_consumer_joins_thread_via_gc(prefetch):
    stream = prefetch(iter(range(1000)), depth=2)
    assert next(stream) == 0
    del stream
    gc.collect()
    assert _wait_until(_no_prefetch_threads)


def test_break_out_of_for_loop_then_gc_joins_thread(prefetch):
    for item in prefetch(iter(range(1000)), depth=2):
        if item == 3:
            break
    gc.collect()
    assert _wait_until(_no_prefetch_threads)


def test_producer_exception_propagates_with_original_traceback(prefetch):
    def source():
        yield 1
        raise KeyError("boom in the loader")

    stream = prefetch(source(), depth=2)
    assert next(stream) == 1
    with pytest.raises(KeyError, match="boom in the loader") as excinfo:
        next(stream)
    assert "source" in "".join(traceback.format_tb(excinfo.value.__traceback__))
    assert _wait_until(_no_prefetch_threads)
    assert list(stream) == []


def test_exception_position_in_stream_is_preserved(prefetch):
    def source():
        yield from range(3)
        raise RuntimeError("after three")

    seen = []
    with pytest.raises(RuntimeError, match="after three"):
        for item in prefetch(source(), depth=2):
            seen.append(item)
    assert seen == [0, 1, 2]


def test_stalled_source_does_not_hang_close(prefetch):
    release = threading.Event()

    def source():
        yield 0
        release.wait(timeout=30)  # a stalled loader
        yield 1

    stream = prefetch(source(), depth=1)
    assert next(stream) == 0
    t0 = time.monotonic()
    stream.close()
    assert time.monotonic() - t0 < 10
    release.set()
    assert _wait_until(_no_prefetch_threads)


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_per_batch_loop_through_prefetch_matches_graph_path(dropout):
    """The per-batch loop (its index batches through the prefetch thread)
    and the device-resident step path train the same bits, dropout
    included; no producer thread outlives the epochs."""
    x, y = generate_har_arrays(184, seq_length=24, seed=3)
    train = MotionDataset(x, y)
    formatter = TrainingMessageFormatter(2)

    def trainer():
        model = MotionModel(input_dim=9, hidden_dim=16, layer_dim=2, output_dim=6,
                            dropout=dropout, generator=torch.Generator().manual_seed(5))
        return Trainer(model, train, batch_size=48, learning_rate=2.5e-3, seed=SEED,
                       device="cpu")

    runs = {}
    for eager in (True, False):
        t = trainer()
        history = []
        for epoch in range(2):
            t.sampler.set_epoch(epoch)
            history.append(t._train_epoch(formatter, eager=eager)[0])
        runs[eager] = (history, t)
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1].model.parameters(), runs[False][1].model.parameters()):
        assert torch.equal(a, b)
    assert np.isfinite(runs[True][0]).all()
    assert _wait_until(_no_prefetch_threads)
