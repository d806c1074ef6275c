"""The port's TCP ring (``runtime/native.py`` over its copy of
``collectives.cpp``) and its bucket plan (``parallel/bucketing.py``).

The ring runs in spawned worlds of 2 and 3 ranks, each spawned once: every
rank runs all its checks in one body and sends back what it saw.  The bucket
plan is held against the JAX package's ``plan_buckets``.
"""

import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch.parallel import bucketing
from pytorch_distributed_rnn_tpu_torch.runtime import native
from pytorch_distributed_rnn_tpu_torch.runtime.native import Communicator
from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
CHUNK = 37  # elements a rank in the reduce-scatter checks
FAULT_DELAY_MS = 25.0


def _arrays(tensors):
    """Tensors as float64 numpy arrays (exact for every wire dtype) for the
    trip back to the test process."""
    return [t.double().numpy() for t in tensors]


def _rejections(comm) -> list:
    """Each bad call must raise before anything is posted: the ring is
    still in step afterwards (the allreduce after them agrees)."""
    raised = []
    bad_calls = [
        lambda: comm.allreduce(torch.ones(4, dtype=torch.int32)),
        lambda: comm.allreduce(np.ones(4, np.int64)),
        lambda: comm.reduce_scatter(torch.ones(4, dtype=torch.float16)),
        lambda: comm.reduce_scatter(torch.ones(comm.world_size * 3 + 1)),
        lambda: comm.reduce_scatter_async(torch.ones(comm.world_size * 2 + 1)),
        lambda: comm.reduce_scatter_async(torch.ones(4, dtype=torch.int64)),
        lambda: comm.allgather_async(torch.ones(2, dtype=torch.int8)),
        lambda: comm.allreduce_async(torch.ones(2, dtype=torch.float16)),
        lambda: comm.broadcast(torch.ones(2, dtype=torch.int32)),
    ]
    for call in bad_calls:
        try:
            call()
        except (TypeError, ValueError) as e:
            raised.append(type(e).__name__)
        else:
            raised.append(None)
    return raised


def _body(rank, world, port):
    """Every check of one rank; returns what it saw."""
    seen = {}
    with Communicator("127.0.0.1", port, rank, world) as comm:
        data = torch.full((1000,), float(rank + 1))
        seen["sum"] = comm.allreduce(data).numpy().copy()
        seen["mean"] = comm.allreduce(torch.arange(7.0) + rank, op="mean").numpy().copy()
        seen["numpy_sum"] = comm.allreduce(np.full(5, rank + 1.0, np.float64)).numpy().copy()
        generator = torch.Generator().manual_seed(17 + rank)
        for name, dtype in DTYPES.items():
            values = torch.randn(CHUNK * world, generator=generator).to(dtype)
            kept = values.clone()
            chunk = comm.reduce_scatter(values)
            full = comm.allreduce(values.clone())
            mean_chunk = comm.reduce_scatter(values, op="mean")
            mean_full = comm.allreduce(values.clone(), op="mean")
            seen[f"rs_{name}"] = _arrays([chunk, full[rank * CHUNK:(rank + 1) * CHUNK],
                                          mean_chunk, mean_full[rank * CHUNK:(rank + 1) * CHUNK]])
            seen[f"rs_{name}_dtype"] = str(chunk.dtype)
            seen[f"rs_{name}_untouched"] = bool(torch.equal(values, kept))
        seen["gather"] = comm.allgather(torch.tensor([rank, 10.0 * rank])).numpy().copy()
        root = world - 1
        seen["bcast"] = comm.broadcast(torch.full((5,), float(rank)), root=root).numpy().copy()
        # async against sync, many handles outstanding (bucket-like sizes)
        sync, posted = [], []
        for name, dtype in DTYPES.items():
            bucket = [torch.randn(n * world, generator=generator).to(dtype) for n in (1, 3, 16, 5)]
            sync.append([comm.reduce_scatter(b) for b in bucket])
            sync[-1] += [comm.allgather(s) for s in sync[-1]]
            sync[-1].append(comm.allreduce(torch.cat(bucket).clone()))
            posted.append((bucket, [comm.reduce_scatter_async(b) for b in bucket],
                           comm.allreduce_async(torch.cat(bucket).clone())))
        async_out = []
        for bucket, handles, reduce_handle in posted:
            chunks = [comm.wait(h) for h in handles]
            gathers = [comm.allgather_async(c) for c in chunks]
            async_out.append(chunks + [comm.wait(g) for g in gathers]
                             + [comm.wait(reduce_handle)])
        seen["async"] = [_arrays(s) for s in sync], [_arrays(a) for a in async_out]
        seen["wait_again"] = comm.wait(posted[0][1][0]) is async_out[0][0]
        seen["comm_seconds"] = min(h.comm_seconds for _, hs, _ in posted for h in hs)
        # point to point: rank 0 sends to the last rank
        if rank == 0:
            comm.send(world - 1, torch.arange(4.0, dtype=torch.float64))
        if rank == world - 1:
            seen["recv"] = comm.recv(0, (4,), torch.float64).numpy().copy()
        seen["rejected"] = _rejections(comm)
        seen["after_rejections"] = comm.allreduce(torch.ones(3)).numpy().copy()
        comm.set_fault(FAULT_DELAY_MS, 0.0)
        t0 = time.perf_counter()
        comm.allreduce(torch.ones(world * 4))
        seen["fault_seconds"] = time.perf_counter() - t0
        comm.set_fault(0.0, 0.0)
        comm.barrier()
        seen["threads"] = comm.thread_count()
    return seen


def _wrapper(rank, world, port, queue):
    try:
        queue.put((rank, _body(rank, world, port)))
    except BaseException as e:  # the parent reports it
        queue.put((rank, repr(e)))


@pytest.fixture(scope="module", params=[2, 3], ids=lambda w: f"world{w}")
def world(request):
    """One spawned world: ``(world size, {rank: what it saw})``."""
    size = request.param
    native.build_native_library()  # built once, before the ranks load it
    (port,) = free_ports(1)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_wrapper, args=(rank, size, port, queue))
             for rank in range(size)]
    for p in procs:
        p.start()
    try:
        seen = dict(queue.get(timeout=120) for _ in range(size))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    failed = {rank: v for rank, v in seen.items() if isinstance(v, str)}
    assert not failed, failed
    return size, seen


def test_allreduce_sum_and_mean(world):
    size, seen = world
    for rank in range(size):
        np.testing.assert_array_equal(seen[rank]["sum"], np.full(1000, size * (size + 1) / 2))
        np.testing.assert_allclose(seen[rank]["mean"], np.arange(7.0) + (size - 1) / 2,
                                   rtol=1e-6)
        np.testing.assert_array_equal(seen[rank]["numpy_sum"],
                                      np.full(5, size * (size + 1) / 2))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reduce_scatter_chunks_equal_allreduce_slices_bitwise(world, dtype):
    size, seen = world
    expected_dtype = str(DTYPES[dtype])
    for rank in range(size):
        chunk, full, mean_chunk, mean_full = seen[rank][f"rs_{dtype}"]
        np.testing.assert_array_equal(chunk, full)
        np.testing.assert_array_equal(mean_chunk, mean_full)
        assert seen[rank][f"rs_{dtype}_dtype"] == expected_dtype
        assert seen[rank][f"rs_{dtype}_untouched"]


def test_allgather_in_rank_order(world):
    size, seen = world
    want = np.array([[r, 10.0 * r] for r in range(size)], np.float32)
    for rank in range(size):
        np.testing.assert_array_equal(seen[rank]["gather"], want)


def test_broadcast_from_a_nonzero_root(world):
    size, seen = world
    for rank in range(size):
        np.testing.assert_array_equal(seen[rank]["bcast"], np.full(5, float(size - 1)))


def test_send_recv(world):
    size, seen = world
    np.testing.assert_array_equal(seen[size - 1]["recv"], np.arange(4.0))


def test_async_equals_sync_bitwise(world):
    size, seen = world
    for rank in range(size):
        sync, posted = seen[rank]["async"]
        for s, a in zip(sync, posted, strict=True):
            for x, y in zip(s, a, strict=True):
                np.testing.assert_array_equal(x, y)
        assert seen[rank]["wait_again"]
        assert seen[rank]["comm_seconds"] >= 0.0


def test_bad_inputs_are_rejected_before_posting_at_every_rank(world):
    size, seen = world
    for rank in range(size):
        assert seen[rank]["rejected"] == ["TypeError", "TypeError", "TypeError", "ValueError",
                                          "ValueError", "TypeError", "TypeError", "TypeError",
                                          "TypeError"]
        np.testing.assert_array_equal(seen[rank]["after_rejections"], np.full(3, float(size)))


def test_fault_delay_slows_the_ring_and_workers_are_two(world):
    size, seen = world
    for rank in range(size):
        assert seen[rank]["fault_seconds"] >= FAULT_DELAY_MS / 1e3
        assert seen[rank]["threads"] == 2


# ---------------------------------------------------------------------------
# in process: a world of 1, the build, the fault environment
# ---------------------------------------------------------------------------


def test_library_is_built_under_build_from_the_ports_own_source():
    path = native.build_native_library()
    assert path == native.library_path() and path.exists()
    assert path.is_relative_to(os.path.join(ROOT, "build", "torch_runtime"))
    assert native.SOURCE == (
        native.Path(ROOT) / "pytorch_distributed_rnn_tpu_torch" / "runtime" / "csrc"
        / "collectives.cpp")


def test_world_of_one_is_identity_without_threads():
    with Communicator(world_size=1) as comm:
        data = torch.arange(6.0)
        np.testing.assert_array_equal(comm.allreduce(data.clone()), data)
        np.testing.assert_array_equal(comm.reduce_scatter(data), data)
        np.testing.assert_array_equal(comm.allgather(data), data[None])
        assert torch.equal(comm.wait(comm.reduce_scatter_async(data.bfloat16())),
                           data.bfloat16())
        np.testing.assert_array_equal(comm.broadcast(data.clone()), data)
        comm.barrier()
        assert comm.thread_count() == 0


def test_ring_refuses_tensors_off_the_host():
    with Communicator(world_size=1) as comm:
        with pytest.raises(ValueError, match="host"):
            comm.allreduce(torch.ones(3, device="meta"))


def test_fault_environment_sets_the_fault(monkeypatch):
    calls = []
    monkeypatch.setattr(Communicator, "set_fault", lambda self, d, p: calls.append((d, p)))
    monkeypatch.setenv("PDRNN_FAULT_DELAY_MS", "12.5")
    monkeypatch.setenv("PDRNN_FAULT_LOSS_PROB", "0.25")
    Communicator(world_size=1).close()
    monkeypatch.delenv("PDRNN_FAULT_DELAY_MS")
    monkeypatch.delenv("PDRNN_FAULT_LOSS_PROB")
    Communicator(world_size=1).close()
    assert calls == [(12.5, 0.25)]


def test_init_from_env_without_a_launcher_is_a_world_of_one(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with native.init_from_env() as comm:
        assert (comm.rank, comm.world_size) == (0, 1)


# ---------------------------------------------------------------------------
# the bucket plan against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 7, 99, 662, 14150, 3_573_504])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_plan_buckets_matches_jax(size, world):
    from pytorch_distributed_rnn_tpu.parallel.bucketing import plan_buckets as jax_plan

    # one-element buckets (1e-9, 1e-5 MB) only where the plan stays short
    caps = (1e-9, 1e-5, 1e-3) if size < 100_000 else ()
    for itemsize in (2, 4, 8):
        for bucket_mb in (*caps, 0.02, 4.0, bucketing.DEFAULT_BUCKET_MB):
            port = bucketing.plan_buckets(size, world, itemsize, bucket_mb)
            ref = jax_plan(size, world, itemsize, bucket_mb)
            assert port.bounds == ref.bounds and port.shard == ref.shard
            assert port.padded == ref.padded
            assert port.wire_expectations() == ref.wire_expectations()
            assert sum(port.rs_bytes(b) for b in range(port.num_buckets)) == \
                port.monolithic_rs_bytes


def test_plan_buckets_rejects_what_jax_rejects():
    for bad in [(0, 2, 4, 1.0), (662, 0, 4, 1.0), (662, 2, 0, 1.0), (662, 2, 4, 0.0)]:
        with pytest.raises(ValueError):
            bucketing.plan_buckets(*bad)
