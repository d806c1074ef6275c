"""The port's resilience and memory flags on the CPU, against the JAX
package (``tests/test_resilience.py``, ``tests/test_training.py``,
``tests/test_precision.py``) and against the port itself:

- the ``FaultSchedule`` grammar: both packages parse every spec to the same
  events, draw the same ``prob`` events, bind ranks and rejoins alike and
  export the same ``PDRNN_FAULT_*`` environment;
- the guarded Adam (``ops/adam.py``): on a finite step the unguarded
  update's bits, on a bad one nothing moves, and its counters and updates
  follow ``optax.apply_if_finite(optax.adam)`` over a run of steps;
- the guard in the trainer: guarded == unguarded bit for bit on finite
  runs (per-batch loop and graph path), the NaN skip counted as JAX counts
  it, the abort past K with JAX's message; one verdict for the world under
  the sharded update (ranks as threads) and over the ring's bucketed
  update, and a spawned world of 2 of both strategies whose ranks stay
  bitwise equal;
- ``--resume auto``: ``resume_latest`` past a corrupt file, ``advance_epoch``,
  the guard's counters and the dropout stream carried by the checkpoint,
  and a kill at ``step:4`` then ``--resume auto`` through the CLI, bit for
  bit the uninterrupted run at dropout 0.1;
- ``--grad-accum``: against JAX's ``grad_accum`` histories at rtol 1e-4
  (motion with a partial final batch, and the char LM), against the
  single-shot step at 1e-5, and refused where JAX refuses it;
- ``--remat``: bit for bit the plain run with dropout, motion LSTM/GRU
  (scan and fused), char and attention (dense and flash), keeping fewer
  tensors for the backward;
- ``--faults`` under ``parameter-server``: a worker's stall, its NaN push
  refused by the port's master as by JAX's, the actions that need the
  elastic roster refused;
- the CLI's acceptance of the five flags, and the launch helpers' required
  ``device``.

The sizes are the JAX tests': 96-120 windows of T=12, hidden 8, batch 48.
"""

import json
import logging
import math
import os
import subprocess
import sys
import threading
import time
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import (
    MotionDataset,
    TextDataset,
    generate_char_tokens,
    generate_har_arrays,
    write_synthetic_har_cache,
    write_synthetic_har_dataset,
)
from pytorch_distributed_rnn_tpu_torch.models import AttentionClassifier, CharRNN, MotionModel
from pytorch_distributed_rnn_tpu_torch.ops.adam import Adam, NonFiniteCounters, adam_update_
from pytorch_distributed_rnn_tpu_torch.parallel import launch
from pytorch_distributed_rnn_tpu_torch.parallel.sharded_update import ShardedUpdate
from pytorch_distributed_rnn_tpu_torch.resilience import (
    ChaosError,
    FaultSchedule,
    NonFiniteAbort,
    NonFiniteGuard,
    resume_latest,
)
from pytorch_distributed_rnn_tpu_torch.resilience.faults import NAN_NEEDS_FLOAT
from pytorch_distributed_rnn_tpu_torch.runtime import native
from pytorch_distributed_rnn_tpu_torch.training import Trainer
from pytorch_distributed_rnn_tpu_torch.training import native_ddp
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import checkpoint_candidates
from pytorch_distributed_rnn_tpu_torch.training.formatter import TrainingMessageFormatter
from pytorch_distributed_rnn_tpu_torch.training.lm import wrap_lm_trainer
from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports

ROOT = Path(__file__).resolve().parent.parent
SEED = 123456789
LR = 2.5e-3
HISTORY_RTOL = 1e-4
ACCUM_RTOL = 1e-5


def _jax_faults():
    from pytorch_distributed_rnn_tpu.resilience import faults

    return faults


@pytest.fixture(scope="module")
def motion_arrays():
    return generate_har_arrays(96, seq_length=12, seed=0)


def _model(layers=2, dropout=0.0, cell="lstm", impl="auto", remat=False, seed=1):
    return MotionModel(input_dim=9, hidden_dim=8, layer_dim=layers, output_dim=6, cell=cell,
                       impl=impl, dropout=dropout, remat=remat,
                       generator=torch.Generator().manual_seed(seed))


def _trainer(arrays, cls=Trainer, model=None, **kw):
    return cls(model if model is not None else _model(dropout=0.1), MotionDataset(*arrays),
               batch_size=48, learning_rate=LR, seed=SEED, device="cpu", **kw)


def _same_params(a, b):
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name


def _train(trainer, epochs, eager=None):
    """``epochs`` epochs of the per-batch loop (``eager``), of the graph
    path (``not eager``) or of ``train``'s own choice (None)."""
    if eager is None:
        return trainer.train(epochs=epochs)[1]
    formatter = TrainingMessageFormatter(epochs)
    history = []
    for epoch in range(epochs):
        trainer.sampler.set_epoch(epoch)
        history.append(trainer._train_epoch(formatter, eager=eager)[0])
    return history


# ---------------------------------------------------------------------------
# the schedule's grammar against the JAX package's
# ---------------------------------------------------------------------------

SPECS = [
    "step:3:nan,step:7:stall:0.5,epoch:2:kill@1,net:delay:100,seed:7",
    "step:1:stall",
    "step:1:slow",
    "epoch:0:exc, step:4:kill",
    "prob:0.25:nan,prob:0.5:stall:0.01,seed:3",
    "epoch:1:respawn@2,step:2:preempt@0,epoch:3:slow:0.75",
    "net:loss:0.05,net:flap:0.5",
    "step:2:nan@1",
]


def _events(schedule):
    return [(e.trigger, e.at, e.action, e.arg, e.rank) for e in schedule.events]


@pytest.mark.parametrize("spec", SPECS)
def test_schedule_parses_like_jax(spec):
    ours = FaultSchedule.parse(spec)
    theirs = _jax_faults().FaultSchedule.parse(spec)
    assert _events(ours) == _events(theirs)
    assert ours.network == theirs.network and ours.seed == theirs.seed
    assert str(ours) == str(theirs)
    assert ours.network_env() == theirs.network_env()
    # the string form parses back to the same schedule
    again = FaultSchedule.parse(str(ours))
    assert _events(again) == _events(ours) and again.network == ours.network
    for rank in (None, 0, 1, 2):
        a = ours if rank is None else ours.for_rank(rank)
        b = theirs if rank is None else theirs.for_rank(rank)
        assert a.has_step_events == b.has_step_events
        assert _events(a.for_rejoin()) == _events(b.for_rejoin())
        for step in range(12):
            assert ([str(e) for e in a._matches(("step", "prob"), step)]
                    == [str(e) for e in b._matches(("step", "prob"), step)])
            assert ([str(e) for e in a._matches(("epoch",), step)]
                    == [str(e) for e in b._matches(("epoch",), step)])


@pytest.mark.parametrize("bad", ["step:1:frobnicate", "wibble:1:nan", "step:x:nan",
                                 "net:teleport:1", "step:1"])
def test_bad_specs_raise_like_jax(bad):
    with pytest.raises(ValueError, match="bad fault event|unknown") as ours:
        FaultSchedule.parse(bad)
    with pytest.raises(ValueError) as theirs:
        _jax_faults().FaultSchedule.parse(bad)
    assert str(ours.value) == str(theirs.value)


def test_env_contract_and_network_export_match_jax(monkeypatch):
    for key in ("PDRNN_CHAOS", "PDRNN_FAULT_DELAY_MS", "PDRNN_FAULT_LOSS_PROB"):
        monkeypatch.delenv(key, raising=False)
    assert FaultSchedule.from_env() is None
    assert FaultSchedule.resolve(Namespace(faults=None)) is None
    monkeypatch.setenv("PDRNN_CHAOS", "step:1:nan@1,net:delay:5")
    ours = FaultSchedule.resolve(Namespace(faults=None), rank=1)
    ours_env = {k: os.environ.pop(k) for k in ("PDRNN_FAULT_DELAY_MS",)}
    theirs = _jax_faults().FaultSchedule.resolve(Namespace(faults=None), rank=1)
    theirs_env = {k: os.environ.pop(k) for k in ("PDRNN_FAULT_DELAY_MS",)}
    assert ours.rank == theirs.rank == 1 and _events(ours) == _events(theirs)
    assert ours_env == theirs_env == {"PDRNN_FAULT_DELAY_MS": "5.0"}
    # the flag beats the environment
    assert _events(FaultSchedule.resolve(Namespace(faults="step:2:stall"))) == [
        ("step", 2.0, "stall", 0.25, None)]


def test_slow_latches_once_and_degrades_every_item():
    s = FaultSchedule.parse("step:2:slow:0.5")
    s.on_producer_item(1)
    assert not s.slow_active
    s.on_producer_item(2)
    assert s.slow_active and s.fired == {"slow": 1}
    time.sleep(0.05)
    t0 = time.perf_counter()
    s.on_producer_item(3)
    assert time.perf_counter() - t0 >= 0.02
    assert s.fired == {"slow": 1}


def test_corrupt_batch_fills_features_and_refuses_token_ids():
    s = FaultSchedule.parse("step:1:nan")
    x, y = torch.ones(2, 3), torch.arange(2)
    assert s.corrupt_batch(0, (x, y))[0] is x
    bad, labels = s.corrupt_batch(1, (x, y))
    assert torch.isnan(bad).all() and labels is y and s.fired == {"nan": 1}
    with pytest.raises(ValueError, match="token ids"):
        s.corrupt_batch(1, (torch.zeros(2, 3, dtype=torch.int64), y))
    # the reason: JAX's corrupt_batch casts the NaN into token 0
    tokens = np.arange(6, dtype=np.int32).reshape(2, 3)
    theirs, _ = _jax_faults().FaultSchedule.parse("step:1:nan").corrupt_batch(1, (tokens, y))
    assert np.asarray(theirs).dtype == np.int32 and not np.asarray(theirs).any()
    assert "token 0" in NAN_NEEDS_FLOAT


# ---------------------------------------------------------------------------
# the guarded update
# ---------------------------------------------------------------------------


def _adam_lists(seed, shapes=((3, 5), (7,))):
    """Parameters, gradients, first and second moments (non-negative)."""
    g = torch.Generator().manual_seed(seed)
    lists = [[torch.randn(s, generator=g) for s in shapes] for _ in range(4)]
    lists[3] = [v.abs() for v in lists[3]]
    return lists


@pytest.mark.parametrize("form", ["host", "device"])
def test_guarded_update_gives_the_unguarded_bits_or_nothing(form):
    step = 3 if form == "host" else torch.tensor(3.0, dtype=torch.float64)
    for finite in (True, False):
        plain = _adam_lists(0)
        guarded = _adam_lists(0)
        adam_update_(*plain, step, 1e-3, 0.9, 0.999, 1e-8)
        adam_update_(*guarded, step, 1e-3, 0.9, 0.999, 1e-8, finite=torch.tensor(finite))
        want = plain if finite else _adam_lists(0)
        for ours, theirs in zip(guarded, want):
            for a, b in zip(ours, theirs):
                assert torch.equal(a, b)


def test_verdict_is_per_element():
    big = torch.full((4,), 3e38)  # finite, but its sum overflows
    assert not torch.isfinite(big.sum())
    assert bool(NonFiniteCounters.verdict([big, torch.ones(2)]))
    assert not bool(NonFiniteCounters.verdict([big, torch.tensor([1.0, float("inf")])]))
    assert not bool(NonFiniteCounters.verdict([torch.tensor([float("nan")])]))


def test_guarded_adam_follows_optax_apply_if_finite():
    """A run of steps, some with a NaN or an Inf in one element: the
    guarded ``DeviceStepAdam`` keeps ``apply_if_finite(adam)``'s counters,
    skips the same steps and lands on its parameters (f32 rounding)."""
    import jax
    import jax.numpy as jnp
    import optax

    from pytorch_distributed_rnn_tpu_torch.ops.adam import DeviceStepAdam

    rng = np.random.default_rng(0)
    init = [rng.standard_normal((4, 3)).astype(np.float32),
            rng.standard_normal(5).astype(np.float32)]
    bad_steps = {1: float("nan"), 2: float("inf"), 4: float("nan")}
    grads = []
    for step in range(6):
        g = [rng.standard_normal(p.shape).astype(np.float32) for p in init]
        if step in bad_steps:
            g[1][2] = bad_steps[step]
        grads.append(g)
    opt = optax.apply_if_finite(optax.adam(1e-2), max_consecutive_errors=2**30)
    params = [jnp.asarray(p) for p in init]
    state = opt.init(params)
    ours = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    adam = DeviceStepAdam(ours, lr=1e-2, guarded=True)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        for p, x in zip(ours, g):
            p.grad = torch.from_numpy(x.copy())
        adam.step()
        assert adam.nonfinite.read() == (int(state.notfinite_count), int(state.total_notfinite))
    assert float(adam.device_steps) == 3  # the skipped steps leave the count
    for a, b in zip(ours, params):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert jax is not None


# ---------------------------------------------------------------------------
# the guard in the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eager", [True, False], ids=["per-batch-loop", "graph-path"])
def test_guarded_run_is_bitwise_unguarded_when_finite(motion_arrays, eager):
    plain = _trainer(motion_arrays)
    guarded = _trainer(motion_arrays, max_bad_steps=3)
    assert _train(plain, 2, eager) == _train(guarded, 2, eager)
    _same_params(plain.model, guarded.model)
    assert guarded.optimizer.nonfinite.read() == (0, 0)
    for a, b in zip(plain.optimizer.state_dict()["state"].values(),
                    guarded.optimizer.state_dict()["state"].values()):
        for key in a:
            assert torch.equal(a[key], b[key]), key


class _Recording(Trainer):
    """The local trainer, keeping its parameters after every step."""

    def _optimizer_step(self):
        super()._optimizer_step()
        self.snapshots.append([p.detach().clone() for p in self.model.parameters()])


def _jax_pair(arrays, jax_kw=None, port_kw=None, layers=1, cls=Trainer):
    """A JAX trainer and a port trainer from its initial weights."""
    import jax

    from pytorch_distributed_rnn_tpu.data import MotionDataset as JaxDataset
    from pytorch_distributed_rnn_tpu.models import MotionModel as JaxMotionModel
    from pytorch_distributed_rnn_tpu.training.base import Trainer as JaxTrainer

    jt = JaxTrainer(JaxMotionModel(input_dim=9, hidden_dim=8, layer_dim=layers, output_dim=6),
                    JaxDataset(*arrays), batch_size=48, learning_rate=LR, seed=SEED,
                    **(jax_kw or {}))
    model = MotionModel(input_dim=9, hidden_dim=8, layer_dim=layers, output_dim=6)
    model.load_state_dict(interop.jax_params_to_state_dict(jax.tree.map(np.array, jt.params)))
    trainer = cls(model, MotionDataset(*arrays), batch_size=48, learning_rate=LR, seed=SEED,
                  device="cpu", **(port_kw or {}))
    return jt, trainer


def test_nan_step_skipped_and_counted_like_jax(motion_arrays):
    spec = "step:1:nan"
    jf = _jax_faults().FaultSchedule.parse(spec)
    faults = FaultSchedule.parse(spec)
    jt, trainer = _jax_pair(motion_arrays, {"max_bad_steps": 3, "faults": jf},
                            {"max_bad_steps": 3, "faults": faults}, cls=_Recording)
    trainer.snapshots = []
    _, jax_history, _ = jt.train(epochs=2)
    _, history, _ = trainer.train(epochs=2)
    assert faults.fired == jf.fired == {"nan": 1}
    assert trainer.guard.total_skipped == jt.guard.total_skipped == 1
    assert trainer.optimizer.nonfinite.read() == (int(jt.opt_state.notfinite_count),
                                                 int(jt.opt_state.total_notfinite)) == (0, 1)
    # the skipped step moved nothing, and Adam counted only the applied ones
    assert all(torch.equal(a, b) for a, b in zip(*trainer.snapshots[:2]))
    assert float(trainer.optimizer.device_steps) == len(trainer.snapshots) - 1 == 3
    assert math.isnan(history[0]) and math.isnan(jax_history[0])
    np.testing.assert_allclose(history[1:], jax_history[1:], rtol=HISTORY_RTOL)
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_consecutive_bad_steps_abort_like_jax(motion_arrays):
    spec = "step:1:nan,step:2:nan,step:3:nan"
    jt, trainer = _jax_pair(
        motion_arrays, {"max_bad_steps": 2, "faults": _jax_faults().FaultSchedule.parse(spec)},
        {"max_bad_steps": 2, "faults": FaultSchedule.parse(spec)})
    with pytest.raises(NonFiniteAbort, match="3 consecutive") as ours:
        trainer.train(epochs=3)
    from pytorch_distributed_rnn_tpu.resilience import NonFiniteAbort as JaxAbort

    with pytest.raises(JaxAbort) as theirs:
        jt.train(epochs=3)
    assert str(ours.value) == str(theirs.value)
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_guard_limit_validation():
    with pytest.raises(ValueError, match="limit"):
        NonFiniteGuard(0)


def test_loader_exception_propagates_without_a_thread_leak(motion_arrays):
    trainer = _trainer(motion_arrays, faults=FaultSchedule.parse("step:2:exc"))
    with pytest.raises(ChaosError, match="step 2"):
        trainer.train(epochs=2)
    time.sleep(0.05)
    assert not any(t.name == "pdrnn-prefetch" and t.is_alive() for t in threading.enumerate())


def test_loader_stall_delays_but_keeps_the_bits(motion_arrays):
    faults = FaultSchedule.parse("step:1:stall:0.3,epoch:1:stall:0.01")
    stalled = _trainer(motion_arrays, faults=faults)
    t0 = time.monotonic()
    history = _train(stalled, 2)
    assert time.monotonic() - t0 >= 0.3 and faults.fired == {"stall": 2}
    plain = _trainer(motion_arrays)
    assert _train(plain, 2) == history
    _same_params(plain.model, stalled.model)


class _ThreadWorld:
    """A world of ranks as threads of this process: the collectives of
    ``collectives.World`` the sharded update uses, prescaled sums in rank
    order."""

    def __init__(self, rank, size, board):
        self.rank, self.size, self.board = rank, size, board
        self.device = torch.device("cpu")

    def _exchange(self, tensor):
        self.board["slots"][self.rank] = tensor.detach().clone()
        self.board["barrier"].wait()
        values = [self.board["slots"][r] for r in range(self.size)]
        self.board["barrier"].wait()
        return values

    def reduce_scatter_mean(self, flat):
        values = self._exchange(flat)
        total = values[0] / self.size
        for v in values[1:]:
            total = total + v / self.size
        shard = len(flat) // self.size
        return total[self.rank * shard:(self.rank + 1) * shard]

    def psum_(self, tensors):
        for t in tensors:
            values = self._exchange(t)
            t.copy_(torch.stack(values).sum(dim=0))

    def all_gather(self, shard):
        return torch.cat(self._exchange(shard))


def _run_ranks(fn, world=2, timeout=120):
    results, errors = {}, []

    def run(rank):
        try:
            results[rank] = fn(rank)
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return results


def _grads_with_one_nan(params, rank, step, bad_step=1, bad_rank=1):
    """Every rank's own finite gradients; at ``bad_step`` ``bad_rank`` holds
    one NaN, in the first element, which the reduce-scatter hands to rank
    0's slice alone."""
    for p in params:
        p.grad = torch.full_like(p, 0.01 * (rank + 1) * (step + 1))
    if step == bad_step and rank == bad_rank:
        params[0].grad.view(-1)[0] = float("nan")


def test_sharded_update_takes_one_verdict_for_the_world():
    board = {"slots": {}, "barrier": threading.Barrier(2)}

    def rank_main(rank):
        params = [torch.nn.Parameter(torch.arange(6.0).reshape(2, 3) / 10),
                  torch.nn.Parameter(torch.ones(5))]
        su = ShardedUpdate(Adam(params, lr=0.1), 2, rank, _ThreadWorld(rank, 2, board),
                           guarded=True)
        snapshots = []
        for step in range(3):
            _grads_with_one_nan(params, rank, step)
            su.step()
            snapshots.append([p.detach().clone() for p in params])
        return snapshots, su.nonfinite.read(), float(su.steps)

    results = _run_ranks(rank_main)
    for a, b in zip(results[0][0], results[1][0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    snapshots = results[0][0]
    assert all(torch.equal(x, y) for x, y in zip(snapshots[0], snapshots[1]))  # skipped
    assert not all(torch.equal(x, y) for x, y in zip(snapshots[1], snapshots[2]))
    assert results[0][1:] == results[1][1:] == ((0, 1), 2.0)


def test_native_bucketed_update_takes_one_verdict_over_the_ring(motion_arrays):
    native.build_native_library()
    (port,) = free_ports(1)

    def rank_main(rank):
        with native.Communicator("127.0.0.1", port, rank, 2) as comm:
            model = _model(layers=1, seed=3)
            trainer = native_ddp.NativeDDPTrainer(
                model, MotionDataset(*motion_arrays), 48, LR, seed=SEED, device="cpu",
                comm=comm, bucket_mb=0.001, max_bad_steps=2)
            assert trainer.bucket_plan.num_buckets > 1
            params = list(model.parameters())
            snapshots = []
            for step in range(3):
                _grads_with_one_nan(params, rank, step)
                trainer._optimizer_step()
                snapshots.append(torch.cat([p.detach().reshape(-1) for p in params]))
            return snapshots, trainer.optimizer.nonfinite.read()

    results = _run_ranks(rank_main)
    assert all(torch.equal(a, b) for a, b in zip(results[0][0], results[1][0]))
    assert torch.equal(results[0][0][0], results[0][0][1])
    assert not torch.equal(results[0][0][1], results[0][0][2])
    assert results[0][1] == results[1][1] == (0, 1)


@pytest.fixture(scope="module")
def har_cache(tmp_path_factory):
    work = tmp_path_factory.mktemp("resilience")
    return write_synthetic_har_cache(work / "data", num_train=120, num_test=16, seq_length=12,
                                     split_seed=0), work


def test_world2_ranks_skip_alike_under_both_strategies(har_cache):
    """``step:1:nan@1 --max-bad-steps 2``: only rank 1's batch is NaN; under
    sharded ``distributed`` and bucketed ``distributed-native`` both ranks
    skip the step and end with the same bits."""
    cache, work = har_cache
    argv = ["--device", "cpu", "--dataset-path", str(cache), "--epochs", "2", "--seed", "7",
            "--batch-size", "48", "--hidden-units", "8", "--stacked-layer", "1",
            "--dropout", "0", "--no-validation", "--faults", "step:1:nan@1",
            "--max-bad-steps", "2"]
    root = work / "w2"
    jobs = {"distributed": {"dir": str(root / "distributed"), "argv": [*argv, "distributed"]},
            "native": {"dir": str(root / "native"),
                       "argv": [*argv, "--bucket-mb", "0.001", "distributed-native"],
                       "env": {"MASTER_ADDR": "127.0.0.1",
                               "MASTER_PORT": str(free_ports(1)[0])}}}
    launch.spawn(2, list(jobs.values()), root, device="cpu", timeout=300)
    for name, job in jobs.items():
        ranks = [torch.load(f"{job['dir']}/rank{r}.pt", weights_only=True) for r in range(2)]
        for key, value in ranks[0]["state"].items():
            assert torch.equal(value, ranks[1]["state"][key]), (name, key)
        for rank, result in enumerate(ranks):
            assert any("skipped 1 step(s) (total 1, consecutive 1)" in m for m in result["log"])
            injected = any("chaos: injecting step:1:nan@1" in m for m in result["log"])
            assert injected == (rank == 1), (name, rank)
        assert all(torch.isfinite(v).all() for v in ranks[0]["state"].values())


# ---------------------------------------------------------------------------
# --resume auto
# ---------------------------------------------------------------------------


def test_resume_latest_falls_back_past_corrupt_and_finishes_bitwise(motion_arrays, tmp_path,
                                                                  caplog):
    full = _trainer(motion_arrays, checkpoint_dir=tmp_path, checkpoint_every=1)
    full_history = _train(full, 3)
    latest = tmp_path / "checkpoint-epoch-3.ckpt"
    blob = latest.read_bytes()
    latest.write_bytes(blob[: len(blob) // 2])  # a crash mid-write

    fresh = _trainer(motion_arrays, checkpoint_dir=tmp_path)
    with caplog.at_level(logging.WARNING):
        meta = resume_latest(fresh, tmp_path)
    assert meta["epoch"] == 2 and fresh._start_epoch == 2
    assert any("skipping corrupt checkpoint" in r.getMessage() for r in caplog.records)
    assert _train(fresh, 3) == full_history[2:]
    _same_params(full.model, fresh.model)


def test_resume_latest_none_when_empty(motion_arrays, tmp_path):
    assert resume_latest(_trainer(motion_arrays), tmp_path / "none") is None


def test_advance_epoch_continues_not_retrains(motion_arrays, tmp_path):
    full = _trainer(motion_arrays, checkpoint_dir=tmp_path, checkpoint_every=1)
    full_history = _train(full, 3)
    resumed = _trainer(motion_arrays)
    meta = resumed.resume_from(tmp_path / "checkpoint-epoch-1.ckpt", advance_epoch=True)
    assert meta["epoch"] == 1 and resumed._start_epoch == 1
    assert _train(resumed, 3) == full_history[1:]
    _same_params(full.model, resumed.model)
    # without advance_epoch the run trains its full count again
    again = _trainer(motion_arrays)
    again.resume_from(tmp_path / "checkpoint-epoch-1.ckpt")
    assert again._start_epoch == 0 and len(_train(again, 1)) == 1


def test_checkpoint_carries_the_guard_counters_and_the_dropout_stream(motion_arrays, tmp_path):
    faults = FaultSchedule.parse("step:0:nan")
    run = _trainer(motion_arrays, checkpoint_dir=tmp_path, checkpoint_every=1, max_bad_steps=3,
                   faults=faults)
    _train(run, 1)
    resumed = _trainer(motion_arrays, max_bad_steps=3)
    meta = resumed.resume_from(tmp_path / "checkpoint-epoch-1.ckpt", advance_epoch=True)
    assert meta["trainer"]["nonfinite"] == {"notfinite_count": 0, "total_notfinite": 1}
    assert resumed.optimizer.nonfinite.read() == (0, 1) and resumed.guard.total_skipped == 1
    assert torch.equal(resumed.dropout_generator.get_state(), run.dropout_generator.get_state())
    # a checkpoint of another world size: the masks start fresh
    meta["trainer"]["world"] = 2
    other = _trainer(motion_arrays)
    before = other.dropout_generator.get_state()
    other._restore_trainer_state("ckpt", meta["trainer"])
    assert torch.equal(other.dropout_generator.get_state(), before)


def _cli(cwd, argv):
    here = os.getcwd()
    os.chdir(cwd)
    try:
        trainer = port_main.main(argv)
    finally:
        os.chdir(here)
    return trainer, json.loads((Path(cwd) / "history.json").read_text())


def test_kill_then_resume_auto_matches_uninterrupted_bitwise(tmp_path, caplog):
    """The JAX test's run (120 windows, 96 after the validation split and
    truncation: 2 steps an epoch; batch 48, 3 epochs, checkpoints every
    epoch) with two layers at dropout 0.1: SIGKILLed by ``step:4:kill`` at
    the start of epoch 2, its newest checkpoint truncated, restarted with
    ``--resume auto``: it falls back to epoch 1's checkpoint and ends with
    the uninterrupted run's parameters and losses bit for bit."""
    write_synthetic_har_dataset(tmp_path / "har", num_train=120, num_test=16, seq_length=12)
    base = ["--device", "cpu", "--dataset-path", "har", "--epochs", "3", "--batch-size", "48",
            "--seed", "7", "--hidden-units", "8", "--stacked-layer", "2", "--dropout", "0.1",
            "--checkpoint-every", "1"]
    reference, ref_history = _cli(tmp_path, [*base, "--checkpoint-directory", "models_ref",
                                             "local"])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main", *base,
         "--checkpoint-directory", "models", "--resume", "auto", "--faults", "step:4:kill",
         "local"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert "no usable checkpoint" in proc.stderr and "chaos schedule active" in proc.stderr
    newest, *older = checkpoint_candidates(tmp_path / "models")
    assert [newest.name, *(p.name for p in older)] == [
        "checkpoint-epoch-2.ckpt", "checkpoint-epoch-1.ckpt", "best-model.ckpt"]
    newest.write_bytes(newest.read_bytes()[:100])  # the newest file, torn
    with caplog.at_level(logging.INFO):
        resumed, history = _cli(tmp_path, [*base, "--checkpoint-directory", "models",
                                           "--resume", "auto", "local"])
    messages = [r.getMessage() for r in caplog.records]
    assert any("skipping corrupt checkpoint" in m for m in messages)
    assert any("restored models/checkpoint-epoch-1.ckpt" in m for m in messages)
    assert len(history["validation_history"]) == 2
    assert history["validation_history"] == ref_history["validation_history"][1:]
    assert history["train_history"] == ref_history["train_history"][1:]
    _same_params(reference.model, resumed.model)


# ---------------------------------------------------------------------------
# --grad-accum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [96, 106], ids=["full-batches", "partial-batch"])
def test_grad_accum_matches_jax_and_the_single_shot(n):
    arrays = generate_har_arrays(n, seq_length=12, seed=0)
    jt, trainer = _jax_pair(arrays, {"grad_accum": 4}, {"grad_accum": 4})
    if n == 106:
        assert trainer._microbatches(10) == 2  # the final batch of 10
    _, jax_history, _ = jt.train(epochs=2)
    history = _train(trainer, 2)
    np.testing.assert_allclose(history, jax_history, rtol=HISTORY_RTOL)
    _, single = _jax_pair(arrays)
    np.testing.assert_allclose(history, _train(single, 2), rtol=ACCUM_RTOL)
    for a, b in zip(trainer.model.parameters(), single.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=1e-6)


def test_grad_accum_char_lm_matches_jax():
    import jax

    from pytorch_distributed_rnn_tpu.data.text import TextDataset as JaxText
    from pytorch_distributed_rnn_tpu.models import CharRNN as JaxCharRNN
    from pytorch_distributed_rnn_tpu.training.base import Trainer as JaxTrainer
    from pytorch_distributed_rnn_tpu.training.lm import wrap_lm_trainer as jax_wrap

    windows = generate_char_tokens(90, 12, 256, seed=1)  # 2 batches of 40 and one of 10
    kw = dict(batch_size=40, learning_rate=5e-3, seed=SEED, grad_accum=4)
    jt = jax_wrap(JaxTrainer)(JaxCharRNN(vocab_size=256, embed_dim=12, hidden_dim=12,
                                         layer_dim=2), JaxText(windows), **kw)
    model = CharRNN(vocab_size=256, embed_dim=12, hidden_dim=12, layer_dim=2)
    model.load_state_dict(interop.jax_params_to_state_dict(jax.tree.map(np.array, jt.params)))
    trainer = wrap_lm_trainer(Trainer)(model, TextDataset(windows), device="cpu", **kw)
    _, jax_history, _ = jt.train(epochs=2)
    np.testing.assert_allclose(_train(trainer, 2), jax_history, rtol=HISTORY_RTOL)


def test_grad_accum_needs_a_dividing_batch(motion_arrays):
    with pytest.raises(ValueError, match="not divisible by grad_accum 5"):
        _trainer(motion_arrays, grad_accum=5)


class _FakeComm:
    rank, world_size = 0, 1

    def broadcast(self, data, root=0):
        return data


@pytest.mark.parametrize("strategy", ["DDPTrainer", "HorovodTrainer", "NativeDDPTrainer",
                                      "ParameterServerWorkerTrainer"])
def test_grad_accum_refused_where_jax_refuses_it(motion_arrays, strategy):
    from pytorch_distributed_rnn_tpu_torch.param_server.worker import (
        ParameterServerWorkerTrainer,
    )
    from pytorch_distributed_rnn_tpu_torch.training import DDPTrainer, HorovodTrainer

    classes = {"DDPTrainer": DDPTrainer, "HorovodTrainer": HorovodTrainer,
               "NativeDDPTrainer": native_ddp.NativeDDPTrainer,
               "ParameterServerWorkerTrainer": ParameterServerWorkerTrainer}
    jax_modules = {"DDPTrainer": "training.distributed", "HorovodTrainer": "training.distributed",
                   "NativeDDPTrainer": "training.native_ddp",
                   "ParameterServerWorkerTrainer": "param_server.worker"}
    import importlib

    jax_cls = getattr(importlib.import_module(
        f"pytorch_distributed_rnn_tpu.{jax_modules[strategy]}"), strategy)
    assert jax_cls.SUPPORTS_GRAD_ACCUM is False and classes[strategy].SUPPORTS_GRAD_ACCUM is False
    kwargs = {"comm": _FakeComm()}
    if strategy in ("DDPTrainer", "HorovodTrainer"):
        kwargs = {"group": Namespace(device=torch.device("cpu"), rank=0, size=1)}
    with pytest.raises(NotImplementedError) as ours:
        classes[strategy](_model(), MotionDataset(*motion_arrays), batch_size=48,
                          learning_rate=LR, device="cpu", grad_accum=2, **kwargs)
    # JAX's message, from its base trainer's check
    assert str(ours.value) == (f"{strategy} builds its train step outside _make_grad_step "
                               "and does not support grad_accum > 1")


# ---------------------------------------------------------------------------
# --remat
# ---------------------------------------------------------------------------


def _saved_bytes(model, x, generator):
    """The bytes autograd keeps for the backward of one forward."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x, generator)
    return total[0]


def _remat_models(family, impl, remat):
    g = torch.Generator().manual_seed(4)
    if family in ("lstm", "gru"):
        return MotionModel(input_dim=9, hidden_dim=8, layer_dim=2, output_dim=6, cell=family,
                           impl=impl, dropout=0.1, remat=remat, generator=g)
    if family == "char":
        return CharRNN(vocab_size=256, embed_dim=8, hidden_dim=8, layer_dim=2, impl=impl,
                       dropout=0.1, remat=remat, generator=g)
    return AttentionClassifier(input_dim=9, dim=16, depth=2, num_heads=2, output_dim=6,
                               dropout=0.1, impl=impl, remat=remat, generator=g)


@pytest.mark.parametrize("family,impl", [("lstm", "scan"), ("lstm", "fused"), ("gru", "scan"),
                                         ("gru", "fused"), ("char", "fused"),
                                         ("attention", "dense"), ("attention", "flash")])
def test_remat_is_bitwise_plain_with_dropout(family, impl):
    runs = []
    for remat in (False, True):
        model = _remat_models(family, impl, remat)
        if family == "char":
            data = TextDataset(generate_char_tokens(70, 10, 256, seed=1))
            trainer = wrap_lm_trainer(Trainer)(model, data, batch_size=32, learning_rate=5e-3,
                                               seed=SEED, device="cpu")
        else:
            trainer = Trainer(model, MotionDataset(*generate_har_arrays(100, seq_length=12,
                                                                        seed=2)),
                              batch_size=48, learning_rate=LR, seed=SEED, device="cpu")
        runs.append((_train(trainer, 2), trainer))
    assert runs[0][0] == runs[1][0]
    _same_params(runs[0][1].model, runs[1][1].model)
    # the remat model keeps less for its backward
    plain, remat = (t.model.train() for _, t in runs)
    x = (torch.from_numpy(np.asarray(runs[0][1].training_set.features[:8]))
         if family != "char" else torch.from_numpy(generate_char_tokens(8, 10, 256, seed=3)))
    assert (_saved_bytes(remat, x, torch.Generator().manual_seed(0))
            < _saved_bytes(plain, x, torch.Generator().manual_seed(0)))


# ---------------------------------------------------------------------------
# --faults under parameter-server
# ---------------------------------------------------------------------------


def _ps_world(make_model, training_set, faults=None):
    """A sync world of the master and one worker as threads (the port's
    transport); the worker runs ``faults``."""
    from pytorch_distributed_rnn_tpu_torch.param_server.master import ParameterServerMaster
    from pytorch_distributed_rnn_tpu_torch.param_server.runner import FlatAdam, flat_parameters
    from pytorch_distributed_rnn_tpu_torch.param_server.worker import (
        ParameterServerWorkerTrainer,
    )

    native.build_native_library()
    (port,) = free_ports(1)

    def rank_main(rank):
        with native.Communicator("127.0.0.1", port, rank, 2) as comm:
            if rank == 0:
                update = FlatAdam(flat_parameters(make_model()), LR, "cpu")
                return ParameterServerMaster(comm, update.host, update, sync_mode=True,
                                             sync_timeout=60.0).serve().clone()
            trainer = ParameterServerWorkerTrainer(make_model(), training_set, 48, LR,
                                                   comm=comm, worker_rank=1, num_workers=1,
                                                   seed=SEED, device="cpu", faults=faults)
            _, history, _ = trainer.train(epochs=2)
            trainer.finish()
            return history

    return _run_ranks(rank_main)


def test_ps_worker_stall_delays_but_keeps_the_bits(motion_arrays):
    train = MotionDataset(*motion_arrays)
    faults = FaultSchedule.parse("step:1:stall:0.3")
    t0 = time.monotonic()
    stalled = _ps_world(lambda: _model(layers=1), train, faults)
    assert time.monotonic() - t0 >= 0.3 and faults.fired == {"stall": 1}
    plain = _ps_world(lambda: _model(layers=1), train)
    assert stalled[1] == plain[1] and torch.equal(stalled[0], plain[0])


class _PushRecorder:
    """A worker's transport that answers every request with the current
    parameters and records the gradients pushed."""

    world_size = 2

    def __init__(self, flat):
        self.flat, self.pushes, self._pending = flat, [], None

    def send(self, dst, data):
        data = torch.as_tensor(data)
        if self._pending is not None:
            self.pushes.append(data.clone())
            self._pending = None
        elif int(data[0]) == 2:  # a PUSH header: its gradient follows
            self._pending = data

    def recv(self, src, shape, dtype=torch.float32, out=None):
        return self.flat.clone()


def test_ps_nan_push_is_refused_by_the_master_as_jax_refuses_it(motion_arrays):
    from collections import deque

    from pytorch_distributed_rnn_tpu.param_server.master import (
        ParameterServerMaster as JaxMaster,
    )
    from pytorch_distributed_rnn_tpu_torch.param_server.master import ParameterServerMaster
    from pytorch_distributed_rnn_tpu_torch.param_server.runner import flat_parameters
    from pytorch_distributed_rnn_tpu_torch.param_server.worker import (
        ParameterServerWorkerTrainer,
    )

    model = _model(layers=1)
    comm = _PushRecorder(flat_parameters(model))
    worker = ParameterServerWorkerTrainer(model, MotionDataset(*motion_arrays), 48, LR,
                                          comm=comm, worker_rank=1, num_workers=1, seed=SEED,
                                          device="cpu", faults=FaultSchedule.parse("step:1:nan"))
    worker.train(epochs=1)
    assert len(comm.pushes) == 2
    assert torch.isfinite(comm.pushes[0]).all() and torch.isnan(comm.pushes[1]).all()
    nan_push = comm.pushes[1]
    n = nan_push.numel()

    class Scripted:
        world_size = 2

        def __init__(self, inbox):
            self.inbox = deque(inbox)

        def recv(self, src, shape, dtype=None):
            return self.inbox.popleft().reshape(shape)

        def send(self, dst, data):
            pass

    header = torch.tensor([2.0, 1.0])
    ours = ParameterServerMaster(Scripted([header, nan_push]), torch.zeros(n), lambda g: g)
    with pytest.raises(RuntimeError, match="non-finite"):
        ours._serve_worker(1)
    theirs = JaxMaster(Scripted([header.numpy(), nan_push.numpy()]), np.zeros(n, np.float32),
                       lambda g: g)
    with pytest.raises(AssertionError, match="non-finite"):
        theirs._serve_worker(1)


@pytest.mark.parametrize("spec,refused", [("epoch:1:respawn@1", "respawn"),
                                          ("step:2:preempt", "preempt")])
def test_ps_refuses_the_fault_actions_of_the_elastic_roster(spec, refused):
    with pytest.raises(SystemExit, match=f"--faults {refused}: .*elastic half of ROADMAP A7"):
        port_main.main(["--device", "cpu", "--faults", spec, "parameter-server"])


def test_ps_max_bad_steps_warns_and_changes_nothing(caplog):
    from pytorch_distributed_rnn_tpu_torch.param_server import runner

    with caplog.at_level(logging.WARNING):
        with pytest.raises(SystemExit, match="outside the world"):
            runner.run(Namespace(world_size=2, max_bad_steps=2, log="INFO", faults=None,
                                 rank=5))
    assert any("--max-bad-steps has no effect under the parameter-server" in r.getMessage()
               for r in caplog.records)


# ---------------------------------------------------------------------------
# the CLI and the launch helpers
# ---------------------------------------------------------------------------


def test_cli_accepts_the_five_flags():
    args = port_main.build_parser().parse_args(
        ["--max-bad-steps", "2", "--faults", "step:1:nan", "--resume", "auto",
         "--grad-accum", "4", "--remat", "local"])
    port_main.reject_unported(args)  # no SystemExit
    for flags in (["--checkpoint-format", "sharded"], ["--checkpoint-async"]):
        with pytest.raises(SystemExit, match="not ported yet"):
            port_main.reject_unported(port_main.build_parser().parse_args([*flags, "local"]))


def test_cli_refuses_nan_faults_for_the_char_lm(tmp_path):
    with pytest.raises(SystemExit, match="token ids"):
        port_main.main(["--device", "cpu", "--model", "char", "--dataset-path",
                        str(tmp_path / "no-corpus"), "--seq-length", "8", "--hidden-units", "8",
                        "--epochs", "1", "--faults", "step:0:nan", "local"])


def test_launch_helpers_need_a_device(tmp_path):
    with pytest.raises(TypeError, match="device"):
        launch.spawn(2, [], tmp_path)
    with pytest.raises(TypeError, match="device"):
        native_ddp.launch_world(2, ["--epochs", "1"])
