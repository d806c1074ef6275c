"""The port's ``distributed-native`` strategy: data parallelism over its
TCP ring (``training/native_ddp.py``), against the JAX package's
``NativeDDPTrainer`` and within the port.

The setup is the JAX package's own (``tests/test_bucketed_comm.py``): the
motion classifier at H=8, one layer, T=12, 96 training windows, batch 48,
2 epochs, from the JAX trainer's initial weights carried over by
``interop``.  The bars:

- against JAX at world 1 (in process, both on a world-1 ring; the LSTM and
  ``--cell gru``) and at world 2 (JAX's two ranks as two threads of this
  process, each on its own JAX ring communicator; the port's as a spawned
  world): histories and final parameters within rtol 1e-4 (``PERF.md``
  §2);
- within the port, bit for bit: bucketed (three buckets at ``--bucket-mb
  1e-3``, one-element buckets) equals monolithic (``--no-bucketed-comm``)
  equals replicated (``--no-sharded-update``), and every rank equals rank
  0.

The world-2 port runs are one spawned world (``parallel/launch.py``) that
runs every CLI job in turn, each on a ring of its own port.  JAX is
imported where a test uses it, so the ``cuda`` cases also run on a card
without it (``python -m pytest --noconftest -m cuda``).
"""

import json
import os
import re
import threading

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import MotionDataset, write_synthetic_har_cache
from pytorch_distributed_rnn_tpu_torch.models import MotionModel
from pytorch_distributed_rnn_tpu_torch.parallel import launch
from pytorch_distributed_rnn_tpu_torch.runtime.native import Communicator
from pytorch_distributed_rnn_tpu_torch.training import native_ddp
from pytorch_distributed_rnn_tpu_torch.training.base import FUSE_RUN_UNFUSABLE
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from pytorch_distributed_rnn_tpu_torch.training.native_ddp import NativeDDPTrainer
from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports

SEED = 123456789
LR = 2.5e-3
EPOCHS = 2
JAX_RTOL = 1e-4
FLAVOURS = {  # name: the CLI flags, and the trainer's arguments
    "bucketed": (["--bucket-mb", "1e-3"], dict(bucket_mb=1e-3)),
    "one-element": (["--bucket-mb", "1e-9"], dict(bucket_mb=1e-9)),
    "monolithic": (["--no-bucketed-comm"], dict(bucketed_comm=False)),
    "replicated": (["--no-sharded-update"], dict(sharded_update=False)),
}
PARAM_RE = re.compile(r"(\d+): parameters: (-?[\d.]+)")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("native")


@pytest.fixture(scope="module")
def data(work):
    """The HAR cache (96 training windows of T=12) and its training arrays."""
    cache = write_synthetic_har_cache(work / "data", num_train=120, num_test=16, seq_length=12,
                                      split_seed=0)
    train = MotionDataset.load(cache)[0]
    assert len(train) == 96
    return cache, (train.features, train.labels)


def _jax_trainer(comm, arrays, cell="lstm", **kw):
    from pytorch_distributed_rnn_tpu.data import MotionDataset as JaxDataset
    from pytorch_distributed_rnn_tpu.models import MotionModel as JaxMotionModel
    from pytorch_distributed_rnn_tpu.training.native_ddp import NativeDDPTrainer as JaxNative

    return JaxNative(comm=comm, model=JaxMotionModel(input_dim=9, hidden_dim=8, layer_dim=1,
                                                     output_dim=6, cell=cell),
                     training_set=JaxDataset(*arrays), batch_size=48, learning_rate=LR,
                     seed=SEED, bucket_mb=1e-3, **kw)


def _jax_params(trainer):
    import jax

    return jax.tree.map(np.array, trainer.params)


@pytest.fixture(scope="module")
def jax_world1(data):
    """JAX's trainer at world 1 for each cell: its initial parameters (the
    port's too), history and final parameters."""
    from pytorch_distributed_rnn_tpu.runtime.native import Communicator as JaxCommunicator

    runs = {}
    for cell in ("lstm", "gru"):
        with JaxCommunicator(world_size=1) as comm:
            trainer = _jax_trainer(comm, data[1], cell)
            init = interop.jax_params_to_state_dict(_jax_params(trainer))
            _, history, _ = trainer.train(epochs=EPOCHS)
            runs[cell] = (init, history, _jax_params(trainer))
    return runs


@pytest.fixture(scope="module")
def jax_world2(data):
    """JAX's world of 2: each rank a thread of this process with its own
    ring communicator."""
    from pytorch_distributed_rnn_tpu.runtime.native import Communicator as JaxCommunicator

    (port,) = free_ports(1)
    results, errors = {}, []

    def rank_main(rank):
        try:
            with JaxCommunicator("127.0.0.1", port, rank, 2) as comm:
                trainer = _jax_trainer(comm, data[1])
                _, history, _ = trainer.train(epochs=EPOCHS)
                results[rank] = (history, _jax_params(trainer))
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=rank_main, args=(rank,)) for rank in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and len(results) == 2, errors
    return results


def _port_trainer(arrays, init, cell="lstm", comm=None, **kw):
    model = MotionModel(input_dim=9, hidden_dim=8, layer_dim=1, output_dim=6, cell=cell)
    model.load_state_dict(init)
    return NativeDDPTrainer(model, MotionDataset(*arrays), 48, LR, seed=SEED, device="cpu",
                            comm=comm or Communicator(), **kw)


@pytest.fixture(scope="module")
def port_world1(data, jax_world1):
    """The port's trainer at world 1, every cell and flavour, in process."""
    runs = {}
    for cell in ("lstm", "gru"):
        init = jax_world1[cell][0]
        for name, (_, kw) in FLAVOURS.items():
            trainer = _port_trainer(data[1], init, cell, **kw)
            _, history, _ = trainer.train(epochs=EPOCHS)
            runs[cell, name] = (trainer, history)
    return runs


def _argv(cache, *extra, epochs=EPOCHS, resume=None):
    return ["--device", "cpu", "--dataset-path", str(cache), "--epochs", str(epochs),
            "--seed", str(SEED), "--batch-size", "48", "--hidden-units", "8",
            "--stacked-layer", "1", "--dropout", "0", "--learning-rate", str(LR),
            "--checkpoint-directory", "models",
            *(["--resume", str(resume)] if resume else []), *extra, "distributed-native"]


def _family_argv(work, family, cache):
    flags = {"char": ["--model", "char", "--seq-length", "16", "--hidden-units", "16",
                      "--batch-size", "32", "--dataset-path", str(work / "no-corpus")],
             "attention": ["--model", "attention", "--hidden-units", "16", "--num-heads", "2",
                           "--batch-size", "48", "--dataset-path", str(cache)]}[family]
    return ["--device", "cpu", "--epochs", "2", "--seed", "3", "--dropout", "0",
            "--stacked-layer", "2", "--no-validation", *flags, "distributed-native"]


@pytest.fixture(scope="module")
def world2(work, data, jax_world1):
    """One spawned world of 2 ranks running every job in turn: the four
    flavours from JAX's initial weights, a sharded run that checkpoints
    every epoch (with validation), its epoch-1 checkpoint resumed for an
    epoch sharded and replicated, and the char and attention families."""
    cache, _ = data
    model = MotionModel(hidden_dim=8, layer_dim=1)
    model.load_state_dict(jax_world1["lstm"][0])
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    save_checkpoint(work / "init", -1, model.state_dict(), opt.state_dict(), float("inf"))
    init = work / "init" / "checkpoint-epoch-0.ckpt"
    root = work / "w2"
    jobs = {name: {"dir": str(root / name), "argv": _argv(cache, "--no-validation", *flags,
                                                          resume=init)}
            for name, (flags, _) in FLAVOURS.items()}
    jobs["checkpointed"] = {"dir": str(root / "checkpointed"),
                            "argv": _argv(cache, "--checkpoint-every", "1", resume=init)}
    checkpoint = root / "checkpointed" / "rank0" / "models" / "checkpoint-epoch-1.ckpt"
    for name in ("sharded", "replicated"):
        flags = ["--no-sharded-update"] if name == "replicated" else []
        jobs[f"resumed-{name}"] = {"dir": str(root / f"resumed-{name}"),
                                   "argv": _argv(cache, "--no-validation", *flags, epochs=1,
                                                 resume=checkpoint)}
    for family in ("char", "attention"):
        jobs[family] = {"dir": str(root / family), "argv": _family_argv(work, family, cache)}
    for job, port in zip(jobs.values(), free_ports(len(jobs))):
        job["env"] = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    launch.spawn(2, list(jobs.values()), root, device="cpu", timeout=300)
    return jobs, checkpoint


def _results(job, world=2):
    ranks = [torch.load(f"{job['dir']}/rank{r}.pt", weights_only=True) for r in range(world)]
    history_path = f"{job['dir']}/rank0/history.json"
    history = json.load(open(history_path)) if os.path.exists(history_path) else None
    return ranks, history


def _assert_same_bits(a: dict, b: dict):
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def _assert_close_to_jax(state, history, jax_history, jax_params):
    import jax

    np.testing.assert_allclose(history, jax_history, rtol=JAX_RTOL)
    final = interop.state_dict_to_jax_params(state)
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(jax_params), strict=True):
        np.testing.assert_allclose(a, b, rtol=JAX_RTOL, atol=1e-5)


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flavour", list(FLAVOURS))
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_world1_matches_jax_native_trainer(port_world1, jax_world1, cell, flavour):
    trainer, history = port_world1[cell, flavour]
    _, jax_history, jax_params = jax_world1[cell]
    _assert_close_to_jax(trainer.model.state_dict(), history, jax_history, jax_params)


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_world2_matches_jax_native_trainer(world2, jax_world2, flavour):
    jobs, _ = world2
    ranks, history = _results(jobs[flavour])
    jax_history, jax_params = jax_world2[0]
    _assert_close_to_jax(ranks[0]["state"], history["train_history"], jax_history, jax_params)


# ---------------------------------------------------------------------------
# within the port, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_world1_flavours_are_bitwise_equal(port_world1, cell):
    base, base_history = port_world1[cell, "monolithic"]
    assert base.bucket_plan is None
    plans = {name: port_world1[cell, name][0].bucket_plan for name in ("bucketed", "one-element")}
    assert plans["bucketed"].num_buckets > 1
    assert plans["one-element"].num_buckets == plans["one-element"].shard
    for name in FLAVOURS:
        trainer, history = port_world1[cell, name]
        assert history == base_history, name
        _assert_same_bits(trainer.model.state_dict(), base.model.state_dict())
        if trainer.sharded_update:
            assert torch.equal(trainer.optimizer.exp_avg_sq, base.optimizer.exp_avg_sq)


def test_world2_flavours_and_ranks_are_bitwise_equal(world2):
    jobs, _ = world2
    base, base_history = _results(jobs["monolithic"])
    for name in FLAVOURS:
        ranks, history = _results(jobs[name])
        assert history == base_history, name
        for result in ranks:
            _assert_same_bits(result["state"], base[0]["state"])
            assert result["steps"] == EPOCHS * 2  # 48 rows a rank, 24 a step


@pytest.mark.parametrize("family", ["char", "attention"])
def test_other_families_keep_rank_parity(world2, family):
    jobs, _ = world2
    ranks, history = _results(jobs[family])
    _assert_same_bits(ranks[1]["state"], ranks[0]["state"])
    assert len(history["train_history"]) == 2
    assert all(np.isfinite(history["train_history"]))
    sums = [[m for m in r["log"] if PARAM_RE.fullmatch(m)] for r in ranks]
    assert [PARAM_RE.fullmatch(s[0]).group(1) for s in sums] == ["0", "1"]
    assert sums[0][0].split(": ")[-1] == sums[1][0].split(": ")[-1]


def test_only_rank0_evaluates_and_writes(world2):
    jobs, _ = world2
    job = jobs["checkpointed"]
    ranks, history = _results(job)
    assert sorted(os.listdir(f"{job['dir']}/rank0/models")) == [
        "best-model.ckpt", "checkpoint-epoch-1.ckpt", "checkpoint-epoch-2.ckpt"]
    assert os.listdir(f"{job['dir']}/rank1") == []
    assert len(history["validation_history"]) == EPOCHS
    for rank, result in enumerate(ranks):
        perf = [m for m in result["log"] if "Memory Usage" in m]
        assert len(perf) == 1 and perf[0].startswith(f"{rank}: ")
        evaluations = [m for m in result["log"] if "Evaluation" in m]
        assert len(evaluations) == (EPOCHS + 1 if rank == 0 else 0)
        assert len(result["comm"]) == result["steps"]
        assert all(wait >= 0.0 and active >= 0.0 for wait, active in result["comm"])


def test_sharded_checkpoint_resumes_bitwise_replicated_and_loads_in_local(world2, data,
                                                                          tmp_path):
    jobs, checkpoint = world2
    sharded, h_sharded = _results(jobs["resumed-sharded"])
    replicated, h_replicated = _results(jobs["resumed-replicated"])
    assert h_sharded == h_replicated
    _assert_same_bits(sharded[0]["state"], replicated[0]["state"])
    _assert_same_bits(sharded[1]["state"], sharded[0]["state"])

    model_state, opt_state, meta = load_checkpoint(checkpoint)
    assert meta["epoch"] == 1
    assert sorted(opt_state["state"]) == list(range(len(model_state)))
    trainer = port_main.main(["--device", "cpu", "--dataset-path", str(data[0]), "--epochs", "0",
                              "--hidden-units", "8", "--stacked-layer", "1",
                              "--checkpoint-directory", str(tmp_path), "--resume",
                              str(checkpoint), "local"])
    _assert_same_bits(trainer.model.state_dict(), model_state)
    loaded = trainer.optimizer.state_dict()["state"]
    for i, state in opt_state["state"].items():
        assert float(state["step"]) == 2  # one epoch of 2 steps
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(loaded[i][key], state[key]), (i, key)


# ---------------------------------------------------------------------------
# the wire: what rides the ring a step
# ---------------------------------------------------------------------------


class _Handle:
    def __init__(self, result):
        self.result = result
        self.comm_seconds = 0.0


class _RecordingComm:
    """A world of ``world_size`` seen from rank 0, recording each
    collective as ``(method, dtype, nbytes)``; the other ranks contribute
    nothing.  It also checks that the ring is never handed the storage of
    a parameter or of a gradient."""

    def __init__(self, world_size):
        self.rank = 0
        self.world_size = world_size
        self.calls = []
        self.model = None

    def _rec(self, method, data):
        if self.model is not None:
            owned = {p.untyped_storage().data_ptr() for p in self.model.parameters()}
            owned |= {p.grad.untyped_storage().data_ptr() for p in self.model.parameters()
                      if p.grad is not None}
            assert data.untyped_storage().data_ptr() not in owned, method
        self.calls.append((method, str(data.dtype), data.numel() * data.element_size()))

    def broadcast(self, data, root=0):
        self._rec("broadcast", data)
        return data

    def allreduce(self, data, op="sum"):
        self._rec("allreduce", data)
        return data

    def reduce_scatter_async(self, data, op="sum", out=None):
        self._rec("reduce_scatter", data)
        return _Handle(data[: data.numel() // self.world_size].clone())

    def allgather_async(self, data, out=None):
        self._rec("allgather", data)
        return _Handle(torch.stack([data] * self.world_size))

    def wait(self, handle):
        return handle.result


def _recorded(data, sharded: bool, world: int = 4):
    comm = _RecordingComm(world)
    model = MotionModel(input_dim=9, hidden_dim=8, layer_dim=1, output_dim=6)
    trainer = NativeDDPTrainer(model, MotionDataset(*data[1]), 48, LR, seed=SEED, device="cpu",
                               comm=comm, sharded_update=sharded)
    comm.model = trainer.model
    trainer.train(epochs=1)
    return trainer, comm


def test_sharded_step_wire_bytes_are_reduce_scatter_plus_allgather(data):
    trainer, comm = _recorded(data, sharded=True)
    su = trainer.optimizer
    assert su.size == 662 and su.size % comm.world_size != 0 and su.padded == 664
    broadcasts = [c for c in comm.calls if c[0] == "broadcast"]
    steps = [c for c in comm.calls if c[0] != "broadcast"]
    assert broadcasts == [("broadcast", "torch.float32", su.size * 4)]
    assert len(steps) == 4  # two steps
    assert steps == [("reduce_scatter", "torch.float32", su.padded * 4),
                     ("allgather", "torch.float32", su.shard * 4)] * 2


def test_replicated_step_wire_bytes_are_one_full_allreduce(data):
    trainer, comm = _recorded(data, sharded=False)
    broadcasts = [c for c in comm.calls if c[0] == "broadcast"]
    steps = [c for c in comm.calls if c[0] != "broadcast"]
    assert broadcasts == [("broadcast", "torch.float32", 662 * 4)]
    assert steps == [("allreduce", "torch.float32", 662 * 4)] * 2


def test_bucketed_step_wire_bytes_sum_to_monolithic(data):
    comm = _RecordingComm(4)
    model = MotionModel(input_dim=9, hidden_dim=8, layer_dim=1, output_dim=6)
    trainer = NativeDDPTrainer(model, MotionDataset(*data[1]), 48, LR, seed=SEED, device="cpu",
                               comm=comm, bucket_mb=1e-4)
    trainer.train(epochs=1)
    plan = trainer.bucket_plan
    assert plan.num_buckets > 1
    step = [c for c in comm.calls if c[0] != "broadcast"][: 2 * plan.num_buckets]
    assert [c[2] for c in step if c[0] == "reduce_scatter"] == [
        plan.rs_bytes(b) for b in range(plan.num_buckets)]
    assert [c[2] for c in step if c[0] == "allgather"] == [
        plan.ag_bytes(b) for b in range(plan.num_buckets)]
    assert [c[0] for c in step[:plan.num_buckets]] == ["reduce_scatter"] * plan.num_buckets


# ---------------------------------------------------------------------------
# the CLI and what it rejects
# ---------------------------------------------------------------------------


def test_cli_world2_over_launch_world_keeps_rank_parity(work, data):
    cache, _ = data
    directory = work / "launched"
    directory.mkdir()
    # launch_world adds --device cpu and the subcommand
    results = native_ddp.launch_world(2, _argv(cache, "--no-validation")[2:-1], device="cpu",
                                     cwd=directory)
    assert len(results) == 2
    sums = {}
    for code, _, err in results:
        assert code == 0
        (rank, value), = PARAM_RE.findall(err)
        assert re.search(rf"{rank}: Memory Usage: [\d.]+, Training Duration: [\d.]+", err)
        sums[rank] = value
    assert sums["0"] == sums["1"]
    assert len(json.loads((directory / "history.json").read_text())["train_history"]) == 2


@pytest.mark.parametrize("flags,reason", [
    (["--fuse-run", "--no-validation"], native_ddp.FUSE_RUN_REJECTED),
    (["--checkpoint-format", "sharded"], native_ddp.CHECKPOINT_SHARDED_REJECTED),
    (["--checkpoint-async"], native_ddp.CHECKPOINT_ASYNC_REJECTED),
    (["--model", "moe"], "not ported yet"),
])
def test_cli_rejects(data, flags, reason, monkeypatch, tmp_path):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    argv = _argv(data[0], *flags)
    with pytest.raises(SystemExit, match=re.escape(reason)):
        port_main.main(argv)


def test_trainer_rejects_what_jax_rejects(data, jax_world1):
    init = jax_world1["lstm"][0]
    with pytest.raises(ValueError, match="--checkpoint-format sharded"):
        _port_trainer(data[1], init, checkpoint_format="sharded")
    with pytest.raises(ValueError, match="--checkpoint-async"):
        _port_trainer(data[1], init, checkpoint_async=True)
    with pytest.raises(ValueError, match=re.escape(FUSE_RUN_UNFUSABLE)):
        _port_trainer(data[1], init, fuse_run=True).train(epochs=1)


def test_cli_world1_without_a_launcher(data, monkeypatch, tmp_path):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    trainer = port_main.main(_argv(data[0], "--no-validation", "--bucket-mb", "1e-3"))
    assert type(trainer) is NativeDDPTrainer and trainer.world_size == 1
    assert trainer.bucket_plan.num_buckets == 3 and trainer.device.type == "cpu"
    assert len(json.loads((tmp_path / "history.json").read_text())["train_history"]) == EPOCHS


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the pinned staging and the CUDA kernels have no "
                    "CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_cuda_flavours_are_bitwise_equal_through_pinned_staging(cuda_device):
    generator = torch.Generator().manual_seed(0)
    arrays = (torch.randn(96, 12, 9, generator=generator).numpy(),
              torch.randint(0, 6, (96, 1), generator=generator).numpy())
    init = MotionModel(input_dim=9, hidden_dim=8, layer_dim=1, output_dim=6).state_dict()
    runs = {}
    for name, (_, kw) in FLAVOURS.items():
        model = MotionModel(input_dim=9, hidden_dim=8, layer_dim=1, output_dim=6)
        model.load_state_dict(init)
        trainer = NativeDDPTrainer(model, MotionDataset(*arrays), 48, LR, seed=SEED,
                                   device=cuda_device, comm=Communicator(), **kw)
        _, history, _ = trainer.train(epochs=EPOCHS)
        runs[name] = (history, {k: v.cpu() for k, v in trainer.model.state_dict().items()})
        assert all(buf.is_pinned() for buf in trainer._pinned.values())
    for name, (history, state) in runs.items():
        assert history == runs["monolithic"][0], name
        _assert_same_bits(state, runs["monolithic"][1])
