"""The port's data-parallel strategies, ``distributed`` (DDP) and
``horovod``, one spawned process a rank over gloo on the CPU.

Every run starts from the JAX trainer's initial parameters, carried by
``interop`` into a port checkpoint that the CLI resumes from, on the same
HAR windows (hidden 16, 2 layers, T=24, batch 48, 192 train windows).
Each world size is spawned once (``parallel/launch.py``), and runs every
configuration in turn.  The bars:

- against the JAX ``DDPTrainer``/``HorovodTrainer`` on ``make_mesh({"dp":
  W})``: 2-epoch histories within rtol 1e-4 (``PERF.md`` §2), final
  parameters within 1e-4;
- against the port's ``local`` trainer from the same weights on the same
  global batches: 1e-5 (the bars of ``tests/test_training.py``);
- ``--sharded-update`` against ``--no-sharded-update``, and every rank
  against rank 0: bit for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pytorch_distributed_rnn_tpu.data import MotionDataset as JaxDataset
from pytorch_distributed_rnn_tpu.evaluation.analysis import PERF_LINE_RE
from pytorch_distributed_rnn_tpu.models import MotionModel as JaxMotionModel
from pytorch_distributed_rnn_tpu.parallel import make_mesh
from pytorch_distributed_rnn_tpu.training import DDPTrainer as JaxDDPTrainer
from pytorch_distributed_rnn_tpu.training import HorovodTrainer as JaxHorovodTrainer
from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import MotionDataset, write_synthetic_har_cache
from pytorch_distributed_rnn_tpu_torch.models import MotionModel
from pytorch_distributed_rnn_tpu_torch.ops.adam import DeviceStepAdam
from pytorch_distributed_rnn_tpu_torch.parallel import collectives, launch
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

SEED = 123456789
HISTORY_RTOL = 1e-4  # port against JAX
LOCAL_TOL = 1e-5  # port against port
FLAVOURS = ("distributed", "horovod")
SHARDING = ("--sharded-update", "--no-sharded-update")
JAX_TRAINERS = {"distributed": JaxDDPTrainer, "horovod": JaxHorovodTrainer}
EPOCHS = 2


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("dp")


@pytest.fixture(scope="module")
def data(work):
    """The HAR cache and its arrays, and a port checkpoint holding the JAX
    trainer's initial parameters (no optimizer state)."""
    # a seeded validation split: the same windows every session, so a result
    # of this file is reproducible (an unseeded split drew new training data
    # each run)
    cache = write_synthetic_har_cache(work / "data", num_train=240, num_test=40, seq_length=24,
                                      split_seed=SEED)
    sets = MotionDataset.load(cache)
    jt = JaxDDPTrainer(JaxMotionModel(hidden_dim=16, layer_dim=2), JaxDataset(*_arrays(sets[0])),
                       batch_size=48, learning_rate=2.5e-3, seed=SEED, mesh=make_mesh({"dp": 2}))
    init = interop.jax_params_to_state_dict(jax.tree.map(np.array, jt.params))
    model = MotionModel(hidden_dim=16, layer_dim=2)
    model.load_state_dict(init)
    opt = torch.optim.Adam(model.parameters(), lr=2.5e-3)
    save_checkpoint(work / "init", -1, model.state_dict(), opt.state_dict(), float("inf"))
    return cache, sets, init


def _arrays(dataset):
    return dataset.features, dataset.labels


def _argv(data, *extra, epochs=EPOCHS, resume=None):
    cache, _, _ = data
    resume = resume or cache.parent / "init" / "checkpoint-epoch-0.ckpt"
    return ["--device", "cpu", "--dataset-path", str(cache), "--epochs", str(epochs),
            "--seed", str(SEED), "--batch-size", "48", "--hidden-units", "16",
            "--stacked-layer", "2", "--dropout", "0", "--checkpoint-directory", "models",
            "--resume", str(resume), *extra]


def _config_jobs(work, data, world):
    return [{"dir": str(work / f"w{world}" / f"{flavour}{sharding}"),
             "argv": _argv(data, "--checkpoint-every", "1", sharding, flavour)}
            for flavour in FLAVOURS for sharding in SHARDING]


def _results(job, world):
    """Each rank's ``rank<r>.pt`` of a job, and rank 0's ``history.json``."""
    directory = job["dir"] if isinstance(job, dict) else job
    ranks = [torch.load(f"{directory}/rank{r}.pt", weights_only=True) for r in range(world)]
    with open(f"{directory}/rank0/history.json") as f:
        return ranks, json.load(f)


def _init_checkpoints_by_rank(work, data, world):
    """Rank r's initial weights offset by r/100, in ``init-<r>/``; returns
    the checkpoint path with ``{rank}`` for the rank."""
    _, _, init = data
    model = MotionModel(hidden_dim=16, layer_dim=2)
    opt = torch.optim.Adam(model.parameters(), lr=2.5e-3)
    for rank in range(world):
        model.load_state_dict({k: v + rank / 100 for k, v in init.items()})
        save_checkpoint(work / f"init-{rank}", -1, model.state_dict(), opt.state_dict(), 1.0)
    return str(work / "init-{rank}" / "checkpoint-epoch-0.ckpt")


@pytest.fixture(scope="module")
def world2(work, data):
    """World 2: the four configurations, horovod from rank-offset weights
    (0 epochs), the char LM and the attention classifier under
    ``distributed``, and the kernel build's ordering."""
    cache, _, _ = data
    jobs = _config_jobs(work, data, 2)
    extra = {
        "perturbed": {"dir": str(work / "w2" / "perturbed"),
                      "argv": _argv(data, "horovod", epochs=0,
                                    resume=_init_checkpoints_by_rank(work, data, 2))},
        "char": {"dir": str(work / "w2" / "char"), "argv": _family_argv(work, "char")},
        "attention": {"dir": str(work / "w2" / "attention"),
                      "argv": _family_argv(work, "attention", cache)},
        "build": {"dir": str(work / "w2" / "build"), "build_once": True},
    }
    launch.spawn(2, jobs + list(extra.values()), work / "w2", timeout=300)
    return jobs, extra


@pytest.fixture(scope="module")
def world4(work, data):
    """World 4: the four configurations, then the sharded distributed
    run's epoch-1 checkpoint resumed for 1 epoch with and without
    ``--sharded-update``."""
    jobs = _config_jobs(work, data, 4)
    checkpoint = work / "w4" / "distributed--sharded-update" / "rank0" / "models" / \
        "checkpoint-epoch-1.ckpt"
    resumed = {sharding: {"dir": str(work / "w4" / f"resumed{sharding}"),
                          "argv": _argv(data, sharding, "distributed", epochs=1,
                                        resume=checkpoint)}
               for sharding in SHARDING}
    launch.spawn(4, jobs + list(resumed.values()), work / "w4", timeout=300)
    return jobs, resumed, checkpoint


def _in_process(tmp, argv):
    """The CLI in this process, in ``tmp``; returns its trainer and history."""
    here = os.getcwd()
    tmp.mkdir(parents=True, exist_ok=True)
    os.chdir(tmp)
    try:
        trainer = port_main.main(argv)
    finally:
        os.chdir(here)
    return trainer, json.loads((tmp / "history.json").read_text())


LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


@pytest.fixture(scope="module")
def world1(work, data):
    """World 1 with no launcher environment, in this process: the four
    configurations."""
    runs = {}
    with pytest.MonkeyPatch.context() as patch:
        for var in LAUNCHER_ENV:
            patch.delenv(var, raising=False)
        for flavour in FLAVOURS:
            for sharding in SHARDING:
                trainer, history = _in_process(work / "w1" / f"{flavour}{sharding}",
                                               _argv(data, sharding, flavour))
                runs[flavour, sharding] = (trainer.model.state_dict(), history)
    return runs


@pytest.fixture(scope="module")
def local(work, data):
    """The port's ``local`` trainer from the same weights."""
    trainer, history = _in_process(work / "local", _argv(data, "local"))
    return trainer.model.state_dict(), history


@pytest.fixture(scope="module")
def jax_runs(data):
    """JAX's trainers at worlds 2 and 4, sharded and replicated."""
    _, sets, _ = data
    jax_sets = [JaxDataset(*_arrays(s)) for s in sets]
    runs = {}
    for world in (2, 4):
        for flavour in FLAVOURS:
            for sharded in (True, False):
                jt = JAX_TRAINERS[flavour](
                    JaxMotionModel(hidden_dim=16, layer_dim=2), jax_sets[0], batch_size=48,
                    learning_rate=2.5e-3, validation_set=jax_sets[1], test_set=jax_sets[2],
                    seed=SEED, mesh=make_mesh({"dp": world}), sharded_update=sharded)
                params, train, valid = jt.train(epochs=EPOCHS)
                runs[world, flavour, sharded] = (jax.tree.map(np.array, params), train, valid)
    return runs


def _world_runs(request, world):
    return request.getfixturevalue({2: "world2", 4: "world4"}[world])[0]


def _job(jobs, flavour, sharding):
    return next(j for j in jobs if j["dir"].endswith(f"{flavour}{sharding}"))


def _assert_state_close(a, b, rtol, atol):
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_allclose(np.asarray(a[name]), np.asarray(b[name]), rtol=rtol,
                                   atol=atol, err_msg=name)


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


# ---------------------------------------------------------------------------
# port against JAX, and against the port's local trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sharding", SHARDING)
@pytest.mark.parametrize("flavour", FLAVOURS)
@pytest.mark.parametrize("world", [2, 4])
def test_matches_jax_trainer(request, jax_runs, world, flavour, sharding):
    ranks, history = _results(_job(_world_runs(request, world), flavour, sharding), world)
    params, train, valid = jax_runs[world, flavour, sharding == "--sharded-update"]
    np.testing.assert_allclose(history["train_history"], train, rtol=HISTORY_RTOL)
    np.testing.assert_allclose(history["validation_history"], valid, rtol=HISTORY_RTOL)
    final = interop.state_dict_to_jax_params(ranks[0]["state"])
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(params), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sharding", SHARDING)
@pytest.mark.parametrize("flavour", FLAVOURS)
@pytest.mark.parametrize("world", [2, 4])
def test_matches_port_local(request, local, world, flavour, sharding):
    ranks, history = _results(_job(_world_runs(request, world), flavour, sharding), world)
    local_state, local_history = local
    for key in ("train_history", "validation_history"):
        np.testing.assert_allclose(history[key], local_history[key], rtol=LOCAL_TOL,
                                   atol=LOCAL_TOL)
    _assert_state_close(ranks[0]["state"], local_state, LOCAL_TOL, LOCAL_TOL)


# ---------------------------------------------------------------------------
# port against port, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flavour", FLAVOURS)
@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_matches_replicated_bitwise(request, world, flavour):
    if world == 1:
        runs = request.getfixturevalue("world1")
        (sharded, h_sharded), (replicated, h_replicated) = (
            runs[flavour, s] for s in SHARDING)
    else:
        jobs = _world_runs(request, world)
        (r_sharded, h_sharded), (r_replicated, h_replicated) = (
            _results(_job(jobs, flavour, s), world) for s in SHARDING)
        sharded, replicated = r_sharded[0]["state"], r_replicated[0]["state"]
    assert h_sharded == h_replicated
    _assert_state_equal(sharded, replicated)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_ends_with_rank0_parameters(request, world):
    for job in _world_runs(request, world):
        ranks, _ = _results(job, world)
        for result in ranks[1:]:
            _assert_state_equal(result["state"], ranks[0]["state"])
            assert result["steps"] == ranks[0]["steps"] == EPOCHS * 4


def test_horovod_broadcasts_rank0_parameters_at_train_entry(world2, data):
    """Rank r starts from the weights offset by r/100; after ``train()``'s
    entry (0 epochs) every rank holds rank 0's."""
    _, extra = world2
    ranks, _ = _results(extra["perturbed"], 2)
    _, _, init = data
    for result in ranks:
        _assert_state_equal(result["state"], init)


def test_only_rank0_writes_and_logs_are_rank_tagged(world2):
    jobs, _ = world2
    job = _job(jobs, "distributed", "--sharded-update")
    ranks, _ = _results(job, 2)
    rank_dirs = [f"{job['dir']}/rank{r}" for r in range(2)]
    assert sorted(os.listdir(f"{rank_dirs[0]}/models")) == [
        "best-model.ckpt", "checkpoint-epoch-1.ckpt", "checkpoint-epoch-2.ckpt"]
    assert os.listdir(rank_dirs[1]) == []  # no history.json, no models/
    for rank, result in enumerate(ranks):
        perf = [m for m in result["log"] if "Memory Usage" in m]
        assert len(perf) == 1 and perf[0].startswith(f"{rank}: ")
        (tag, memory, duration), = PERF_LINE_RE.findall(perf[0])
        assert tag == str(rank) and float(memory) > 0 and float(duration) > 0
        evaluations = [m for m in result["log"] if "Evaluation" in m]
        assert len(evaluations) == (EPOCHS + 1 if rank == 0 else 0)
        assert any(m.startswith(f"Rank: {rank:02d}   Start Epoch") for m in result["log"])


# ---------------------------------------------------------------------------
# checkpoints: unsharded, resumable under any strategy
# ---------------------------------------------------------------------------


def test_sharded_checkpoint_holds_per_parameter_adam_state(world4):
    _, _, checkpoint = world4
    model_state, opt_state, meta = load_checkpoint(checkpoint)
    assert meta["epoch"] == 1 and not any(k.startswith("module.") for k in model_state)
    shapes = [v.shape for v in model_state.values()]
    assert sorted(opt_state["state"]) == list(range(len(shapes)))
    for i, shape in enumerate(shapes):
        state = opt_state["state"][i]
        assert state["exp_avg"].shape == state["exp_avg_sq"].shape == shape
        assert float(state["step"]) == 4  # one epoch of 4 steps
        assert float(state["exp_avg_sq"].abs().sum()) > 0


def test_sharded_checkpoint_resumes_bitwise_in_replicated_and_local(world4, data, tmp_path):
    _, resumed, checkpoint = world4
    (sharded, h_sharded), (replicated, h_replicated) = (
        _results(resumed[s], 4) for s in SHARDING)
    assert h_sharded == h_replicated
    _assert_state_equal(sharded[0]["state"], replicated[0]["state"])

    trainer = port_main.main(["--device", "cpu", "--dataset-path", str(data[0]), "--epochs", "0",
                              "--hidden-units", "16", "--checkpoint-directory", str(tmp_path),
                              "--resume", str(checkpoint), "local"])
    model_state, opt_state, _ = load_checkpoint(checkpoint)
    _assert_state_equal(trainer.model.state_dict(), model_state)
    assert isinstance(trainer.optimizer, torch.optim.Adam)
    loaded = trainer.optimizer.state_dict()["state"]
    for i, state in opt_state["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(loaded[i][key], state[key]), (i, key)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_distributed_runs_at_world_1_without_a_launcher(world1):
    for (flavour, sharding), (state, history) in world1.items():
        assert len(history["train_history"]) == EPOCHS, (flavour, sharding)
        assert all(np.isfinite(history["train_history"] + history["validation_history"]))
    assert not dist.is_initialized()  # each run ended the group it made


def _family_argv(work, family, cache=None):
    flags = {"char": ["--model", "char", "--seq-length", "16", "--hidden-units", "16",
                      "--batch-size", "32", "--dataset-path", str(work / "no-corpus")],
             "attention": ["--model", "attention", "--hidden-units", "16", "--num-heads", "2",
                           "--batch-size", "48", "--dataset-path", str(cache)]}[family]
    return ["--device", "cpu", "--epochs", "2", "--seed", "3", "--dropout", "0",
            "--stacked-layer", "2", *flags, "distributed"]


@pytest.mark.parametrize("family", ["char", "attention"])
def test_other_families_distributed_match_local(world2, work, data, family):
    """``--model char`` (the LM loss) and ``--model attention`` under
    ``distributed`` at world 2 against ``local`` at 1e-5.  The key
    projection's bias is left out of the parameter comparison: softmax
    ignores a shift shared by a row's scores, so its gradient is zero but
    for rounding, and Adam turns that noise into steps of about the
    learning rate whose sign depends on the order of the sums."""
    _, extra = world2
    ranks, history = _results(extra[family], 2)
    argv = extra[family]["argv"][:-1] + ["local"]
    trainer, local_history = _in_process(work / f"local-{family}", argv)
    for key in ("train_history", "validation_history"):
        np.testing.assert_allclose(history[key], local_history[key], rtol=LOCAL_TOL,
                                   atol=LOCAL_TOL)
    compared = [k for k in ranks[0]["state"] if not k.endswith("wk.bias")]
    _assert_state_close({k: ranks[0]["state"][k] for k in compared},
                        {k: trainer.model.state_dict()[k] for k in compared}, LOCAL_TOL, LOCAL_TOL)
    _assert_state_equal(ranks[1]["state"], ranks[0]["state"])


def test_sharded_update_is_inert_on_local(work, data):
    runs = [_in_process(work / f"inert{s}", _argv(data, s, "local")) for s in SHARDING]
    (a, h_a), (b, h_b) = runs
    assert h_a == h_b
    _assert_state_equal(a.model.state_dict(), b.model.state_dict())
    assert type(a.optimizer) is type(b.optimizer) is DeviceStepAdam


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------


def test_kernels_build_once_before_the_other_ranks_load(world2):
    """Only rank 0 runs the build; rank 1 passes the barrier after it."""
    _, extra = world2
    directory = extra["build"]["dir"]
    assert sorted(os.listdir(directory)) == ["built-0", "passed-0", "passed-1"]
    built = float(open(f"{directory}/built-0").read())
    for rank in range(2):
        assert float(open(f"{directory}/passed-{rank}").read()) >= built


@pytest.mark.parametrize(
    "device_type,local_world,count,backend",
    [("cpu", 4, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"),
     ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo")],
)
def test_backend_rule(device_type, local_world, count, backend):
    assert collectives.choose_backend(device_type, local_world, count) == backend


def test_backend_rule_needs_a_card_for_cuda():
    with pytest.raises(RuntimeError, match="--device cpu"):
        collectives.choose_backend("cuda", 1, 0)


def test_launch_needs_a_rendezvous_above_world_1(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        collectives.init_process_group("cpu")
    assert not dist.is_initialized()
