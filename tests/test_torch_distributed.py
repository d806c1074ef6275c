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

The runs at INFO take the device-resident step body (``training/base.py``
``_step_body``, uncaptured over gloo); each has a twin at ``--log DEBUG``,
the per-batch loop, which it must equal bit for bit.  ``--fuse-run``
(``--no-validation``) is held against the per-epoch path at 1e-5 and
against JAX's fused trainers at 1e-4.
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
from pytorch_distributed_rnn_tpu.resilience import FaultSchedule as JaxFaults
from pytorch_distributed_rnn_tpu.training import DDPTrainer as JaxDDPTrainer
from pytorch_distributed_rnn_tpu.training import HorovodTrainer as JaxHorovodTrainer
from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import (
    MotionDataset,
    generate_har_arrays,
    write_synthetic_har_cache,
)
from pytorch_distributed_rnn_tpu_torch.models import MotionModel
from pytorch_distributed_rnn_tpu_torch.ops.adam import DeviceStepAdam
from pytorch_distributed_rnn_tpu_torch.parallel import collectives, launch
from pytorch_distributed_rnn_tpu_torch.resilience import FaultSchedule
from pytorch_distributed_rnn_tpu_torch.training import DDPTrainer, HorovodTrainer
from pytorch_distributed_rnn_tpu_torch.training.base import FUSE_RUN_UNFUSABLE
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

SEED = 123456789
HISTORY_RTOL = 1e-4  # port against JAX
LOCAL_TOL = 1e-5  # port against port
FLAVOURS = ("distributed", "horovod")
SHARDING = ("--sharded-update", "--no-sharded-update")
JAX_TRAINERS = {"distributed": JaxDDPTrainer, "horovod": JaxHorovodTrainer}
PORT_TRAINERS = {"distributed": DDPTrainer, "horovod": HorovodTrainer}
EPOCHS = 2
FUSE_RTOL = 1e-5  # --fuse-run against the per-epoch path (tests/test_torch_graph_step.py)
UNCAPTURED = "gloo collectives cannot be captured: the step body runs uncaptured on cpu"


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


def _config_jobs(work, data, world, suffix="", *flags):
    return [{"dir": str(work / f"w{world}" / f"{flavour}{sharding}{suffix}"),
             "argv": _argv(data, "--checkpoint-every", "1", sharding, *flags, flavour)}
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
    """World 2: the four configurations and their per-batch-loop twins
    (``--log DEBUG``), horovod from rank-offset weights (0 epochs), the
    char LM and the attention classifier under ``distributed`` and their
    twins, ``--fuse-run`` under both strategies beside their per-epoch
    runs (``--no-validation``), and the kernel build's ordering."""
    cache, _, _ = data
    jobs = _config_jobs(work, data, 2)
    debug = _config_jobs(work, data, 2, "-debug", "--log", "DEBUG")
    fused = {(flavour, mode): {"dir": str(work / "w2" / f"{flavour}-{mode}"),
                               "argv": _argv(data, "--no-validation", *flags, flavour)}
             for flavour in FLAVOURS
             for mode, flags in (("fused", ["--fuse-run"]), ("epochs", []))}
    families = {(family, mode): {"dir": str(work / "w2" / f"{family}-{mode}"),
                                 "argv": _family_argv(work, family, cache, *flags)}
                for family in ("char", "attention")
                for mode, flags in (("step", []), ("debug", ["--log", "DEBUG"]))}
    extra = {
        "perturbed": {"dir": str(work / "w2" / "perturbed"),
                      "argv": _argv(data, "horovod", epochs=0,
                                    resume=_init_checkpoints_by_rank(work, data, 2))},
        "char": families["char", "step"],
        "attention": families["attention", "step"],
        "build": {"dir": str(work / "w2" / "build"), "build_once": True},
        "debug": debug,
        "fused": fused,
        "families": families,
    }
    runs = [*jobs, extra["perturbed"], *families.values(), extra["build"], *debug,
            *fused.values()]
    launch.spawn(2, runs, work / "w2", device="cpu", timeout=300)
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
    launch.spawn(4, jobs + list(resumed.values()), work / "w4", device="cpu", timeout=300)
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


def _final_adam_state(job):
    """The Adam state of rank 0's last epoch checkpoint."""
    _, opt_state, _ = load_checkpoint(f"{job['dir']}/rank0/models/checkpoint-epoch-{EPOCHS}.ckpt")
    return opt_state["state"]


def _assert_step_body_equals_loop(step_job, loop_job, adam=True):
    """Two world-2 runs, the step body and the per-batch loop: the same
    history, every rank's parameters and (``adam``) rank 0's last Adam
    state bit for bit; only the step body's ranks log, once each, that
    their gloo world runs it uncaptured."""
    (step, h_step), (loop, h_loop) = _results(step_job, 2), _results(loop_job, 2)
    assert h_step == h_loop
    for a, b in zip(step, loop, strict=True):
        _assert_state_equal(a["state"], b["state"])
        assert a["buffers"] == ["epoch"] and b["buffers"] == []
        assert sum(UNCAPTURED in m for m in a["log"]) == 1
        assert not any(UNCAPTURED in m for m in b["log"])
    if adam:
        want = _final_adam_state(loop_job)
        for i, state in _final_adam_state(step_job).items():
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(state[key], want[i][key]), (i, key)


@pytest.mark.parametrize("sharding", SHARDING)
@pytest.mark.parametrize("flavour", FLAVOURS)
def test_step_body_matches_the_per_batch_loop_bitwise(world2, flavour, sharding):
    """The step body that the card captures, uncaptured over gloo at world
    2, against the per-batch loop (``--log DEBUG``): under ``distributed``
    with the replicated update the body averages the bare model's
    gradients itself, where the loop goes through DDP's hook."""
    jobs, extra = world2
    _assert_step_body_equals_loop(_job(jobs, flavour, sharding),
                                  _job(extra["debug"], flavour, f"{sharding}-debug"))


@pytest.mark.parametrize("family", ["char", "attention"])
def test_other_families_step_body_matches_the_per_batch_loop_bitwise(world2, family):
    _, extra = world2
    runs = extra["families"]
    _assert_step_body_equals_loop(runs[family, "step"], runs[family, "debug"], adam=False)


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
# --fuse-run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_fused(data):
    """JAX's fused trainers at world 2, from the same initial weights."""
    _, sets, _ = data
    runs = {}
    for flavour in FLAVOURS:
        jt = JAX_TRAINERS[flavour](
            JaxMotionModel(hidden_dim=16, layer_dim=2), JaxDataset(*_arrays(sets[0])),
            batch_size=48, learning_rate=2.5e-3, seed=SEED, mesh=make_mesh({"dp": 2}),
            fuse_run=True)
        params, train, _ = jt.train(epochs=EPOCHS)
        runs[flavour] = (jax.tree.map(np.array, params), train)
    return runs


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_fuse_run_matches_the_per_epoch_path(world2, flavour):
    """``--fuse-run --no-validation`` through the CLI takes the fused run
    on every rank, each over its own shard padded with zero-weight rows,
    within 1e-5 of the per-epoch path; the ranks end alike."""
    _, extra = world2
    (fused, h_fused), (epochs, h_epochs) = (_results(extra["fused"][flavour, mode], 2)
                                            for mode in ("fused", "epochs"))
    np.testing.assert_allclose(h_fused["train_history"], h_epochs["train_history"],
                               rtol=FUSE_RTOL)
    assert h_fused["validation_history"] == h_epochs["validation_history"] == []
    for a, b in zip(fused, epochs, strict=True):
        assert a["buffers"] == ["run"] and b["buffers"] == ["epoch"]
        _assert_state_equal(a["state"], fused[0]["state"])
    _assert_state_close(fused[0]["state"], epochs[0]["state"], FUSE_RTOL, FUSE_RTOL)


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_fuse_run_matches_jax_fused_trainer(world2, jax_fused, flavour):
    _, extra = world2
    ranks, history = _results(extra["fused"][flavour, "fused"], 2)
    params, train = jax_fused[flavour]
    np.testing.assert_allclose(history["train_history"], train, rtol=HISTORY_RTOL)
    final = interop.state_dict_to_jax_params(ranks[0]["state"])
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(params), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.fixture
def group1(monkeypatch):
    """A world of 1 over gloo in this process."""
    for var in LAUNCHER_ENV:
        monkeypatch.delenv(var, raising=False)
    group = collectives.init_process_group("cpu")
    yield group
    collectives.destroy(group)


@pytest.mark.parametrize("case", ["validation", "checkpoint-every", "dropout-partial-batch",
                                  "faults", "epoch-offset-resume"])
@pytest.mark.parametrize("flavour", FLAVOURS)
def test_fuse_run_refuses_where_jax_does(group1, flavour, case, tmp_path):
    """The strategies' gate of ``--fuse-run`` against JAX's trainers at
    ``dp`` 2 (the port's at world 1, in this process): the same
    ``ValueError``, before any step.  ``grad_accum`` above 1 both refuse
    earlier, at construction (``tests/test_torch_resilience.py``)."""
    X, y = generate_har_arrays(100, seq_length=8, seed=0)  # a partial last batch, both worlds
    Xv, yv = generate_har_arrays(16, seq_length=8, seed=1)
    kw = dict(batch_size=48, learning_rate=1e-3, seed=SEED, fuse_run=True)
    dropout, jax_kw, port_kw = 0.0, {}, {}
    if case == "validation":
        jax_kw, port_kw = {"validation_set": JaxDataset(Xv, yv)}, {"validation_set":
                                                                   MotionDataset(Xv, yv)}
    elif case == "checkpoint-every":
        jax_kw = port_kw = {"checkpoint_every": 1, "checkpoint_dir": tmp_path}
    elif case == "faults":
        jax_kw = {"faults": JaxFaults.parse("epoch:9:stall")}
        port_kw = {"faults": FaultSchedule.parse("epoch:9:stall")}
    elif case == "dropout-partial-batch":
        dropout = 0.1
    jt = JAX_TRAINERS[flavour](JaxMotionModel(hidden_dim=8, dropout=dropout),
                               JaxDataset(X, y), mesh=make_mesh({"dp": 2}), **kw, **jax_kw)
    trainer = PORT_TRAINERS[flavour](MotionModel(hidden_dim=8, dropout=dropout),
                                     MotionDataset(X, y), group=group1, **kw, **port_kw)
    epochs = 1
    if case == "epoch-offset-resume":
        # each resumes its own checkpoint of epoch 1, and trains from there
        for t, directory in ((jt, tmp_path / "jax"), (trainer, tmp_path / "port")):
            directory.mkdir()
            t.checkpoint_dir = directory
            t._save_checkpoint(0, 1.0)
            t.resume_from(directory / "checkpoint-epoch-1.ckpt", advance_epoch=True)
        assert jt._start_epoch == trainer._start_epoch == 1
        epochs = 2
    with pytest.raises(ValueError, match="--fuse-run") as theirs:
        jt.train(epochs=epochs)
    with pytest.raises(ValueError, match="--fuse-run") as ours:
        trainer.train(epochs=epochs)
    assert str(ours.value) == str(theirs.value) == FUSE_RUN_UNFUSABLE
    assert not trainer._buffers  # refused before any step


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


def _family_argv(work, family, cache=None, *extra):
    flags = {"char": ["--model", "char", "--seq-length", "16", "--hidden-units", "16",
                      "--batch-size", "32", "--dataset-path", str(work / "no-corpus")],
             "attention": ["--model", "attention", "--hidden-units", "16", "--num-heads", "2",
                           "--batch-size", "48", "--dataset-path", str(cache)]}[family]
    return ["--device", "cpu", "--epochs", "2", "--seed", "3", "--dropout", "0",
            "--stacked-layer", "2", *flags, *extra, "distributed"]


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
