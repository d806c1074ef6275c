"""The parameter server's checkpoints (``--ps-checkpoint-rounds``,
``--resume`` under ``parameter-server``) on the CPU, against the JAX
package's master.

A world runs as threads of this process, one a rank: the master is each
package's own ``runner.run_master(args)`` (args from its own CLI parser),
the workers its worker trainer on its own transport.  The model is the
motion LSTM at H=8, one layer, T=12, 96 training windows, global batch
48, lr 2.5e-3, dropout 0.

- ``AsyncCheckpointWriter``: JAX's three cases (off the caller,
  coalescing to the newest snapshot, ``close`` dropping a pending one);
- the port's master writes a checkpoint every update and a final one:
  the newest file holds its final parameters, by name, bit for bit, and
  Adam's count, the ordinals rising;
- JAX's master bootstraps from the port's newest file (``--resume
  auto``), and the port's master from JAX's: the parameters the workers
  pull equal the writer's final parameters by name at 0 difference, and
  the restored optimizer state (count, moments) equals the writer's;
- a restarted port world continues from its own checkpoint: the master
  logs the bootstrap, and the first parameters the workers pull are the
  checkpoint's; restarted on a JAX-written checkpoint, the port's world
  and JAX's train the same epoch at rtol 1e-4;
- the CLI accepts ``--ps-checkpoint-rounds`` and ``--resume``.
"""

import logging
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import write_synthetic_har_cache
from pytorch_distributed_rnn_tpu_torch.param_server import runner
from pytorch_distributed_rnn_tpu_torch.param_server.runner import AsyncCheckpointWriter
from pytorch_distributed_rnn_tpu_torch.param_server.worker import ParameterServerWorkerTrainer
from pytorch_distributed_rnn_tpu_torch.runtime import native
from pytorch_distributed_rnn_tpu_torch.training import families
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import (
    checkpoint_candidates,
    load_checkpoint,
)
from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports

SEED = 7
LR = 2.5e-3
JAX_RTOL = 1e-4


# ---------------------------------------------------------------------------
# the writer thread (JAX's cases)
# ---------------------------------------------------------------------------


def test_writer_writes_off_the_caller():
    written = []
    done = threading.Event()

    def write(flat, opt, updates):
        written.append((np.array(flat), opt, updates))
        done.set()

    writer = AsyncCheckpointWriter(write)
    writer.submit(np.ones(3, np.float32), {"o": 1}, 4)
    assert done.wait(timeout=10)
    writer.close()
    assert len(written) == 1 and written[0][2] == 4


def test_writer_coalesces_to_the_newest_snapshot():
    written = []
    gate = threading.Event()
    first_started = threading.Event()

    def write(flat, opt, updates):
        first_started.set()
        gate.wait(timeout=10)  # hold the writer mid-save
        written.append(updates)

    writer = AsyncCheckpointWriter(write)
    writer.submit(np.zeros(1), None, 1)
    assert first_started.wait(timeout=10)
    # submitted while the writer is busy: only the newest survives
    writer.submit(np.zeros(1), None, 2)
    writer.submit(np.zeros(1), None, 3)
    gate.set()
    deadline = time.monotonic() + 10
    while len(written) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    writer.close()
    assert written == [1, 3]


def test_writer_close_drops_pending_and_is_idempotent():
    written = []
    writer = AsyncCheckpointWriter(lambda *snap: written.append(snap))
    writer.close()
    writer.submit(np.zeros(1), None, 1)  # after stop: never written
    writer.close()
    assert written == []


# ---------------------------------------------------------------------------
# worlds of each package, the master through its runner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    work = tmp_path_factory.mktemp("ps-ckpt")
    cache = write_synthetic_har_cache(work / "data", num_train=120, num_test=16, seq_length=12,
                                      split_seed=0)
    native.build_native_library()  # before any thread loads it
    return cache


def _flags(cache, checkpoints, epochs, port, workers, *extra):
    return ["--dataset-path", str(cache), "--checkpoint-directory", str(checkpoints),
            "--epochs", str(epochs), "--seed", str(SEED), "--batch-size", "48",
            "--hidden-units", "8", "--stacked-layer", "1", "--dropout", "0",
            "--learning-rate", str(LR), "--no-validation", *extra, "parameter-server",
            "--world-size", str(workers + 1), "--ps-mode", "sync", "--master-port", str(port),
            "--rank", "0"]


def _threads(targets: dict, timeout: float = 300.0) -> dict:
    results, errors = {}, []

    def run(rank, fn):
        try:
            results[rank] = fn()
        except BaseException as e:  # reported below
            errors.append((rank, e))

    threads = [threading.Thread(target=run, args=item) for item in targets.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a rank outlived its timeout"
    if errors:
        raise errors[0][1]
    return results


def port_world(cache, checkpoints, epochs, workers=1, resume=False, rounds=1) -> dict:
    """The port's world: its ``run_master`` and ``workers`` workers.
    Returns ``{"final": flat, w: (first pulled flat, history, flat)}``."""
    (port,) = free_ports(1)
    extra = ["--resume", "auto"] if resume else []
    args = port_main.build_parser().parse_args(
        ["--device", "cpu", *_flags(cache, checkpoints, epochs, port, workers, *extra)])
    args.ps_checkpoint_rounds = rounds

    def worker_main(rank):
        with native.Communicator("127.0.0.1", port, rank, workers + 1) as comm:
            comm.barrier()  # run_master's rank 0 loads the data first
            training_set = families.load_datasets(args)[0]
            trainer = ParameterServerWorkerTrainer(
                families.build_model(args, training_set), training_set, 48, LR, comm=comm,
                worker_rank=rank, num_workers=workers, seed=SEED, device="cpu")
            first = runner.flat_parameters(trainer.model)
            _, history, _ = trainer.train(epochs=epochs)
            trainer.finish()
            return first, history, runner.flat_parameters(trainer.model)

    targets = {0: lambda: runner.run_master(args)}
    targets.update({r: (lambda r=r: worker_main(r)) for r in range(1, workers + 1)})
    results = _threads(targets)
    results["final"] = results.pop(0)
    return results


def jax_world(cache, checkpoints, epochs, workers=1, resume=False, rounds=1) -> dict:
    """JAX's world: its ``run_master`` and its workers.  Returns
    ``{"final": flat in JAX's order, "unravel": ..., w: (first, history)}``."""
    import jax
    from jax.flatten_util import ravel_pytree

    from pytorch_distributed_rnn_tpu import main as jax_main
    from pytorch_distributed_rnn_tpu.param_server import runner as jax_runner
    from pytorch_distributed_rnn_tpu.param_server.worker import (
        ParameterServerWorkerTrainer as JaxWorker,
    )
    from pytorch_distributed_rnn_tpu.runtime.native import Communicator as JaxCommunicator
    from pytorch_distributed_rnn_tpu.training import families as jax_families

    (port,) = free_ports(1)
    extra = ["--resume", "auto"] if resume else []
    args = jax_main.build_parser().parse_args(
        _flags(cache, checkpoints, epochs, port, workers, *extra))
    args.ps_checkpoint_rounds = rounds
    training_set = jax_families.load_datasets(args)[0]
    model = jax_families.build_model(args, training_set)
    unravel = ravel_pytree(model.init(jax.random.PRNGKey(SEED)))[1]

    def worker_main(rank):
        with JaxCommunicator("127.0.0.1", port, rank, workers + 1) as comm:
            trainer = JaxWorker(comm, jax_families.build_model(args, training_set), training_set,
                                batch_size=48, learning_rate=LR, worker_rank=rank,
                                num_workers=workers, seed=SEED)
            first = np.asarray(ravel_pytree(trainer.params)[0])
            _, history, _ = trainer.train(epochs=epochs)
            trainer.finish()
            return first, history

    targets = {0: lambda: jax_runner.run_master(args)}
    targets.update({r: (lambda r=r: worker_main(r)) for r in range(1, workers + 1)})
    results = _threads(targets)
    results["final"] = np.asarray(results.pop(0))
    results["unravel"] = unravel
    return results


def _param_shapes():
    from pytorch_distributed_rnn_tpu_torch.models import MotionModel

    return dict(MotionModel(input_dim=9, hidden_dim=8, layer_dim=1).named_parameters())


def _by_name_from_jax(flat, unravel) -> dict:
    import jax

    return interop.jax_params_to_state_dict(jax.tree.map(np.asarray, unravel(flat)))


def _assert_same_by_name(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name].float(), want[name].float()), name


def test_port_master_writes_its_final_state_every_round(cache, tmp_path, caplog):
    with caplog.at_level(logging.INFO):
        world = port_world(cache, tmp_path, epochs=2)
    files = checkpoint_candidates(tmp_path)
    ordinals = sorted(int(p.name.split("-")[-1].split(".")[0]) for p in files)
    assert ordinals == sorted(set(ordinals)) and ordinals[-1] == len(ordinals)
    assert 2 <= len(files) <= 5  # 4 updates, coalesced, and the final write
    names = list(_param_shapes())
    model_state, opt_state, meta = load_checkpoint(files[0])
    assert meta["epoch"] == ordinals[-1] and meta["loss"] == 0.0
    assert torch.equal(interop.state_dict_to_flat(model_state, names), world["final"])
    assert torch.equal(world[1][2], world["final"])
    assert {int(s["step"]) for s in opt_state["state"].values()} == {4}
    assert "master checkpoint:" in caplog.text and "write ms" in caplog.text


def test_jax_master_bootstraps_from_the_port_file(cache, tmp_path):
    import jax
    import optax

    from pytorch_distributed_rnn_tpu.training.checkpoint import find_latest_checkpoint
    from pytorch_distributed_rnn_tpu.training.checkpoint import load_checkpoint as jax_load

    written = port_world(cache, tmp_path, epochs=2)
    restarted = jax_world(cache, tmp_path, epochs=0, resume=True, rounds=0)
    shapes = _param_shapes()
    want = interop.flat_to_state_dict(written["final"], shapes)
    _assert_same_by_name(_by_name_from_jax(restarted[1][0], restarted["unravel"]), want)
    # the optimizer state JAX's master restored: count and moments by name
    unravel = restarted["unravel"]
    template = unravel(np.zeros(sum(p.numel() for p in shapes.values()), np.float32))
    _, opt_state, _ = jax_load(find_latest_checkpoint(tmp_path), template,
                               optax.adam(LR).init(template))
    _, port_opt, _ = load_checkpoint(find_latest_checkpoint(tmp_path), names=list(shapes))
    assert int(opt_state[0].count) == 4
    mu = interop.jax_params_to_state_dict(jax.tree.map(np.asarray, opt_state[0].mu))
    for i, name in enumerate(shapes):
        assert torch.equal(mu[name], port_opt["state"][i]["exp_avg"]), name


def test_port_master_bootstraps_from_the_jax_file(cache, tmp_path, caplog):
    written = jax_world(cache, tmp_path, epochs=2)
    with caplog.at_level(logging.INFO):
        restarted = port_world(cache, tmp_path, epochs=0, resume=True, rounds=0)
    ordinal = len(checkpoint_candidates(tmp_path))
    assert f"(checkpoint ordinal {ordinal})" in caplog.text
    shapes = _param_shapes()
    want = _by_name_from_jax(written["final"], written["unravel"])
    _assert_same_by_name(interop.flat_to_state_dict(restarted[1][0], shapes), want)
    # the restored Adam state on the master's flat vector, by name
    update = runner.FlatAdam(torch.zeros(sum(p.numel() for p in shapes.values())), LR, "cpu")
    checkpoints = runner.MasterCheckpoints(tmp_path, 0, shapes, update)
    assert checkpoints.bootstrap() is not None and checkpoints.count == ordinal
    assert update.steps == 4
    _, opt_state, _ = load_checkpoint(checkpoints.bootstrap(), names=list(shapes))
    avg = interop.flat_to_state_dict(update.exp_avg, shapes)
    for i, name in enumerate(shapes):
        assert torch.equal(avg[name], opt_state["state"][i]["exp_avg"]), name


def test_a_restarted_port_world_continues_as_jax_does(cache, tmp_path, caplog):
    """A port world restarted on its own checkpoint pulls that checkpoint's
    parameters first; both packages' worlds restarted on one JAX-written
    checkpoint train the same epoch at rtol 1e-4."""
    port_dir, jax_dir, copy_dir = tmp_path / "port", tmp_path / "jax", tmp_path / "copy"
    port_world(cache, port_dir, epochs=1)
    last = load_checkpoint(checkpoint_candidates(port_dir)[0])[0]
    with caplog.at_level(logging.INFO):
        port = port_world(cache, port_dir, epochs=1, resume=True)
    assert "master bootstrap: restored" in caplog.text
    assert torch.equal(port[1][0], interop.state_dict_to_flat(last, list(_param_shapes())))

    jax_world(cache, jax_dir, epochs=1)
    shutil.copytree(jax_dir, copy_dir)
    jax = jax_world(cache, jax_dir, epochs=1, resume=True, rounds=0)
    port = port_world(cache, copy_dir, epochs=1, resume=True, rounds=0)
    np.testing.assert_allclose(port[1][1], jax[1][1], rtol=JAX_RTOL)
    want = _by_name_from_jax(jax["final"], jax["unravel"])
    for name, got in interop.flat_to_state_dict(port["final"], _param_shapes()).items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=JAX_RTOL, atol=1e-5)


@pytest.mark.parametrize("argv", [
    ["parameter-server", "--ps-checkpoint-rounds", "5"],
    ["--resume", "auto", "parameter-server"],
    ["--resume", "x.ckpt", "parameter-server", "--ps-checkpoint-rounds", "1"],
])
def test_the_cli_takes_the_checkpoint_flags(argv):
    args = port_main.build_parser().parse_args(["--device", "cpu", *argv])
    port_main.reject_unported(args)
    assert args.ps_checkpoint_rounds in (0, 1, 5)


def test_master_checkpoints_map_the_flat_vector_by_name(tmp_path):
    """The port's wire order is not JAX's ravel order: the file's tree
    holds each parameter under its name whatever the flat order."""
    shapes = _param_shapes()
    flat = torch.arange(sum(p.numel() for p in shapes.values()), dtype=torch.float32)
    update = runner.FlatAdam(flat, LR, "cpu")
    checkpoints = runner.MasterCheckpoints(tmp_path, 1, shapes, update)
    path = checkpoints.save(*update.snapshot(), 0)
    assert path.name == "checkpoint-epoch-1.ckpt" and checkpoints.count == 1
    model_state, opt_state, meta = load_checkpoint(path)
    offset = 0
    for name, p in shapes.items():
        want = torch.arange(offset, offset + p.numel(), dtype=torch.float32).reshape(p.shape)
        assert torch.equal(model_state[name], want), name
        offset += p.numel()
    assert opt_state["state"] == {} and meta["epoch"] == 1
