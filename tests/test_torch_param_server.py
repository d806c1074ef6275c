"""The port's ``parameter-server`` strategy (``pytorch_distributed_rnn_tpu_
torch/param_server/``) on the CPU: against the JAX package's parameter
server, against the port's ``local`` and ``distributed-native``, and
through its CLI.

The setup is the JAX package's own (``tests/test_param_server.py``): the
motion classifier at H=8, one layer, T=12, the synthetic HAR windows of
120 training windows (96 after the validation split), global batch 48,
lr 2.5e-3, 2 epochs, dropout 0, from the JAX model's initial weights
carried over by ``interop``.  A world runs as threads of this process, one
a rank, each with its own transport communicator (the port's, or JAX's
for JAX's world).  The bars:

- sync at 1 worker: within rtol 1e-4 of JAX's master and worker (history
  and final parameters, ``PERF.md`` §2) and within 1e-5 of the port's
  ``local``;
- sync at 2 workers: within rtol 1e-4 of JAX's, and bit for bit equal to
  the port's ``distributed-native`` replicated at world 2 (the same
  shards, batch and initial parameters; (g1 + g2) / 2 then flat Adam is
  the ring's sum / 2 then Adam);
- async at 1 worker bit for bit equal to sync at 1 worker; async at 2
  workers completes with finite losses and one update a push;
- the char and attention families through sync at 2 workers;
- one spawn-mode CLI world of 3, and the CLI's flags.
"""

import json
import os
import subprocess
import sys
import threading
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import MotionDataset, write_synthetic_har_cache
from pytorch_distributed_rnn_tpu_torch.models import MotionModel
from pytorch_distributed_rnn_tpu_torch.param_server.master import ParameterServerMaster
from pytorch_distributed_rnn_tpu_torch.param_server.runner import FlatAdam, flat_parameters
from pytorch_distributed_rnn_tpu_torch.param_server.worker import ParameterServerWorkerTrainer
from pytorch_distributed_rnn_tpu_torch.runtime import native
from pytorch_distributed_rnn_tpu_torch.training import Trainer, families
from pytorch_distributed_rnn_tpu_torch.training.native_ddp import NativeDDPTrainer
from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports

ROOT = Path(__file__).resolve().parent.parent
SEED = 7
LR = 2.5e-3
BATCH = 48
EPOCHS = 2
JAX_RTOL = 1e-4
LOCAL_TOL = 1e-5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The HAR cache (96 training windows of T=12) and its training arrays."""
    work = tmp_path_factory.mktemp("ps")
    cache = write_synthetic_har_cache(work / "data", num_train=120, num_test=16, seq_length=12,
                                      split_seed=0)
    train = MotionDataset.load(cache)[0]
    assert len(train) == 96
    native.build_native_library()  # before any thread loads it
    return cache, (train.features, train.labels)


def _jax_model():
    from pytorch_distributed_rnn_tpu.models import MotionModel as JaxMotionModel

    return JaxMotionModel(input_dim=9, hidden_dim=8, layer_dim=1, output_dim=6)


@pytest.fixture(scope="module")
def init():
    """The JAX model's initial parameters, as JAX's runner makes them, in
    the port's names."""
    import jax

    return interop.jax_params_to_state_dict(_jax_model().init(jax.random.PRNGKey(SEED)))


def _port_model(init):
    model = MotionModel(input_dim=9, hidden_dim=8, layer_dim=1, output_dim=6)
    model.load_state_dict(init)
    return model


def _run_threads(targets: dict, timeout: float = 300.0) -> dict:
    """Each ``targets[rank]()`` on a thread of its own; their results by
    rank, or the first error raised."""
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


def port_world(make_model, training_set, workers: int, sync: bool = True,
               trainer_class=ParameterServerWorkerTrainer, batch: int = BATCH) -> dict:
    """The port's world: the master (rank 0) and ``workers`` workers as
    threads.  Returns ``{"master": (master, final), w: (history, state)}``."""
    (port,) = free_ports(1)
    world = workers + 1

    def master_main():
        with native.Communicator("127.0.0.1", port, 0, world) as comm:
            update = FlatAdam(flat_parameters(make_model()), LR, "cpu")
            master = ParameterServerMaster(comm, update.host, update, sync_mode=sync,
                                           sync_timeout=60.0)
            return master, master.serve().clone()

    def worker_main(rank):
        with native.Communicator("127.0.0.1", port, rank, world) as comm:
            trainer = trainer_class(make_model(), training_set, batch, LR, comm=comm,
                                    worker_rank=rank, num_workers=workers, seed=SEED,
                                    device="cpu")
            _, history, _ = trainer.train(epochs=EPOCHS)
            trainer.finish()
            return history, {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}

    targets = {0: master_main}
    targets.update({rank: (lambda r=rank: worker_main(r)) for rank in range(1, world)})
    results = _run_threads(targets)
    results["master"] = results.pop(0)
    return results


def jax_world(arrays, workers: int) -> dict:
    """JAX's sync world in threads: its master with the JAX runner's
    optax Adam update and its workers, each on a JAX communicator.
    Returns ``{"final": state dict, w: history}``."""
    import jax
    import optax
    from jax.flatten_util import ravel_pytree

    from pytorch_distributed_rnn_tpu.data import MotionDataset as JaxDataset
    from pytorch_distributed_rnn_tpu.param_server.master import (
        ParameterServerMaster as JaxMaster,
    )
    from pytorch_distributed_rnn_tpu.param_server.worker import (
        ParameterServerWorkerTrainer as JaxWorker,
    )
    from pytorch_distributed_rnn_tpu.runtime.native import Communicator as JaxCommunicator

    (port,) = free_ports(1)
    world = workers + 1
    params = _jax_model().init(jax.random.PRNGKey(SEED))
    flat, unravel = ravel_pytree(params)
    optimizer = optax.adam(LR)
    state = {"flat": np.asarray(flat, np.float32), "opt": optimizer.init(params)}

    @jax.jit
    def _update(flat_params, opt_state, flat_grads):
        p = unravel(flat_params)
        updates, opt_state = optimizer.update(unravel(flat_grads), opt_state, p)
        return ravel_pytree(optax.apply_updates(p, updates))[0], opt_state

    def apply_update(flat_grads):
        new_flat, state["opt"] = _update(state["flat"], state["opt"], flat_grads)
        state["flat"] = np.asarray(new_flat, np.float32)
        return state["flat"]

    def master_main():
        with JaxCommunicator("127.0.0.1", port, 0, world) as comm:
            final = JaxMaster(comm, state["flat"], apply_update, sync_mode=True).serve()
            return interop.jax_params_to_state_dict(unravel(final))

    def worker_main(rank):
        with JaxCommunicator("127.0.0.1", port, rank, world) as comm:
            trainer = JaxWorker(comm, _jax_model(), JaxDataset(*arrays), batch_size=BATCH,
                                learning_rate=LR, worker_rank=rank, num_workers=workers,
                                seed=SEED)
            _, history, _ = trainer.train(epochs=EPOCHS)
            trainer.finish()
            return history

    targets = {0: master_main}
    targets.update({rank: (lambda r=rank: worker_main(r)) for rank in range(1, world)})
    results = _run_threads(targets)
    results["final"] = results.pop(0)
    return results


def _close(a: dict, b: dict, rtol: float, atol: float = 0.0):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_allclose(a[key].numpy(), np.asarray(b[key]), rtol=rtol, atol=atol,
                                   err_msg=key)


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.fixture(scope="module")
def sync_worlds(data, init):
    """The port's sync worlds at 1 and 2 workers."""
    train = MotionDataset(*data[1])
    return {w: port_world(lambda: _port_model(init), train, w) for w in (1, 2)}


# ---------------------------------------------------------------------------
# against JAX's parameter server


@pytest.mark.parametrize("workers", [1, 2])
def test_sync_matches_the_jax_parameter_server(data, sync_worlds, workers):
    jax_runs = jax_world(data[1], workers)
    port_runs = sync_worlds[workers]
    for rank in range(1, workers + 1):
        np.testing.assert_allclose(port_runs[rank][0], jax_runs[rank], rtol=JAX_RTOL)
        _close(port_runs[rank][1], jax_runs["final"], rtol=JAX_RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# within the port


def test_sync_at_one_worker_matches_local(data, init, sync_worlds):
    local = Trainer(_port_model(init), MotionDataset(*data[1]), BATCH, LR, seed=SEED,
                    device="cpu")
    _, history, _ = local.train(epochs=EPOCHS)
    ps_history, ps_state = sync_worlds[1][1]
    np.testing.assert_allclose(ps_history, history, rtol=LOCAL_TOL)
    _close(ps_state, local.model.state_dict(), rtol=LOCAL_TOL, atol=1e-7)


def test_sync_at_two_workers_equals_distributed_native_bitwise(data, init, sync_worlds):
    """The port's ``distributed-native --no-sharded-update`` at world 2 on
    the same shards and initial weights: every rank's history and final
    parameters bit for bit, and the master's."""
    (port,) = free_ports(1)
    train = MotionDataset(*data[1])

    def rank_main(rank):
        with native.Communicator("127.0.0.1", port, rank, 2) as comm:
            trainer = NativeDDPTrainer(_port_model(init), train, BATCH, LR, seed=SEED,
                                       device="cpu", comm=comm, sharded_update=False)
            _, history, _ = trainer.train(epochs=EPOCHS)
            return history, trainer.model.state_dict()

    ring = _run_threads({0: lambda: rank_main(0), 1: lambda: rank_main(1)})
    ps = sync_worlds[2]
    for worker in (1, 2):
        assert ps[worker][0] == ring[worker - 1][0]
        _equal(ps[worker][1], ring[worker - 1][1])
    model = _port_model(init)
    model.load_state_dict(ring[0][1])
    assert torch.equal(ps["master"][1], flat_parameters(model))
    assert ps["master"][0].updates_applied == 2 * EPOCHS  # 48 windows a worker, 24 a batch


def test_async_at_one_worker_equals_sync_bitwise(data, init, sync_worlds):
    runs = port_world(lambda: _port_model(init), MotionDataset(*data[1]), 1, sync=False)
    assert runs[1][0] == sync_worlds[1][1][0]
    _equal(runs[1][1], sync_worlds[1][1][1])
    assert torch.equal(runs["master"][1], sync_worlds[1]["master"][1])


def test_async_at_two_workers_completes_one_update_a_push(data, init):
    runs = port_world(lambda: _port_model(init), MotionDataset(*data[1]), 2, sync=False)
    master = runs["master"][0]
    steps = 2 * EPOCHS  # 48 windows a worker, 24 a batch
    assert master.updates_applied == 2 * steps
    assert master.roster.counts() == {"joined": 0, "drained": 0, "dead": 0, "done": 2}
    for rank in (1, 2):
        assert len(runs[rank][0]) == EPOCHS and np.isfinite(runs[rank][0]).all()
    assert torch.isfinite(runs["master"][1]).all()


# ---------------------------------------------------------------------------
# the other families


def _family_args(tmp_path, model: str) -> Namespace:
    args = Namespace(model=model, dataset_path=tmp_path, output_path=None, seq_length=None,
                     validation_fraction=0.1, seed=SEED, stacked_layer=1, hidden_units=16,
                     cell="lstm", precision="f32", dropout=0.0, num_heads=4)
    if model == "char":
        (tmp_path / "corpus.txt").write_bytes(bytes(range(256)) * 40)
        args.seq_length = 15
    return args


@pytest.mark.parametrize("model", ["char", "attention"])
def test_char_and_attention_train_through_sync(data, tmp_path, model):
    if model == "attention":
        args = _family_args(data[0], model)
    else:
        args = _family_args(tmp_path, model)
    training_set = families.load_datasets(args)[0]

    def make_model():
        return families.build_model(args, training_set)

    runs = port_world(make_model, training_set, 2,
                      trainer_class=families.wrap_trainer(args, ParameterServerWorkerTrainer))
    for rank in (1, 2):
        history = runs[rank][0]
        assert len(history) == EPOCHS and np.isfinite(history).all()
        if model == "char":
            assert history[-1] < history[0]
    assert torch.isfinite(runs["master"][1]).all()


# ---------------------------------------------------------------------------
# the CLI


def test_spawn_mode_cli_world_of_three_writes_history(data, tmp_path):
    """``parameter-server`` without ``--rank``: the CLI spawns the master
    and two workers, each the port's CLI with its rank; rank 1 writes
    ``history.json`` and every rank ends on the master's parameters."""
    (port,) = free_ports(1)
    argv = ["--device", "cpu", "--dataset-path", str(data[0]), "--epochs", str(EPOCHS),
            "--hidden-units", "8", "--stacked-layer", "1", "--batch-size", str(BATCH),
            "--dropout", "0", "--seed", str(SEED), "--no-validation", "parameter-server",
            "--world-size", "3", "--ps-mode", "sync", "--master-port", str(port)]
    proc = subprocess.run([sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main",
                           *argv], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    history = json.loads((tmp_path / "history.json").read_text())
    assert len(history["train_history"]) == EPOCHS
    assert np.isfinite(history["train_history"]).all()
    digests = {line.split(": parameters: ")[0][-1]: line.split("sha256 ")[1]
               for line in proc.stderr.splitlines() if ": parameters: " in line}
    assert sorted(digests) == ["0", "1", "2"] and len(set(digests.values())) == 1
    assert "ps master: 4 updates (sync)" in proc.stderr


def _parse(argv):
    args = port_main.build_parser().parse_args(argv)
    args.argv = argv
    return args


def test_world_size_one_is_rejected():
    with pytest.raises(SystemExit, match="--world-size >= 2"):
        port_main.main(["--device", "cpu", "parameter-server", "--world-size", "1"])


@pytest.mark.parametrize("flags, dest, value", [
    (["--elastic"], "elastic", True),
    (["--min-workers", "2"], "min_workers", 2),
    (["--ps-max-respawns", "1"], "ps_max_respawns", 1),
    (["--ps-join-timeout", "5"], "ps_join_timeout", 5.0),
    (["--ps-rejoin"], "ps_rejoin", True),
    (["--ps-worker-id", "3"], "ps_worker_id", 3),
    (["--ps-checkpoint-rounds", "5"], "ps_checkpoint_rounds", 5),
])
def test_the_elastic_and_checkpoint_flags_are_accepted(flags, dest, value):
    args = _parse(["parameter-server", *flags])
    port_main.reject_unported(args)
    assert getattr(args, dest) == value


def test_fuse_run_is_rejected_and_resume_is_accepted():
    with pytest.raises(SystemExit, match="host handles every batch"):
        port_main.reject_unported(_parse(["--fuse-run", "parameter-server"]))
    port_main.reject_unported(_parse(["--resume", "x.ckpt", "parameter-server"]))


def test_moe_exits_citing_a9():
    args = _parse(["--model", "moe", "parameter-server", "--world-size", "2"])
    with pytest.raises(SystemExit, match="A9"):
        args.func(args)


def test_the_jax_flags_parse():
    args = _parse(["parameter-server", "--world-size", "3", "--ps-mode", "sync",
                   "--ps-quorum", "0.5", "--ps-sync-timeout", "5",
                   "--ps-transport-retries", "2", "--rank", "1", "--master-address",
                   "10.0.0.1", "--master-port", "29511"])
    assert (args.ps_quorum, args.ps_sync_timeout, args.ps_transport_retries) == (0.5, 5.0, 2)
    assert (args.rank, args.world_size, args.master_address, args.master_port) == (
        1, 3, "10.0.0.1", "29511")
    port_main.reject_unported(args)


def test_without_a_card_every_role_names_device_cpu():
    """No fallback: ``--device cuda`` (the default) without a card fails
    before any world starts, naming ``--device cpu`` (skips where a card
    exists)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    for rank in ([], ["--rank", "0"], ["--rank", "1"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            port_main.main(["parameter-server", "--world-size", "2", *rank])
