"""The data-parallel strategies' device-resident step: what makes it safe
to capture, and, on the card, its capture and replay over NCCL.

- The sharded update's Adam count is a float64 device tensor, guarded or
  not (a captured step sees each replay's count); it still crosses a
  checkpoint in ``torch.optim.Adam``'s layout and continues with the bits
  of the run that never stopped.
- ``cuda``: ``distributed`` and ``horovod`` at world 1 on NCCL, in this
  process, through the CLI: each batch shape's step captured once and
  replayed, equal bit for bit to the per-batch loop (``--log DEBUG``),
  and ``--fuse-run`` within 1e-5 of the per-epoch path.

The world-2 cases over gloo, against the per-batch loop and JAX's
trainers, are in ``tests/test_torch_distributed.py``.  This file imports
nothing of JAX, so that the ``cuda`` cases run on a card without it:
``python -m pytest --noconftest -m cuda tests/test_torch_dp_graph.py``.
"""

import copy
import json

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import write_synthetic_har_cache
from pytorch_distributed_rnn_tpu_torch.models import MotionModel
from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr
from pytorch_distributed_rnn_tpu_torch.ops.adam import Adam
from pytorch_distributed_rnn_tpu_torch.parallel.sharded_update import ShardedUpdate
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import load_checkpoint

LR = 2.5e-3
FUSE_RTOL = 1e-5
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


class _World1:
    """The collectives of a world of 1, for the update's step and state."""

    def reduce_scatter_mean(self, flat):
        return flat.clone()

    def all_gather(self, shard, out=None):
        return shard.clone()

    def psum_(self, tensors):
        pass


def _update(model, guarded):
    return ShardedUpdate(Adam(model.parameters(), lr=LR), 1, 0, _World1(), guarded=guarded)


def _step(update, model, seed, nan=False):
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    if nan:
        next(model.parameters()).grad[0] = float("nan")
    update.step()


@pytest.mark.parametrize("guarded", [False, True], ids=["unguarded", "guarded"])
def test_sharded_step_count_round_trips_through_torch_adam(guarded):
    """Three applied steps (and under the guard a skipped one): the device
    count reads 3, the checkpoint layout holds 3 in every parameter's
    float32 ``step``, ``torch.optim.Adam`` loads and gives it back, a new
    update adopts it on the device, and its next step has the bits of the
    update that never stopped."""
    model = MotionModel(hidden_dim=8, layer_dim=1, generator=torch.Generator().manual_seed(0))
    update = _update(model, guarded)
    for seed in range(3):
        _step(update, model, seed)
    if guarded:
        _step(update, model, 3, nan=True)
        assert update.nonfinite.read() == (1, 1)
    assert update.steps.dtype == torch.float64 and update.steps.dim() == 0
    assert float(update.steps) == 3
    saved = update.state_dict()
    assert all(s["step"].dtype == torch.float32 and float(s["step"]) == 3
               for s in saved["state"].values())

    twin = MotionModel(hidden_dim=8, layer_dim=1)
    twin.load_state_dict(model.state_dict())
    torch_adam = torch.optim.Adam(twin.parameters(), lr=LR)
    torch_adam.load_state_dict(copy.deepcopy(saved))
    back = _update(twin, guarded)
    back.load_state_dict(torch_adam.state_dict())
    assert back.steps.dtype == torch.float64 and float(back.steps) == 3
    assert torch.equal(back.exp_avg, update.exp_avg)
    assert torch.equal(back.exp_avg_sq, update.exp_avg_sq)

    _step(update, model, 4)
    _step(back, twin, 4)
    assert float(update.steps) == float(back.steps) == 4
    for a, b in zip(model.parameters(), twin.parameters(), strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_world(tmp_path, monkeypatch):
    """A HAR cache, and no launcher environment: the CLI's strategies run
    a world of 1 (NCCL on the card) in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: NCCL, CUDA graphs and the CUDA kernels have no "
                    "CPU mode")
    for var in LAUNCHER_ENV:
        monkeypatch.delenv(var, raising=False)
    cache = write_synthetic_har_cache(tmp_path / "data", num_train=400, num_test=40,
                                      seq_length=24, split_seed=0)
    return tmp_path, cache, monkeypatch


def _cli(world, name, *flags):
    """``main ... <flags>`` on the card in its own directory: the trainer,
    its history, its kernel launches and its last checkpoint's Adam state."""
    tmp, cache, monkeypatch = world
    directory = tmp / name
    directory.mkdir()
    monkeypatch.chdir(directory)
    fr.reset_launch_counts()
    trainer = port_main.main(["--device", "cuda", "--dataset-path", str(cache), "--epochs", "2",
                              "--seed", "0", "--batch-size", "96", "--hidden-units", "16",
                              "--dropout", "0", "--checkpoint-directory", "models", *flags])
    torch.cuda.synchronize()
    launches = dict(fr.LAUNCHES)
    history = json.loads((directory / "history.json").read_text())
    adam = None
    if "--checkpoint-every" in flags:
        _, opt_state, _ = load_checkpoint(directory / "models" / "checkpoint-epoch-2.ckpt")
        adam = opt_state["state"]
    return trainer, history, launches, adam


@pytest.mark.cuda
@pytest.mark.parametrize("sharding", ["--sharded-update", "--no-sharded-update"])
@pytest.mark.parametrize("flavour", ["distributed", "horovod"])
def test_cuda_nccl_graph_path_matches_the_per_batch_loop_bitwise(nccl_world, flavour, sharding):
    """The captured step, its NCCL collectives inside the graph, replayed
    for every step after each shape's first: the per-batch loop's history,
    parameters, Adam state and kernel launches, bit for bit."""
    flags = ["--checkpoint-every", "2", sharding]
    graph, h_graph, l_graph, adam_graph = _cli(nccl_world, "graph", *flags, flavour)
    loop, h_loop, l_loop, adam_loop = _cli(nccl_world, "loop", *flags, "--log", "DEBUG",
                                           flavour)
    assert h_graph == h_loop and all(np.isfinite(h_graph["train_history"]))
    for key, value in graph.model.state_dict().items():
        assert torch.equal(value, loop.model.state_dict()[key]), key
    for i, state in adam_graph.items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state[key], adam_loop[i][key]), (i, key)
    assert l_graph == l_loop and l_graph["lstm_bwd"] > 0
    assert graph.graphs and not loop.graphs
    steps = 2 * len(graph._epoch_index_batches())
    assert sum(g.replays for g in graph.graphs.values()) == steps - len(graph.graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("flavour", ["distributed", "horovod"])
def test_cuda_nccl_fuse_run_matches_the_per_epoch_path(nccl_world, flavour):
    fused, h_fused, l_fused, _ = _cli(nccl_world, "fused", "--no-validation", "--fuse-run",
                                      flavour)
    epochs, h_epochs, l_epochs, _ = _cli(nccl_world, "epochs", "--no-validation", flavour)
    np.testing.assert_allclose(h_fused["train_history"], h_epochs["train_history"],
                               rtol=FUSE_RTOL)
    assert list(fused.graphs) == [("run", 96)] and l_fused == l_epochs
