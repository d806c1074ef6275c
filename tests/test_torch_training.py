"""The port's data layer, local trainer, checkpoints and CLI, on the CPU.

The loss-history test starts the port from the JAX ``Trainer``'s own
initial params (carried by ``interop``) on the same arrays; the samplers
agree bit for bit, so both see identical batches, and the histories must
agree within rtol 1e-4 (f32 CPU; Adam over a handful of steps).
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu.data import DataLoader as JaxDataLoader
from pytorch_distributed_rnn_tpu.data import DistributedSampler as JaxSampler
from pytorch_distributed_rnn_tpu.data import MotionDataProcessor as JaxProcessor
from pytorch_distributed_rnn_tpu.data import MotionDataset as JaxDataset
from pytorch_distributed_rnn_tpu.data.synthetic import generate_har_arrays as jax_generate
from pytorch_distributed_rnn_tpu.evaluation.analysis import PERF_LINE_RE
from pytorch_distributed_rnn_tpu.models import MotionModel as JaxMotionModel
from pytorch_distributed_rnn_tpu.training.base import Trainer as JaxTrainer
from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import (
    DataLoader,
    DistributedSampler,
    MotionDataProcessor,
    MotionDataset,
    generate_har_arrays,
    write_synthetic_har_cache,
    write_synthetic_har_dataset,
)
from pytorch_distributed_rnn_tpu_torch.models import MotionModel
from pytorch_distributed_rnn_tpu_torch.training import Trainer
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import (
    CheckpointCorruptError,
    load_checkpoint,
)

SEED = 123456789
HISTORY_RTOL = 1e-4


@pytest.fixture(scope="module")
def arrays():
    return [generate_har_arrays(n, seq_length=24, seed=s) for n, s in ((192, 0), (32, 1), (32, 2))]


def _port_trainer(arrays, tmp_path=None, **kw):
    train, valid, test = (MotionDataset(*a) for a in arrays)
    model = MotionModel(hidden_dim=16, layer_dim=2, impl=kw.pop("impl", "auto"))
    return Trainer(model, train, batch_size=80, learning_rate=2.5e-3, validation_set=valid,
                   test_set=test, seed=SEED, checkpoint_dir=tmp_path, device="cpu", **kw)


# ---------------------------------------------------------------------------
# data layer: identical batches to the JAX package's
# ---------------------------------------------------------------------------


def test_synthetic_arrays_match_jax():
    for a, b in zip(generate_har_arrays(50, seq_length=16, seed=4), jax_generate(50, seq_length=16, seed=4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "size,replicas,rank,seed,epoch",
    [(100, 1, 0, 0, 0), (100, 1, 0, 7, 3), (101, 4, 2, 5, 1), (3, 4, 3, 0, 2)],
)
def test_sampler_matches_jax(size, replicas, rank, seed, epoch):
    ours = DistributedSampler(size, num_replicas=replicas, rank=rank, seed=seed)
    theirs = JaxSampler(size, num_replicas=replicas, rank=rank, seed=seed)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    np.testing.assert_array_equal(ours.indices(), theirs.indices())
    assert len(ours) == len(theirs)


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_matches_jax(arrays, drop_last):
    X, y = arrays[0]
    ours = DataLoader(MotionDataset(X, y), 80, DistributedSampler(len(X), seed=1), drop_last)
    theirs = JaxDataLoader(JaxDataset(X, y), 80, JaxSampler(len(X), seed=1), drop_last)
    assert len(ours) == len(theirs)
    for (xa, ya), (xb, yb) in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_processor_and_cache_match_jax(tmp_path):
    """The raw-text path gives the JAX processor's arrays exactly (seeded
    split, x96 truncation); the direct cache writer gives the same splits
    up to the text files' 7 significant digits."""
    write_synthetic_har_dataset(tmp_path / "raw", num_train=230, num_test=20, seq_length=16, seed=3)
    ours = MotionDataProcessor(seed=5).process_data(tmp_path / "raw", 0.1)
    theirs = JaxProcessor(seed=5).process_data(tmp_path / "raw", 0.1)
    for (xa, ya), (xb, yb) in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    assert len(ours[0][0]) == 192  # 230 - 23 validation, truncated to 2 x 96

    write_synthetic_har_cache(tmp_path / "cache", num_train=230, num_test=20, seq_length=16,
                              seed=3, validation_fraction=0.1, split_seed=5)
    cached = MotionDataset.load(tmp_path / "cache", seed=5)
    for ds, (xb, yb) in zip(cached, theirs, strict=True):
        np.testing.assert_allclose(ds.features, xb, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ds.labels, yb)


# ---------------------------------------------------------------------------
# the local trainer against the JAX trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["scan", "fused"])
def test_two_epoch_loss_history_matches_jax_trainer(arrays, impl):
    jax_sets = [JaxDataset(*a) for a in arrays]
    jt = JaxTrainer(JaxMotionModel(hidden_dim=16, layer_dim=2), jax_sets[0], batch_size=80,
                    learning_rate=2.5e-3, validation_set=jax_sets[1], test_set=jax_sets[2],
                    seed=SEED)
    init = jax.tree.map(np.array, jt.params)
    jax_params, jax_train, jax_valid = jt.train(epochs=2)

    trainer = _port_trainer(arrays, impl=impl)
    trainer.model.load_state_dict(interop.jax_params_to_state_dict(init))
    _, train_history, valid_history = trainer.train(epochs=2)

    np.testing.assert_allclose(train_history, jax_train, rtol=HISTORY_RTOL)
    np.testing.assert_allclose(valid_history, jax_valid, rtol=HISTORY_RTOL)
    final = interop.state_dict_to_jax_params(trainer.model.state_dict())
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(jax_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_perf_line_parses_with_the_analysis_regex(arrays, caplog):
    trainer = _port_trainer(arrays)
    with caplog.at_level(logging.INFO):
        trainer.train(epochs=1)
    perf = [r.getMessage() for r in caplog.records if "Memory Usage" in r.getMessage()]
    assert len(perf) == 1
    (rank, memory, duration), = PERF_LINE_RE.findall(perf[0])
    assert rank == "0" and float(memory) > 0 and float(duration) > 0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_and_resume(arrays, tmp_path):
    trainer = _port_trainer(arrays, tmp_path, checkpoint_every=1, keep_checkpoints=1)
    trainer.train(epochs=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["best-model.ckpt", "checkpoint-epoch-2.ckpt"]
    model_state, opt_state, meta = load_checkpoint(tmp_path / "checkpoint-epoch-2.ckpt")
    assert meta["epoch"] == 2
    for key, value in trainer.model.state_dict().items():
        torch.testing.assert_close(model_state[key], value, rtol=0, atol=0)
    assert opt_state["state"][0]["step"] == trainer.optimizer.state_dict()["state"][0]["step"]

    resumed = _port_trainer(arrays)
    meta = resumed.resume_from(tmp_path / "checkpoint-epoch-2.ckpt")
    assert meta["epoch"] == 2 and resumed._resume_best_loss == meta["loss"]
    for key, value in trainer.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[key], value, rtol=0, atol=0)


@pytest.mark.parametrize("damage", ["truncate", "flip", "header", "trailing"])
def test_corrupt_checkpoint_is_rejected(arrays, tmp_path, damage):
    trainer = _port_trainer(arrays, tmp_path)
    trainer._save_checkpoint(0, 1.0, best=True)
    path = tmp_path / "best-model.ckpt"
    blob = path.read_bytes()
    if damage == "truncate":
        blob = blob[:-10]
    elif damage == "flip":
        blob = blob[:-5] + bytes([blob[-5] ^ 0xFF]) + blob[-4:]
    elif damage == "header":
        blob = b"not json\n" + blob
    else:
        blob += b"x"
    path.write_bytes(blob)
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(path)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def cache_dir(tmp_path):
    return write_synthetic_har_cache(tmp_path / "data", num_train=240, num_test=40, seq_length=16)


def test_cli_local_run_and_resume(cache_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--dataset-path", str(cache_dir), "--epochs", "2", "--seed", "1",
            "--batch-size", "96", "--hidden-units", "8", "--checkpoint-directory",
            str(tmp_path / "models")]
    trainer = port_main.main(argv + ["local"])
    history = json.loads((tmp_path / "history.json").read_text())
    assert len(history["train_history"]) == len(history["validation_history"]) == 2
    assert all(np.isfinite(history["train_history"]))
    assert trainer.device == torch.device("cpu")
    best = tmp_path / "models" / "best-model.ckpt"
    assert best.exists()
    resumed = port_main.main(argv + ["--epochs", "1", "--resume", str(best), "local"])
    assert resumed._resume_best_loss is not None


def test_main_without_device_cpu_needs_cuda(cache_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_main.main(["--dataset-path", str(cache_dir), "local"])


@pytest.mark.parametrize(
    "flags,command",
    # --fuse-run is ported for local, distributed and horovod (the case
    # below); --grad-accum, --max-bad-steps, --faults, --remat and --resume
    # auto are ported (tests/test_torch_resilience.py, and the case below),
    # and so are the telemetry flags (tests/test_torch_obs.py, and the case
    # below); the two checkpoint flags stay rejected on every strategy that
    # does not name its own reason
    [(["--checkpoint-format", "sharded"], "distributed"),
     (["--checkpoint-format", "sharded"], "horovod"), (["--checkpoint-async"], "distributed"),
     (["--checkpoint-async"], "horovod"), (["--checkpoint-format", "sharded"], "parameter-server"),
     (["--checkpoint-async"], "parameter-server"), (["--checkpoint-format", "sharded"], "local"),
     (["--checkpoint-async"], "local")],
)
def test_unported_flags_are_rejected_loudly(flags, command, capsys):
    with pytest.raises(SystemExit, match="not ported yet") as exc:
        port_main.main(["--device", "cpu", *flags, command])
    assert flags[0] in str(exc.value)


@pytest.mark.parametrize("flags", [["--metrics", "m.jsonl"], ["--metrics-sample-every", "4"],
                                   ["--live", "0"], ["--live-port-file", "p"],
                                   ["--profile", "trace"], ["--profile-steps", "1:3"]])
@pytest.mark.parametrize("command", ["local", "distributed", "horovod", "distributed-native",
                                     "parameter-server"])
def test_telemetry_flags_pass_the_gate(flags, command):
    """The six telemetry flags of ROADMAP A5's second part pass the gate
    on every strategy."""
    port_main.reject_unported(port_main.build_parser().parse_args([*flags, command]))


@pytest.mark.parametrize("command", ["local", "distributed", "horovod"])
def test_fuse_run_passes_the_gate(command):
    """``--fuse-run --no-validation`` passes the gate on the strategies
    that have the device-resident step (``distributed-native`` and
    ``parameter-server`` refuse it with their own reasons:
    ``tests/test_torch_native_ddp.py``, ``tests/test_torch_param_server.py``)."""
    port_main.reject_unported(
        port_main.build_parser().parse_args(["--fuse-run", "--no-validation", command]))


@pytest.mark.parametrize("flags", [["--grad-accum", "2"], ["--max-bad-steps", "3"],
                                   ["--faults", "step:1:nan"], ["--remat"],
                                   ["--resume", "auto"]])
def test_resilience_and_memory_flags_pass_the_gate(flags):
    """The five flags of ROADMAP A5's first half are no longer rejected."""
    port_main.reject_unported(port_main.build_parser().parse_args([*flags, "local"]))


@pytest.mark.parametrize("family", ["char", "attention", "moe"])
def test_other_model_families_exit(cache_dir, family):
    """moe is not ported; char and attention are, and their own argument
    checks exit as loudly (a window of no tokens; a recurrent cell for
    the encoder, with the JAX message)."""
    flags, match = ["--model", family], f"--model {family} is not ported"
    if family == "char":
        flags, match = flags + ["--seq-length", "0"], "--seq-length must be >= 1"
    elif family == "attention":
        flags, match = flags + ["--cell", "gru"], "--model attention does not support: --cell gru"
    with pytest.raises(SystemExit, match=match):
        port_main.main(["--device", "cpu", "--dataset-path", str(cache_dir), *flags, "local"])


def test_only_local_is_a_subcommand():
    """The strategies not ported yet are not subcommands (``local``,
    ``distributed``, ``horovod`` and ``distributed-native`` are)."""
    for command in ("fsdp", "mesh", "parameter-server"):
        with pytest.raises(SystemExit):
            port_main.main(["--device", "cpu", command])
    parser = port_main.build_parser()
    for command in ("local", "distributed", "horovod", "distributed-native"):
        assert parser.parse_args([command]).strategy == command
