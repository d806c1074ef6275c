"""Checkpoints that cross frameworks: the port writes and reads the JAX
package's single-file format (``training/checkpoint.py``).

In one process, against the JAX package:

- the codec (``utils/flax_msgpack.py``) against ``flax.serialization.
  msgpack_serialize``/``msgpack_restore`` on seeded random trees (f32,
  bf16, int32, bool and 0-d leaves, nested lists, scalars, a chunked
  leaf under a patched ``MAX_CHUNK_SIZE``), byte for byte;
- the port's model and optimizer sections against the JAX trainer's own
  file for the same state, byte for byte: the JAX trainer trains an
  epoch and writes its checkpoint (``flax.serialization.to_bytes`` of its
  params and optax state), the port resumes it and writes its own, for
  every family, with and without ``--max-bad-steps`` (the guard's
  counters set to non-zero values), and through the sharded, bucketed,
  monolithic and replicated layouts of ``distributed`` and
  ``distributed-native`` at world 1;
- JAX writes and the port resumes, and the port writes and JAX resumes
  (``Trainer.resume_from`` on each side): the epoch after the checkpoint
  agrees at rtol 1e-4 (``PERF.md`` §2) for the motion LSTM and GRU, the
  char LSTM and the attention classifier, and at world 2 on gloo
  (``distributed``) and on the ring (``distributed-native``) against
  JAX's ``DDPTrainer`` and ``NativeDDPTrainer``;
- the JAX fixture (``tests/data/jax_checkpoints``): JAX reads it and
  continues to its ``expected.json`` at rtol 1e-5, its final parameters'
  signature included; the port's ``--resume auto`` from it and JAX's, on
  a cut of the fixture's data, agree at 1e-4 in the losses and 1e-5 in
  the signature, which a resume with fresh Adam state misses;
- ``serve``'s loader on a JAX-written ``AttentionLM`` gives the JAX
  engine's tokens; a file the port wrote before it wrote JAX's format
  (``torch.save`` sections and a trainer section) still resumes.
"""

import copy
import io
import json
import os
import shutil
import sys
import threading
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pytorch_distributed_rnn_tpu.data import MotionDataset as JaxDataset
from pytorch_distributed_rnn_tpu.data.text import TextDataset as JaxTextDataset
from pytorch_distributed_rnn_tpu.models import AttentionClassifier as JaxAttention
from pytorch_distributed_rnn_tpu.models import CharRNN as JaxCharRNN
from pytorch_distributed_rnn_tpu.models import MotionModel as JaxMotionModel
from pytorch_distributed_rnn_tpu.parallel import make_mesh
from pytorch_distributed_rnn_tpu.training import DDPTrainer as JaxDDPTrainer
from pytorch_distributed_rnn_tpu.training.base import Trainer as JaxTrainer
from pytorch_distributed_rnn_tpu.training.checkpoint import load_checkpoint as jax_load
from pytorch_distributed_rnn_tpu.training.lm import wrap_lm_trainer as jax_wrap_lm
from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import (
    MotionDataset,
    TextDataset,
    generate_char_tokens,
    generate_har_arrays,
    write_synthetic_har_cache,
)
from pytorch_distributed_rnn_tpu_torch.models import AttentionClassifier, CharRNN, MotionModel
from pytorch_distributed_rnn_tpu_torch.parallel import collectives, launch
from pytorch_distributed_rnn_tpu_torch.runtime.native import Communicator
from pytorch_distributed_rnn_tpu_torch.training import Trainer
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import _read_sections, load_checkpoint
from pytorch_distributed_rnn_tpu_torch.training.distributed import DDPTrainer
from pytorch_distributed_rnn_tpu_torch.training.lm import wrap_lm_trainer
from pytorch_distributed_rnn_tpu_torch.training.native_ddp import NativeDDPTrainer
from pytorch_distributed_rnn_tpu_torch.utils import flax_msgpack
from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports

SEED = 123456789
LR = 2.5e-3
HISTORY_RTOL = 1e-4  # port against JAX (PERF.md §2)
FIXTURE = Path(__file__).resolve().parent / "data" / "jax_checkpoints"
FAMILIES = ["motion-lstm", "motion-gru", "char-lstm", "char-gru", "attention-dense",
            "attention-flash"]


# ---------------------------------------------------------------------------
# the codec against flax's
# ---------------------------------------------------------------------------


def _random_tree(seed: int):
    rng = np.random.default_rng(seed)

    def leaf(kind):
        shape = tuple(int(d) for d in rng.integers(0, 5, size=int(rng.integers(0, 3))))
        if kind == "f32":
            return rng.standard_normal(shape).astype(np.float32)
        if kind == "bf16":
            return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
        if kind == "i32":
            return rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
        if kind == "bool":
            return rng.integers(0, 2, size=shape).astype(bool)
        if kind == "zero-d":
            return np.asarray(rng.integers(0, 1000), np.int32)
        if kind == "scalar":
            return np.float32(rng.standard_normal())
        return [int(rng.integers(-2**40, 2**40)), float(rng.standard_normal()), None, True,
                "w" * int(rng.integers(0, 40))]

    kinds = ["f32", "bf16", "i32", "bool", "zero-d", "scalar", "python"]
    return {f"k{i:02d}": ({"inner": [leaf(k), {"deep": leaf(k)}]} if i % 2 else leaf(k))
            for i, k in enumerate(kinds * 2)}


def _same_leaves(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            _same_leaves(got[key], want[key])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _same_leaves(a, b)
    elif isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert got.view(torch.int16).numpy().tobytes() == want.tobytes()
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("seed", range(4))
def test_codec_matches_flax_msgpack(seed):
    tree = _random_tree(seed)
    blob = flax_msgpack.serialize(tree)
    assert blob == serialization.msgpack_serialize(tree)
    _same_leaves(flax_msgpack.restore(blob), serialization.msgpack_restore(blob))
    _same_leaves(flax_msgpack.restore(blob), tree)


def test_codec_writes_maps_in_the_callers_order():
    tree = {"b": np.ones(2, np.float32), "a": {"d": np.int32(1), "c": {"0": 1, "1": 2}}}
    assert list(flax_msgpack.restore(flax_msgpack.serialize(tree))) == ["b", "a"]
    # flax's to_bytes keeps the order too (its msgpack_serialize sorts)
    assert flax_msgpack.serialize(tree) == serialization.to_bytes(
        {"b": tree["b"], "a": {"d": tree["a"]["d"], "c": [1, 2]}})


def test_codec_chunks_large_leaves_as_flax_does(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(7)
    # sorted keys: flax's msgpack_serialize rebuilds dicts in sorted order
    tree = {"bf16": torch.randn(9, 5).to(torch.bfloat16),
            "big": rng.standard_normal((10, 7)).astype(np.float32),
            "nest": {"ints": np.arange(50, dtype=np.int32), "small": np.ones(3, np.float32)}}
    flax_tree = {**tree, "bf16": np.asarray(jnp.asarray(tree["bf16"].float().numpy(),
                                                        jnp.bfloat16))}
    blob = flax_msgpack.serialize(tree)
    assert blob == serialization.msgpack_serialize(flax_tree)
    back = flax_msgpack.restore(blob)
    np.testing.assert_array_equal(back["big"], tree["big"])
    np.testing.assert_array_equal(back["nest"]["ints"], tree["nest"]["ints"])
    assert torch.equal(back["bf16"], tree["bf16"])
    flax_back = serialization.msgpack_restore(blob)
    np.testing.assert_array_equal(flax_back["big"], tree["big"])
    whole = rng.standard_normal(40).astype(np.float32)
    assert flax_msgpack.serialize(whole) == serialization.msgpack_serialize(whole)
    np.testing.assert_array_equal(flax_msgpack.restore(flax_msgpack.serialize(whole)), whole)


def test_codec_refuses_what_flax_refuses():
    for bad in ((1, 2), {1, 2}, object()):
        with pytest.raises(TypeError):
            flax_msgpack.serialize({"x": bad})
    with pytest.raises(ValueError):
        flax_msgpack.restore(flax_msgpack.serialize({"x": 1}) + b"\x00")


# ---------------------------------------------------------------------------
# the families: a JAX trainer and the port's, from the same weights
# ---------------------------------------------------------------------------


def _family_pair(family: str, checkpoint_dir=None, max_bad_steps: int = 0,
                 checkpoint_every: int = 0):
    """The JAX trainer of ``family`` and the port's, the port's model
    holding the JAX trainer's initial weights; both with dropout 0."""
    kind, variant = family.split("-")
    jax_kw = dict(learning_rate=LR, seed=SEED, checkpoint_dir=checkpoint_dir,
                  max_bad_steps=max_bad_steps, checkpoint_every=checkpoint_every)
    port_kw = dict(learning_rate=LR, seed=SEED, device="cpu", max_bad_steps=max_bad_steps)
    if kind == "motion":
        X, y = generate_har_arrays(96, seq_length=12, seed=0)
        jt = JaxTrainer(JaxMotionModel(hidden_dim=8, layer_dim=2, cell=variant),
                        JaxDataset(X, y), batch_size=48, **jax_kw)
        model = MotionModel(hidden_dim=8, layer_dim=2, cell=variant)
        make = lambda m, **kw: Trainer(m, MotionDataset(X, y), batch_size=48, **kw)  # noqa: E731
    elif kind == "char":
        windows = generate_char_tokens(80, 12, 64, seed=1)
        jt = jax_wrap_lm(JaxTrainer)(
            JaxCharRNN(vocab_size=64, embed_dim=8, hidden_dim=8, layer_dim=2, cell=variant),
            JaxTextDataset(windows), batch_size=40, **jax_kw)
        model = CharRNN(vocab_size=64, embed_dim=8, hidden_dim=8, layer_dim=2, cell=variant)
        make = lambda m, **kw: wrap_lm_trainer(Trainer)(  # noqa: E731
            m, TextDataset(windows), batch_size=40, **kw)
    else:
        X, y = generate_har_arrays(64, seq_length=16, seed=2)
        jt = JaxTrainer(JaxAttention(input_dim=9, dim=16, depth=2, num_heads=2, output_dim=6,
                                     impl=variant), JaxDataset(X, y), batch_size=32, **jax_kw)
        model = AttentionClassifier(input_dim=9, dim=16, depth=2, num_heads=2, output_dim=6,
                                    impl=variant)
        make = lambda m, **kw: Trainer(m, MotionDataset(X, y), batch_size=32, **kw)  # noqa: E731
    model.load_state_dict(interop.jax_params_to_state_dict(jax.tree.map(np.array, jt.params)))
    # each port trainer its own copy of the weights
    return jt, (lambda **kw: make(copy.deepcopy(model), **{**port_kw, **kw}))


def _sections(path) -> tuple[bytes, bytes]:
    _, model, opt, trainer = _read_sections(path)
    assert trainer is None
    return model, opt


def _set_guard_counters(jt):
    """Non-zero ``apply_if_finite`` counters in JAX's own types."""
    jt.opt_state = jt.opt_state._replace(
        notfinite_count=jnp.asarray(2, jnp.int32), last_finite=jnp.asarray(False),
        total_notfinite=jnp.asarray(5, jnp.int32))


@pytest.mark.parametrize("guard", [0, 3], ids=["plain", "max-bad-steps"])
@pytest.mark.parametrize("family", FAMILIES)
def test_port_sections_are_the_jax_trainers_bytes(family, guard, tmp_path):
    jt, make = _family_pair(family, tmp_path / "jax", max_bad_steps=guard)
    jt.train(epochs=1)
    if guard:
        _set_guard_counters(jt)
    jt._save_checkpoint(0, 1.5)
    jax_file = tmp_path / "jax" / "checkpoint-epoch-1.ckpt"
    trainer = make(checkpoint_dir=tmp_path / "port", max_bad_steps=guard)
    meta = trainer.resume_from(jax_file)
    assert meta["epoch"] == 1 and meta["loss"] == 1.5
    if guard:
        assert meta["trainer"] == {"nonfinite": {"notfinite_count": 2, "total_notfinite": 5}}
        assert trainer.optimizer.nonfinite.read() == (2, 5)
    trainer._save_checkpoint(0, 1.5)
    port_file = tmp_path / "port" / "checkpoint-epoch-1.ckpt"
    assert _sections(port_file) == _sections(jax_file)
    header = json.loads(port_file.read_bytes().split(b"\n", 1)[0])
    assert list(header) == ["epoch", "loss", "model_len", "opt_len", "crcs", "extra"]
    assert header["extra"]["parameters"] == [n for n, _ in trainer.model.named_parameters()]


def _native_jax(comm, arrays, **kw):
    from pytorch_distributed_rnn_tpu.training.native_ddp import NativeDDPTrainer as JaxNative

    return JaxNative(comm=comm, model=JaxMotionModel(hidden_dim=8, layer_dim=1),
                     training_set=JaxDataset(*arrays), batch_size=48, learning_rate=LR,
                     seed=SEED, bucket_mb=1e-3, **kw)


LAYOUTS = {  # the port's trainer at world 1: (class, its arguments)
    "native-bucketed": (NativeDDPTrainer, dict(bucket_mb=1e-3)),
    "native-monolithic": (NativeDDPTrainer, dict(bucketed_comm=False)),
    "native-replicated": (NativeDDPTrainer, dict(sharded_update=False)),
    "distributed-sharded": (DDPTrainer, dict()),
    "distributed-replicated": (DDPTrainer, dict(sharded_update=False)),
}


@pytest.mark.parametrize("guard", [0, 3], ids=["plain", "max-bad-steps"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_layouts_write_the_jax_sharded_trainers_bytes(layout, guard, tmp_path, monkeypatch):
    """JAX's ``NativeDDPTrainer`` (sharded, three buckets) writes its
    gathered state after an epoch; each port layout at world 1 resumes it
    and writes the same sections."""
    from pytorch_distributed_rnn_tpu.runtime.native import Communicator as JaxCommunicator

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    arrays = generate_har_arrays(96, seq_length=12, seed=0)
    with JaxCommunicator(world_size=1) as comm:
        jt = _native_jax(comm, arrays, checkpoint_dir=tmp_path / "jax", max_bad_steps=guard)
        assert jt._bucket_plan is not None
        init = interop.jax_params_to_state_dict(jax.tree.map(np.array, jt.params))
        jt.train(epochs=1)
        jt._save_checkpoint(0, 0.5)
    jax_file = tmp_path / "jax" / "checkpoint-epoch-1.ckpt"
    cls, kw = LAYOUTS[layout]
    model = MotionModel(hidden_dim=8, layer_dim=1)
    model.load_state_dict(init)
    common = dict(seed=SEED, checkpoint_dir=tmp_path / "port", max_bad_steps=guard)
    if cls is NativeDDPTrainer:
        trainer = cls(model, MotionDataset(*arrays), 48, LR, device="cpu", comm=Communicator(),
                      **common, **kw)
    else:
        world = collectives.init_process_group("cpu")
        trainer = cls(model, MotionDataset(*arrays), 48, LR, group=world, **common, **kw)
    try:
        trainer.resume_from(jax_file)
        if cls is NativeDDPTrainer:
            trainer._gather_checkpoint_state()  # the epoch end's gather
        trainer._save_checkpoint(0, 0.5)
    finally:
        if cls is NativeDDPTrainer:
            trainer.comm.close()
        else:
            collectives.destroy(world)
    assert _sections(tmp_path / "port" / "checkpoint-epoch-1.ckpt") == _sections(jax_file)


# ---------------------------------------------------------------------------
# resuming across frameworks, local
# ---------------------------------------------------------------------------


RESUME_FAMILIES = ["motion-lstm", "motion-gru", "char-lstm", "attention-dense"]


@pytest.mark.parametrize("family", RESUME_FAMILIES)
def test_each_framework_resumes_the_others_checkpoint(family, tmp_path):
    """Two epochs of each trainer from the same weights, a checkpoint
    after the first; each framework resumes the other's file and trains
    the second epoch: the other's second-epoch loss at rtol 1e-4."""
    jt, make = _family_pair(family, tmp_path / "jax", checkpoint_every=1)
    _, jax_history, _ = jt.train(epochs=2)
    port = make(checkpoint_dir=tmp_path / "port", checkpoint_every=1)
    _, port_history, _ = port.train(epochs=2)
    np.testing.assert_allclose(port_history, jax_history, rtol=HISTORY_RTOL)

    resumed = make()
    resumed.resume_from(tmp_path / "jax" / "checkpoint-epoch-1.ckpt", advance_epoch=True)
    _, history, _ = resumed.train(epochs=2)
    np.testing.assert_allclose(history, jax_history[1:], rtol=HISTORY_RTOL)

    jax_resumed, _ = _family_pair(family)
    jax_resumed.resume_from(tmp_path / "port" / "checkpoint-epoch-1.ckpt", advance_epoch=True)
    _, history, _ = jax_resumed.train(epochs=2)
    np.testing.assert_allclose(history, port_history[1:], rtol=HISTORY_RTOL)


def test_port_file_restores_into_the_jax_trainers_exact_state(tmp_path):
    """JAX's loader reads the port's file into its templates: the params
    and the optax state (counts, moments, guard counters) equal the
    port's, value for value."""
    jt, make = _family_pair("char-lstm", max_bad_steps=2)
    port = make(checkpoint_dir=tmp_path, max_bad_steps=2)
    port.train(epochs=1)
    port.optimizer.nonfinite.counts.copy_(torch.tensor([1, 4], dtype=torch.int32))
    port._save_checkpoint(0, 2.0)
    params, opt_state, meta = jax_load(tmp_path / "checkpoint-epoch-1.ckpt", jt.params,
                                       jt.opt_state)
    assert meta["epoch"] == 1 and meta["loss"] == 2.0
    state = port.model.state_dict()
    flat = interop.jax_params_to_state_dict(params)
    for name, value in state.items():
        np.testing.assert_array_equal(flat[name].numpy(), value.numpy())
    assert (int(opt_state.notfinite_count), bool(opt_state.last_finite),
            int(opt_state.total_notfinite)) == (1, False, 4)
    adam = opt_state.inner_state[0]
    steps = port.optimizer.state_dict()["state"]
    assert int(adam.count) == int(steps[0]["step"]) == 2
    names = [n for n, _ in port.model.named_parameters()]
    mu = interop.jax_params_to_state_dict(adam.mu)
    for i, name in enumerate(names):
        np.testing.assert_array_equal(mu[name].numpy(), steps[i]["exp_avg"].numpy())


# ---------------------------------------------------------------------------
# resuming across frameworks, world 2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dp_work(tmp_path_factory):
    """The HAR cache (96 windows of T=12) and JAX's checkpoint of one
    local epoch from its initial weights."""
    work = tmp_path_factory.mktemp("interop-dp")
    cache = write_synthetic_har_cache(work / "data", num_train=120, num_test=16, seq_length=12,
                                      split_seed=0)
    train = MotionDataset.load(cache)[0]
    arrays = (train.features, train.labels)
    jt = JaxTrainer(JaxMotionModel(hidden_dim=8, layer_dim=1), JaxDataset(*arrays),
                    batch_size=48, learning_rate=LR, seed=SEED, checkpoint_dir=work / "jax")
    jt.train(epochs=1)
    jt._save_checkpoint(0, 1.0)
    return work, cache, arrays


def _dp_argv(cache, strategy, checkpoint_dir, *extra):
    return ["--device", "cpu", "--dataset-path", str(cache), "--seed", str(SEED),
            "--batch-size", "48", "--hidden-units", "8", "--stacked-layer", "1", "--dropout",
            "0", "--learning-rate", str(LR), "--no-validation", "--checkpoint-directory",
            str(checkpoint_dir), *extra, strategy]


@pytest.fixture(scope="module")
def port_world2(dp_work):
    """One spawned world of 2 over gloo: ``distributed`` and
    ``distributed-native`` each resume JAX's file (``--resume auto``) for
    the second epoch, and each trains two epochs from JAX's file's
    weights with ``--resume PATH``, checkpointing every epoch."""
    work, cache, _ = dp_work
    jax_dir = work / "jax"
    root = work / "w2"
    jobs = {}
    for strategy in ("distributed", "distributed-native"):
        jobs[f"{strategy}-resumes"] = {
            "dir": str(root / f"{strategy}-resumes"),
            "argv": _dp_argv(cache, strategy, jax_dir, "--epochs", "2", "--resume", "auto")}
        jobs[f"{strategy}-writes"] = {
            "dir": str(root / f"{strategy}-writes"),
            "argv": _dp_argv(cache, strategy, "models", "--epochs", "2", "--checkpoint-every",
                             "1", "--resume", str(jax_dir / "checkpoint-epoch-1.ckpt"))}
    for job, port in zip(jobs.values(), free_ports(len(jobs))):
        job["env"] = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    launch.spawn(2, list(jobs.values()), root, device="cpu", timeout=300)
    return {name: json.loads((Path(job["dir"]) / "rank0" / "history.json").read_text())
            for name, job in jobs.items()} | {"root": root}


def _jax_world2(strategy, arrays, checkpoint):
    """JAX's world of 2 resumed from ``checkpoint`` for the second epoch:
    its train history."""
    if strategy == "distributed":
        jt = JaxDDPTrainer(JaxMotionModel(hidden_dim=8, layer_dim=1), JaxDataset(*arrays),
                           batch_size=48, learning_rate=LR, seed=SEED,
                           mesh=make_mesh({"dp": 2}))
        jt.resume_from(checkpoint, advance_epoch=True)
        return jt.train(epochs=2)[1]
    from pytorch_distributed_rnn_tpu.runtime.native import Communicator as JaxCommunicator

    (port,) = free_ports(1)
    results, errors = {}, []

    def rank_main(rank):
        try:
            with JaxCommunicator("127.0.0.1", port, rank, 2) as comm:
                jt = _native_jax(comm, arrays, bucketed_comm=True)
                jt.resume_from(checkpoint, advance_epoch=True)
                results[rank] = jt.train(epochs=2)[1]
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=rank_main, args=(rank,)) for rank in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and len(results) == 2, errors
    return results[0]


@pytest.mark.parametrize("strategy", ["distributed", "distributed-native"])
def test_world2_resumes_across_frameworks(strategy, dp_work, port_world2):
    work, _, arrays = dp_work
    want = _jax_world2(strategy, arrays, work / "jax" / "checkpoint-epoch-1.ckpt")
    np.testing.assert_allclose(port_world2[f"{strategy}-resumes"]["train_history"], want,
                               rtol=HISTORY_RTOL)
    written = port_world2["root"] / f"{strategy}-writes" / "rank0" / "models"
    port_history = port_world2[f"{strategy}-writes"]["train_history"]
    got = _jax_world2(strategy, arrays, written / "checkpoint-epoch-1.ckpt")
    np.testing.assert_allclose(got, port_history[1:], rtol=HISTORY_RTOL)


# ---------------------------------------------------------------------------
# the JAX-written fixture
# ---------------------------------------------------------------------------


def _fixture():
    sys.path.insert(0, str(FIXTURE))
    try:
        import make
    finally:
        sys.path.remove(str(FIXTURE))
    return make, json.loads((FIXTURE / "expected.json").read_text())


# The port's CPU continuations run on a cut of the fixture's data (the
# model and its optimizer state are the fixture's): the full data costs
# the port minutes of CPU time on a loaded machine.  JAX's continuation on
# the same cut is what they are held to; the card (chip_smoke.py phase s)
# holds the port's full continuation to expected.json.
CPU_CUT = {"num_train": 660}


def _fixture_run(main, tmp_path, device_flags, cut=None):
    make, expected = _fixture()
    cache = write_synthetic_har_cache(tmp_path / "data", **{**expected["data"], **(cut or {})})
    (tmp_path / "models").mkdir()
    shutil.copy(FIXTURE / expected["checkpoint"], tmp_path / "models")
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        main([*device_flags, *make.cli_argv(cache, tmp_path / "models", expected["epochs"],
                                            resume=True)])
    finally:
        os.chdir(here)
    final = load_checkpoint(tmp_path / "models" / f"checkpoint-epoch-{expected['epochs']}.ckpt")
    return json.loads((tmp_path / "history.json").read_text()), final[0]


@pytest.fixture(scope="module")
def jax_on_the_cut(tmp_path_factory):
    """JAX's continuation of the fixture on ``CPU_CUT``: its history and
    its final parameters' signature."""
    from pytorch_distributed_rnn_tpu import main as jax_main

    make, _ = _fixture()
    history, final = _fixture_run(jax_main.main, tmp_path_factory.mktemp("jax-cut"), [],
                                  CPU_CUT)
    return history, make.parameter_signature(final)


def test_jax_continues_its_fixture_to_expected(tmp_path):
    from pytorch_distributed_rnn_tpu import main as jax_main

    make, expected = _fixture()
    assert expected["flags"] == make.FLAGS
    header = json.loads((FIXTURE / expected["checkpoint"]).read_bytes().split(b"\n", 1)[0])
    assert header["epoch"] == 1 and "extra" not in header
    history, final = _fixture_run(jax_main.main, tmp_path, [])
    for key in ("train_history", "validation_history"):
        np.testing.assert_allclose(history[key], expected[key], rtol=1e-5)
    errors = make.signature_errors(final, expected["final_parameters"])
    assert max(errors.values()) <= make.SIGNATURE_RTOL, errors


def test_port_continues_the_jax_fixture(tmp_path, jax_on_the_cut):
    make, expected = _fixture()
    their_history, their_signature = jax_on_the_cut
    history, final = _fixture_run(port_main.main, tmp_path, ["--device", "cpu"], CPU_CUT)
    for key in ("train_history", "validation_history"):
        np.testing.assert_allclose(history[key], their_history[key], rtol=HISTORY_RTOL)
    errors = make.signature_errors(final, their_signature)
    assert max(errors.values()) <= make.SIGNATURE_RTOL, errors
    jax_state = load_checkpoint(FIXTURE / expected["checkpoint"])
    assert list(final) == [n for n in MotionModel().state_dict()]
    assert sorted(final) == sorted(jax_state[0])


def test_a_resume_with_fresh_adam_state_misses_the_fixture_signature(tmp_path, monkeypatch,
                                                                      jax_on_the_cut):
    """The control of the signature check: a continuation that drops the
    optimizer state the file holds (moments and count) misses every
    parameter's signature by more than ten times its limit."""
    from pytorch_distributed_rnn_tpu_torch.training import base

    make, _ = _fixture()
    monkeypatch.setattr(base.Trainer, "_with_hyperparameters",
                        lambda self, opt_state: self.optimizer.state_dict())
    _, final = _fixture_run(port_main.main, tmp_path, ["--device", "cpu"], CPU_CUT)
    errors = make.signature_errors(final, jax_on_the_cut[1])
    assert min(errors.values()) > 10 * make.SIGNATURE_RTOL, errors


# ---------------------------------------------------------------------------
# serving a JAX-written AttentionLM; an older port file
# ---------------------------------------------------------------------------


def test_serve_loader_on_a_jax_attention_lm_gives_the_jax_engines_tokens(tmp_path):
    import optax

    from pytorch_distributed_rnn_tpu.models import AttentionLM as JaxAttentionLM
    from pytorch_distributed_rnn_tpu.serving import adapters as jax_adapters
    from pytorch_distributed_rnn_tpu.serving.buckets import BucketSpec as JaxBucketSpec
    from pytorch_distributed_rnn_tpu.serving.engine import ServingEngine as JaxServingEngine
    from pytorch_distributed_rnn_tpu.serving.scheduler import ServeRequest as JaxServeRequest
    from pytorch_distributed_rnn_tpu.training.checkpoint import save_checkpoint as jax_save
    from pytorch_distributed_rnn_tpu_torch.serving.cli import build_serve_parser, load_served_model
    from pytorch_distributed_rnn_tpu_torch.serving.adapters import adapter_for
    from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
    from pytorch_distributed_rnn_tpu_torch.serving.engine import ServingEngine
    from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ServeRequest

    jax_model = JaxAttentionLM(vocab_size=256, dim=32, depth=2, num_heads=4, max_len=64)
    params = jax_model.init(jax.random.PRNGKey(4))
    jax_save(tmp_path, 0, params, optax.adam(1e-3).init(params), 1.25)
    args = build_serve_parser().parse_args([
        "--device", "cpu", "--checkpoint", str(tmp_path), "--model", "attention",
        "--hidden-units", "32", "--stacked-layer", "2", "--num-heads", "4", "--max-len", "64"])
    model, meta = load_served_model(args)
    assert meta == {"epoch": 1, "loss": 1.25}
    rng = np.random.RandomState(5)
    specs = [(rng.randint(0, 256, size=rng.randint(1, 16)).tolist(), int(rng.randint(1, 12)))
             for _ in range(6)]
    engines = ((JaxServingEngine(jax_adapters.adapter_for(jax_model), params, num_slots=4,
                                 bucket_spec=JaxBucketSpec((8, 16)), max_new_tokens=12),
                JaxServeRequest),
               (ServingEngine(adapter_for(model), num_slots=4, bucket_spec=BucketSpec((8, 16)),
                              max_new_tokens=12), ServeRequest))
    served = []
    for engine, cls in engines:
        engine.warmup()
        requests = [cls(prompt=p, max_new_tokens=n, temperature=0.0, id=str(i))
                    for i, (p, n) in enumerate(specs)]
        for r in requests:
            assert engine.submit(r), r.error
        engine.drain()
        assert all(r.status == "done" for r in requests)
        served.append([r.tokens for r in requests])
    assert served[1] == served[0]


def _old_format_file(path, model_state, opt_state, trainer_state, epoch=1, loss=0.75):
    """A checkpoint as the port wrote them before it wrote JAX's format:
    ``torch.save`` sections and a trainer section (``trainer_len``)."""
    def blob(state):
        buf = io.BytesIO()
        torch.save(state, buf)
        return buf.getvalue()

    sections = {"model": blob(model_state), "opt": blob(opt_state),
                "trainer": blob(trainer_state)}
    header = json.dumps({"epoch": epoch, "loss": loss,
                         **{f"{n}_len": len(b) for n, b in sections.items()},
                         "crcs": {n: zlib.crc32(b) for n, b in sections.items()}}).encode()
    path.write_bytes(header + b"\n" + b"".join(sections.values()))
    return path


def test_a_file_of_the_older_port_format_still_resumes(tmp_path):
    """A file of ``torch.save`` sections with a trainer section, written
    after one epoch, resumes: the run continues bit for bit as an
    uninterrupted one, with the guard's counters and the dropout stream."""
    _, make = _family_pair("motion-lstm", max_bad_steps=2)
    _, uninterrupted, _ = make(max_bad_steps=2).train(epochs=2)
    first = make(max_bad_steps=2)
    first.train(epochs=1)
    first.optimizer.nonfinite.counts.copy_(torch.tensor([0, 3], dtype=torch.int32))
    path = _old_format_file(tmp_path / "checkpoint-epoch-1.ckpt", first.model.state_dict(),
                            first.optimizer.state_dict(), first._trainer_state())
    resumed = make(max_bad_steps=2)
    meta = resumed.resume_from(path, advance_epoch=True)
    assert meta["epoch"] == 1 and meta["trainer"]["nonfinite"]["total_notfinite"] == 3
    assert resumed.optimizer.nonfinite.read() == (0, 3)
    assert torch.equal(resumed.dropout_generator.get_state(), first.dropout_generator.get_state())
    for key, value in first.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[key], value), key
    sa, sb = first.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    _, history, _ = resumed.train(epochs=2)
    assert history == uninterrupted[1:]
