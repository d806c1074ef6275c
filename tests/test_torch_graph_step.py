"""The local trainer's device-resident fast paths on the CPU, against its
per-batch loop and against the JAX trainer's one-program runs.

On the CPU the train-step body that the card captures as a CUDA graph runs
directly, so these tests hold the body itself:

- the per-epoch path (the body over the epoch's static buffers) gives the
  per-batch loop's loss history, parameters and Adam state bit for bit, with
  and without a partial final batch, with and without dropout; its device
  counter walks the epoch's rows in the sampler's order;
- ``--fuse-run`` (``Trainer(fuse_run=True)``) against the JAX trainer's
  ``_train_run_fused`` from the same initial weights (``interop``), at rtol
  1e-4 as the other history tests (f32 CPU; Adam over a few steps);
- the weighted losses of the classification and LM trainers against the
  JAX trainer's at 1e-5;
- ``DeviceStepAdam`` against ``optax.adam`` at 1e-6 (f32 rounding over a few
  steps), and its ``state_dict`` in ``torch.optim.Adam``'s layout;
- the fusable gate against the JAX trainer's, with its refusals of
  ``grad_accum``, a fault schedule and an epoch-offset resume;
- the step body with ``grad_accum`` microbatches and with the guarded
  update against the per-batch loop, bit for bit.

The ``cuda``-marked tests need the card: ``python -m pytest --noconftest -m
cuda tests/test_torch_graph_step.py``.  JAX is imported inside the tests
that use it (:func:`_jax`), so that file runs on a card without JAX.
"""

import copy
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch.data import (
    MotionDataset,
    TextDataset,
    generate_char_tokens,
    generate_har_arrays,
)
from pytorch_distributed_rnn_tpu_torch.models import AttentionClassifier, CharRNN, MotionModel
from pytorch_distributed_rnn_tpu_torch.ops.adam import DeviceStepAdam
from pytorch_distributed_rnn_tpu_torch.training import Trainer
from pytorch_distributed_rnn_tpu_torch.training.base import FUSE_RUN_UNFUSABLE, StepBuffers
from pytorch_distributed_rnn_tpu_torch.training.formatter import TrainingMessageFormatter
from pytorch_distributed_rnn_tpu_torch.training.lm import wrap_lm_trainer

SEED = 123456789
HISTORY_RTOL = 1e-4
LOSS_TOL = 1e-5
ADAM_TOL = 1e-6


def _jax():
    """The JAX side of the comparisons."""
    import jax
    import jax.numpy as jnp
    import optax

    from pytorch_distributed_rnn_tpu.data import MotionDataset
    from pytorch_distributed_rnn_tpu.data.text import TextDataset
    from pytorch_distributed_rnn_tpu.models import AttentionClassifier, CharRNN, MotionModel
    from pytorch_distributed_rnn_tpu.training.base import Trainer
    from pytorch_distributed_rnn_tpu.training.lm import wrap_lm_trainer

    return SimpleNamespace(jax=jax, jnp=jnp, optax=optax, MotionDataset=MotionDataset,
                           TextDataset=TextDataset, AttentionClassifier=AttentionClassifier,
                           CharRNN=CharRNN, MotionModel=MotionModel, Trainer=Trainer,
                           wrap_lm_trainer=wrap_lm_trainer)


def _motion_trainer(n, batch, dropout=0.0, cell="lstm", device="cpu", remat=False, **kw):
    X, y = generate_har_arrays(n, seq_length=12, seed=0)
    model = MotionModel(hidden_dim=8, layer_dim=2, cell=cell, dropout=dropout, remat=remat,
                        generator=torch.Generator().manual_seed(1))
    return Trainer(model, MotionDataset(X, y), batch_size=batch, learning_rate=2.5e-3,
                   seed=SEED, device=device, **kw)


def _assert_same_bits(a, b):
    for key, value in a.model.state_dict().items():
        assert torch.equal(value, b.model.state_dict()[key]), key
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i, state in sa.items():
        for key, value in state.items():
            assert torch.equal(value, sb[i][key]), (i, key)


def _two_paths(make, epochs=2):
    """``epochs`` epochs of the per-batch loop and of the per-epoch path,
    each on a trainer from ``make()``; returns both trainers and histories."""
    formatter = TrainingMessageFormatter(epochs)
    eager, device = make(), make()
    histories = ([], [])
    for epoch in range(epochs):
        for trainer, history, flag in ((eager, histories[0], True),
                                       (device, histories[1], False)):
            trainer.sampler.set_epoch(epoch)
            history.append(trainer._train_epoch(formatter, eager=flag))
    return eager, device, histories


# ---------------------------------------------------------------------------
# the step body against the per-batch loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [192, 200], ids=["full-batches", "partial-batch"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_step_body_matches_the_per_batch_loop_bitwise(n, dropout, cell):
    eager, device, (h_eager, h_device) = _two_paths(
        lambda: _motion_trainer(n, 48, dropout=dropout, cell=cell))
    assert h_eager == h_device
    _assert_same_bits(eager, device)
    assert float(device.optimizer.device_steps) == 2 * -(-n // 48)


def test_char_step_body_matches_the_per_batch_loop_bitwise():
    windows = generate_char_tokens(70, 10, 256, seed=1)

    def make():
        model = CharRNN(vocab_size=256, embed_dim=8, hidden_dim=8, layer_dim=2, dropout=0.1,
                        generator=torch.Generator().manual_seed(2))
        return wrap_lm_trainer(Trainer)(model, TextDataset(windows), batch_size=32,
                                        learning_rate=5e-3, seed=SEED, device="cpu")

    eager, device, (h_eager, h_device) = _two_paths(make)
    assert h_eager == h_device
    _assert_same_bits(eager, device)


@pytest.mark.parametrize("n", [192, 202], ids=["full-batches", "partial-batch"])
def test_grad_accum_step_body_matches_the_per_batch_loop_bitwise(n):
    """Four microbatches a step (the final batch of 10: two), dropout drawn
    in microbatch order on both paths."""
    eager, device, (h_eager, h_device) = _two_paths(
        lambda: _motion_trainer(n, 48, dropout=0.1, grad_accum=4))
    assert h_eager == h_device
    _assert_same_bits(eager, device)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_guarded_step_body_matches_the_per_batch_loop_and_the_unguarded(dropout):
    eager, device, (h_eager, h_device) = _two_paths(
        lambda: _motion_trainer(200, 48, dropout=dropout, max_bad_steps=2))
    assert h_eager == h_device
    _assert_same_bits(eager, device)
    plain = _two_paths(lambda: _motion_trainer(200, 48, dropout=dropout))
    assert plain[2][1] == h_device
    _assert_same_bits(plain[1], device)
    assert device.optimizer.nonfinite.read() == (0, 0)


def test_device_counter_walks_the_epochs_rows_in_sampler_order():
    trainer = _motion_trainer(200, 48)
    seen = []
    plain = trainer._loss_and_metrics

    def record(x, y, generator=None):
        seen.append(x.detach().clone())
        return plain(x, y, generator)

    trainer._loss_and_metrics = record
    formatter = TrainingMessageFormatter(2)
    for epoch in range(2):
        trainer.sampler.set_epoch(epoch)
        batches = trainer._epoch_index_batches()
        seen.clear()
        trainer._train_epoch(formatter, eager=False)
        run = trainer._buffers["epoch"]
        assert int(run.step) == len(batches) and int(run.position) == 200
        assert [len(x) for x in seen] == [48, 48, 48, 48, 8]
        for x, idx in zip(seen, batches, strict=True):
            np.testing.assert_array_equal(x.numpy(), trainer.training_set.features[idx])


def test_step_buffers_load_resets_the_counters():
    run = StepBuffers("run", rows=6, steps=3, weighted=True, device="cpu")
    run.position.fill_(4)
    run.step.fill_(2)
    run.load(np.array([5, 4, 3, 2, 1, 0]), np.array([1, 1, 1, 1, 0, 0], np.float32))
    assert int(run.position) == int(run.step) == 0
    assert run.order.tolist() == [5, 4, 3, 2, 1, 0] and run.weights.tolist()[-2:] == [0, 0]
    assert run.fits(6, 3, True) and not run.fits(6, 3, False) and not run.fits(8, 3, True)


def test_pad_batch_matches_jax():
    jx = _jax()
    batch = np.array([7, 3, 9])
    for full in (3, 5):
        ours = Trainer._pad_batch(batch, full)
        theirs = jx.Trainer._pad_batch(None, batch, full)
        for a, b in zip(ours, theirs, strict=True):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# ---------------------------------------------------------------------------
# --fuse-run against the JAX trainer's one-program run
# ---------------------------------------------------------------------------


def _quiet():
    """Logging above INFO, as in a run where nothing reads the epochs."""
    root = logging.getLogger()
    level = root.level
    root.setLevel(logging.WARNING)
    return root, level


def _fused_histories(jax_trainer, port_trainer, epochs=2):
    jx = _jax()
    root, level = _quiet()
    try:
        init = jx.jax.tree.map(np.array, jax_trainer.params)
        jax_params, jax_history, _ = jax_trainer.train(epochs=epochs)
        assert jax_trainer._run_fn is not None  # JAX took its fused run
        port_trainer.model.load_state_dict(interop.jax_params_to_state_dict(init))
        _, history, _ = port_trainer.train(epochs=epochs)
    finally:
        root.setLevel(level)
    assert list(port_trainer._buffers) == ["run"]  # the port took its fused run
    np.testing.assert_allclose(history, jax_history, rtol=HISTORY_RTOL)
    return jax_params


def _motion_arrays():
    # 176 = 3 batches of 48 and a partial batch of 32
    return generate_har_arrays(176, seq_length=16, seed=3)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fuse_run_matches_jax_motion(cell):
    jx = _jax()
    X, y = _motion_arrays()
    kw = dict(batch_size=48, learning_rate=2.5e-3, seed=SEED, fuse_run=True)
    jt = jx.Trainer(jx.MotionModel(hidden_dim=12, layer_dim=2, cell=cell),
                    jx.MotionDataset(X, y), **kw)
    trainer = Trainer(MotionModel(hidden_dim=12, layer_dim=2, cell=cell), MotionDataset(X, y),
                      device="cpu", **kw)
    jax_params = _fused_histories(jt, trainer)
    final = interop.state_dict_to_jax_params(trainer.model.state_dict())
    for a, b in zip(jx.jax.tree.leaves(final), jx.jax.tree.leaves(jax_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_fuse_run_matches_jax_char_lstm():
    jx = _jax()
    windows = generate_char_tokens(90, 12, 256, seed=1)  # 2 batches of 40 and one of 10
    kw = dict(batch_size=40, learning_rate=5e-3, seed=SEED, fuse_run=True)
    jt = jx.wrap_lm_trainer(jx.Trainer)(
        jx.CharRNN(vocab_size=256, embed_dim=12, hidden_dim=12, layer_dim=2),
        jx.TextDataset(windows), **kw)
    trainer = wrap_lm_trainer(Trainer)(
        CharRNN(vocab_size=256, embed_dim=12, hidden_dim=12, layer_dim=2),
        TextDataset(windows), device="cpu", **kw)
    _fused_histories(jt, trainer)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_fuse_run_matches_jax_attention(impl):
    jx = _jax()
    X, y = generate_har_arrays(144, seq_length=16, seed=0)  # 2 batches of 64 and one of 16
    kw = dict(batch_size=64, learning_rate=2.5e-3, seed=SEED, fuse_run=True)
    jt = jx.Trainer(jx.AttentionClassifier(input_dim=9, dim=16, depth=2, num_heads=2, output_dim=6),
                    jx.MotionDataset(X, y), **kw)
    trainer = Trainer(AttentionClassifier(input_dim=9, dim=16, depth=2, num_heads=2,
                                          output_dim=6, impl=impl),
                      MotionDataset(X, y), device="cpu", **kw)
    _fused_histories(jt, trainer)


def test_fuse_run_matches_the_per_epoch_path():
    """With a partial final batch the fused run's weighted loss rounds
    unlike the plain one: the JAX suite's bar (tests/test_training.py)."""
    fused = _motion_trainer(200, 48, fuse_run=True)
    per_epoch = _motion_trainer(200, 48)
    with _info_logging():
        _, fused_history, _ = fused.train(epochs=2)
        _, history, _ = per_epoch.train(epochs=2)
    assert list(fused._buffers) == ["run"] and list(per_epoch._buffers) == ["epoch"]
    np.testing.assert_allclose(fused_history, history, rtol=1e-5, atol=1e-5)
    for key, value in fused.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), per_epoch.model.state_dict()[key].numpy(),
                                   rtol=1e-5, atol=1e-5)


class _info_logging:
    def __enter__(self):
        self.root = logging.getLogger()
        self.level = self.root.level
        self.root.setLevel(logging.INFO)

    def __exit__(self, *exc):
        self.root.setLevel(self.level)


def test_run_fuses_by_itself_above_info_only():
    """Without the flag the run fuses when nothing reads the epochs
    (logging above INFO), as the JAX trainer does; at INFO each epoch runs
    the per-epoch path and logs its start."""
    quiet = _motion_trainer(192, 48)
    root, level = _quiet()
    try:
        quiet.train(epochs=1)
    finally:
        root.setLevel(level)
    assert list(quiet._buffers) == ["run"]
    loud = _motion_trainer(192, 48)
    with _info_logging():
        loud.train(epochs=1)
    assert list(loud._buffers) == ["epoch"]
    explicit = _motion_trainer(192, 48, fuse_run=True)
    with _info_logging():
        explicit.train(epochs=1)
    assert list(explicit._buffers) == ["run"]


# ---------------------------------------------------------------------------
# the weighted losses against the JAX trainer's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tail", [0, 5], ids=["all-ones", "zero-padded-tail"])
def test_weighted_classification_loss_matches_jax(tail):
    jx = _jax()
    X, y = generate_har_arrays(16, seq_length=10, seed=4)
    y = y.reshape(-1)
    jax_model = jx.MotionModel(hidden_dim=8, layer_dim=2)
    jt = jx.Trainer(jax_model, jx.MotionDataset(X, y), batch_size=16, learning_rate=1e-3)
    model = MotionModel(hidden_dim=8, layer_dim=2)
    model.load_state_dict(interop.jax_params_to_state_dict(jx.jax.tree.map(np.array, jt.params)))
    trainer = Trainer(model, MotionDataset(X, y), batch_size=16, learning_rate=1e-3,
                      device="cpu")
    w = np.ones(16, np.float32)
    w[len(w) - tail:] = 0.0 if tail else 1.0
    want, metrics = jt._weighted_loss_and_metrics(jt.params, (jx.jnp.asarray(X), jx.jnp.asarray(y)),
                                                  jx.jnp.asarray(w))
    loss, correct = trainer._weighted_loss_and_metrics(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w))
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_TOL, atol=LOSS_TOL)
    assert float(correct) == float(metrics["correct"])
    if not tail:
        plain, _ = trainer._loss_and_metrics(torch.from_numpy(X), torch.from_numpy(y))
        np.testing.assert_allclose(loss.item(), plain.item(), rtol=LOSS_TOL)


@pytest.mark.parametrize("tail", [0, 3], ids=["all-ones", "zero-padded-tail"])
def test_weighted_lm_loss_matches_jax(tail):
    jx = _jax()
    windows = generate_char_tokens(8, 9, 256, seed=2)
    jt = jx.wrap_lm_trainer(jx.Trainer)(jx.CharRNN(vocab_size=256, embed_dim=8, hidden_dim=8,
                                            layer_dim=2),
                                 jx.TextDataset(windows), batch_size=8, learning_rate=1e-3)
    model = CharRNN(vocab_size=256, embed_dim=8, hidden_dim=8, layer_dim=2)
    model.load_state_dict(interop.jax_params_to_state_dict(jx.jax.tree.map(np.array, jt.params)))
    trainer = wrap_lm_trainer(Trainer)(model, TextDataset(windows), batch_size=8,
                                       learning_rate=1e-3, device="cpu")
    w = np.ones(8, np.float32)
    if tail:
        w[-tail:] = 0.0
    tokens = windows.astype(np.int32)
    want, metrics = jt._weighted_loss_and_metrics(
        jt.params, (jx.jnp.asarray(tokens), jx.jnp.zeros(8, jx.jnp.int32)), jx.jnp.asarray(w))
    loss, correct = trainer._weighted_loss_and_metrics(
        torch.from_numpy(tokens), torch.zeros(8, dtype=torch.int32), torch.from_numpy(w))
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(float(correct), float(metrics["correct"]), rtol=LOSS_TOL)


# ---------------------------------------------------------------------------
# DeviceStepAdam
# ---------------------------------------------------------------------------


def _adam_problem(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(shape).astype(np.float32) for shape in ((4, 3), (5,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in params]
             for _ in range(6)]
    return params, grads


def test_device_step_adam_matches_optax():
    jx = _jax()
    params, grads = _adam_problem()
    opt = jx.optax.adam(2.5e-3)
    jax_params = [jx.jnp.asarray(p) for p in params]
    state = opt.init(jax_params)
    tensors = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    adam = DeviceStepAdam(tensors, lr=2.5e-3)
    for step_grads in grads:
        updates, state = opt.update([jx.jnp.asarray(g) for g in step_grads], state, jax_params)
        jax_params = jx.optax.apply_updates(jax_params, updates)
        for t, g in zip(tensors, step_grads):
            t.grad = torch.from_numpy(g.copy())
        adam.step()
    for got, want in zip(tensors, jax_params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=ADAM_TOL,
                                   atol=ADAM_TOL)
    assert float(adam.device_steps) == len(grads)


def test_device_step_adam_state_dict_round_trips_through_torch_adam():
    params, grads = _adam_problem(1)
    ours = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    adam = DeviceStepAdam(ours, lr=1e-3)
    for step_grads in grads[:3]:
        for t, g in zip(ours, step_grads):
            t.grad = torch.from_numpy(g.copy())
        adam.step()
    saved = copy.deepcopy(adam.state_dict())
    assert all(s["step"].dtype == torch.float32 and s["step"].device.type == "cpu"
               and float(s["step"]) == 3 for s in saved["state"].values())

    theirs = [torch.nn.Parameter(p.detach().clone()) for p in ours]
    torch_adam = torch.optim.Adam(theirs, lr=1e-3)
    torch_adam.load_state_dict(copy.deepcopy(saved))
    torch_adam.step()  # grads of None: no step, the state stays loaded
    back = DeviceStepAdam([torch.nn.Parameter(p.detach().clone()) for p in ours], lr=1e-3)
    back.load_state_dict(copy.deepcopy(torch_adam.state_dict()))
    assert float(back.device_steps) == 3
    for i, state in back.state_dict()["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state[key], saved["state"][i][key]), (i, key)

    # both continue with the same step: the loaded count enters the bias
    # corrections (the device form against the host form, f32 rounding)
    for t, u, g in zip(back.param_groups[0]["params"], ours, grads[3]):
        t.grad = torch.from_numpy(g.copy())
        u.grad = torch.from_numpy(g.copy())
    back.step()
    from pytorch_distributed_rnn_tpu_torch.ops.adam import Adam

    host = Adam(ours, lr=1e-3)
    host.load_state_dict(copy.deepcopy(saved))
    host.step()
    for a, b in zip(back.param_groups[0]["params"], ours):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=ADAM_TOL,
                                   atol=ADAM_TOL)


# ---------------------------------------------------------------------------
# the fusable gate against the JAX trainer's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["validation", "checkpoint-every", "dropout-partial-batch",
                                  "grad-accum", "faults", "epoch-offset-resume"])
def test_fuse_run_refuses_where_jax_does(case, tmp_path):
    jx = _jax()
    X, y = generate_har_arrays(100, seq_length=8, seed=0)  # 2 batches of 48 and one of 4
    Xv, yv = generate_har_arrays(16, seq_length=8, seed=1)
    kw = dict(batch_size=48, learning_rate=1e-3, seed=SEED, fuse_run=True)
    dropout = 0.0
    if case == "validation":
        jax_kw = {"validation_set": jx.MotionDataset(Xv, yv)}
        port_kw = {"validation_set": MotionDataset(Xv, yv)}
    elif case == "checkpoint-every":
        jax_kw = port_kw = {"checkpoint_every": 1, "checkpoint_dir": tmp_path}
    elif case == "grad-accum":
        jax_kw = port_kw = {"grad_accum": 2}
    elif case == "faults":
        from pytorch_distributed_rnn_tpu.resilience import FaultSchedule as JaxFaults

        from pytorch_distributed_rnn_tpu_torch.resilience import FaultSchedule

        jax_kw = {"faults": JaxFaults.parse("epoch:9:stall")}
        port_kw = {"faults": FaultSchedule.parse("epoch:9:stall")}
    else:
        jax_kw = port_kw = {}
        dropout = 0.1 if case == "dropout-partial-batch" else 0.0
    jt = jx.Trainer(jx.MotionModel(hidden_dim=8, dropout=dropout), jx.MotionDataset(X, y),
                    **kw, **jax_kw)
    trainer = Trainer(MotionModel(hidden_dim=8, dropout=dropout), MotionDataset(X, y),
                      device="cpu", **kw, **port_kw)
    if case == "epoch-offset-resume":
        # each resumes its own checkpoint of epoch 1, and trains from there
        jt.checkpoint_dir = trainer.checkpoint_dir = tmp_path
        jt._save_checkpoint(0, 1.0)
        jt.resume_from(tmp_path / "checkpoint-epoch-1.ckpt", advance_epoch=True)
        (tmp_path / "port").mkdir()
        trainer.checkpoint_dir = tmp_path / "port"
        trainer._save_checkpoint(0, 1.0)
        trainer.resume_from(tmp_path / "port" / "checkpoint-epoch-1.ckpt", advance_epoch=True)
        assert jt._start_epoch == trainer._start_epoch == 1
    epochs = 2 if case == "epoch-offset-resume" else 1
    with pytest.raises(ValueError, match="--fuse-run") as theirs:
        jt.train(epochs=epochs)
    with pytest.raises(ValueError, match="--fuse-run") as ours:
        trainer.train(epochs=epochs)
    assert str(ours.value) == str(theirs.value) == FUSE_RUN_UNFUSABLE
    assert not trainer._buffers  # refused before any step


def test_fuse_run_with_dropout_fuses_where_the_batch_divides():
    trainer = _motion_trainer(192, 48, dropout=0.1, fuse_run=True)
    with _info_logging():
        trainer.train(epochs=1)
    assert list(trainer._buffers) == ["run"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs and the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_cuda_graph_path_matches_the_per_batch_loop_bitwise(cuda_device, dropout):
    """A two-layer motion LSTM (H=8), a partial final batch: two epochs of
    CUDA-graph replays against the per-batch loop."""
    eager, device, (h_eager, h_device) = _two_paths(
        lambda: _motion_trainer(200, 48, dropout=dropout, device=cuda_device))
    assert h_eager == h_device
    _assert_same_bits(eager, device)
    assert sorted(device.graphs) == [("epoch", 8), ("epoch", 48)]


@pytest.mark.cuda
def test_cuda_guard_inside_the_captured_step(cuda_device):
    """The guarded update captured in the step's graph: finite, the
    unguarded graph path's bits; a NaN step replayed from the graph moves
    nothing and counts on the device."""
    eager, device, (h_eager, h_device) = _two_paths(
        lambda: _motion_trainer(200, 48, dropout=0.1, device=cuda_device, max_bad_steps=2))
    assert h_eager == h_device
    _assert_same_bits(eager, device)
    plain = _two_paths(lambda: _motion_trainer(200, 48, dropout=0.1, device=cuda_device))
    assert plain[2][1] == h_device
    _assert_same_bits(plain[1], device)
    features, _ = device._device_train_data()
    features[0, 0, 0] = float("nan")  # one NaN row: the step whose batch holds it skips
    before = [p.detach().clone() for p in device.model.parameters()]
    steps = float(device.optimizer.device_steps)
    device.sampler.set_epoch(2)
    device._train_epoch(TrainingMessageFormatter(1), eager=False)
    assert device.optimizer.nonfinite.read()[1] == 1
    assert float(device.optimizer.device_steps) == steps + 4
    assert all(torch.isfinite(p).all() for p in device.model.parameters())
    assert not all(torch.equal(a, b) for a, b in zip(before, device.model.parameters()))


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_cuda_remat_recompute_replays_in_the_captured_backward(cuda_device, dropout):
    """--remat on the graph path: the forward kernels run again inside the
    captured backward (two forward launches a layer a step) and the run
    keeps the plain run's bits."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    runs = {}
    for remat in (False, True):
        fr.reset_launch_counts()
        eager, device, (h_eager, h_device) = _two_paths(
            lambda r=remat: _motion_trainer(200, 48, dropout=dropout, device=cuda_device,
                                            remat=r))
        torch.cuda.synchronize()
        assert h_eager == h_device
        runs[remat] = (device, h_device, dict(fr.LAUNCHES))
    assert runs[False][1] == runs[True][1]
    _assert_same_bits(runs[False][0], runs[True][0])
    assert runs[True][2]["lstm_fwd"] == 2 * runs[False][2]["lstm_fwd"]
    assert runs[True][2]["lstm_bwd"] == runs[False][2]["lstm_bwd"]


@pytest.mark.cuda
def test_cuda_launch_counts_count_replays(cuda_device):
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    trainer = _motion_trainer(192, 48, device=cuda_device)
    formatter = TrainingMessageFormatter(1)
    for eager in (True, False, False):  # the per-batch loop, a capture, replays only
        fr.reset_launch_counts()
        trainer._train_epoch(formatter, eager=eager)
        torch.cuda.synchronize()
        assert fr.LAUNCHES == {"lstm_fwd": 8, "lstm_bwd": 8, "gru_fwd": 0, "gru_bwd": 0}
    (graph,) = trainer.graphs.values()
    assert graph.replays == 3 + 4 and graph.tally == [
        (fr.LAUNCHES, "lstm_fwd"), (fr.LAUNCHES, "lstm_fwd"),
        (fr.LAUNCHES, "lstm_bwd"), (fr.LAUNCHES, "lstm_bwd")]
