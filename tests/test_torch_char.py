"""The port's char-LM family against the JAX package's, on the CPU.

``CharRNN`` (apply, loss, gradients, greedy ``generate``) with the JAX
weights carried over by ``interop``; the text dataset bit for bit; the
LM loss through the local trainer, and two-epoch loss histories of
``--model char --cell gru`` and ``--cell gru`` against the JAX trainer from
the same initial weights (rtol 1e-4, as ``test_torch_training.py``);
the CLI's ``--model``/``--seq-length`` handling.  Tolerances: f32 1e-5
forward and 1e-4 gradients, bf16 5e-2.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu.data import MotionDataset as JaxMotionDataset
from pytorch_distributed_rnn_tpu.data.synthetic import generate_char_tokens as jax_tokens
from pytorch_distributed_rnn_tpu.data.text import TextDataset as JaxTextDataset
from pytorch_distributed_rnn_tpu.models import CharRNN as JaxCharRNN
from pytorch_distributed_rnn_tpu.models import MotionModel as JaxMotionModel
from pytorch_distributed_rnn_tpu.models import num_params as jax_num_params
from pytorch_distributed_rnn_tpu.training.base import Trainer as JaxTrainer
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
from pytorch_distributed_rnn_tpu_torch.models import CharRNN, MotionModel, char_rnn_50m, num_params
from pytorch_distributed_rnn_tpu_torch.ops.initializers import embedding_init
from pytorch_distributed_rnn_tpu_torch.training import Trainer
from pytorch_distributed_rnn_tpu_torch.training.lm import LMLossMixin, wrap_lm_trainer

F32_FWD, F32_GRAD, BF16 = 1e-5, 1e-4, 5e-2
HISTORY_RTOL = 1e-4
SEED = 123456789
VOCAB = 40


def _pair(cell="gru", precision="f32", impl="scan", vocab=VOCAB, embed=12, hidden=16,
          layers=2, seed=3):
    jax_model = JaxCharRNN(vocab_size=vocab, embed_dim=embed, hidden_dim=hidden,
                           layer_dim=layers, cell=cell, precision=precision, impl="scan")
    params = jax_model.init(jax.random.PRNGKey(seed))
    model = CharRNN(vocab_size=vocab, embed_dim=embed, hidden_dim=hidden, layer_dim=layers,
                    cell=cell, impl=impl, precision=precision)
    model.load_state_dict(interop.jax_params_to_state_dict(params))
    return jax_model, params, model


def _tokens(batch, length, vocab=VOCAB, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(batch, length)).astype(np.int32)


# ---------------------------------------------------------------------------
# the model against the JAX model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["scan", "fused"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_apply_loss_and_grads_match_jax(cell, precision, impl):
    jax_model, params, model = _pair(cell, precision, impl)
    tokens = _tokens(5, 11, seed=1)
    fwd_tol = F32_FWD if precision == "f32" else BF16
    grad_tol = F32_GRAD if precision == "f32" else BF16

    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(tokens[:, :-1]))
    want = jax_model.apply(params, jnp.asarray(tokens[:, :-1]))
    assert logits.dtype == torch.float32 and logits.shape == (5, 10, VOCAB)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=fwd_tol, atol=fwd_tol)

    loss = model.loss(torch.from_numpy(tokens))
    loss.backward()
    loss = loss.detach()
    j_loss, j_grads = jax.value_and_grad(jax_model.loss)(params, jnp.asarray(tokens))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=fwd_tol, atol=fwd_tol)
    j_grads = interop.jax_params_to_state_dict(j_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(), rtol=grad_tol,
                                   atol=grad_tol, err_msg=name)


def test_parameter_names_follow_the_jax_tree():
    model = CharRNN(vocab_size=VOCAB, embed_dim=8, hidden_dim=8, layer_dim=2, cell="gru")
    assert sorted(model.state_dict()) == sorted(
        ["embed", "head.weight", "head.bias"]
        + [f"rnn.{i}.{n}" for i in range(2) for n in ("w_ih", "w_hh", "b_ih", "b_hh")]
    )
    assert model.rnn[0]["w_hh"].shape == (24, 8)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_interop_round_trip_of_char_params(cell):
    params = JaxCharRNN(vocab_size=VOCAB, embed_dim=6, hidden_dim=8, layer_dim=2,
                        cell=cell).init(jax.random.PRNGKey(9))
    back = interop.state_dict_to_jax_params(interop.jax_params_to_state_dict(params))
    flat_a, tree_a = jax.tree.flatten(jax.tree.map(np.asarray, params))
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_num_params_matches_jax_and_the_50m_preset():
    jax_model, params, model = _pair(layers=3)
    assert num_params(model) == jax_num_params(params)
    preset = char_rnn_50m()
    assert (preset.cell, len(preset.rnn), preset.embed.shape) == ("lstm", 4, (256, 512))
    assert 45e6 < num_params(preset) < 55e6


def test_embedding_init_is_scaled_normal_from_the_generator():
    table = embedding_init(torch.Generator().manual_seed(0), 300, 64)
    assert table.shape == (300, 64)
    # N(0, 1/64): 19200 samples -> std within ~1%
    assert abs(table.std().item() * 8.0 - 1.0) < 0.03
    torch.manual_seed(5)  # the global RNG must not matter
    assert torch.equal(table, embedding_init(torch.Generator().manual_seed(0), 300, 64))


def test_dropout_in_train_mode_only():
    _, _, model = _pair(cell="gru", layers=2)
    model.dropout = 0.5
    tokens = torch.from_numpy(_tokens(3, 9, seed=4))
    with torch.no_grad():
        a = model.eval()(tokens)
        model.train()
        b = model(tokens, torch.Generator().manual_seed(0))
        c = model(tokens, torch.Generator().manual_seed(0))
        assert torch.equal(b, c) and not torch.equal(a, b)
        with pytest.raises(ValueError, match="Generator"):
            model(tokens)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["scan", "fused"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_greedy_generate_matches_jax_and_stepwise_apply(cell, impl):
    """Greedy tokens equal the JAX model's on copied weights, and equal
    greedy decoding by re-applying the whole prefix each step."""
    jax_model, params, model = _pair(cell, impl=impl, hidden=24, seed=1)
    prompt = _tokens(3, 7, seed=0)
    out = model.eval().generate(torch.from_numpy(prompt), 6, temperature=0.0)
    assert out.shape == (3, 13) and out.dtype == torch.int32
    assert torch.equal(out[:, :7], torch.from_numpy(prompt))
    want = jax_model.generate(params, jnp.asarray(prompt), length=6, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))

    ref = torch.from_numpy(prompt)
    with torch.no_grad():
        for _ in range(6):
            nxt = model(ref)[:, -1, :].argmax(dim=-1).to(ref.dtype)
            ref = torch.cat([ref, nxt[:, None]], dim=1)
    assert torch.equal(out, ref)


def test_sampled_generate_is_seeded_and_in_vocab():
    _, _, model = _pair(layers=1)
    prompt = torch.zeros((2, 4), dtype=torch.int32)
    a = model.generate(prompt, 8, torch.Generator().manual_seed(7), temperature=1.0)
    b = model.generate(prompt, 8, torch.Generator().manual_seed(7), temperature=1.0)
    c = model.generate(prompt, 8, torch.Generator().manual_seed(8), temperature=1.0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < VOCAB


@pytest.mark.parametrize(
    "prompt_shape,temperature,generator",
    [((1, 2), -1.0, None), ((1, 2), 1.0, None), ((2, 0), 0.0, None), ((4,), 0.0, None)],
)
def test_generate_rejects_bad_args(prompt_shape, temperature, generator):
    _, _, model = _pair(layers=1)
    with pytest.raises(ValueError):
        model.generate(torch.zeros(prompt_shape, dtype=torch.int32), 2, generator,
                       temperature=temperature)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_char_tokens_matches_jax(seed):
    np.testing.assert_array_equal(generate_char_tokens(37, 21, 64, seed=seed),
                                  jax_tokens(37, 21, 64, seed=seed))


@pytest.mark.parametrize("source", ["synthetic", "corpus_file", "corpus_dir"])
def test_text_dataset_load_matches_jax(tmp_path, source):
    path = None
    if source != "synthetic":
        corpus = tmp_path / "corpus.txt"
        corpus.write_bytes(bytes(np.random.RandomState(2).randint(0, 256, 5000).astype(np.uint8)))
        path = corpus if source == "corpus_file" else tmp_path
    kw = dict(seq_length=24, validation_fraction=0.1, seed=5)
    ours = TextDataset.load(path, synthetic_sequences=300, **kw)
    theirs = JaxTextDataset.load(path, synthetic_sequences=300, **kw)
    for a, b in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.features.dtype == np.int32 and (a.seq_length, a.vocab_size) == (24, 256)
    assert TextDataset.resolve_corpus(path) == JaxTextDataset.resolve_corpus(path)


def test_text_dataset_warns_loudly_on_a_path_without_corpus(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        train, _, _ = TextDataset.load(tmp_path / "nothing", seq_length=8, synthetic_sequences=30)
    assert any("SYNTHETIC" in r.getMessage() for r in caplog.records)
    assert train.features.shape[1] == 9


def test_text_dataset_rejects_short_corpora_and_bad_windows(tmp_path):
    (tmp_path / "corpus.txt").write_bytes(b"abc" * 10)
    with pytest.raises(ValueError, match="too short"):
        TextDataset.load(tmp_path, seq_length=15)
    with pytest.raises(ValueError, match="windows"):
        TextDataset(np.zeros((4, 1), np.int32))


# ---------------------------------------------------------------------------
# the LM loss in the local trainer, against the JAX trainer
# ---------------------------------------------------------------------------


def test_lm_loss_and_token_accuracy():
    """``LMLossMixin``: next-token CE over shifted windows; ``correct`` is
    the sum over sequences of each one's mean token accuracy."""
    _, _, model = _pair(layers=1)
    tokens = torch.from_numpy(_tokens(4, 10, seed=6))

    class Host(LMLossMixin):
        pass

    host = Host()
    host.model = model.eval()
    loss, correct = host._loss_and_metrics(tokens, torch.zeros(4, dtype=torch.int32))
    torch.testing.assert_close(loss, model.loss(tokens))
    logits = model(tokens[:, :-1])
    acc = (logits.argmax(-1) == tokens[:, 1:].long()).float().mean(dim=1).sum()
    torch.testing.assert_close(correct, acc)
    assert wrap_lm_trainer(Trainer) is wrap_lm_trainer(Trainer)
    assert issubclass(wrap_lm_trainer(Trainer), Trainer)


def _windows():
    windows = generate_char_tokens(130, 12, 256, seed=1)
    return windows[:90], windows[90:110], windows[110:]


# the char LM with its default LSTM cell, and with --cell gru
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_char_gru_two_epoch_history_matches_jax_trainer(cell):
    train, valid, test = _windows()
    jax_sets = [JaxTextDataset(w) for w in (train, valid, test)]
    jax_cls = jax_wrap_lm(JaxTrainer)
    jt = jax_cls(JaxCharRNN(vocab_size=256, embed_dim=12, hidden_dim=12, layer_dim=2,
                            cell=cell), jax_sets[0], batch_size=40, learning_rate=5e-3,
                 validation_set=jax_sets[1], test_set=jax_sets[2], seed=SEED)
    init = jax.tree.map(np.array, jt.params)
    jax_params, jax_train, jax_valid = jt.train(epochs=2)

    model = CharRNN(vocab_size=256, embed_dim=12, hidden_dim=12, layer_dim=2, cell=cell,
                    impl="fused")
    model.load_state_dict(interop.jax_params_to_state_dict(init))
    trainer = wrap_lm_trainer(Trainer)(
        model, TextDataset(train), batch_size=40, learning_rate=5e-3,
        validation_set=TextDataset(valid), test_set=TextDataset(test), seed=SEED, device="cpu")
    _, train_history, valid_history = trainer.train(epochs=2)

    np.testing.assert_allclose(train_history, jax_train, rtol=HISTORY_RTOL)
    np.testing.assert_allclose(valid_history, jax_valid, rtol=HISTORY_RTOL)
    final = interop.state_dict_to_jax_params(trainer.model.state_dict())
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(jax_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["scan", "fused"])
def test_motion_gru_two_epoch_history_matches_jax_trainer(impl):
    arrays = [generate_har_arrays(n, seq_length=20, seed=s) for n, s in ((160, 0), (32, 1), (32, 2))]
    jax_sets = [JaxMotionDataset(*a) for a in arrays]
    jt = JaxTrainer(JaxMotionModel(hidden_dim=12, layer_dim=2, cell="gru"), jax_sets[0],
                    batch_size=64, learning_rate=2.5e-3, validation_set=jax_sets[1],
                    test_set=jax_sets[2], seed=SEED)
    init = jax.tree.map(np.array, jt.params)
    jax_params, jax_train, jax_valid = jt.train(epochs=2)

    train, valid, test = (MotionDataset(*a) for a in arrays)
    model = MotionModel(hidden_dim=12, layer_dim=2, cell="gru", impl=impl)
    model.load_state_dict(interop.jax_params_to_state_dict(init))
    trainer = Trainer(model, train, batch_size=64, learning_rate=2.5e-3, validation_set=valid,
                      test_set=test, seed=SEED, device="cpu")
    _, train_history, valid_history = trainer.train(epochs=2)

    np.testing.assert_allclose(train_history, jax_train, rtol=HISTORY_RTOL)
    np.testing.assert_allclose(valid_history, jax_valid, rtol=HISTORY_RTOL)
    final = interop.state_dict_to_jax_params(trainer.model.state_dict())
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(jax_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_char_local_run(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.INFO):
        trainer = port_main.main([
            "--device", "cpu", "--model", "char", "--cell", "gru", "--hidden-units", "8",
            "--stacked-layer", "1", "--seq-length", "6", "--batch-size", "512",
            "--dropout", "0", "--epochs", "2", "--seed", "2",
            "--dataset-path", str(tmp_path / "no-corpus"),
            "--checkpoint-directory", str(tmp_path / "models"), "local",
        ])
    history = json.loads((tmp_path / "history.json").read_text())
    assert len(history["train_history"]) == len(history["validation_history"]) == 2
    assert all(np.isfinite(history["train_history"] + history["validation_history"]))
    assert isinstance(trainer.model, CharRNN) and isinstance(trainer, LMLossMixin)
    # 2048 synthetic windows: 204 test, 204 validation, the rest train
    assert (len(trainer.training_set), len(trainer.validation_set)) == (1640, 204)
    assert trainer.model.embed.shape == (256, 8)
    assert (tmp_path / "models" / "best-model.ckpt").exists()
    messages = [r.getMessage() for r in caplog.records]
    assert any("SYNTHETIC" in m for m in messages)
    assert any(m.startswith("Test Evaluation:") for m in messages)


@pytest.fixture
def cache_dir(tmp_path):
    return write_synthetic_har_cache(tmp_path / "data", num_train=120, num_test=20, seq_length=8)


# --model attention / moe and --seq-length 0 are
# test_torch_training.py::test_other_model_families_exit's cases
@pytest.mark.parametrize(
    "flags,match",
    [(["--seq-length", "16"], "--seq-length only applies to --model char"),
     (["--model", "char", "--seq-length", "-3"], "--seq-length must be >= 1")],
)
def test_cli_model_and_seq_length_rejections(cache_dir, flags, match):
    with pytest.raises(SystemExit, match=match):
        port_main.main(["--device", "cpu", "--dataset-path", str(cache_dir), *flags, "local"])
