"""The port's ``AttentionLM`` (``models/attention_lm.py``) against the JAX
package's, on the CPU: the JAX weights carried over by ``interop``,
inputs from numpy seeds.  Logits and loss at 1e-5, gradients at 1e-4
(f32); the prefill and the cached decode step at 1e-5; greedy
``generate`` token for token; and, within the port, greedy ``generate``
against re-applying the model, seeded sampling, the cache-capacity
invariance (JAX ``tests/test_lm_generate.py:90``) and the argument
checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu.models import AttentionLM as JaxAttentionLM
from pytorch_distributed_rnn_tpu.models.attention_lm import (
    attention_decode_step as jax_decode_step,
)
from pytorch_distributed_rnn_tpu.models.attention_lm import attention_prefill as jax_prefill
from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch.models import AttentionLM
from pytorch_distributed_rnn_tpu_torch.models.attention_lm import (
    attention_decode_step,
    attention_prefill,
)

F32_FWD, F32_GRAD = 1e-5, 1e-4
VOCAB = 48


def _pair(dim=32, depth=2, heads=4, max_len=64, seed=1):
    jax_model = JaxAttentionLM(vocab_size=VOCAB, dim=dim, depth=depth, num_heads=heads,
                               max_len=max_len)
    params = jax_model.init(jax.random.PRNGKey(seed))
    model = AttentionLM(vocab_size=VOCAB, dim=dim, depth=depth, num_heads=heads,
                        max_len=max_len)
    model.load_state_dict(interop.jax_params_to_state_dict(params))
    return jax_model, params, model.eval()


def _tokens(batch, length, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, size=(batch, length)).astype(np.int32)


def test_parameter_names_follow_the_jax_tree():
    _, params, model = _pair()
    assert set(model.state_dict()) == set(interop.jax_params_to_state_dict(params))
    assert "blocks.1.ln2.scale" in model.state_dict() and "ln_f.bias" in model.state_dict()


def test_logits_loss_and_grads_match_jax():
    jax_model, params, model = _pair()
    tokens = _tokens(3, 12, seed=2)
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    want = jax.jit(jax_model.apply)(params, jnp.asarray(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=F32_FWD, atol=F32_FWD)

    loss = model.loss(torch.from_numpy(tokens))
    loss.backward()
    jax_loss, jax_grads = jax.jit(jax.value_and_grad(jax_model.loss))(params,
                                                                     jnp.asarray(tokens))
    assert loss.item() == pytest.approx(float(jax_loss), rel=F32_FWD)
    want_grads = interop.jax_params_to_state_dict(jax_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=F32_GRAD,
                                   atol=F32_GRAD, err_msg=name)


def test_prefill_and_decode_step_match_jax():
    """The shared serving functions: a prefill into a cache wider than the
    prompt, then cached steps at per-row positions."""
    _, params, model = _pair()
    prompt = _tokens(2, 5, seed=3)
    prefill = jax.jit(jax_prefill, static_argnums=(2, 3))
    step = jax.jit(jax_decode_step, static_argnums=5)
    jk, jv, jlogits = prefill(params, jnp.asarray(prompt), 4, model.max_len)
    pos = np.array([5, 3], np.int32)  # row 1 decodes over its own prompt's tail
    with torch.no_grad():
        k, v, logits = attention_prefill(model, torch.from_numpy(prompt), model.max_len)
        for i, tok in enumerate((None, [7, 9], [1, 40], [33, 0])):
            if tok is not None:
                tok, at = np.array(tok, np.int32), pos + i - 1
                k, v, logits = attention_decode_step(model, k, v, torch.from_numpy(at),
                                                     torch.from_numpy(tok))
                jk, jv, jlogits = step(params, jk, jv, jnp.asarray(at), jnp.asarray(tok), 4)
            for got, want in ((k, jk), (v, jv), (logits, jlogits)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_FWD,
                                           atol=F32_FWD)


def test_greedy_generate_matches_jax():
    jax_model, params, model = _pair(seed=4)
    prompt = _tokens(3, 7, seed=5)
    got = model.generate(torch.from_numpy(prompt), 9, temperature=0.0)
    want = jax_model.generate(params, jnp.asarray(prompt), 9, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_generate_matches_stepwise_apply():
    """The cached decode against re-applying the whole model each token."""
    _, _, model = _pair(seed=6)
    prompt = torch.from_numpy(_tokens(3, 7, seed=7))
    out = model.generate(prompt, 6, temperature=0.0)
    assert out.shape == (3, 13) and torch.equal(out[:, :7], prompt)
    ref = prompt
    with torch.no_grad():
        for _ in range(6):
            nxt = model(ref)[:, -1].argmax(dim=-1)
            ref = torch.cat([ref, nxt[:, None].to(ref.dtype)], dim=1)
    assert torch.equal(out, ref)


def test_sampled_generate_is_seeded_and_in_vocab():
    _, _, model = _pair(seed=2)
    prompt = torch.zeros((2, 4), dtype=torch.int32)

    def sample(seed):
        return model.generate(prompt, 8, generator=torch.Generator().manual_seed(seed),
                              temperature=1.0)

    a, b, c = sample(7), sample(7), sample(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < VOCAB


def test_cache_capacity_is_numerics_invariant():
    """Decoding under the serving engine's ``max_len`` cache reproduces
    ``generate``'s tight-cache tokens: padded columns weigh exactly 0."""
    _, _, model = _pair(seed=3)
    prompt = torch.from_numpy(_tokens(2, 5, seed=1))
    ref = model.generate(prompt, 6, temperature=0.0)
    with torch.no_grad():
        k, v, logits_all = attention_prefill(model, prompt, cache_len=model.max_len)
        logits = logits_all[:, -1]
        pos = torch.full((2,), 5)
        toks = []
        for _ in range(6):
            tok = logits.argmax(dim=-1)
            toks.append(tok)
            k, v, logits = attention_decode_step(model, k, v, pos, tok)
            pos = pos + 1
    assert torch.equal(torch.stack(toks, dim=1), ref[:, 5:].long())


def test_generate_is_bounded_by_max_len_and_checks_arguments():
    model = AttentionLM(vocab_size=VOCAB, dim=16, depth=1, num_heads=2, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        model.generate(torch.zeros((1, 10), dtype=torch.long), 7, temperature=0.0)
    assert model.generate(torch.zeros((1, 10), dtype=torch.long), 6,
                          temperature=0.0).shape == (1, 16)
    with pytest.raises(ValueError, match="max_len"):
        model(torch.zeros((1, 17), dtype=torch.long))
    prompt = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="temperature"):
        model.generate(prompt, 2, temperature=-1.0)
    with pytest.raises(ValueError, match="Generator"):
        model.generate(prompt, 2, temperature=1.0)
    with pytest.raises(ValueError, match="empty prompt"):
        model.generate(torch.zeros((1, 0), dtype=torch.long), 2, temperature=0.0)
    with pytest.raises(ValueError, match="divisible"):
        AttentionLM(dim=30, num_heads=4)
