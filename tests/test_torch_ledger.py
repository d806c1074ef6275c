"""The efficiency ledger's inputs in the port: the analytic FLOP count of
a train step (``obs/flops.py``) against the JAX package's
``closed_jaxpr_flop_stats`` over the jaxpr of the JAX trainer's step, and
the peak table (``utils/hw.py``).

JAX is traced with ``impl="scan"`` (and dense attention): a Pallas call
costs 1 an output element in its count.  The port counts its fused path
through the kernels' plain versions, whose backward forms the initial
carry's cotangent product as JAX's scan transpose does, so the matrix
products (2 * output elements * contraction) must agree exactly; the
elementwise ops differ in granularity (autograd's ``sigmoid_backward``
against JAX's three ops), so the total is held within 5%.  The widths are
small; every case has dropout, so the masks' ops are counted on both
sides.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu.data import MotionDataset as JaxMotionDataset
from pytorch_distributed_rnn_tpu.data.text import TextDataset as JaxTextDataset
from pytorch_distributed_rnn_tpu.models import AttentionClassifier as JaxClassifier
from pytorch_distributed_rnn_tpu.models import CharRNN as JaxCharRNN
from pytorch_distributed_rnn_tpu.models import MotionModel as JaxMotionModel
from pytorch_distributed_rnn_tpu.obs.flops import closed_jaxpr_flop_stats
from pytorch_distributed_rnn_tpu.training.base import Trainer as JaxTrainer
from pytorch_distributed_rnn_tpu.training.lm import wrap_lm_trainer as jax_wrap_lm
from pytorch_distributed_rnn_tpu_torch.data import (
    MotionDataset,
    TextDataset,
    generate_char_tokens,
    generate_har_arrays,
)
from pytorch_distributed_rnn_tpu_torch.models import AttentionClassifier, CharRNN, MotionModel
from pytorch_distributed_rnn_tpu_torch.obs.flops import FlopCountMode, step_flop_stats
from pytorch_distributed_rnn_tpu_torch.training import Trainer
from pytorch_distributed_rnn_tpu_torch.training.lm import wrap_lm_trainer
from pytorch_distributed_rnn_tpu_torch.utils.hw import local_peak_flops, peak_flops

BATCH = 24
TOTAL_RTOL = 0.05


def _family(name):
    """(JAX trainer, port trainer) of one family at a small width, both
    with dropout 0.1."""
    if name in ("lstm", "gru"):
        arrays = generate_har_arrays(48, seq_length=12, seed=0)
        jt = JaxTrainer(JaxMotionModel(hidden_dim=8, layer_dim=2, cell=name, impl="scan",
                                       dropout=0.1),
                        JaxMotionDataset(*arrays), batch_size=BATCH, learning_rate=2.5e-3, seed=1)
        pt = Trainer(MotionModel(hidden_dim=8, layer_dim=2, cell=name, dropout=0.1),
                     MotionDataset(*arrays), BATCH, 2.5e-3, seed=1, device="cpu")
    elif name == "char":
        windows = generate_char_tokens(48, 10, 256, seed=1)
        jt = jax_wrap_lm(JaxTrainer)(
            JaxCharRNN(vocab_size=256, embed_dim=12, hidden_dim=12, layer_dim=2, impl="scan",
                       dropout=0.1),
            JaxTextDataset(windows), batch_size=BATCH, learning_rate=5e-3, seed=1)
        pt = wrap_lm_trainer(Trainer)(
            CharRNN(vocab_size=256, embed_dim=12, hidden_dim=12, layer_dim=2, dropout=0.1),
            TextDataset(windows), BATCH, 5e-3, seed=1, device="cpu")
    else:
        arrays = generate_har_arrays(48, seq_length=16, seed=0)
        jt = JaxTrainer(JaxClassifier(input_dim=9, dim=16, depth=2, num_heads=2, output_dim=6,
                                      impl="dense", dropout=0.1),
                        JaxMotionDataset(*arrays), batch_size=BATCH, learning_rate=2.5e-3, seed=1)
        pt = Trainer(AttentionClassifier(input_dim=9, dim=16, depth=2, num_heads=2, output_dim=6,
                                         dropout=0.1),
                     MotionDataset(*arrays), BATCH, 2.5e-3, seed=1, device="cpu")
    return jt, pt


def _jax_step_stats(jt) -> dict:
    """JAX's count of its trainer's device-resident train step (the step
    its recorder traces), at one batch of ``BATCH`` rows."""
    features, labels = jt._device_train_data()
    key = jt._epoch_dropout_keys(0, 2)[0]
    closed = jax.make_jaxpr(jt._make_idx_train_step())(
        jt.params, jt.opt_state, features, labels, np.arange(BATCH), key)
    return closed_jaxpr_flop_stats(closed)


@pytest.mark.parametrize("family", ["lstm", "gru", "char", "attention"])
def test_step_flops_match_jax(family):
    jt, pt = _family(family)
    want = _jax_step_stats(jt)
    got = step_flop_stats(pt, BATCH)
    assert got["exact"] and want["exact"]
    assert got["matmul_flops"] == want["by_primitive"]["dot_general"]
    assert got["flops"] == pytest.approx(want["flops"], rel=TOTAL_RTOL)


@pytest.mark.parametrize("family", ["lstm", "gru", "char"])
def test_recurrent_count_extrapolates_exactly(family):
    """A recurrent step counted at lengths 3 and 4 and extrapolated gives
    the integers of the count at its own length."""
    _, pt = _family(family)
    assert step_flop_stats(pt, BATCH) == step_flop_stats(pt, BATCH, extrapolate=False)


def test_step_count_leaves_the_trainer_alone():
    """The count runs on fake tensors: the model's parameters, the
    optimizer state and the dropout stream are untouched."""
    _, pt = _family("lstm")
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    stream = pt.dropout_generator.get_state()
    step_flop_stats(pt, BATCH)
    for key, value in pt.model.state_dict().items():
        assert torch.equal(value, before[key])
    assert torch.equal(pt.dropout_generator.get_state(), stream)
    assert not pt.optimizer.state


def test_costing_rules():
    """A product costs 2 * output elements * contraction (and addmm's added
    term one an element), data moves cost nothing, another op one an
    element, an in-place op its first operand's elements."""
    a, b, bias = torch.zeros(4, 8), torch.zeros(8, 16), torch.zeros(16)
    with FlopCountMode() as mode:
        a @ b
        torch.addmm(bias, a, b)
        a.t().reshape(-1).clone()
        torch.cat([a, a])
        torch.tanh(a)
        a.add_(1.0)
    assert mode.matmul_flops == 2 * 2 * (4 * 16) * 8
    assert mode.by_op["add"] == 4 * 16
    assert mode.by_op["tanh"] == 32 and mode.by_op["add_"] == 32
    assert mode.flops == mode.matmul_flops + 64 + 64


def test_peak_table():
    h100 = peak_flops("gpu", "NVIDIA H100 80GB HBM3", "f32")
    assert h100 == {"peak_flops_per_device": 67e12, "device": "NVIDIA H100 80GB HBM3",
                    "estimated": False}
    assert peak_flops("gpu", "NVIDIA H100 80GB HBM3", "bf16")["peak_flops_per_device"] == 989e12
    other = peak_flops("gpu", "Some Other Card", "f32")
    assert other["estimated"] and other["peak_flops_per_device"] == 4e11
    local = local_peak_flops("cpu")
    assert local["estimated"] and local["backend"] == "cpu"
    assert local["peak_flops_total"] == local["peak_flops_per_device"]
