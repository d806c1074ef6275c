"""The port's toy-model examples (``pytorch_distributed_rnn_tpu_torch/
examples/``) against the JAX package's (``examples/``).

``example_single`` runs in process from JAX's parameters and draws, and
``example_generate`` from JAX's initial char LM on the same stream.
``example_ddp`` and ``example_horovod`` run at world 1 in process and at
world 2 in one spawned gloo world (``parallel/launch.py``), from JAX's
``ToyModel().init(PRNGKey(0))`` weights, against JAX's ``run`` on a
``dp`` mesh of the same size: final sums and every rank's per-step losses
and parameter sums within rtol 1e-5.  ``example_p2p`` relays rank 0's 1.0
around a spawned world of 3.
"""

import re

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch.examples import (
    example_ddp,
    example_generate,
    example_horovod,
    example_single,
)
from pytorch_distributed_rnn_tpu_torch.models import ToyModel
from pytorch_distributed_rnn_tpu_torch.parallel import launch

RTOL = 1e-5
LINE_RE = re.compile(r"^rank\s+(\d+)\s+(\w+):\s+(\S+)$", re.M)
PORT_EXAMPLES = {"ddp": example_ddp, "horovod": example_horovod}
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


def _lines(text: str) -> dict:
    """``{(rank, key): [values in order]}`` of the ``rank r key: value``
    lines (``None`` values, the first step's ``grad``, left out)."""
    out = {}
    for rank, key, value in LINE_RE.findall(text):
        if value != "None":
            out.setdefault((int(rank), key), []).append(float(value))
    return out


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """JAX's toy weights as a port ``state_dict`` file."""
    from pytorch_distributed_rnn_tpu.models import ToyModel as JaxToyModel

    params = jax.tree.map(np.array, JaxToyModel().init(jax.random.PRNGKey(0)))
    path = tmp_path_factory.mktemp("toy") / "init.pt"
    torch.save(interop.jax_params_to_state_dict(params), path)
    return path


def _jax_run(name: str, world: int, capsys) -> tuple:
    """JAX's example on a ``dp`` mesh of ``world``: its final sum and what
    it printed."""
    import importlib

    from pytorch_distributed_rnn_tpu.parallel import make_mesh

    module = importlib.import_module(f"examples.example_{name}")
    capsys.readouterr()
    final = module.run(make_mesh({"dp": world}))
    return final, capsys.readouterr().out


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_init):
    """``example_ddp`` then ``example_horovod`` on one spawned world of 2."""
    root = tmp_path_factory.mktemp("examples")
    jobs = {name: {"dir": str(root / name), "module": module.__name__,
                   "argv": ["--device", "cpu", "--init", str(jax_init)]}
            for name, module in PORT_EXAMPLES.items()}
    launch.spawn(2, list(jobs.values()), root, timeout=120)
    return {name: [torch.load(f"{job['dir']}/rank{r}.pt", weights_only=False)
                   for r in range(2)] for name, job in jobs.items()}


def _compare(port_outputs: list, port_final: float, jax_final: float, jax_text: str):
    assert port_final == pytest.approx(jax_final, rel=RTOL)
    want = _lines(jax_text)
    got = {}
    for text in port_outputs:
        assert "PARITY-OK" in text
        got.update(_lines(text))
    compared = [k for k in want if k[1] in ("loss", "parameters", "batch", "grad", "inputs",
                                            "labels", "initial", "synced")]
    assert compared
    for key in compared:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=1e-6, err_msg=str(key))


@pytest.mark.parametrize("name", list(PORT_EXAMPLES))
def test_world2_matches_jax(world2, name, capsys):
    results = world2[name]
    jax_final, jax_text = _jax_run(name, 2, capsys)
    _compare([r["stdout"] for r in results], results[0]["result"], jax_final, jax_text)
    assert results[1]["result"] == results[0]["result"]


@pytest.mark.parametrize("name", list(PORT_EXAMPLES))
def test_world1_in_process_matches_jax(name, jax_init, capsys, monkeypatch):
    for var in LAUNCHER_ENV:
        monkeypatch.delenv(var, raising=False)
    jax_final, jax_text = _jax_run(name, 1, capsys)
    final = PORT_EXAMPLES[name].main(["--device", "cpu", "--init", str(jax_init)])
    _compare([capsys.readouterr().out], final, jax_final, jax_text)


def test_p2p_relays_rank0s_value_around_a_world_of_3(tmp_path):
    job = {"dir": str(tmp_path / "p2p"), "module": "pytorch_distributed_rnn_tpu_torch.examples."
           "example_p2p", "argv": ["--device", "cpu"]}
    launch.spawn(3, [job], tmp_path, timeout=120)
    for rank in range(3):
        result = torch.load(tmp_path / "p2p" / f"rank{rank}.pt", weights_only=False)
        assert result["result"] == 1.0
        assert result["stdout"].strip() == f"Rank  {rank}  has data  1.0"


def test_example_single_matches_jax_update(monkeypatch):
    """One SGD step from JAX's Linear(10, 10) on JAX's draws: the updated
    parameters within 1e-6 of ``examples/example_single.py``'s."""
    import examples.example_single as jax_single
    from pytorch_distributed_rnn_tpu.ops import linear_init

    jax_printed, port_printed = [], []
    monkeypatch.setattr(jax_single, "print", jax_printed.append, raising=False)
    jax_single.run()
    pkey, xkey, ykey = jax.random.split(jax.random.PRNGKey(0), 3)
    init = jax.tree.map(np.array, linear_init(pkey, 10, 10))
    inputs = (np.array(jax.random.normal(xkey, (20, 10))),
              np.array(jax.random.normal(ykey, (20, 10))))
    monkeypatch.setattr(example_single, "print", port_printed.append, raising=False)
    total = example_single.run(state_dict=init, inputs=inputs, device="cpu")
    (want,), (got,) = jax_printed, port_printed
    for name in ("weight", "bias"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0, atol=1e-6)
        assert not np.array_equal(got[name].numpy(), init[name])  # a step was taken
    assert total == pytest.approx(sum(float(v.sum()) for v in got.values()))


def test_example_single_runs_seeded(capsys):
    total = example_single.main(["--device", "cpu"])
    assert np.isfinite(total) and "weight" in capsys.readouterr().out


def test_toy_model_takes_jax_weights_by_name():
    from pytorch_distributed_rnn_tpu.models import ToyModel as JaxToyModel

    params = JaxToyModel().init(jax.random.PRNGKey(0))
    model = ToyModel()
    model.load_state_dict(interop.jax_params_to_state_dict(jax.tree.map(np.array, params)))
    x = np.random.RandomState(1).randn(7, 10).astype(np.float32)
    want = np.asarray(JaxToyModel().apply(params, x))
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    assert sorted(model.state_dict()) == ["net1.bias", "net1.weight", "net2.bias", "net2.weight"]


def test_example_generate_matches_jax(monkeypatch):
    """300 Adam steps of the 1-layer char LM from JAX's initial weights on
    the same successor stream: the final loss JAX's example prints (4
    decimals), and greedy decoding reproduces the successor chain."""
    import examples.example_generate as jax_generate
    from pytorch_distributed_rnn_tpu.models import CharRNN as JaxCharRNN

    jax_printed, port_printed = [], []
    monkeypatch.setattr(jax_generate, "print", jax_printed.append, raising=False)
    jax_generate.main()
    params = JaxCharRNN(vocab_size=example_generate.VOCAB, embed_dim=16, hidden_dim=64,
                        layer_dim=1, impl="scan").init(jax.random.PRNGKey(example_generate.SEED))
    monkeypatch.setattr(example_generate, "print", port_printed.append, raising=False)
    result = example_generate.run(
        "cpu", interop.jax_params_to_state_dict(jax.tree.map(np.array, params)))
    want_loss = float(jax_printed[0].rsplit(" ", 1)[1])
    assert result["loss"] == pytest.approx(want_loss, abs=1e-4)
    assert port_printed[1:3] == jax_printed[1:3]  # the greedy decode and the chain
    assert port_printed[-1] == jax_printed[-1] == "generation ok"
    assert len(result["sampled"]) == 10 and all(0 <= t < example_generate.VOCAB
                                                for t in result["sampled"])
