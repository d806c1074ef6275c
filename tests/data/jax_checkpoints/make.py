"""Write the JAX-written checkpoint fixture the port resumes.

    JAX_PLATFORMS=cpu python tests/data/jax_checkpoints/make.py

Runs the JAX package's own ``local`` trainer on the CPU, at the smoke's
path a model (the motion LSTM, 2 x 32, the CLI's defaults) with
``--dropout 0 --checkpoint-every 1``, on the seeded synthetic HAR cache
(``DATA``: fewer windows than the full dataset, so that the run is quick;
the checkpoint's size does not depend on them), for one epoch.  It keeps
``checkpoint-epoch-1.ckpt`` here, then resumes that file with ``--resume
auto`` for epochs 2-3 and writes ``expected.json``: the flags, the data,
the JAX trainer's train and validation losses of those epochs, and the
signature of its final parameters (``parameter_signature``).  The losses
alone are a weak check: a resume that starts Adam afresh moves them by
less than 1e-4, while it moves every parameter's signature by more than
1e-4 of its L1 norm.

``tests/test_torch_checkpoint_interop.py`` checks that JAX still reads
the file and continues to ``expected.json``, and the port's continuation
against it; ``chip_smoke.py`` phase s resumes it on the card.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent.parent
# the HAR cache: port's data/synthetic.py:write_synthetic_har_cache arguments
DATA = {"num_train": 3300, "num_test": 200, "seq_length": 128, "seed": 0, "split_seed": 0}
SEED = 0
FLAGS = ["--dropout", "0", "--seed", str(SEED), "--checkpoint-every", "1"]
EPOCHS = 3
# the final parameters' signature: seed of the sign vectors, and the
# largest error a continuation may show, relative to each parameter's L1 norm
PROBE_SEED = 0
SIGNATURE_RTOL = 1e-5


def parameter_signature(state) -> dict:
    """``{name: [projection, l1]}`` of a state dict of numpy arrays or CPU
    tensors: each parameter's dot product with a sign vector drawn from
    ``PROBE_SEED``, and its L1 norm, in float64."""
    import numpy as np

    signature = {}
    for name, value in state.items():
        flat = np.asarray(value, np.float64).ravel()
        signs = np.random.default_rng(PROBE_SEED).choice([-1.0, 1.0], flat.size)
        signature[name] = [float(flat @ signs), float(np.abs(flat).sum())]
    return signature


def signature_errors(state, expected: dict) -> dict:
    """Each parameter's projection error against ``expected``'s, relative
    to its L1 norm there (a missing or extra parameter raises)."""
    got = parameter_signature(state)
    if sorted(got) != sorted(expected):
        raise KeyError(f"parameters {sorted(got)} != {sorted(expected)}")
    return {name: abs(got[name][0] - want[0]) / want[1] for name, want in expected.items()}


def cli_argv(dataset: Path, checkpoints: Path, epochs: int, resume: bool = False) -> list:
    """The ``main`` command line of the fixture's runs (before ``local``)."""
    return ["--dataset-path", str(dataset), "--checkpoint-directory", str(checkpoints),
            "--epochs", str(epochs), *FLAGS, *(["--resume", "auto"] if resume else []),
            "local"]


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pytorch_distributed_rnn_tpu import main as jax_main
    from pytorch_distributed_rnn_tpu_torch.data.synthetic import write_synthetic_har_cache
    from pytorch_distributed_rnn_tpu_torch.training.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        dataset = write_synthetic_har_cache(tmp / "data", **DATA)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            jax_main.main(cli_argv(dataset, tmp / "models", 1))
            shutil.copy(tmp / "models" / "checkpoint-epoch-1.ckpt", HERE)
            jax_main.main(cli_argv(dataset, tmp / "models", EPOCHS, resume=True))
            history = json.loads((tmp / "history.json").read_text())
            final, _, _ = load_checkpoint(tmp / "models" / f"checkpoint-epoch-{EPOCHS}.ckpt")
        finally:
            os.chdir(cwd)
    expected = {
        "flags": FLAGS, "data": DATA, "epochs": EPOCHS,
        "checkpoint": "checkpoint-epoch-1.ckpt",
        "train_history": history["train_history"],
        "validation_history": history["validation_history"],
        "final_parameters": parameter_signature(final),
    }
    (HERE / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    print(json.dumps(expected))


if __name__ == "__main__":
    main()
