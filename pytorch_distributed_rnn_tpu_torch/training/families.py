"""Model-family construction, the counterpart of the JAX package's
``training/families.py``.  The port has the ``rnn`` family (the motion
classifier) only; every other ``--model`` exits loudly."""

from __future__ import annotations

import torch

from pytorch_distributed_rnn_tpu_torch.data import MotionDataset


def load_datasets(args):
    """(train, validation, test) motion datasets from ``--dataset-path``."""
    if getattr(args, "seq_length", None) is not None:
        raise SystemExit(
            "--seq-length only applies to --model char (motion sequence "
            "length is a property of the HAR data)"
        )
    return MotionDataset.load(
        args.dataset_path,
        output_path=args.output_path,
        validation_fraction=args.validation_fraction,
        seed=args.seed,
    )


def build_model(args, training_set):
    """The motion model from the CLI flags, its weights drawn from a
    generator seeded with ``--seed``."""
    family = getattr(args, "model", "rnn")
    if family != "rnn":
        raise SystemExit(
            f"--model {family} is not ported yet - the PyTorch port trains "
            "--model rnn only (ROADMAP.md, port queue)"
        )
    from pytorch_distributed_rnn_tpu_torch.models import MotionModel

    seed = args.seed if args.seed is not None else 0
    return MotionModel(
        input_dim=training_set.num_features,
        hidden_dim=args.hidden_units,
        layer_dim=args.stacked_layer,
        output_dim=len(MotionDataset.LABELS),
        cell=args.cell,
        precision=args.precision,
        dropout=args.dropout or 0.0,
        generator=torch.Generator().manual_seed(seed),
    )
