"""Model-family construction, the counterpart of the JAX package's
``training/families.py``.  The port has the ``rnn`` family (the motion
classifier), the ``char`` family (the char LM) and the ``attention``
family (the attention classifier, on the HAR windows as ``rnn``); ``moe``
exits loudly."""

from __future__ import annotations

import torch

from pytorch_distributed_rnn_tpu_torch.data import MotionDataset


def family_of(args) -> str:
    return getattr(args, "model", "rnn")


def load_datasets(args):
    """(train, validation, test) for the selected family: token windows
    for ``char`` (``--seq-length``, default 128), motion windows from
    ``--dataset-path`` otherwise."""
    seq_length = getattr(args, "seq_length", None)
    if family_of(args) == "char":
        from pytorch_distributed_rnn_tpu_torch.data import TextDataset

        if seq_length is None:
            seq_length = 128
        elif seq_length < 1:
            raise SystemExit(f"--seq-length must be >= 1, got {seq_length}")
        return TextDataset.load(
            args.dataset_path,
            seq_length=seq_length,
            validation_fraction=args.validation_fraction,
            seed=args.seed,
        )
    if seq_length is not None:
        raise SystemExit(
            "--seq-length only applies to --model char (motion/attention "
            "sequence length is a property of the HAR data)"
        )
    return MotionDataset.load(
        args.dataset_path,
        output_path=args.output_path,
        validation_fraction=args.validation_fraction,
        seed=args.seed,
    )


def build_model(args, training_set):
    """The family's model from the CLI flags, its weights drawn from a
    generator seeded with ``--seed``."""
    family = family_of(args)
    if family not in ("rnn", "char", "attention"):
        raise SystemExit(
            f"--model {family} is not ported yet - the PyTorch port trains "
            "--model rnn, char and attention (ROADMAP.md, port queue)"
        )
    seed = args.seed if args.seed is not None else 0
    if family == "attention":
        from pytorch_distributed_rnn_tpu_torch.models import AttentionClassifier

        if args.cell != "lstm":
            raise SystemExit(
                "--model attention does not support: --cell gru "
                "(the encoder has no recurrent cell)"
            )
        return AttentionClassifier(
            input_dim=training_set.num_features,
            dim=args.hidden_units,
            depth=args.stacked_layer,
            num_heads=args.num_heads,
            output_dim=len(MotionDataset.LABELS),
            dropout=args.dropout or 0.0,
            precision=args.precision,
            generator=torch.Generator().manual_seed(seed),
            remat=getattr(args, "remat", False),
        )
    common = dict(
        layer_dim=args.stacked_layer,
        cell=args.cell,
        precision=args.precision,
        dropout=args.dropout or 0.0,
        generator=torch.Generator().manual_seed(seed),
        remat=getattr(args, "remat", False),
    )
    if family == "char":
        from pytorch_distributed_rnn_tpu_torch.models import CharRNN

        return CharRNN(
            vocab_size=training_set.vocab_size,
            embed_dim=args.hidden_units,
            hidden_dim=args.hidden_units,
            **common,
        )
    from pytorch_distributed_rnn_tpu_torch.models import MotionModel

    return MotionModel(
        input_dim=training_set.num_features,
        hidden_dim=args.hidden_units,
        output_dim=len(MotionDataset.LABELS),
        **common,
    )


def wrap_trainer(args, trainer_class):
    """The trainer class with the family's loss mixed in: the next-token
    loss for ``char``; the motion classifier's loss is the base class's."""
    if family_of(args) == "char":
        from pytorch_distributed_rnn_tpu_torch.training.lm import wrap_lm_trainer

        return wrap_lm_trainer(trainer_class)
    return trainer_class
