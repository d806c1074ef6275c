"""Trainer registry: the ``local`` subcommand and the shared run tail,
the counterparts of the JAX package's ``training/__init__.py``
``add_sub_commands``/``train``/``_run_trainer``."""

from __future__ import annotations

import json
import logging

from pytorch_distributed_rnn_tpu_torch.training.base import Trainer

__all__ = ["Trainer", "add_sub_commands", "train"]


def add_sub_commands(sub_parser):
    local = sub_parser.add_parser("local")
    local.set_defaults(func=lambda args: train(args, Trainer))


def train(args, trainer_class):
    """Load the datasets, build the model and run the trainer."""
    logging.basicConfig(level=args.log)
    logging.getLogger().setLevel(args.log)
    from pytorch_distributed_rnn_tpu_torch.training import families

    training_set, validation_set, test_set = families.load_datasets(args)
    logging.info(f"Training set of size {len(training_set)}")
    if args.no_validation:
        validation_set = test_set = None
    else:
        logging.info(f"Validation set of size {len(validation_set)}")
        logging.info(f"Test set of size {len(test_set)}")
    model = families.build_model(args, training_set)
    return _run_trainer(args, trainer_class, model, (training_set, validation_set, test_set))


def _run_trainer(args, trainer_class, model, datasets):
    """Construct, optionally resume, train, and dump ``history.json`` into
    the working directory."""
    training_set, validation_set, test_set = datasets
    trainer = trainer_class(
        model=model,
        training_set=training_set,
        validation_set=validation_set,
        test_set=test_set,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        checkpoint_dir=args.checkpoint_directory,
        seed=args.seed,
        checkpoint_every=args.checkpoint_every,
        keep_checkpoints=args.keep_checkpoints,
        device=args.device,
    )
    if args.resume:
        meta = trainer.resume_from(args.resume)
        logging.info(f"Resumed from {args.resume} at epoch {meta['epoch']}")
    logging.info(f"Training model for {args.epochs} epochs...")
    _, train_history, validation_history = trainer.train(epochs=args.epochs)
    with open("history.json", "w") as file:
        json.dump({
            "train_history": train_history,
            "validation_history": validation_history,
        }, file)
    return trainer
