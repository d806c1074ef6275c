"""Trainer registry: the ``local``, ``distributed``, ``horovod`` and
``distributed-native`` subcommands and the shared run tail, the
counterparts of the JAX package's ``training/__init__.py``
``add_sub_commands``/``train``/``_run_trainer``.

``distributed`` and ``horovod`` run one process a rank: start them with
``torchrun`` (``python -m torch.distributed.run --nproc-per-node W -m
pytorch_distributed_rnn_tpu_torch.main ... distributed``).
``distributed-native`` runs one process a rank over the TCP ring
(``training/native_ddp.py``): any launcher that sets ``MASTER_ADDR``/
``MASTER_PORT``/``RANK``/``WORLD_SIZE`` (``torchrun`` does, or
``native_ddp.launch_world``).  Without a launcher each runs as a world of 1.
"""

from __future__ import annotations

import json
import logging

from pytorch_distributed_rnn_tpu_torch.training.base import Trainer
from pytorch_distributed_rnn_tpu_torch.training.distributed import (
    DDPTrainer,
    HorovodTrainer,
    SpmdTrainer,
)
from pytorch_distributed_rnn_tpu_torch.training.native_ddp import NativeDDPTrainer

__all__ = ["DDPTrainer", "HorovodTrainer", "NativeDDPTrainer", "SpmdTrainer", "Trainer",
           "add_sub_commands", "train"]


def add_sub_commands(sub_parser):
    for name, trainer_class in (("local", Trainer), ("distributed", DDPTrainer),
                                ("horovod", HorovodTrainer)):
        command = sub_parser.add_parser(name)
        command.set_defaults(func=lambda args, cls=trainer_class: train(args, cls),
                             strategy=name)
    from pytorch_distributed_rnn_tpu_torch.training import native_ddp

    sub_parser.add_parser("distributed-native").set_defaults(func=native_ddp.execute,
                                                             strategy="distributed-native")


def train(args, trainer_class):
    """Load the family's datasets, build its model and run the trainer
    with the family's loss mixed in.  A data-parallel strategy first joins
    the process group of its launch; rank 0 builds the kernels and
    prepares the data before the other ranks read them."""
    logging.basicConfig(level=args.log)
    logging.getLogger().setLevel(args.log)
    if not issubclass(trainer_class, SpmdTrainer):
        return _train(args, trainer_class)
    from pytorch_distributed_rnn_tpu_torch.parallel import collectives

    group = collectives.init_process_group(args.device)
    try:
        if group.device.type == "cuda":
            collectives.build_kernels_once(group)
        return _train(args, trainer_class, group, device=group.device, group=group,
                      sharded_update=args.sharded_update)
    finally:
        collectives.destroy(group)


def _train(args, trainer_class, ranks=None, **placement):
    """The datasets, the model and the run.  ``ranks`` (anything with
    ``rank`` and ``barrier()``: a process group, or the ring) orders the
    data preparation; ``placement`` holds the trainer's device and its
    strategy's arguments (the device of ``--device`` without them)."""
    from pytorch_distributed_rnn_tpu_torch.training import families

    if ranks is not None and ranks.rank != 0:
        ranks.barrier()  # rank 0 may write the data cache first
    datasets = families.load_datasets(args)
    if ranks is not None and ranks.rank == 0:
        ranks.barrier()
    training_set, validation_set, test_set = datasets
    logging.info(f"Training set of size {len(training_set)}")
    if args.no_validation:
        validation_set = test_set = None
    else:
        logging.info(f"Validation set of size {len(validation_set)}")
        logging.info(f"Test set of size {len(test_set)}")
    model = families.build_model(args, training_set)
    placement = placement or {"device": args.device}
    return _run_trainer(args, families.wrap_trainer(args, trainer_class), model,
                        (training_set, validation_set, test_set), **placement)


def _run_trainer(args, trainer_class, model, datasets, **placement):
    """Construct, optionally resume, train, and (rank 0) dump
    ``history.json`` into the working directory.  ``placement`` holds the
    device, and a data-parallel strategy's process group or ring and its
    options."""
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
        fuse_run=args.fuse_run,
        **placement,
    )
    if args.resume:
        meta = trainer.resume_from(args.resume)
        logging.info(f"Resumed from {args.resume} at epoch {meta['epoch']}")
    logging.info(f"Training model for {args.epochs} epochs...")
    _, train_history, validation_history = trainer.train(epochs=args.epochs)
    if trainer.rank == 0:
        with open("history.json", "w") as file:
            json.dump({
                "train_history": train_history,
                "validation_history": validation_history,
            }, file)
    return trainer
