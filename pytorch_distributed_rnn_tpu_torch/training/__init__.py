"""Trainer registry: the ``local``, ``distributed``, ``horovod``,
``distributed-native`` and ``parameter-server`` subcommands and the shared
run tail, the counterparts of the JAX package's ``training/__init__.py``
``add_sub_commands``/``train``/``_run_trainer``.

``distributed`` and ``horovod`` run one process a rank: start them with
``torchrun`` (``python -m torch.distributed.run --nproc-per-node W -m
pytorch_distributed_rnn_tpu_torch.main ... distributed``).
``distributed-native`` runs one process a rank over the TCP ring
(``training/native_ddp.py``): any launcher that sets ``MASTER_ADDR``/
``MASTER_PORT``/``RANK``/``WORLD_SIZE`` (``torchrun`` does, or
``native_ddp.launch_world``).  Without a launcher each runs as a world of 1.
``parameter-server`` (``param_server/``) spawns its own world, or runs one
role a process with ``--rank``.

The run tail (:func:`_run_trainer`) wires the telemetry flags as the JAX
package's does: ``--metrics`` (or ``PDRNN_METRICS``) a rank-suffixed
JSONL sidecar a rank (``obs/recorder.py``), ``--live`` (or
``PDRNN_LIVE``) the live plane and its watchdog (``obs/live.py``: rank 0
serves ``/metrics``, ``/health``, ``/events`` and ``/fleet``, the other
ranks push to it; ``--live-port-file`` reports the port), a SIGUSR2
stack dump beside the sidecar, ``--profile DIR`` a trace of the whole
run and ``--profile-steps A:B`` of a step range (``obs/profile.py``).
"""

from __future__ import annotations

import json
import logging
import os

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
    from pytorch_distributed_rnn_tpu_torch import param_server

    param_server.add_sub_command(sub_parser)


def train(args, trainer_class):
    """Load the family's datasets, build its model and run the trainer
    with the family's loss mixed in.  A data-parallel strategy first joins
    the process group of its launch; rank 0 builds the kernels and
    prepares the data before the other ranks read them, and each rank
    ends with its parameters' digest (:func:`log_parameter_digest`)."""
    logging.basicConfig(level=args.log)
    logging.getLogger().setLevel(args.log)
    if not issubclass(trainer_class, SpmdTrainer):
        return _train(args, trainer_class)
    from pytorch_distributed_rnn_tpu_torch.parallel import collectives

    # before the process group, bound to the launcher's rank
    faults = resolve_faults(args, rank=int(os.environ.get("RANK", "0")))
    group = collectives.init_process_group(args.device)
    try:
        if group.device.type == "cuda":
            collectives.build_kernels_once(group)
        trainer = _train(args, trainer_class, group, device=group.device, group=group,
                         sharded_update=args.sharded_update, faults=faults)
        log_parameter_digest(group.rank, trainer.model)
        return trainer
    finally:
        collectives.destroy(group)


def log_parameter_digest(rank: int, model) -> None:
    """The rank-parity observable of a world's rank: ``"{rank}: parameters
    sha256 {hex}"``, the digest of the parameters' float32 bytes in
    ``parameters()`` order (equal digests: equal bits)."""
    from pytorch_distributed_rnn_tpu_torch.param_server.runner import (
        flat_parameters,
        parameters_digest,
    )

    logging.info(f"{rank}: parameters sha256 {parameters_digest(flat_parameters(model))}")


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


def resolve_faults(args, rank: int | None = None):
    """The run's fault schedule (``--faults``, else ``PDRNN_CHAOS``), bound
    to ``rank`` and logged; its ``net:*`` events are exported onto the
    transport's ``PDRNN_FAULT_*`` environment, so call it before any ring
    or spawned process exists.  ``nan`` needs floating-point features and
    is refused for ``--model char``."""
    from pytorch_distributed_rnn_tpu_torch.resilience.faults import NAN_NEEDS_FLOAT, FaultSchedule
    from pytorch_distributed_rnn_tpu_torch.training import families

    faults = FaultSchedule.resolve(args, rank=rank)
    if faults is None:
        return None
    if families.family_of(args) == "char" and faults.has_action("nan"):
        raise SystemExit(NAN_NEEDS_FLOAT)
    logging.warning(f"chaos schedule active: {faults}")
    return faults


def _run_trainer(args, trainer_class, model, datasets, **placement):
    """Construct, optionally resume, train (under the telemetry the
    flags ask for), and (rank 0) dump ``history.json`` into the working
    directory.  ``placement`` holds the device, and a data-parallel
    strategy's process group or ring and its options, and the fault
    schedule its entry point resolved (``faults``; ``local`` resolves it
    here)."""
    import contextlib

    from pytorch_distributed_rnn_tpu_torch.obs.profile import StepTraceCapture, run_trace
    from pytorch_distributed_rnn_tpu_torch.obs.recorder import MetricsRecorder

    if "faults" not in placement:
        placement["faults"] = resolve_faults(args)
    world = placement.get("group") or placement.get("comm")
    rank = world.rank if world is not None else 0
    # --metrics beats PDRNN_METRICS; the NULL recorder (no thread) when off
    recorder = MetricsRecorder.resolve(args, rank=rank)
    profile_steps = StepTraceCapture.resolve(args)
    plane = None
    if recorder.enabled:
        from pytorch_distributed_rnn_tpu_torch.obs.live import LivePlane
        from pytorch_distributed_rnn_tpu_torch.obs.watchdog import install_stack_dump_handler

        # kill -USR2 <pid>: every thread's stack beside the sidecar
        install_stack_dump_handler(recorder.path)
        plane = LivePlane.resolve(args, recorder, rank=rank, role="trainer",
                                  faults=placement["faults"])
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
        grad_accum=args.grad_accum,
        max_bad_steps=args.max_bad_steps,
        recorder=recorder,
        profile_steps=profile_steps,
        **placement,
    )
    if args.resume is not None and str(args.resume) == "auto":
        # the newest valid checkpoint wins, a corrupt one falls back to the
        # one before it, none starts fresh
        from pytorch_distributed_rnn_tpu_torch.resilience import resume_latest

        if resume_latest(trainer, args.checkpoint_directory) is None:
            logging.info(f"--resume auto: no usable checkpoint in "
                         f"{args.checkpoint_directory}; starting fresh")
    elif args.resume:
        meta = trainer.resume_from(args.resume)
        logging.info(f"Resumed from {args.resume} at epoch {meta['epoch']}")
    logging.info(f"Training model for {args.epochs} epochs...")
    trace = (run_trace(args.profile, trainer.device, rank)
             if args.profile and profile_steps is None else contextlib.nullcontext())
    try:
        with trace:
            _, train_history, validation_history = trainer.train(epochs=args.epochs)
    finally:
        # the sidecar drains even when training raises; the plane closes
        # after the recorder, so its final digest (finished) lands first
        recorder.close()
        if plane is not None:
            plane.close()
    if trainer.rank == 0:
        with open("history.json", "w") as file:
            json.dump({
                "train_history": train_history,
                "validation_history": validation_history,
            }, file)
    return trainer
