"""Process-per-rank worlds on one machine, and the rank entry they run.

    python -m torch.distributed.run --standalone --nproc-per-node W \\
        -m pytorch_distributed_rnn_tpu_torch.parallel.launch JOBS.json

Each rank joins the launch's process group (``collectives.init_process_group``)
and runs the jobs of ``JOBS.json`` (``{"device": "cuda" | "cpu", "jobs":
[...]}``) in order, every rank the same job, with a barrier after each.
A job is ``{"dir": DIR, "argv": [...]}``: the CLI (``main.main(argv)``),
each rank working in ``DIR/rank<r>/`` (so a relative
``--checkpoint-directory`` and ``history.json`` land there), with
``{rank}`` in an argument replaced by the rank.  ``"env"`` (a dict) is set
in the environment for the job's run, e.g. the ``MASTER_PORT`` of a
``distributed-native`` job's own ring.  The launch counts of the kernels
are set to 0 just before the run and read just after.  Each rank writes
``DIR/rank<r>.pt``: the final ``state_dict`` of the model, the launch
counts, the train steps the rank took, its INFO log lines, the run's
wall seconds, and for ``distributed-native`` every step's
``(comm_wait_s, comm_active_s)``.  With ``"profile": true`` (on the card)
the run goes under ``torch.profiler``: ``device_ms`` holds its device time
(kernels, copies, sets) a train step and ``kernels`` their counts by name.
``{"dir": DIR, "module": NAME, "argv": [...]}`` runs ``NAME.main(argv)``
(an example) and records what it printed (``stdout``) and returned
(``result``).  ``{"dir": DIR, "build_once": true}`` runs
``collectives.build_kernels_once`` with a build that only records which
rank ran it and when.

:func:`spawn` starts such a world with ``torch.multiprocessing`` and a file
rendezvous in ``workdir``, as the CPU tests do; its workers import this
module and nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import io
import json
import logging
import os
import sys
import time
from pathlib import Path

import torch


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _record_build(directory: Path, rank: int):
    """The build of a ``build_once`` job: takes a while, then records its
    rank and the time it finished."""
    time.sleep(0.5)
    (directory / f"built-{rank}").write_text(repr(time.time()))


def launch_counts() -> dict:
    """Every kernel's launches since the last reset."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    return {**fr.LAUNCHES, **fa.LAUNCHES}


def reset_launch_counts():
    from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    fr.reset_launch_counts()
    fa.reset_launch_counts()


@contextlib.contextmanager
def _environment(env: dict):
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update({key: str(value) for key, value in env.items()})
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _profiled(run, device: torch.device) -> tuple:
    """``run()`` under ``torch.profiler``: its result, the device
    microseconds of its kernels, copies and sets, and their counts by
    name."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_rnn_tpu_torch.utils.ab import device_events

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize(device)
    events = device_events(prof)
    return (result, sum(e.self_device_time_total for e in events),
            {e.key: e.count for e in events})


def _run_cli(group, directory: Path, job: dict):
    from pytorch_distributed_rnn_tpu_torch import main as port_main

    argv = [arg.replace("{rank}", str(group.rank)) for arg in job["argv"]]
    cwd = directory / f"rank{group.rank}"
    cwd.mkdir(parents=True, exist_ok=True)
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    here = os.getcwd()
    os.chdir(cwd)
    profiled = job.get("profile") and group.device.type == "cuda"
    device_us = kernels = None
    try:
        with _environment(job.get("env", {})):
            reset_launch_counts()
            t0 = time.perf_counter()
            if profiled:
                trainer, device_us, kernels = _profiled(lambda: port_main.main(argv),
                                                        group.device)
            else:
                trainer = port_main.main(argv)
            if group.device.type == "cuda":
                torch.cuda.synchronize(group.device)
            wall = time.perf_counter() - t0
            launches = launch_counts()
    finally:
        os.chdir(here)
        logging.getLogger().removeHandler(capture)
    epochs = port_main.build_parser().parse_args(argv).epochs
    steps = len(trainer._epoch_index_batches()) * epochs
    torch.save({
        "state": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()},
        "launches": launches,
        "steps": steps,
        "log": capture.messages,
        "wall": wall,
        "comm": getattr(trainer, "comm_log", None),
        "device_ms": None if device_us is None else device_us / 1e3 / steps,
        "kernels": kernels,
    }, directory / f"rank{group.rank}.pt")


def _run_module(group, directory: Path, job: dict):
    """``job["module"]``'s ``main(argv)`` on this rank (it joins the
    launch's process group), what it printed and what it returned."""
    module = importlib.import_module(job["module"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = module.main(job["argv"])
    torch.save({"stdout": out.getvalue(), "result": result}, directory / f"rank{group.rank}.pt")


def run_jobs(group, jobs: list):
    """Every job of ``jobs`` on this rank, a barrier after each."""
    from pytorch_distributed_rnn_tpu_torch.parallel import collectives

    for job in jobs:
        directory = Path(job["dir"])
        directory.mkdir(parents=True, exist_ok=True)
        if job.get("build_once"):
            collectives.build_kernels_once(
                group, build=functools.partial(_record_build, directory, group.rank))
            (directory / f"passed-{group.rank}").write_text(repr(time.time()))
        elif "module" in job:
            _run_module(group, directory, job)
        else:
            _run_cli(group, directory, job)
        group.barrier()


def _rank_main(rank: int, world_size: int, init_file: str, device: str, jobs: list):
    """The entry of a spawned rank: the launcher's environment, the process
    group, the jobs."""
    from pytorch_distributed_rnn_tpu_torch.parallel import collectives

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size))
    # the ranks share the host's cores, as torchrun's OMP_NUM_THREADS=1 makes them
    torch.set_num_threads(1)
    group = collectives.init_process_group(device, init_method=f"file://{init_file}")
    try:
        run_jobs(group, jobs)
    finally:
        collectives.destroy(group)


def spawn(world_size: int, jobs: list, workdir, device: str = "cpu", timeout: float = 600.0):
    """Run ``jobs`` on a world of ``world_size`` spawned ranks; raises if a
    rank fails or the world outlives ``timeout`` seconds (its processes
    are then stopped)."""
    import torch.multiprocessing as mp

    Path(workdir).mkdir(parents=True, exist_ok=True)
    init_file = Path(workdir) / "rendezvous"
    init_file.unlink(missing_ok=True)
    context = mp.start_processes(_rank_main, args=(world_size, str(init_file), device, jobs),
                                 nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world_size} ranks ran past {timeout} s")
    finally:
        for process in context.processes:
            if process.is_alive():
                process.terminate()
                process.join(timeout=10)


def main(argv=None) -> int:
    from pytorch_distributed_rnn_tpu_torch.parallel import collectives

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: python -m pytorch_distributed_rnn_tpu_torch.parallel.launch "
                         "JOBS.json (under torchrun)")
    spec = json.loads(Path(argv[0]).read_text())
    logging.basicConfig(level=logging.INFO)
    group = collectives.init_process_group(spec["device"])
    try:
        run_jobs(group, spec["jobs"])
    finally:
        collectives.destroy(group)
    return 0


if __name__ == "__main__":
    sys.exit(main())
