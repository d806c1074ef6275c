"""A world's checkpoint keeps every rank's dropout stream (ROADMAP C6).

A world of 2 on the CPU at dropout 0.1 with a checkpoint every epoch,
under ``distributed`` (gloo) and ``distributed-native`` (the TCP ring):
one run uninterrupted, one SIGKILLed by ``--faults epoch:1:kill`` at the
start of its second epoch, then restarted with ``--resume auto``.  The
restarted run must end on the uninterrupted run's parameters and Adam
state bit for bit (the final checkpoints compared tensor by tensor) on
every rank (each rank's sha256 of its parameters), which holds only if
each rank's dropout masks continue where they stopped.  The JAX package
derives a rank's masks from (seed, epoch); the port carries each rank's
generator state in the checkpoint, gathered to rank 0.

Every rank is a CLI process.  The four runs that need no checkpoint of
another run start together as one spawned world, the two restarts as a
second.
"""

import os
import re
import sys
from pathlib import Path

import pytest
import torch

from pytorch_distributed_rnn_tpu_torch.data import write_synthetic_har_dataset
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import load_checkpoint
from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports, spawn_world

ROOT = Path(__file__).resolve().parent.parent
STRATEGIES = ("distributed", "distributed-native")
WORLD = 2
EPOCHS = 3
DIGEST = re.compile(r"(\d+): parameters sha256 (\w+)")
# the CLI, run from the directory given first (rank 0 writes history.json there)
_IN_DIR = ("import os, runpy, sys; os.chdir(sys.argv[1]); sys.argv = sys.argv[1:]; "
           "runpy.run_module('pytorch_distributed_rnn_tpu_torch.main', run_name='__main__')")


def _rank_cmds(tmp_path, name, strategy, port, *extra):
    run = tmp_path / name
    run.mkdir(exist_ok=True)
    argv = ["--device", "cpu", "--dataset-path", str(tmp_path / "har"), "--epochs", str(EPOCHS),
            "--batch-size", "48", "--seed", "7", "--hidden-units", "8", "--stacked-layer", "2",
            "--dropout", "0.1", "--checkpoint-every", "1", "--no-validation",
            "--checkpoint-directory", str(run.parent / f"{name.split('-')[0]}-models"), *extra,
            strategy]
    cmds = []
    for rank in range(WORLD):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                   OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        cmds.append(([sys.executable, "-c", _IN_DIR, str(run), *argv], env))
    return cmds


def _digests(results) -> dict:
    found = {}
    for _, _, err in results:
        found.update(dict(DIGEST.findall(err)))
    return found


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per strategy: the uninterrupted run's and the restarted run's rank
    results (return code, stdout, stderr), and the killed run's."""
    tmp = tmp_path_factory.mktemp("resume_world")
    write_synthetic_har_dataset(tmp / "har", num_train=120, num_test=16, seq_length=12)
    ports = free_ports(4)
    first = []
    for i, strategy in enumerate(STRATEGIES):
        tag = strategy.replace("-", "_")
        first += _rank_cmds(tmp, f"{tag}ref-run", strategy, ports[2 * i])
        first += _rank_cmds(tmp, f"{tag}kill-run", strategy, ports[2 * i + 1],
                            "--faults", "epoch:1:kill")
    results = spawn_world(first, timeout=300, check=False)
    out = {}
    for i, strategy in enumerate(STRATEGIES):
        block = results[4 * i: 4 * i + 4]
        out[strategy] = {"ref": block[:2], "kill": block[2:]}
    ports = free_ports(2)
    second = []
    for i, strategy in enumerate(STRATEGIES):
        tag = strategy.replace("-", "_")
        second += _rank_cmds(tmp, f"{tag}kill-resume", strategy, ports[i], "--resume", "auto")
    results = spawn_world(second, timeout=300, check=False)
    for i, strategy in enumerate(STRATEGIES):
        tag = strategy.replace("-", "_")
        out[strategy]["resume"] = results[2 * i: 2 * i + 2]
        out[strategy]["models"] = {"ref": tmp / f"{tag}ref-models",
                                   "resume": tmp / f"{tag}kill-models"}
    return out


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_killed_world_resumes_every_ranks_dropout_stream_bitwise(runs, strategy):
    run = runs[strategy]
    for rc, _, err in run["ref"] + run["resume"]:
        assert rc == 0, err[-3000:]
    # the kill fired at the start of the second epoch on both ranks, after
    # the first epoch's checkpoint
    assert [rc for rc, _, _ in run["kill"]] == [-9, -9], run["kill"][0][2][-3000:]
    resumed_logs = "".join(err for _, _, err in run["resume"])
    assert "auto-resume: restored" in resumed_logs and "checkpoint-epoch-1.ckpt" in resumed_logs
    assert "holds no dropout stream" not in resumed_logs

    ref, resumed = (load_checkpoint(run["models"][k] / f"checkpoint-epoch-{EPOCHS}.ckpt")
                    for k in ("ref", "resume"))
    for key, value in ref[0].items():
        assert torch.equal(resumed[0][key], value), key
    ref_opt, resumed_opt = ref[1]["state"], resumed[1]["state"]
    assert sorted(ref_opt) == sorted(resumed_opt)
    for index, state in ref_opt.items():
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(resumed_opt[index][name], state[name]), (index, name)
        assert float(resumed_opt[index]["step"]) == float(state["step"])
    # every rank's stream is in the checkpoint, and each continued alike
    ref_streams = ref[2]["trainer"]["dropout_generators"]
    assert len(ref_streams) == WORLD
    for a, b in zip(ref_streams, resumed[2]["trainer"]["dropout_generators"]):
        assert torch.equal(a, b)
    ref_digests, resumed_digests = _digests(run["ref"]), _digests(run["resume"])
    assert sorted(ref_digests) == ["0", "1"]
    assert resumed_digests == ref_digests
