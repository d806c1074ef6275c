"""The port's parameter-server master logic and its resilience helpers
(``pytorch_distributed_rnn_tpu_torch/param_server/master.py``,
``resilience/{retry,membership}.py``), on recording fake transports: the
JAX package's ``TestMasterLogic``, ``TestSyncTimeout`` and
``TestQuorumDegradation`` (``tests/test_param_server.py``), and its retry
cases (``tests/test_resilience.py``, ``tests/test_elastic.py``), with the
backoff schedule equal to JAX's."""

import threading
import time
from collections import deque

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch.param_server import protocol
from pytorch_distributed_rnn_tpu_torch.param_server.master import ParameterServerMaster
from pytorch_distributed_rnn_tpu_torch.resilience import (
    DrainRequested,
    DrainSignal,
    Roster,
    backoff_delays,
    retry_transport,
)
from pytorch_distributed_rnn_tpu_torch.resilience import membership


def _t(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32)


class ScriptedComm:
    """Master side of one worker's socket: ``recv`` pops scripted
    messages, ``send`` records (destination, copy)."""

    def __init__(self, inbox, world_size=2):
        self.world_size = world_size
        self.inbox = deque(inbox)
        self.sent = []

    def recv(self, src, shape, dtype=torch.float32):
        return self.inbox.popleft().reshape(shape)

    def send(self, dst, data):
        self.sent.append((dst, torch.as_tensor(data).clone()))


class _RecordingComm:
    """Master side of a world whose workers the test calls in: ``send``
    records (destination, copy)."""

    def __init__(self, world_size):
        self.world_size = world_size
        self.sent = []

    def send(self, dst, data):
        self.sent.append((dst, torch.as_tensor(data).clone()))


def _push(seq, grads):
    return [_t([float(protocol.OP_PUSH), float(seq)]), grads]


DONE = [_t([float(protocol.OP_DONE), 0.0])]


def _stepper(state, lr=0.1):
    def apply_update(g):
        state["p"] = state["p"] - lr * g
        return state["p"]

    return apply_update


# ---------------------------------------------------------------------------
# the service loop


def test_master_rejects_a_non_finite_gradient():
    n = 10
    comm = ScriptedComm(_push(1, torch.full((n,), float("nan"))))
    master = ParameterServerMaster(comm, torch.zeros(n), lambda g: g)
    with pytest.raises(RuntimeError, match="non-finite"):
        master._serve_worker(1)
    assert master.updates_applied == 0 and comm.sent == []


def test_master_rejects_a_malformed_gradient():
    class ShortComm(ScriptedComm):
        def recv(self, src, shape, dtype=torch.float32):
            return self.inbox.popleft()

    comm = ShortComm(_push(1, torch.ones(3)))
    master = ParameterServerMaster(comm, torch.zeros(4), lambda g: g)
    with pytest.raises(RuntimeError, match="malformed"):
        master._serve_worker(1)


def test_master_applies_updates_in_arrival_order():
    """Async mode: every push advances the params and replies with the
    fresh vector."""
    n = 4
    state = {"p": torch.zeros(n)}
    comm = ScriptedComm(_push(1, torch.ones(n)) + _push(2, 2 * torch.ones(n)) + DONE)
    master = ParameterServerMaster(comm, state["p"], _stepper(state))
    master._serve_worker(1)
    assert master.updates_applied == 2
    np.testing.assert_allclose(state["p"].numpy(), -0.3 * np.ones(n), rtol=1e-6)
    assert [dst for dst, _ in comm.sent] == [1, 1]
    np.testing.assert_allclose(comm.sent[0][1].numpy(), -0.1 * np.ones(n), rtol=1e-6)
    assert master.roster.member_for_rank(1).state == membership.DONE


def test_duplicate_push_seq_is_not_applied_again():
    """A retried push (the reply leg failed after the update applied)
    carries the same seq: the master replies with the current params
    without a second update."""
    n = 4
    state = {"p": torch.zeros(n)}
    comm = ScriptedComm(_push(1, torch.ones(n)) + _push(1, torch.ones(n))
                        + _push(2, torch.ones(n)) + DONE)
    master = ParameterServerMaster(comm, state["p"], _stepper(state))
    master._serve_worker(1)
    assert master.updates_applied == 2  # seq 1 once + seq 2, not 3
    np.testing.assert_allclose(state["p"].numpy(), -0.2 * np.ones(n), rtol=1e-6)
    assert len(comm.sent) == 3  # the duplicate still gets its reply


def test_pull_replies_with_the_current_params_and_deregister_drains():
    n = 3
    comm = ScriptedComm([_t([float(protocol.OP_PULL), 0.0]),
                         _t([float(protocol.OP_DEREGISTER), 7.0])])
    master = ParameterServerMaster(comm, _t([1.0, 2.0, 3.0]), lambda g: g)
    master._serve_worker(1)
    assert len(comm.sent) == 1 and comm.sent[0][0] == 1
    assert comm.sent[0][1].tolist() == [1.0, 2.0, 3.0]
    assert master.roster.member_for_rank(1).state == membership.DRAINED
    assert master.roster.round_ranks() == set()


def test_an_elastic_opcode_is_refused_loudly():
    comm = ScriptedComm([_t([float(protocol.OP_REGISTER), 1.0])])
    master = ParameterServerMaster(comm, torch.zeros(2), lambda g: g)
    with pytest.raises(RuntimeError, match="does not handle"):
        master._serve_worker(1)


@pytest.mark.parametrize("arrival", [(1, 2, 3), (3, 1, 2), (2, 3, 1)])
def test_sync_round_averages_in_rank_order(arrival):
    """Three workers' pushes in any arrival order close one round whose
    gradient is ((g1 + g2) + g3) / 3, summed in rank order: the same bits
    (float32 addition is not associative: 1e8 + 1 - 1e8 is 0, 1e8 - 1e8 + 1
    is 1)."""
    grads = {1: _t([1e8, 0.1, 0.3]), 2: _t([1.0, 0.2, 1e-8]), 3: _t([-1e8, 0.7, 3.0])}
    applied = []
    master = ParameterServerMaster(_RecordingComm(4), torch.zeros(3),
                                   lambda g: applied.append(g.clone()) or g,
                                   sync_mode=True, sync_timeout=30.0)
    waiters = []
    for worker in arrival[:-1]:
        waiters.append(threading.Thread(target=master._push_sync, args=(worker, grads[worker])))
        waiters[-1].start()
        time.sleep(0.05)
    master._push_sync(arrival[-1], grads[arrival[-1]])
    for t in waiters:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in waiters) and master.updates_applied == 1
    assert torch.equal(applied[0], ((grads[1] + grads[2]) + grads[3]) / 3)
    assert applied[0][0] == 0.0


# ---------------------------------------------------------------------------
# sync rounds: timeout, quorum, deaths


def test_sync_round_timeout_raises():
    """A straggler past sync_timeout errors loudly in strict mode (quorum
    1.0), rather than proceeding with stale params."""
    master = ParameterServerMaster(_RecordingComm(3), torch.zeros(4), lambda g: g,
                                   sync_mode=True, sync_timeout=0.2)
    with pytest.raises(RuntimeError, match="timed out"):
        master._push_sync(1, torch.zeros(4))


def _quorum_master(num_workers, quorum, timeout=0.3):
    comm = _RecordingComm(num_workers + 1)
    applied = []

    def apply_update(g):
        applied.append(g.clone())
        return -g  # a recognizable reply payload

    master = ParameterServerMaster(comm, torch.zeros(4), apply_update, sync_mode=True,
                                   sync_timeout=timeout, quorum=quorum)
    return master, comm, applied


def test_round_degrades_to_quorum_on_timeout():
    """3 workers, quorum 0.5: two gradients and a straggler past the
    timeout -> ONE update over the partial mean, both pushers released."""
    master, comm, applied = _quorum_master(3, quorum=0.5)
    threads = [threading.Thread(target=master._push_sync, args=(1, torch.full((4,), 1.0))),
               threading.Thread(target=master._push_sync, args=(2, torch.full((4,), 3.0)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert master.updates_applied == 1 and master.degraded_rounds == 1
    np.testing.assert_allclose(applied[0].numpy(), np.full(4, 2.0))  # mean(1, 3)
    assert sorted(dst for dst, _ in comm.sent) == [1, 2]  # not worker 3
    for _, params in comm.sent:
        np.testing.assert_allclose(params.numpy(), -np.full(4, 2.0))


def test_timeout_below_quorum_still_raises():
    """quorum 0.9 of 3 workers needs 3 gradients: one pusher alone times
    out fatally - degradation never goes below the floor."""
    master, _, applied = _quorum_master(3, quorum=0.9)
    with pytest.raises(RuntimeError, match="quorum 3/3 not met"):
        master._push_sync(1, torch.zeros(4))
    assert applied == [] and master.updates_applied == 0


def test_straggler_joins_the_next_round():
    """A gradient landing after its round degraded joins the NEXT round as
    an ordinary (stale) contribution."""
    master, _, applied = _quorum_master(2, quorum=0.5)
    master._push_sync(1, torch.full((4,), 1.0))  # round 1: alone, degrades
    assert master.degraded_rounds == 1
    t = threading.Thread(target=master._push_sync, args=(2, torch.full((4,), 8.0)))
    t.start()
    time.sleep(0.05)  # the straggler enters the round first
    master._push_sync(1, torch.full((4,), 2.0))
    t.join(timeout=10)
    assert not t.is_alive()
    assert master.updates_applied == 2 and master.degraded_rounds == 1
    np.testing.assert_allclose(applied[1].numpy(), np.full(4, 5.0))  # mean(8, 2)


def test_dead_worker_shrinks_later_rounds():
    """``_mark_dead`` drops a worker from the rendezvous: the in-flight
    round closes over the survivors at once, later rounds need only the
    live workers."""
    master, _, applied = _quorum_master(2, quorum=0.5, timeout=30.0)
    t = threading.Thread(target=master._push_sync, args=(1, torch.full((4,), 4.0)))
    t.start()
    time.sleep(0.05)
    master._mark_dead(2, RuntimeError("socket closed"))
    t.join(timeout=10)  # closed by the death path, not the 30 s timeout
    assert not t.is_alive()
    assert master.updates_applied == 1 and master.degraded_rounds == 0
    np.testing.assert_allclose(applied[0].numpy(), np.full(4, 4.0))
    master._push_sync(1, torch.full((4,), 6.0))  # closes on worker 1 alone
    assert master.updates_applied == 2
    assert master.roster.counts()["dead"] == 1


@pytest.mark.parametrize("bad", [0.0, -0.5, 1.5])
def test_quorum_validation(bad):
    with pytest.raises(ValueError, match="quorum"):
        ParameterServerMaster(_RecordingComm(3), torch.zeros(2), lambda g: g, quorum=bad)


def test_serve_reraises_a_failed_worker_in_strict_mode():
    comm = ScriptedComm(_push(1, torch.full((2,), float("inf"))))
    master = ParameterServerMaster(comm, torch.zeros(2), lambda g: g)
    with pytest.raises(RuntimeError, match="worker thread"):
        master.serve()


# ---------------------------------------------------------------------------
# roster and drain


def test_roster_lifecycle_and_watermarks():
    roster = Roster()
    roster.bootstrap([1, 2, 3])
    assert roster.round_ranks() == {1, 2, 3}
    assert roster.note_push(1, 1) and roster.note_push(1, 2)
    assert not roster.note_push(1, 2) and not roster.note_push(1, 1)  # duplicates
    assert roster.note_push(99, 1)  # unrostered: passes through
    roster.complete(1)
    roster.drain(2, seq=5)
    roster.mark_dead(3, error="gone")
    assert roster.counts() == {"joined": 0, "drained": 1, "dead": 1, "done": 1}
    assert roster.round_ranks() == set() and not roster.all_terminal()
    assert roster.member_for_rank(3).error == "gone"
    assert roster.member_for_rank(1).push_seq == 2


def test_drain_signal_raises_only_once_requested():
    drain = DrainSignal()
    drain.check()
    drain._on_sigterm(15, None)
    with pytest.raises(DrainRequested):
        drain.check()


# ---------------------------------------------------------------------------
# retry_transport


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("deadline", [None, 0.01, 0.1, 1.0, 5.0])
def test_backoff_delays_equal_jax_and_stay_under_the_budget(seed, deadline):
    from pytorch_distributed_rnn_tpu.resilience.retry import backoff_delays as jax_backoff

    delays = backoff_delays(64, seed=seed, deadline_s=deadline)
    assert delays == jax_backoff(64, seed=seed, deadline_s=deadline)
    if deadline is not None:
        assert sum(delays) <= deadline
        assert delays == backoff_delays(64, seed=seed)[:len(delays)]  # trimmed from the tail


def test_retries_then_succeeds_with_exponential_jittered_sleeps():
    calls, sleeps = {"n": 0}, []

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError(f"transient {calls['n']}")
        return "ok"

    assert retry_transport(flaky, retries=3, sleep=sleeps.append) == "ok"
    assert calls["n"] == 3 and len(sleeps) == 2
    assert 0.05 <= sleeps[0] < 0.075 and 0.10 <= sleeps[1] < 0.15


def test_exhausted_retries_raise_the_first_error_and_others_pass_through():
    calls = {"n": 0}

    def always_bad():
        calls["n"] += 1
        raise RuntimeError(f"failure {calls['n']}")

    with pytest.raises(RuntimeError, match="failure 1"):
        retry_transport(always_bad, retries=2, sleep=lambda _: None)
    assert calls["n"] == 3

    def bad():
        raise KeyError("not a transport error")

    with pytest.raises(KeyError):
        retry_transport(bad, retries=5, sleep=lambda _: None)


def test_the_deadline_trims_attempts_and_elapsed_time_burns_it():
    calls = {"n": 0}

    def always_bad():
        calls["n"] += 1
        raise RuntimeError(f"failure {calls['n']}")

    with pytest.raises(RuntimeError, match="failure 1"):
        retry_transport(always_bad, retries=50, deadline_s=1e-9, sleep=lambda _: None)
    assert calls["n"] == 1

    now, calls["n"] = {"t": 0.0}, 0

    def slow_and_bad():
        calls["n"] += 1
        now["t"] += 0.6  # each attempt costs 0.6 s of wall clock
        raise RuntimeError(f"failure {calls['n']}")

    with pytest.raises(RuntimeError, match="failure 1"):
        retry_transport(slow_and_bad, retries=10, deadline_s=1.0, sleep=lambda _: None,
                        clock=lambda: now["t"])
    assert calls["n"] == 2  # attempt 1 at t=0.6 (delay fits), attempt 2 at t=1.2
