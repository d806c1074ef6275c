"""The parameter server's elastic membership in the port, held against the
JAX package's in the same process: the roster, the REGISTER/STATE_SYNC/
DEREGISTER protocol, the master's membership logic, transport star-joins,
the supervisor, the lifetime faults, the membership telemetry, the CLI,
and the supervised spawn-mode drills.

The cases are the JAX package's ``tests/test_elastic.py`` where they apply
to the port (its retry-deadline cases are ``tests/test_torch_ps_master.py``
and its checkpoint writer's ``tests/test_torch_ps_checkpoint.py``).  Each
runs the same script through the port's object and the JAX package's and
compares what they return, what they send and record, and the state they
end in; the drills run the port's CLI and the JAX package's CLI on the CPU
at the same flags and seed (a world of 3, the motion LSTM at H=8, 3 epochs
of 2 steps a worker, sync with quorum 0.5) and compare the roster, the
rejoins, the state syncs, every round's pushes and the updates applied.
"""

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu.launcher import supervisor as jax_supervisor
from pytorch_distributed_rnn_tpu.param_server import protocol as jax_protocol
from pytorch_distributed_rnn_tpu.param_server.master import (
    ParameterServerMaster as JaxParameterServerMaster,
)
from pytorch_distributed_rnn_tpu.resilience import membership as jax_membership
from pytorch_distributed_rnn_tpu.runtime import Communicator as JaxCommunicator
from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import write_synthetic_har_cache
from pytorch_distributed_rnn_tpu_torch.launcher import supervisor as port_supervisor
from pytorch_distributed_rnn_tpu_torch.param_server import protocol
from pytorch_distributed_rnn_tpu_torch.param_server.master import ParameterServerMaster
from pytorch_distributed_rnn_tpu_torch.resilience import membership
from pytorch_distributed_rnn_tpu_torch.runtime.native import Communicator
from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports

SIDES = ("port", "jax")


class _ListRecorder:
    """Minimal recorder double: captures events in order."""

    enabled = True

    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append({"kind": kind, **fields})

    def emit_span(self, name, tm_start, dur_s, cat="train", **attrs):
        self.events.append({"kind": "span", "name": name, "cat": cat, "dur_s": dur_s, **attrs})

    def flush(self):
        pass


def _timeless(events):
    """Recorded events without their clock readings."""
    return [{k: v for k, v in e.items() if k not in ("dur_s", "t", "tm")} for e in events]


def _np(value):
    return value.detach().numpy() if torch.is_tensor(value) else np.asarray(value)


def _plain(value):
    """What a script observed, in a form both frameworks' objects compare in."""
    if isinstance(value, (membership.Member, jax_membership.Member)):
        return _member(value)
    if isinstance(value, (set, frozenset)):
        return sorted(value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if torch.is_tensor(value) or isinstance(value, np.ndarray):
        return _np(value).tolist()
    return value


# ---------------------------------------------------------------------------
# the roster
# ---------------------------------------------------------------------------


def _member(m):
    return None if m is None else (m.worker_id, m.rank, m.state, m.incarnation, m.push_seq,
                                   m.synced, m.error, m.died_tm is None)


def _table(roster):
    return {"members": sorted(_member(m) for m in roster.members()), "counts": roster.counts(),
            "round_ranks": sorted(roster.round_ranks()), "rejoins": roster.rejoins,
            "terminal": roster.all_terminal(), "watermarks": roster.watermarks()}


def _both_rosters(script):
    """Run ``script(roster, module)`` on the port's Roster and on the JAX
    package's, each with its own recorder: what the script returns, the
    final tables and the recorded events must be equal.  Returns the
    port's ``(roster, recorder, observations)``."""
    runs = {}
    for side, module in (("port", membership), ("jax", jax_membership)):
        rec = _ListRecorder()
        roster = module.Roster(recorder=rec)
        runs[side] = (roster, rec, _plain(script(roster, module)))
    (roster, rec, seen), (theirs, their_rec, their_seen) = runs["port"], runs["jax"]
    assert seen == their_seen
    assert _table(roster) == _table(theirs)
    assert rec.events == their_rec.events
    return roster, rec, seen


class TestRoster:
    def test_bootstrap_and_counts(self):
        roster, rec, _ = _both_rosters(lambda r, m: [r.bootstrap([1, 2, 3]), r.counts(),
                                                  r.round_ranks()])
        assert roster.counts() == {"joined": 3, "drained": 0, "dead": 0, "done": 0}
        assert roster.round_ranks() == {1, 2, 3}
        joins = [e for e in rec.events if e["kind"] == "member_join"]
        assert len(joins) == 3 and all(e["via"] == "bootstrap" for e in joins)

    def test_lifecycle_transitions_emit_events(self):
        def script(roster, module):
            roster.bootstrap([1, 2])
            return [_member(roster.drain(1, seq=5)),
                    _member(roster.mark_dead(2, error="socket closed")),
                    roster.counts(), roster.round_ranks()]

        roster, rec, _ = _both_rosters(script)
        assert roster.counts() == {"joined": 0, "drained": 1, "dead": 1, "done": 0}
        assert roster.round_ranks() == set()
        kinds = [e["kind"] for e in rec.events]
        assert kinds.count("member_drain") == 1 and kinds.count("member_dead") == 1
        drain = next(e for e in rec.events if e["kind"] == "member_drain")
        assert drain["seq"] == 5 and drain["worker_id"] == 1

    def test_rejoin_bumps_incarnation_and_keeps_watermark(self):
        def script(roster, module):
            roster.bootstrap([1])
            seen = [roster.note_push(1, 1), roster.note_push(1, 2),
                    _member(roster.mark_dead(1, error="killed"))]
            # the watermark 2 survives the rejoin; not in the rounds until it pushes
            seen += [_member(roster.join(1, 1)), roster.rejoins, roster.round_ranks()]
            return seen + [roster.note_push(1, 3), roster.round_ranks()]

        roster, _, _ = _both_rosters(script)
        member = roster.get(1)
        assert member.incarnation == 2 and member.state == membership.JOINED
        assert member.push_seq == 3  # the watermark 2 survived the rejoin, then seq 3
        assert roster.rejoins == 1 and roster.round_ranks() == {1}

    def test_note_push_dedupes_at_or_below_watermark(self):
        def script(roster, module):
            roster.bootstrap([1])
            seen = [roster.note_push(1, 1), roster.note_push(1, 1), roster.note_push(1, 2)]
            roster.mark_dead(1, error="x")
            roster.join(1, 1)
            # the respawn's stale in-flight push (seq <= watermark) dedupes
            return seen + [roster.note_push(1, 2), roster.note_push(1, 1), roster.note_push(1, 3)]

        _, _, seen = _both_rosters(script)
        assert seen == [True, False, True, False, False, True]

    def test_terminal_states(self):
        def script(roster, module):
            roster.bootstrap([1, 2])
            return [_member(roster.complete(1)), _member(roster.drain(2)), roster.all_terminal()]

        roster, _, _ = _both_rosters(script)
        assert roster.all_terminal() and roster.counts()["done"] == 1

    def test_fresh_register_join_enters_next_round(self):
        def script(roster, module):
            roster.bootstrap([1])
            member = _member(roster.join(7, 3))  # a new worker-id through REGISTER
            return [member, roster.round_ranks(), roster.note_push(3, 1), roster.round_ranks()]

        roster, _, _ = _both_rosters(script)
        assert roster.get(7).state == membership.JOINED and roster.get(7).synced
        assert roster.round_ranks() == {1, 3}

    def test_bootstrap_quiet_suppresses_events(self):
        roster, rec, _ = _both_rosters(lambda r, m: [r.bootstrap([1, 2], quiet=True), r.counts()])
        assert roster.counts()["joined"] == 2
        assert not [e for e in rec.events if e["kind"] == "member_join"]

    def test_watermarks_round_trip_through_a_restore(self):
        def script(roster, module):
            roster.bootstrap([1, 2])
            roster.note_push(1, 4)
            roster.note_push(2, 9)
            marks = roster.watermarks()
            restored = module.Roster()
            restored.bootstrap([1])
            restored.restore_watermarks({str(k): v for k, v in marks.items()})
            seen = [marks, restored.note_push(1, 4), restored.note_push(1, 5),
                    _member(restored.get(2)), _member(restored.join(2, 2)),
                    restored.note_push(2, 9),
                    _table(restored)]
            return seen

        roster, _, _ = _both_rosters(script)
        assert roster.watermarks() == {1: 4, 2: 9}
        restored = membership.Roster()
        restored.bootstrap([1])
        restored.restore_watermarks({"1": 4, "2": 9})
        # an unknown worker-id is pre-rostered dead: it re-enters by REGISTER
        assert restored.get(2).state == membership.DEAD and restored.get(2).push_seq == 9
        assert not restored.note_push(1, 4) and restored.note_push(1, 5)


# ---------------------------------------------------------------------------
# the wire: REGISTER / STATE_SYNC / DEREGISTER
# ---------------------------------------------------------------------------


class _PipeComm:
    """One endpoint of a scripted pair: what it sends is recorded (as
    numpy), what it receives pops from ``inbox`` (as the side's type)."""

    def __init__(self, side="port"):
        self.side = side
        self.sent = []
        self.inbox = deque()

    def send(self, dst, data):
        self.sent.append((dst, np.array(_np(data))))

    def recv(self, src, shape, dtype=None, out=None):
        value = np.asarray(self.inbox.popleft(), np.float32).reshape(shape)
        if self.side == "jax":
            return value
        value = torch.from_numpy(value.copy())
        return value if out is None else out.copy_(value)


def _wire(sent):
    return [(dst, str(data.dtype), data.tolist()) for dst, data in sent]


class TestProtocol:
    def test_state_sync_round_trip(self):
        params = np.arange(6, dtype=np.float32)
        got = {}
        for side, module, flat in (("port", protocol, torch.from_numpy(params.copy())),
                                   ("jax", jax_protocol, params)):
            master_side = _PipeComm(side)
            module.send_state_sync(master_side, 3, flat, step=17, seq=4)
            worker_side = _PipeComm(side)
            worker_side.inbox.extend(data for _, data in master_side.sent)
            received = module.recv_state_sync(worker_side, 6)
            got[side] = (_wire(master_side.sent), _plain(received))
        assert got["port"] == got["jax"]
        assert got["port"][1] == [params.tolist(), 17, 4]

    def test_state_sync_rejects_wrong_opcode(self):
        for side, module in (("port", protocol), ("jax", jax_protocol)):
            worker_side = _PipeComm(side)
            worker_side.inbox.append(np.array([2.0, 0.0, 0.0], np.float32))
            with pytest.raises(RuntimeError, match="STATE_SYNC"):
                module.recv_state_sync(worker_side, 4)

    def test_register_and_deregister_headers(self):
        sent = {}
        for side, module in (("port", protocol), ("jax", jax_protocol)):
            comm = _PipeComm(side)
            module.send_request(comm, module.OP_REGISTER, seq=7)
            module.send_request(comm, module.OP_DEREGISTER, seq=12)
            sent[side] = _wire(comm.sent)
        assert sent["port"] == sent["jax"]
        assert [data for _, _, data in sent["port"]] == [
            [float(protocol.OP_REGISTER), 7.0], [float(protocol.OP_DEREGISTER), 12.0]]

    def test_codes_are_the_jax_packages(self):
        for name in ("OP_PULL", "OP_PUSH", "OP_DONE", "OP_REGISTER", "OP_DEREGISTER",
                     "OP_STATE_SYNC"):
            assert getattr(protocol, name) == getattr(jax_protocol, name), name


# ---------------------------------------------------------------------------
# the master's membership logic (scripted comm, no processes)
# ---------------------------------------------------------------------------


class _ScriptedComm:
    world_size = 3

    def __init__(self, messages, side):
        self.side = side
        self.inbox = deque()
        self.feed(messages)
        self.sent = []

    def feed(self, messages):
        self.inbox.extend(np.asarray(m, np.float32) for m in messages)

    def recv(self, src, shape, dtype=None):
        value = self.inbox.popleft().reshape(shape)
        return value if self.side == "jax" else torch.from_numpy(value.copy())

    def send(self, dst, data):
        self.sent.append((dst, np.array(_np(data))))


@dataclasses.dataclass
class _Side:
    master: object
    comm: _ScriptedComm
    state: dict
    recorder: _ListRecorder

    def observed(self):
        return {"sent": _wire(self.comm.sent), "inbox_left": len(self.comm.inbox),
                "updates": self.master.updates_applied, "p": _np(self.state["p"]).tolist(),
                "roster": _table(self.master.roster),
                "events": _timeless(self.recorder.events)}


def _masters(messages, n=4, **kwargs):
    """The port's and the JAX package's ParameterServerMaster, each on its
    own scripted comm fed the same messages and applying ``p - 0.1 g``."""
    sides = {}
    for side, cls in (("port", ParameterServerMaster), ("jax", JaxParameterServerMaster)):
        state = {"p": torch.zeros(n) if side == "port" else np.zeros(n, np.float32)}

        def apply_update(g, state=state, side=side):
            state["p"] = state["p"] - 0.1 * (g if side == "port" else np.asarray(g))
            return state["p"]

        comm = _ScriptedComm(messages, side)
        recorder = kwargs.get("recorder") or _ListRecorder()
        master = cls(comm, _np(state["p"]).copy() if side == "jax" else state["p"].clone(),
                     apply_update, **{**kwargs, "recorder": recorder})
        sides[side] = _Side(master, comm, state, recorder)
    return sides


def _on_both(sides, action):
    """``action(side)`` on each side; the exception each raised, by type
    and message, must be the same (or none on both).  Returns it."""
    raised = {}
    for name, side in sides.items():
        try:
            action(side)
            raised[name] = None
        except Exception as exc:  # compared below, never swallowed
            raised[name] = (type(exc).__name__, str(exc))
    assert raised["port"] == raised["jax"]
    return raised["port"]


def _same(sides):
    ours, theirs = sides["port"].observed(), sides["jax"].observed()
    assert ours == theirs
    return ours


class TestMasterMembership:
    def test_register_replies_state_sync_with_watermarks(self):
        n = 4
        sides = _masters([
            [2.0, 1.0], np.ones(n),  # push seq 1 (applied)
            [4.0, 2.0],              # REGISTER, worker-id 2 (rank 1)
            [3.0, 0.0],              # DONE
        ], n=n)
        _on_both(sides, lambda s: s.master._serve_worker(1))
        seen = _same(sides)
        # replies: params for the push, then the STATE_SYNC header + params
        assert len(seen["sent"]) == 3
        assert seen["sent"][1][2] == [6.0, 1.0, 0.0]  # op, step 1, seq watermark 0
        member = sides["port"].master.roster.get(2)
        assert member is not None and member.rank == 1

    def test_deregister_drains_without_burning_quorum(self):
        sides = _masters([[5.0, 3.0]])  # DEREGISTER after seq 3
        _on_both(sides, lambda s: s.master._serve_worker(1))
        seen = _same(sides)
        assert sides["port"].master.roster.member_for_rank(1).state == membership.DRAINED
        assert seen["roster"]["counts"]["drained"] == 1

    def test_non_elastic_master_emits_no_membership_telemetry(self):
        for elastic, joins in ((False, 0), (True, 2)):
            sides = _masters([], elastic=elastic)
            seen = _same(sides)
            assert len([e for e in seen["events"] if e["kind"] == "member_join"]) == joins

    def test_elastic_push_from_unrostered_rank_rejected(self):
        n = 4
        sides = _masters([[2.0, 1.0], np.ones(n)], n=n, elastic=True)
        name, message = _on_both(sides, lambda s: s.master._serve_worker(5))
        assert name == "RuntimeError" and "unrostered" in message
        seen = _same(sides)
        assert seen["updates"] == 0 and seen["p"] == [0.0] * n

    def test_push_from_dead_member_requires_register(self):
        n = 4
        sides = _masters([[2.0, 7.0], np.ones(n)], n=n)
        _on_both(sides, lambda s: s.master._mark_dead(1, RuntimeError("socket reset")))
        name, message = _on_both(sides, lambda s: s.master._serve_worker(1))
        assert name == "RuntimeError" and "REGISTER" in message
        seen = _same(sides)
        assert seen["updates"] == 0 and seen["p"] == [0.0] * n

    def test_rejoin_stale_push_dedupes_not_double_applied(self):
        n = 4
        sides = _masters([
            [2.0, 1.0], np.ones(n),   # incarnation 1: push seq 1
            [2.0, 2.0], np.ones(n),   # incarnation 1: push seq 2
        ], n=n)
        # runs out of scripted messages
        assert _on_both(sides, lambda s: s.master._serve_worker(1))[0] == "IndexError"
        assert _same(sides)["updates"] == 2
        _on_both(sides, lambda s: s.master._mark_dead(1, RuntimeError("killed")))
        for side in sides.values():
            side.comm.feed([
                [4.0, 1.0],               # REGISTER worker-id 1
                [2.0, 2.0], np.ones(n),   # stale in-flight push (duplicate)
                [2.0, 3.0], np.ones(n),   # the first real push after the rejoin
                [3.0, 0.0],               # DONE
            ])
        _on_both(sides, lambda s: s.master._serve_worker(1))
        seen = _same(sides)
        assert seen["updates"] == 3  # seq 2 not applied again
        member = sides["port"].master.roster.get(1)
        assert member.incarnation == 2 and member.push_seq == 3
        torch.testing.assert_close(sides["port"].state["p"], torch.full((n,), -0.3), rtol=1e-6,
                                   atol=0)

    def test_state_sync_watermark_survives_respawn(self):
        n = 4
        sides = _masters([
            [2.0, 1.0], np.ones(n),
            [2.0, 2.0], np.ones(n),
            [3.0, 0.0],
        ], n=n)
        _on_both(sides, lambda s: s.master._serve_worker(1))
        _on_both(sides, lambda s: s.master._mark_dead(1, RuntimeError("killed")))
        for side in sides.values():
            side.comm.feed([[4.0, 1.0], [3.0, 0.0]])
        _on_both(sides, lambda s: s.master._serve_worker(1))
        seen = _same(sides)
        sync_header = next(data for _, _, data in seen["sent"] if len(data) == 3 and data[0] == 6.0)
        assert sync_header == [6.0, 2.0, 2.0]  # 2 updates, push-seq watermark 2

    def test_drain_closes_inflight_round(self):
        class _RecordingComm:
            world_size = 3

            def __init__(self):
                self.sent = []

            def send(self, dst, data):
                self.sent.append((dst, np.array(_np(data))))

        seen = {}
        for side, cls in (("port", ParameterServerMaster), ("jax", JaxParameterServerMaster)):
            applied = []
            comm = _RecordingComm()
            zeros = torch.zeros(4) if side == "port" else np.zeros(4, np.float32)
            master = cls(comm, zeros, lambda g, a=applied: (a.append(_np(g).copy()), -g)[1],
                         sync_mode=True, sync_timeout=30.0, quorum=0.5)
            grads = torch.full((4,), 4.0) if side == "port" else np.full(4, 4.0, np.float32)
            t = threading.Thread(target=master._push_sync, args=(1, grads))
            t.start()
            time.sleep(0.05)
            master.roster.drain(2, seq=0)
            master._rendezvous_leave(2)
            t.join(timeout=10)
            assert not t.is_alive()
            seen[side] = (master.updates_applied, master.degraded_rounds,
                          [a.tolist() for a in applied], _wire(comm.sent), _table(master.roster))
        assert seen["port"] == seen["jax"]
        assert seen["port"][:3] == (1, 0, [[4.0] * 4])

    def test_stale_service_thread_exits_without_reading(self):
        """A rank re-accepted while its old thread served a request: the
        old generation's loop returns before touching the new socket."""
        sides = _masters([[3.0, 0.0]])
        for side in sides.values():
            side.master._thread_gen[1] = 2
        _on_both(sides, lambda s: s.master._serve_worker(1, gen=1))
        assert _same(sides)["inbox_left"] == 1  # nothing read
        _on_both(sides, lambda s: s.master._serve_worker(1, gen=2))
        seen = _same(sides)
        assert seen["inbox_left"] == 0
        assert sides["port"].master.roster.member_for_rank(1).state == membership.DONE


# ---------------------------------------------------------------------------
# the transport: star joins (threads, no processes), across frameworks
# ---------------------------------------------------------------------------


COMMS = {"port": Communicator, "jax": JaxCommunicator}
# (the master's side, the workers' side): each pair is one world on the wire
MIXED = [("port", "port"), ("port", "jax"), ("jax", "port")]


def _full(side, n, value):
    return torch.full((n,), value) if side == "port" else np.full(n, value, np.float32)


class TestElasticTransport:
    @pytest.mark.parametrize("master_side,worker_side", MIXED)
    def test_respawn_and_new_rank_star_join(self, master_side, worker_side):
        (port,) = free_ports(1)
        res = {}
        Master, Worker = COMMS[master_side], COMMS[worker_side]

        def master():
            c = Master("127.0.0.1", port, 0, 3)
            c.reserve(8)
            res["r1"] = _np(c.recv(1, (4,)))
            c.close_peer(2)  # rank 2 "died"
            rank = None
            while rank is None:
                rank = c.accept_peer(timeout_s=1.0)
            res["rejoined"] = rank
            res["r2"] = _np(c.recv(2, (4,)))
            c.send(2, _full(master_side, 4, 9.0))
            rank = None
            while rank is None:
                rank = c.accept_peer(timeout_s=1.0)
            res["new_rank"] = rank
            res["r3"] = _np(c.recv(3, (2,)))
            res["world"] = c.world_size
            c.close()

        def w1():
            c = Worker("127.0.0.1", port, 1, 3)
            c.send(0, _full(worker_side, 4, 1.0))
            time.sleep(1.0)
            c.close()

        def w2_initial():
            Worker("127.0.0.1", port, 2, 3).close()

        def w2_respawn():
            time.sleep(0.3)
            c = Worker("127.0.0.1", port, 2, 3, star=True)
            c.send(0, _full(worker_side, 4, 2.0))
            res["w2_params"] = _np(c.recv(0, (4,)))
            c.close()

        def w3_new():
            time.sleep(0.8)
            c = Worker("127.0.0.1", port, 3, 4, star=True)
            c.send(0, _full(worker_side, 2, 3.0))
            c.close()

        threads = [threading.Thread(target=f)
                   for f in (master, w1, w2_initial, w2_respawn, w3_new)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert res["rejoined"] == 2 and res["new_rank"] == 3
        np.testing.assert_array_equal(res["r1"], np.full(4, 1.0))
        np.testing.assert_array_equal(res["r2"], np.full(4, 2.0))
        np.testing.assert_array_equal(res["w2_params"], np.full(4, 9.0))
        np.testing.assert_array_equal(res["r3"], np.full(2, 3.0))
        assert res["world"] == 4  # the world grew

    @pytest.mark.parametrize("side", SIDES)
    def test_star_join_rejects_rank_zero(self, side):
        (port,) = free_ports(1)
        with pytest.raises(ValueError, match="star"):
            COMMS[side]("127.0.0.1", port, 0, 2, star=True)

    @pytest.mark.parametrize("master_side,worker_side", MIXED)
    def test_listener_world_accepts_star_joins(self, master_side, worker_side):
        (port,) = free_ports(1)
        listener = COMMS[master_side].listener(port, capacity=3)
        assert (listener.rank, listener.world_size) == (0, 1)
        joined = {}

        def peer():
            c = COMMS[worker_side]("127.0.0.1", port, 2, 3, star=True)
            c.send(0, _full(worker_side, 3, 5.0))
            c.close()

        t = threading.Thread(target=peer)
        t.start()
        rank = None
        while rank is None:
            rank = listener.accept_peer(timeout_s=1.0)
        joined["rank"] = rank
        joined["data"] = _np(listener.recv(rank, (3,)))
        t.join(timeout=30)
        listener.close()
        assert joined["rank"] == 2 and listener.world_size == 3
        np.testing.assert_array_equal(joined["data"], np.full(3, 5.0))


# ---------------------------------------------------------------------------
# the supervisor (fake processes)
# ---------------------------------------------------------------------------


class _FakeProc:
    def __init__(self, exitcode=None):
        self.exitcode = exitcode
        self.terminated = False

    def is_alive(self):
        return self.exitcode is None

    def terminate(self):
        self.terminated = True
        if self.exitcode is None:
            self.exitcode = -15

    def join(self, timeout=None):
        pass


def _both_supervisors(script, **kwargs):
    """Run ``script(supervisor, spawned)`` on the port's ElasticSupervisor
    and on the JAX package's: what it returns, what each spawned, each
    fake process's end, the events and the verdicts must be equal.
    Returns the port's ``(supervisor, spawned)``."""
    runs = {}
    for side, module in (("port", port_supervisor), ("jax", jax_supervisor)):
        spawned, events = [], []

        def spawn(rank, worker_id, rejoin, spawned=spawned):
            proc = _FakeProc()
            spawned.append((rank, worker_id, rejoin, proc))
            return proc

        sup = module.ElasticSupervisor(spawn, respawn_delay_s=0.0,
                                       on_event=lambda kind, **f: events.append((kind, f)),
                                       **kwargs)
        seen = script(sup, spawned)
        slots = {r: (s.completed, s.failed) for r, s in sup.slots.items()}
        runs[side] = (sup, spawned, [seen, [(r, w, j, p.exitcode, p.terminated)
                                            for r, w, j, p in spawned],
                                     events, slots, sup.verdict()])
    assert runs["port"][2] == runs["jax"][2]
    return runs["port"][:2]


class TestSupervisor:
    def test_nonzero_exit_respawns_with_same_worker_id(self):
        def script(sup, spawned):
            sup.launch([1, 2])
            spawned[1][3].exitcode = -9  # worker-id 2 dies
            return [sup.poll(), sup.total_respawns]

        sup, spawned = _both_supervisors(script, max_respawns=2)
        assert len(spawned) == 3 and spawned[2][:3] == (2, 2, True)
        assert sup.total_respawns == 1

    def test_exit_zero_is_terminal_never_respawned(self):
        def script(sup, spawned):
            sup.launch([1])
            spawned[0][3].exitcode = 0  # drain or completion
            return sup.poll()

        sup, spawned = _both_supervisors(script)
        assert len(spawned) == 1 and sup.slots[1].completed

    def test_budget_exhaustion_respects_min_workers_floor(self):
        def script(sup, spawned):
            sup.launch([1, 2])
            spawned[1][3].exitcode = 1
            first = sup.poll()  # respawn 1/1
            spawned[2][3].exitcode = 1
            return [first, sup.poll()]  # budget gone, 1 live < min_workers 2

        sup, _ = _both_supervisors(script, max_respawns=1, min_workers=2)
        assert sup.slots[2].failed and sup.total_respawns == 1

    def test_shutdown_settles_verdicts(self):
        def script(sup, spawned):
            sup.launch([1, 2])
            spawned[0][3].exitcode = 0
            sup.shutdown()
            return sup.verdict()

        sup, spawned = _both_supervisors(script)
        verdict = sup.verdict()
        assert verdict["completed"] == 1 and verdict["failed"] == 1
        assert spawned[1][3].terminated


# ---------------------------------------------------------------------------
# the lifetime fault actions
# ---------------------------------------------------------------------------


def _resilience(side):
    if side == "port":
        from pytorch_distributed_rnn_tpu_torch import resilience
    else:
        from pytorch_distributed_rnn_tpu import resilience
    return resilience


def _events(schedule):
    return [dataclasses.astuple(e) for e in schedule.events]


class TestLifetimeFaults:
    def test_parse_preempt_and_respawn(self):
        seen = {}
        for side in SIDES:
            s = _resilience(side).FaultSchedule.parse("epoch:1:preempt@2,step:3:respawn")
            assert _resilience(side).FaultSchedule.parse(str(s)).events == s.events
            seen[side] = (str(s), _events(s))
        assert seen["port"] == seen["jax"]
        assert [e[2] for e in seen["port"][1]] == ["preempt", "respawn"]

    def test_preempt_sends_sigterm_to_self(self, monkeypatch):
        import signal as signal_mod

        for side in SIDES:
            sent = []
            monkeypatch.setattr(os, "kill", lambda pid, sig, sent=sent: sent.append((pid, sig)))
            s = _resilience(side).FaultSchedule.parse("step:1:preempt")
            s.maybe_kill(step=1)
            assert sent == [(os.getpid(), signal_mod.SIGTERM)], side
            assert s.fired == {"preempt": 1}, side

    def test_for_rejoin_drops_deterministic_lifetime_events(self):
        seen = {}
        for side in SIDES:
            s = _resilience(side).FaultSchedule.parse(
                "epoch:1:kill@2,step:3:respawn,step:2:nan,prob:0.1:kill,step:4:preempt"
            ).for_rank(2)
            rejoined = s.for_rejoin()
            seen[side] = (_events(rejoined), rejoined.rank)
        assert seen["port"] == seen["jax"]
        assert [(e[0], e[2]) for e in seen["port"][0]] == [("step", "nan"), ("prob", "kill")]
        assert seen["port"][1] == 2

    def test_drain_signal_flag_and_check(self):
        for side in SIDES:
            resilience = _resilience(side)
            drain = resilience.DrainSignal()
            drain.check()  # nothing requested
            drain._on_sigterm(15, None)
            with pytest.raises(resilience.DrainRequested):
                drain.check()


# ---------------------------------------------------------------------------
# membership telemetry
# ---------------------------------------------------------------------------


def _sidecar(path, rank, events, now):
    head = {"kind": "meta", "schema": 2, "rank": rank, "t": now - 300, "tm": 0.0,
            "sample_every": 1}
    lines = [head] + [{"rank": rank, "t": now - 200, "tm": 100.0, **e} for e in events]
    path.write_text("".join(json.dumps(e) + "\n" for e in lines))


def _obs(side):
    if side == "port":
        from pytorch_distributed_rnn_tpu_torch import obs
        from pytorch_distributed_rnn_tpu_torch.obs import cli, spans, summary, timeline
    else:
        from pytorch_distributed_rnn_tpu import obs
        from pytorch_distributed_rnn_tpu.obs import cli, spans, summary, timeline
    return argparse.Namespace(obs=obs, cli=cli, spans=spans, summary=summary,
                              timeline=timeline)


def _health(tmp_path, capsys, files):
    """``obs health`` of the same sidecar family through each framework's
    CLI: the exit codes and the printed reports must be equal."""
    now = time.time()
    for name, rank, events in files:
        _sidecar(tmp_path / name, rank, events, now)
    seen = {}
    for side in SIDES:
        capsys.readouterr()
        rc = _obs(side).cli.main(["health", str(tmp_path / "m.jsonl"), "--now", str(now),
                                  "--stale-after", "30"])
        seen[side] = (rc, capsys.readouterr().out)
    assert seen["port"] == seen["jax"]
    return seen["port"]


class TestMembershipObservability:
    def test_health_classifies_drained_rank_exit_zero(self, tmp_path, capsys):
        rc, out = _health(tmp_path, capsys, [
            ("m.jsonl", 0, [{"kind": "run_summary", "duration_s": 1.0}]),
            ("m-r1.jsonl", 1, [{"kind": "member_drain", "worker_id": 1, "rank_slot": 1,
                                "seq": 4}])])
        assert rc == 0 and "rank 1: drained" in out

    def test_health_dead_rank_still_flagged(self, tmp_path, capsys):
        rc, _ = _health(tmp_path, capsys, [
            ("m.jsonl", 0, [{"kind": "run_summary", "duration_s": 1.0}]),
            ("m-r1.jsonl", 1, [{"kind": "step", "step": 0, "dispatch_s": 0.001}])])
        assert rc == 1

    def test_masters_worker_drain_does_not_drain_master(self, tmp_path):
        now = time.time()
        _sidecar(tmp_path / "m.jsonl", 0, [
            {"kind": "member_drain", "worker_id": 2, "rank_slot": 2, "seq": 3}], now)
        reports = {side: _obs(side).obs.rank_health(
            _obs(side).obs.load_events(tmp_path / "m.jsonl"), now=now, stale_after=30)
            for side in SIDES}
        assert reports["port"] == reports["jax"]
        assert reports["port"]["status"] == "dead" and not reports["port"]["drained"]

    def test_summarize_counts_membership_events(self, tmp_path):
        _sidecar(tmp_path / "m.jsonl", 0, [
            {"kind": "member_join", "worker_id": 1, "rank_slot": 1, "via": "bootstrap",
             "rejoin": False},
            {"kind": "member_join", "worker_id": 2, "rank_slot": 2, "via": "register",
             "rejoin": True},
            {"kind": "member_dead", "worker_id": 2, "rank_slot": 2},
            {"kind": "member_drain", "worker_id": 1, "rank_slot": 1},
            {"kind": "run_summary", "duration_s": 1.0,
             "roster": {"joined": 0, "drained": 1, "dead": 0, "done": 1}},
        ], time.time())
        keys = ("member_joins", "member_rejoins", "member_deaths", "member_drains", "roster")
        seen = {side: {k: _obs(side).summary.summarize_file(tmp_path / "m.jsonl")[k]
                       for k in keys} for side in SIDES}
        assert seen["port"] == seen["jax"]
        summary = seen["port"]
        assert (summary["member_joins"], summary["member_rejoins"], summary["member_deaths"],
                summary["member_drains"]) == (2, 1, 1, 1)
        assert summary["roster"]["done"] == 1

    def test_summarize_membership_none_on_plain_runs(self, tmp_path):
        _sidecar(tmp_path / "m.jsonl", 0, [{"kind": "step", "step": 0, "dispatch_s": 0.001}],
                 time.time())
        for side in SIDES:
            assert _obs(side).summary.summarize_file(tmp_path / "m.jsonl")["member_joins"] is None

    def test_timeline_renders_membership_lane(self, tmp_path):
        _sidecar(tmp_path / "m.jsonl", 0, [
            {"kind": "member_join", "worker_id": 2, "rank_slot": 2, "via": "register",
             "rejoin": True},
            {"kind": "member_dead", "worker_id": 2, "rank_slot": 2},
            {"kind": "span", "name": "state_sync", "cat": "member", "dur_s": 0.01,
             "worker_id": 2},
            {"kind": "checkpoint_fallback", "path": "x.ckpt", "reason": "truncated",
             "chosen": "y.ckpt"},
        ], time.time())
        traces = {}
        for side in SIDES:
            o = _obs(side)
            traces[side] = o.timeline.build_chrome_trace(o.timeline.load_run(tmp_path / "m.jsonl"))
            o.obs.validate_chrome_trace(traces[side])
        assert traces["port"] == traces["jax"]
        tids = _obs("port").spans.SUBSYSTEM_TIDS
        member_events = [e for e in traces["port"]["traceEvents"] if e.get("cat") == "member"]
        assert {e["name"] for e in member_events} == {"member_join", "member_dead",
                                                     "state_sync"}
        assert all(e["tid"] == tids["member"] for e in member_events)
        assert next(e for e in member_events if e["name"] == "member_dead")["s"] == "p"
        ckpt = next(e for e in traces["port"]["traceEvents"]
                    if e.get("name") == "checkpoint_fallback")
        assert ckpt["cat"] == "ckpt"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


ELASTIC_DESTS = ("elastic", "min_workers", "ps_max_respawns", "ps_join_timeout", "ps_rejoin",
                 "ps_worker_id", "ps_checkpoint_rounds")


def test_elastic_cli_flags_parse():
    from pytorch_distributed_rnn_tpu.main import build_parser as jax_parser

    argvs = (["parameter-server", "--world-size", "3", "--elastic", "--min-workers", "2",
              "--ps-max-respawns", "5", "--ps-join-timeout", "12", "--ps-checkpoint-rounds", "4"],
             ["parameter-server", "--world-size", "3", "--rank", "2", "--ps-rejoin",
              "--ps-worker-id", "2"])
    for argv in argvs:
        ours, theirs = port_main.build_parser().parse_args(argv), jax_parser().parse_args(argv)
        assert ({d: getattr(ours, d) for d in ELASTIC_DESTS}
                == {d: getattr(theirs, d) for d in ELASTIC_DESTS})
        port_main.reject_unported(ours)
    args = port_main.build_parser().parse_args(argvs[0])
    assert args.elastic and args.min_workers == 2 and args.ps_max_respawns == 5
    assert args.ps_join_timeout == 12.0 and args.ps_checkpoint_rounds == 4
    rejoin = port_main.build_parser().parse_args(argvs[1])
    assert rejoin.ps_rejoin and rejoin.ps_worker_id == 2


def test_the_elastic_help_is_the_jax_packages():
    from pytorch_distributed_rnn_tpu.main import build_parser as jax_parser

    def helps(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        ps = sub.choices["parameter-server"]
        return {a.dest: " ".join((a.help or "").split()) for a in ps._actions
                if a.dest in ELASTIC_DESTS}

    ours, theirs = helps(port_main.build_parser()), helps(jax_parser())
    assert len(ours) == 7 and ours == theirs


# ---------------------------------------------------------------------------
# the drills: supervised spawn-mode worlds through each framework's CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def har_cache(tmp_path_factory):
    work = tmp_path_factory.mktemp("elastic")
    return write_synthetic_har_cache(work / "data", num_train=120, num_test=16, seq_length=12,
                                     split_seed=0)


def _drill_argv(cache, tmp, port, faults):
    """The drills' command line, the same for both frameworks' ``main``."""
    return ["--dataset-path", str(cache), "--epochs", "3", "--batch-size", "48", "--seed", "7",
            "--no-validation", "--dropout", "0", "--hidden-units", "8", "--stacked-layer", "1",
            "--learning-rate", "2.5e-3", "--faults", faults, "--metrics", str(tmp / "m.jsonl"),
            "--checkpoint-directory", str(tmp / "models"), "parameter-server",
            "--world-size", "3", "--ps-mode", "sync", "--ps-quorum", "0.5",
            "--ps-sync-timeout", "60", "--ps-transport-retries", "2", "--elastic",
            "--min-workers", "1", "--ps-join-timeout", "30", "--master-port", str(port)]


def _family(path):
    from pytorch_distributed_rnn_tpu_torch.obs.summary import rank_files

    events = {}
    for member in rank_files(path):
        rows = [json.loads(line) for line in Path(member).read_text().splitlines()
                if line.strip()]
        events[rows[0]["rank"]] = rows
    return events


def _rounds(events):
    return [e for e in events if e["kind"] == "span" and e.get("name") == "ps_round"]


def _outcome(master):
    """What a drill's master sidecar says of the membership and the
    updates.  The rounds are the same in both frameworks because the
    schedule orders them: a survivor's remaining steps take milliseconds
    and a respawn takes seconds (process start, imports, data load)."""
    summary = next(e for e in reversed(master) if e["kind"] == "run_summary")
    ps_summary = next(e for e in reversed(master) if e["kind"] == "ps_summary")
    return {
        "roster": summary["roster"], "rejoins": summary["rejoins"],
        "updates": summary["steps"], "ps_updates": ps_summary["updates"],
        "degraded_rounds": ps_summary["degraded_rounds"],
        "membership": [(e["kind"], e["worker_id"], e.get("via"), e.get("rejoin"), e.get("seq"))
                       for e in master if e["kind"] in ("member_join", "member_drain",
                                                        "member_dead")],
        "state_syncs": [(e["worker_id"], e["incarnation"], e["step"], e["seq"])
                        for e in master if e["kind"] == "span" and e.get("name") == "state_sync"],
        "rounds": [sorted(r["seqs"].items()) for r in _rounds(master)],
    }


def _check_the_rule(outcome):
    """Sync mode's rule: one update a round, every push in exactly one
    round, each worker's push seqs 1..its last."""
    contributions = [c for r in outcome["rounds"] for c in r]
    assert len(contributions) == len(set(contributions))
    for worker in {w for w, _ in contributions}:
        seqs = sorted(s for w, s in contributions if w == worker)
        assert seqs == list(range(1, len(seqs) + 1))
    assert outcome["updates"] == outcome["ps_updates"] == len(outcome["rounds"])


@pytest.fixture(scope="module")
def jax_drill(har_cache, tmp_path_factory):
    """The JAX package's CLI drill at ``faults`` (run once a fault spec in
    this module): its master's outcome and history."""
    from pytorch_distributed_rnn_tpu import main as jax_main

    done = {}

    def run(faults):
        if faults not in done:
            tmp = tmp_path_factory.mktemp("jax-drill")
            (port,) = free_ports(1)
            here = os.getcwd()
            os.chdir(tmp)
            try:
                assert jax_main.main(_drill_argv(har_cache, tmp, port, faults)) == 0
            finally:
                os.chdir(here)
            done[faults] = (_outcome(_family(tmp / "m.jsonl")[0]),
                            json.loads((tmp / "history.json").read_text()))
        return done[faults]

    return run


def _drill(tmp_path, monkeypatch, cache, faults, jax_drill):
    """The port's CLI drill at ``faults`` beside the JAX package's: the
    same outcome, both by the rule, histories of the same length."""
    monkeypatch.chdir(tmp_path)
    (port,) = free_ports(1)
    assert port_main.main(["--device", "cpu", *_drill_argv(cache, tmp_path, port, faults)]) == 0
    family = _family(tmp_path / "m.jsonl")
    ours = _outcome(family[0])
    theirs, their_history = jax_drill(faults)
    _check_the_rule(ours)
    _check_the_rule(theirs)
    assert ours == theirs
    # rank 1 writes the history: the epochs its last incarnation trained
    history = json.loads((tmp_path / "history.json").read_text())["train_history"]
    assert len(history) == len(their_history["train_history"]) and all(np.isfinite(history))
    return family, ours, history


def test_kill_respawn_rejoin_completes_full_strength(har_cache, tmp_path, monkeypatch,
                                                      jax_drill):
    """SIGKILL worker 2 at its second epoch: the supervisor respawns it
    into the same worker-id, it REGISTERs and state-syncs, and the roster
    ends at full strength; every push the workers made lands in exactly
    one round, in the rounds JAX's master forms."""
    _, outcome, history = _drill(tmp_path, monkeypatch, har_cache, "epoch:1:kill@2", jax_drill)
    assert len(history) == 3
    assert [m[:2] for m in outcome["membership"]] == [
        ("member_join", 1), ("member_join", 2), ("member_dead", 2), ("member_join", 2)]
    assert outcome["membership"][-1][3] is True  # the last join is the rejoin
    # worker 2 state-syncs at the master's 6 updates with its watermark 2
    # (its first epoch), and pushes its last two epochs again from seq 3
    assert outcome["state_syncs"] == [(2, 2, 6, 2)]
    assert outcome["roster"] == {"joined": 0, "drained": 0, "dead": 0, "done": 2}
    assert outcome["rejoins"] == 1 and outcome["updates"] == 10


def test_sigterm_drain_exits_zero_and_health_reports_drained(har_cache, tmp_path, monkeypatch,
                                                            capsys, jax_drill):
    from pytorch_distributed_rnn_tpu_torch.obs.cli import main as metrics_main

    family, outcome, _ = _drill(tmp_path, monkeypatch, har_cache, "epoch:1:preempt@2",
                                jax_drill)
    drains = [m for m in outcome["membership"] if m[0] == "member_drain"]
    assert len(drains) == 1 and drains[0][1] == 2
    assert not [m for m in outcome["membership"] if m[0] == "member_dead"]
    # exactly once: the drained worker's last push seq in one round
    assert len([r for r in outcome["rounds"] if ("2", drains[0][4]) in r]) == 1
    assert any(e["kind"] == "member_drain" for e in family[2])
    capsys.readouterr()
    rc = metrics_main(["health", str(tmp_path / "m.jsonl"), "--stale-after", "1.0"])
    assert rc == 0 and "rank 2: drained" in capsys.readouterr().out


def test_respawn_action_drills_supervisor(har_cache, tmp_path, monkeypatch, caplog, jax_drill):
    """The ``respawn`` action (an abrupt nonzero exit) drives the same
    supervisor path, in the port as in JAX."""
    import logging

    with caplog.at_level(logging.INFO):
        _, outcome, history = _drill(tmp_path, monkeypatch, har_cache, "step:3:respawn@1",
                                     jax_drill)
    assert outcome["roster"]["done"] == 2 and outcome["rejoins"] == 1
    # worker 1 re-entered at its watermark 3 (seq 3 was step 2, epoch 1):
    # it trains epochs 1 and 2 again, pushing seqs 4-7
    assert outcome["state_syncs"] == [(1, 2, 6, 3)] and len(history) == 2
    assert "'respawns': 1" in caplog.text and "'failed': 0" in caplog.text


def test_manual_rejoin_in_rank_mode(har_cache, tmp_path, monkeypatch, jax_drill):
    """``--ps-rejoin --ps-worker-id``: a rank-mode elastic world whose
    worker 1 is killed by a ``respawn`` fault and re-entered by hand; the
    master's STATE_SYNC digest equals the one the rejoiner adopted, and
    the master's outcome is the JAX package's supervised drill's at the
    same fault (a re-entry by hand and a respawn form the same rounds)."""
    monkeypatch.chdir(tmp_path)
    (port,) = free_ports(1)
    base = ["--device", "cpu", *_drill_argv(har_cache, tmp_path, port, "step:3:respawn@1")]
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}

    def start(rank, *extra):
        return subprocess.Popen([sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main",
                                 *base, "--rank", str(rank), *extra], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    master, w1, w2 = start(0), start(1), start(2)
    w1.communicate(timeout=120)
    assert w1.returncode != 0  # the respawn fault's exit
    rejoined = start(1, "--ps-rejoin", "--ps-worker-id", "1")
    outs = {name: p.communicate(timeout=120)[0]
            for name, p in (("rejoined", rejoined), ("w2", w2), ("master", master))}
    assert (rejoined.returncode, w2.returncode, master.returncode) == (0, 0, 0), outs
    sent = re.search(r"state sync: worker-id 1 .*sha256 (\w+)", outs["master"]).group(1)
    adopted = re.search(r"ps worker 1: state sync .*sha256 (\w+)", outs["rejoined"]).group(1)
    assert sent == adopted
    assert "1 rejoin(s)" in outs["master"]
    ours = _outcome(_family(tmp_path / "m.jsonl")[0])
    _check_the_rule(ours)
    assert ours == jax_drill("step:3:respawn@1")[0]
