"""Wire protocol of the parameter-server strategy, the counterpart of the
JAX package's ``param_server/protocol.py`` over the port's TCP transport
(``runtime/native.py:Communicator``: ``send`` takes CPU tensors and
float32 numpy arrays, ``recv`` returns a CPU tensor or fills ``out``).

Tiny fixed-header messages.  The state that crosses the wire is explicit:
flat float32 parameter/gradient vectors plus a scalar header.

Messages (worker -> master):
  PULL       - request the current flat params
  PUSH       - gradient vector; the master replies with fresh params
  DONE       - the worker finished all epochs
  DEREGISTER - voluntary leave (preemption-aware drain): the seq slot
               carries the worker's last push seq; the master shrinks
               the roster without burning the quorum budget

The master replies to PULL/PUSH with the current flat parameter vector.
Loss stays local to the worker.

The header ``[opcode, seq]`` (float32) carries a per-worker SEQUENCE
NUMBER, so a retried exchange (``resilience/retry.py``: the worker
re-runs the whole push when only the reply leg failed) is idempotent:
the master sees a duplicate PUSH seq, skips the re-apply and resends the
current params.  float32 carries step counts exactly up to 2^24.

REGISTER, STATE_SYNC, EXPERIENCE and PARAMS_AT keep the reference's
codes so that the wire stays the same; their messages come with the
elastic half of ROADMAP A7 (REGISTER, STATE_SYNC) and with the streaming
actor/learner of A8 (EXPERIENCE, PARAMS_AT).
"""

from __future__ import annotations

import numpy as np
import torch

OP_PULL = 1
OP_PUSH = 2
OP_DONE = 3
OP_REGISTER = 4
OP_DEREGISTER = 5
OP_STATE_SYNC = 6
OP_EXPERIENCE = 7
OP_PARAMS_AT = 8

_HEADER_LEN = 2  # [opcode, seq]


def send_request(comm, opcode: int, grads=None, seq: int = 0):
    """Worker side: one request to the master (rank 0); a PUSH carries
    ``grads``, a flat float32 CPU tensor or array."""
    comm.send(0, np.array([float(opcode), float(seq)], dtype=np.float32))
    if opcode == OP_PUSH:
        comm.send(0, grads)


def recv_request(comm, worker: int, num_params: int):
    """Master side: receive one request from ``worker``.  Returns
    ``(opcode, grads-or-None, seq)``."""
    header = comm.recv(worker, (_HEADER_LEN,), torch.float32)
    opcode = int(header[0])
    seq = int(header[1])
    grads = None
    if opcode == OP_PUSH:
        grads = comm.recv(worker, (num_params,), torch.float32)
    return opcode, grads, seq


def send_params(comm, worker: int, flat_params):
    comm.send(worker, flat_params)


def recv_params(comm, num_params: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Worker side: the master's flat params (into ``out``, a contiguous
    float32 CPU tensor of ``num_params`` elements, when given)."""
    return comm.recv(0, (num_params,), torch.float32, out=out)
