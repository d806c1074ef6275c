"""ctypes bindings to the native TCP collectives library, on torch tensors.

The counterpart of the JAX package's ``runtime/native.py``.
``csrc/collectives.cpp`` is a verbatim copy of the JAX package's source
(plain C++, no JAX in it), so the wire format and the ring's accumulation
order are the same on both sides: a reduce-scatter's chunk has the bits of
the same slice of an allreduce, which the sharded update's bitwise parity
with the replicated one rests on.

The library builds at first use with ``g++ -O2 -shared -fPIC -std=c++17
-pthread`` into ``build/torch_runtime/<hash>/libpdrnn_collectives.so``
beside the package (git-ignored; the hash covers the source and the
flags), through a per-process temporary file and an atomic ``os.replace``,
so ranks spawned together never load half a library.  A missing ``g++`` or
a failed build raises.

:class:`Communicator` holds one rank of a ring world: rendezvous at
``MASTER_ADDR``/``MASTER_PORT`` (rank 0 listens there), then a full mesh of
sockets.  Its collectives take CPU tensors (numpy arrays of float32 and
float64 too, viewed without a copy) and pass their ``data_ptr()`` to the
ring, so bfloat16 rides the wire at 2 bytes an element with no numpy view.
The ring writes through those pointers: ``allreduce`` and ``broadcast``
reduce their (contiguous) argument in place, so a caller hands the ring a
buffer it owns - never a view of a parameter or of a gradient it still
reads.  A tensor on the card is refused: stage it through host memory.

Wire dtypes (the codes of ``collectives.cpp``): float32 0, float64 1,
bfloat16 2.  Any other dtype raises ``TypeError`` before anything is
posted; a reduce-scatter whose length the world does not divide raises
``ValueError``.

The elastic entries of the library serve the parameter server's
membership (``param_server/master.py``): ``Communicator(..., star=True)``
star-joins a running world as a worker rank (``pdrnn_init_star``: it dials
rank 0 only), and the master grows its peer table (:meth:`Communicator.
reserve`), accepts (re)joins on its rendezvous listener
(:meth:`Communicator.accept_peer`) and closes a peer's socket
(:meth:`Communicator.close_peer`).  :meth:`Communicator.listener`
(``pdrnn_init_listener``) is rank 0 of an empty world on a known port,
the host end of the JAX package's MPMD pipeline links.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "collectives.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "torch_runtime"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIBRARY = "libpdrnn_collectives.so"
WIRE_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
OPS = {"sum": 0, "mean": 1}
BUILD_SECONDS: list = []  # the seconds of each build this process ran


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIBRARY


def build_native_library() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the ring library builds from "
                           f"{SOURCE.name} at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"ring library build failed (g++ exited {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS.append(time.perf_counter() - t0)
    return out


def wait_for_library(timeout: float = 300.0) -> Path:
    """The library another process (rank 0) is building: returns its path
    once it exists; raises after ``timeout`` seconds."""
    out = library_path()
    deadline = time.monotonic() + timeout
    while not out.exists():
        if time.monotonic() > deadline:
            raise RuntimeError(f"the ring library {out} did not appear within {timeout} s "
                               "(rank 0 builds it)")
        time.sleep(0.05)
    return out


_VOID, _INT, _I64, _DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_SIGNATURES = {  # name: (restype, argtypes)
    "pdrnn_init": (_VOID, [ctypes.c_char_p, _INT, _INT, _INT]),
    "pdrnn_init_star": (_VOID, [ctypes.c_char_p, _INT, _INT, _INT]),
    "pdrnn_init_listener": (_VOID, [_INT, _INT]),
    "pdrnn_reserve": (_INT, [_VOID, _INT]),
    "pdrnn_accept_peer": (_INT, [_VOID, _INT]),
    "pdrnn_close_peer": (_INT, [_VOID, _INT]),
    "pdrnn_set_fault": (None, [_VOID, _DBL, _DBL]),
    "pdrnn_send": (_INT, [_VOID, _INT, _VOID, _I64]),
    "pdrnn_recv": (_INT, [_VOID, _INT, _VOID, _I64]),
    "pdrnn_broadcast": (_INT, [_VOID, _INT, _VOID, _I64]),
    "pdrnn_allreduce": (_INT, [_VOID, _VOID, _I64, _INT, _INT]),
    "pdrnn_reduce_scatter": (_INT, [_VOID, _VOID, _I64, _INT, _INT, _VOID]),
    "pdrnn_allgather": (_INT, [_VOID, _VOID, _I64, _VOID]),
    "pdrnn_allreduce_async": (_I64, [_VOID, _VOID, _I64, _INT, _INT]),
    "pdrnn_reduce_scatter_async": (_I64, [_VOID, _VOID, _I64, _INT, _INT, _VOID]),
    "pdrnn_allgather_async": (_I64, [_VOID, _VOID, _I64, _VOID]),
    "pdrnn_wait": (_INT, [_VOID, _I64, ctypes.POINTER(_DBL)]),
    "pdrnn_thread_count": (_INT, [_VOID]),
    "pdrnn_barrier": (_INT, [_VOID]),
    "pdrnn_destroy": (None, [_VOID]),
}


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native_library()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _host_tensor(data, op: str) -> torch.Tensor:
    """``data`` as a CPU tensor of a wire dtype (numpy arrays viewed, not
    copied); raises before anything is posted."""
    if isinstance(data, np.ndarray):
        if data.dtype not in (np.float32, np.float64):
            raise TypeError(f"{op} takes float32, float64 or bfloat16, got numpy {data.dtype}")
        data = torch.from_numpy(np.ascontiguousarray(data))
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"{op} takes a CPU tensor or a numpy array, got {type(data).__name__}")
    if data.dtype not in WIRE_DTYPES:
        raise TypeError(f"{op} takes float32, float64 or bfloat16, got {data.dtype}")
    if data.device.type != "cpu":
        raise ValueError(f"{op} runs on the host: stage the {data.device} tensor through "
                         "host memory first")
    return data


def _output(out, numel: int, like: torch.Tensor, op: str) -> torch.Tensor:
    if out is None:
        return torch.empty(numel, dtype=like.dtype)
    out = _host_tensor(out, op)
    if out.dtype != like.dtype or out.numel() != numel or not out.is_contiguous():
        raise ValueError(f"{op}: out must be a contiguous {like.dtype} tensor of {numel} "
                         f"elements, got {out.dtype} {tuple(out.shape)}")
    return out


class CollectiveHandle:
    """A nonblocking collective's handle: ``result`` is valid after
    :meth:`Communicator.wait`, which also sets ``comm_seconds``, the
    collective's own execution time on the comm worker (its wire time with
    no overlap).  Holds the buffers the ring borrows until then."""

    __slots__ = ("id", "op", "result", "comm_seconds", "_keepalive", "_done")

    def __init__(self, handle_id: int, op: str, result, keepalive):
        self.id = handle_id
        self.op = op
        self.result = result
        self.comm_seconds = 0.0
        self._keepalive = keepalive
        self._done = False


class Communicator:
    """One rank of a ring world over TCP (host-side transport).  A world of
    1 opens no socket.  ``star=True`` (a worker rank, the elastic (re)join)
    dials rank 0 only, whose acceptor must install it (:meth:`accept_peer`).
    ``PDRNN_FAULT_DELAY_MS`` / ``PDRNN_FAULT_LOSS_PROB`` in the environment
    set the fault injection at construction."""

    def __init__(self, master_addr: str = "127.0.0.1", master_port: int = 29500,
                 rank: int = 0, world_size: int = 1, star: bool = False):
        self._lib = _load()
        if star and rank < 1:
            raise ValueError("star join is for worker ranks (>= 1)")
        init = self._lib.pdrnn_init_star if star else self._lib.pdrnn_init
        self._handle = init(master_addr.encode(), int(master_port), int(rank), int(world_size))
        if not self._handle:
            raise RuntimeError(f"rendezvous failed (rank {rank}/{world_size} via "
                               f"{master_addr}:{master_port}{', star join' if star else ''})")
        self.rank = int(rank)
        self.world_size = int(world_size)
        self._fault_from_env()

    def _fault_from_env(self) -> None:
        # the netem analogue: a fault sweep exports these before the ranks start
        delay_ms = float(os.environ.get("PDRNN_FAULT_DELAY_MS", "0") or 0)
        loss_prob = float(os.environ.get("PDRNN_FAULT_LOSS_PROB", "0") or 0)
        if delay_ms or loss_prob:
            self.set_fault(delay_ms, loss_prob)

    @classmethod
    def listener(cls, port: int, capacity: int = 2) -> "Communicator":
        """Rank 0 of an empty world bound to the known ``port``, with a
        ``capacity``-slot peer table: peers arrive later through
        :meth:`accept_peer` star joins."""
        self = cls.__new__(cls)
        self._lib = _load()
        self._handle = self._lib.pdrnn_init_listener(int(port), int(capacity))
        if not self._handle:
            raise RuntimeError(f"listener world failed to bind port {port}")
        self.rank = 0
        self.world_size = 1
        self._fault_from_env()
        return self

    # -- elastic membership (master side) ----------------------------------------

    def reserve(self, capacity: int) -> None:
        """Grow the peer table to ``capacity`` rank slots, so that accepting
        a new rank never reallocates it under a concurrent send or recv.
        Call once, before the acceptor thread starts."""
        self._lib.pdrnn_reserve(self._handle, int(capacity))

    def accept_peer(self, timeout_s: float = 0.5) -> int | None:
        """Accept one elastic (re)join on the rendezvous listener (rank 0):
        the joining rank, or None on a timeout or a stray connection.  A
        rank whose slot is taken has its old socket shut down and
        replaced; ``world_size`` grows with a new rank."""
        rank = self._lib.pdrnn_accept_peer(self._handle, int(timeout_s * 1000))
        if rank < 0:
            return None
        self.world_size = max(self.world_size, rank + 1)
        return rank

    def close_peer(self, rank: int) -> None:
        """Shut down and close one peer's socket; a later accept of the
        same rank installs a fresh one."""
        self._lib.pdrnn_close_peer(self._handle, int(rank))

    def set_fault(self, delay_ms: float = 0.0, loss_prob: float = 0.0):
        """A delay before every send, and a probability that a send pays a
        simulated retransmit timeout (TCP never drops: loss is latency)."""
        self._lib.pdrnn_set_fault(self._handle, float(delay_ms), float(loss_prob))

    def _check(self, status: int, op: str):
        if status != 0:
            raise RuntimeError(f"{op} failed (rank {self.rank})")

    def _even(self, data: torch.Tensor, op: str):
        if data.numel() % self.world_size:
            raise ValueError(f"{op} needs size % world == 0, got {data.numel()} % "
                             f"{self.world_size}")

    # -- point to point ---------------------------------------------------------

    def send(self, dst: int, data):
        data = _host_tensor(data, "send").contiguous()
        self._check(self._lib.pdrnn_send(self._handle, dst, data.data_ptr(),
                                         data.numel() * data.element_size()), "send")

    def recv(self, src: int, shape, dtype=torch.float32, out=None) -> torch.Tensor:
        """``shape`` elements of ``dtype`` from ``src``, into ``out`` (a
        contiguous CPU tensor of that many elements and that dtype, e.g.
        a reused pinned buffer) when given."""
        if out is None:
            out = torch.empty(shape, dtype=dtype)
        else:
            out = _output(out, int(np.prod(shape)), torch.empty(0, dtype=dtype), "recv")
        self._check(self._lib.pdrnn_recv(self._handle, src, out.data_ptr(),
                                         out.numel() * out.element_size()), "recv")
        return out

    # -- blocking collectives ---------------------------------------------------

    def broadcast(self, data, root: int = 0) -> torch.Tensor:
        """Rank ``root``'s ``data`` on every rank, written in place into a
        contiguous ``data`` (else into a contiguous copy), which is returned."""
        data = _host_tensor(data, "broadcast").contiguous()
        self._check(self._lib.pdrnn_broadcast(self._handle, root, data.data_ptr(),
                                              data.numel() * data.element_size()), "broadcast")
        return data

    def allreduce(self, data, op: str = "sum") -> torch.Tensor:
        """In-place ring allreduce (``op`` ``"sum"`` or ``"mean"``); any
        length.  bfloat16 accumulates each hop in float32 and rounds back."""
        data = _host_tensor(data, "allreduce").contiguous()
        self._check(self._lib.pdrnn_allreduce(self._handle, data.data_ptr(), data.numel(),
                                              WIRE_DTYPES[data.dtype], OPS[op]), "allreduce")
        return data

    def reduce_scatter(self, data, op: str = "sum", out=None) -> torch.Tensor:
        """This rank's chunk (chunk ``rank`` of ``world``) of the elementwise
        reduction of the flat ``data``, whose length the world must divide.
        ``data`` is not written: a private copy is reduced.  The reduce
        phase is the allreduce's, so each chunk has the bits of the same
        slice of :meth:`allreduce`."""
        return self.wait(self.reduce_scatter_async(data, op, out))

    def allgather(self, data, out=None) -> torch.Tensor:
        """Every rank's ``data``, shape ``(world,) + data.shape``, in rank
        order (into ``out``, a contiguous tensor of that many elements, when
        given)."""
        return self.wait(self.allgather_async(data, out))

    def barrier(self):
        self._check(self._lib.pdrnn_barrier(self._handle), "barrier")

    # -- nonblocking collectives ------------------------------------------------
    #
    # Sync and async collectives run in order on one comm worker a
    # communicator, so handles stay matched across ranks as long as every
    # rank posts them in the same order.  wait() blocks only until its own
    # job is done; the jobs queued behind it keep streaming.

    def allreduce_async(self, data, op: str = "sum") -> CollectiveHandle:
        """Nonblocking :meth:`allreduce`; the handle's ``result`` is the
        (contiguous) argument, reduced in place once waited."""
        data = _host_tensor(data, "allreduce").contiguous()
        code, op_code = WIRE_DTYPES[data.dtype], OPS[op]
        handle_id = self._lib.pdrnn_allreduce_async(self._handle, data.data_ptr(), data.numel(),
                                                    code, op_code)
        return CollectiveHandle(handle_id, "allreduce", data, data)

    def reduce_scatter_async(self, data, op: str = "sum", out=None) -> CollectiveHandle:
        """Nonblocking :meth:`reduce_scatter`, with its dtype and length
        contract and its accumulation order."""
        data = _host_tensor(data, "reduce_scatter")
        self._even(data, "reduce_scatter")
        code, op_code = WIRE_DTYPES[data.dtype], OPS[op]
        out = _output(out, data.numel() // self.world_size, data, "reduce_scatter")
        scratch = data.reshape(-1).clone()
        handle_id = self._lib.pdrnn_reduce_scatter_async(
            self._handle, scratch.data_ptr(), scratch.numel(), code, op_code, out.data_ptr())
        return CollectiveHandle(handle_id, "reduce_scatter", out, (scratch, out))

    def allgather_async(self, data, out=None) -> CollectiveHandle:
        """Nonblocking :meth:`allgather`."""
        data = _host_tensor(data, "allgather").contiguous()
        out = _output(out, data.numel() * self.world_size, data, "allgather")
        handle_id = self._lib.pdrnn_allgather_async(
            self._handle, data.data_ptr(), data.numel() * data.element_size(), out.data_ptr())
        return CollectiveHandle(handle_id, "allgather",
                                out.view((self.world_size,) + tuple(data.shape)), (data, out))

    def wait(self, handle: CollectiveHandle) -> torch.Tensor:
        """Block until ``handle``'s collective is done; returns its result.
        Waiting a finished handle returns the same result again."""
        if not handle._done:
            seconds = ctypes.c_double(0.0)
            status = self._lib.pdrnn_wait(self._handle, handle.id, ctypes.byref(seconds))
            handle.comm_seconds = float(seconds.value)
            handle._done = True
            handle._keepalive = None
            self._check(status, handle.op)
        return handle.result

    def thread_count(self) -> int:
        """Worker threads the library made for this communicator in its
        life: 0 until the first collective of a world above 1, then 2 (one
        sender, one collective worker) however many collectives run."""
        return int(self._lib.pdrnn_thread_count(self._handle))

    def close(self):
        if self._handle:
            self._lib.pdrnn_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def init_from_env() -> Communicator:
    """A communicator from ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE`` (defaults 127.0.0.1, 29500, 0, 1: no launcher, a world
    of 1)."""
    return Communicator(master_addr=os.environ.get("MASTER_ADDR", "127.0.0.1"),
                        master_port=int(os.environ.get("MASTER_PORT", "29500")),
                        rank=int(os.environ.get("RANK", "0")),
                        world_size=int(os.environ.get("WORLD_SIZE", "1")))
