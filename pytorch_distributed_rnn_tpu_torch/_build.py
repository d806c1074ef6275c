"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>.so`` with a
plain C interface (no PyTorch headers, so a build takes seconds), for
Hopper only: ``-gencode arch=compute_90a,code=sm_90a``; ``flash_bwd.cu``
holds two kernels, ``flash_dq`` and ``flash_dkv``.  Libraries go to
``build/torch_kernels/<hash>/`` beside the package, keyed on a hash of
every source and the flags, so an edited source rebuilds and an unchanged
one loads from disk.  :func:`build_all` starts one ``nvcc`` per source at
once; :func:`load` builds on first use.  A missing ``nvcc`` or a failed
build raises: there is no fallback.  ``-Xptxas -v`` makes nvcc report each
kernel's registers and spills; :data:`BUILD_LOGS` keeps that output of
every source this process built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
KERNELS = ("lstm_fwd", "lstm_bwd", "gru_fwd", "gru_bwd", "flash_fwd", "flash_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_LOGS: dict[str, str] = {}  # nvcc's output by source, for the builds of this process


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location; raises when none exists."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "kernels build from csrc/ at first use"
    )


def _source_hash() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / _source_hash() / f"lib{name}.so"


def _start(name: str, out: Path) -> tuple[subprocess.Popen, Path]:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile every kernel that is not built yet, all ``nvcc`` processes
    at once; returns ``{name: library path}``."""
    pending = {}
    for name in names:
        out = library_path(name)
        if not out.exists():
            pending[name] = (out, *_start(name, out))
    failures = []
    for name, (out, proc, tmp) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            BUILD_LOGS[name] = log
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {name: library_path(name) for name in names}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``lib<name>.so``, built first if needed."""
    return ctypes.CDLL(str(build_all((name,))[name]))
