"""The PyTorch port stands alone: no module of it, and not
``chip_smoke.py``, imports JAX, flax, optax or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "pytorch_distributed_rnn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pytorch_distributed_rnn_tpu")
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        f"for name in {list(FORBIDDEN)!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("relative", [
    "runtime/__init__.py", "runtime/native.py", "examples/__init__.py",
    "examples/example_single.py", "examples/example_ddp.py", "examples/example_horovod.py",
    "examples/example_p2p.py", "models/toy.py", "training/native_ddp.py",
    "parallel/bucketing.py", "utils/worlds.py",
    "serving/__init__.py", "serving/__main__.py", "serving/adapters.py", "serving/buckets.py",
    "serving/cli.py", "serving/drill.py", "serving/engine.py", "serving/loadgen.py",
    "serving/protocol.py", "serving/scheduler.py", "serving/server.py", "obs/__init__.py",
    "obs/live.py", "obs/summary.py", "obs/tracectx.py", "models/attention_lm.py",
    "examples/example_generate.py", "resilience/faults.py", "resilience/guard.py",
    "data/prefetch.py", "obs/trace.py", "launcher/__init__.py", "launcher/supervisor.py",
    "serving/fleet/__init__.py", "serving/fleet/__main__.py", "serving/fleet/cli.py",
    "serving/fleet/drill.py", "serving/fleet/pool.py", "serving/fleet/router.py",
])
def test_new_modules_are_checked(relative):
    assert PORT / relative in FILES


def test_ring_library_builds_under_build_from_the_ports_own_source():
    from pytorch_distributed_rnn_tpu_torch.runtime import native

    assert native.SOURCE == PORT / "runtime" / "csrc" / "collectives.cpp"
    assert native.library_path().is_relative_to(ROOT / "build" / "torch_runtime")
    assert native.library_path().name == "libpdrnn_collectives.so"
    # a verbatim copy: the same wire format and accumulation order as the
    # JAX package's ring
    jax_source = ROOT / "pytorch_distributed_rnn_tpu" / "runtime" / "csrc" / "collectives.cpp"
    assert native.SOURCE.read_bytes() == jax_source.read_bytes()
