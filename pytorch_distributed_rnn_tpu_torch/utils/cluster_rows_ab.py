"""Rows a cluster of the GRU forward's cluster kernel: R=8 against R=4.

    python -m pytorch_distributed_rnn_tpu_torch.utils.cluster_rows_ab

The package's ``gru_fwd_cluster_kernel`` runs ``kFwdClusterRows`` = 8 batch
rows a cluster.  This copies the package into ``build/cluster_rows_ab/``,
sets the copy's rows to 4 (``csrc/gru_fwd.cu`` and ``ops/fused_rnn.py``),
and times ``gru_fwd`` at the char-LM shape (T=128, B=256, H=512, float32)
in both, each in its own process, in turns (8, 4, 4, 8): the whole call
and one cluster's rows (the serial floor), CUDA events over 20 launches,
with the error against the plain version.  Needs one card.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
WORK = PACKAGE.parent / "build" / "cluster_rows_ab"
SUBSTITUTIONS = (
    ("csrc/gru_fwd.cu", "constexpr int kFwdClusterRows = 8;", "constexpr int kFwdClusterRows = 4;"),
    ("ops/fused_rnn.py", "GRU_FWD_CLUSTER_ROWS = 8", "GRU_FWD_CLUSTER_ROWS = 4"),
)
SEQ_LEN, BATCH, HIDDEN = 128, 256, 512


def _copy(rows: int) -> Path:
    """A copy of the package with ``rows`` rows a cluster; its parent goes
    on ``sys.path``."""
    root = WORK / f"rows{rows}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / PACKAGE.name, ignore=shutil.ignore_patterns("__pycache__"))
    if rows != 8:
        for rel, old, new in SUBSTITUTIONS:
            path = root / PACKAGE.name / rel
            text = path.read_text()
            if old not in text:
                raise RuntimeError(f"{rel}: {old!r} not found")
            path.write_text(text.replace(old, new))
    return root


def _time_one() -> dict:
    """In a child process whose ``sys.path[0]`` is a copy: its gru_fwd."""
    import torch

    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    if not Path(fr.__file__).resolve().is_relative_to(Path(sys.path[0]).resolve()):
        raise RuntimeError(f"imported {fr.__file__}, not the copy on {sys.path[0]}")

    def time_ms(fn, iters=20):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"rows": fr.gru_tile(HIDDEN)[0]}
    for batch, key in ((BATCH, "ms"), (out["rows"], "serial_ms")):
        x = torch.randn(SEQ_LEN, batch, 3 * HIDDEN, generator=gen, device="cuda")
        h0 = 0.5 * torch.randn(batch, HIDDEN, generator=gen, device="cuda")
        w = torch.randn(HIDDEN, 3 * HIDDEN, generator=gen, device="cuda") / HIDDEN ** 0.5
        b = 0.1 * torch.randn(3 * HIDDEN, generator=gen, device="cuda")
        out[key] = time_ms(lambda: fr.gru_fwd(x, h0, w, b))
        err = (fr.gru_fwd(x, h0, w, b) - fr.gru_fwd_plain(x, h0, w, b)).abs().max().item()
        out[f"{key}_max_abs_err"] = err
    out.update(fr.cluster_shape("gru_fwd", HIDDEN, BATCH))
    return out


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    roots = {rows: _copy(rows) for rows in (8, 4)}
    for rows in (8, 4, 4, 8):
        code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
                "from pytorch_distributed_rnn_tpu_torch.utils.cluster_rows_ab import _time_one; "
                "print(json.dumps(_time_one()))")
        proc = subprocess.run([sys.executable, "-c", code, str(roots[rows])],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"rows {rows}: {proc.stderr[-2000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        if result["rows"] != rows:
            raise RuntimeError(f"the copy for {rows} rows ran {result['rows']}")
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
