"""Checkpoint save/load for the model and optimizer state.

The framing of the JAX package's ``training/checkpoint.py``: the same
file names (``best-model.ckpt``, ``checkpoint-epoch-N.ckpt``), one JSON
header line with metadata, section lengths and a CRC32 per section, then
the model section, the optimizer section and, where the trainer has one,
the trainer section (``trainer_len``): the state a resumed run needs
beside the model and ``torch.optim.Adam``'s layout, the dropout
generator's state and the non-finite guard's counters.  A file without it
loads as before.  Writes go to a temp file,
``fsync``, then ``os.replace``, so a crash never leaves a half-written
file under the checkpoint name; a truncated or corrupt file fails to
load with :class:`CheckpointCorruptError`.

The sections hold the port's own serialisation, ``torch.save`` of the
state dicts (loaded with ``weights_only=True``), so they are not
interchangeable with the JAX package's flax-msgpack sections: a
JAX-written file passes the framing checks and then fails to load with
:class:`CheckpointCorruptError` (cross-framework checkpoints are ROADMAP
A6).  The serving loaders (:func:`load_model_params`,
:func:`find_latest_checkpoint`) read the model section alone.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
import zlib
from pathlib import Path

import torch

log = logging.getLogger(__name__)

_EPOCH_CKPT_RE = re.compile(r"^checkpoint-epoch-(\d+)\.ckpt$")


class CheckpointCorruptError(RuntimeError):
    """The file is truncated, unparseable, or fails CRC verification."""


def _to_bytes(state) -> bytes:
    buf = io.BytesIO()
    torch.save(state, buf)
    return buf.getvalue()


def save_checkpoint(checkpoint_dir, epoch: int, model_state, opt_state,
                    loss: float, best: bool = False, trainer_state=None) -> Path:
    """Write a checkpoint atomically; returns its path.  ``trainer_state``
    (a dict, or None) becomes the trainer section."""
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    name = "best-model.ckpt" if best else f"checkpoint-epoch-{epoch + 1}.ckpt"
    path = checkpoint_dir / name

    sections = {"model": _to_bytes(model_state), "opt": _to_bytes(opt_state)}
    if trainer_state is not None:
        sections["trainer"] = _to_bytes(trainer_state)
    header = json.dumps({
        "epoch": epoch + 1,
        "loss": float(loss),
        **{f"{name}_len": len(blob) for name, blob in sections.items()},
        "crcs": {name: zlib.crc32(blob) for name, blob in sections.items()},
    }).encode()
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(header + b"\n")
            for blob in sections.values():
                f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if tmp.exists():  # replace failed or write raised
            tmp.unlink()
    # make the rename itself durable where the filesystem allows it
    try:
        dir_fd = os.open(checkpoint_dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError:  # pragma: no cover - platform-dependent
        pass
    return path


def _read_sections(path):
    """``(header, model_bytes, opt_bytes, trainer_bytes)`` of ``path``
    (``trainer_bytes`` None where the file has no trainer section), raising
    :class:`CheckpointCorruptError` on any structural damage."""
    try:
        with open(path, "rb") as f:
            try:
                header = json.loads(f.readline().decode())
                lengths = {"model": int(header["model_len"]), "opt": int(header["opt_len"])}
                if "trainer_len" in header:
                    lengths["trainer"] = int(header["trainer_len"])
            except (UnicodeDecodeError, json.JSONDecodeError, KeyError,
                    TypeError, ValueError) as exc:
                raise CheckpointCorruptError(f"{path}: bad header ({exc})") from exc
            blobs = {name: f.read(n) for name, n in lengths.items()}
            trailing = f.read(1)
    except OSError as exc:
        raise CheckpointCorruptError(f"{path}: unreadable ({exc})") from exc
    if any(len(blobs[name]) != n for name, n in lengths.items()):
        raise CheckpointCorruptError(
            f"{path}: truncated - expected {'+'.join(map(str, lengths.values()))} section "
            f"bytes, found {'+'.join(str(len(b)) for b in blobs.values())}"
        )
    if trailing:
        raise CheckpointCorruptError(f"{path}: trailing bytes past the declared sections")
    crcs = header.get("crcs") or {}
    for name, blob in blobs.items():
        if zlib.crc32(blob) != crcs.get(name):
            raise CheckpointCorruptError(f"{path}: {name} section CRC mismatch")
    return header, blobs["model"], blobs["opt"], blobs.get("trainer")


def _load_section(path, blob: bytes):
    try:
        return torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    except Exception as exc:
        raise CheckpointCorruptError(
            f"{path}: sections verified but failed to deserialize as torch.save "
            f"state ({exc}); a checkpoint written by the JAX package holds "
            "flax-msgpack sections, which the port does not read yet (ROADMAP A6, "
            "cross-framework checkpoints)"
        ) from exc


def load_checkpoint(path):
    """``(model_state, opt_state, meta)`` from ``path``, tensors on the
    CPU; ``meta["trainer"]`` is the trainer section (None where the file
    has none).  Raises :class:`CheckpointCorruptError` for a damaged
    file."""
    header, model_bytes, opt_bytes, trainer_bytes = _read_sections(path)
    model_state = _load_section(path, model_bytes)
    opt_state = _load_section(path, opt_bytes)
    trainer_state = None if trainer_bytes is None else _load_section(path, trainer_bytes)
    return model_state, opt_state, {"epoch": header["epoch"], "loss": header["loss"],
                                    "trainer": trainer_state}


def load_model_params(path, model):
    """Load the model section of ``path`` into ``model`` (an
    ``nn.Module``) without deserializing the optimizer section; returns
    ``meta``.  Every section is still length- and CRC-verified, so a
    corrupt optimizer section fails the load: a checkpoint is intact or
    rejected, never half-trusted.  A state dict that does not fit the
    module raises :class:`CheckpointCorruptError` naming the file."""
    header, model_bytes, _, _ = _read_sections(path)
    state = _load_section(path, model_bytes)
    try:
        model.load_state_dict(state)
    except (RuntimeError, TypeError, AttributeError) as exc:
        raise CheckpointCorruptError(
            f"{path}: model section verified but does not fit the given model ({exc})"
        ) from exc
    return {"epoch": header["epoch"], "loss": header["loss"]}


def checkpoint_candidates(checkpoint_dir) -> list[Path]:
    """Checkpoints under ``checkpoint_dir``, newest first: epoch files by
    their epoch (descending), then ``best-model.ckpt`` last (the best
    validation state, not the furthest progress)."""
    checkpoint_dir = Path(checkpoint_dir)
    if not checkpoint_dir.is_dir():
        return []
    epochs = []
    for entry in checkpoint_dir.iterdir():
        m = _EPOCH_CKPT_RE.match(entry.name)
        if m:
            epochs.append((int(m.group(1)), entry))
    out = [p for _, p in sorted(epochs, key=lambda t: t[0], reverse=True)]
    best = checkpoint_dir / "best-model.ckpt"
    if best.exists():
        out.append(best)
    return out


def find_latest_checkpoint(checkpoint_dir) -> Path | None:
    """The newest checkpoint that passes structural verification, or
    ``None``; corrupt or truncated files are skipped (and logged)."""
    for path in checkpoint_candidates(checkpoint_dir):
        try:
            _read_sections(path)
        except CheckpointCorruptError as exc:
            log.warning(f"find_latest_checkpoint: skipping {path}: {exc}")
            continue
        return path
    return None


def rotate_checkpoints(checkpoint_dir, keep_last: int) -> list[Path]:
    """Delete all but the newest ``keep_last`` epoch checkpoints
    (``best-model.ckpt`` is never rotated); returns the deleted paths.
    ``keep_last <= 0`` keeps everything."""
    if keep_last <= 0:
        return []
    epochs = []
    for entry in Path(checkpoint_dir).iterdir():
        m = _EPOCH_CKPT_RE.match(entry.name)
        if m:
            epochs.append((int(m.group(1)), entry))
    deleted = []
    for _, path in sorted(epochs, reverse=True)[keep_last:]:
        try:
            path.unlink()
            deleted.append(path)
        except OSError as exc:  # pragma: no cover - racing cleanup is fine
            log.warning(f"rotate_checkpoints: could not delete {path}: {exc}")
    return deleted
