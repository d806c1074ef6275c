"""Checkpoint save/load for the model and optimizer state, in the JAX
package's file format.

One file, as the JAX package's ``training/checkpoint.py`` writes it: the
same names (``best-model.ckpt``, ``checkpoint-epoch-N.ckpt``), one JSON
header line (``epoch``, ``loss``, ``model_len``, ``opt_len``, a CRC32 a
section under ``crcs``, and ``extra``), then two flax-msgpack sections
(``utils/flax_msgpack.py``): the model's parameters and ``optax.adam``'s
state, each tree in the JAX tree order and with JAX's dtypes
(``interop.py``).  So a file moves between the two frameworks both ways:
a JAX-written checkpoint resumes or is served here, and the JAX package
resumes or serves one the port wrote.

The trainer's state beyond the two sections goes into the header's
``extra``, which JAX's loader hands back and its trainer ignores:
``extra["trainer"]`` holds every rank's dropout generator state (base64
of its bytes) with the world and the device kind it belongs to, and
``extra["parameters"]`` the module's parameter names in their order, so
that a reader without the model lays the state out in the writer's
order.  The non-finite guard's counters are in the optimizer tree, as
``optax.apply_if_finite``'s state.  A JAX-written file has no streams:
its dropout masks start fresh from the seed.

Writes go to a temp file, ``fsync``, then ``os.replace``, so a crash
never leaves a half-written file under the checkpoint name; a truncated
or corrupt file fails to load with :class:`CheckpointCorruptError`.

Files written by the port before it wrote JAX's format (``torch.save``
sections, told by the zip magic at the start of the model section, and
an optional third section, ``trainer_len``) still load.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import re
import zlib
from pathlib import Path

import torch

from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch.utils import flax_msgpack

log = logging.getLogger(__name__)

_EPOCH_CKPT_RE = re.compile(r"^checkpoint-epoch-(\d+)\.ckpt$")
# a torch.save blob is a zip archive
_ZIP_MAGIC = b"PK\x03\x04"


class CheckpointCorruptError(RuntimeError):
    """The file is truncated, unparseable, or fails CRC verification."""


def _encode_trainer(state: dict) -> dict:
    """The trainer state as JSON: each dropout generator state as base64."""
    out = {key: value for key, value in state.items() if key not in ("dropout_generators", "nonfinite")}
    if state.get("dropout_generators") is not None:
        out["dropout_generators"] = [
            base64.b64encode(g.detach().cpu().contiguous().numpy().tobytes()).decode("ascii")
            for g in state["dropout_generators"]]
    return out


def _decode_trainer(state: dict) -> dict:
    out = dict(state)
    if state.get("dropout_generators") is not None:
        out["dropout_generators"] = [
            torch.frombuffer(bytearray(base64.b64decode(g)), dtype=torch.uint8)
            for g in state["dropout_generators"]]
    return out


def save_checkpoint(checkpoint_dir, epoch: int, model_state, opt_state,
                    loss: float, best: bool = False, trainer_state=None) -> Path:
    """Write a checkpoint atomically; returns its path.  ``model_state`` is
    the model's ``state_dict()`` (its order is the parameters'),
    ``opt_state`` ``torch.optim.Adam``'s ``state_dict`` (``{}`` or no
    state: an optimizer that has not stepped); ``trainer_state`` (a dict,
    or None) holds the dropout streams and the guard's counters."""
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    name = "best-model.ckpt" if best else f"checkpoint-epoch-{epoch + 1}.ckpt"
    path = checkpoint_dir / name

    params = {key: value.detach().cpu() for key, value in model_state.items()}
    guard = None if trainer_state is None else trainer_state.get("nonfinite")
    model_bytes = flax_msgpack.serialize(interop.state_dict_to_tree(params))
    opt_bytes = flax_msgpack.serialize(interop.adam_state_to_optax(opt_state, params, guard))
    extra = {"parameters": list(params)}
    if trainer_state is not None:
        extra["trainer"] = _encode_trainer(trainer_state)
    header = json.dumps({
        "epoch": epoch + 1,
        "loss": float(loss),
        "model_len": len(model_bytes),
        "opt_len": len(opt_bytes),
        "crcs": {"model": zlib.crc32(model_bytes), "opt": zlib.crc32(opt_bytes)},
        "extra": extra,
    }).encode()
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(header + b"\n")
            f.write(model_bytes)
            f.write(opt_bytes)
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
    (``trainer_bytes`` None but in an older port file with a trainer
    section), raising :class:`CheckpointCorruptError` on any structural
    damage."""
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


def _is_torch_save(blob: bytes) -> bool:
    return blob[:4] == _ZIP_MAGIC


def _load_section(path, blob: bytes):
    """A section as a tree: flax-msgpack, or an older port file's
    ``torch.save`` state."""
    try:
        if _is_torch_save(blob):
            return torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
        return flax_msgpack.restore(blob)
    except Exception as exc:
        raise CheckpointCorruptError(
            f"{path}: sections verified but failed to deserialize as flax-msgpack or "
            f"torch.save state ({exc})"
        ) from exc


def _tree_names(tree, prefix: str = "") -> list[str]:
    """The dotted names of a tree's leaves, depth first in its order."""
    names = []
    for key, value in tree.items():
        name = f"{prefix}{key}"
        names.extend(_tree_names(value, name + ".") if isinstance(value, dict) else [name])
    return names


def _meta(header, trainer) -> dict:
    meta = {"epoch": header["epoch"], "loss": header["loss"], "trainer": trainer}
    if "extra" in header:
        meta["extra"] = header["extra"]
    return meta


def load_checkpoint(path, names=None):
    """``(model_state, opt_state, meta)`` from ``path``, tensors on the
    CPU: the model's ``state_dict`` and ``torch.optim.Adam``'s, their
    order ``names`` (the module's parameter names in order), or, where
    ``names`` is None, the writer's (``extra["parameters"]``; a JAX-written
    file's tree order).  ``opt_state``'s parameter group holds only
    ``params`` in JAX's format: the optimizer keeps its own
    hyperparameters.  ``meta["trainer"]`` holds the dropout streams and
    the guard's counters (``nonfinite``) where the file has them, else
    None.  Raises :class:`CheckpointCorruptError` for a damaged file."""
    header, model_bytes, opt_bytes, trainer_bytes = _read_sections(path)
    model_tree = _load_section(path, model_bytes)
    opt_tree = _load_section(path, opt_bytes)
    if _is_torch_save(model_bytes):
        trainer = None if trainer_bytes is None else _load_section(path, trainer_bytes)
        return model_tree, opt_tree, _meta(header, trainer)
    extra = header.get("extra") or {}
    names = list(names or extra.get("parameters") or _tree_names(model_tree))
    try:
        model_state = interop.tree_to_state_dict(model_tree, names)
        opt_state, guard = interop.optax_to_adam_state(opt_tree, names)
    except (KeyError, TypeError, ValueError) as exc:
        raise CheckpointCorruptError(
            f"{path}: sections verified but do not hold the parameters {names} ({exc!r})"
        ) from exc
    trainer = _decode_trainer(extra["trainer"]) if "trainer" in extra else None
    if guard is not None:
        trainer = {**(trainer or {}), "nonfinite": guard}
    return model_state, opt_state, _meta(header, trainer)


def load_model_params(path, model):
    """Load the model section of ``path`` into ``model`` (an
    ``nn.Module``) without deserializing the optimizer section; returns
    ``meta``.  Every section is still length- and CRC-verified, so a
    corrupt optimizer section fails the load: a checkpoint is intact or
    rejected, never half-trusted.  A model section that does not fit the
    module raises :class:`CheckpointCorruptError` naming the file."""
    header, model_bytes, _, _ = _read_sections(path)
    tree = _load_section(path, model_bytes)
    try:
        state = tree if _is_torch_save(model_bytes) else interop.tree_to_state_dict(
            tree, list(model.state_dict()))
        model.load_state_dict(state)
    except (RuntimeError, TypeError, AttributeError, KeyError) as exc:
        raise CheckpointCorruptError(
            f"{path}: model section verified but does not fit the given model ({exc!r})"
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
