"""Synthetic data, a copy of the JAX package's ``data/synthetic.py`` with
the same arrays for the same seed.

HAR: per-class sinusoid motifs plus noise over 9 channels x 128 steps, as
arrays, as a raw-text directory tree in the UCI layout, or straight into
the ``X_*.npy``/``y_*.npy`` cache that ``MotionDataset.load`` reads
(after the processor's seeded validation split and x96 truncation), which
skips text parsing at full size.  Char LM: token windows of repeated
motifs and noise (:func:`generate_char_tokens`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pytorch_distributed_rnn_tpu_torch.data.processor import (
    INPUT_SIGNAL_TYPES,
    MotionDataProcessor,
)

NUM_CLASSES = 6


def generate_har_arrays(
    num_samples: int,
    seq_length: int = 128,
    num_features: int = 9,
    seed: int = 0,
    num_classes: int = NUM_CLASSES,
):
    """Class-dependent sinusoid + noise windows: X (N, T, F) float32,
    y (N, 1) int64 in [0, num_classes)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=(num_samples, 1)).astype(np.int64)
    t = np.arange(seq_length, dtype=np.float32)[None, :, None]
    freq = 0.05 + 0.04 * y[:, :, None].astype(np.float32)  # (N,1,1)
    phase = rng.uniform(0, 2 * np.pi, size=(num_samples, 1, num_features)).astype(
        np.float32
    )
    amplitude = 0.5 + 0.1 * np.arange(num_features, dtype=np.float32)
    X = amplitude * np.sin(freq * t + phase) + 0.1 * rng.randn(
        num_samples, seq_length, num_features
    ).astype(np.float32)
    return X.astype(np.float32), y


def write_synthetic_har_dataset(
    base_path,
    num_train: int = 256,
    num_test: int = 64,
    seq_length: int = 128,
    seed: int = 0,
):
    """Write a raw-text UCI HAR directory tree under ``base_path``."""
    base_path = Path(base_path)
    for split, num in (("train", num_train), ("test", num_test)):
        X, y = generate_har_arrays(num, seq_length, seed=seed + (split == "test"))
        signals_dir = base_path / split / "Inertial Signals"
        signals_dir.mkdir(parents=True, exist_ok=True)
        for f, signal in enumerate(INPUT_SIGNAL_TYPES):
            np.savetxt(signals_dir / f"{signal}{split}.txt", X[:, :, f], fmt="%.6e")
        # labels on disk are 1-based, as in the real dataset
        np.savetxt(base_path / split / f"y_{split}.txt", y + 1, fmt="%d")
    return base_path


def write_synthetic_har_cache(
    base_path,
    num_train: int = 256,
    num_test: int = 64,
    seq_length: int = 128,
    seed: int = 0,
    validation_fraction: float = 0.1,
    split_seed: int | None = None,
):
    """Write the processed cache (``X_{train,validation,test}.npy`` and
    ``y_*.npy``) that :func:`write_synthetic_har_dataset` followed by
    preprocessing would give, without the text round trip (which rounds
    to 7 digits).  ``split_seed`` seeds the validation split, as
    ``--seed`` does for the processor."""
    base_path = Path(base_path)
    base_path.mkdir(parents=True, exist_ok=True)
    X_train, y_train = generate_har_arrays(num_train, seq_length, seed=seed)
    X_test, y_test = generate_har_arrays(num_test, seq_length, seed=seed + 1)
    train, valid = MotionDataProcessor(split_seed).split(
        X_train, y_train, validation_fraction
    )
    splits = {"train": train, "validation": valid, "test": (X_test, y_test)}
    for name, (X, y) in splits.items():
        np.save(base_path / f"X_{name}.npy", X)
        np.save(base_path / f"y_{name}.npy", y)
    return base_path


def generate_char_tokens(num_sequences: int, seq_length: int,
                         vocab_size: int = 256, seed: int = 0):
    """Synthetic character streams for the char-RNN LM family: a mixture of
    repeated motifs and noise so a language model has real structure to
    learn (uniform-random tokens would pin the loss at log(vocab)).
    Returns (num_sequences, seq_length + 1) int32 windows."""
    rng = np.random.RandomState(seed)
    motifs = rng.randint(0, vocab_size, size=(8, 16))
    rows = []
    for _ in range(num_sequences):
        row = []
        while len(row) < seq_length + 1:
            if rng.rand() < 0.8:
                row.extend(motifs[rng.randint(len(motifs))])
            else:
                row.extend(rng.randint(0, vocab_size, size=4))
        rows.append(row[: seq_length + 1])
    return np.asarray(rows, dtype=np.int32)
