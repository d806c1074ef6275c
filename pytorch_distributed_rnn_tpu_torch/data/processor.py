"""UCI HAR raw-text processor, a copy of the JAX package's
``data/processor.py`` with the same semantics: the nine inertial-signal
text files per split stack to float32 (N, 128, 9), 1-based labels become
0-based int64 (N, 1), a validation split is carved off the training set
with a permutation from ``RandomState(seed)``, and the training set is
truncated to a multiple of 96 so runs with 1/2/4/8/12 workers x 1/2/4
slots consume identical data.  Batches are therefore identical to the
JAX package's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

INPUT_SIGNAL_TYPES = [
    "body_acc_x_",
    "body_acc_y_",
    "body_acc_z_",
    "body_gyro_x_",
    "body_gyro_y_",
    "body_gyro_z_",
    "total_acc_x_",
    "total_acc_y_",
    "total_acc_z_",
]

# Training-set truncation keeps sample counts divisible for every node/slot
# combination benchmarked by the reference (1/2/4/8/12 nodes x 1/2/4 slots).
WORKER_DIVISOR = 96


class MotionDataProcessor:
    TRAIN = "train"
    TEST = "test"

    def __init__(self, seed: int | None = None):
        self.seed = seed

    def process_data(self, base_path, validation_fraction: float = 0.05):
        """Load the raw dataset under ``base_path``.

        Returns ``((X_train, y_train), (X_valid, y_valid), (X_test, y_test))``
        with X float32 (N, T, 9) and y int64 (N, 1).
        """
        base_path = Path(base_path)

        X_train = self._load_signals(base_path / self.TRAIN, "train")
        X_test = self._load_signals(base_path / self.TEST, "test")
        y_train = self._load_labels(base_path / self.TRAIN / "y_train.txt")
        y_test = self._load_labels(base_path / self.TEST / "y_test.txt")

        train, valid = self.split(X_train, y_train, validation_fraction)
        return train, valid, (X_test, y_test)

    def split(self, features, labels, validation_fraction: float):
        """Seeded validation split, then the training part truncated to a
        multiple of ``WORKER_DIVISOR``: ``((X_train, y_train), (X_valid,
        y_valid))``."""
        (X_train, y_train), valid = self._train_valid_split(
            features, labels, validation_fraction
        )
        num_train = (len(X_train) // WORKER_DIVISOR) * WORKER_DIVISOR
        return (X_train[:num_train], y_train[:num_train]), valid

    def _load_signals(self, split_dir: Path, split: str) -> np.ndarray:
        """Stack the 9 per-signal text files into (N, T, 9) float32."""
        signals = []
        for signal in INPUT_SIGNAL_TYPES:
            path = split_dir / "Inertial Signals" / f"{signal}{split}.txt"
            signals.append(np.loadtxt(path, dtype=np.float32))  # (N, T)
        return np.stack(signals, axis=-1)

    def _load_labels(self, path: Path) -> np.ndarray:
        """1-based class ids in a text column -> 0-based int64 (N, 1)."""
        y = np.loadtxt(path, dtype=np.int64).reshape(-1, 1)
        return y - 1

    def _train_valid_split(self, features, labels, validation_fraction):
        if len(features) != len(labels):
            raise ValueError("features/labels size mismatch")
        rng = np.random.RandomState(self.seed)
        indices = rng.permutation(len(features))
        num_valid = int(len(features) * validation_fraction)
        valid_idx, train_idx = indices[:num_valid], indices[num_valid:]
        return (
            (features[train_idx], labels[train_idx]),
            (features[valid_idx], labels[valid_idx]),
        )
