"""Motion dataset with a preprocessing cache.

A copy of the JAX package's ``data/dataset.py``: six activity labels,
``seq_length``/``num_features`` from the array shape, and ``load()``
returning (train, validation, test) - from the ``X_*.npy``/``y_*.npy``
cache when all six files exist, else by preprocessing the raw text data
and writing the cache.  Arrays stay numpy; the trainer moves them to the
device.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from pytorch_distributed_rnn_tpu_torch.data.processor import MotionDataProcessor

log = logging.getLogger(__name__)


class MotionDataset:
    LABELS = [
        "WALKING",
        "WALKING_UPSTAIRS",
        "WALKING_DOWNSTAIRS",
        "SITTING",
        "STANDING",
        "LAYING",
    ]

    def __init__(self, features: np.ndarray, labels: np.ndarray):
        self.features = np.asarray(features, dtype=np.float32)
        self.labels = np.asarray(labels)
        self.seq_length = self.features.shape[1]
        self.num_features = self.features.shape[2]

    def __getitem__(self, index):
        return self.features[index], self.labels[index]

    def __len__(self):
        return len(self.features)

    # -- cache ---------------------------------------------------------------

    @classmethod
    def get_data_path(cls, base_path: Path, data_type: str):
        return base_path / f"X_{data_type}.npy", base_path / f"y_{data_type}.npy"

    @classmethod
    def processed_data_exists(cls, paths) -> bool:
        return all(Path(p).exists() for p in paths)

    @classmethod
    def load(
        cls,
        base_path,
        output_path=None,
        validation_fraction: float = 0.05,
        seed: int | None = None,
    ):
        """Return (train, validation, test) datasets, using the cache when
        complete, else preprocessing raw data and writing it."""
        base_path = Path(base_path)
        types = ["train", "validation", "test"]
        cached = []
        for data_type in types:
            feature_path, label_path = cls.get_data_path(base_path, data_type)
            if cls.processed_data_exists([feature_path, label_path]):
                cached.append(cls(np.load(feature_path), np.load(label_path)))

        if len(cached) == 3:
            log.info("Preprocessed data found. Skip preprocessing.")
            return cached

        if output_path is None:
            output_path = base_path
        output_path = Path(output_path)
        output_path.mkdir(parents=True, exist_ok=True)

        log.info("No processed data found. Preprocess raw data...")
        processor = MotionDataProcessor(seed=seed)
        splits = processor.process_data(base_path, validation_fraction)
        datasets = []
        for data_type, (features, labels) in zip(types, splits):
            np.save(output_path / f"X_{data_type}.npy", features)
            np.save(output_path / f"y_{data_type}.npy", labels)
            datasets.append(cls(features, labels))
        return datasets
