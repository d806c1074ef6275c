"""Token-window dataset for the char-LM family.

A copy of the JAX package's ``data/text.py``.  A corpus (any bytes file)
is tokenized at the byte level and cut into non-overlapping
``(seq_length + 1)``-token windows: the ``+1`` carries the final target so
the LM loss can shift inside the window (``tokens[:, :-1] ->
tokens[:, 1:]``).  Without a corpus file the loader generates the
synthetic motif stream (``data/synthetic.py:generate_char_tokens``) and,
when a path was given, says so loudly.

The dataset has the ``features`` / ``labels`` / ``__len__`` surface the
sampler and the trainer consume; ``labels`` are dummy zeros (the LM
derives its targets from the window itself).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from pytorch_distributed_rnn_tpu_torch.data.synthetic import generate_char_tokens

log = logging.getLogger(__name__)

VOCAB_SIZE = 256  # byte-level


class TextDataset:
    """``features``: (N, seq_length + 1) int32 token windows."""

    def __init__(self, windows: np.ndarray):
        windows = np.asarray(windows)
        if windows.ndim != 2 or windows.shape[1] < 2:
            raise ValueError(
                f"windows must be (N, seq_length + 1 >= 2), got {windows.shape}"
            )
        self.features = windows.astype(np.int32)
        self.labels = np.zeros(len(windows), np.int32)  # sampler/trainer compat
        self.seq_length = self.features.shape[1] - 1
        self.vocab_size = VOCAB_SIZE

    def __getitem__(self, index):
        return self.features[index], self.labels[index]

    def __len__(self):
        return len(self.features)

    @classmethod
    def resolve_corpus(cls, dataset_path):
        """The corpus a path names: the file itself, or ``corpus.txt``
        under a directory; ``None`` when ``dataset_path`` is None or holds
        neither."""
        if dataset_path is None:
            return None
        path = Path(dataset_path)
        if path.is_file():
            return path
        if (path / "corpus.txt").is_file():
            return path / "corpus.txt"
        return None

    @classmethod
    def load(
        cls,
        dataset_path,
        seq_length: int = 128,
        validation_fraction: float = 0.05,
        test_fraction: float = 0.1,
        seed: int | None = None,
        synthetic_sequences: int = 2048,
    ):
        """(train, validation, test) token-window datasets.

        ``dataset_path`` may be a bytes/text file, or a directory holding
        ``corpus.txt``; otherwise the synthetic motif stream is generated
        (deterministic in ``seed``).  Windows are shuffled with ``seed``
        before the split, so the three sets are i.i.d. slices of the
        corpus."""
        corpus_file = cls.resolve_corpus(dataset_path)
        if corpus_file is None and dataset_path is not None:
            # a given path that names no corpus must not train on
            # synthetic data silently (a mistyped path would look like a
            # real run); not an error, since the generic data directory
            # with no corpus.txt is the normal synthetic-LM case
            log.warning(
                "--dataset-path %s holds no corpus (no such file / no "
                "corpus.txt under it) - training on the SYNTHETIC motif "
                "corpus instead", dataset_path,
            )

        if corpus_file is not None:
            data = np.frombuffer(corpus_file.read_bytes(), dtype=np.uint8)
            num_windows = len(data) // (seq_length + 1)
            if num_windows < 3:
                raise ValueError(
                    f"{corpus_file} holds {len(data)} bytes - too short for "
                    f"3 windows of {seq_length + 1}"
                )
            windows = (
                data[: num_windows * (seq_length + 1)]
                .reshape(num_windows, seq_length + 1)
                .astype(np.int32)
            )
        else:
            windows = generate_char_tokens(
                synthetic_sequences, seq_length, VOCAB_SIZE, seed=seed or 0
            )

        rng = np.random.RandomState(seed if seed is not None else 0)
        windows = windows[rng.permutation(len(windows))]

        n = len(windows)
        n_test = max(1, int(n * test_fraction))
        n_valid = max(1, int(n * validation_fraction))
        test = cls(windows[:n_test])
        valid = cls(windows[n_test : n_test + n_valid])
        train = cls(windows[n_test + n_valid :])
        return train, valid, test
