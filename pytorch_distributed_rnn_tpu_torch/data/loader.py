"""Minimal batch loader over array datasets: numpy index slices in the
sampler's order, the final partial batch included unless ``drop_last``.
A copy of the JAX package's ``data/loader.py``; the local trainer does
not use it (it gathers batches from device-resident arrays)."""

from __future__ import annotations

import numpy as np

from pytorch_distributed_rnn_tpu_torch.data.sampler import DistributedSampler


class DataLoader:
    def __init__(self, dataset, batch_size=None, sampler=None, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size if batch_size is not None else len(dataset)
        self.sampler = sampler
        self.drop_last = drop_last

    def __iter__(self):
        if self.sampler is not None:
            indices = np.asarray(self.sampler.indices())
        else:
            indices = np.arange(len(self.dataset))
        for start in range(0, len(indices), self.batch_size):
            batch_idx = indices[start : start + self.batch_size]
            if self.drop_last and len(batch_idx) < self.batch_size:
                return
            features, labels = self.dataset[batch_idx]
            yield features, labels

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)
