"""Distributed sampler: epoch-seeded shuffle, pad-to-divisible, rank shard.

A copy of the JAX package's ``data/sampler.py`` with the same semantics
as ``torch.utils.data.DistributedSampler``: every rank sees a disjoint
1/world_size shard of a permutation drawn from ``RandomState(seed +
epoch)``, padded by repeating leading samples so the total divides
evenly, and ``set_epoch`` reseeds the shuffle.  The shard is rank-strided
(``indices[rank::world]``).  Keeping numpy's generator (not torch's) is
what makes the port's batches identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np


class DistributedSampler:
    def __init__(
        self,
        dataset_size,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
    ):
        if hasattr(dataset_size, "__len__"):
            dataset_size = len(dataset_size)
        if rank >= num_replicas or rank < 0:
            raise ValueError(f"invalid rank {rank} for world size {num_replicas}")
        self.dataset_size = int(dataset_size)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-self.dataset_size // num_replicas)  # ceil
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        """This rank's sample indices for the current epoch."""
        return self.global_indices()[self.rank]

    def global_indices(self) -> np.ndarray:
        """All ranks' shards as one (num_replicas, num_samples) matrix
        (row r == the ``indices()`` a rank-r sampler would produce).  Used
        by the single-controller SPMD trainers to assemble rank-major
        global batches."""
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(self.dataset_size)
        else:
            order = np.arange(self.dataset_size)
        padding = self.total_size - self.dataset_size
        if padding > 0:
            # torch semantics: repeat the permutation as often as needed
            # (covers datasets smaller than the replica count)
            reps = -(-padding // len(order))
            order = np.concatenate([order, np.tile(order, reps)[:padding]])
        return order.reshape(self.num_samples, self.num_replicas).T

    def __iter__(self):
        return iter(self.indices())

    def __len__(self):
        return self.num_samples
