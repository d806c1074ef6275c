"""Bucket plan for overlapped gradient communication on the native ring.

The sharded weight update (``parallel/sharded_update.py``) moves one
monolithic reduce-scatter (gradients) and one monolithic allgather
(fresh params) per step; the host sits blocked for the full wire time
of each.  Bucketing splits that traffic into ``--bucket-mb``-bounded
pieces so bucket k's optimizer apply can run while bucket k+1's
reduce-scatter is still on the wire (the DDP ``bucket_cap_mb`` reducer
idea, SURVEY.md `trainer/ddp.py:19`, on top of 2004.13336's sharding).

Layout - the part that makes bucketing BITWISE-identical to the
monolithic path: buckets partition each rank's monolithic shard range
``[0, shard)`` into contiguous sub-ranges ``[lo, hi)``, NOT the flat
padded vector.  Bucket b's wire vector is the concatenation over ranks
of ``padded[r*shard+lo : r*shard+hi]``, so ring chunk r of the bucket
is exactly rank r's sub-slice.  The ring's per-chunk accumulation
sequence starts at the chunk's own index, which therefore matches the
monolithic reduce-scatter chunk-for-chunk: every element is summed in
the identical rank order and association, and each bucket's output is
the bitwise-equal sub-slice of the monolithic ``g_shard``.  (A naive
contiguous split of the padded vector would reassign elements to
different chunk indices and change the f32 summation order.)

This module is the JAX package's ``parallel/bucketing.py`` unchanged
(pure stdlib), so the port plans the same buckets as the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

# DDP's bucket_cap_mb default: the reference reducer packs gradients
# into 25 MB buckets before allreducing them during backward
DEFAULT_BUCKET_MB = 25.0


@dataclass(frozen=True)
class BucketPlan:
    """Immutable bucket layout for one (size, world, wire-itemsize,
    bucket_mb) binding.

    ``bounds`` are ``[lo, hi)`` sub-ranges of the PER-RANK shard range
    ``[0, shard)``; every bucket's wire vector holds ``(hi-lo) * world``
    elements, so each bucket's total wire size (not its per-rank slice)
    is what ``bucket_mb`` caps - the same accounting as DDP's
    ``bucket_cap_mb``.
    """

    size: int        # raveled (unpadded) parameter count
    world: int
    itemsize: int    # wire dtype bytes/element
    bucket_mb: float
    shard: int       # per-rank elements, ceil(size / world)
    padded: int      # shard * world
    bounds: tuple[tuple[int, int], ...]

    @property
    def num_buckets(self) -> int:
        return len(self.bounds)

    def bucket_len(self, b: int) -> int:
        lo, hi = self.bounds[b]
        return hi - lo

    def rs_bytes(self, b: int) -> int:
        """Bucket b's reduce-scatter wire-vector bytes."""
        return self.bucket_len(b) * self.world * self.itemsize

    def ag_bytes(self, b: int) -> int:
        """Bucket b's allgather per-rank contribution bytes."""
        return self.bucket_len(b) * self.itemsize

    @property
    def monolithic_rs_bytes(self) -> int:
        """The un-bucketed reduce-scatter's wire-vector bytes; the
        per-bucket ``rs_bytes`` MUST sum to exactly this (the collective
        gate's relational invariant: overlap must not change traffic)."""
        return self.padded * self.itemsize

    @property
    def monolithic_ag_bytes(self) -> int:
        """The un-bucketed allgather's per-rank contribution bytes; the
        per-bucket ``ag_bytes`` MUST sum to exactly this."""
        return self.shard * self.itemsize

    def wire_expectations(self) -> dict:
        """The ``native_wire`` section of
        ``lint/collective_expectations.json``: enough config to replay
        the plan plus the per-bucket and monolithic byte counts the gate
        cross-checks."""
        return {
            "config": {
                "size": self.size,
                "world": self.world,
                "itemsize": self.itemsize,
                "bucket_mb": self.bucket_mb,
            },
            "monolithic": {
                "reduce_scatter_bytes": self.monolithic_rs_bytes,
                "allgather_bytes": self.monolithic_ag_bytes,
            },
            "buckets": [
                {
                    "reduce_scatter_bytes": self.rs_bytes(b),
                    "allgather_bytes": self.ag_bytes(b),
                }
                for b in range(self.num_buckets)
            ],
        }


def plan_buckets(
    size: int,
    world: int,
    itemsize: int,
    bucket_mb: float = DEFAULT_BUCKET_MB,
) -> BucketPlan:
    """Split the per-rank shard range into contiguous buckets whose
    total wire size (``len * world * itemsize``) stays under
    ``bucket_mb`` (at least one element per rank per bucket, so a tiny
    cap degenerates to 1-element buckets, never zero buckets)."""
    if size <= 0:
        raise ValueError(f"plan_buckets needs size > 0, got {size}")
    if world <= 0:
        raise ValueError(f"plan_buckets needs world > 0, got {world}")
    if itemsize <= 0:
        raise ValueError(f"plan_buckets needs itemsize > 0, got {itemsize}")
    if bucket_mb <= 0:
        raise ValueError(
            f"plan_buckets needs bucket_mb > 0, got {bucket_mb} "
            "(use --no-bucketed-comm to disable bucketing)"
        )
    shard = -(-size // world)  # ceil
    padded = shard * world
    cap_bytes = float(bucket_mb) * (1 << 20)
    per_rank_len = max(1, int(cap_bytes // (itemsize * world)))
    bounds = []
    lo = 0
    while lo < shard:
        hi = min(shard, lo + per_rank_len)
        bounds.append((lo, hi))
        lo = hi
    return BucketPlan(
        size=int(size),
        world=int(world),
        itemsize=int(itemsize),
        bucket_mb=float(bucket_mb),
        shard=shard,
        padded=padded,
        bounds=tuple(bounds),
    )
