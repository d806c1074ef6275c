"""Prompt-length bucket policy (a copy of the JAX package's
``serving/buckets.py``).

A captured prefill graph replays one input shape, so serving pads every
prompt up to one of a FIXED set of lengths: after warm-up the engine
holds exactly ``len(prompt_buckets)`` prefill graphs and the decode
step's single graph, and no request mix can trigger another capture (the
no-capture-after-warm-up contract the engine asserts).

Pure Python/numpy - unit-testable without a device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_PROMPT_BUCKETS = (16, 32, 64, 128)

# the id every padded prompt position carries; any in-vocab id works
# (masked prefill never lets pad positions touch the decode state) but a
# fixed one keeps padded buffers reproducible across runs
PAD_TOKEN = 0


@dataclass(frozen=True)
class BucketSpec:
    """A sorted set of prompt-length buckets."""

    prompt_buckets: tuple[int, ...] = DEFAULT_PROMPT_BUCKETS

    def __post_init__(self):
        buckets = tuple(self.prompt_buckets)
        if not buckets:
            raise ValueError("at least one prompt bucket is required")
        if any(b < 1 for b in buckets):
            raise ValueError(f"bucket lengths must be >= 1: {buckets}")
        if sorted(set(buckets)) != list(buckets):
            raise ValueError(
                f"prompt buckets must be strictly increasing: {buckets}"
            )

    @classmethod
    def parse(cls, spec: str) -> "BucketSpec":
        """``"16,32,64"`` -> BucketSpec((16, 32, 64))."""
        try:
            buckets = tuple(
                int(part) for part in str(spec).split(",") if part.strip()
            )
        except ValueError as exc:
            raise ValueError(f"bad bucket spec {spec!r}: {exc}") from exc
        return cls(buckets)

    @property
    def max_prompt_len(self) -> int:
        return self.prompt_buckets[-1]

    def bucket_for(self, length: int) -> int:
        """The smallest bucket holding ``length`` prompt tokens; raises
        for empty prompts and prompts past the largest bucket (admission
        rejects those loudly instead of silently truncating)."""
        if length < 1:
            raise ValueError("prompts must hold at least one token")
        for bucket in self.prompt_buckets:
            if length <= bucket:
                return bucket
        raise ValueError(
            f"prompt of {length} tokens exceeds the largest bucket "
            f"{self.max_prompt_len}"
        )

    def pad(self, prompt) -> np.ndarray:
        """``prompt`` (list/array of ids) -> (1, bucket) int32 padded
        with :data:`PAD_TOKEN`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        bucket = self.bucket_for(len(prompt))
        out = np.full((1, bucket), PAD_TOKEN, np.int32)
        out[0, : len(prompt)] = prompt
        return out
