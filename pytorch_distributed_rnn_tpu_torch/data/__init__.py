"""The numpy data layer: copies of the JAX package's modules with the
same semantics, so the port trains on identical batches."""

from pytorch_distributed_rnn_tpu_torch.data.dataset import MotionDataset
from pytorch_distributed_rnn_tpu_torch.data.loader import DataLoader
from pytorch_distributed_rnn_tpu_torch.data.processor import MotionDataProcessor
from pytorch_distributed_rnn_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_rnn_tpu_torch.data.synthetic import (
    generate_char_tokens,
    generate_har_arrays,
    write_synthetic_har_cache,
    write_synthetic_har_dataset,
)
from pytorch_distributed_rnn_tpu_torch.data.text import TextDataset

__all__ = [
    "DataLoader",
    "DistributedSampler",
    "MotionDataProcessor",
    "MotionDataset",
    "TextDataset",
    "generate_char_tokens",
    "generate_har_arrays",
    "write_synthetic_har_cache",
    "write_synthetic_har_dataset",
]
