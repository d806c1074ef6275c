"""Log messages with the machine-readable contracts of the JAX package's
``training/formatter.py``.

The perf line ``'{rank}: Memory Usage: {m}, Training Duration: {d}'`` is
regex-parsed downstream (the JAX package's ``evaluation/analysis.py``
``PERF_LINE_RE``), so it stays byte-compatible; the other messages keep
the same shapes so logs stay comparable.
"""

from __future__ import annotations


def _pct(current, overall) -> float:
    return 100.0 * (current / overall)


class TrainingMessageFormatter:
    def __init__(self, num_epochs: int, rank: int = 0):
        self.num_epochs = num_epochs
        self.rank = rank

    def epoch_start_message(self, epoch: int) -> str:
        return f"Rank: {self.rank:02d}   Start Epoch {epoch}"

    def train_progress_message(
        self, batch_idx, batches, training_examples, correct, loss
    ) -> str:
        batch_idx += 1
        return (
            f"Rank: {self.rank:02d}   "
            f"Train Batch: {batch_idx}/{batches} ({_pct(batch_idx, batches):.0f}%)\t"
            f"Loss: {loss:.6f}\t"
            f"Acc: {correct}/{training_examples} "
            f"({_pct(float(correct), training_examples):.0f}%)"
        )

    def evaluation_message(
        self, accuracy, examples, epoch, eval_loss, total_correct
    ) -> str:
        metrics = (
            f"Loss: {eval_loss:.4f}\t "
            f"Accuracy: {total_correct}/{examples} ({100.0 * accuracy:.0f}%)\n"
        )
        if epoch is None:
            prefix = "Test Evaluation:\t"
        else:
            epoch += 1
            prefix = (
                f"Evaluation Epoch: {epoch}/{self.num_epochs} "
                f"({_pct(epoch, self.num_epochs):.0f}%)\t"
            )
        return prefix + metrics

    def performance_message(self, memory, duration) -> str:
        # Parsed downstream by the JAX package's evaluation/analysis.py
        # PERF_LINE_RE - keep byte-compatible.  The values are RAW floats
        # (str() formatting); the parser accepts scientific ('5e-05') and
        # integer-valued ('700') renderings too.
        return f"{self.rank}: Memory Usage: {memory}, Training Duration: {duration}"
