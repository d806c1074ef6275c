from pytorch_distributed_rnn_tpu_torch.models.motion import MotionModel

__all__ = ["MotionModel"]
