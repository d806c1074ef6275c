from pytorch_distributed_rnn_tpu_torch.models.char_rnn import CharRNN, char_rnn_50m, num_params
from pytorch_distributed_rnn_tpu_torch.models.motion import MotionModel

__all__ = ["CharRNN", "MotionModel", "char_rnn_50m", "num_params"]
