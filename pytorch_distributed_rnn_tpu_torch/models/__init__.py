from pytorch_distributed_rnn_tpu_torch.models.attention import AttentionClassifier
from pytorch_distributed_rnn_tpu_torch.models.attention_lm import AttentionLM
from pytorch_distributed_rnn_tpu_torch.models.char_rnn import CharRNN, char_rnn_50m, num_params
from pytorch_distributed_rnn_tpu_torch.models.motion import MotionModel
from pytorch_distributed_rnn_tpu_torch.models.toy import ToyModel

__all__ = ["AttentionClassifier", "AttentionLM", "CharRNN", "MotionModel", "ToyModel",
           "char_rnn_50m", "num_params"]
