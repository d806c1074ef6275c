"""Numerics of the port: losses, initializers, RNN layers, the fused
LSTM and GRU kernels (``fused_rnn``), dense attention (``attention``) and
the flash-attention kernels (``fused_attention``)."""
