"""Numerics of the port: losses, initializers, RNN layers, the fused
LSTM and GRU kernels (``fused_rnn``), dense attention (``attention``),
the flash-attention kernels (``fused_attention``) and the optax Adam
update of the data-parallel strategies (``adam``)."""
