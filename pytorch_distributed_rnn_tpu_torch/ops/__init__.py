"""Numerics of the port: losses, initializers, RNN layers and the fused
LSTM and GRU kernels."""
