"""PyTorch/CUDA port of ``pytorch_distributed_rnn_tpu``.

The JAX package beside it is the reference; this package imports
nothing of it (nor of JAX).  Its layers: ``ops`` (losses, initializers,
the RNN scan path, dense attention, and the hand-written CUDA kernels of
``ops/fused_rnn.py`` and ``ops/fused_attention.py`` built from ``csrc/``),
``models`` (motion classifier, char LM, attention classifier, the toy
MLP), ``data``, ``training`` (``local``, and the data-parallel
``distributed``, ``horovod`` and ``distributed-native``), ``parallel``
(process groups, collectives, the sharded update and its bucket plan, the
launcher of process-per-rank worlds), ``runtime`` (the C++ TCP ring of
``distributed-native``), ``examples`` (the reference's toy-model examples)
and the ``main`` CLI.  Entry points run on the CUDA card unless the caller
passes ``--device cpu``.
"""
