"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions and
the counting wrappers the record readers call (``ops``)."""
