"""HAIL on PyTorch and CUDA: the port of the ``repro`` package.

Same layout as the JAX package (``core/``, ``kernels/``, ``obs/``), with the
Pallas kernels of the read and adaptive-build path rewritten as hand-written
CUDA kernels for Hopper (``kernels/csrc/``).  Entry points that create state
take ``device=None``, meaning ``"cuda"``.
"""
