"""HAIL on PyTorch and CUDA: the port of the ``repro`` package.

Same layout as the JAX package: ``core/``, ``kernels/`` and ``obs/`` for
HAIL; ``configs/``, ``dist/``, ``models/``, ``train/`` and ``launch/`` for
LM serving.  The Pallas kernels of both paths are rewritten as
hand-written CUDA kernels for Hopper (``kernels/csrc/``).  Entry points
that create state take ``device=None`` (or ``--device``), meaning
``"cuda"``.
"""
