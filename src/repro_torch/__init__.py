"""HAIL on PyTorch and CUDA: the port of the ``repro`` package.

Same layout as the JAX package: ``core/``, ``kernels/`` and ``obs/`` for
HAIL; ``configs/``, ``dist/``, ``models/``, ``train/``, ``ckpt/`` and
``launch/`` for LM serving and training.  The Pallas kernels of both paths
are rewritten as hand-written CUDA kernels for Hopper (``kernels/csrc/``),
and the training path adds backward kernels for flash attention and the
Mamba1 scan.  Entry points
that create state take ``device=None`` (or ``--device``), meaning
``"cuda"``.
"""
