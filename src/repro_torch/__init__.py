"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper GPUs.

The layout mirrors ``src/repro/``: ``configs/``, ``core/``, ``kernels/``
(hand-written CUDA C++ under ``kernels/csrc/`` with a plain PyTorch version
of each kernel in ``ref.py``), ``models/``, ``serve/`` and ``launch/``.
The package imports ``torch`` and never ``jax``; the JAX package is the
reference the tests hold it against.
"""
