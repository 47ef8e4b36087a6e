"""PyTorch/CUDA port of the stwo circle-STARK verifier.

Mirrors the layout of ``stark_symphony_tpu`` (``ops/``, ``models/stwo/``,
``utils/``) and its function names.  Plain tensor code is PyTorch; the
SHA-256, Merkle-node and Merkle-walk kernels and the tiled path's fused
stage-V and FRI kernels are CUDA C++ for Hopper (``csrc/``), built at
first use by ``ops/cuda/build.py``.  This package never imports JAX.
"""
