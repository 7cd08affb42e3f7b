"""repro_torch — the PyTorch/CUDA port of the CHL system.

The package mirrors the reference JAX package ``repro`` module for
module (``graphs``, ``sssp``, ``core``, ``kernels``, ``engine``,
``index``, ``serve``) and imports nothing from it. Entry points run on
the CUDA card by default and raise without one; pass ``device="cpu"``
to run the plain PyTorch path. The hand-written kernels (CUDA C++ for
sm_90a, under ``kernels/*/csrc``) compile on first use.
"""
