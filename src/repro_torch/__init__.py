"""PyTorch/CUDA port of the TNNGen functional simulator.

Mirrors the layout and names of the JAX package ``repro`` module for
module; plain tensor code is PyTorch, and each Pallas kernel of the
JAX package becomes a CUDA C++ kernel for Hopper (``kernels/csrc``) with
a plain PyTorch version beside it.  Entry points run on ``cuda`` unless
the caller passes ``device='cpu'``.
"""
