"""Hand-written CUDA kernels for Hopper (``csrc/``) with their wrappers.

``rk45`` (B1) and ``radau`` (B2) each launch their kernel for CUDA tensors
and run their plain PyTorch version for CPU tensors.  The modules are
imported lazily by the solvers; importing them builds nothing (``_build``
compiles the library at the first CUDA launch).
"""
