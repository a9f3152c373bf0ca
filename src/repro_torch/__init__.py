"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package (``src/repro``) stays the reference; this package
imports nothing of it and never imports JAX.  Every TPU kernel on the
port's path is a CUDA C++ kernel written by hand for Hopper
(``csrc/``), each beside its plain PyTorch version
(``repro_torch.kernels``).  Entry points default to ``device="cuda"``
and raise without a CUDA device; ``device="cpu"`` runs the plain
versions.
"""
