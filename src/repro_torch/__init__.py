"""PyTorch/CUDA port of the VRL-SGD system (``repro``), module for module.

Each module here has its JAX counterpart at the same path under
``src/repro/``; the JAX package is the reference the port is tested
against.  The port imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``repro`` — so it keeps its own copies of the framework-free
pieces it needs (configs, the synthetic data stream).

Hot-path update math runs in hand-written CUDA kernels for Hopper
(``kernels/csrc``), built at first use; every kernel has a plain PyTorch
version beside it (``kernels/torch_update``) that CPU tensors take.
"""
