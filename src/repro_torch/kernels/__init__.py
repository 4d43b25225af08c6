"""Hand-written Hopper kernels of the port (CUDA C++ under ``*/csrc``),
each beside its plain PyTorch version.  Kernels are built by
:mod:`._build` at first use, never on import."""
