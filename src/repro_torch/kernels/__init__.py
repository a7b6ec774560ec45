"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their plain
PyTorch versions, one package per kernel family as in ``repro.kernels``."""
