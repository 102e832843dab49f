"""Kernels of the port and their plain PyTorch versions (counterpart of
``rocket_tpu.ops``): CUDA sources under ``csrc/``, built by ``_build``."""
