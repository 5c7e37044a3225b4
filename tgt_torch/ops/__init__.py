"""Layers and primitive ops (counterpart of tgt_tpu/ops). Hand-written CUDA
kernels and their plain versions live in ``ops/kernels``."""
