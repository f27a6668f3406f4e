"""PyTorch + CUDA port of spnerf_tpu for one NVIDIA H100 (sm_90a).

The JAX package ``spnerf_tpu`` stays the reference; this package imports
nothing of it (nor JAX). Public functions keep the reference's NHWC
layout. Every Pallas kernel on a ported path has a hand-written CUDA
counterpart under ``kernels/csrc``; on CPU tensors the kernels' plain
PyTorch versions run instead.
"""
