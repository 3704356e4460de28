"""PyTorch / CUDA port of trafficbots_tpu for NVIDIA Hopper (H100).

The JAX package `trafficbots_tpu` is the reference; this package mirrors its
layout (geometry, data/, models/, ops/, sim/, orchestration) and never
imports it or JAX. The TPU kernels on the ported path are hand-written CUDA
C++ under csrc/, built with nvcc at first use (ops/cuda_build.py).
"""
