"""PyTorch/CUDA port of the Focus system for one NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` (the reference), module by
module. Hand-written Hopper kernels live in ``hopper/``; every entry point
takes a ``device`` argument, defaulting to ``"cuda"``.
"""
