"""Hopper kernels (CUDA C++ for sm_90a), their build, wrappers and plain versions."""
