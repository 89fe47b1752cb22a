"""Tensor primitives of the filter: weights, OT geometry, CUDA kernels."""
