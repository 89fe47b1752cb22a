"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes bindings,
plain PyTorch versions and the drivers built on them."""
