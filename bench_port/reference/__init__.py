"""The plain reference of the benchmark: the NF-DPF's train step in plain
PyTorch, float32, with no kernel, CUDA graph or library of the program.

It imports neither JAX nor the JAX package nor anything of ``nfdpf_torch``:
its modules are frozen copies of the port's plain versions, written again
where the port hands work to its kernels (``model.py``).
"""
