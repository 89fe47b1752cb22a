"""The harness of the port's benchmark: what ``bench_port/run.py`` runs.

Nothing here imports JAX or the JAX package; the program under test is
``nfdpf_torch``, imported only inside the functions that drive it.
"""
