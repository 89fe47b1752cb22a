"""nfdpf_torch — the PyTorch/CUDA port of the NF-DPF framework.

A second package beside the JAX one (``nfdpf_tpu``), held to it module by
module.  The hot kernels are written by hand for NVIDIA Hopper
(``nfdpf_torch/ops/cuda``); everything around them is plain PyTorch.
Importing the package loads the config only.
"""

from nfdpf_torch.config import DPFConfig, parse_args

__version__ = "0.1.0"

__all__ = ["DPFConfig", "parse_args", "__version__"]
