"""Tensor primitives of the filter: weights, flows, resamplers, CUDA kernels."""

from nfdpf_torch.ops.density import (
    cosine_distance,
    effective_sample_size,
    log_normal_density,
    normalize_log_weights,
    weighted_mean,
)
from nfdpf_torch.ops.resampling import soft_systematic_resample, systematic_indices
from nfdpf_torch.ops.sinkhorn import ot_resample, sinkhorn_transport

__all__ = [
    "cosine_distance",
    "effective_sample_size",
    "log_normal_density",
    "normalize_log_weights",
    "weighted_mean",
    "soft_systematic_resample",
    "systematic_indices",
    "ot_resample",
    "sinkhorn_transport",
]
