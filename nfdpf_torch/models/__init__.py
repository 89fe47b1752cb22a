"""Networks, dynamics and measurement models, and the filter engine."""

from nfdpf_torch.models.nets import (
    LikelihoodNet,
    ObservationDecoder,
    ObservationEncoder,
    ParticleEncoder,
    TransitionMLP,
)
from nfdpf_torch.models.measurement import build_measurement_model
from nfdpf_torch.models.dpf import DPF, FilterOutput  # last: dpf imports the modules above

__all__ = [
    "ObservationEncoder",
    "ObservationDecoder",
    "ParticleEncoder",
    "LikelihoodNet",
    "TransitionMLP",
    "build_measurement_model",
    "DPF",
    "FilterOutput",
]
