"""nets_roofline (%): the least time the card needs for the traced steps'
conv encoder and decoder over the device time of the operations launched
inside the program's spans around them (``nfdpf_torch::nets.encoder``,
``nets.decoder`` and their ``.bwd`` ranges; ``benchlib.spans``).

Least time: the frame part of ``benchlib.counts.step_model_ops`` (the
convolutions and the dense layers of both nets at B·T frames a step,
forward and backward, the first convolution's backward its weight gradient
alone) at the H100 SXM's dense TF32 tensor-core peak, the fastest the card
runs them (cuDNN may take the convolutions in TF32).  Nothing to read where
the program opens no such span or no device operation was traced."""

from benchlib import counts, spans

# NVIDIA H100 SXM data sheet: dense TF32 on the tensor cores, no sparsity
H100_TF32_OPS_PER_S = 494.7e12
LAYERS = ("nets.encoder", "nets.encoder.bwd", "nets.decoder", "nets.decoder.bwd")


def frame_ops(cfg) -> float:
    """Operations of one frame through both nets, forward and backward."""
    enc, dec = counts.conv_ops_per_frame(cfg.width)
    h = cfg.hidden_size
    dense = counts.mlp_ops((256 * 16, h)) + counts.mlp_ops((h, 256 * 16))
    return 3 * (enc + dec + dense) - counts.first_conv_ops(cfg.width)


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    device_ns = spans.device_ns_under(tr["events"], LAYERS)
    if not device_ns:
        return None
    frames = tr["steps"] * ctx["b"] * ctx["t"]
    least_s = frames * frame_ops(ctx["cfg"]) / H100_TF32_OPS_PER_S
    return 100.0 * least_s / (device_ns / 1e9)
