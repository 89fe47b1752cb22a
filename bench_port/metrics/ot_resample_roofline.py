"""ot_resample_roofline (%): the least time the card needs for the traced
steps' OT firings over the resampler layer's device time.

Least time: per firing, the larger of its operations at the float32 peak
and its bytes at the HBM bandwidth (``benchlib.counts.k3_ops_bytes`` at the
iterations that firing made, and the transport's backward where it had
one).  Device time: the device operations launched inside the harness's
spans around ``ot_resample_streaming`` and its backward
(``benchlib.trace``).  Nothing to read when no firing was traced."""

from benchlib import counts, trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["ot_calls"]:
        return None
    device_s = trace.span_device_ns(tr["events"], "ot_resample") / 1e9
    if device_s <= 0:
        return None
    least_ms = 0.0
    for call in tr["ot_calls"]:
        ops, nbytes = counts.k3_ops_bytes(call["b"], call["n"], call["iters"])
        if call["backward"]:
            bops, bbytes = counts.ot_backward_ops_bytes(call["b"], call["n"])
            ops, nbytes = ops + bops, nbytes + bbytes
        least_ms += counts.bound_ms(nbytes, ops)[0]
    return 100.0 * least_ms / 1e3 / device_s
