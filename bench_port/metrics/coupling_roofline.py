"""coupling_roofline (%): the least time the card needs for the traced
steps' packed flow chains over the flows layer's device time.

Least time: per call, the larger of its operations at the float32 peak and
its bytes at the HBM bandwidth (``benchlib.counts.coupling_ops_bytes``:
``chain_ops`` + ``share_ops``, the backward three times the chain's
forward).  Device time: the device operations launched inside the
harness's spans around ``fused_coupling_chain`` and its backward
(``benchlib.trace``).  Nothing to read when no chain was traced."""

from benchlib import counts, trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["coupling_calls"]:
        return None
    device_s = trace.span_device_ns(tr["events"], "coupling") / 1e9
    if device_s <= 0:
        return None
    least_ms = 0.0
    for call in tr["coupling_calls"]:
        shape = (call["rows"], call["ctx_rows"], call["ctx_dim"], call["n_blocks"],
                 call["hidden"], call["max_in"])
        least_ms += counts.bound_ms(*reversed(counts.coupling_ops_bytes(*shape, False)))[0]
        if call["backward"]:
            least_ms += counts.bound_ms(*reversed(counts.coupling_ops_bytes(*shape, True)))[0]
    return 100.0 * least_ms / 1e3 / device_s
