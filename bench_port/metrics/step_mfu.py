"""step_mfu (%): the train step's model operations over the window's time at
the card's float32 peak.

Operations from shapes (``benchlib.counts.step_model_ops``): the conv encoder
and decoder with their dense layers, the particle encoder, the CRNVP
measurement's nets and the flows' chains, forward and backward, and the
Sinkhorn work of the iterations the window's firings made (the port's
``STREAMING_LOOP`` counter, with each firing's transport backward).  The
time is the untraced window's: all its steps and all its wall time.
"""

from benchlib import counts


def read(ctx):
    w = ctx["window"]
    if w["steps"] == 0 or w["seconds"] <= 0:
        return None
    ops = (w["steps"] * counts.step_model_ops(ctx["cfg"], ctx["b"], ctx["n"], ctx["t"])
           + counts.sinkhorn_ops(ctx["b"], ctx["n"], w["streaming"]["calls"],
                                 w["streaming"]["iters"]))
    return 100.0 * ops / (w["seconds"] * counts.H100_FP32_OPS_PER_S)
