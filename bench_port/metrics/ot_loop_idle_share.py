"""ot_loop_idle_share (%): the device's idle time in gaps that start while
the program's Sinkhorn loop is open on the host (``nfdpf_torch::ot.loop``:
the loop's graph replays and the host reads of its stop flag), over the
wall time of the traced window that records the host.  A gap counts where
the span is open on the thread that launched the operation ending it
(``benchlib.spans``).  Nothing to read where the program opens no such
span or no device operation was traced."""

from benchlib import spans


def read(ctx):
    return spans.idle_share(ctx, ("ot.loop",))
