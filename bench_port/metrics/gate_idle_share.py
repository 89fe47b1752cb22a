"""gate_idle_share (%): the device's idle time in gaps that start while the
filter's ESS gate is open on the host (``nfdpf_torch::filter.gate``: the
effective sample size and its host read, one a time step), over the wall
time of the traced window that records the host.  A gap counts where the
span is open on the thread that launched the operation ending it
(``benchlib.spans``).  Nothing to read where the program opens no such span
or no device operation was traced."""

from benchlib import spans


def read(ctx):
    return spans.idle_share(ctx, ("filter.gate",))
