"""host_syncs_per_step (syncs/step): the synchronising CUDA calls that
``torch.cuda.set_sync_debug_mode("warn")`` reports over one train step taken
after the window.  They include the ESS gate's read at every time step, the
trainer's two ``.item()`` reads and the streaming Sinkhorn loop's reads of
its stop flag (which the port's ``STREAMING_LOOP`` counter also counts)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.get("syncs") is None:
        return None
    return float(tr["syncs"])
