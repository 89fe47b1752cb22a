"""device_idle_share (%): 1 − the union of the device operations' intervals
in the profiler's trace over the traced window's wall time."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
