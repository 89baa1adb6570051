"""device_idle_pct: the share of the profiled slice's wall in which no
kernel ran on the device, in %."""


def read(ctx):
    if ctx.slice is None or not ctx.kernels or not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
