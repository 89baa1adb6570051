"""kernels_per_step: device kernels a step in the profiled slice."""


def read(ctx):
    if ctx.slice is None or not ctx.kernels:
        return None
    return len(ctx.kernels) / ctx.slice.steps
