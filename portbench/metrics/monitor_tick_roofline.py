"""monitor_tick_roofline: the monitor tick's share of its roofline in the
profiled slice: the bytes the ticks need (``bytecount``) over the HBM
peak, over the device time of the kernel that runs the per-link monitor
tick, in %. Byte-bound: the tick does a few integer operations a byte."""
from portbench import bytecount

KERNEL = "monitor_tick_kernel"


def read(ctx):
    if ctx.slice is None:
        return None
    dev_s = sum(b - a for a, b, n in ctx.kernels if KERNEL in n) * 1e-6
    if dev_s <= 0:
        return None
    need = ctx.slice.steps * bytecount.monitor_tick_bytes(ctx.slice.num_links)
    return 100.0 * need / ctx.peaks["hbm_bytes_per_s"] / dev_s
