"""route_arrivals_roofline: the arrival routing's share of its roofline
in the profiled slice: the bytes each step's routing needs
(``bytecount.route_arrivals_bytes``) over the HBM peak, over the device
time of the kernel that routes the arrivals, in %. Byte-bound."""
from portbench import bytecount

KERNEL = "route_arrivals_kernel"


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    dev_s = sum(b - a for a, b, n in ctx.kernels if KERNEL in n) * 1e-6
    if dev_s <= 0:
        return None
    need = sum(bytecount.route_arrivals_bytes(
        sl.world, t, sl.policy, sl.ring, sl.flow_path)
        for t in range(sl.start, sl.start + sl.steps))
    return 100.0 * need / ctx.peaks["hbm_bytes_per_s"] / dev_s
