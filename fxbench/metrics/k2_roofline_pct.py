"""K2's share of its roofline, summed over a frame's bounded warps: the
least time for their work (fxbench/yardstick.py k2_work, from each warp's
image shape) over K2's device time a frame."""
from fxbench import yardstick

KERNELS = ("warp_tap_vec", "warp_tap_elem")


def read(t):
    ms = t.kernel_ms_per_frame(lambda n: any(k in n for k in KERNELS))
    if ms <= 0 or not t.work.get("k2", (0, 0))[0]:
        return None
    return yardstick.least_seconds(*t.work["k2"]) * 1e3 / ms * 100.0
