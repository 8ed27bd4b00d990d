"""K1's share of its roofline: the least time for a frame's G-buffer
raster (fxbench/yardstick.py k1_work, from the frame's pixels, channels
and visible triangles) over K1's device time a frame."""
from fxbench import yardstick

KERNEL = "raster_fused_kernel"


def read(t):
    ms = t.kernel_ms_per_frame(lambda n: KERNEL in n)
    if ms <= 0 or "k1" not in t.work:
        return None
    return yardstick.least_seconds(*t.work["k1"]) * 1e3 / ms * 100.0
