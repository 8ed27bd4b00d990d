"""The share of the traced window that the union of the device's
intervals (kernels, copies, sets) leaves uncovered."""


def read(t):
    lo, hi = t.window
    if hi <= lo:
        return None
    return (1.0 - t.busy_us() / (hi - lo)) * 100.0
