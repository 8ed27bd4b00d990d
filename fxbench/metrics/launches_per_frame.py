"""Kernel launches a frame: the profiler's kernel rows in the traced
window over its frames."""


def read(t):
    n = len(t.kernels())
    return n / t.frames if n else None
