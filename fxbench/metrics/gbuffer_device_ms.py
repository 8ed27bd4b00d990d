"""Device ms a frame of the kernels launched inside the port's dfx.gbuffer
range (pbr/deferred.py, ops/raster.py), over the traced stretch."""


def read(t):
    return t.range_device_ms_per_frame(("dfx.gbuffer",))
