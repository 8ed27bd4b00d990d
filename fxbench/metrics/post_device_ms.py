"""Device ms a frame of the kernels launched inside the port's
dfx.context_composite and dfx.taa_bloom_tonemap ranges (postfx/; they hold
dfx.ssao and dfx.ssr), over the traced stretch."""


def read(t):
    return t.range_device_ms_per_frame(("dfx.context_composite",
                                        "dfx.taa_bloom_tonemap"))
