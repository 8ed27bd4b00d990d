"""Helpers of the Hydra front end's parity tests (tests/test_torch_hydra_*.py
and tests/test_torch_async_pipeline.py): the port's small CPU renderer and
the field-by-field comparison of two committed ScenePrimitives.  Imports
no JAX: JAX arrays reach it only as arguments."""
import numpy as np
import torch


def small_port_renderer():
    """The port's PBRRenderer on the CPU with small IBL maps and an 8 x 128
    tile raster config (the JAX package's delegate tests' sizes)."""
    from diligentfx_tpu_torch.config import (PBRRendererCreateInfo,
                                             RasterizerConfig)
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    return PBRRenderer(
        PBRRendererCreateInfo(brdf_lut_dim=16, num_brdf_samples=8,
                              irradiance_cube_dim=16,
                              prefiltered_env_map_dim=16,
                              num_specular_env_samples=8),
        raster_cfg=RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=256,
                                    max_tiles_per_tri=8, big_tri_capacity=16,
                                    chunk=8), device="cpu")


def _numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_scene(ts, js):
    """Every field of the port's committed ScenePrimitives equals the JAX
    delegate's, exactly (None where JAX's is None); the port's on the
    CPU."""
    for f in ts._fields:
        a, b = getattr(ts, f), getattr(js, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        if f == "materials":
            for g in a._fields:
                np.testing.assert_array_equal(_numpy(getattr(a, g)),
                                              _numpy(getattr(b, g)), g)
            continue
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(_numpy(a), _numpy(b), f)
