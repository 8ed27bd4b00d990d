"""The JAX package's cascade shadow maps, its steps run op by op, as the
reference of the port's shadow pass in the CPU tests
(tests/test_torch_shadows.py, tests/test_torch_frame.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.ops import raster as jr


def jax_cascade_maps_op_by_op(world_pos, indices, att, size, cfg):
    """render_cascade_shadow_maps of the JAX package (double-sided
    rasterize(backend="xla") = setup, binning, the XLA tile scan), its
    steps run op by op: a jitted function contracts the plane evaluations
    into FMAs and may flip a shared-edge texel.  The setup and the scan
    run eagerly, the integer binning jitted.  The scan takes 64 candidates
    a step instead of cfg.chunk: the winner (first minimum in candidate
    order) does not depend on the grouping, and op by op each step costs a
    fixed overhead.  Returns (C, size, size) numpy depth, 1.0 where no
    caster."""
    ds = jnp.ones((indices.shape[0],), bool)
    maps = []
    for i in range(att.num_cascades):
        with jax.disable_jit():
            lv = jm3.transform_points(world_pos,
                                      att.world_to_light_view)[..., :3]
            p = lv * att.light_space_scale[i] + att.light_space_bias[i]
            clip = jnp.concatenate([p[..., :2], p[..., 2:3],
                                    jnp.ones_like(p[..., :1])], -1)
            setup, valid, bbox, _, _ = jr._triangle_setup(
                clip, indices, size, size, ds, True, 1e-3)
        cand = jax.jit(jr._bin_triangles, static_argnums=(2, 3, 4))(
            valid, bbox, size, size, cfg)[0]
        with jax.disable_jit():
            z, tid, _, _ = jr._raster_tiles(
                setup, cand, size, size, dataclasses.replace(cfg, chunk=64),
                float("inf"), True)
        maps.append(np.where(np.asarray(tid) >= 0,
                             np.clip(np.asarray(z), 0.0, 1.0), 1.0))
    return np.stack(maps)
