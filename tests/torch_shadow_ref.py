"""The JAX package's cascade and per-light shadow maps, their steps run op
by op, as the reference of the port's shadow passes in the CPU tests
(tests/test_torch_shadows.py, tests/test_torch_frame.py,
tests/test_torch_light_shadows.py, tests/test_torch_shadow_atlas.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.ops import raster as jr


def _maps_op_by_op(clips, indices, size, cfg):
    """Depth maps of the JAX two-pass raster (double-sided, setup, binning,
    the XLA tile scan) of each clip-space vertex array in `clips`, its
    steps run op by op: a jitted function contracts the plane evaluations
    into FMAs and may flip a shared-edge texel (and moves the depth of
    near-clipped triangles, whose coefficients are huge).  The setup and
    the scan run eagerly, the integer binning jitted.  The scan takes 64
    candidates a step instead of cfg.chunk: the winner (first minimum in
    candidate order) does not depend on the grouping, and op by op each
    step costs a fixed overhead.  Returns (N, size, size) numpy depth,
    1.0 where no caster."""
    ds = jnp.ones((indices.shape[0],), bool)
    maps = []
    for clip_fn in clips:
        with jax.disable_jit():
            setup, valid, bbox, _, _ = jr._triangle_setup(
                clip_fn(), indices, size, size, ds, True, 1e-3)
        cand = jax.jit(jr._bin_triangles, static_argnums=(2, 3, 4))(
            valid, bbox, size, size, cfg)[0]
        with jax.disable_jit():
            z, tid, _, _ = jr._raster_tiles(
                setup, cand, size, size, dataclasses.replace(cfg, chunk=64),
                float("inf"), True)
        maps.append(np.where(np.asarray(tid) >= 0,
                             np.clip(np.asarray(z), 0.0, 1.0), 1.0))
    return np.stack(maps)


def jax_cascade_maps_op_by_op(world_pos, indices, att, size, cfg):
    """render_cascade_shadow_maps of the JAX package, op by op
    (_maps_op_by_op)."""
    def clip(i):
        lv = jm3.transform_points(world_pos, att.world_to_light_view)[..., :3]
        p = lv * att.light_space_scale[i] + att.light_space_bias[i]
        return jnp.concatenate([p[..., :2], p[..., 2:3],
                                jnp.ones_like(p[..., :1])], -1)
    return _maps_op_by_op([lambda i=i: clip(i)
                           for i in range(att.num_cascades)], indices, size,
                          cfg)


def jax_light_maps_op_by_op(world_pos, indices, view_projs, size, cfg):
    """render_light_shadow_maps of the JAX package (one slice a
    view-projection), op by op (_maps_op_by_op)."""
    return _maps_op_by_op(
        [lambda i=i: jm3.transform_points(world_pos, view_projs[i])
         for i in range(view_projs.shape[0])], indices, size, cfg)
