"""Parity of the port's cascaded shadow maps
(diligentfx_tpu_torch.components.shadow_map_manager) with the JAX package on
the CPU (the forward renderer with shadows is held in
tests/test_torch_frame.py).

Inputs come from the csm_256 golden scene of tests/golden/generate.py (a
sphere on a ground plane, 2 cascades at 256^2) and from numpy seeds.
Tolerances and their causes:
  * distribute_cascades: 1e-5 (XLA's and PyTorch's pow and the order of
    the 4-term matrix products differ in the last bit; measured 5e-7);
  * cascade depth maps: coverage equal and depth within 1e-6 against the
    JAX raster run op by op (setup and the XLA tile scan eagerly, the
    integer binning jitted; the jitted function contracts plane
    evaluations into FMAs and may flip a shared-edge texel);
  * moments and blur: 1e-5 relative (EVSM's exp(40 z) amplifies an ulp of
    z forty-fold);
  * shadow sampling: 1e-5 for every mode against the JAX functions run
    eagerly, on the JAX package's own maps.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import PBRMaterialBasicAttribs
from diligentfx_tpu.components import shadow_map_manager as jsm
from diligentfx_tpu.config import ShadowMode
from diligentfx_tpu.gltf.primitives import plane, uv_sphere
from diligentfx_tpu.pbr.renderer import build_scene, transform_vertices
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.components import shadow_map_manager as tsm
from diligentfx_tpu_torch.config import ShadowMode as PortMode
from diligentfx_tpu_torch.ops.raster_tiles import raster_tiles
from tests.torch_shadow_ref import jax_cascade_maps_op_by_op
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
sys.path.insert(0, GOLDEN)
import generate as gen  # noqa: E402

W, H, S = 256, 128, 256
SUN = [-0.5, -1.0, -0.4]


def _t(x):
    return cv.tensor(x)


@pytest.fixture(scope="module")
def golden_scene():
    """The csm_256 golden's scene, camera and cascades (JAX package
    objects), as render_csm_golden builds them, with the cascade depth maps
    of the JAX raster run op by op (jax_cascade_maps_op_by_op)."""
    gn = np.eye(4, dtype=np.float32)
    gn[3, 1] = -1.0
    scene = build_scene([
        (uv_sphere(0.9, 24, 32), np.eye(4, dtype=np.float32),
         PBRMaterialBasicAttribs.create(base_color_factor=(0.7, 0.55, 0.35, 1),
                                        metallic_factor=0.6,
                                        roughness_factor=0.35)),
        (plane(20.0), gn, PBRMaterialBasicAttribs.create(
            base_color_factor=(0.45, 0.45, 0.5, 1.0), roughness_factor=0.7)),
    ])
    cam = gen._small_cam([0.0, 1.2, 4.0], [0, 0, 0], W, H)
    att = jsm.distribute_cascades(cam.view, jm3.inverse(cam.view),
                                  float(cam.proj[0, 0]), float(cam.proj[1, 1]),
                                  0.1, 100.0, SUN, num_cascades=2,
                                  shadow_map_size=S)
    wp, _, _ = transform_vertices(scene)
    g = dict(scene=scene, cam=cam, att=att, wp=wp)
    g["maps"] = jax_cascade_maps_op_by_op(wp, scene.indices, att, S,
                                          gen._small_cfg())
    return g


@pytest.mark.parametrize("case", ["csm_256", "bench_csm"])
def test_distribute_cascades_matches_jax(golden_scene, case):
    if case == "csm_256":
        cam, n, size, sun = golden_scene["cam"], 2, S, SUN
    else:        # bench.py --csm: the bench camera, 4 cascades at 2048^2
        eye = [0.0, 1.0, 7.5]
        from diligentfx_tpu.attribs import CameraAttribs
        cam = CameraAttribs.create(jm3.look_at(eye, [0.0, 0.0, 0.0]),
                                   jm3.perspective(0.7, 1920 / 1080, 0.1,
                                                   100.0),
                                   eye, 0.1, 100.0, 1920, 1080)
        n, size, sun = 4, 2048, [-0.5, -0.7, -0.5]
    args = (float(cam.proj[0, 0]), float(cam.proj[1, 1]), 0.1, 100.0, sun)
    a = jsm.distribute_cascades(cam.view, jm3.inverse(cam.view), *args,
                                num_cascades=n, shadow_map_size=size)
    b = tsm.distribute_cascades(_t(cam.view), _t(jm3.inverse(cam.view)),
                                *args, num_cascades=n, shadow_map_size=size)
    assert b.num_cascades == n
    for f in a._fields:
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


def test_render_cascade_shadow_maps_matches_jax(golden_scene):
    g = golden_scene
    before = raster_tiles.launches
    maps = tsm.render_cascade_shadow_maps(
        _t(g["wp"]), _t(g["scene"].indices), cv.shadow_attribs_from_jax(g["att"]),
        shadow_map_size=S, cfg=cv.raster_config_from_jax(gen._small_cfg()))
    assert raster_tiles.launches == before        # the CPU runs no kernel
    maps = maps.numpy()
    assert maps.shape == (2, S, S)
    ref = g["maps"]
    cover = ref < 1.0
    assert 0.3 < cover.mean() < 0.9
    np.testing.assert_array_equal(maps < 1.0, cover)
    np.testing.assert_allclose(maps, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["VSM", "EVSM2", "EVSM4", "VSM16"])
def test_convert_and_blur_match_jax(golden_scene, mode):
    maps = golden_scene["maps"]
    jmode = ShadowMode[mode.replace("16", "")]
    kw = dict(emulate_16bit=True) if mode == "VSM16" else {}
    a = jsm.gaussian_blur_separable(
        jsm.convert_to_filterable(jnp.asarray(maps), jmode, **kw))
    b = tsm.gaussian_blur_separable(
        tsm.convert_to_filterable(torch.from_numpy(maps), PortMode(int(jmode)),
                                  **kw))
    assert b.shape == a.shape == maps.shape + ((4,) if mode == "EVSM4"
                                               else (2,))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=0)


def _receivers(g):
    """World positions (H, W, 3) of receivers: the ground plane around the
    sphere's shadow and the sphere's top, plus noise (from a seed)."""
    rng = np.random.default_rng(7)
    x = np.linspace(-1.5, 2.5, W, dtype=np.float32)
    z = np.linspace(-1.5, 2.5, H, dtype=np.float32)
    xx, zz = np.meshgrid(x, z)
    pos = np.stack([xx, np.full_like(xx, -1.0), zz], -1)
    r = np.sqrt(xx ** 2 + (zz + 1.0) ** 2)
    on_sphere = r < 0.9
    pos[..., 1] = np.where(on_sphere,
                           np.sqrt(np.maximum(0.81 - r ** 2, 0.0)), -1.0)
    pos = pos + rng.normal(0.0, 1e-3, pos.shape).astype(np.float32)
    view = np.asarray(g["cam"].view)
    cam_z = -(pos @ view[:3, :3] + view[3, :3])[..., 2]
    return pos.astype(np.float32), cam_z.astype(np.float32)


@pytest.mark.parametrize("mode", ["PCF", "VSM", "EVSM2", "EVSM4"])
def test_sample_cascaded_shadows_matches_jax(golden_scene, mode):
    g = golden_scene
    jmode = ShadowMode[mode]
    pos, cam_z = _receivers(g)
    maps = g["maps"]
    mom = (None if jmode == ShadowMode.PCF else np.asarray(
        jsm.gaussian_blur_separable(jsm.convert_to_filterable(
            jnp.asarray(maps), jmode))))
    with jax.disable_jit():
        a = np.asarray(jsm.sample_cascaded_shadows(
            jnp.asarray(pos), jnp.asarray(cam_z), g["att"], jnp.asarray(maps),
            mode=jmode, moments=None if mom is None else jnp.asarray(mom)))
    b = tsm.sample_cascaded_shadows(
        torch.from_numpy(pos), torch.from_numpy(cam_z),
        cv.shadow_attribs_from_jax(g["att"]), torch.from_numpy(maps),
        mode=PortMode(int(jmode)),
        moments=None if mom is None else torch.from_numpy(mom)).numpy()
    assert b.shape == (H, W) and np.isfinite(b).all()
    assert 0.05 < (b < 0.5).mean() < 0.95      # shadowed and lit receivers
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
