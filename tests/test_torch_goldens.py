"""The port renders the JAX package's goldens that no other port test
renders (tests/golden/generate.py): deferred_256.png and
full_chain_256.png (_chain_golden: the mini-Sponza scene, SSAO and SSR,
then TAA, bloom and DoF, the second of two frames) and mr_spheres_128.png
(render_mr_spheres_golden: the forward renderer).  Each scene is built the
way the generator builds it and carried over with convert.py, each
configuration is the generator's, and the port computes its own IBL maps
at the generator's sizes.  Only the port renders: the bound is
tests/test_golden.py's 40 dB against the 8-bit PNG.
"""
import os
import sys

import numpy as np
import pytest

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRMaterialBasicAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.gltf.primitives import uv_sphere
from diligentfx_tpu.hydrogent.task_manager import (FrameSettings,
                                                   TaskManagerCreateInfo)
from diligentfx_tpu.pbr.renderer import RenderInfo, build_scene
from diligentfx_tpu.postfx.ssr import SSRSettings
from diligentfx_tpu.utils.image import read_png
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.config import PBRRendererCreateInfo as PortCI
from diligentfx_tpu_torch.config import RasterizerConfig as PortCfg
from diligentfx_tpu_torch.hydrogent import task_manager as ttm
from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
from diligentfx_tpu_torch.utils.image import psnr
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _golden(name):
    return read_png(os.path.join(GOLDEN, name))[..., :3].astype(
        np.float64) / 255.0


def _generate():
    sys.path.insert(0, GOLDEN)
    import generate
    return generate


@pytest.mark.parametrize("full_chain", [False, True],
                         ids=["deferred_256", "full_chain_256"])
def test_chain_golden(full_chain):
    """generate.py _chain_golden: the deferred frame (SSAO and SSR at half
    resolution, 2 x 4 GTAO steps, 16 SSR intersections) and the full chain
    (+ TAA, bloom, DoF), two frames at 256 x 128; the second frame above
    40 dB against its golden."""
    gen = _generate()
    w, h = 256, 128
    ren = PBRRenderer(PortCI(brdf_lut_dim=32, num_brdf_samples=16,
                             irradiance_cube_dim=16,
                             prefiltered_env_map_dim=32,
                             num_specular_env_samples=16),
                      raster_cfg=cv.raster_config_from_jax(gen._small_cfg()),
                      device="cpu")
    ci = TaskManagerCreateInfo(
        enable_ssao=True, ssao_half_resolution=True, ssao_num_slices=2,
        ssao_num_steps=4, enable_ssr=True, ssr_half_resolution=True,
        enable_taa=full_chain, enable_bloom=full_chain,
        enable_dof=full_chain)
    tm = ttm.HnTaskManager(ren, cv.task_manager_ci_from_jax(ci))
    info = cv.render_info_from_jax(RenderInfo(
        camera=gen._small_cam([0.0, 2.0, 9.0], [0, 1, 0], w, h),
        lights=PBRLightAttribs.directional([-0.4, -1.0, -0.2], [4, 4, 4]),
        renderer_params=PBRRendererShaderParameters.create()))
    scene = cv.scene_from_jax(gen._mini_sponza())
    settings = cv.frame_settings_from_jax(
        FrameSettings(ssr=SSRSettings(max_traversal_intersections=16)))
    state = tm.initial_state(w, h)
    for _ in range(2):
        out = tm.execute(scene, info, state, width=w, height=h,
                         settings=settings)
        state = out.state
    color = out.color.numpy()
    assert np.isfinite(color).all()
    name = "full_chain_256.png" if full_chain else "deferred_256.png"
    p = psnr(np.clip(color, 0.0, 1.0), _golden(name))
    print(f"{name}: {p:.2f} dB")
    assert p > 40.0, p


def test_mr_spheres_golden():
    """generate.py render_mr_spheres_golden: three spheres of metallic 0,
    0.5 and 1 through the forward renderer at 128 x 128, above 40 dB
    against mr_spheres_128.png."""
    n = 128
    ren = PBRRenderer(PortCI(brdf_lut_dim=32, num_brdf_samples=32,
                             irradiance_cube_dim=32,
                             prefiltered_env_map_dim=32,
                             num_specular_env_samples=32),
                      raster_cfg=PortCfg(tile_h=8, tile_w=128,
                                         bin_capacity=512,
                                         max_tiles_per_tri=16,
                                         big_tri_capacity=16, chunk=8),
                      device="cpu")
    sphere = uv_sphere(0.45, stacks=16, slices=24)
    meshes = []
    for i in range(3):
        node = np.eye(4, dtype=np.float32)
        node[3, 0] = (i - 1) * 1.1
        meshes.append((sphere, node, PBRMaterialBasicAttribs.create(
            base_color_factor=(0.7, 0.2, 0.2, 1.0),
            metallic_factor=i * 0.5, roughness_factor=0.3)))
    eye = [0.0, 0.6, 3.2]
    info = RenderInfo(
        camera=CameraAttribs.create(jm3.look_at(eye, [0, 0, 0]),
                                    jm3.perspective(0.8, 1.0, 0.1, 20.0),
                                    eye, 0.1, 20.0, n, n),
        lights=PBRLightAttribs.directional([-0.4, -0.6, -0.8],
                                           [3.0, 3.0, 3.0]),
        renderer_params=PBRRendererShaderParameters.create())
    img = ren.render(cv.scene_from_jax(build_scene(meshes)),
                     cv.render_info_from_jax(info), width=n,
                     height=n).numpy()
    assert np.isfinite(img).all()
    p = psnr(np.clip(img, 0.0, 1.0), _golden("mr_spheres_128.png"))
    print(f"mr_spheres_128.png: {p:.2f} dB")
    assert p > 40.0, p
