"""Transparency through the port's task graph against the JAX package's,
on the CPU: two `HnTaskManager.execute` frames of the mixed glTF scene of
tests/test_torch_gltf.py (a lattice of ALPHA_MODE_MASK, three glass panes
of ALPHA_MODE_BLEND over a ground and a quad) with SSAO, SSR, TAA and bloom
on, the camera moving between the frames.  Each package loads the file,
builds its scene and renders its own whole frames: the G-buffer takes the
two-pass path with the alpha-mask resolve, OIT the K-layer raster with
K = 2, so the three panes overflow into the tail.  The frames are
untextured (no atlas: the material factors alone, the lattice's alpha 1
passing its cutoff): the textured G-buffer and alpha test are held
against JAX by tests/test_torch_alpha_mask.py and tests/test_torch_oit.py,
and compiling the textured JAX frame takes about 90 s more of one core.

Tolerance: the JAX frame is one compiled program, whose contracted
multiply-adds flip a few coverage tests at triangle edges and move values
by ulps, which SSAO, SSR and TAA then spread; the final sRGB colours are
held above 70 dB (measured 124.5 and 97.5 dB for the two frames).
"""
import numpy as np
import pytest

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.config import PBRRendererCreateInfo, RasterizerConfig
from diligentfx_tpu.gltf import loader as jloader
from diligentfx_tpu.gltf import model as jmodel
from diligentfx_tpu.hydrogent import task_manager as jtm
from diligentfx_tpu.pbr.renderer import PBRRenderer, RenderInfo
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.config import PBRRendererCreateInfo as PortCI
from diligentfx_tpu_torch.gltf import loader as tloader
from diligentfx_tpu_torch.gltf import model as tmodel
from diligentfx_tpu_torch.hydrogent import task_manager as ttm
from diligentfx_tpu_torch.pbr.renderer import PBRRenderer as PortRenderer
from diligentfx_tpu_torch.utils.image import psnr
from tests.test_torch_gltf import mixed_scene
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 256, 128
FRAMES = 2
CFG = RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=256,
                       max_tiles_per_tri=16, big_tri_capacity=32, chunk=8)
CI = PBRRendererCreateInfo(brdf_lut_dim=16, num_brdf_samples=8,
                           irradiance_cube_dim=16, prefiltered_env_map_dim=16,
                           num_specular_env_samples=8)
CHAIN = jtm.TaskManagerCreateInfo(
    enable_ssao=True, ssao_half_resolution=True, ssao_num_slices=2,
    ssao_num_steps=4, enable_ssr=True, ssr_half_resolution=True,
    enable_taa=True, enable_bloom=True, oit_layer_count=2)


def _info(i):
    eye = [0.2 + 0.05 * i, 0.1, 1.0]
    cam = CameraAttribs.create(jm3.look_at(eye, [0.2, 0.0, -2.5]),
                               jm3.perspective(0.9, W / H, 0.1, 20.0), eye,
                               0.1, 20.0, W, H)
    return RenderInfo(
        camera=cam,
        lights=PBRLightAttribs.concat([
            PBRLightAttribs.directional([-0.3, -1.0, -0.5], [3, 3, 3]),
            PBRLightAttribs.point([0.5, 1.0, -1.0], [4, 3, 2], range=10.0)]),
        renderer_params=PBRRendererShaderParameters.create())


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = mixed_scene(str(tmp_path_factory.mktemp("oit") / "mixed.gltf"))
    rs = jmodel.build_render_scene(jloader.load_gltf(path))
    prs = tmodel.build_render_scene(tloader.load_gltf(path), device="cpu")
    ren = PBRRenderer(CI, raster_cfg=CFG)
    jtask = jtm.HnTaskManager(ren, CHAIN)
    port = PortRenderer(PortCI(), raster_cfg=cv.raster_config_from_jax(CFG),
                        device="cpu", env_oct=cv.tensor(ren.env_oct),
                        ibl_maps=cv.ibl_maps_from_jax(ren.ibl_maps))
    ptask = ttm.HnTaskManager(port, cv.task_manager_ci_from_jax(CHAIN))
    jstate, pstate = jtask.initial_state(W, H), ptask.initial_state(W, H)
    out = []
    for i in range(FRAMES):
        jo = jtask.execute(rs.scene, _info(i), jstate, width=W, height=H)
        po = ptask.execute(prs.scene, cv.render_info_from_jax(_info(i)),
                           pstate, width=W, height=H)
        jstate, pstate = jo.state, po.state
        out.append((np.asarray(jo.color), po.color.numpy()))
    return out, prs, ptask


@pytest.mark.parametrize("frame", range(FRAMES))
def test_oit_frame_matches_jax(frames, frame):
    a, b = frames[0][frame]
    assert b.shape == a.shape == (H, W, 3)
    assert np.isfinite(b).all() and 0.0 <= b.min() <= b.max() <= 1.0
    assert psnr(a, b) > 70.0, psnr(a, b)


def test_oit_layers_change_the_frame(frames):
    """The panes composite over the opaque frame: without OIT
    (oit_layer_count 0, the blend geometry skipped as in the JAX package)
    the frame differs where the panes are; the K = 2 layers overflow."""
    _, prs, ptask = frames
    import dataclasses
    from diligentfx_tpu_torch.pbr import oit
    ci0 = dataclasses.replace(ptask.ci, oit_layer_count=0)
    plain = ttm.HnTaskManager(ptask.renderer, ci0)
    info = cv.render_info_from_jax(_info(0))
    with_oit = ptask.execute(prs.scene, info, ptask.initial_state(W, H),
                             width=W, height=H).color.numpy()
    without = plain.execute(prs.scene, info, plain.initial_state(W, H),
                            width=W, height=H).color.numpy()
    changed = np.abs(with_oit - without).max(-1) > 1e-3
    assert 0.1 < changed.mean() < 0.9, changed.mean()
    begin = ttm._frame_begin(prs.scene, info, ptask.initial_state(W, H),
                             ptask.renderer, ptask.jitter_seq, ptask.ci, W, H)
    _, kl = ttm._oit(begin.gb.background, begin.gb, begin.info, prs.scene,
                     ptask.renderer, ptask.ci)
    assert isinstance(kl, oit.KLayerBuffer) and kl.depth.shape[0] == 2
    assert int(kl.overflow.max()) > 0
