"""HnTaskManager.execute_split in the port: examples/benchmark_suite.py's
cfg5 frame (config_5_4k: SSAO on the per-tap warp route, half-resolution
SSR, TAA with the warp history, YCoCg and Gaussian weighting, bloom) at
256 x 128 on chip_smoke.py's atrium with 4 columns, two frames with the
G-buffer in 1 and in 4 row bands.

Against the port's `execute`: bit-equal.  The banded G-buffer shades
pixel by pixel the rows the whole frame shades (cfg5 keeps fast_env_taps
off, whose half-resolution background would edge-clamp at each band's
last row), and the stages after it are the same calls.

Against the JAX package's execute_split: held at the task manager's two
seams after the G-buffer, as tests/test_torch_full_chain.py holds the
full chain: both packages' `_frame_fx` and `_frame_post` run on the
port's banded G-buffer, converted, with their own temporal states; the
JAX seams run eagerly with the Pallas warps interpreted.  The G-buffer's
banded form itself is held against the JAX package by
tests/test_torch_banded_gbuffer.py.  Colour above 50 dB (the gate of
tests/test_torch_frame.py).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.config import RasterizerConfig
from diligentfx_tpu.hydrogent import task_manager as jtm
from diligentfx_tpu.pbr.deferred import GBufferData
from diligentfx_tpu.pbr.renderer import RenderInfo
from diligentfx_tpu.postfx.ssr import SSRSettings
from diligentfx_tpu.postfx.taa import TAAFeatureFlags
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.config import DebugViewType
from diligentfx_tpu_torch.hydrogent import task_manager as ttm
from diligentfx_tpu_torch.utils.image import psnr
from tests.test_torch_full_chain import _benchmark_suite
from tests.test_torch_material_ext import jax_and_port_renderers
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 256, 128
FRAMES = 2
# benchmark_suite.py:248-258
CFG = RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=1024,
                       max_tiles_per_tri=16, big_tri_capacity=64, chunk=8)
CFG5 = jtm.TaskManagerCreateInfo(
    enable_ssao=True, ssao_half_resolution=True, ssao_use_pallas=True,
    ssao_num_slices=2, ssao_num_steps=4,
    enable_ssr=True, ssr_half_resolution=True,
    enable_taa=True, enable_bloom=True,
    taa_feature_flags=(TAAFeatureFlags.YCOCG_COLOR_SPACE
                       | TAAFeatureFlags.GAUSSIAN_WEIGHTING
                       | TAAFeatureFlags.PALLAS_WARP))
SETTINGS = jtm.FrameSettings(ssr=SSRSettings(max_traversal_intersections=24))


def _info():
    eye = [0.0, 2.0, 10.0]
    cam = CameraAttribs.create(jm3.look_at(eye, [0, 1, 0]),
                               jm3.perspective(0.8, W / H, 0.1, 100.0), eye,
                               0.1, 100.0, W, H)
    return RenderInfo(camera=cam, lights=PBRLightAttribs.directional(
        [-0.4, -1.0, -0.2], [4, 4, 4]),
        renderer_params=PBRRendererShaderParameters.create())


@pytest.fixture(scope="module")
def split():
    """FRAMES frames of the port's execute_split with 4 bands and with 1,
    of its execute, and of the JAX seams on the 4-band G-buffer."""
    from jax.experimental import pallas as pl
    ren, port_ren = jax_and_port_renderers()
    port_ren.raster_cfg = cv.raster_config_from_jax(CFG)
    ptm = ttm.HnTaskManager(port_ren, cv.task_manager_ci_from_jax(CFG5))
    jtask = jtm.HnTaskManager(ren, CFG5)
    pscene = chip_smoke.full_chain_scene(4, device="cpu")
    jscene = _benchmark_suite().sponza_like_scene(n_columns=4)
    pinfo, psettings = cv.render_info_from_jax(_info()), \
        cv.frame_settings_from_jax(SETTINGS)
    runs = {}
    for name, call in (("execute", ptm.execute),
                       ("bands1", functools.partial(ptm.execute_split,
                                                    gbuffer_bands=1)),
                       ("bands4", functools.partial(ptm.execute_split,
                                                    gbuffer_bands=4))):
        state, outs = ptm.initial_state(W, H), []
        for _ in range(FRAMES):
            out = call(pscene, pinfo, state, width=W, height=H,
                       settings=psettings)
            state = out.state
            outs.append(out)
        runs[name] = outs
    jstate, jcolors = jtask.initial_state(W, H), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        for out in runs["bands4"]:
            jinfo, first, _ = jtm._begin_camera(_info(), jstate,
                                                jtask.jitter_seq, CFG5, W, H)
            jgb = GBufferData(*(jnp.asarray(getattr(out.gbuffer, f).numpy())
                                for f in GBufferData._fields[:-1]))
            jfx = jtm._frame_fx(jtm.FrameBegin(gb=jgb, info=jinfo,
                                               first_frame=first),
                                jscene, jstate, ren.ibl_maps, SETTINGS, None,
                                width=W, height=H, cfg=CFG, ci=CFG5,
                                use_ibl=True, ssr_steps=24)
            jout = jtm._frame_post(jfx, jstate, SETTINGS, width=W, height=H,
                                   ci=CFG5)
            jcolors.append(np.asarray(jout.color))
            jstate = jout.state
    return runs, jcolors, jstate, ptm, (pscene, pinfo)


@pytest.mark.parametrize("bands", ["bands1", "bands4"])
@pytest.mark.parametrize("frame", range(FRAMES))
def test_execute_split_equals_execute(split, bands, frame):
    a, b = split[0]["execute"][frame], split[0][bands][frame]
    assert b.color.shape == (H, W, 3)
    assert torch.isfinite(b.color).all()
    assert torch.equal(a.color, b.color)
    for f in ("depth", "mesh_id", "normal_view", "direct", "background",
              "motion"):
        assert torch.equal(getattr(a.gbuffer, f), getattr(b.gbuffer, f)), f
    sa, sb = a.state, b.state
    assert sa.frame_index == sb.frame_index == frame + 1
    for x, y in ((sa.taa.color, sb.taa.color), (sa.ssao.history,
                                                sb.ssao.history),
                 (sa.ssr.radiance, sb.ssr.radiance),
                 (sa.prev_depth, sb.prev_depth)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_execute_split_matches_jax_seams(split, frame):
    """The 4-band frame against the JAX package's effects and temporal
    stage on the same G-buffer."""
    out, jc = split[0]["bands4"][frame], split[1][frame]
    c = out.color.numpy()
    assert c.min() >= 0.0 and c.max() <= 1.0
    assert 0.2 < out.gbuffer.hit.float().mean() < 1.0
    assert psnr(jc, c) > 50.0, psnr(jc, c)


def test_execute_split_state_matches_jax(split):
    jst, pst = split[2], split[0]["bands4"][-1].state
    assert pst.frame_index == int(jst.frame_index) == FRAMES
    assert psnr(np.clip(jst.taa.color, 0, 1),
                np.clip(pst.taa.color.numpy(), 0, 1)) > 50.0
    assert psnr(np.asarray(jst.ssao.history), pst.ssao.history.numpy()) > 50.0


def test_execute_split_refuses_bands_without_the_whole_gbuffer(split):
    """A debug view and vis_only read the whole G-buffer's payload: the
    banded form refuses them, and takes them with one band."""
    ptm, (pscene, pinfo) = split[3], split[4]
    for kw in (dict(view_mode=DebugViewType.BASE_COLOR), dict(vis_only=True)):
        tm = ttm.HnTaskManager(ptm.renderer, dataclasses.replace(ptm.ci,
                                                                 **kw))
        with pytest.raises(ValueError, match="gbuffer_bands=1"):
            tm.execute_split(pscene, pinfo, tm.initial_state(W, H),
                             width=W, height=H, gbuffer_bands=2)
        out = tm.execute_split(pscene, pinfo, tm.initial_state(W, H),
                               width=W, height=H, gbuffer_bands=1)
        assert out.color.shape == (H, W, 3)
