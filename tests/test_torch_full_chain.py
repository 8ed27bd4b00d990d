"""The full-chain frame (examples/benchmark_suite.py config_4_animated) in
the port against the JAX package on the CPU: chip_smoke.py's atrium scene
(full_chain_scene) against the JAX package's sponza_like_scene, and two
256 x 128 frames of the atrium with 4 columns (the camera moving between
them) under config 4's TaskManagerCreateInfo: SSAO on the warp route, SSR,
TAA with the warp history, DoF on the warp route, bloom, epipolar light
scattering (256 slices x 128 samples x 24 steps) and auto exposure.

The frames are held at the task manager's two seams after the G-buffer:
both packages' `_frame_fx` (SSAO, SSR, composite, scattering, exposure)
and `_frame_post` (TAA, DoF, bloom, tone map) run on the same G-buffer,
the port's, converted, with their own temporal states.  The JAX seams run
eagerly, op by op, with the Pallas warps interpreted: compiled as one
program, the frame would hold each interpreted warp call (the 16 SSAO
taps, the TAA history, the 24 five-channel DoF taps) as a kernel of its
own, where run eagerly each shape compiles once.  The G-buffer itself is
held against the JAX package by tests/test_torch_frame.py.

Tolerances: eager XLA rounds each operation as the port does, so what
remains are the ulp-level differences of the libraries' exp, log, pow and
trigonometric routines, which the ill-conditioned GTAO pixels of
tests/test_torch_ssao.py and the SSR hit flips of tests/test_torch_ssr.py
amplify locally.  The colour gates sit 10 dB or more under what this path
measured (stated at each gate).
"""
import functools
import importlib.util
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.config import PBRRendererCreateInfo, RasterizerConfig
from diligentfx_tpu.hydrogent import task_manager as jtm
from diligentfx_tpu.pbr.deferred import GBufferData
from diligentfx_tpu.pbr.renderer import PBRRenderer, RenderInfo
from diligentfx_tpu.postfx.ssr import SSRSettings
from diligentfx_tpu.postfx.taa import TAAFeatureFlags
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.config import PBRRendererCreateInfo as PortCI
from diligentfx_tpu_torch.hydrogent import task_manager as ttm
from diligentfx_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_multi
from diligentfx_tpu_torch.pbr.renderer import PBRRenderer as PortRenderer
from diligentfx_tpu_torch.utils.image import psnr
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
W, H = 256, 128
FRAMES = 2
CFG = RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=1536,
                       max_tiles_per_tri=16, big_tri_capacity=64, chunk=8)
CI = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                           irradiance_cube_dim=16, prefiltered_env_map_dim=32,
                           num_specular_env_samples=16)
# benchmark_suite.py:201-214
CHAIN = jtm.TaskManagerCreateInfo(
    enable_ssao=True, ssao_half_resolution=True, ssao_use_pallas=True,
    ssao_num_slices=2, ssao_num_steps=4,
    enable_ssr=True, ssr_half_resolution=True,
    enable_taa=True, enable_bloom=True, enable_dof=True,
    dof_use_pallas=True, fast_env_taps=True,
    enable_light_scattering=True, enable_auto_exposure=True,
    taa_feature_flags=(TAAFeatureFlags.YCOCG_COLOR_SPACE
                       | TAAFeatureFlags.GAUSSIAN_WEIGHTING
                       | TAAFeatureFlags.PALLAS_WARP))
SETTINGS = jtm.FrameSettings(ssr=SSRSettings(max_traversal_intersections=24))


def _benchmark_suite():
    """examples/benchmark_suite.py as a module; it sets a JAX compilation
    cache directory in the environment at import, which is put back."""
    prev = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    spec = importlib.util.spec_from_file_location(
        "benchmark_suite", ROOT / "examples" / "benchmark_suite.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if prev is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = prev
    return mod


def test_scene_matches_jax():
    """chip_smoke.full_chain_scene(12) equals sponza_like_scene(12): the
    112,592-triangle atrium, arrays and materials."""
    ref = _benchmark_suite().sponza_like_scene(n_columns=12)
    got = chip_smoke.full_chain_scene(12, device="cpu")
    assert got.num_triangles == 112592
    for f in ("positions", "normals", "uvs", "tangents", "indices",
              "vertex_node", "tri_material", "tri_double_sided",
              "node_matrices"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in type(got.materials)._fields:
        np.testing.assert_array_equal(getattr(got.materials, f).numpy(),
                                      np.asarray(getattr(ref.materials, f)),
                                      err_msg=f)


def _jax_info(i):
    a = i * 0.02
    eye = [10.0 * np.sin(a), 2.0, 10.0 * np.cos(a)]
    cam = CameraAttribs.create(jm3.look_at(eye, [0, 1, 0]),
                               jm3.perspective(0.8, W / H, 0.1, 100.0), eye,
                               0.1, 100.0, W, H)
    return RenderInfo(camera=cam, lights=PBRLightAttribs.directional(
        [-0.4, -1.0, -0.2], [4, 4, 4]),
        renderer_params=PBRRendererShaderParameters.create())


@pytest.fixture(scope="module")
def chain():
    """FRAMES frames of both packages' seams on the port's G-buffer:
    (records, port task manager), one record a frame with both packages'
    effects colour (after exposure), final colour and new state."""
    from jax.experimental import pallas as pl
    jscene = _benchmark_suite().sponza_like_scene(n_columns=4)
    ren = PBRRenderer(CI, raster_cfg=CFG)
    jtask = jtm.HnTaskManager(ren, CHAIN)
    port_ren = PortRenderer(PortCI(), raster_cfg=cv.raster_config_from_jax(CFG),
                            device="cpu", env_oct=cv.tensor(ren.env_oct),
                            ibl_maps=cv.ibl_maps_from_jax(ren.ibl_maps))
    ptask = ttm.HnTaskManager(port_ren, cv.task_manager_ci_from_jax(CHAIN))
    pscene = chip_smoke.full_chain_scene(4, device="cpu")
    psettings = cv.frame_settings_from_jax(SETTINGS)
    jstate, pstate = jtask.initial_state(W, H), ptask.initial_state(W, H)
    records = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        for i in range(FRAMES):
            pinfo = chip_smoke.full_chain_info(i, W, H, "cpu")
            pbegin = ttm._frame_begin(pscene, pinfo, pstate, port_ren,
                                      ptask.jitter_seq, ptask.ci, W, H)
            jinfo, first, _ = jtm._begin_camera(_jax_info(i), jstate,
                                                jtask.jitter_seq, CHAIN, W, H)
            jgb = GBufferData(*(jnp.asarray(getattr(pbegin.gb, f).numpy())
                                for f in GBufferData._fields[:-1]))
            jbegin = jtm.FrameBegin(gb=jgb, info=jinfo, first_frame=first)
            jfx = jtm._frame_fx(jbegin, jscene, jstate, ren.ibl_maps, SETTINGS,
                                jtask.atmosphere_lut, width=W, height=H,
                                cfg=CFG, ci=CHAIN, use_ibl=True, ssr_steps=24)
            jout = jtm._frame_post(jfx, jstate, SETTINGS, width=W, height=H,
                                   ci=CHAIN)
            pfx = ttm._frame_fx(pbegin, pstate, psettings, ptask.ci,
                                ptask.atmosphere_lut)
            pout = ttm._frame_post(pfx, pstate, psettings, ptask.ci)
            records.append(dict(
                jfx=np.asarray(jfx.color), pfx=pfx.color.numpy(),
                jcolor=np.asarray(jout.color), pcolor=pout.color.numpy(),
                jstate=jout.state, pstate=pout.state))
            jstate, pstate = jout.state, pout.state
    return records, ptask


@pytest.mark.parametrize("frame", range(FRAMES))
def test_full_chain_effects_match_jax(chain, frame):
    """SSAO + SSR + composite + epipolar scattering + exposure (HDR): at
    least 100 dB over the colour range (measured 133.5 and 111.0 dB)."""
    r = chain[0][frame]
    a, b = r["jfx"], r["pfx"]
    assert b.shape == a.shape == (H, W, 3) and np.isfinite(b).all()
    peak = float(np.abs(a).max())
    assert psnr(a / peak, b / peak) > 100.0, psnr(a / peak, b / peak)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_full_chain_frame_matches_jax(chain, frame):
    """The final sRGB frame (after TAA, DoF, bloom and the tone map with
    the adapted exposure): at least 90 dB (measured 130.2 and 104.0 dB)."""
    r = chain[0][frame]
    a, b = r["jcolor"], r["pcolor"]
    assert b.shape == a.shape == (H, W, 3)
    assert np.isfinite(b).all() and b.min() >= 0.0 and b.max() <= 1.0
    assert psnr(a, b) > 90.0, psnr(a, b)


def test_full_chain_state_matches_jax(chain):
    """The temporal state after two frames: the adapted exposure (1e-5
    relative; measured 5.3e-7: a mean of logs over the frame), the DoF CoC
    history (1e-6; it depends on the shared depth alone, measured equal)
    and the TAA history (90 dB; measured 100.4 dB)."""
    jst, pst = chain[0][-1]["jstate"], chain[0][-1]["pstate"]
    assert pst.frame_index == int(jst.frame_index) == FRAMES
    np.testing.assert_allclose(float(pst.average_log_lum),
                               float(jst.average_log_lum), rtol=1e-5)
    np.testing.assert_allclose(pst.dof.coc_history.numpy(),
                               np.asarray(jst.dof.coc_history), rtol=0,
                               atol=1e-6)
    assert psnr(np.clip(jst.taa.color, 0, 1),
                np.clip(pst.taa.color.numpy(), 0, 1)) > 90.0


def test_full_chain_execute_on_cpu_runs_no_kernel(chain):
    """execute composes the same seams: its first frame equals the seams'
    first frame, and the CPU path counts no kernel launch."""
    records, ptask = chain
    before = (warp_bilinear.launches, warp_bilinear_multi.launches)
    pscene = chip_smoke.full_chain_scene(4, device="cpu")
    out = ptask.execute(pscene, chip_smoke.full_chain_info(0, W, H, "cpu"),
                        ptask.initial_state(W, H), width=W, height=H,
                        settings=cv.frame_settings_from_jax(SETTINGS))
    np.testing.assert_array_equal(out.color.numpy(), records[0]["pcolor"])
    assert (warp_bilinear.launches, warp_bilinear_multi.launches) == before
    assert out.state.dof is not None and out.state.average_log_lum.shape == ()
