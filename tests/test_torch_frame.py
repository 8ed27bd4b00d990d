"""The frame end to end: two frames of HnTaskManager.execute in the port
against the JAX package on the CPU, on the bench.py --smoke scene at 256x128
with the bench raster config and the fused raster path, in two
configurations: SLICE (G-buffer -> disocclusion -> TAA -> bloom -> Uncharted2
tone map -> sRGB, SSAO and SSR off) and BENCH, the full bench.py feature set
(half-resolution GTAO on the warp kernel route, divisor-2 SSR on the march
kernel route, fast env taps, TAA with the warp history).  The port also
renders the JAX package's bench-configuration golden scene.

The JAX side runs with DFX_FUSE=on (read at trace time, so the jit caches
are cleared around it) and its Pallas kernels interpreted.  Its frame is
one jitted program, in which XLA contracts multiply-adds into FMAs; the
port rounds every operation separately.  So the two agree to ulps, not
bits: a handful of edge pixels may change winner (tolerated below 0.1%),
and NDC depth moves by up to a few 1e-4 where the depth plane's
coefficients are large.  Tolerances per G-buffer field are stated at
GB_TOL; the final color must reach 50 dB PSNR.  With SSAO and SSR on, the
ill-conditioned GTAO pixels of tests/test_torch_ssao.py and the SSR hit
flips of tests/test_torch_ssr.py add to that.  The BENCH gates sit about
10 dB under what this CPU path measured: colour 70 dB (81.1 and 81.8 dB),
the run resumed from the JAX state 70 dB (83.6), the SSAO history 65 dB
(73.7), the SSR history 50 dB (55.5, where the hit flips land).  Only the
golden gate keeps tests/test_golden.py's 40 dB (measured 54.1).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import bench
from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.config import (PBRRendererCreateInfo, RasterizerConfig,
                                    ShadowMode)
from diligentfx_tpu.hydrogent.task_manager import (FrameSettings,
                                                   HnTaskManager,
                                                   TaskManagerCreateInfo)
from diligentfx_tpu.pbr.renderer import PBRRenderer, RenderInfo
from diligentfx_tpu.postfx.ssr import SSRSettings
from diligentfx_tpu.postfx.taa import TAAFeatureFlags
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.config import PBRRendererCreateInfo as PortCI
from diligentfx_tpu_torch.hydrogent import task_manager as ttm
from diligentfx_tpu_torch.ops.gtao import gtao_fused
from diligentfx_tpu_torch.ops.march import march_small_table
from diligentfx_tpu_torch.ops.raster_kernel import raster_tiles_fused
from diligentfx_tpu_torch.ops.warp import warp_bilinear
from diligentfx_tpu_torch.pbr.renderer import PBRRenderer as PortRenderer
from diligentfx_tpu_torch.utils.image import psnr
from tests.torch_shadow_ref import jax_cascade_maps_op_by_op
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 256, 128
CFG = RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=1024,
                       max_tiles_per_tri=8, big_tri_capacity=64, chunk=8,
                       pair_compaction_cap=1 << 17, sub_bins=4,
                       big_tile_capacity=16)
CI = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                           irradiance_cube_dim=16, prefiltered_env_map_dim=32,
                           num_specular_env_samples=16)
SLICE = TaskManagerCreateInfo(
    enable_ssao=False, enable_ssr=False, enable_taa=True, enable_bloom=True,
    enable_dof=False, fast_env_taps=True,
    taa_feature_flags=(TAAFeatureFlags.YCOCG_COLOR_SPACE
                       | TAAFeatureFlags.GAUSSIAN_WEIGHTING
                       | TAAFeatureFlags.PALLAS_WARP))
BENCH = dataclasses.replace(
    SLICE, enable_ssao=True, ssao_half_resolution=True, ssao_num_slices=2,
    ssao_num_steps=4, ssao_use_pallas=True, enable_ssr=True,
    ssr_half_resolution=True, ssr_resolution_divisor=2, ssr_use_pallas=True)
FRAMES = 2

# G-buffer fields on pixels where both sides hit the same mesh: at least
# 99.9% of the values within tests/test_renderer.py:193's tolerance (5e-4
# absolute + 5e-4 relative), and all within the per-field (atol, rtol)
# below, which leaves room for the few pixels where XLA's contracted
# multiply-adds move a normal or a highlight.  world_pos is checked through
# the view distance instead (it is reconstructed from depth, whose ulps grow
# with distance squared).
GB_TOL = {
    "depth": (5e-4, 0.0), "normal_world": (2e-3, 0.0),
    "normal_view": (2e-3, 0.0), "base_color": (0.0, 0.0),
    "material_data": (0.0, 0.0), "motion": (1e-4, 0.0),
    "direct": (5e-3, 5e-3), "ambient_diffuse": (5e-4, 5e-4),
    "ambient_specular": (2e-3, 2e-3), "spec_env_factor": (3e-3, 3e-3),
}


SUN = [-0.5, -0.7, -0.5]


def _camera_and_lights(csm=False):
    """The bench camera and lights; with csm the sun casts the cascaded
    shadows (shadow map index 0), as in bench.py --csm."""
    eye = [0.0, 1.0, 7.5]
    cam = CameraAttribs.create(jm3.look_at(eye, [0.0, 0.0, 0.0]),
                               jm3.perspective(0.7, W / H, 0.1, 100.0), eye,
                               0.1, 100.0, W, H)
    lights = PBRLightAttribs.concat([
        PBRLightAttribs.directional(SUN, [3.0, 3.0, 3.0],
                                    shadow_map_index=0 if csm else -1),
        PBRLightAttribs.point([2.0, 2.0, 2.0], [8.0, 7.0, 6.0], range=30.0)])
    return RenderInfo(camera=cam, lights=lights,
                      renderer_params=PBRRendererShaderParameters.create())


@pytest.fixture(scope="module")
def frames():
    """FRAMES frames of both packages from the same scene, IBL and
    camera: (jax outputs, port outputs, jax renderer)."""
    from jax.experimental import pallas as pl
    scene = bench.build_bench_scene(2, 2, 12)
    info = _camera_and_lights()
    ren = PBRRenderer(CI, raster_cfg=CFG)
    jouts = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DFX_FUSE", "on")
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        jax.clear_caches()
        try:
            tm = HnTaskManager(ren, SLICE)
            state = tm.initial_state(W, H)
            for _ in range(FRAMES):
                out = tm.execute(scene, info, state, width=W, height=H)
                state = out.state
                jouts.append(jax.tree.map(np.asarray, out))
        finally:
            jax.clear_caches()

    port_ren = PortRenderer(PortCI(), raster_cfg=cv.raster_config_from_jax(CFG),
                            device="cpu", env_oct=cv.tensor(ren.env_oct),
                            ibl_maps=cv.ibl_maps_from_jax(ren.ibl_maps))
    ptm = ttm.HnTaskManager(port_ren, cv.task_manager_ci_from_jax(SLICE))
    pscene, pinfo = cv.scene_from_jax(scene), cv.render_info_from_jax(info)
    pstate = ptm.initial_state(W, H)
    pouts = []
    for _ in range(FRAMES):
        out = ptm.execute(pscene, pinfo, pstate, width=W, height=H)
        pstate = out.state
        pouts.append(out)
    return jouts, pouts, ren


@pytest.mark.parametrize("frame", range(FRAMES))
def test_frame_color_matches_jax(frames, frame):
    jouts, pouts, _ = frames
    a, b = jouts[frame].color, pouts[frame].color.numpy()
    assert b.shape == a.shape == (H, W, 3)
    assert np.isfinite(b).all() and b.min() >= 0.0 and b.max() <= 1.0
    assert psnr(a, b) > 50.0, psnr(a, b)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_gbuffer_matches_jax(frames, frame):
    """render_gbuffer with the fused raster (fuse="on" through DFX_FUSE on
    the JAX side), the frame's main pass with its jittered camera, field by
    field."""
    jgb, pgb = frames[0][frame].gbuffer, frames[1][frame].gbuffer
    ha, hb = jgb.hit, pgb.hit.numpy()
    ia, ib = jgb.mesh_id, pgb.mesh_id.numpy()
    same = (ha == hb) & (ia == ib)
    assert (~same).mean() < 1e-3, int((~same).sum())
    assert 0.3 < ha.mean() < 1.0
    for name, (atol, rtol) in GB_TOL.items():
        x, y = getattr(jgb, name)[same], getattr(pgb, name).numpy()[same]
        close = np.abs(y - x) <= 5e-4 + 5e-4 * np.abs(x)
        assert close.mean() >= 0.999, (name, int((~close).sum()))
        np.testing.assert_allclose(y, x, atol=atol, rtol=rtol, err_msg=name)
    # background: half-res point taps of the sky; the two packages invert
    # the view-projection with different LU codes, so a tap on a texel edge
    # may land on the neighbouring texel (the sky is smooth: 1e-2)
    bg_a, bg_b = jgb.background, pgb.background.numpy()
    assert (np.abs(bg_b - bg_a) <= 1e-5).mean() > 0.995
    np.testing.assert_allclose(bg_b, bg_a, atol=1e-2, rtol=0)
    # world position is reconstructed from depth: a depth error dd moves it
    # by about dd * z^2 (f - n) / (f n) along the view ray (z <= the view
    # distance); bound it by twice that plus 1e-3
    cam_pos = np.array([0.0, 1.0, 7.5], np.float32)
    dist = np.linalg.norm(jgb.world_pos - cam_pos, axis=-1)
    err = np.linalg.norm(pgb.world_pos.numpy() - jgb.world_pos, axis=-1)
    dd = np.abs(pgb.depth.numpy() - jgb.depth) + 1e-6
    near, far = 0.1, 100.0
    bound = 2.0 * dd * dist ** 2 * (far - near) / (far * near) + 1e-3
    hit_same = same & ha
    assert (err[hit_same] <= bound[hit_same]).all(), \
        float((err / bound)[hit_same].max())


def test_taa_state_matches_jax(frames):
    jouts, pouts, _ = frames
    jst, pst = jouts[-1].state, pouts[-1].state
    assert pst.frame_index == int(jst.frame_index) == FRAMES
    assert (pst.taa.sample_count.numpy() == jst.taa.sample_count).mean() \
        > 0.995
    assert psnr(np.clip(jst.taa.color, 0, 1),
                np.clip(pst.taa.color.numpy(), 0, 1)) > 50.0
    np.testing.assert_allclose(pst.prev_view_proj.numpy(),
                               jst.prev_view_proj, rtol=1e-6, atol=1e-6)
    same = pouts[-1].gbuffer.mesh_id.numpy() == jouts[-1].gbuffer.mesh_id
    np.testing.assert_allclose(pst.prev_depth.numpy()[same],
                               jst.prev_depth[same], atol=5e-4)


def test_frame_resumes_from_converted_jax_state(frames):
    """convert.frame_state_from_jax carries the JAX package's temporal
    history into the port: the port's frame 2 rendered from the JAX
    package's state after frame 1 matches the JAX package's frame 2."""
    jouts, _, ren = frames
    port_ren = PortRenderer(PortCI(), raster_cfg=cv.raster_config_from_jax(CFG),
                            device="cpu", env_oct=cv.tensor(ren.env_oct),
                            ibl_maps=cv.ibl_maps_from_jax(ren.ibl_maps))
    ptm = ttm.HnTaskManager(port_ren, cv.task_manager_ci_from_jax(SLICE))
    scene = bench.build_bench_scene(2, 2, 12)
    out = ptm.execute(cv.scene_from_jax(scene),
                      cv.render_info_from_jax(_camera_and_lights()),
                      cv.frame_state_from_jax(jouts[0].state), width=W,
                      height=H)
    assert out.state.frame_index == 2
    assert psnr(jouts[1].color, out.color.numpy()) > 50.0


def test_frame_runs_no_kernel_on_cpu(frames):
    """The CPU path runs the plain versions: no kernel launch is counted."""
    from diligentfx_tpu_torch.ops.raster_tiles import raster_tiles
    assert raster_tiles.launches == 0
    assert raster_tiles_fused.launches == 0
    assert warp_bilinear.launches == 0
    assert march_small_table.launches == 0
    assert gtao_fused.launches == 0


def _port_renderer():
    return PortRenderer(PortCI(brdf_lut_dim=8, num_brdf_samples=4,
                               irradiance_cube_dim=8,
                               prefiltered_env_map_dim=8,
                               num_specular_env_samples=4),
                        raster_cfg=cv.raster_config_from_jax(CFG),
                        device="cpu")


# switches the port once refused; the editor's and vis_only are ported
# (tests/test_torch_editor_frame.py), the SSR profiling knobs stay refused
UNPORTED = {"enable_selection": True, "enable_grid": True, "vis_only": True,
            "ssr_stage_cut": "march", "ssr_march_sweep": "static"}
REFUSED = ("ssr_stage_cut", "ssr_march_sweep")


@pytest.mark.parametrize("switch", list(UNPORTED))
def test_unported_switches_raise(switch):
    """The SSR profiling knobs raise NotImplementedError when the task
    manager is built; the switches ported since build."""
    ci = dataclasses.replace(cv.task_manager_ci_from_jax(SLICE),
                             **{switch: UNPORTED[switch]})
    if switch in REFUSED:
        with pytest.raises(NotImplementedError):
            ttm.HnTaskManager(_port_renderer(), ci)
    else:
        tm = ttm.HnTaskManager(_port_renderer(), ci)
        assert getattr(tm.ci, switch) == UNPORTED[switch]


def test_default_task_manager_config_raises():
    """The default config (SSAO and SSR on, their non-kernel routes, as in
    the JAX package) builds and renders on the CPU; it raises only with
    the SSR profiling knobs set."""
    ci = ttm.TaskManagerCreateInfo()
    assert ci.enable_ssao and ci.enable_ssr
    assert not (ci.ssao_use_pallas or ci.ssr_use_pallas)
    with pytest.raises(NotImplementedError, match="stage_cut"):
        ttm.HnTaskManager(_port_renderer(),
                          dataclasses.replace(ci, ssr_stage_cut="taps"))
    tm = ttm.HnTaskManager(_port_renderer(), ci)
    state = tm.initial_state(W, H)
    assert state.ssr.radiance.shape == (H, W, 4)
    assert state.ssao.history.shape == (H, W)
    scene = cv.scene_from_jax(bench.build_bench_scene(1, 2, 8))
    out = tm.execute(scene, cv.render_info_from_jax(_camera_and_lights()),
                     state, width=W, height=H)
    color = out.color.numpy()
    assert np.isfinite(color).all() and 0.0 <= color.min() <= color.max() <= 1.0
    assert out.state.ssao.history.shape == (H, W)


def test_entry_points_default_to_cuda():
    """Entry points run on CUDA unless the caller passes device="cpu"; with
    no CUDA they raise instead of falling back."""
    from diligentfx_tpu_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PortRenderer(PortCI())
        with pytest.raises(RuntimeError):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# the bench feature set (SSAO + SSR on their kernel routes)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench_frames(frames):
    """FRAMES frames of the BENCH configuration in both packages, with the
    JAX renderer of `frames`: (jax outputs, port outputs)."""
    from jax.experimental import pallas as pl
    ren = frames[2]
    scene = bench.build_bench_scene(2, 2, 12)
    info = _camera_and_lights()
    settings = FrameSettings(ssr=SSRSettings(max_traversal_intersections=24))
    jouts = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DFX_FUSE", "on")
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        jax.clear_caches()
        try:
            tm = HnTaskManager(ren, BENCH)
            state = tm.initial_state(W, H)
            for _ in range(FRAMES):
                out = tm.execute(scene, info, state, width=W, height=H,
                                 settings=settings)
                state = out.state
                jouts.append(jax.tree.map(np.asarray, out))
        finally:
            jax.clear_caches()

    port_ren = PortRenderer(PortCI(), raster_cfg=cv.raster_config_from_jax(CFG),
                            device="cpu", env_oct=cv.tensor(ren.env_oct),
                            ibl_maps=cv.ibl_maps_from_jax(ren.ibl_maps))
    ptm = ttm.HnTaskManager(port_ren, cv.task_manager_ci_from_jax(BENCH))
    pscene, pinfo = cv.scene_from_jax(scene), cv.render_info_from_jax(info)
    psettings = cv.frame_settings_from_jax(settings)
    pstate = ptm.initial_state(W, H)
    pouts = []
    for _ in range(FRAMES):
        out = ptm.execute(pscene, pinfo, pstate, width=W, height=H,
                          settings=psettings)
        pstate = out.state
        pouts.append(out)
    return jouts, pouts, port_ren, psettings


@pytest.mark.parametrize("frame", range(FRAMES))
def test_bench_frame_color_matches_jax(bench_frames, frame):
    jouts, pouts = bench_frames[:2]
    a, b = jouts[frame].color, pouts[frame].color.numpy()
    assert b.shape == a.shape == (H, W, 3)
    assert np.isfinite(b).all() and b.min() >= 0.0 and b.max() <= 1.0
    assert psnr(a, b) > 70.0, psnr(a, b)


def test_bench_frame_state_matches_jax(bench_frames):
    """The SSAO and SSR histories after FRAMES frames."""
    jst, pst = bench_frames[0][-1].state, bench_frames[1][-1].state
    assert pst.frame_index == int(jst.frame_index) == FRAMES
    assert pst.ssr.radiance.shape == jst.ssr.radiance.shape == (H // 2,
                                                                 W // 2, 4)
    assert psnr(np.clip(jst.ssao.history, 0, 1),
                pst.ssao.history.numpy()) > 65.0
    np.testing.assert_allclose(pst.ssao.depth_history.numpy(),
                               jst.ssao.depth_history, atol=1e-4)
    assert psnr(np.clip(jst.ssr.radiance, 0, 1),
                np.clip(pst.ssr.radiance.numpy(), 0, 1)) > 50.0


def test_bench_frame_resumes_from_converted_jax_state(bench_frames):
    """convert.frame_state_from_jax carries the SSAO and SSR histories too:
    the port's frame 2 from the JAX package's state after frame 1."""
    jouts, _, port_ren, psettings = bench_frames
    ptm = ttm.HnTaskManager(port_ren, cv.task_manager_ci_from_jax(BENCH))
    out = ptm.execute(cv.scene_from_jax(bench.build_bench_scene(2, 2, 12)),
                      cv.render_info_from_jax(_camera_and_lights()),
                      cv.frame_state_from_jax(jouts[0].state), width=W,
                      height=H, settings=psettings)
    assert out.state.frame_index == 2
    assert psnr(jouts[1].color, out.color.numpy()) > 70.0


def test_bench_config_golden(bench_frames):
    """The port renders the JAX package's bench-configuration golden
    (tests/golden/generate.py render_bench_config_golden: its scene built by
    the JAX package and carried across) against bench_cfg_256.png, with
    the threshold of tests/test_golden.py (40 dB)."""
    import os
    import sys
    golden = os.path.join(os.path.dirname(__file__), "golden")
    sys.path.insert(0, golden)
    import generate as gen
    from diligentfx_tpu.utils.image import read_png
    w, h = 256, 128
    port_ren = bench_frames[2]
    ren = PortRenderer(PortCI(), raster_cfg=cv.raster_config_from_jax(
        gen._small_cfg()), device="cpu", env_oct=port_ren.env_oct,
        ibl_maps=port_ren.ibl_maps)
    tm = ttm.HnTaskManager(ren, cv.task_manager_ci_from_jax(BENCH))
    info = RenderInfo(
        camera=gen._small_cam([0.0, 2.0, 9.0], [0, 1, 0], w, h),
        lights=PBRLightAttribs.directional([-0.4, -1.0, -0.2], [4, 4, 4]),
        renderer_params=PBRRendererShaderParameters.create())
    scene, pinfo = cv.scene_from_jax(gen._mini_sponza()), \
        cv.render_info_from_jax(info)
    settings = cv.frame_settings_from_jax(
        FrameSettings(ssr=SSRSettings(max_traversal_intersections=16)))
    state = tm.initial_state(w, h)
    for _ in range(2):
        out = tm.execute(scene, pinfo, state, width=w, height=h,
                         settings=settings)
        state = out.state
    ref = read_png(os.path.join(golden, "bench_cfg_256.png"))[..., :3]
    p = psnr(np.clip(out.color.numpy(), 0.0, 1.0),
             ref.astype(np.float64) / 255.0)
    assert p > 40.0, p


# ---------------------------------------------------------------------------
# the --csm frame: textured materials + cascaded EVSM2 shadows
# ---------------------------------------------------------------------------

# the slice-1 effects plus EVSM2 shadows; the scene carries bench.py's atlas
CSM = dataclasses.replace(SLICE, enable_shadows=True,
                          shadow_mode=ShadowMode.EVSM2)
SHADOW_SIZE = 256


@pytest.fixture(scope="module")
def csm_inputs(frames):
    """The textured bench --smoke scene (bench.py's atlas), its 2 EVSM2
    cascades at 256^2 (the JAX package's distribute_cascades), the port's
    shadow pass over them (HnTaskManager.render_shadows) and the JAX
    package's (its cascade raster run op by op, then the moments and the
    blur), with the renderer and IBL of `frames`."""
    from diligentfx_tpu.components import shadow_map_manager as jsm
    from diligentfx_tpu.pbr.renderer import transform_vertices
    ren = frames[2]
    scene, atlas = bench.build_bench_scene(2, 2, 12, textured=True)
    info = _camera_and_lights(csm=True)
    cam = info.camera
    att = jsm.distribute_cascades(cam.view, jm3.inverse(cam.view),
                                  float(cam.proj[0, 0]), float(cam.proj[1, 1]),
                                  0.1, 100.0, SUN, num_cascades=2,
                                  shadow_map_size=SHADOW_SIZE)
    port_ren = PortRenderer(PortCI(), raster_cfg=cv.raster_config_from_jax(CFG),
                            device="cpu", env_oct=cv.tensor(ren.env_oct),
                            ibl_maps=cv.ibl_maps_from_jax(ren.ibl_maps))
    ptm = ttm.HnTaskManager(port_ren, cv.task_manager_ci_from_jax(CSM),
                            atlas=cv.atlas_from_jax(atlas))
    pscene = cv.scene_from_jax(scene)
    pinfo = ptm.render_shadows(pscene, cv.render_info_from_jax(info),
                               cv.shadow_attribs_from_jax(att),
                               shadow_map_size=SHADOW_SIZE)
    jmaps = jax_cascade_maps_op_by_op(transform_vertices(scene)[0],
                                      scene.indices, att, SHADOW_SIZE, CFG)
    jmoments = np.asarray(jsm.gaussian_blur_separable(
        jsm.convert_to_filterable(jax.numpy.asarray(jmaps),
                                  ShadowMode.EVSM2)))
    return dict(ren=ren, scene=scene, atlas=atlas, info=info, att=att,
                ptm=ptm, pscene=pscene, pinfo=pinfo, jmaps=jmaps,
                jmoments=jmoments)


def test_csm_shadow_pass_matches_jax(csm_inputs):
    """The port's shadow pass on the textured bench scene (the cascade depth
    maps through K4's plain version, the EVSM2 moments, the blur) against
    the JAX package's: coverage equal and depth within 1e-6 (as
    tests/test_torch_shadows.py on the golden scene), moments within 1e-5
    relative (EVSM's exp(40 z) amplifies an ulp of z forty-fold)."""
    g = csm_inputs
    maps, ref = g["pinfo"].shadow_maps.numpy(), g["jmaps"]
    assert maps.shape == ref.shape == (2, SHADOW_SIZE, SHADOW_SIZE)
    assert 0.3 < (ref < 1.0).mean() < 1.0
    np.testing.assert_array_equal(maps < 1.0, ref < 1.0)
    np.testing.assert_allclose(maps, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g["pinfo"].shadow_moments.numpy(),
                               g["jmoments"], rtol=1e-5, atol=0)


def test_csm_gbuffer_matches_jax(csm_inputs):
    """The textured, shadowed G-buffer: the port's render_gbuffer (K1's plain
    version with the UV-derivative channels, the five texture slots, the
    normal map, the EVSM2 cascade factor) against the JAX package's
    deferred shading (_shade_band, jitted) on the same kernel output, each
    with its own shadow maps and moments (the JAX side with the JAX
    package's, which test_csm_shadow_pass_matches_jax holds against the
    port's).  The JAX side shades the port's fused-kernel output:
    the kernel itself is held against the interpreted Pallas kernel with
    derivative channels in tests/test_torch_raster.py, and compiling the
    interpreted kernel into the textured JAX frame costs 100-150 s of one
    core.  Tolerances as GB_TOL (XLA's contracted multiply-adds), but the
    base colour and material, which the textures now modulate: all within
    1e-5 (XLA's contracted multiply-adds in the texel and mip weights;
    measured 2.4e-7 and 8.9e-8)."""
    from diligentfx_tpu.pbr import deferred as jd
    from diligentfx_tpu.ops import raster as jr
    from diligentfx_tpu_torch.pbr import deferred as td
    from diligentfx_tpu_torch.ops.raster_kernel import raster_tiles_fused
    g = csm_inputs
    pinfo, pscene = g["pinfo"], g["pscene"]
    kw = dict(width=W, height=H, cfg=cv.raster_config_from_jax(CFG),
              use_ibl=True, use_lights=True, shadow_mode=ShadowMode.EVSM2,
              atlas=g["ptm"].atlas, use_textures=True, fast_env=True)
    pgb = td.render_gbuffer(pscene, pinfo, g["ptm"].renderer.ibl_maps,
                            g["ptm"].renderer.env_oct, **kw)
    k = td.fused_raster_inputs(pscene, pinfo, pad_w=W, pad_h=H,
                               cfg=kw["cfg"], use_textures=True)
    z, tid, out = raster_tiles_fused(k.setup, k.planes, k.candidates,
                                     k.counts, k.mat_table, k.rects,
                                     **k.kernel_kw)
    assert out.shape[0] == 12 + 4 + 2 + 20     # channels, derivs, ids, mat
    vb = jr.VisibilityBuffer(depth=jax.numpy.asarray(z.numpy()),
                             tri_id=jax.numpy.asarray(tid.numpy()),
                             bary=jax.numpy.zeros((H, W, 2)))
    jinfo = g["info"]._replace(
        shadow_attribs=g["att"],
        shadow_maps=jax.numpy.asarray(g["jmaps"]),
        shadow_moments=jax.numpy.asarray(g["jmoments"]))
    shade = jax.jit(functools.partial(
        jd._shade_band, band_h=H, pad_w=W, pad_h=H, use_ibl=True,
        use_lights=True, shadow_mode=ShadowMode.EVSM2, pcf_kernel_size=3,
        use_textures=True, enable_clearcoat=False, fast_env=True,
        light_shadow_kinds=()))
    ren = g["ren"]
    jgb = jax.tree.map(np.asarray, shade(
        g["scene"], jinfo, ren.ibl_maps, ren.env_oct, vb, None, None,
        jax.numpy.int32(0), atlas=g["atlas"],
        fused_px=jax.numpy.asarray(out.numpy())))
    hit = jgb.hit
    np.testing.assert_array_equal(pgb.hit.numpy(), hit)
    np.testing.assert_array_equal(pgb.mesh_id.numpy(), jgb.mesh_id)
    assert 0.3 < hit.mean() < 1.0
    tol = dict(GB_TOL, base_color=(1e-5, 0.0), material_data=(1e-5, 0.0))
    for name, (atol, rtol) in tol.items():
        x, y = getattr(jgb, name)[hit], getattr(pgb, name).numpy()[hit]
        close = np.abs(y - x) <= 5e-4 + 5e-4 * np.abs(x)
        assert close.mean() >= 0.999, (name, int((~close).sum()))
        np.testing.assert_allclose(y, x, atol=atol, rtol=rtol, err_msg=name)


def test_csm_frame_runs_and_is_textured_and_shadowed(csm_inputs, frames):
    """Two frames of the port's csm task-manager frame (the shadow pass,
    then execute): finite in [0, 1], the cascade maps half covered, and
    against the untextured, unshadowed slice-1 frame of the same scene the
    base colour and the direct light differ where they should."""
    g = csm_inputs
    ptm, pinfo = g["ptm"], g["pinfo"]
    assert pinfo.shadow_maps.shape == (2, SHADOW_SIZE, SHADOW_SIZE)
    assert pinfo.shadow_moments.shape == (2, SHADOW_SIZE, SHADOW_SIZE, 2)
    assert 0.3 < float((pinfo.shadow_maps < 1.0).float().mean()) < 1.0
    state = ptm.initial_state(W, H)
    for _ in range(FRAMES):
        out = ptm.execute(g["pscene"], pinfo, state, width=W, height=H)
        state = out.state
    b = out.color.numpy()
    assert b.shape == (H, W, 3) and np.isfinite(b).all()
    assert 0.0 <= b.min() <= b.max() <= 1.0
    plain = frames[1][-1].gbuffer
    hit = out.gbuffer.hit.numpy() & plain.hit.numpy()
    base_diff = np.abs(out.gbuffer.base_color.numpy()
                       - plain.base_color.numpy())[hit]
    assert (base_diff.max(-1) > 1e-3).mean() > 0.5      # textured
    direct_diff = (out.gbuffer.direct.numpy()
                   - plain.direct.numpy())[hit].max(-1)
    assert (direct_diff < -1e-2).mean() > 0.05          # shadowed somewhere


def test_csm_unported_options_raise(csm_inputs):
    """Per-light shadow kinds and the texture heap on the csm frame: with
    light_shadow_kinds ("csm", "none") the frame equals the cascaded frame
    bit for bit (the JAX package's dispatch gives "csm" the cascaded
    factor; the point light, shadow map index -1, is lit either way); with
    the bench textures in a texture heap, the heap holds the atlas's own
    mips (each 256^2 texture fills its layer) and the frame stays within
    1e-5 of the atlas frame (the heap blends its two levels as
    s0 + (s1 - s0) f, the atlas sums six weighted levels; the MIRROR wrap
    clamps at the edge in both)."""
    from diligentfx_tpu_torch.ops import texture as tt
    g = csm_inputs
    ptm, pinfo, pscene = g["ptm"], g["pinfo"], g["pscene"]
    state = ptm.initial_state(W, H)
    plain = ptm.execute(pscene, pinfo, state, width=W, height=H)
    kinds = ptm.execute(pscene, pinfo, state, width=W, height=H,
                        light_shadow_kinds=("csm", "none"))
    assert torch.equal(kinds.color, plain.color)
    assert torch.equal(kinds.gbuffer.direct, plain.gbuffer.direct)
    hb = tt.TextureHeapBuilder()
    for layer in g["ptm"].atlas.mips[0].numpy():
        hb.add(layer)
    heap = hb.build(num_mips=len(g["atlas"].mips), device="cpu")
    mips = np.concatenate([m.numpy()[i].reshape(-1, 4)
                           for i in range(3) for m in g["ptm"].atlas.mips])
    np.testing.assert_array_equal(heap.texels.numpy(), mips)
    htm = ttm.HnTaskManager(ptm.renderer, ptm.ci, atlas=heap)
    out = htm.execute(pscene, pinfo, state, width=W, height=H)
    assert out.gbuffer.hit.float().mean() > 0.3
    np.testing.assert_allclose(out.gbuffer.base_color.numpy(),
                               plain.gbuffer.base_color.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out.color.numpy(), plain.color.numpy(),
                               rtol=0, atol=1e-5)


def test_forward_render_csm_golden(frames):
    """PBRRenderer.render of the csm_256 golden (tests/golden/generate.py
    render_csm_golden: a sphere on a ground plane, 2-cascade EVSM2 shadows
    at 256^2) with the port's own cascades, shadow maps and moments, on the
    two-pass branch (K4's plain version: fuse="auto" on the CPU) and the
    fused one: 40 dB against the golden (tests/test_golden.py's bound), and
    60 dB against the JAX package's render of the golden's own steps, about
    10 dB under the 69.96 dB measured (XLA's FMAs; the port's own cascades
    and maps).  The JAX renderer is `frames`' (the golden's IBL dims) with
    the golden's raster config."""
    import copy
    import os
    import sys
    from diligentfx_tpu.components import shadow_map_manager as jsm
    from diligentfx_tpu.pbr.renderer import transform_vertices
    from diligentfx_tpu.utils.image import read_png
    from diligentfx_tpu_torch.components import shadow_map_manager as tsm
    from diligentfx_tpu_torch.config import ShadowMode as PortMode
    from diligentfx_tpu_torch.pbr.renderer import \
        transform_vertices as port_transform_vertices
    golden = os.path.join(os.path.dirname(__file__), "golden")
    sys.path.insert(0, golden)
    import generate as gen
    from diligentfx_tpu.attribs import PBRMaterialBasicAttribs
    from diligentfx_tpu.gltf.primitives import plane, uv_sphere
    from diligentfx_tpu.pbr.renderer import build_scene
    w, h, sun = 256, 128, [-0.5, -1.0, -0.4]
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
    jren = copy.copy(frames[2])
    jren.ci = dataclasses.replace(jren.ci, enable_shadows=True)
    jren.raster_cfg = gen._small_cfg()
    cam = gen._small_cam([0.0, 1.2, 4.0], [0, 0, 0], w, h)
    att = jsm.distribute_cascades(cam.view, jm3.inverse(cam.view),
                                  float(cam.proj[0, 0]), float(cam.proj[1, 1]),
                                  0.1, 100.0, sun, num_cascades=2,
                                  shadow_map_size=256)
    wp, _, _ = transform_vertices(scene)
    maps = jsm.render_cascade_shadow_maps(wp, scene.indices, att,
                                          shadow_map_size=256,
                                          cfg=jren.raster_cfg)
    info = RenderInfo(
        camera=cam,
        lights=PBRLightAttribs.directional(sun, [4, 4, 4], shadow_map_index=0),
        renderer_params=PBRRendererShaderParameters.create())
    jframe = np.asarray(jren.render(
        scene, info._replace(shadow_attribs=att, shadow_maps=maps,
                             shadow_moments=jsm.gaussian_blur_separable(
                                 jsm.convert_to_filterable(
                                     maps, ShadowMode.EVSM2))),
        width=w, height=h, shadow_mode=ShadowMode.EVSM2))

    ren = PortRenderer(PortCI(enable_shadows=True),
                       raster_cfg=cv.raster_config_from_jax(jren.raster_cfg),
                       device="cpu", env_oct=cv.tensor(jren.env_oct),
                       ibl_maps=cv.ibl_maps_from_jax(jren.ibl_maps))
    pscene, pinfo = cv.scene_from_jax(scene), cv.render_info_from_jax(info)
    pcam = pinfo.camera
    patt = tsm.distribute_cascades(pcam.view, torch.linalg.inv(pcam.view),
                                   float(pcam.proj[0, 0]),
                                   float(pcam.proj[1, 1]), 0.1, 100.0, sun,
                                   num_cascades=2, shadow_map_size=256)
    pwp, _, _ = port_transform_vertices(pscene)
    pmaps = tsm.render_cascade_shadow_maps(pwp, pscene.indices, patt,
                                           shadow_map_size=256,
                                           cfg=ren.raster_cfg)
    pinfo = pinfo._replace(shadow_attribs=patt, shadow_maps=pmaps,
                           shadow_moments=tsm.gaussian_blur_separable(
                               tsm.convert_to_filterable(pmaps,
                                                         PortMode.EVSM2)))
    ref = read_png(os.path.join(golden, "csm_256.png"))[..., :3] / 255.0
    for fuse in ("auto", "on"):
        img = ren.render(pscene, pinfo, width=w, height=h,
                         shadow_mode=PortMode.EVSM2, fuse=fuse).numpy()
        assert img.shape == (h, w, 3) and np.isfinite(img).all()
        assert psnr(np.clip(img, 0.0, 1.0), ref) > 40.0, fuse
        assert psnr(jframe, img) > 60.0, (fuse, psnr(jframe, img))
    # the shadow darkens the ground: unshadowed, the frame differs
    lit = ren.render(pscene, pinfo._replace(shadow_attribs=None), width=w,
                     height=h).numpy()
    assert psnr(lit, img) < 40.0
