"""The port's editor frame against the JAX package on the CPU: the
HnTaskManager task switches of the editor (ProcessSelection, the
coordinate grid, RenderBoundBox, the vector field, ComputeDepthBounds), a
debug view end to end, emit_aovs=False, vis_only, reset_taa and
suspend_super_sampling; and the still-pixel motion of the ext_skin
showroom (its MOTION_VECTORS view and vector field show that AOV).

Two jitted JAX execute frames at 128 x 64, their renderer fed the port's
IBL maps (tests/test_torch_material_ext.py jax_and_port_renderers); the
port takes the two-pass G-buffer route there, as the JAX package does on
the CPU.  Tolerances:
  * the components frame (emit_aovs=False): its colour above 60 dB
    against the JAX frame (the jitted JAX raster's FMAs move a few
    silhouette pixels, which the selection outline and the desaturation
    follow), equal on every pixel whose mesh id and depth agree but for
    the grid's and the bound box's threshold pixels; the depth range's
    NDC depths 1e-6 relative, its view distances 1e-4 (z = n f / (f - d
    (f - n)) multiplies a depth's last bit by (f - n) z / (n f), about 39
    here: 1.0e-5 measured); the same AOVs dropped;
  * the IRIDESCENCE view of every extension: above 60 dB, 1e-4 + 1e-4
    relative where the mesh ids agree;
  * vis_only's G-buffer against the JAX render_gbuffer(vis_only=True):
    the triangle ids on all but 0.5% of the pixels, and where they agree
    the depth-derived channels within 1e-4 (the jitted JAX raster's FMAs
    move the ground's depth by up to 4.2e-5);
  * reset_taa / suspend_super_sampling: exact;
  * the showroom's motion with the camera held, the JAX render_gbuffer
    (jitted) against the port's, two-pass, at 256 x 128: within 0.02 px on
    every still pixel whose mesh id agrees (0.0137 px measured).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRMaterialBasicAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.config import DebugViewType as JV
from diligentfx_tpu.gltf.primitives import plane, uv_sphere
from diligentfx_tpu.hydrogent import task_manager as jtm
from diligentfx_tpu.pbr import deferred as jd
from diligentfx_tpu.pbr.renderer import RenderInfo, build_scene
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.hydrogent import task_manager as ttm
from diligentfx_tpu_torch.pbr import deferred as td
from diligentfx_tpu_torch.utils.image import psnr
from tests.test_torch_material_ext import ext_scene, jax_and_port_renderers
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 128, 64
OFF = dict(enable_ssao=False, enable_ssr=False, enable_taa=False,
           enable_bloom=False)
EDITOR = jtm.TaskManagerCreateInfo(
    **OFF, enable_selection=True, enable_grid=True, enable_bound_box=True,
    enable_vector_field=True, enable_depth_bounds=True, emit_aovs=False)
SHADING_AOVS = ("normal_world", "normal_view", "base_color",
                "material_data", "world_pos", "direct", "ambient_diffuse",
                "ambient_specular", "spec_env_factor", "background", "debug")


def _info(eye=(0.0, 2.0, 6.0), target=(0.0, 0.5, 0.0)):
    cam = CameraAttribs.create(jm3.look_at(list(eye), list(target)),
                               jm3.perspective(0.8, W / H, 0.1, 50.0),
                               list(eye), 0.1, 50.0, W, H)
    return RenderInfo(camera=cam, lights=PBRLightAttribs.directional(
        [-0.3, -1.0, -0.2], [4.0, 4.0, 4.0]),
        renderer_params=PBRRendererShaderParameters.create())


@pytest.fixture(scope="module")
def setup():
    """tests/test_task_manager.py's scene (a sphere on a ground plane) at
    128 x 64, the JAX and the port's renderer on the same IBL maps.  The
    ground is cut into 8 x 8 quads: as two 20 m triangles it crosses the
    near plane, whose clip turns a last-bit difference of the two sides'
    clip coordinates into up to 5e-4 of barycentrics there (0.16 px of
    motion), which the vector field's colours follow."""
    ren, port = jax_and_port_renderers()
    lift = np.eye(4, dtype=np.float32)
    lift[3, 1] = 1.0
    gnode = np.eye(4, dtype=np.float32)
    gnode[3, 1] = -0.5
    scene = build_scene([
        (uv_sphere(0.8, stacks=10, slices=14), lift,
         PBRMaterialBasicAttribs.create(
             base_color_factor=(0.8, 0.2, 0.2, 1.0), metallic_factor=0.9,
             roughness_factor=0.2)),
        (plane(20.0, segments=8), gnode, PBRMaterialBasicAttribs.create(
            base_color_factor=(0.5, 0.5, 0.55, 1.0), metallic_factor=0.0,
            roughness_factor=0.15))])
    return ren, port, scene, _info()


def _settings():
    return jtm.FrameSettings(
        selected_ids=jnp.array([0, -1, -1, -1], jnp.int32),
        bound_box=jtm.BoundBoxParams(box_min=jnp.array([-0.8, 0.2, -0.8]),
                                     box_max=jnp.array([0.8, 1.8, 0.8])))


def _port_frame(port, ci, scene, info, settings=ttm.FrameSettings(),
                state=None, **kw):
    tm = ttm.HnTaskManager(port, ci)
    if state is None:
        state = tm.initial_state(W, H)
    return tm.execute(scene, info, state, width=W, height=H,
                      settings=settings, fuse="off", **kw)


def _moving_state(jt):
    """A second frame's state: the previous camera 0.3 m to the left, so
    the vector field draws real motion (a first frame's is rounding noise,
    whose segments point anywhere)."""
    prev = _info(eye=(-0.3, 2.0, 6.0)).camera.view_proj
    return jt.initial_state(W, H)._replace(frame_index=jnp.int32(1),
                                           prev_view_proj=prev)


@pytest.fixture(scope="module")
def components_frame(setup):
    """The components frame of tests/test_task_manager.py:203 (every
    overlay, the selection, the depth bounds) with emit_aovs=False, a
    second frame of a moving camera: the JAX frame and the port's."""
    ren, port, scene, info = setup
    jt = jtm.HnTaskManager(ren, EDITOR)
    state = _moving_state(jt)
    want = jt.execute(scene, info, state, width=W, height=H,
                      settings=_settings())
    got = _port_frame(port, cv.task_manager_ci_from_jax(EDITOR),
                      cv.scene_from_jax(scene), cv.render_info_from_jax(info),
                      cv.frame_settings_from_jax(_settings()),
                      state=cv.frame_state_from_jax(state))
    return want, got


def test_components_frame_matches_jax(setup, components_frame):
    """The port's editor frame against the JAX package's: the colour, the
    depth range, the mesh ids and depth, and the AOVs emit_aovs=False
    drops."""
    want, got = components_frame
    color, ref = got.color.numpy(), np.asarray(want.color)
    assert color.shape == (H, W, 3) and np.isfinite(color).all()
    p = psnr(ref, color)
    print(f"components frame: {p:.2f} dB against the JAX frame")
    assert p > 60.0, p
    jgb = want.gbuffer
    agree = ((np.asarray(jgb.mesh_id) == got.gbuffer.mesh_id.numpy())
             & (np.abs(np.asarray(jgb.depth) - got.gbuffer.depth.numpy())
                < 1e-5))
    assert agree.mean() > 0.99
    diff = np.abs(color - ref).max(-1)
    print(f"components frame: {(diff > 1e-4)[agree].sum()} agreeing pixels "
          f"differ by more than 1e-4 (the overlays' thresholds)")
    assert (diff > 1e-4)[agree].mean() < 5e-3
    ref_range = cv.depth_range_from_jax(want.depth_range)
    for f, rel in (("scene_near_depth", 1e-6), ("scene_far_depth", 1e-6),
                   ("scene_near_z", 1e-4), ("scene_far_z", 1e-4)):
        assert float(getattr(got.depth_range, f)) == pytest.approx(
            float(getattr(ref_range, f)), rel=rel), f
    dr = got.depth_range
    assert 0.0 < float(dr.scene_near_z) < float(dr.scene_far_z) <= 50.5
    for f in SHADING_AOVS:
        assert getattr(jgb, f) is None and getattr(got.gbuffer, f) is None, f
    for f in ("depth", "mesh_id", "motion", "hit"):
        assert getattr(got.gbuffer, f) is not None, f


def test_components_change_the_frame_and_emit_aovs(setup, components_frame):
    """The overlays change the frame (the JAX test's check); the
    emit_aovs=True frame's colour is bit-equal to the emit_aovs=False
    one's and keeps every AOV; the selected sphere keeps its colour where
    it shows and the ground is desaturated."""
    ren, port, scene, info = setup
    _, got = components_frame
    pscene, pinfo = cv.scene_from_jax(scene), cv.render_info_from_jax(info)
    settings = cv.frame_settings_from_jax(_settings())
    ci = cv.task_manager_ci_from_jax(EDITOR)
    state = cv.frame_state_from_jax(_moving_state(jtm.HnTaskManager(
        ren, EDITOR)))
    full = _port_frame(port, dataclasses.replace(ci, emit_aovs=True), pscene,
                       pinfo, settings, state=state)
    assert torch.equal(full.color, got.color)
    for f in SHADING_AOVS[:-1]:
        assert getattr(full.gbuffer, f) is not None, f
    base = _port_frame(port, cv.task_manager_ci_from_jax(
        jtm.TaskManagerCreateInfo(**OFF)), pscene, pinfo, state=state)
    assert float((full.color - base.color).abs().max()) > 0.05
    plain = _port_frame(port, dataclasses.replace(
        ci, enable_grid=False, enable_bound_box=False,
        enable_vector_field=False, emit_aovs=True), pscene, pinfo, settings,
        state=state)
    sphere = full.gbuffer.mesh_id == 0
    ground = full.gbuffer.mesh_id == 1
    inner = sphere.clone()
    for dy in (-4, 0, 4):          # away from the outline band
        for dx in (-4, 0, 4):
            inner &= torch.roll(sphere, (dy, dx), (0, 1))
    assert bool(inner.any())
    assert torch.equal(plain.color[inner], base.color[inner])

    def sat(c):
        return (c.max(-1).values - c.min(-1).values)
    assert float(sat(plain.color)[ground].mean()) < float(
        sat(base.color)[ground].mean())


def test_iridescence_view_frame_matches_jax(setup):
    """One debug view end to end (tests/test_task_manager.py:177's
    IRIDESCENCE) on a scene with every extension: the JAX frame against
    the port's; the view shows the spheres' thin-film Fresnel term and is
    zero off them."""
    ren, port, _, _ = setup
    scene, info = ext_scene("all")
    ci = jtm.TaskManagerCreateInfo(**OFF, view_mode=JV.IRIDESCENCE)
    jt = jtm.HnTaskManager(ren, ci)
    want = jt.execute(scene, info, jt.initial_state(W, H), width=W, height=H)
    got = _port_frame(port, cv.task_manager_ci_from_jax(ci),
                      cv.scene_from_jax(scene), cv.render_info_from_jax(info))
    color, ref = got.color.numpy(), np.asarray(want.color)
    p = psnr(ref, color)
    print(f"IRIDESCENCE view frame: {p:.2f} dB against the JAX frame")
    assert p > 60.0, p
    agree = np.asarray(want.gbuffer.mesh_id) == got.gbuffer.mesh_id.numpy()
    assert agree.mean() > 0.99
    err = np.abs(color - ref) > 1e-4 + 1e-4 * np.abs(ref)
    assert not err[agree].any()
    mid = got.gbuffer.mesh_id.numpy()
    assert np.abs(color[mid >= 0]).min(-1).max() > 0.05
    assert (color[mid < 0] == 0).all()
    assert got.gbuffer.debug is not None and len(got.gbuffer.debug) == 21


def test_vis_only_matches_jax(setup):
    """vis_only: render_gbuffer's visibility-only G-buffer (triangle ids,
    depth, the depth-derived channels) against the JAX package's; a
    vis_only frame runs the effects on it."""
    ren, port, scene, info = setup
    want = jd.render_gbuffer(scene, info, ren.ibl_maps, ren.env_oct,
                             width=W, height=H, cfg=ren.raster_cfg,
                             vis_only=True, fuse="off")
    pscene, pinfo = cv.scene_from_jax(scene), cv.render_info_from_jax(info)
    got = td.render_gbuffer(pscene, pinfo, port.ibl_maps, port.env_oct,
                            width=W, height=H, cfg=port.raster_cfg,
                            vis_only=True, fuse="off")
    assert got.debug is None
    tid, jtid = got.mesh_id.numpy(), np.asarray(want.mesh_id)
    agree = tid == jtid
    assert agree.mean() > 0.995 and (tid >= 0).mean() > 0.5
    for f in ("depth", "normal_world", "base_color", "motion", "background"):
        np.testing.assert_allclose(getattr(got, f).numpy()[agree],
                                   np.asarray(getattr(want, f))[agree],
                                   atol=1e-4, rtol=0, err_msg=f)
    fused = td.render_gbuffer(pscene, pinfo, port.ibl_maps, port.env_oct,
                              width=W, height=H, cfg=port.raster_cfg,
                              vis_only=True, fuse="on")
    assert torch.equal(fused.hit, got.hit)
    ci = dataclasses.replace(cv.task_manager_ci_from_jax(
        jtm.TaskManagerCreateInfo()), vis_only=True)
    out = _port_frame(port, ci, pscene, pinfo)
    assert np.isfinite(out.color.numpy()).all()


def test_reset_taa_matches_jax(setup):
    """reset_taa and suspend_super_sampling zero the TAA sample counts and
    keep the other temporal products, as the JAX package's do; a state
    without TAA passes through."""
    ren, port, _, _ = setup
    ci = jtm.TaskManagerCreateInfo()
    jt = jtm.HnTaskManager(ren, ci)
    rng = np.random.default_rng(12)
    js = jt.initial_state(W, H)
    js = js._replace(taa=js.taa._replace(
        sample_count=jnp.asarray(rng.integers(1, 16, (H, W)).astype(
            np.float32)),
        color=jnp.asarray(rng.random((H, W, 3)).astype(np.float32))))
    pt = ttm.HnTaskManager(port, cv.task_manager_ci_from_jax(ci))
    ps = cv.frame_state_from_jax(js)
    for j_fn, p_fn in ((jt.reset_taa, pt.reset_taa),
                       (jt.suspend_super_sampling,
                        pt.suspend_super_sampling)):
        want, got = j_fn(js), p_fn(ps)
        np.testing.assert_array_equal(got.taa.sample_count.numpy(),
                                      np.asarray(want.taa.sample_count))
        np.testing.assert_array_equal(got.taa.color.numpy(),
                                      np.asarray(want.taa.color))
        assert float(got.taa.sample_count.max()) == 0.0
        assert got.prev_depth is ps.prev_depth and got.ssr is ps.ssr
    no_taa = ps._replace(taa=None)
    assert pt.reset_taa(no_taa) is no_taa


# ---------------------------------------------------------------------------
# the still-pixel motion of the ext_skin showroom
# ---------------------------------------------------------------------------

SW, SH = 256, 128
# 0.1 px at 1920 px wide, at this width
STILL_PX = 0.1 * SW / 1920


def test_showroom_still_pixel_motion_matches_jax(tmp_path):
    """chip_smoke.py's ext_skin showroom (the atrium, two figures) at 256 x
    128, frame 5 of its animation and camera with the camera held
    (prev_view_proj = view_proj), through the JAX render_gbuffer and the
    port's on the two-pass route: the motion AOVs agree pixel by pixel,
    and the still pixels (off the figures) that carry motion carry it on
    both sides: the interpolation's rounding on thin triangles, which the
    JAX G-buffer shows too (a reference-side hazard, not a port fault)."""
    import chip_smoke as cs
    from diligentfx_tpu.config import RasterizerConfig
    from diligentfx_tpu.gltf import animation as janim
    from diligentfx_tpu.gltf import loader as jloader
    from diligentfx_tpu.gltf import model as jmodel
    from diligentfx_tpu_torch.pbr.renderer import default_env_oct
    path, meta = cs.ext_skin_glb(str(tmp_path / "showroom.glb"),
                                 n_figures=2, sphere=(12, 24), tube=(8, 2),
                                 normal_size=64)
    jm = jloader.load_gltf(path)
    rs = jmodel.build_render_scene(jm, texture_binding_mode="array")
    rs = jmodel.update_animation(rs, jm, janim.AnimationPlayer(
        jm, jm.animations), 5 / cs.EXT_FPS, 4 / cs.EXT_FPS)
    a = 5 * 0.02                       # chip_smoke.py full_chain_info(5)
    eye = [10.0 * np.sin(a), 2.0, 10.0 * np.cos(a)]
    cam = CameraAttribs.create(jm3.look_at(eye, [0, 1, 0]),
                               jm3.perspective(0.8, SW / SH, 0.1, 100.0),
                               eye, 0.1, 100.0, SW, SH)
    info = RenderInfo(camera=cam, lights=PBRLightAttribs.directional(
        cs.FULL_CHAIN_SUN, [4, 4, 4]),
        renderer_params=PBRRendererShaderParameters.create(),
        prev_view_proj=cam.view_proj)
    cfg = RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=16384,
                           max_tiles_per_tri=16, big_tri_capacity=256,
                           chunk=8, pair_compaction_cap=1 << 20, sub_bins=4,
                           big_tile_capacity=64)
    env = default_env_oct("cpu")
    kw = dict(width=SW, height=SH, use_ibl=False, use_textures=True,
              enable_clearcoat=True, fuse="off")
    got = td.render_gbuffer(cv.scene_from_jax(rs.scene),
                            cv.render_info_from_jax(info), None, env,
                            cfg=cv.raster_config_from_jax(cfg),
                            atlas=cv.heap_from_jax(rs.atlas), **kw)
    want = jax.tree.map(np.asarray, jd.render_gbuffer(
        rs.scene, info, None, jnp.asarray(env.numpy()), cfg=cfg,
        atlas=rs.atlas, **kw))
    np.testing.assert_array_equal(got.hit.numpy(), want.hit)
    mid = got.mesh_id.numpy()
    same = (mid == want.mesh_id) & want.hit
    assert same.mean() > 0.995 * want.hit.mean()
    figures = np.isin(mid, [rs.mesh_node_ids.index(n)
                            for n in meta["figure_nodes"]])
    still = same & ~figures
    px = np.array([SW, SH], np.float32)
    pm = np.linalg.norm(got.motion.numpy() * px, axis=-1)
    jm_ = np.linalg.norm(want.motion * px, axis=-1)
    dv = np.linalg.norm((got.motion.numpy() - want.motion) * px, axis=-1)
    p_set, j_set = still & (pm > STILL_PX), still & (jm_ > STILL_PX)
    print(f"showroom, camera held: {still.sum()} still pixels; above "
          f"{STILL_PX:.4f} px (0.1 px at 1080p) port {p_set.sum()} (max "
          f"{pm[still].max():.4f} px), JAX {j_set.sum()} (max "
          f"{jm_[still].max():.4f} px), both {(p_set & j_set).sum()}; "
          f"largest difference {dv[still].max():.4f} px")
    assert dv[still].max() <= 0.02
    assert p_set.any() and j_set.any() and (p_set & j_set).any()
    assert (pm[figures & same] > STILL_PX).mean() > 0.3
