"""Parity of the port's per-light shadows (the spot / point half of
diligentfx_tpu_torch/components/shadow_map_manager.py and the per-light
dispatch of pbr/deferred.py) with the JAX package on the CPU.

Scenes: tests/test_light_shadows.py's floor and occluder (128 x 128, 8 x
128 tiles) for the slices, and tests/test_shadow_atlas.py's floor with two
occluders for the dispatch, lit by a cascaded sun, a spot, a point light,
a single-slice directional light and an unshadowed point light.

Tolerances and their causes:
  * view-projections: 1e-6 (the port multiplies the 4 x 4 products in
    exact fp32 order; XLA's HIGHEST-precision matmul may sum otherwise);
  * cube faces: exact, ties included;
  * slice depth maps: coverage equal and depth within 1e-6 against the
    JAX raster run op by op (tests/torch_shadow_ref.py; a jitted raster
    contracts the plane evaluations into FMAs, which near-clipped
    triangles' huge coefficients turn into depth errors of 0.1);
  * sample_light_shadow: 1e-5 against the JAX function run eagerly (the
    JAX package projects through an einsum, the port row by row);
  * render_gbuffer's direct light with every kind: 1e-4 + 1e-4 relative
    against the JAX package's _shade_band run eagerly on the port's own
    visibility (fused and two-pass), where only the projection and the
    shading order differ;
  * execute with a spot shadow and the texture heap: 90 dB against the
    JAX frame (compiled: its raster's FMAs move edge pixels; measured
    103.6 dB), and the shadow changes the image as in the JAX package's
    test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRMaterialBasicAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.components import shadow_atlas as jsa
from diligentfx_tpu.components import shadow_map_manager as jsm
from diligentfx_tpu.config import (PBRRendererCreateInfo, RasterizerConfig,
                                    ShadowMode)
from diligentfx_tpu.gltf.primitives import plane
from diligentfx_tpu.pbr import deferred as jd
from diligentfx_tpu.pbr.renderer import (PBRRenderer, RenderInfo,
                                         build_scene, transform_vertices)
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.components import shadow_atlas as tsa
from diligentfx_tpu_torch.components import shadow_map_manager as tsm
from diligentfx_tpu_torch.config import PBRRendererCreateInfo as PortCI
from diligentfx_tpu_torch.config import ShadowMode as PortMode
from diligentfx_tpu_torch.ops.raster_tiles import raster_tiles
from diligentfx_tpu_torch.pbr import deferred as td
from diligentfx_tpu_torch.pbr.renderer import PBRRenderer as PortRenderer
from tests.torch_shadow_ref import jax_light_maps_op_by_op
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = H = 128
S = 128
CFG = RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=256,
                       max_tiles_per_tri=16, big_tri_capacity=32, chunk=8)
PCFG = cv.raster_config_from_jax(CFG)
CI = PBRRendererCreateInfo(brdf_lut_dim=16, num_brdf_samples=8,
                           irradiance_cube_dim=16, prefiltered_env_map_dim=16,
                           num_specular_env_samples=8)
SPOT = dict(position=[0.0, 4.0, 0.0], direction=[0.0, -1.0, 0.0],
            outer_angle=0.9, near=0.1, far=20.0)
POINT = dict(position=[0.3, 1.6, 0.2], near=0.1, far=30.0)
SUN = [-0.4, -1.0, -0.3]
KINDS = ("csm", "spot", "point", "dir", "none")


def _t(x):
    return cv.tensor(x)


def _floor_occluder():
    """tests/test_light_shadows.py's scene: a 6 m floor at y = 0 and a
    double-sided 0.8 m occluder at y = 1."""
    mat = PBRMaterialBasicAttribs.create(base_color_factor=(1, 1, 1, 1),
                                         roughness_factor=1.0)
    occ_m = np.eye(4, dtype=np.float32)
    occ_m[3, 1] = 1.0
    return build_scene([(plane(6.0), np.eye(4, dtype=np.float32), mat),
                        (plane(0.8), occ_m, mat)],
                       double_sided_flags=[False, True])


def _floor_two_occluders():
    """tests/test_shadow_atlas.py's scene: the floor and two floating
    occluder quads."""
    mat = PBRMaterialBasicAttribs.create(base_color_factor=(1, 1, 1, 1),
                                         roughness_factor=1.0)
    occ1 = np.eye(4, dtype=np.float32)
    occ1[3, :3] = [0.6, 1.0, 0.0]
    occ2 = np.eye(4, dtype=np.float32)
    occ2[3, :3] = [-0.8, 1.4, 0.4]
    return build_scene(
        [(plane(6.0, segments=4), np.eye(4, dtype=np.float32), mat),
         (plane(0.8), occ1, mat), (plane(0.7), occ2, mat)],
        double_sided_flags=[False, True, True])


def _camera():
    eye = [0.0, 3.0, 4.0]
    return CameraAttribs.create(jm3.look_at(eye, [0, 0, 0]),
                                jm3.perspective(0.9, 1.0, 0.1, 30.0), eye,
                                0.1, 30.0, W, H)


def _slice_view_projs():
    """The spot's slice and the point light's six faces, (7, 4, 4)."""
    return jnp.concatenate([
        jsm.spot_view_proj(SPOT["position"], SPOT["direction"],
                           SPOT["outer_angle"], near=SPOT["near"],
                           far=SPOT["far"])[None],
        jsm.point_view_projs(POINT["position"], near=POINT["near"],
                             far=POINT["far"])])


def test_view_projs_match_jax():
    """spot_view_proj, point_view_projs (the +-Y faces on look_at's
    fallback up vector) and directional_view_proj: within 1e-6."""
    rng = np.random.default_rng(0)
    for _ in range(3):
        pos = rng.uniform(-3, 3, 3).astype(np.float32)
        d = rng.normal(size=3).astype(np.float32)
        d /= np.linalg.norm(d)
        ang = float(rng.uniform(0.2, 1.2))
        a = jsm.spot_view_proj(pos, d, ang, near=0.05, far=50.0)
        b = tsm.spot_view_proj(pos, d, ang, near=0.05, far=50.0,
                               device="cpu")
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
        a = jsm.point_view_projs(pos, near=0.1, far=40.0)
        b = tsm.point_view_projs(pos, near=0.1, far=40.0, device="cpu")
        assert b.shape == (6, 4, 4)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
        bmin = rng.uniform(-3, 0, 3)
        bmax = bmin + rng.uniform(0.5, 4, 3)
        a = jsa.directional_view_proj(jnp.asarray(d), bmin, bmax)
        b = tsa.directional_view_proj(d, bmin, bmax, device="cpu")
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    # straight down: look_at's degenerate up vector
    a = jsm.spot_view_proj([0, 4, 0], [0, -1, 0], 0.9)
    b = tsm.spot_view_proj([0, 4, 0], [0, -1, 0], 0.9, device="cpu")
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_point_shadow_face_matches_jax():
    """Dominant axis and sign, exactly, on random vectors and on ties
    (|x| = |y|, |y| = |z|, all equal, zero): the first axis wins."""
    rng = np.random.default_rng(1)
    v = rng.normal(size=(500, 3)).astype(np.float32)
    ties = np.array([[1, 1, 0], [-1, 1, 0], [1, -1, 0.5], [0, 2, 2],
                     [0, -2, -2], [3, 3, 3], [-3, 3, -3], [0, 0, 0],
                     [0, 0, -1], [-0.0, 0, 0], [2, 0, -2], [-2, 0, 2]],
                    np.float32)
    v = np.concatenate([v, ties, np.round(v * 2) / 2])
    want = np.asarray(jsm.point_shadow_face(jnp.asarray(v)))
    got = tsm.point_shadow_face(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[500:506], [0, 1, 0, 2, 3, 0])


def test_render_light_shadow_maps_matches_jax():
    """The spot's slice and all six cube faces of the point light on the
    floor and occluder: coverage equal, depth within 1e-6 against the JAX
    raster op by op; the CPU launches no kernel."""
    scene = _floor_occluder()
    wp, _, _ = transform_vertices(scene)
    vps = _slice_view_projs()
    before = raster_tiles.launches
    maps = tsm.render_light_shadow_maps(_t(wp), _t(scene.indices),
                                        _t(vps), shadow_map_size=S,
                                        cfg=PCFG).numpy()
    assert raster_tiles.launches == before
    ref = jax_light_maps_op_by_op(wp, scene.indices, vps, S, CFG)
    assert maps.shape == (7, S, S)
    cover = (ref < 1.0).mean(axis=(1, 2))
    # the spot and five faces see casters; +Y looks at the empty sky
    assert (cover[[0, 1, 2, 4, 5, 6]] > 0.1).all() and cover[3] == 0.0
    np.testing.assert_array_equal(maps < 1.0, ref < 1.0)
    np.testing.assert_allclose(maps, ref, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def point_maps():
    """The point light's faces on the floor and occluder (the JAX raster,
    jitted: both samplers read the same maps)."""
    scene = _floor_occluder()
    wp, _, _ = transform_vertices(scene)
    vps = _slice_view_projs()
    maps = jsm.render_light_shadow_maps(wp, scene.indices, vps,
                                        shadow_map_size=S, cfg=CFG)
    return np.asarray(vps), np.asarray(maps)


@pytest.mark.parametrize("light", ["spot", "point"])
def test_sample_light_shadow_matches_jax(point_maps, light):
    """Points on and above the floor, inside and outside the slices'
    frusta: the shadow factor within 1e-5 of the JAX function run
    eagerly; both lit and shadowed points occur."""
    vps, maps = point_maps
    rng = np.random.default_rng(2)
    pos = rng.uniform([-1.5, -0.01, -1.5], [1.5, 0.9, 1.5],
                      (40, 50, 3)).astype(np.float32)
    pos[::2, :, 1] = 0.0                       # half the rows on the floor
    pos[1::8, :, 1] = 5.0                      # above the lights
    if light == "spot":
        sl, face = slice(0, 1), None
    else:
        sl = slice(1, 7)
        face = np.array(jsm.point_shadow_face(
            jnp.asarray(pos - np.asarray(POINT["position"], np.float32))))
    with jax.disable_jit():
        a = np.asarray(jsm.sample_light_shadow(
            jnp.asarray(pos), jnp.asarray(vps[sl]), jnp.asarray(maps[sl]),
            face_idx=None if face is None else jnp.asarray(face)))
    b = tsm.sample_light_shadow(
        torch.from_numpy(pos), torch.from_numpy(vps[sl].copy()),
        torch.from_numpy(maps[sl].copy()),
        face_idx=None if face is None else torch.from_numpy(face)).numpy()
    assert b.shape == (40, 50)
    assert (b < 0.5).mean() > 0.02 and (b == 1.0).mean() > 0.2
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def _dispatch_info():
    """Five lights (a cascaded sun, a spot, a point light, a single-slice
    directional light, a point light of kind "none"), the camera, the sun's
    two cascades and the 1 + 6 + 1 slices in light order; JAX objects."""
    scene = _floor_two_occluders()
    wp, _, _ = transform_vertices(scene)
    cam = _camera()
    lights = PBRLightAttribs.concat([
        PBRLightAttribs.directional(SUN, [2.0, 2.0, 2.0], shadow_map_index=0),
        PBRLightAttribs.spot(SPOT["position"], SPOT["direction"],
                             [20.0, 20.0, 20.0], 0.5, SPOT["outer_angle"],
                             range=20.0),
        PBRLightAttribs.point(POINT["position"], [6.0, 6.0, 6.0], range=30.0),
        PBRLightAttribs.directional([0.5, -1.0, 0.2], [1.0, 1.0, 1.0]),
        PBRLightAttribs.point([1.5, 2.0, 1.5], [3.0, 3.0, 3.0], range=30.0)])
    # a light's shadow factor applies where its shadow map index is >= 0
    lights = lights.replace(
        shadow_map_index=jnp.arange(lights.count, dtype=jnp.int32))
    att = jsm.distribute_cascades(cam.view, jm3.inverse(cam.view),
                                  float(cam.proj[0, 0]),
                                  float(cam.proj[1, 1]), 0.1, 30.0, SUN,
                                  num_cascades=2, shadow_map_size=S)
    atlas = jsa.ShadowAtlasManager(slice_size=S, initial_slices=8)
    for name, kind in (("spot", "spot"), ("point", "point"), ("dir", "dir")):
        atlas.add_light(name, kind)
    vps = atlas.build_view_projs(
        {"spot": SPOT, "point": POINT,
         "dir": {"direction": jm3.normalize(jnp.asarray([0.5, -1.0, 0.2]))}},
        bounds_min=[-3.0, 0.0, -3.0], bounds_max=[3.0, 2.0, 3.0])
    # both sides sample the same maps: the port's raster renders them (the
    # CPU runs its plain K4 in milliseconds; test_render_light_shadow_maps
    # holds it against the JAX raster)
    twp, tidx = _t(wp), _t(scene.indices)
    cmaps = tsm.render_cascade_shadow_maps(
        twp, tidx, cv.shadow_attribs_from_jax(att), shadow_map_size=S,
        cfg=PCFG).numpy()
    maps = tsm.render_light_shadow_maps(twp, tidx, _t(vps),
                                        shadow_map_size=S, cfg=PCFG).numpy()
    pv, pm = atlas.packed_for_lights(vps, jnp.asarray(maps))
    info = RenderInfo(camera=cam, lights=lights,
                      renderer_params=PBRRendererShaderParameters.create(),
                      shadow_attribs=att, shadow_maps=jnp.asarray(cmaps),
                      light_shadow_maps=pm, light_shadow_view_projs=pv)
    return scene, info


@pytest.fixture(scope="module")
def renderers():
    """The JAX renderer (small IBL) and the port's with its IBL maps."""
    ren = PBRRenderer(CI, raster_cfg=CFG)
    return ren, PortRenderer(PortCI(), raster_cfg=PCFG, device="cpu",
                             env_oct=_t(ren.env_oct),
                             ibl_maps=cv.ibl_maps_from_jax(ren.ibl_maps))


@pytest.fixture(scope="module")
def dispatch(renderers):
    scene, info = _dispatch_info()
    ren, port = renderers
    return dict(scene=scene, info=info, ren=ren, port=port,
                pscene=cv.scene_from_jax(scene),
                pinfo=cv.render_info_from_jax(info))


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_gbuffer_light_dispatch_matches_jax(dispatch, fuse):
    """render_gbuffer with the kinds csm, spot, point, dir and none, on the
    fused route (K1's plain version) and the two-pass route (K4's): the
    direct light against the JAX package's _shade_band, run eagerly on
    the port's own visibility (fused channels or barycentrics), within
    1e-4 + 1e-4 relative; each shadowed light darkens part of the floor
    and the unshadowed light does not, so every kind is exercised."""
    g = dispatch
    kw = dict(width=W, height=H, cfg=PCFG, use_ibl=False,
              shadow_mode=PortMode.PCF, fuse=fuse)
    args = (g["pscene"], g["pinfo"], g["port"].ibl_maps, g["port"].env_oct)
    pgb = td.render_gbuffer(*args, light_shadow_kinds=KINDS, **kw)
    if fuse == "on":
        vb, fused_px, _ = td._fused_raster(g["pscene"], g["pinfo"], pad_w=W,
                                           pad_h=H, cfg=PCFG,
                                           use_textures=False)
        clip = winv = None
        fused = jnp.asarray(fused_px.numpy())
    else:
        vb, clip, winv, _ = td._two_pass_raster(
            g["pscene"], g["pinfo"], pad_w=W, pad_h=H, cfg=PCFG, atlas=None,
            use_textures=False)
        clip, winv, fused = (jnp.asarray(clip.numpy()),
                             jnp.asarray(winv.numpy()), None)
    from diligentfx_tpu.ops import raster as jr
    jvb = jr.VisibilityBuffer(depth=jnp.asarray(vb.depth.numpy()),
                              tri_id=jnp.asarray(vb.tri_id.numpy()),
                              bary=jnp.asarray(vb.bary.numpy())
                              if vb.bary is not None
                              else jnp.zeros((H, W, 2)))
    ren = g["ren"]
    with jax.disable_jit():
        jgb = jd._shade_band(
            g["scene"], g["info"], ren.ibl_maps, ren.env_oct, jvb, clip,
            winv, jnp.int32(0), band_h=H, pad_w=W, pad_h=H, use_ibl=False,
            use_lights=True, shadow_mode=ShadowMode.PCF, pcf_kernel_size=3,
            atlas=None, use_textures=False, enable_clearcoat=False,
            fast_env=False, light_shadow_kinds=KINDS, fused_px=fused)
    hit = np.asarray(jgb.hit)
    np.testing.assert_array_equal(pgb.hit.numpy(), hit)
    assert 0.5 < hit.mean() < 1.0
    x = np.asarray(jgb.direct)[hit]
    y = pgb.direct.numpy()[hit]
    np.testing.assert_allclose(y, x, atol=1e-4, rtol=1e-4)
    # each kind on its own: the shadowed lights darken, "none" does not
    pos = pgb.world_pos[torch.from_numpy(hit.copy())]
    info = g["pinfo"]
    fac = tsm.light_shadow_factors(pos, info, KINDS, PortMode.PCF)
    assert fac.shape == (5, pos.shape[0])
    for i, kind in enumerate(KINDS):
        dark = float((fac[i] < 0.5).float().mean())
        assert (dark > 0.005) == (kind != "none"), (kind, dark)
    # without kinds the cascaded factor shades every light
    plain = td.render_gbuffer(*args, **kw)
    assert not torch.equal(plain.direct, pgb.direct)


def test_light_dispatch_needs_slices(dispatch):
    """Per-light kinds without the slices raise instead of shading lit."""
    g = dispatch
    info = g["pinfo"]._replace(light_shadow_maps=None)
    pos = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="light_shadow_maps"):
        tsm.light_shadow_factors(pos, info, ("spot",), None)
    fac = tsm.light_shadow_factors(pos, info, ("none", "csm"), None)
    assert torch.equal(fac, torch.ones((5, 4)))


def _heap_floor_gltf(path):
    """A glTF of a textured floor (a 48 x 40 RGB texture, REPEAT, uv scaled
    by 3 through KHR_texture_transform) and a double-sided occluder quad
    above it."""
    from tests.test_torch_gltf import grid_quad, placed, write_gltf
    floor = placed(grid_quad(4, 4, 6.0, 6.0), [0.0, 0.0, 0.0], -np.pi / 2)
    occ = placed(grid_quad(1, 1, 0.9, 0.9), [0.0, 1.0, 0.0], -np.pi / 2)
    rng = np.random.default_rng(4)
    tex = rng.integers(60, 256, (40, 48, 4), dtype=np.uint8)
    tex[..., 3] = 255
    materials = [
        {"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0, "extensions": {
                "KHR_texture_transform": {"scale": [3.0, 3.0]}}},
            "metallicFactor": 0.0, "roughnessFactor": 0.9}},
        {"doubleSided": True, "pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.8, 0.8, 1.0], "metallicFactor": 0.0,
            "roughnessFactor": 0.9}}]
    return write_gltf(path, [dict(floor, material=0), dict(occ, material=1)],
                      materials, images=[tex])


def test_execute_spot_shadow_with_heap_matches_jax(renderers, tmp_path):
    """HnTaskManager.execute with light_shadow_kinds=("spot",) on a scene
    whose textures are bound as a texture heap (build_render_scene
    "array"): 90 dB against the JAX frame, and the shadow changes the
    image (tests/test_light_shadows.py's check)."""
    from diligentfx_tpu.gltf import loader as jloader
    from diligentfx_tpu.gltf import model as jmodel
    from diligentfx_tpu.hydrogent.task_manager import (HnTaskManager,
                                                       TaskManagerCreateInfo)
    from diligentfx_tpu.ops.texture import TextureHeap
    from diligentfx_tpu_torch.hydrogent import task_manager as ttm
    from diligentfx_tpu_torch.utils.image import psnr
    rs = jmodel.build_render_scene(
        jloader.load_gltf(_heap_floor_gltf(str(tmp_path / "floor.gltf"))),
        texture_binding_mode="array")
    assert isinstance(rs.atlas, TextureHeap)
    wp, _, _ = transform_vertices(rs.scene)
    vp = jsm.spot_view_proj(SPOT["position"], SPOT["direction"],
                            SPOT["outer_angle"], near=SPOT["near"],
                            far=SPOT["far"])[None]
    maps = jnp.asarray(tsm.render_light_shadow_maps(
        _t(wp), _t(rs.scene.indices), _t(vp), shadow_map_size=S,
        cfg=PCFG).numpy())
    lights = PBRLightAttribs.spot(SPOT["position"], SPOT["direction"],
                                  [30.0, 30.0, 30.0], 0.4, 0.9, range=20.0,
                                  shadow_map_index=0)
    info = RenderInfo(camera=_camera(), lights=lights,
                      renderer_params=PBRRendererShaderParameters.create(),
                      light_shadow_maps=maps, light_shadow_view_projs=vp)
    ci = TaskManagerCreateInfo(enable_ssao=False, enable_ssr=False,
                               enable_taa=False, enable_bloom=False)
    ren, port = renderers
    jtm = HnTaskManager(ren, ci, atlas=rs.atlas)
    want = np.asarray(jtm.execute(rs.scene, info, jtm.initial_state(W, H),
                                  width=W, height=H,
                                  light_shadow_kinds=("spot",)).color)
    ptm = ttm.HnTaskManager(port, cv.task_manager_ci_from_jax(ci),
                            atlas=cv.heap_from_jax(rs.atlas))
    pscene, pinfo = cv.scene_from_jax(rs.scene), cv.render_info_from_jax(info)
    got = ptm.execute(pscene, pinfo, ptm.initial_state(W, H), width=W,
                      height=H, light_shadow_kinds=("spot",)).color.numpy()
    unshadowed = ptm.execute(pscene, pinfo, ptm.initial_state(W, H),
                             width=W, height=H).color.numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert psnr(want, got) > 90.0, psnr(want, got)
    assert np.abs(got - unshadowed).max() > 0.02
