"""Parity of the port's packed multi-light shadow atlas
(diligentfx_tpu_torch/components/shadow_atlas.py) with the JAX package's on
the CPU, and tests/test_shadow_atlas.py's cases on the port.

Tolerances: the allocator, the light order and the kinds are compared for
equality; view-projections within 1e-6 (exact fp32 products in the port,
XLA's HIGHEST-precision matmul in the JAX package); the rendered atlas,
coverage equal and depth within 1e-6 against the JAX raster run op by op
(tests/torch_shadow_ref.py); the atlas path against slices rendered and
packed by hand within 1e-5, the JAX package's own bound (the same
function on the same slices: measured equal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu.attribs import PBRLightAttribs as JLights
from diligentfx_tpu.components import shadow_atlas as jsa
from diligentfx_tpu.config import RasterizerConfig
from diligentfx_tpu.gltf.primitives import plane
from diligentfx_tpu.pbr.renderer import build_scene as jax_build_scene
from diligentfx_tpu.pbr.renderer import transform_vertices
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                          PBRMaterialBasicAttribs,
                                          PBRRendererShaderParameters)
from diligentfx_tpu_torch.components import shadow_atlas as tsa
from diligentfx_tpu_torch.components import shadow_map_manager as tsm
from diligentfx_tpu_torch.config import PBRRendererCreateInfo
from diligentfx_tpu_torch.gltf.primitives import plane as port_plane
from diligentfx_tpu_torch.pbr.deferred import render_gbuffer
from diligentfx_tpu_torch.pbr.renderer import (PBRRenderer, RenderInfo,
                                               build_scene,
                                               transform_vertices as ptv)
from tests.torch_shadow_ref import jax_light_maps_op_by_op
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = H = 128
S = 128
CFG = RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=256,
                       max_tiles_per_tri=16, big_tri_capacity=32, chunk=8)
PCFG = cv.raster_config_from_jax(CFG)
BMIN, BMAX = [-3.0, 0.0, -3.0], [3.0, 2.0, 3.0]


def _both(**kw):
    return jsa.ShadowAtlasManager(**kw), tsa.ShadowAtlasManager(**kw)


def _same_state(j, t):
    assert t.capacity == j.capacity and t.used_slices == j.used_slices
    assert t._free == j._free
    assert t.light_order() == j.light_order()
    assert t.light_shadow_kinds() == j.light_shadow_kinds()
    np.testing.assert_array_equal(t.light_order_slices(),
                                  j.light_order_slices())
    for lid in j.light_order():
        assert t.slices_of(lid) == j.slices_of(lid)


def test_allocator_matches_jax():
    """tests/test_shadow_atlas.py's allocation sequence on both managers:
    alloc, growth 4 -> 8 for a point light, free and reuse at the same
    capacity, the idempotent same-kind re-add, a kind change; every
    return value and the whole state equal after each step; the converter
    copies the state."""
    j, t = _both(slice_size=64, initial_slices=4, max_slices=32)
    steps = [("add", "spot0", "spot"), ("add", "dir0", "dir"),
             ("add", "p0", "point"), ("remove", "spot0"),
             ("add", "spot1", "spot"), ("add", "p0", "point"),
             ("add", "dir0", "spot"), ("remove", "nobody"),
             ("add", "p1", "point")]
    for op, *a in steps:
        if op == "add":
            assert t.add_light(*a) == j.add_light(*a), a
        else:
            assert t.remove_light(*a) is j.remove_light(*a) is None
        _same_state(j, t)
    assert t.capacity == 16 and t.slices_of("spot1") == [0]
    assert t.slices_of("dir0") == [1]
    _same_state(j, cv.shadow_atlas_from_jax(j))
    with pytest.raises(ValueError, match="unknown shadow kind"):
        t.add_light("x", "area")


def test_allocator_exhaustion():
    j, t = _both(slice_size=64, initial_slices=2, max_slices=4)
    for name in "abcd":
        assert t.add_light(name, "spot") == j.add_light(name, "spot")
    for m in (j, t):
        with pytest.raises(RuntimeError, match="exhausted"):
            m.add_light("e", "spot")
    _same_state(j, t)


def test_light_order_layout():
    j, t = _both(slice_size=64, initial_slices=16)
    for i, kind in enumerate(("dir", "spot", "point", "spot")):
        j.add_light(i, kind)
        t.add_light(i, kind)
    assert t.light_shadow_kinds() == ("dir", "spot", "point", "spot")
    assert t.light_order_slices().tolist() == list(range(9))
    _same_state(j, t)


def test_kinds_from_lights_matches_jax():
    args = [("directional", ([0, -1, 0], [1, 1, 1]), {}),
            ("point", ([0, 1, 0], [1, 1, 1]), dict(range=10.0)),
            ("spot", ([0, 2, 0], [0, -1, 0], [1, 1, 1]),
             dict(inner_cone_angle=0.3, outer_cone_angle=0.5, range=10.0)),
            ("point", ([1, 1, 0], [1, 1, 1]), {})]
    jl = JLights.concat([getattr(JLights, k)(*a, **kw) for k, a, kw in args])
    tl = PBRLightAttribs.concat([getattr(PBRLightAttribs, k)(*a, **kw)
                                 for k, a, kw in args])
    assert tsa.kinds_from_lights(tl) == jsa.kinds_from_lights(jl) == (
        "dir", "point", "spot", "point")


def _params():
    return {"dir": {"direction": [-0.4, -1.0, -0.3]},
            "spot": {"position": [1.5, 4.0, 1.0],
                     "direction": [-0.28, -0.93, -0.19], "outer_angle": 0.6,
                     "far": 30.0},
            "point": {"position": [0.0, 2.5, 1.5], "far": 30.0}}


def _scene_jax():
    """tests/test_shadow_atlas.py's floor with two floating occluders."""
    from diligentfx_tpu.attribs import PBRMaterialBasicAttribs as JMat
    mat = JMat.create(base_color_factor=(1, 1, 1, 1), roughness_factor=1.0)
    occ1 = np.eye(4, dtype=np.float32)
    occ1[3, :3] = [0.6, 1.0, 0.0]
    occ2 = np.eye(4, dtype=np.float32)
    occ2[3, :3] = [-0.8, 1.4, 0.4]
    return jax_build_scene(
        [(plane(6.0), np.eye(4, dtype=np.float32), mat),
         (plane(0.8), occ1, mat), (plane(0.7), occ2, mat)],
        double_sided_flags=[False, True, True])


def test_build_view_projs_and_render_match_jax():
    """A spot and a directional light in an atlas of four slices: the
    view-projections (identity on the two free slices) within 1e-6, and
    the rendered atlas, free slices included, against the JAX raster op
    by op; packed_for_lights picks the same slices in light order."""
    params = _params()
    j, t = _both(slice_size=S, initial_slices=4)
    for m in (j, t):
        m.add_light("spot", "spot")
        m.add_light("dir", "dir")
    jv = np.asarray(j.build_view_projs(params, BMIN, BMAX))
    tv = t.build_view_projs(params, BMIN, BMAX, device="cpu")
    assert tv.shape == (4, 4, 4)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-6)
    for free in (2, 3):
        assert torch.equal(tv[free], torch.eye(4))
    with pytest.raises(ValueError, match="bounds"):
        t.build_view_projs(params, device="cpu")

    scene = _scene_jax()
    wp, _, _ = transform_vertices(scene)
    maps = t.render(cv.tensor(wp), cv.tensor(scene.indices), tv, cfg=PCFG)
    ref = jax_light_maps_op_by_op(wp, scene.indices, jnp.asarray(tv.numpy()),
                                  S, CFG)
    assert maps.shape == (4, S, S)
    assert ((ref < 1.0).mean(axis=(1, 2))[:2] > 0.05).all()
    np.testing.assert_array_equal(maps.numpy() < 1.0, ref < 1.0)
    np.testing.assert_allclose(maps.numpy(), ref, rtol=0, atol=1e-6)

    pv, pm = t.packed_for_lights(tv, maps)
    jpv, jpm = j.packed_for_lights(jnp.asarray(tv.numpy()),
                                   jnp.asarray(maps.numpy()))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jpv))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jpm))


def test_directional_slice_covers_bounds():
    """Every point inside the bounds projects inside the ortho slice."""
    d = [0.3, -1.0, 0.2]
    bmin, bmax = [-2.0, 0.0, -1.0], [2.0, 3.0, 1.0]
    vp = tsa.directional_view_proj(d, bmin, bmax, device="cpu")
    rng = np.random.default_rng(0)
    pts = rng.uniform(bmin, bmax, size=(256, 3)).astype(np.float32)
    clip = m3.transform_points(torch.from_numpy(pts), vp).numpy()
    ndc = clip[:, :3] / clip[:, 3:4]
    assert (np.abs(ndc[:, :2]) <= 1.0 + 1e-4).all()
    assert (ndc[:, 2] >= -1e-4).all() and (ndc[:, 2] <= 1.0 + 1e-4).all()


def test_atlas_five_lights_matches_per_light_reference():
    """tests/test_shadow_atlas.py's frame on the port: one directional,
    three spot and one point light, all shadow-casting, through one packed
    atlas of four slices grown to 16 (slices out of light order), against
    the same slices rendered and packed by hand: the direct light within
    1e-5; the shadows darken and never brighten."""
    mat = PBRMaterialBasicAttribs.create(base_color_factor=(1, 1, 1, 1),
                                         roughness_factor=1.0)
    occ1 = np.eye(4, dtype=np.float32)
    occ1[3, :3] = [0.6, 1.0, 0.0]
    occ2 = np.eye(4, dtype=np.float32)
    occ2[3, :3] = [-0.8, 1.4, 0.4]
    scene = build_scene([(port_plane(6.0), np.eye(4, dtype=np.float32), mat),
                         (port_plane(0.8), occ1, mat),
                         (port_plane(0.7), occ2, mat)],
                        double_sided_flags=[False, True, True], device="cpu")
    wp, _, _ = ptv(scene)
    spots = [dict(position=[1.5, 4.0, 1.0], direction=[-0.3, -1.0, -0.2],
                  outer_angle=0.6, far=30.0),
             dict(position=[-2.0, 3.5, 0.5], direction=[0.4, -1.0, 0.0],
                  outer_angle=0.5, far=30.0),
             dict(position=[0.0, 4.5, -2.0], direction=[0.0, -1.0, 0.6],
                  outer_angle=0.7, far=30.0)]
    for sp in spots:
        d = np.asarray(sp["direction"], np.float32)
        sp["direction"] = (d / np.linalg.norm(d)).tolist()
    dir_d = [-0.4, -1.0, -0.3]
    point = {"position": [0.0, 2.5, 1.5], "far": 30.0}
    lights = PBRLightAttribs.concat(
        [PBRLightAttribs.directional(dir_d, [2.0, 2.0, 2.0], device="cpu")]
        + [PBRLightAttribs.spot(sp["position"], sp["direction"],
                                [6.0, 6.0, 6.0], sp["outer_angle"] * 0.6,
                                sp["outer_angle"], range=30.0, device="cpu")
           for sp in spots]
        + [PBRLightAttribs.point(point["position"], [5.0, 5.0, 5.0],
                                 range=30.0, device="cpu")])
    lights = lights._replace(shadow_map_index=torch.arange(
        lights.count, dtype=torch.int32))

    atlas = tsa.ShadowAtlasManager(slice_size=S, initial_slices=4,
                                   max_slices=32)
    atlas.add_light("tmp", "spot")
    atlas.add_light("dir", "dir")
    for i in range(3):
        atlas.add_light(f"spot{i}", "spot")
    atlas.add_light("point", "point")
    atlas.remove_light("tmp")
    kinds = atlas.light_shadow_kinds()
    assert kinds == ("dir", "spot", "spot", "spot", "point")
    assert atlas.capacity == 16 and atlas.light_order_slices()[0] == 1
    params = {"dir": {"direction": dir_d}, "point": point,
              **{f"spot{i}": sp for i, sp in enumerate(spots)}}
    vps = atlas.build_view_projs(params, BMIN, BMAX, device="cpu")
    maps = atlas.render(wp, scene.indices, vps, cfg=PCFG)
    pv, pm = atlas.packed_for_lights(vps, maps)

    eye = [0.0, 3.0, 4.0]
    cam = CameraAttribs.create(m3.look_at(eye, [0, 0, 0]),
                               m3.perspective(0.9, 1.0, 0.1, 30.0), eye,
                               0.1, 30.0, W, H, device="cpu")
    info = RenderInfo(camera=cam, lights=lights,
                      renderer_params=PBRRendererShaderParameters.create(
                          device="cpu"),
                      light_shadow_maps=pm, light_shadow_view_projs=pv)
    ren = PBRRenderer(PBRRendererCreateInfo(
        brdf_lut_dim=16, num_brdf_samples=8, irradiance_cube_dim=16,
        prefiltered_env_map_dim=16, num_specular_env_samples=8),
        raster_cfg=PCFG, device="cpu")

    def direct(info_, kinds_):
        return render_gbuffer(scene, info_, ren.ibl_maps, ren.env_oct,
                              width=W, height=H, cfg=PCFG, use_ibl=False,
                              light_shadow_kinds=kinds_).direct.numpy()

    ref_vps = torch.cat([
        tsa.directional_view_proj(dir_d, BMIN, BMAX, device="cpu")[None],
        torch.stack([tsm.spot_view_proj(sp["position"], sp["direction"],
                                        sp["outer_angle"], far=30.0,
                                        device="cpu") for sp in spots]),
        tsm.point_view_projs(point["position"], far=30.0, device="cpu")])
    ref_maps = tsm.render_light_shadow_maps(wp, scene.indices, ref_vps,
                                            shadow_map_size=S, cfg=PCFG)
    got = direct(info, kinds)
    want = direct(info._replace(light_shadow_maps=ref_maps,
                                light_shadow_view_projs=ref_vps), kinds)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    lit = direct(info._replace(light_shadow_maps=None,
                               light_shadow_view_projs=None), ())
    assert (lit - got).max() > 0.05
    assert (got <= lit + 1e-4).all()
