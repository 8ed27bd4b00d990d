"""The G-buffer in row bands in the port (pbr/deferred.py `_shade_band`'s
band form, `_raster_stage`, `render_gbuffer_banded`,
`render_gbuffer_band_sp`) against the whole-frame G-buffer and the JAX
package, on the bench.py --smoke scene at 256 x 128 in 32 x 128 tiles.

Against the port's whole frame: bit-equal.  Shading is pixel-local, and
the band's rows use the frame's global rows for the motion, the camera
rays and the position from depth; a band's viewport raster
(render_gbuffer_band_sp) rasterizes the frame's global triangle setup at
an integer pixel offset, so it finds the same winners at the same depths.

Against the JAX package: the two-pass route on both sides (the port with
fuse="off"; the JAX package's "auto" does not fuse on the CPU), its
compiled programs.  XLA contracts multiply-adds there, so on pixels where
both sides show the same mesh the fields are held to
tests/test_torch_frame.py's GB_TOL (world position interpolated on this
route, its barycentrics rounded another way: 5e-4, where 4 of 55,932
values passed 1e-4 and the largest difference was 3.6e-4), at most 0.5%
of the pixels showing another mesh.
"""
import numpy as np
import pytest
import torch

import bench
from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.config import RasterizerConfig
from diligentfx_tpu.pbr import deferred as jd
from diligentfx_tpu.pbr.renderer import RenderInfo
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.ops.raster_kernel import raster_tiles_fused
from diligentfx_tpu_torch.ops.raster_tiles import raster_tiles
from diligentfx_tpu_torch.pbr import deferred as td
from tests.test_torch_frame import GB_TOL
from tests.test_torch_gltf import mixed_scene
from tests.test_torch_material_ext import jax_and_port_renderers
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 256, 128
CFG = RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=1024,
                       max_tiles_per_tri=8, big_tri_capacity=64, chunk=8)
PCFG = cv.raster_config_from_jax(CFG)
ROUTES = {"fused": "on", "two_pass": "off"}


def _info(w=W, h=H):
    eye = [0.0, 1.0, 7.5]
    cam = CameraAttribs.create(jm3.look_at(eye, [0.0, 0.0, 0.0]),
                               jm3.perspective(0.7, w / h, 0.1, 100.0), eye,
                               0.1, 100.0, w, h)
    lights = PBRLightAttribs.concat([
        PBRLightAttribs.directional([-0.5, -0.7, -0.5], [3.0, 3.0, 3.0]),
        PBRLightAttribs.point([2.0, 2.0, 2.0], [8.0, 7.0, 6.0], range=30.0)])
    return RenderInfo(camera=cam, lights=lights,
                      renderer_params=PBRRendererShaderParameters.create())


@pytest.fixture(scope="module")
def setup():
    ren, port = jax_and_port_renderers()
    scene = bench.build_bench_scene(2, 2, 12)
    return dict(ren=ren, port=port, scene=scene,
                pscene=cv.scene_from_jax(scene), info=_info(),
                pinfo=cv.render_info_from_jax(_info()))


def _args(g):
    return (g["pscene"], g["pinfo"], g["port"].ibl_maps, g["port"].env_oct)


def _assert_gbuffers_equal(a, b, rows=slice(None)):
    for f in td.GBufferData._fields:
        x = getattr(a, f)
        if x is not None:
            assert torch.equal(x[rows], getattr(b, f)), f


def _assert_close_to_jax(pgb, jgb):
    """GB_TOL on the pixels where both sides show the same mesh."""
    jid, pid = np.asarray(jgb.mesh_id), pgb.mesh_id.numpy()
    same = jid == pid
    assert same.mean() >= 0.995, same.mean()
    hit = same & (jid >= 0)
    for name, (atol, rtol) in {**GB_TOL, "world_pos": (5e-4, 0.0)}.items():
        x = np.asarray(getattr(jgb, name))[hit]
        y = getattr(pgb, name).numpy()[hit]
        np.testing.assert_allclose(y, x, atol=atol, rtol=rtol, err_msg=name)
    np.testing.assert_allclose(pgb.background.numpy(),
                               np.asarray(jgb.background), atol=1e-2)


@pytest.mark.parametrize("route", list(ROUTES))
def test_shade_band_rows_equal_whole_frame(setup, route):
    """_shade_band on rows [row0, row0 + band_h) of one raster, on both
    routes: the same rows of the whole frame's shading."""
    g = setup
    scene, info, ibl, env = _args(g)
    vb, fused_px, two_pass = td._raster_stage(
        scene, info, None, pad_w=W, pad_h=H, cfg=PCFG, use_textures=False,
        fuse=ROUTES[route])
    assert (fused_px is None) == (route == "two_pass")
    kw = dict(pad_w=W, pad_h=H, use_ibl=True, use_lights=True,
              fast_env=False, two_pass=two_pass)
    whole = td._shade_band(scene, info, ibl, env, vb, fused_px, **kw)
    for row0, band_h in ((0, 32), (32, 32), (64, 64), (96, 32)):
        band = td._shade_band(scene, info, ibl, env, vb, fused_px,
                              row0=row0, band_h=band_h, **kw)
        _assert_gbuffers_equal(whole, band, slice(row0, row0 + band_h))


@pytest.mark.parametrize("bands", [1, 2, 4, 3])
def test_gbuffer_banded_matches_jax(setup, bands):
    """render_gbuffer_banded on the two-pass route against the JAX
    package's; 3 bands drop to 2 (128 rows, the `while` loop), and every
    count equals the port's render_gbuffer bit for bit."""
    g = setup
    k4 = raster_tiles.launches
    pgb = td.render_gbuffer_banded(*_args(g), width=W, height=H, cfg=PCFG,
                                   bands=bands, fuse="off")
    assert raster_tiles.launches == k4          # the plain version here
    assert 0.3 < pgb.hit.float().mean() < 1.0
    _assert_gbuffers_equal(td.render_gbuffer(*_args(g), width=W, height=H,
                                             cfg=PCFG, fuse="off"), pgb)
    jgb = jd.render_gbuffer_banded(g["scene"], g["info"], g["ren"].ibl_maps,
                                   g["ren"].env_oct, width=W, height=H,
                                   cfg=CFG, bands=bands)
    _assert_close_to_jax(pgb, jgb)


@pytest.mark.parametrize("bands", [2, 4])
def test_fused_banded_equals_render_gbuffer(setup, bands):
    """The fused route: one K1 raster, shaded in bands, bit-equal to
    render_gbuffer; with the background's fast taps too, but for the rows
    at the band seams, where the half-resolution upsample edge-clamps to
    the band's own taps."""
    g = setup
    n = raster_tiles_fused.launches
    for fast_env in (False, True):
        kw = dict(width=W, height=H, cfg=PCFG, fuse="on", fast_env=fast_env)
        a = td.render_gbuffer(*_args(g), **kw)
        b = td.render_gbuffer_banded(*_args(g), bands=bands, **kw)
        if not fast_env:
            _assert_gbuffers_equal(a, b)
            continue
        _assert_gbuffers_equal(a._replace(background=None), b)
        diff = (a.background != b.background).any(-1)
        band_h = H // bands
        seam = np.zeros(H, bool)
        seam[band_h - 1:-1:band_h] = seam[band_h::band_h] = True
        assert diff[torch.from_numpy(seam)].any()
        assert not diff[torch.from_numpy(~seam)].any()
    assert raster_tiles_fused.launches == n


def test_mask_tail_through_raster_stage(tmp_path):
    """A scene with an ALPHA_MODE_MASK tail: _raster_stage takes the
    two-pass route with the alpha-mask resolve under "auto", and the
    banded G-buffer equals render_gbuffer."""
    from diligentfx_tpu.gltf import loader as jloader
    from diligentfx_tpu.gltf import model as jmodel
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo as PortCI
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer as PortRenderer
    rs = jmodel.build_render_scene(jloader.load_gltf(
        mixed_scene(str(tmp_path / "mixed.glb"))))
    cfg = RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=256,
                           max_tiles_per_tri=16, big_tri_capacity=32, chunk=8)
    pcfg = cv.raster_config_from_jax(cfg)
    port = PortRenderer(PortCI(brdf_lut_dim=16, num_brdf_samples=8,
                               irradiance_cube_dim=8,
                               prefiltered_env_map_dim=8,
                               num_specular_env_samples=8),
                        raster_cfg=pcfg, device="cpu")
    pscene = cv.scene_from_jax(rs.scene)
    eye = [0.2, 0.1, 1.0]
    cam = CameraAttribs.create(jm3.look_at(eye, [0.2, 0.0, -2.5]),
                               jm3.perspective(0.9, W / H, 0.1, 20.0), eye,
                               0.1, 20.0, W, H)
    pinfo = cv.render_info_from_jax(RenderInfo(
        camera=cam, lights=PBRLightAttribs.directional([-0.3, -1.0, -0.5],
                                                       [3, 3, 3]),
        renderer_params=PBRRendererShaderParameters.create()))
    atlas = cv.atlas_from_jax(rs.atlas)
    assert pscene.mask_indices is not None
    vb, fused_px, two_pass = td._raster_stage(
        pscene, pinfo, atlas, pad_w=W, pad_h=H, cfg=pcfg, use_textures=True)
    assert fused_px is None and vb.bary is not None
    plain = td._two_pass_raster(pscene, pinfo, pad_w=W, pad_h=H, cfg=pcfg,
                                atlas=atlas, use_textures=True)[0]
    assert torch.equal(vb.tri_id, plain.tri_id)
    kw = dict(width=W, height=H, cfg=pcfg, atlas=atlas, use_textures=True)
    args = (pscene, pinfo, port.ibl_maps, port.env_oct)
    whole = td.render_gbuffer(*args, **kw)
    _assert_gbuffers_equal(whole, td.render_gbuffer_banded(*args, bands=4,
                                                           **kw))
    # the mask tail's fragments both kept and cut out: some of the
    # lattice's box shows what lies behind it
    assert 0.1 < whole.hit.float().mean() < 1.0


@pytest.mark.parametrize("route", list(ROUTES))
def test_band_sp_matches_whole_frame_and_jax(setup, route):
    """render_gbuffer_band_sp at each band's offset: the same rows of the
    whole frame's G-buffer (K1 or K4's plain version at screen_offset
    (0, y0)), and on the two-pass route the JAX package's band."""
    g = setup
    fuse = ROUTES[route]
    whole = td.render_gbuffer(*_args(g), width=W, height=H, cfg=PCFG,
                              fuse=fuse)
    band_h = 32
    for y0 in range(0, H, band_h):
        pgb = td.render_gbuffer_band_sp(*_args(g), width=W, band_h=band_h,
                                        full_height=H, band_y0=y0, cfg=PCFG,
                                        fuse=fuse)
        assert pgb.depth.shape == (band_h, W)
        _assert_gbuffers_equal(whole, pgb, slice(y0, y0 + band_h))
        if route == "two_pass":
            jgb = jd.render_gbuffer_band_sp(
                g["scene"], g["info"], g["ren"].ibl_maps, g["ren"].env_oct,
                width=W, band_h=band_h, full_height=H, band_y0=y0, cfg=CFG)
            _assert_close_to_jax(pgb, jgb)
    with pytest.raises(ValueError, match="tile-aligned"):
        td.render_gbuffer_band_sp(*_args(g), width=W, band_h=20,
                                  full_height=H, band_y0=0, cfg=PCFG)
