"""The port's K-layer OIT and alpha-mask resolve (diligentfx_tpu_torch/
pbr/oit.py) against the JAX package's pbr/oit.py, on the CPU.

`rasterize_klayers` and `resolve_alpha_mask` are held to the JAX functions
run eagerly (`jax.disable_jit()`: each operation rounds as the port's does;
compiled, XLA contracts the plane evaluations into FMAs and a coverage
test at an edge can flip): tolerance none, every field equal.  The inputs
are random overlapping triangles from a numpy seed, some near-clipped and
some big enough for the big-triangle list, at 256 x 64 in 8 x 128 tiles,
deeper than the K layers so that fragments overflow into the tail.

`shade_klayers` and `composite_klayers` get the same inputs on both sides;
their tolerances are stated at each test.
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
from diligentfx_tpu.config import PBRRendererCreateInfo, RasterizerConfig
from diligentfx_tpu.gltf import loader as jloader
from diligentfx_tpu.gltf import model as jmodel
from diligentfx_tpu.gltf.primitives import MeshData, compute_tangents
from diligentfx_tpu.pbr import oit as joit
from diligentfx_tpu.pbr.renderer import PBRRenderer, RenderInfo, build_scene
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch import math3d as tm3
from diligentfx_tpu_torch.ops import raster as trz
from diligentfx_tpu_torch.pbr import oit as toit
from diligentfx_tpu_torch.pbr.renderer import \
    transform_vertices as t_transform
from tests.test_torch_gltf import grid_quad, mixed_scene
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 256, 64
CFG = RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=32,
                       max_tiles_per_tri=8, big_tri_capacity=8, chunk=8)
PCFG = cv.raster_config_from_jax(CFG)


def random_triangles(seed=0, n=40):
    """n random triangles in clip space (NDC spread about +-1, depth 0.05
    to 0.95, w in 0.5..2; the first six with a vertex behind the near
    plane), each a triangle of its own vertices; per-triangle alphas and
    colours.  Every triangle set of this file has 40 triangles (see
    _factor_mask_scene)."""
    rng = np.random.default_rng(seed)
    ndc = rng.uniform(-1, 1, (n, 1, 2)) + rng.normal(0, 0.4, (n, 3, 2))
    z = rng.uniform(0.05, 0.95, (n, 1, 1)) + rng.normal(0, 0.05, (n, 3, 1))
    w = rng.uniform(0.5, 2.0, (n, 3, 1))
    w[:6, 0, 0] = -0.5
    clip = np.concatenate([ndc * np.abs(w), z * np.abs(w), w], -1)
    clip = clip.reshape(-1, 4).astype(np.float32)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    alpha = rng.uniform(0.2, 0.8, n).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return clip, idx, alpha, rgb


def assert_klayers_equal(ref, got):
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f)


@pytest.mark.parametrize("tail", [False, True], ids=["no_tail", "tail"])
def test_rasterize_klayers_matches_jax(tail):
    """Depth, tri_id, bary, overflow, tail_alpha and tail_color equal the
    eager JAX function's, with and without the per-triangle alpha and
    colour; fragments overflow K = 3."""
    clip, idx, alpha, rgb = random_triangles()
    kw = dict(width=W, height=H, num_layers=3)
    jx = dict(tri_alpha=jnp.asarray(alpha), tri_rgb=jnp.asarray(rgb)) \
        if tail else {}
    tx = dict(tri_alpha=torch.from_numpy(alpha),
              tri_rgb=torch.from_numpy(rgb)) if tail else {}
    with jax.disable_jit():
        ref = joit.rasterize_klayers(jnp.asarray(clip), jnp.asarray(idx),
                                     cfg=CFG, **kw, **jx)
    got = toit.rasterize_klayers(torch.from_numpy(clip),
                                 torch.from_numpy(idx), cfg=PCFG, **kw, **tx)
    assert_klayers_equal(ref, got)
    assert int(got.overflow.max()) > 0
    assert float((got.tri_id >= 0).float().mean()) > 0.2
    assert (got.tail_alpha is not None) == tail


def test_tail_color_without_alpha_matches_jax():
    """tri_rgb alone implies opaque tail fragments (alpha 1), as in JAX."""
    clip, idx, _, rgb = random_triangles(seed=1)
    with jax.disable_jit():
        ref = joit.rasterize_klayers(jnp.asarray(clip), jnp.asarray(idx),
                                     width=W, height=H, cfg=CFG, num_layers=2,
                                     tri_rgb=jnp.asarray(rgb))
    got = toit.rasterize_klayers(torch.from_numpy(clip),
                                 torch.from_numpy(idx), width=W, height=H,
                                 cfg=PCFG, num_layers=2,
                                 tri_rgb=torch.from_numpy(rgb))
    assert_klayers_equal(ref, got)


def test_trimmed_walk_equals_full_walk():
    """Walking each tile's compact candidate list up to the longest count
    (rounded to the chunk) gives exactly what walking every column does:
    past its count a tile holds -1 entries, which insert nothing."""
    clip, idx, alpha, rgb = random_triangles(seed=2)
    clip, idx = torch.from_numpy(clip), torch.from_numpy(idx)
    t = idx.shape[0]
    setup, valid, bbox, orig, _ = trz._triangle_setup(
        clip, idx, W, H, torch.ones(t, dtype=torch.bool), True, 1e-3)
    compact, counts, *_ = trz._bin_triangles(valid, bbox, W, H, PCFG)
    ta = torch.from_numpy(alpha)[orig]
    tr = torch.from_numpy(rgb)[orig]
    n = toit.klayer_walk_columns(counts, PCFG.chunk)
    assert n % PCFG.chunk == 0 and n < compact.shape[1]
    assert n >= int(counts.max())
    full = toit._klayer_raster_tiles(setup, compact, W, H, PCFG, 3,
                                     tri_alpha=ta, tri_rgb=tr)
    trimmed = toit._klayer_raster_tiles(setup, compact, W, H, PCFG, 3,
                                        tri_alpha=ta, tri_rgb=tr, n_cols=n)
    for f in full._fields:
        assert torch.equal(getattr(full, f), getattr(trimmed, f)), f


# ---------------------------------------------------------------------------
# the alpha-mask resolve, shading and compositing
# ---------------------------------------------------------------------------


def _camera(eye, target, w, h):
    view = jm3.look_at(eye, target)
    proj = jm3.perspective(0.9, w / h, 0.1, 20.0)
    return CameraAttribs.create(view, proj, eye, 0.1, 20.0, w, h)


def _info(eye, target):
    return RenderInfo(
        camera=_camera(eye, target, W, H),
        lights=PBRLightAttribs.concat([
            PBRLightAttribs.directional([-0.3, -1.0, -0.5], [3, 3, 3]),
            PBRLightAttribs.point([0.5, 1.0, -1.0], [4, 3, 2], range=10.0)]),
        renderer_params=PBRRendererShaderParameters.create())


def _factor_mask_scene():
    """An opaque back quad and two masked quads in front, one below its
    cutoff (alpha 0.3 < 0.5: discarded), one above (0.9: kept), the two
    overlapping each other and the back quad.  The masked tail has 40
    triangles, as the other scenes of this file: the eager JAX setup and
    binning then compile their operations once."""
    pos, nrm, uv, idx = grid_quad(5, 2, 2.0, 2.0)
    quad = MeshData(pos, nrm, uv, idx.astype(np.int32),
                    compute_tangents(pos, nrm, uv, idx))
    entries = []
    for (x, z, rgba, mode) in ((0.0, -3.0, (0, 1, 0, 1), 0),
                               (-0.4, -2.0, (1, 0, 0, 0.3), 1),
                               (0.5, -2.4, (0, 0, 1, 0.9), 1)):
        node = np.eye(4, dtype=np.float32)
        node[3, :3] = [x, 0.0, z]
        entries.append((quad, node, PBRMaterialBasicAttribs.create(
            base_color_factor=rgba, roughness_factor=0.8, alpha_mode=mode,
            alpha_mask_cutoff=0.5)))
    return build_scene(entries, double_sided_flags=[False, True, True])


def _vertex_stage(pscene, pinfo):
    """The port's vertex stage: world position and normal, clip, 1/w."""
    wp, wn, _ = t_transform(pscene)
    clip = tm3.transform_points(wp, pinfo.camera.view_proj)
    w = clip[:, 3]
    winv = torch.where(torch.abs(w) > 1e-12, 1.0 / w, torch.zeros_like(w))
    return wp, wn, clip, winv


def _resolve_both(jscene, atlas_j, textured, eye, target):
    info = _info(eye, target)
    pscene = cv.scene_from_jax(jscene)
    pinfo = cv.render_info_from_jax(info)
    _, _, clip, winv = _vertex_stage(pscene, pinfo)
    n_op = pscene.indices.shape[0] - pscene.mask_indices.shape[0]
    vb, _ = trz.rasterize(clip, pscene.indices[:n_op], width=W, height=H,
                          cfg=PCFG,
                          double_sided=pscene.tri_double_sided[:n_op])
    jvb = joit.rz.VisibilityBuffer(depth=jnp.asarray(vb.depth.numpy()),
                                   tri_id=jnp.asarray(vb.tri_id.numpy()),
                                   bary=jnp.asarray(vb.bary.numpy()))
    patlas = (None if atlas_j is None else cv.heap_from_jax(atlas_j)
              if hasattr(atlas_j, "texels") else cv.atlas_from_jax(atlas_j))
    ptally = {}
    got = toit.resolve_alpha_mask(vb, clip, pscene, winv, width=W, height=H,
                                  cfg=PCFG, atlas=patlas,
                                  use_textures=textured, tally=ptally)
    with jax.disable_jit():
        ref = joit.resolve_alpha_mask(jvb, jnp.asarray(clip.numpy()), jscene,
                                      jnp.asarray(winv.numpy()), width=W,
                                      height=H, cfg=CFG, atlas=atlas_j,
                                      use_textures=textured)
    for f in ("depth", "tri_id", "bary"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    return vb, got, n_op, ptally


def test_resolve_alpha_mask_untextured():
    """Factor alphas against the cutoff: the resolved visibility equals the
    eager JAX resolve; the masked quad above its cutoff wins in front of
    the opaque quad, the one below it is discarded."""
    jscene = _factor_mask_scene()
    vb, got, n_op, tally = _resolve_both(jscene, None, False, [0, 0, 0],
                                         [0, 0, -1])
    mask_won = got.tri_id >= n_op
    assert bool(mask_won.any())
    mat = jscene.tri_material[np.asarray(got.tri_id.clamp(min=0))]
    assert set(np.asarray(mat)[mask_won.numpy()].tolist()) == {2}
    assert int(tally["passed"]) > 0 and int(tally["discarded"]) > 0


def test_resolve_alpha_mask_textured(tmp_path):
    """The lattice of the mixed glTF scene: the base-colour texture's alpha
    (0 in the holes, 1 on the bars, sampled at lod 0 through the texture
    transform and the mirror / clamp sampler) against the cutoff; equal to
    the eager JAX resolve, with fragments both kept and cut out."""
    rs = jmodel.build_render_scene(jloader.load_gltf(
        mixed_scene(str(tmp_path / "m.glb"))))
    vb, got, n_op, tally = _resolve_both(rs.scene, rs.atlas, True,
                                         [0.2, 0.1, 1.0], [0.2, 0.0, -2.5])
    assert bool((got.tri_id >= n_op).any())
    assert int(tally["passed"]) > 0 and int(tally["discarded"]) > 0


@pytest.fixture(scope="module")
def ibl():
    ren = PBRRenderer(PBRRendererCreateInfo(
        brdf_lut_dim=16, num_brdf_samples=8, irradiance_cube_dim=16,
        prefiltered_env_map_dim=16, num_specular_env_samples=8),
        raster_cfg=CFG)
    return ren.ibl_maps, cv.ibl_maps_from_jax(ren.ibl_maps)


def _blend_layers(tmp_path):
    """The mixed scene's blend panes as K = 4 layers (the port's
    rasterize_klayers, held to JAX above), with the inputs of
    shade_klayers on both sides."""
    rs = jmodel.build_render_scene(jloader.load_gltf(
        mixed_scene(str(tmp_path / "m.gltf"))))
    jscene = rs.scene._replace(tri_material=rs.scene.blend_tri_material,
                               indices=rs.scene.blend_indices)
    info = _info([0.2, 0.1, 1.0], [0.0, 0.0, -2.0])
    pscene = cv.scene_from_jax(rs.scene)
    pinfo = cv.render_info_from_jax(info)
    wp, wn, clip, winv = _vertex_stage(pscene, pinfo)
    bc = pscene.materials.base_color_factor[pscene.blend_tri_material.long()]
    kl = toit.rasterize_klayers(clip, pscene.blend_indices, width=W,
                                height=H, cfg=PCFG, num_layers=4,
                                tri_alpha=bc[:, 3], tri_rgb=bc[:, :3])
    pblend = pscene._replace(tri_material=pscene.blend_tri_material,
                             indices=pscene.blend_indices)
    jkl = joit.KLayerBuffer(*(jnp.asarray(x.numpy()) for x in kl))
    return (jscene, info, jkl, wp, wn, winv), (pblend, pinfo, kl, wp, wn,
                                               winv)


def test_shade_klayers_matches_jax(tmp_path, ibl):
    """Each blend layer shaded with factors-only materials, the punctual
    lights and IBL: colours within tests/test_torch_frame.py's bound for
    the direct light (5e-3 + 5e-3 relative), 99.99% of them within 1e-4
    relative to each value (above 1e-3), and 1e-5 on average.  Measured:
    3.0e-3 relative at worst (0.128 on a value of 42.9), on 9 of 196,608
    channels off by more than 1e-4 relative, 1.5e-6 on average: the GGX
    peak of a roughness-0.1 pane under the point light, where alpha^2 is
    1e-4 and one ulp of N.H moves D by about 1e-3.  Alphas and albedos
    exact."""
    (js, ji, jkl, wp, wn, winv), (ps, pi, pkl, *_) = _blend_layers(tmp_path)
    jmaps, pmaps = ibl
    ref = joit.shade_klayers(js, ji, jmaps, jkl, jnp.asarray(wp.numpy()),
                             jnp.asarray(wn.numpy()),
                             jnp.asarray(winv.numpy()))
    got = toit.shade_klayers(ps, pi, pmaps, pkl, wp, wn, winv)
    assert bool((pkl.tri_id >= 0).any())
    c_ref, c_got = np.asarray(ref[0]), got[0].numpy()
    assert np.isfinite(c_got).all()
    err = np.abs(c_ref - c_got)
    np.testing.assert_allclose(c_got, c_ref, atol=5e-3, rtol=5e-3)
    assert (err / np.maximum(np.abs(c_ref), 1e-3) <= 1e-4).mean() >= 0.9999
    assert err.mean() <= 1e-5
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())
    np.testing.assert_array_equal(np.asarray(ref[2]), got[2].numpy())


@pytest.mark.parametrize("variant", ["albedos", "no_albedos", "tail_alpha",
                                     "no_tail"])
def test_composite_klayers_matches_jax(variant):
    """Front-to-back composite of the random triangles' K = 3 layers (with
    their tail) over a random opaque frame and depth, with the tail scaled
    by the kept layers' luminance ratio (albedos), by the tail colour
    alone, by the kept layers' mean colour (tail alpha without colour), and
    without a tail: within 1e-6 of the JAX package's."""
    clip, idx, alpha, rgb = random_triangles()
    kl = toit.rasterize_klayers(torch.from_numpy(clip), torch.from_numpy(idx),
                                width=W, height=H, cfg=PCFG, num_layers=3,
                                tri_alpha=torch.from_numpy(alpha),
                                tri_rgb=torch.from_numpy(rgb))
    rng = np.random.default_rng(5)
    k = kl.depth.shape[0]
    opaque = rng.uniform(0, 2, (H, W, 3)).astype(np.float32)
    odepth = rng.uniform(0.3, 1.0, (H, W)).astype(np.float32)
    cols = rng.uniform(0, 3, (k, H, W, 3)).astype(np.float32)
    alph = rng.uniform(0, 1, (k, H, W, 1)).astype(np.float32)
    albs = rng.uniform(0, 1, (k, H, W, 3)).astype(np.float32)
    if variant == "tail_alpha":
        kl = kl._replace(tail_color=None)
    elif variant == "no_tail":
        kl = kl._replace(tail_alpha=None, tail_color=None)
    jkl = joit.KLayerBuffer(*(None if x is None else jnp.asarray(x.numpy())
                              for x in kl))
    alb = variant == "albedos"
    ref = joit.composite_klayers(jnp.asarray(opaque), jnp.asarray(odepth),
                                 jkl, jnp.asarray(cols), jnp.asarray(alph),
                                 jnp.asarray(albs) if alb else None)
    got = toit.composite_klayers(torch.from_numpy(opaque),
                                 torch.from_numpy(odepth), kl,
                                 torch.from_numpy(cols),
                                 torch.from_numpy(alph),
                                 torch.from_numpy(albs) if alb else None)
    assert int(kl.overflow.max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
