"""ALPHA_MODE_MASK in the port (the two-pass G-buffer with the K-layer
alpha-test resolve, and the forward renderer's mask tail) against the JAX
package on the CPU, and the cutoff tests of tests/test_alpha_mask.py on the
port.

The scene is the mixed glTF scene of tests/test_torch_gltf.py (a ground,
the textured lattice screen of MASK, a textured opaque quad, two glass
panes of BLEND, which the G-buffer ignores), 256 x 128 in 8 x 128 tiles.
Both packages take the two-pass path: the JAX package does on the CPU,
the port for any scene with a mask tail.

Tolerances: the JAX side is compiled, so XLA's contracted multiply-adds
can flip a coverage test at a triangle edge (at most 0.5% of the pixels
may show another mesh) and move values by ulps; on pixels where both show
the same mesh the G-buffer fields are held to tests/test_torch_frame.py's
GB_TOL (world position interpolated here, within 1e-4 absolute; the
textured base colour and material within 5e-5), at least 99.9% of the
values within 5e-4 + 5e-4 relative.
"""
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.config import PBRRendererCreateInfo, RasterizerConfig
from diligentfx_tpu.gltf import loader as jloader
from diligentfx_tpu.gltf import model as jmodel
from diligentfx_tpu.pbr import deferred as jd
from diligentfx_tpu.pbr.renderer import PBRRenderer, RenderInfo
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.attribs import PBRMaterialBasicAttribs as PMat
from diligentfx_tpu_torch.config import PBRRendererCreateInfo as PortCI
from diligentfx_tpu.gltf.primitives import plane, transform_mesh
from diligentfx_tpu_torch.ops.raster_kernel import raster_tiles_fused
from diligentfx_tpu_torch.ops.raster_tiles import raster_tiles
from diligentfx_tpu_torch.pbr import deferred as td
from diligentfx_tpu_torch.pbr.renderer import PBRRenderer as PortRenderer
from diligentfx_tpu_torch.pbr.renderer import build_scene as port_build_scene
from diligentfx_tpu_torch.utils.image import psnr
from tests.test_torch_gltf import mixed_scene
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 256, 128
CFG = RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=256,
                       max_tiles_per_tri=16, big_tri_capacity=32, chunk=8)
PCFG = cv.raster_config_from_jax(CFG)
# tests/test_torch_frame.py's per-field (atol, rtol) on pixels where both
# sides show the same mesh
GB_TOL = {
    "depth": (5e-4, 0.0), "normal_world": (2e-3, 0.0),
    "normal_view": (2e-3, 0.0), "base_color": (0.0, 0.0),
    "material_data": (0.0, 0.0), "motion": (1e-4, 0.0),
    "direct": (5e-3, 5e-3), "ambient_diffuse": (5e-4, 5e-4),
    "ambient_specular": (2e-3, 2e-3), "spec_env_factor": (3e-3, 3e-3),
}
CI = PBRRendererCreateInfo(brdf_lut_dim=16, num_brdf_samples=8,
                           irradiance_cube_dim=16, prefiltered_env_map_dim=16,
                           num_specular_env_samples=8)


def _info(w=W, h=H):
    eye = [0.2, 0.1, 1.0]
    cam = CameraAttribs.create(jm3.look_at(eye, [0.2, 0.0, -2.5]),
                               jm3.perspective(0.9, w / h, 0.1, 20.0), eye,
                               0.1, 20.0, w, h)
    return RenderInfo(
        camera=cam,
        lights=PBRLightAttribs.concat([
            PBRLightAttribs.directional([-0.3, -1.0, -0.5], [3, 3, 3]),
            PBRLightAttribs.point([0.5, 1.0, -1.0], [4, 3, 2], range=10.0)]),
        renderer_params=PBRRendererShaderParameters.create())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = mixed_scene(str(tmp_path_factory.mktemp("mask") / "mixed.glb"))
    rs = jmodel.build_render_scene(jloader.load_gltf(path))
    ren = PBRRenderer(CI, raster_cfg=CFG)
    port = PortRenderer(PortCI(), raster_cfg=PCFG, device="cpu",
                        env_oct=cv.tensor(ren.env_oct),
                        ibl_maps=cv.ibl_maps_from_jax(ren.ibl_maps))
    return dict(rs=rs, ren=ren, port=port, pscene=cv.scene_from_jax(rs.scene),
                patlas=cv.atlas_from_jax(rs.atlas),
                info=_info(), pinfo=cv.render_info_from_jax(_info()))


def _same_mesh(a_id, b_id):
    same = a_id == b_id
    assert same.mean() >= 0.995, same.mean()
    return same & (a_id >= 0)


def test_two_pass_gbuffer_matches_jax(setup):
    """The textured G-buffer of the mask scene: the port's render_gbuffer
    ("auto": two-pass, K4's plain version here, the lattice's texture alpha
    tested at lod 0, the UV derivatives of interpolate_with_derivs) against
    the JAX package's (two-pass on the CPU)."""
    g = setup
    n0, k0 = raster_tiles_fused.launches, raster_tiles.launches
    pgb = td.render_gbuffer(g["pscene"], g["pinfo"], g["port"].ibl_maps,
                            g["port"].env_oct, width=W, height=H, cfg=PCFG,
                            atlas=g["patlas"], use_textures=True,
                            fast_env=True)
    assert (raster_tiles_fused.launches, raster_tiles.launches) == (n0, k0)
    jgb = jd.render_gbuffer(g["rs"].scene, g["info"], g["ren"].ibl_maps,
                            g["ren"].env_oct, width=W, height=H, cfg=CFG,
                            atlas=g["rs"].atlas, use_textures=True,
                            fast_env=True)
    jid, pid = np.asarray(jgb.mesh_id), pgb.mesh_id.numpy()
    same = _same_mesh(jid, pid)
    # the lattice shows through its holes: its bars cover part of its box
    lat = pid == g["rs"].mesh_node_ids.index(1)
    ys, xs = np.nonzero(lat)
    box = lat[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    assert lat.mean() > 0.02 and 0.2 < box.mean() < 0.8, box.mean()
    assert same.mean() > 0.3
    # base colour and material: textured here, and the compiled JAX
    # derivatives (contracted multiply-adds) move the mip weights: within
    # 5e-5 (measured 1.5e-5 on 10 of 45,489 values above 1e-5)
    tol = dict(GB_TOL, base_color=(5e-5, 0.0), material_data=(5e-5, 0.0),
               world_pos=(1e-4, 0.0))
    for name, (atol, rtol) in tol.items():
        x = np.asarray(getattr(jgb, name))[same]
        y = getattr(pgb, name).numpy()[same]
        close = np.abs(y - x) <= 5e-4 + 5e-4 * np.abs(x)
        assert close.mean() >= 0.999, (name, int((~close).sum()))
        np.testing.assert_allclose(y, x, atol=atol, rtol=rtol, err_msg=name)


def test_interpolate_with_derivs_matches_jax(setup):
    """bary_setup_from_clip and interpolate_with_derivs (the two-pass
    path's UV derivatives) on the mask scene's two-pass visibility against
    the JAX functions run eagerly: tolerance none, the plane coefficients,
    values and derivatives equal (each operation rounds as JAX's eager
    one does)."""
    import jax
    from diligentfx_tpu.ops import raster as jr
    from diligentfx_tpu_torch.ops import raster as tr
    g = setup
    vb, clip, winv, _ = td._two_pass_raster(
        g["pscene"], g["pinfo"], pad_w=W, pad_h=H, cfg=PCFG,
        atlas=g["patlas"], use_textures=True)
    s = g["pscene"]
    setup_b = tr.bary_setup_from_clip(clip, s.indices, W, H)
    got = tr.interpolate_with_derivs(vb, s.indices, s.uvs, setup_b, winv)
    with jax.disable_jit():
        jsetup = jr.bary_setup_from_clip(np.asarray(clip), np.asarray(
            s.indices), W, H)
        jvb = jr.VisibilityBuffer(depth=np.asarray(vb.depth),
                                  tri_id=np.asarray(vb.tri_id),
                                  bary=np.asarray(vb.bary))
        ref = jr.interpolate_with_derivs(jvb, np.asarray(s.indices),
                                         np.asarray(s.uvs), jsetup,
                                         np.asarray(winv))
    np.testing.assert_array_equal(setup_b.numpy(), np.asarray(jsetup))
    assert bool((vb.tri_id >= 0).any())
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_fuse_choice(setup):
    """render_gbuffer's fuse: "off" is the path "auto" takes for a mask
    scene (two-pass), value for value; "on" forces the fused raster, which
    drops the mask tail as the JAX package's fused path does (the lattice
    vanishes).  HnTaskManager.execute passes fuse through."""
    from diligentfx_tpu_torch.hydrogent import task_manager as ttm
    g = setup
    kw = dict(width=W, height=H, cfg=PCFG, atlas=g["patlas"],
              use_textures=True, fast_env=True)
    args = (g["pscene"], g["pinfo"], g["port"].ibl_maps, g["port"].env_oct)
    auto = td.render_gbuffer(*args, **kw)
    off = td.render_gbuffer(*args, fuse="off", **kw)
    lattice = g["rs"].mesh_node_ids.index(1)
    for f in ("mesh_id", "depth", "direct", "base_color"):
        assert torch.equal(getattr(auto, f), getattr(off, f)), f
    assert bool((auto.mesh_id == lattice).any())
    on = td.render_gbuffer(*args, fuse="on", **kw)
    assert not bool((on.mesh_id == lattice).any())
    tm = ttm.HnTaskManager(g["port"], ttm.TaskManagerCreateInfo(
        enable_ssao=False, enable_ssr=False, enable_taa=False,
        enable_bloom=False), atlas=g["patlas"])
    for fuse, shown in (("auto", True), ("on", False)):
        out = tm.execute(g["pscene"], g["pinfo"], tm.initial_state(W, H),
                         width=W, height=H, fuse=fuse)
        assert bool((out.gbuffer.mesh_id == lattice).any()) == shown, fuse


def test_forward_render_with_mask_tail_matches_jax(setup):
    """PBRRenderer.render of the mask scene (untextured: the factor alpha
    1 passes the cutoff): the two-pass branch with the resolve, against
    the JAX package's forward frame: above 40 dB (tests/test_golden.py's
    bound; the differing edge pixels of the compiled JAX raster)."""
    g = setup
    jimg = np.asarray(g["ren"].render(g["rs"].scene, g["info"], width=W,
                                      height=H))
    pimg = g["port"].render(g["pscene"], g["pinfo"], width=W,
                            height=H).numpy()
    assert pimg.shape == (H, W, 3) and np.isfinite(pimg).all()
    assert psnr(jimg, pimg) > 40.0, psnr(jimg, pimg)
    # fuse="on" drops the mask tail, as the JAX package does
    pon = g["port"].render(g["pscene"], g["pinfo"], width=W, height=H,
                           fuse="on").numpy()
    assert psnr(pimg, pon) < 40.0


def _two_quads(front_alpha, front_mode):
    """tests/test_alpha_mask.py's scene in the port: a green opaque quad at
    z = -3 behind a red one at z = -2 (alpha front_alpha, mode
    front_mode, cutoff 0.5), both facing a camera at the origin."""
    rx = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
                  np.float32)
    quad = transform_mesh(plane(2.0), rx)
    back = np.eye(4, dtype=np.float32)
    back[3, 2] = -3.0
    front = np.eye(4, dtype=np.float32)
    front[3, 2] = -2.0
    return port_build_scene([
        (quad, back, PMat.create(base_color_factor=(0.0, 1.0, 0.0, 1.0),
                                 roughness_factor=1.0)),
        (quad, front, PMat.create(base_color_factor=(1.0, 0.0, 0.0,
                                                     front_alpha),
                                  roughness_factor=1.0,
                                  alpha_mode=front_mode,
                                  alpha_mask_cutoff=0.5))], device="cpu")


def _render_quads(setup, scene, fwd=False):
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.attribs import (CameraAttribs as PCam,
                                              PBRLightAttribs as PLight,
                                              PBRRendererShaderParameters
                                              as PParams)
    from diligentfx_tpu_torch.pbr.renderer import RenderInfo as PInfo
    n = 128
    cam = PCam.create(m3.look_at([0.0, 0.0, 0.0], [0, 0, -1]),
                      m3.perspective(0.9, 1.0, 0.1, 20.0), [0.0, 0.0, 0.0],
                      0.1, 20.0, n, n)
    info = PInfo(camera=cam, lights=PLight.directional([0, 0, -1], [3, 3, 3]),
                 renderer_params=PParams.create())
    if fwd:
        return None, setup["port"].render(scene, info, width=n,
                                          height=n).numpy()
    gb = td.render_gbuffer(scene, info, setup["port"].ibl_maps,
                           setup["port"].env_oct, width=n, height=n,
                           cfg=PCFG)
    return gb, (gb.direct + gb.ambient_diffuse).numpy()


def test_mask_scene_reorders_tail():
    scene = _two_quads(0.0, front_mode=1)
    nm = scene.mask_indices.shape[0]
    assert nm == 2
    assert torch.equal(scene.indices[-nm:], scene.mask_indices)
    assert int(scene.tri_material[-1]) == 1
    assert _two_quads(0.0, front_mode=0).mask_indices is None


@pytest.mark.parametrize("fwd", [False, True], ids=["gbuffer", "forward"])
@pytest.mark.parametrize("alpha,mode,front", [(0.0, 1, False),
                                              (1.0, 1, True),
                                              (0.0, 0, True)],
                         ids=["below_cutoff", "above_cutoff", "opaque_mode"])
def test_mask_cutoff(setup, fwd, alpha, mode, front):
    """Below the cutoff the masked quad is cut out (the green back quad
    shows), above it the red quad covers; OPAQUE mode ignores alpha."""
    gb, color = _render_quads(setup, _two_quads(alpha, mode), fwd)
    c = color[64, 64]
    assert (c[0] > c[1]) == front, c
    if gb is not None:
        assert int(gb.mesh_id[64, 64]) == (1 if front else 0)
