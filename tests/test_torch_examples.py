"""The port's example entry points (diligentfx_tpu_torch/examples/) against
the JAX package's scripts on the CPU: examples/benchmark_suite.py and
examples/render_mr_spheres.py, imported by file path (examples/ is no
package).

- The scene builders are bit-equal: sponza_like_scene with 4 columns,
  build_mr_spheres_scene and configuration 2's sphere and plane
  (positions, normals, UVs, tangents, indices, node and material tables).
- Configuration 1 at 64 x 64: PBRRenderer.render against the JAX renderer
  (jitted; the two-pass route on both sides), on the port's IBL maps at
  the configuration's own create-info: above 90 dB (measured 108.9 dB).
- Configuration 2 at 128 x 64 with four 256^2 cascades: the cascades
  (each package's distribute_cascades within 1e-5, measured 4.8e-7), the
  shadow maps of the JAX two-pass raster run op by op
  (tests/torch_shadow_ref.py) on the same cascades equal to the port's
  (coverage and depth exactly), the EVSM2 moments of the same maps
  within 1e-5 relative (measured 5e-12), and the forward frame above
  100 dB (measured 134.1 dB).  The 40 m ground plane, two triangles,
  crosses the near plane (ROADMAP.md §3's near-clipped huge triangles);
  at this size and camera the frame holds the bound without cutting it
  into segments, so the test keeps the configuration's plane.
- Configuration 3 with 4 columns at 256 x 128: one frame of
  HnTaskManager.execute against the JAX package's, jitted with its
  Pallas kernels interpreted and DFX_FUSE=on (the port fuses its
  G-buffer on the CPU too).  The jitted frame contracts multiply-adds,
  which moves 6 of 32,768 pixels to another mesh and the glossy clutter
  spheres' highlights (direct light up to 0.38 where the normal moves by
  3e-3); SSR and the composite carry those.  Bounds: the AO history
  50 dB (measured 60.1), the SSR history 40 dB (49.0), the colour 45 dB
  (55.1), each about 10 dB under what this path measured.

Every JAX renderer here takes the port renderer's env map and IBL maps,
so neither side computes the other's precompute.
"""
import functools
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (PBRLightAttribs, PBRMaterialBasicAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.components import shadow_map_manager as jsm
from diligentfx_tpu.config import (PBRRendererCreateInfo, RasterizerConfig,
                                   ShadowMode)
from diligentfx_tpu.gltf.primitives import plane, uv_sphere
from diligentfx_tpu.hydrogent import task_manager as jtm
from diligentfx_tpu.pbr import shading as jsh
from diligentfx_tpu.pbr.renderer import PBRRenderer, RenderInfo, build_scene
from diligentfx_tpu.pbr.renderer import transform_vertices
from diligentfx_tpu.postfx.ssr import SSRSettings
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.components import shadow_map_manager as tsm
from diligentfx_tpu_torch.config import PBRRendererCreateInfo as PortCI
from diligentfx_tpu_torch.examples import benchmark_suite as bs
from diligentfx_tpu_torch.examples import render_mr_spheres as rm
from diligentfx_tpu_torch.pbr.renderer import PBRRenderer as PortRenderer
from diligentfx_tpu_torch.pbr.renderer import \
    transform_vertices as port_transform_vertices
from diligentfx_tpu_torch.utils.image import psnr
from tests.torch_shadow_ref import jax_cascade_maps_op_by_op
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
SMALL_IBL = dict(brdf_lut_dim=32, num_brdf_samples=16, irradiance_cube_dim=16,
                 prefiltered_env_map_dim=32, num_specular_env_samples=16)
SCENE_FIELDS = ("positions", "normals", "uvs", "tangents", "indices",
                "vertex_node", "tri_material", "tri_double_sided",
                "node_matrices")


def _jax_example(name):
    """examples/<name>.py as a module; benchmark_suite.py sets a JAX
    compilation cache directory in the environment at import, which is
    put back."""
    prev = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if prev is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = prev
    return mod


@pytest.fixture(scope="module")
def jbs():
    return _jax_example("benchmark_suite")


def _assert_same_scene(port, ref):
    assert port.num_triangles == ref.num_triangles
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in type(port.materials)._fields:
        np.testing.assert_array_equal(getattr(port.materials, f).numpy(),
                                      np.asarray(getattr(ref.materials, f)),
                                      err_msg=f)


def _jax_renderer(port, ci, cfg):
    """A JAX PBRRenderer of create-info `ci` on the port renderer's env
    map and IBL maps."""
    ren = PBRRenderer(PBRRendererCreateInfo(
        **{**vars(ci), "enable_ibl": False}), raster_cfg=cfg,
        env_oct=jnp.asarray(port.env_oct.numpy()))
    ren.ci = ci
    m = port.ibl_maps
    ren.ibl_maps = jsh.IBLMaps(
        irradiance=jnp.asarray(m.irradiance),
        prefiltered=tuple(jnp.asarray(x) for x in m.prefiltered),
        preintegrated_ggx=jnp.asarray(m.preintegrated_ggx),
        preintegrated_charlie=jnp.asarray(m.preintegrated_charlie),
        sheen_albedo_scaling=jnp.asarray(m.sheen_albedo_scaling),
        irradiance_sh=jnp.asarray(m.irradiance_sh),
        env_brdf_coeffs=jnp.asarray(m.env_brdf_coeffs),
        pref_packed=jnp.asarray(m.pref_packed))
    return ren


@pytest.fixture(scope="module")
def small_ibl():
    return PortRenderer(PortCI(**SMALL_IBL), device="cpu")


# ---------------------------------------------------------------------------
# scene builders
# ---------------------------------------------------------------------------


def test_sponza_like_scene_matches_jax(jbs):
    _assert_same_scene(bs.sponza_like_scene(n_columns=4, device="cpu"),
                       jbs.sponza_like_scene(n_columns=4))


def test_mr_spheres_scene_matches_jax():
    jrm = _jax_example("render_mr_spheres")
    _assert_same_scene(rm.build_mr_spheres_scene(device="cpu"),
                       jrm.build_mr_spheres_scene())


def test_full_size_triangle_counts():
    """The atrium at 24 and 12 columns (configs 3 and 5, config 4), as
    chip_smoke.py's aliases build it too."""
    import chip_smoke
    assert bs.sponza_like_scene(device="cpu").num_triangles == 165152
    assert chip_smoke.full_chain_scene(12, device="cpu").num_triangles \
        == 112592
    assert chip_smoke.full_chain_scene(24, device="cpu").num_triangles \
        == 165152


def test_builders_run_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for build in (bs.config_1_mr_spheres, bs.config_2_shadows,
                  bs.config_3_sponza, bs.config_4_animated, bs.config_5_4k):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bs.main(["--configs", "1", "--frames", "1"])


def test_config_tables_match_jax():
    """Configs 3-5's raster configs and task-manager create-infos field by
    field against the JAX functions' (their lines; the JAX functions build
    and time in one body)."""
    from diligentfx_tpu.postfx.taa import TAAFeatureFlags
    flags = (TAAFeatureFlags.YCOCG_COLOR_SPACE
             | TAAFeatureFlags.GAUSSIAN_WEIGHTING
             | TAAFeatureFlags.PALLAS_WARP)
    common = dict(enable_ssao=True, ssao_half_resolution=True,
                  ssao_use_pallas=True, ssao_num_slices=2, ssao_num_steps=4,
                  enable_ssr=True, ssr_half_resolution=True)
    jax_ci = {   # benchmark_suite.py:148-152, :201-214, :252-258
        3: jtm.TaskManagerCreateInfo(**common, enable_taa=False,
                                     enable_bloom=False),
        4: jtm.TaskManagerCreateInfo(
            **common, enable_taa=True, enable_bloom=True, enable_dof=True,
            dof_use_pallas=True, fast_env_taps=True,
            enable_light_scattering=True, enable_auto_exposure=True,
            taa_feature_flags=flags),
        5: jtm.TaskManagerCreateInfo(**common, enable_taa=True,
                                     enable_bloom=True,
                                     taa_feature_flags=flags)}
    lists = {2: 1024, 3: 1536, 4: 1536, 5: 1024}
    for c, cap in lists.items():
        ref = RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=cap,
                               max_tiles_per_tri=16, big_tri_capacity=64,
                               chunk=8)
        assert getattr(bs, f"config_{c}_raster_config")() == \
            cv.raster_config_from_jax(ref)
    for c, ref in jax_ci.items():
        assert getattr(bs, f"config_{c}_task_manager_ci")() == \
            cv.task_manager_ci_from_jax(ref)
    assert rm.mr_spheres_raster_config() == cv.raster_config_from_jax(
        RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=4096, chunk=32))


# ---------------------------------------------------------------------------
# configuration 1: mr_spheres through the forward renderer
# ---------------------------------------------------------------------------


def test_config_1_frame_matches_jax():
    jrm = _jax_example("render_mr_spheres")
    n = 64
    port_ibl = PortRenderer(rm.mr_spheres_create_info(), device="cpu")
    bc = bs.config_1_mr_spheres(device="cpu", size=n, ibl_from=port_ibl)
    img = bc.step(0).numpy()
    assert img.shape == (n, n, 3) and np.isfinite(img).all()
    assert bc.metric == "cfg1_512_mr_spheres_frame_ms"
    ci = PBRRendererCreateInfo(brdf_lut_dim=64, num_brdf_samples=64,
                               irradiance_cube_dim=32,
                               prefiltered_env_map_dim=64,
                               num_specular_env_samples=64)
    ren = _jax_renderer(port_ibl, ci, RasterizerConfig(
        tile_h=8, tile_w=128, bin_capacity=4096, chunk=32))
    eye = [0.0, 0.3, 6.0]        # render_mr_spheres.py:60-66
    cam = _jax_camera(eye, [0.0, 0.0, 0.0], n, n, fov=0.6)
    info = RenderInfo(camera=cam, lights=PBRLightAttribs.directional(
        [-0.5, -0.7, -0.5], [3.0, 3.0, 3.0]),
        renderer_params=PBRRendererShaderParameters.create())
    ref = np.asarray(ren.render(jrm.build_mr_spheres_scene(), info, width=n,
                                height=n))
    p = psnr(ref, img)
    assert p > 90.0, p


def _jax_camera(eye, target, w, h, fov=0.8):
    """benchmark_suite.py make_camera in the JAX package."""
    from diligentfx_tpu.attribs import CameraAttribs
    return CameraAttribs.create(jm3.look_at(eye, target),
                                jm3.perspective(fov, w / h, 0.1, 100.0), eye,
                                0.1, 100.0, w, h)


# ---------------------------------------------------------------------------
# configuration 2: cascades, EVSM2 and the forward frame
# ---------------------------------------------------------------------------

W2, H2, S2 = 128, 64, 256


@pytest.fixture(scope="module")
def cfg2(small_ibl):
    """The port's configuration 2 at 128 x 64 with 256^2 cascades, one
    frame; and the JAX function's scene, raster config and cascades
    (benchmark_suite.py:95-122)."""
    bc = bs.config_2_shadows(device="cpu", width=W2, height=H2,
                             shadow_map_size=S2, ibl_from=small_ibl)
    img = bc.step(0).numpy()
    gn = np.eye(4, dtype=np.float32)
    gn[3, 1] = -1.3
    scene = build_scene([
        (uv_sphere(1.2, 96, 144), np.eye(4, dtype=np.float32),
         PBRMaterialBasicAttribs.create(
             base_color_factor=(0.7, 0.55, 0.35, 1.0), metallic_factor=0.8,
             roughness_factor=0.35)),
        (plane(40.0), gn, PBRMaterialBasicAttribs.create(
            base_color_factor=(0.45, 0.45, 0.5, 1.0), roughness_factor=0.7)),
    ])
    cfg = RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=1024,
                           max_tiles_per_tri=16, big_tri_capacity=64, chunk=8)
    cam = _jax_camera([0.0, 1.2, 4.5], [0, 0, 0], W2, H2)
    att = jsm.distribute_cascades(cam.view, jm3.inverse(cam.view),
                                  float(cam.proj[0, 0]),
                                  float(cam.proj[1, 1]), 0.1, 100.0,
                                  [-0.5, -1.0, -0.4], num_cascades=4,
                                  shadow_map_size=S2)
    return dict(bc=bc, img=img, scene=scene, cfg=cfg, cam=cam, att=att)


def test_config_2_scene_and_cascades_match_jax(cfg2):
    bc = cfg2["bc"]
    _assert_same_scene(bc.scene, cfg2["scene"])
    assert bc.scene.num_triangles == 27362
    assert bc.cfg == cv.raster_config_from_jax(cfg2["cfg"])
    for f in type(bc.shadow_attribs)._fields:
        a = np.asarray(getattr(cfg2["att"], f), np.float64)
        b = getattr(bc.shadow_attribs, f)
        b = np.asarray(b.numpy() if isinstance(b, torch.Tensor) else b,
                       np.float64)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=f)


def test_config_2_shadow_maps_match_jax_raster(cfg2):
    """On the JAX cascades: the port's maps equal the JAX raster's, run op
    by op, texel for texel."""
    bc, scene = cfg2["bc"], cfg2["scene"]
    wp, _, _ = transform_vertices(scene)
    ref = jax_cascade_maps_op_by_op(wp, scene.indices, cfg2["att"], S2,
                                    cfg2["cfg"])
    pwp, _, _ = port_transform_vertices(bc.scene)
    got = tsm.render_cascade_shadow_maps(
        pwp, bc.scene.indices, cv.shadow_attribs_from_jax(cfg2["att"]),
        shadow_map_size=S2, cfg=bc.cfg).numpy()
    assert got.shape == (4, S2, S2)
    np.testing.assert_array_equal(got < 1.0, ref < 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # the frame's own maps cast the sphere's shadow on the ground
    cover = (bc.last["shadow_maps"].numpy() < 1.0).mean(axis=(1, 2))
    assert (cover > 0.0).all()


def test_config_2_moments_and_frame_match_jax(cfg2, small_ibl):
    bc = cfg2["bc"]
    maps = jnp.asarray(bc.last["shadow_maps"].numpy())
    moments = jsm.gaussian_blur_separable(
        jsm.convert_to_filterable(maps, ShadowMode.EVSM2))
    got = bc.last["shadow_moments"].numpy()
    ref = np.asarray(moments)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    ren = _jax_renderer(small_ibl, PBRRendererCreateInfo(
        enable_shadows=True), cfg2["cfg"])
    info = RenderInfo(
        camera=cfg2["cam"],
        lights=PBRLightAttribs.directional([-0.5, -1.0, -0.4], [4, 4, 4],
                                           shadow_map_index=0),
        renderer_params=PBRRendererShaderParameters.create(),
        shadow_attribs=cfg2["att"], shadow_maps=maps, shadow_moments=moments)
    frame = np.asarray(ren.render(cfg2["scene"], info, width=W2, height=H2,
                                  shadow_mode=ShadowMode.EVSM2))
    img = cfg2["img"]
    assert img.shape == (H2, W2, 3) and np.isfinite(img).all()
    p = psnr(frame, img)
    assert p > 100.0, p


# ---------------------------------------------------------------------------
# configuration 3: the atrium through execute
# ---------------------------------------------------------------------------

W3, H3 = 256, 128


def test_config_3_frame_matches_jax_execute(jbs, small_ibl):
    from jax.experimental import pallas as pl
    bc = bs.config_3_sponza(device="cpu", width=W3, height=H3, n_columns=4,
                            ibl_from=small_ibl)
    color = bc.step(0).numpy()
    out = bc.last["out"]
    assert color.shape == (H3, W3, 3) and np.isfinite(color).all()
    cfg = RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=1536,
                           max_tiles_per_tri=16, big_tri_capacity=64, chunk=8)
    ren = _jax_renderer(small_ibl, PBRRendererCreateInfo(), cfg)
    tm = jtm.HnTaskManager(ren, jtm.TaskManagerCreateInfo(   # :148-152
        enable_ssao=True, ssao_half_resolution=True, ssao_use_pallas=True,
        ssao_num_slices=2, ssao_num_steps=4,
        enable_ssr=True, ssr_half_resolution=True,
        enable_taa=False, enable_bloom=False))
    info = RenderInfo(camera=_jax_camera([0.0, 2.0, 10.0], [0, 1, 0], W3, H3),
                      lights=PBRLightAttribs.directional([-0.4, -1.0, -0.2],
                                                         [4, 4, 4]),
                      renderer_params=PBRRendererShaderParameters.create())
    settings = jtm.FrameSettings(ssr=SSRSettings(
        max_traversal_intersections=24))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DFX_FUSE", "on")
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        jax.clear_caches()
        try:
            ref = tm.execute(jbs.sponza_like_scene(n_columns=4), info,
                             tm.initial_state(W3, H3), width=W3, height=H3,
                             settings=settings)
            ref = jax.tree.map(np.asarray, ref)
        finally:
            jax.clear_caches()
    ids = out.gbuffer.mesh_id.numpy()
    assert (ids != ref.gbuffer.mesh_id).mean() < 1e-3
    ao = out.state.ssao.history.numpy()
    assert psnr(ref.state.ssao.history, ao) > 50.0
    ssr = out.state.ssr.radiance.numpy()
    assert np.isfinite(ssr).all()
    assert psnr(np.clip(ref.state.ssr.radiance, 0, 1),
                np.clip(ssr, 0, 1)) > 40.0
    p = psnr(ref.color, color)
    assert p > 45.0, p


# ---------------------------------------------------------------------------
# render_mr_spheres as a script
# ---------------------------------------------------------------------------


def test_render_mr_spheres_main_writes_a_frame(tmp_path, capsys):
    from diligentfx_tpu_torch.utils.image import read_png
    out = tmp_path / "mr.png"
    assert rm.main(["--size", "32", "--device", "cpu", "--ibl-dim", "32",
                    "--out", str(out)]) == 0
    img = read_png(str(out))
    assert img.shape[:2] == (32, 32) and img[..., :3].max() > 0
    assert "steady-state frame" in capsys.readouterr().out
