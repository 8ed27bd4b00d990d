"""Parity of the port's debug views with the JAX package on the CPU: the
G-buffer's debug payload (diligentfx_tpu_torch/pbr/deferred.py
debug_payload, render_gbuffer(emit_debug=True)) on the fused K1 route and
the two-pass K4 route, the 34 views of the task manager
(hydrogent/task_manager.py _debug_aov) and the 13 of the forward renderer
(pbr/renderer.py _debug_color).

Tolerances:
  * the payload against the JAX package's _shade_band run eagerly on the
    port's visibility (tests/test_torch_material_ext.py _gbuffer_vs_jax),
    and each view of the two G-buffers: the lit layers' bound there, 2e-4
    + 2e-4 relative on the hit pixels but for at most 0.1% of the values,
    those within 1e-2 relative (the clear coat's alpha-0.01 highlight);
    0.2% for the clear coat's own punctual term (clearcoat_lit, the
    CLEAR_COAT view), that highlight neither scaled by the coat factor
    nor added to the base layer (0.12% measured);
  * the port's and the JAX _debug_aov on the same G-buffer (the JAX one,
    carried over with convert.gbuffer_from_jax): 1e-6 + 1e-6 relative;
  * the forward views against the JAX package's jitted render of the same
    scene at 64 x 64: 1e-4 + 1e-4 relative where both rasters hit the same
    triangle (the jitted raster moves a few silhouette pixels), those
    being all but at most 1% of the pixels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu.config import DebugViewType as JV
from diligentfx_tpu.hydrogent import task_manager as jtm
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.config import DebugViewType as TV
from diligentfx_tpu_torch.hydrogent import task_manager as ttm
from tests.test_torch_material_ext import (EXTENSIONS, _gbuffer_vs_jax,
                                           ext_scene, renderers,  # noqa: F401
                                           textured_ext_scene)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

VIEWS = [v for v in TV if v != TV.NONE]
# the payload entries each extension case fills (the others stay zero)
FILLED = {
    "clearcoat": ("clearcoat_factor", "clearcoat_roughness",
                  "clearcoat_normal", "clearcoat_lit"),
    "sheen": ("sheen_color", "sheen_roughness", "sheen_lit"),
    "anisotropy": ("anisotropy_strength", "anisotropy_direction"),
    "iridescence": ("iridescence_fresnel", "iridescence_factor",
                    "iridescence_thickness"),
    "transmission_volume": ("transmission", "thickness"),
}
FILLED["all"] = FILLED["textured"] = sum(FILLED.values(), ())


def _close(got, want, hit, label):
    """2e-4 + 2e-4 relative on the hit pixels but for at most 0.1% of the
    values (0.2% of the clear coat's highlight), those within 1e-2
    relative."""
    x, y = want[hit], got[hit]
    assert np.isfinite(y).all(), label
    err = np.abs(y - x) / (2e-4 + 2e-4 * np.abs(x))
    share = 2e-3 if label in ("clearcoat_lit", "CLEAR_COAT") else 1e-3
    assert (err > 1.0).mean() <= share, (label, (err > 1.0).mean())
    np.testing.assert_allclose(y, x, atol=2e-4, rtol=1e-2, err_msg=label)


def _case(renderers, ext, fuse):  # noqa: F811
    if ext == "textured":
        scene, info, jatlas = textured_ext_scene()
        return _gbuffer_vs_jax(renderers, scene, info, fuse, True,
                               atlas=cv.atlas_from_jax(jatlas),
                               jatlas=jatlas, emit_debug=True)
    scene, info = ext_scene(ext)
    return _gbuffer_vs_jax(renderers, scene, info, fuse,
                           ext in ("clearcoat", "all"), emit_debug=True)


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("ext", EXTENSIONS + ("textured",))
def test_debug_payload_and_views_match_jax(renderers, ext, fuse):  # noqa: F811
    """render_gbuffer(emit_debug=True) with each extension scene on the
    fused route ("auto"; untextured anisotropy takes the two-pass one) and
    the two-pass route ("off"): the 21 payload entries against the JAX
    _shade_band's, zeros for the extensions the scene lacks, texcoord0
    the interpolated UVs when textured (the fused route's from K1's UV
    channels); then the 34 views of both G-buffers, and the port's
    _debug_aov against the JAX one on the same G-buffer."""
    pgb, jgb, fused = _case(renderers, ext, fuse)
    assert fused == (fuse == "auto" and ext not in ("anisotropy", "all"))
    hit = np.asarray(jgb.hit)
    np.testing.assert_array_equal(pgb.hit.numpy(), hit)
    assert sorted(pgb.debug) == sorted(jgb.debug) and len(pgb.debug) == 21
    for key, want in jgb.debug.items():
        got = pgb.debug[key].numpy()
        want = np.asarray(want)
        assert got.shape == want.shape, key
        _close(got, want, hit, key)
        filled = bool(np.abs(got[hit]).max() > 0)
        if key == "texcoord0":
            assert filled == (ext == "textured"), ext
        elif key in FILLED["all"]:
            assert filled == (key in FILLED[ext]), (key, ext)
    ao = np.random.default_rng(11).uniform(0.3, 1.0, hit.shape).astype(
        np.float32)
    conv = cv.gbuffer_from_jax(jgb)
    for view in VIEWS:
        want = np.asarray(jtm._debug_aov(JV(int(view)), jgb, jnp.asarray(ao)))
        got = ttm._debug_aov(view, pgb, torch.from_numpy(ao)).numpy()
        assert got.shape == want.shape == hit.shape + (3,), view.name
        assert (got[~hit] == 0).all(), view.name
        _close(got, want, hit, view.name)
        same = ttm._debug_aov(view, conv, torch.from_numpy(ao)).numpy()
        np.testing.assert_allclose(same, want, atol=1e-6, rtol=1e-6,
                                   err_msg=view.name)
    # no SSAO: the occlusion view is the material's own
    np.testing.assert_array_equal(
        ttm._debug_aov(TV.OCCLUSION, conv, None).numpy(),
        np.asarray(jtm._debug_aov(JV.OCCLUSION, jgb, jnp.ones_like(
            jgb.depth))))


FORWARD_VIEWS = (TV.BASE_COLOR, TV.METALLIC, TV.ROUGHNESS, TV.DIFFUSE_COLOR,
                 TV.SPECULAR_COLOR, TV.REFLECTANCE90, TV.SHADING_NORMAL,
                 TV.NDOTV, TV.PUNCTUAL_LIGHTING, TV.DIFFUSE_IBL,
                 TV.SPECULAR_IBL, TV.EMISSIVE, TV.SCENE_DEPTH)
FW = FH = 64


@pytest.fixture(scope="module")
def forward_scene(renderers):  # noqa: F811
    """ext_scene("clearcoat") for both renderers, the JAX package's 13
    forward views (its _render_frame, the jitted function PBRRenderer.render
    calls, traced once for all of them, so XLA compiles the shared frame
    once) and, from each side's SCENE_DEPTH view, the pixels it hit."""
    import jax
    from diligentfx_tpu.config import ToneMappingMode
    from diligentfx_tpu.pbr import renderer as jr
    ren, port = renderers
    scene, info = ext_scene("clearcoat")
    pscene, pinfo = cv.scene_from_jax(scene), cv.render_info_from_jax(info)

    def views(scene, info, ibl_maps, env_oct):
        return [jr._render_frame.__wrapped__(
            scene, info, ibl_maps, env_oct, width=FW, height=FH,
            cfg=ren.raster_cfg, use_ibl=True, use_lights=True,
            debug_view=JV(int(v)), tone_mapping_mode=ToneMappingMode.NONE,
            convert_output_to_srgb=True,
            pcf_kernel_size=ren.ci.pcf_kernel_size) for v in FORWARD_VIEWS]
    want = dict(zip(FORWARD_VIEWS, (np.asarray(x) for x in jax.jit(views)(
        scene, info, ren.ibl_maps, ren.env_oct))))
    jhit = want[TV.SCENE_DEPTH][..., 0] > 0
    phit = port.render(pscene, pinfo, width=FW, height=FH,
                       debug_view=TV.SCENE_DEPTH).numpy()[..., 0] > 0
    return pscene, pinfo, want, jhit, phit


@pytest.mark.parametrize("view", FORWARD_VIEWS, ids=lambda v: v.name)
def test_forward_debug_view_matches_jax(renderers, forward_scene, view):  # noqa: F811
    """PBRRenderer.render with each of the 13 views of _debug_color (the
    two-pass route on the CPU, as the JAX package takes): zero where
    nothing was hit, and equal to the JAX package's render where both
    rasters hit."""
    _, port = renderers
    pscene, pinfo, wants, jhit, hit = forward_scene
    want = wants[view]
    got = port.render(pscene, pinfo, width=FW, height=FH,
                      debug_view=view).numpy()
    assert got.shape == (FH, FW, 3) and np.isfinite(got).all()
    assert 0.1 < hit.mean() < 0.9
    assert (got[~hit] == 0).all()
    both = jhit & hit
    assert (jhit == hit).mean() >= 0.99
    err = np.abs(got - want) > 1e-4 + 1e-4 * np.abs(want)
    assert not err[both].any(), (view.name, np.abs(got - want)[both].max())
    assert np.abs(got[hit]).max() > 0 or view == TV.EMISSIVE


def test_forward_unlisted_view_is_lit_colour(renderers, forward_scene):  # noqa: F811
    """A view _debug_color does not list renders the lit colour before the
    tone map, zero where nothing was hit."""
    _, port = renderers
    pscene, pinfo, _, _, hit = forward_scene
    from diligentfx_tpu_torch.config import ToneMappingMode
    got = port.render(pscene, pinfo, width=FW, height=FH,
                      debug_view=TV.CLEAR_COAT)
    lit = port.render(pscene, pinfo, width=FW, height=FH,
                      tone_mapping_mode=ToneMappingMode.NONE,
                      convert_output_to_srgb=False)
    want = torch.where(torch.from_numpy(hit)[..., None], lit, 0.0)
    assert torch.equal(got, want)
