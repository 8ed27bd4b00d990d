"""Parity of the port's glTF material extensions (clear coat, sheen,
anisotropy, iridescence, transmission, volume) with the JAX package on the
CPU: the BRDF functions (diligentfx_tpu_torch/pbr/brdf.py), the Charlie
LUT (pbr/ibl.py), the layered punctual and IBL shading (pbr/shading.py)
and the extension block of the deferred shading (pbr/deferred.py), plus
the JAX package's own checks (tests/test_material_extensions.py and the
glass furnace of tests/test_furnace.py) run on the port.

Tolerances (the JAX functions run eagerly, op by op, on the same numpy
inputs from a seed; measured maxima in brackets):
  * BRDF functions: 1e-6 absolute + 1e-5 relative (relative 3.2e-7 for
    _eval_sensitivity, whose cos takes a phase of about 8 rad, 4.5e-7 for
    the torch.pow of _lambda_sheen_helper, 3.1e-6 for _f0_to_ior near F0
    1, 0 for the rational NDF, visibility and inverse Schlick);
  * iridescence_fresnel: 1e-6 absolute + 1e-5 relative (2.9e-7 absolute);
  * precompute_charlie_lut: 5e-6 absolute (1.25e-6; the JAX LUT is
    jitted, its 256-sample sum contracted into FMAs);
  * apply_punctual_lights / apply_ibl / resolve_lighting with each layer
    and all: 1e-4 + 1e-4 relative, the bound of the ported light dispatch;
  * render_gbuffer against the JAX package's _shade_band run eagerly on
    the port's visibility: the lit layers, base colour, normal and motion
    within 2e-4 + 2e-4 relative on the same pixels but for at most 0.1% of
    the values, and those within 1e-2 relative: at the clear coat's
    highlight peaks (roughness 0.1, alpha 0.01) one ulp of N.H moves the
    GGX lobe by about 2e-3 relative (7 of 12,615 values, at most 2.2e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRMaterialAnisotropyAttribs,
                                    PBRMaterialBasicAttribs,
                                    PBRMaterialIridescenceAttribs,
                                    PBRMaterialSheenAttribs,
                                    PBRMaterialTransmissionAttribs,
                                    PBRMaterialVolumeAttribs,
                                    PBRRendererShaderParameters,
                                    stack_materials)
from diligentfx_tpu.config import PBRRendererCreateInfo, RasterizerConfig
from diligentfx_tpu.gltf.primitives import uv_sphere
from diligentfx_tpu.ops import raster as jr
from diligentfx_tpu.pbr import brdf as jb
from diligentfx_tpu.pbr import deferred as jd
from diligentfx_tpu.pbr import ibl as jibl
from diligentfx_tpu.pbr import shading as jsh
from diligentfx_tpu.pbr.renderer import PBRRenderer, RenderInfo, build_scene
from diligentfx_tpu_torch import attribs as ta
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch import math3d as tm3
from diligentfx_tpu_torch.config import PBRRendererCreateInfo as PortCI
from diligentfx_tpu_torch.gltf import primitives as tprim
from diligentfx_tpu_torch.pbr import brdf as tb
from diligentfx_tpu_torch.pbr import deferred as td
from diligentfx_tpu_torch.pbr import ibl as tibl
from diligentfx_tpu_torch.pbr import renderer as tr
from diligentfx_tpu_torch.pbr import shading as tsh
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = H = 128
CFG = RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=512,
                       max_tiles_per_tri=16, big_tri_capacity=16, chunk=8)
PCFG = cv.raster_config_from_jax(CFG)
CI = PBRRendererCreateInfo(brdf_lut_dim=16, num_brdf_samples=8,
                           irradiance_cube_dim=16, prefiltered_env_map_dim=16,
                           num_specular_env_samples=8)
N = 512
TOL = (1e-6, 1e-5)         # (atol, rtol) of the BRDF functions


def _both(*arrays):
    """numpy arrays -> (jnp tuple, torch tuple)."""
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))


def _unit(rng, n, lo=-1.0, hi=1.0):
    v = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _u(rng, shape, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _brdf_inputs(name, rng):
    """The numpy arguments of brdf.<name>, from the seed."""
    c = lambda: _u(rng, (N, 1))                                  # noqa: E731
    if name == "schlick_to_f0":
        return [c(), _u(rng, (N, 3)), _u(rng, (N, 3), 0.5, 1.0)]
    if name == "smith_ggx_visibility_correlated_anisotropic":
        return [c(), c()] + [_u(rng, (N, 1), -1, 1) for _ in range(4)] + [
            _u(rng, (N, 1), 1e-3, 1.0), _u(rng, (N, 1), 1e-3, 1.0)]
    if name == "ndf_ggx_anisotropic":
        return [c(), _u(rng, (N, 1), -1, 1), _u(rng, (N, 1), -1, 1),
                _u(rng, (N, 1), 1e-3, 1.0), _u(rng, (N, 1), 1e-3, 1.0)]
    if name == "ndf_charlie":
        return [c(), _u(rng, (N, 1), 0.03, 1.0)]
    if name == "_lambda_sheen_helper":
        return [c(), _u(rng, (N, 1), 1e-3, 1.0)]
    if name == "lambda_sheen":
        return [_u(rng, (N, 1), -1, 1), _u(rng, (N, 1), 1e-3, 1.0)]
    if name == "sheen_visibility":
        return [c(), c(), _u(rng, (N, 1), 0.03, 1.0)]
    if name == "sheen_specular_brdf":
        return [_u(rng, (N, 3)), _u(rng, (N, 1), 0.03, 1.0), c(), c(), c()]
    if name == "_eval_sensitivity":
        shift = np.where(rng.random((N, 3)) < 0.5, 0.0,
                         np.pi).astype(np.float32)
        return [_u(rng, (N,), 0.0, 2400.0), shift]
    if name == "_f0_to_ior":
        return [_u(rng, (N, 3))]
    if name == "_ior_to_f0":
        return [_u(rng, (N, 3), 1.0, 3.0), _u(rng, (N, 1), 1.0, 2.0)]
    if name == "sample_hemisphere_cosine":
        return [_u(rng, (N,)), _u(rng, (N,))]
    raise KeyError(name)


BRDF_TOL = {
    "schlick_to_f0": TOL,
    "smith_ggx_visibility_correlated_anisotropic": TOL,
    "ndf_ggx_anisotropic": TOL,
    "ndf_charlie": TOL,
    "_lambda_sheen_helper": TOL,
    "lambda_sheen": TOL,
    "sheen_visibility": TOL,
    "sheen_specular_brdf": TOL,
    "_eval_sensitivity": TOL,
    "_f0_to_ior": TOL,
    "_ior_to_f0": TOL,
    "sample_hemisphere_cosine": TOL,
}


@pytest.mark.parametrize("name", sorted(BRDF_TOL))
def test_brdf_function_matches_jax(name):
    """Each ported BRDF function on the same random inputs as the JAX one,
    within its tolerance (module docstring)."""
    rng = np.random.default_rng(sorted(BRDF_TOL).index(name))
    ja, ta_ = _both(*_brdf_inputs(name, rng))
    want = np.asarray(getattr(jb, name)(*ja))
    got = getattr(tb, name)(*ta_).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    atol, rtol = BRDF_TOL[name]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_lambda_sheen_helper_scalar_and_constants():
    """_lambda_sheen_helper at the scalar 0.5 (lambda_sheen's pivot) and
    the XYZ -> RGB rows equal to the JAX package's."""
    rng = np.random.default_rng(11)
    (ja,), (ta_,) = _both(_u(rng, (N, 1), 1e-3, 1.0))
    np.testing.assert_allclose(tb._lambda_sheen_helper(0.5, ta_).numpy(),
                               np.asarray(jb._lambda_sheen_helper(0.5, ja)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(tb._XYZ_TO_RGB_ROWS, np.float32),
                                  np.asarray(jb._XYZ_TO_RGB_ROWS))


def test_iridescence_fresnel_matches_jax():
    """iridescence_fresnel over IORs 1-2.5, thicknesses 0-1200 nm (the
    film vanishing below 400), base F0 of dielectrics and metals, and
    grazing to normal incidence."""
    rng = np.random.default_rng(3)
    args = [_u(rng, (N, 1), 1.0, 2.5), _u(rng, (N, 3), 0.02, 1.0),
            _u(rng, (N, 1), 0.0, 1200.0), _u(rng, (N, 1))]
    ja, ta_ = _both(*args)
    want = np.asarray(jb.iridescence_fresnel(1.0, *ja))
    got = tb.iridescence_fresnel(1.0, *ta_).numpy()
    assert np.ptp(want) > 0.5
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def _srf(rng):
    """The numpy arrays of a random pixels' SurfaceReflectanceInfo."""
    return [_u(rng, (N, 1), 0.05, 1.0), _u(rng, (N, 3)),
            _u(rng, (N, 3), 0.02, 1.0), np.ones((N, 3), np.float32)]


def test_smith_ggx_brdf_anisotropic_matches_jax():
    """The anisotropic Cook-Torrance lobe: diffuse, specular and NdotL."""
    rng = np.random.default_rng(5)
    n = _unit(rng, N)
    t = _unit(rng, N)
    t = t - n * np.sum(t * n, -1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(n, t)
    vecs = [_unit(rng, N), n, (n + _unit(rng, N)).astype(np.float32), t, b]
    srf = _srf(rng)
    ab = [_u(rng, (N, 1), 1e-3, 1.0), _u(rng, (N, 1), 1e-3, 1.0)]
    ja, ta_ = _both(*vecs, *srf, *ab)
    want = jb.smith_ggx_brdf_anisotropic(
        *ja[:5], jb.SurfaceReflectanceInfo(*ja[5:9]), *ja[9:])
    got = tb.smith_ggx_brdf_anisotropic(
        *ta_[:5], tb.SurfaceReflectanceInfo(*ta_[5:9]), *ta_[9:])
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-5)


def test_precompute_charlie_lut_matches_jax():
    """The 64^2 Charlie LUT over 256 samples, against the jitted JAX
    precompute ."""
    want = np.asarray(jibl.precompute_charlie_lut(64, 256))
    got = tibl.precompute_charlie_lut(64, 256).numpy()
    assert got.shape == (64, 64, 1)
    assert np.isfinite(got).all() and want.min() >= 0.0 and want.max() > 0.5
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)


# ---------------------------------------------------------------------------
# the layered shading: apply_punctual_lights, apply_ibl, resolve_lighting
# ---------------------------------------------------------------------------

LAYERS = ("base", "clearcoat", "sheen", "sheen_lut", "anisotropy",
          "iridescence", "transmission", "all")


PORT_CI = PortCI(brdf_lut_dim=16, num_brdf_samples=8, irradiance_cube_dim=16,
                 prefiltered_env_map_dim=16, num_specular_env_samples=8)


def jax_and_port_renderers(clear_coat=False):
    """A JAX PBRRenderer (CI) and the port's (PORT_CI) sharing one set of
    IBL maps: the port precomputes them (0.6 s on one core, where the
    jitted JAX precompute takes 17 s) and the JAX renderer takes them as
    JAX arrays, so the comparisons start from the same maps."""
    port = tr.PBRRenderer(dataclasses.replace(
        PORT_CI, enable_clear_coat=clear_coat), raster_cfg=PCFG,
        device="cpu")
    ren = PBRRenderer(dataclasses.replace(CI, enable_ibl=False,
                                          enable_clear_coat=clear_coat),
                      raster_cfg=CFG, env_oct=jnp.asarray(port.env_oct))
    ren.ci = dataclasses.replace(ren.ci, enable_ibl=True)
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
    return ren, port


@pytest.fixture(scope="module")
def renderers():
    """The JAX and the port's renderer with the same small IBL maps (the
    Charlie LUT at 64^2)."""
    return jax_and_port_renderers()


def _shading_arrays(layer, seed=7):
    """numpy arrays of a (16, 16) frame's SurfaceShadingInfo with `layer`
    on (all: every one): name -> array."""
    rng = np.random.default_rng(seed)
    hw = (16, 16)
    n = _unit(rng, 256).reshape(hw + (3,))
    v = (n + 0.8 * _unit(rng, 256).reshape(hw + (3,)))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    t = _unit(rng, 256).reshape(hw + (3,))
    t = t - n * np.sum(t * n, -1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    u = lambda c, lo=0.0, hi=1.0: _u(rng, hw + (c,), lo, hi)  # noqa: E731
    a = dict(pos=u(3, -3.0, 3.0), view=v.astype(np.float32),
             occlusion=u(1, 0.5, 1.0), emissive=u(3, 0.0, 0.2),
             rough=u(1, 0.05, 1.0), diffuse=u(3), f0=u(3, 0.02, 0.9),
             metallic=u(1), normal=n.astype(np.float32))
    a["ndotv"] = np.clip(np.sum(n * a["view"], -1, keepdims=True), 0, 1)
    a["r90"] = np.ones(hw + (3,), np.float32)
    on = lambda k: layer in (k, "all")                        # noqa: E731
    if on("clearcoat"):
        a.update(cc_rough=u(1, 0.02, 0.6), cc_factor=u(1))
    if on("sheen") or layer == "sheen_lut":
        a.update(sheen_color=u(3), sheen_rough=u(1, 0.03, 1.0))
    if on("anisotropy"):
        a.update(strength=u(1), tangent=t.astype(np.float32),
                 bitangent=np.cross(n, t).astype(np.float32),
                 alpha_t=u(1, 1e-3, 1.0), alpha_b=u(1, 1e-3, 1.0))
    if on("iridescence"):
        a.update(iri_factor=u(1), iri_thick=u(1, 100.0, 400.0),
                 iri_fresnel=u(3), iri_f0=u(3))
    if on("transmission"):
        a.update(transmission=u(1), vol_thick=u(1, 0.0, 2.0),
                 vol_att=u(3, 0.0, 3.0))
    return a


def _shading(mod, sh, a):
    """SurfaceShadingInfo of module `sh` (jsh or tsh) from arrays `a`."""
    t = ((lambda x: jnp.asarray(x)) if mod == "jax"
         else (lambda x: torch.from_numpy(np.ascontiguousarray(x))))
    g = lambda k: t(a[k]) if k in a else None                 # noqa: E731
    cc = sheen = aniso = iri = None
    if "cc_rough" in a:
        cc = sh.ClearcoatShadingInfo(
            srf=sh.get_surface_reflectance_clearcoat(g("cc_rough")),
            normal=g("normal"), factor=g("cc_factor"))
    if "sheen_color" in a:
        sheen = sh.SheenShadingInfo(color=g("sheen_color"),
                                    roughness=g("sheen_rough"))
    if "strength" in a:
        aniso = sh.AnisotropyShadingInfo(
            strength=g("strength"), tangent=g("tangent"),
            bitangent=g("bitangent"), alpha_roughness_t=g("alpha_t"),
            alpha_roughness_b=g("alpha_b"))
    if "iri_factor" in a:
        iri = sh.IridescenceShadingInfo(factor=g("iri_factor"),
                                        thickness=g("iri_thick"),
                                        fresnel=g("iri_fresnel"),
                                        f0=g("iri_f0"))
    srf = sh.SurfaceReflectanceInfo(g("rough"), g("diffuse"), g("f0"),
                                    g("r90"))
    return sh.SurfaceShadingInfo(
        pos=g("pos"), view=g("view"), occlusion=g("occlusion"),
        emissive=g("emissive"),
        base=sh.BaseLayerShadingInfo(srf=srf, metallic=g("metallic"),
                                     normal=g("normal"), ndotv=g("ndotv")),
        ibl_scale=t(np.array([1.0, 0.9, 0.8], np.float32)), clearcoat=cc,
        sheen=sheen, anisotropy=aniso, iridescence=iri,
        transmission=g("transmission"), volume_thickness=g("vol_thick"),
        volume_attenuation=g("vol_att"))


def _lights():
    """A directional, a shadowed point and a spot light (JAX attribs)."""
    return PBRLightAttribs.concat([
        PBRLightAttribs.directional([-0.3, -1.0, -0.4], [3.0, 3.0, 3.0]),
        PBRLightAttribs.point([1.0, 2.0, 1.0], [5.0, 4.0, 3.0], range=12.0,
                              shadow_map_index=0),
        PBRLightAttribs.spot([0.0, 3.0, 0.0], [0.0, -1.0, 0.1],
                             [6.0, 6.0, 6.0], 0.3, 0.7, range=15.0)])


def _layers_np(lighting):
    out = {}
    for name in ("base", "sheen", "clearcoat"):
        layer = getattr(lighting, name)
        if layer is not None:
            for f in layer._fields:
                out[f"{name}.{f}"] = np.asarray(getattr(layer, f))
    return out


@pytest.mark.parametrize("layer", LAYERS)
def test_shading_layers_match_jax(renderers, layer):
    """apply_punctual_lights (three lights, a shadow factor on one; the
    sheen albedo-scaling LUT in "sheen_lut", its fallback elsewhere),
    apply_ibl and resolve_lighting with `layer` on, each layer's punctual,
    diffuse and specular IBL terms and the resolved colour within 1e-4 +
    1e-4 relative of the JAX functions."""
    ren, port = renderers
    a = _shading_arrays(layer)
    js, ts = _shading("jax", jsh, a), _shading("torch", tsh, a)
    with_sheen, with_cc = js.sheen is not None, js.clearcoat is not None
    lights = _lights()
    shadow = np.random.default_rng(1).uniform(0, 1, (3, 16, 16)).astype(
        np.float32)
    lut = layer == "sheen_lut"
    jl = jsh.apply_punctual_lights(
        js, lights, jsh.default_lighting(js.pos, with_sheen, with_cc),
        shadow_factors=jnp.asarray(shadow),
        sheen_albedo_scaling_lut=(ren.ibl_maps.sheen_albedo_scaling
                                  if lut else None))
    tl = tsh.apply_punctual_lights(
        ts, cv.lights_from_jax(lights),
        tsh.default_lighting(ts.pos, with_sheen, with_cc),
        shadow_factors=torch.from_numpy(shadow),
        sheen_albedo_scaling_lut=(port.ibl_maps.sheen_albedo_scaling
                                  if lut else None))
    jl = jsh.apply_ibl(js, ren.ibl_maps, jl)
    tl = tsh.apply_ibl(ts, port.ibl_maps, tl)
    want, got = _layers_np(jl), _layers_np(tl)
    assert sorted(want) == sorted(got)
    assert len(want) == 3 * (1 + with_sheen + with_cc)
    for k in want:
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(tsh.resolve_lighting(ts, tl).numpy(),
                               np.asarray(jsh.resolve_lighting(js, jl)),
                               atol=1e-4, rtol=1e-4)
    if lut:      # the LUT branch differs from the fallback
        fb = tsh.apply_punctual_lights(
            ts, cv.lights_from_jax(lights),
            tsh.default_lighting(ts.pos, True, False),
            shadow_factors=torch.from_numpy(shadow))
        assert not torch.allclose(fb.base.punctual, tl.base.punctual)


# ---------------------------------------------------------------------------
# render_gbuffer's extension block against the JAX _shade_band
# ---------------------------------------------------------------------------

EXTENSIONS = ("clearcoat", "sheen", "anisotropy", "iridescence",
              "transmission_volume", "all")


def _ext_attribs(ext, n_mats):
    """The JAX scene fields of `ext` for n_mats materials (material 0 off,
    the others on, so both sides of each layer's mix show)."""
    on = lambda k: ext in (k, "all")                          # noqa: E731
    out = {}

    def stack(make):
        return stack_materials([make(i) for i in range(n_mats)])
    if on("sheen"):
        out["materials_sheen"] = stack(lambda i: PBRMaterialSheenAttribs
                                       .create((0.8 * (i > 0), 0.2, 0.4),
                                               0.5))
    if on("anisotropy"):
        out["materials_anisotropy"] = stack(
            lambda i: PBRMaterialAnisotropyAttribs.create(0.8 * (i > 0), 0.5))
    if on("iridescence"):
        out["materials_iridescence"] = stack(
            lambda i: PBRMaterialIridescenceAttribs.create(
                1.0 * (i > 0), 1.3, 100.0, 250.0 + 100 * i))
    if on("transmission_volume"):
        out["materials_transmission"] = stack(
            lambda i: PBRMaterialTransmissionAttribs.create(0.9 * (i > 0)))
        out["materials_volume"] = stack(
            lambda i: PBRMaterialVolumeAttribs.create((0.9, 0.5, 0.2), 0.5,
                                                      0.3))
    return out


def ext_scene(ext):
    """Three spheres (materials 0-2, clear coat on 1 and 2) in front of
    the camera, the extension `ext` on materials 1 and 2: the JAX scene
    and RenderInfo."""
    mesh = uv_sphere(0.6, stacks=10, slices=14)
    entries = []
    for i in range(3):
        node = np.eye(4, dtype=np.float32)
        node[3, :3] = [(i - 1) * 1.3, 0.1 * i, -0.2 * i]
        entries.append((mesh, node, PBRMaterialBasicAttribs.create(
            base_color_factor=(0.8, 0.3 + 0.2 * i, 0.2, 1.0),
            metallic_factor=0.5 * (i == 1), roughness_factor=0.3 + 0.2 * i,
            clearcoat_factor=0.5 * i, clearcoat_roughness_factor=0.1)))
    scene = build_scene(entries)
    scene = scene._replace(**_ext_attribs(ext, 3))
    eye = [0.0, 0.5, 3.5]
    cam = CameraAttribs.create(jm3.look_at(eye, [0, 0, 0]),
                               jm3.perspective(0.9, 1.0, 0.1, 20.0), eye,
                               0.1, 20.0, W, H)
    info = RenderInfo(camera=cam, lights=_lights(),
                      renderer_params=PBRRendererShaderParameters.create())
    return scene, info


LIT = ("direct", "ambient_diffuse", "ambient_specular", "spec_env_factor")


def _gbuffer_vs_jax(renderers, scene, info, fuse, clearcoat, atlas=None,
                    jatlas=None, emit_debug=False):
    """The port's render_gbuffer and the JAX _shade_band, run eagerly on
    the port's visibility (fused channels, or barycentrics, clip and 1/w),
    with the debug views' payload when `emit_debug`: (port G-buffer, JAX
    G-buffer, whether the port fused)."""
    ren, port = renderers
    pscene, pinfo = cv.scene_from_jax(scene), cv.render_info_from_jax(info)
    textured = atlas is not None
    pgb = td.render_gbuffer(pscene, pinfo, port.ibl_maps, port.env_oct,
                            width=W, height=H, cfg=PCFG, fuse=fuse,
                            enable_clearcoat=clearcoat, atlas=atlas,
                            use_textures=textured, emit_debug=emit_debug)
    fused = td._fuse_ok(pscene, fuse, textured)
    if fused:
        vb, fused_px, _ = td._fused_raster(pscene, pinfo, pad_w=W, pad_h=H,
                                           cfg=PCFG, use_textures=textured)
        clip = winv = None
        fused_px = jnp.asarray(fused_px.numpy())
        bary = jnp.zeros((H, W, 2))
    else:
        vb, clip, winv, _ = td._two_pass_raster(
            pscene, pinfo, pad_w=W, pad_h=H, cfg=PCFG, atlas=atlas,
            use_textures=textured)
        clip, winv = jnp.asarray(clip.numpy()), jnp.asarray(winv.numpy())
        fused_px, bary = None, jnp.asarray(vb.bary.numpy())
    jvb = jr.VisibilityBuffer(depth=jnp.asarray(vb.depth.numpy()),
                              tri_id=jnp.asarray(vb.tri_id.numpy()),
                              bary=bary)
    with jax.disable_jit():
        jgb = jd._shade_band(
            scene, info, ren.ibl_maps, ren.env_oct, jvb, clip, winv,
            jnp.int32(0), band_h=H, pad_w=W, pad_h=H, use_ibl=True,
            use_lights=True, shadow_mode=None, pcf_kernel_size=3,
            atlas=jatlas, use_textures=textured,
            enable_clearcoat=clearcoat, fast_env=False,
            light_shadow_kinds=(), fused_px=fused_px,
            emit_debug=emit_debug)
    return pgb, jgb, fused


def _assert_lit_close(pgb, jgb):
    hit = np.asarray(jgb.hit)
    np.testing.assert_array_equal(pgb.hit.numpy(), hit)
    assert 0.1 < hit.mean() < 0.9
    for name in LIT + ("base_color", "normal_world", "motion"):
        x = np.asarray(getattr(jgb, name))[hit]
        y = getattr(pgb, name).numpy()[hit]
        assert np.isfinite(y).all(), name
        err = np.abs(y - x) / (2e-4 + 2e-4 * np.abs(x))
        # the clear coat's highlight peaks (alpha 0.01): one ulp of N.H
        # moves the GGX lobe by 2e-3 relative
        assert (err > 1.0).mean() <= 1e-3, (name, (err > 1.0).mean())
        np.testing.assert_allclose(y, x, atol=2e-4, rtol=1e-2, err_msg=name)


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("ext", EXTENSIONS)
def test_gbuffer_extension_matches_jax(renderers, ext, fuse):
    """render_gbuffer with each extension (clear coat through
    enable_clearcoat) on the fused route ("auto") and the two-pass route
    ("off"): the lit layers, base colour, normal and motion against the
    JAX package's _shade_band on the same visibility.  Untextured
    anisotropy takes the two-pass route under "auto" (the fused raster
    carries no tangents; "on" refuses it), and the extension changes the
    frame against the same scene without it."""
    scene, info = ext_scene(ext)
    clearcoat = ext in ("clearcoat", "all")
    pgb, jgb, fused = _gbuffer_vs_jax(renderers, scene, info, fuse,
                                      clearcoat)
    assert fused == (fuse == "auto" and ext not in ("anisotropy", "all"))
    _assert_lit_close(pgb, jgb)
    ren, port = renderers
    bare = td.render_gbuffer(
        cv.scene_from_jax(build_scene_like(scene)),
        cv.render_info_from_jax(info), port.ibl_maps, port.env_oct, width=W,
        height=H, cfg=PCFG, fuse="off")
    assert not torch.allclose(bare.direct + bare.ambient_specular,
                              pgb.direct + pgb.ambient_specular, atol=1e-3)
    if ext in ("anisotropy", "all"):
        with pytest.raises(ValueError, match="two-pass"):
            td.render_gbuffer(cv.scene_from_jax(scene),
                              cv.render_info_from_jax(info), port.ibl_maps,
                              port.env_oct, width=W, height=H, cfg=PCFG,
                              fuse="on")


def build_scene_like(scene):
    """`scene` without its material extensions."""
    return scene._replace(**{f: None for f in (
        "materials_sheen", "materials_anisotropy", "materials_iridescence",
        "materials_transmission", "materials_volume")})


def textured_ext_scene():
    """ext_scene("all") with a normal map on every material (a 32^2 atlas
    texture, its UVs scaled by 2): the JAX scene, RenderInfo and atlas."""
    from diligentfx_tpu.gltf.model import NUM_SLOTS, SLOT_NORMAL
    from diligentfx_tpu.ops.texture import AtlasBuilder
    scene, info = ext_scene("all")
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    nrm = np.stack([0.3 * np.sin(xx * 12), 0.3 * np.cos(yy * 9),
                    np.ones_like(xx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    b = AtlasBuilder(size=32)
    nid = b.add((nrm * 0.5 + 0.5).astype(np.float32))
    jatlas = b.build(num_mips=3)
    ids = np.full((3, NUM_SLOTS), -1, np.int32)
    ids[:, SLOT_NORMAL] = nid
    scene = scene._replace(
        tex_ids=jnp.asarray(ids),
        tex_uv_transform=jnp.asarray(np.tile(np.array(
            [2, 0, 0, 2, 0, 0], np.float32), (3, NUM_SLOTS, 1))),
        tex_wraps=jnp.zeros((3, NUM_SLOTS, 2), jnp.int32))
    return scene, info, jatlas


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_textured_anisotropy_gbuffer_matches_jax(renderers, fuse):
    """Every extension and the clear coat with a normal map: the fused
    route now carries the node-transformed tangents the anisotropy reads
    (and the two-pass route interpolates them), against the JAX
    _shade_band on the same visibility."""
    scene, info, jatlas = textured_ext_scene()
    pgb, jgb, fused = _gbuffer_vs_jax(renderers, scene, info, fuse, True,
                                      atlas=cv.atlas_from_jax(jatlas),
                                      jatlas=jatlas)
    assert fused == (fuse == "auto")
    _assert_lit_close(pgb, jgb)


# ---------------------------------------------------------------------------
# the JAX package's own checks (tests/test_material_extensions.py and the
# glass furnace of tests/test_furnace.py), run on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def base(renderers):
    """tests/test_material_extensions.py's scene on the port: a red sphere
    with clear coat 1.0 (roughness 0.1) under a directional light."""
    _, port = renderers
    mesh = tprim.uv_sphere(1.0, stacks=12, slices=16)
    scene = tr.build_scene([(mesh, np.eye(4, dtype=np.float32),
                             ta.PBRMaterialBasicAttribs.create(
                                 base_color_factor=(0.8, 0.1, 0.1, 1.0),
                                 metallic_factor=0.0, roughness_factor=0.5,
                                 clearcoat_factor=1.0,
                                 clearcoat_roughness_factor=0.1))],
                           device="cpu")
    eye = [0.0, 0.0, 3.5]
    cam = ta.CameraAttribs.create(tm3.look_at(eye, [0, 0, 0]),
                                  tm3.perspective(0.8, 1.0, 0.1, 20.0), eye,
                                  0.1, 20.0, W, H)
    info = tr.RenderInfo(camera=cam, lights=ta.PBRLightAttribs.directional(
        [-0.3, -0.5, -1.0], [3, 3, 3]),
        renderer_params=ta.PBRRendererShaderParameters.create())
    return port, scene, info


def _render(port, scene, info, **kw):
    gb = td.render_gbuffer(scene, info, port.ibl_maps, port.env_oct,
                           width=W, height=H, cfg=PCFG, **kw)
    return gb, (gb.direct + gb.ambient_diffuse + gb.ambient_specular).numpy()


def _one(attribs):
    return ta.stack_materials([attribs])


def test_port_clearcoat_adds_secondary_highlight(base):
    port, scene, info = base
    gb0, img0 = _render(port, scene, info, enable_clearcoat=False)
    gb1, img1 = _render(port, scene, info, enable_clearcoat=True)
    assert np.isfinite(img1).all()
    hit = gb1.hit.numpy()
    assert np.abs(img1 - img0)[hit].mean() > 1e-3


def test_port_sheen_layer(base):
    port, scene, info = base
    scene_s = scene._replace(materials_sheen=_one(
        ta.PBRMaterialSheenAttribs.create((1.0, 0.5, 0.3), 0.5)))
    _, img0 = _render(port, scene, info)
    gb1, img1 = _render(port, scene_s, info)
    hit = gb1.hit.numpy()
    assert np.isfinite(img1).all()
    assert img1[hit].sum() > img0[hit].sum()


def test_port_anisotropy_changes_highlight(base):
    port, scene, info = base
    scene_a = scene._replace(materials_anisotropy=_one(
        ta.PBRMaterialAnisotropyAttribs.create(0.9, 0.0)))
    _, img0 = _render(port, scene, info)
    gb1, img1 = _render(port, scene_a, info)
    hit = gb1.hit.numpy()
    assert np.isfinite(img1).all()
    assert np.abs(img1 - img0)[hit].mean() > 1e-4


def test_port_iridescence_tints_specular(base):
    port, scene, info = base
    scene_i = scene._replace(materials_iridescence=_one(
        ta.PBRMaterialIridescenceAttribs.create(1.0, 1.3, 100.0, 400.0)))
    gb1, img1 = _render(port, scene_i, info)
    _, img0 = _render(port, scene, info)
    hit = gb1.hit.numpy()
    assert np.isfinite(img1).all()
    per_chan = np.abs((img1 - img0)[hit]).mean(0)
    assert per_chan.max() > 1e-4
    assert per_chan.std() > 1e-6


def test_port_transmission_replaces_diffuse(base):
    port, scene, info = base
    scene_t = scene._replace(materials_transmission=_one(
        ta.PBRMaterialTransmissionAttribs.create(1.0)))
    gb1, _ = _render(port, scene_t, info)
    gb0, _ = _render(port, scene, info)
    hit = gb0.hit.numpy()
    d1 = gb1.ambient_diffuse.numpy()[hit]
    d0 = gb0.ambient_diffuse.numpy()[hit]
    assert d1.mean() > 0.05 * d0.mean()
    assert np.abs(d1 - d0).mean() > 1e-3
    assert gb1.direct.numpy()[hit].sum() < gb0.direct.numpy()[hit].sum()


def test_port_volume_beer_lambert(base):
    port, scene, info = base
    trans = _one(ta.PBRMaterialTransmissionAttribs.create(1.0))

    def with_vol(thickness):
        return scene._replace(
            materials_transmission=trans,
            materials_volume=_one(ta.PBRMaterialVolumeAttribs.create(
                (0.9, 0.2, 0.2), thickness, 1.0)))
    ds = []
    for th in (0.0, 1.0, 3.0):
        gb, _ = _render(port, with_vol(th), info)
        ds.append(gb.ambient_diffuse.numpy()[gb.hit.numpy()].mean(0))
    d0, d1, d3 = ds
    assert d1.sum() < d0.sum() and d3.sum() < d1.sum()
    rel = d3 / np.maximum(d0, 1e-6)
    assert rel[0] > rel[1] and rel[0] > rel[2]


def test_port_spec_gloss_workflow(base):
    port, scene, info = base
    mats = scene.materials
    sg = mats._replace(workflow=torch.ones_like(mats.workflow),
                       specular_factor=torch.full_like(mats.specular_factor,
                                                       0.9),
                       roughness_factor=torch.full_like(mats.roughness_factor,
                                                        0.7))
    gb_sg, img_sg = _render(port, scene._replace(materials=sg), info)
    _, img_mr = _render(port, scene, info)
    hit = gb_sg.hit.numpy()
    assert np.isfinite(img_sg).all()
    assert img_sg[hit].mean() != pytest.approx(img_mr[hit].mean(), rel=0.01)


def test_port_glass_furnace_energy():
    """tests/test_furnace.py's glass furnace on the port: a transmissive
    white sphere in a uniform environment of radiance 0.5 neither glows
    nor goes dark (0.8-1.1 of it at the centre)."""
    lum = 0.5
    env = torch.full((128, 128, 3), lum)
    port = tr.PBRRenderer(PortCI(brdf_lut_dim=32, num_brdf_samples=64,
                                 irradiance_cube_dim=16,
                                 prefiltered_env_map_dim=32,
                                 num_specular_env_samples=64),
                          env_oct=env, raster_cfg=PCFG, device="cpu")
    sphere = tprim.uv_sphere(1.0, stacks=24, slices=32)
    scene = tr.build_scene([(sphere, np.eye(4, dtype=np.float32),
                             ta.PBRMaterialBasicAttribs.create(
                                 base_color_factor=(1.0, 1.0, 1.0, 1.0),
                                 metallic_factor=0.0,
                                 roughness_factor=0.3))], device="cpu")
    scene = scene._replace(materials_transmission=_one(
        ta.PBRMaterialTransmissionAttribs.create(1.0)))
    eye = [0.0, 0.0, 3.0]
    cam = ta.CameraAttribs.create(tm3.look_at(eye, [0, 0, 0]),
                                  tm3.perspective(0.8, 1.0, 0.1, 50.0), eye,
                                  0.1, 50.0, W, H)
    info = tr.RenderInfo(camera=cam, lights=ta.PBRLightAttribs.directional(
        [0, -1, 0], [0.0, 0.0, 0.0]),
        renderer_params=ta.PBRRendererShaderParameters.create())
    _, total = _render(port, scene, info)
    c = total[H // 2 - 20:H // 2 + 20, W // 2 - 20:W // 2 + 20]
    assert np.isfinite(c).all()
    assert lum * 0.80 <= c.mean() <= lum * 1.10, c.mean()
