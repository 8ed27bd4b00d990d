"""Surface shading (the port of diligentfx_tpu/pbr/shading.py):
metallic-roughness / specular-glossiness / clear-coat reflectance, punctual
lights with range windowing (PBR_Shading.fxh:601-722) and
multiple-scattering IBL (PBR_Shading.fxh:724-795), layered as the JAX
package layers them: the base layer, the sheen layer and the clear coat
(ResolveLighting, PBR_Shading.fxh:847-879), with anisotropy, iridescence,
transmission and volume acting on the base layer.  Every function shades
whole framebuffers; the light loop is a static Python loop over the
(small) light count.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from fxbench.reference.dfx.attribs import LightType, PBRLightAttribs
from fxbench.reference.dfx import math3d as m3
from fxbench.reference.dfx.math3d import normalize, reflect, saturate
from fxbench.reference.dfx.ops.sampling import (bilinear_sample, dir_to_oct_uv,
                                               point_sample,
                                               sample_pyramid_packed, sh9_eval)
from fxbench.reference.dfx.pbr import brdf
from fxbench.reference.dfx.pbr.brdf import SurfaceReflectanceInfo

Tensor = torch.Tensor

PBR_WORKFLOW_METALLIC_ROUGHNESS = 0
PBR_WORKFLOW_SPECULAR_GLOSSINESS = 1
PBR_WORKFLOW_UNLIT = 2


def get_surface_reflectance_mr(base_color: Tensor, metallic: Tensor,
                               roughness: Tensor) -> SurfaceReflectanceInfo:
    """Metallic-roughness workflow (PBR_Shading.fxh:431-452)."""
    f0 = 0.04
    refl0 = f0 + (base_color - f0) * metallic
    max_r0 = torch.amax(refl0, dim=-1, keepdim=True)
    r90 = torch.clamp(max_r0 * 50.0, max=1.0)
    return SurfaceReflectanceInfo(
        perceptual_roughness=torch.clamp(roughness, 0.0, 1.0),
        diffuse_color=base_color * ((1.0 - f0) * (1.0 - metallic)),
        reflectance0=refl0,
        reflectance90=r90.expand(refl0.shape))


def get_surface_reflectance_sg(base_color: Tensor, specular: Tensor,
                               glossiness: Tensor) -> SurfaceReflectanceInfo:
    """Specular-glossiness workflow (PBR_Shading.fxh:390-402)."""
    one_minus_spec = 1.0 - torch.amax(specular, dim=-1, keepdim=True)
    max_r0 = torch.amax(specular, dim=-1, keepdim=True)
    r90 = torch.clamp(max_r0 * 50.0, 0.0, 1.0)
    return SurfaceReflectanceInfo(
        perceptual_roughness=torch.clamp(1.0 - glossiness, 0.0, 1.0),
        diffuse_color=base_color * one_minus_spec,
        reflectance0=specular,
        reflectance90=r90.expand(specular.shape))


class BaseLayerShadingInfo(NamedTuple):
    srf: SurfaceReflectanceInfo
    metallic: Tensor   # (..., 1)
    normal: Tensor     # (..., 3)
    ndotv: Tensor      # (..., 1)


class ClearcoatShadingInfo(NamedTuple):
    srf: SurfaceReflectanceInfo
    normal: Tensor
    factor: Tensor


class SheenShadingInfo(NamedTuple):
    color: Tensor
    roughness: Tensor


class AnisotropyShadingInfo(NamedTuple):
    strength: Tensor
    tangent: Tensor
    bitangent: Tensor
    alpha_roughness_t: Tensor
    alpha_roughness_b: Tensor


class IridescenceShadingInfo(NamedTuple):
    factor: Tensor
    thickness: Tensor
    fresnel: Tensor
    f0: Tensor


class SurfaceShadingInfo(NamedTuple):
    """PBR_Shading.fxh:515-552.  An optional layer is None when no material
    of the scene uses it (the analogue of #if ENABLE_*);
    volume_attenuation is the per-pixel Beer-Lambert extinction (..., 3)."""
    pos: Tensor
    view: Tensor
    occlusion: Tensor
    emissive: Tensor
    base: BaseLayerShadingInfo
    ibl_scale: Tensor
    clearcoat: Optional[ClearcoatShadingInfo] = None
    sheen: Optional[SheenShadingInfo] = None
    anisotropy: Optional[AnisotropyShadingInfo] = None
    iridescence: Optional[IridescenceShadingInfo] = None
    transmission: Optional[Tensor] = None
    volume_thickness: Optional[Tensor] = None
    volume_attenuation: Optional[Tensor] = None


class LayerLightingInfo(NamedTuple):
    punctual: Tensor
    diffuse_ibl: Tensor
    specular_ibl: Tensor


class SurfaceLightingInfo(NamedTuple):
    """The base layer and the optional sheen and clear-coat layers."""
    base: LayerLightingInfo
    sheen: Optional[LayerLightingInfo] = None
    clearcoat: Optional[LayerLightingInfo] = None


def default_lighting(shape_like: Tensor, with_sheen: bool = False,
                     with_clearcoat: bool = False) -> SurfaceLightingInfo:
    z = torch.zeros(shape_like.shape[:-1] + (3,), dtype=torch.float32,
                    device=shape_like.device)
    layer = LayerLightingInfo(z, z, z)
    return SurfaceLightingInfo(base=layer,
                               sheen=layer if with_sheen else None,
                               clearcoat=layer if with_clearcoat else None)


class IBLMaps(NamedTuple):
    """Precomputed IBL resources (pbr/ibl.py): octahedral irradiance, the
    GGX prefiltered octahedral mip chain, the split-sum LUT, the Charlie
    sheen LUT and the sheen albedo-scaling LUT (the same array), the SH-9
    irradiance, the Chebyshev fit of the LUT and the footprint-packed
    prefiltered pyramid."""
    irradiance: Tensor            # (R, R, 3)
    prefiltered: Tuple[Tensor, ...]
    preintegrated_ggx: Tensor     # (L, L, 2)
    preintegrated_charlie: Tensor  # (L, L, 1)
    sheen_albedo_scaling: Tensor  # (L, L, 1)
    irradiance_sh: Tensor         # (9, 3)
    env_brdf_coeffs: Tensor       # (K, K, 2)
    pref_packed: Tensor           # (R, 40)

    def to(self, device) -> "IBLMaps":
        return IBLMaps(*(tuple(t.to(device) for t in x) if isinstance(x, tuple)
                         else x.to(device) for x in self))


# ---------------------------------------------------------------------------
# Punctual lights
# ---------------------------------------------------------------------------


def _light_attenuation(shading_pos: Tensor, light: PBRLightAttribs, i: int):
    """Returns (propagation direction (..., 3), attenuation (..., 1)).
    Light type tests stay tensors, so no host synchronisation."""
    ltype = light.type[i]
    lpos = light.position[i]
    ldir = light.direction[i]
    to_point = shading_pos - lpos
    dist2 = torch.clamp(torch.sum(to_point * to_point, dim=-1, keepdim=True),
                        min=1e-9)
    lt_dir = to_point / torch.sqrt(dist2)
    range_att = 1.0 / dist2
    range4 = light.range4[i]
    windowed = saturate(1.0 - (dist2 * dist2) / range4)
    range_att = torch.where(torch.isfinite(range4) & (range4 > 0),
                            range_att * windowed, range_att)
    cos_angle = torch.sum(lt_dir * ldir, dim=-1, keepdim=True)
    ang_att = saturate(cos_angle * light.spot_angle_scale[i]
                       + light.spot_angle_offset[i])
    is_dir = ltype == LightType.DIRECTIONAL
    is_spot = ltype == LightType.SPOT
    one = torch.ones((), dtype=torch.float32, device=shading_pos.device)
    att = torch.where(is_dir, one,
                      range_att * torch.where(is_spot, ang_att, one))
    prop_dir = torch.where(is_dir | is_spot, ldir.expand(lt_dir.shape), lt_dir)
    return prop_dir, att


def apply_punctual_lights(shading: SurfaceShadingInfo, lights: PBRLightAttribs,
                          lighting: SurfaceLightingInfo,
                          shadow_factors: Optional[Tensor] = None,
                          sheen_albedo_scaling_lut: Optional[Tensor] = None
                          ) -> SurfaceLightingInfo:
    """Accumulate all punctual lights (RenderPBR.psh:479-499) into the
    base, sheen and clear-coat layers (JAX shading.py:229).

    shadow_factors: optional (N_lights, H, W) visibility in [0, 1] from the
    shadow pass, applied to the lights with a shadow map index >= 0.
    sheen_albedo_scaling_lut: the sheen layer's albedo scaling
    (PBR_Shading.fxh:705-712); without it the crude 1 - 0.25 max_f."""
    base_p = lighting.base.punctual
    sheen_p = lighting.sheen.punctual if lighting.sheen is not None else None
    cc_p = (lighting.clearcoat.punctual if lighting.clearcoat is not None
            else None)
    for i in range(lights.count):
        prop_dir, att = _light_attenuation(shading.pos, lights, i)
        if shadow_factors is not None:
            att = att * torch.where(lights.shadow_map_index[i] >= 0,
                                    shadow_factors[i][..., None],
                                    torch.ones_like(att))
        intensity = lights.intensity[i] * att
        if shading.anisotropy is not None:
            a = shading.anisotropy
            diffuse, spec, ndotl = brdf.smith_ggx_brdf_anisotropic(
                -prop_dir, shading.base.normal, shading.view, a.tangent,
                a.bitangent, shading.base.srf, a.alpha_roughness_t,
                a.alpha_roughness_b)
        else:
            diffuse, spec, ndotl = brdf.smith_ggx_brdf(
                -prop_dir, shading.base.normal, shading.view,
                shading.base.srf)
        if shading.transmission is not None:
            diffuse = diffuse * (1.0 - shading.transmission)
        contrib = (diffuse + spec) * intensity * ndotl
        if shading.sheen is not None:
            ang = brdf.get_angular_info(-prop_dir, shading.base.normal,
                                        shading.view)
            sheen_p = sheen_p + brdf.sheen_specular_brdf(
                shading.sheen.color, shading.sheen.roughness, ang.ndotl,
                ang.ndotv, ang.ndoth) * intensity * ang.ndotl
            max_f = torch.amax(shading.sheen.color, dim=-1, keepdim=True)
            if sheen_albedo_scaling_lut is not None:
                lut = sheen_albedo_scaling_lut
                e_v = bilinear_sample(lut, torch.cat(
                    [shading.base.ndotv, shading.sheen.roughness], dim=-1))
                e_l = bilinear_sample(lut, torch.cat(
                    [ndotl, shading.sheen.roughness], dim=-1))
                scaling = torch.minimum(1.0 - max_f * e_v, 1.0 - max_f * e_l)
            else:
                scaling = 1.0 - 0.25 * max_f
            contrib = contrib * scaling
        base_p = base_p + contrib
        if shading.clearcoat is not None:
            _, cspec, cndotl = brdf.smith_ggx_brdf(
                -prop_dir, shading.clearcoat.normal, shading.view,
                shading.clearcoat.srf)
            cc_p = cc_p + cspec * intensity * cndotl

    def mk(layer, p):
        return layer._replace(punctual=p) if layer is not None else None
    return SurfaceLightingInfo(base=lighting.base._replace(punctual=base_p),
                               sheen=mk(lighting.sheen, sheen_p),
                               clearcoat=mk(lighting.clearcoat, cc_p))


# ---------------------------------------------------------------------------
# IBL
# ---------------------------------------------------------------------------


def _sample_prefiltered(maps: IBLMaps, direction: Tensor,
                        lod: Tensor) -> Tensor:
    """Prefiltered env sample through the footprint-packed pyramid (full
    trilinear quality, one row gather per pixel)."""
    return sample_pyramid_packed(
        maps.pref_packed, tuple(m.shape[0] for m in maps.prefiltered),
        dir_to_oct_uv(direction), lod)


def apply_ibl(shading: SurfaceShadingInfo, maps: IBLMaps,
              lighting: SurfaceLightingInfo,
              fast_env: bool = False) -> SurfaceLightingInfo:
    """ApplyIBL, multiple-scattering variant (JAX shading.py:333), with the
    iridescence k_s mix, transmission (refracted prefiltered light with
    Beer-Lambert volume absorption), the anisotropic bent normal and the
    sheen and clear-coat IBL."""
    n = shading.base.normal
    v = shading.view
    srf = shading.base.srf
    ndotv = shading.base.ndotv
    last_mip = float(len(maps.prefiltered) - 1)

    lut_uv = torch.cat([ndotv, srf.perceptual_roughness], dim=-1)
    if fast_env and maps.env_brdf_coeffs is not None:
        pre_int = brdf.env_brdf_fitted(ndotv, srf.perceptual_roughness,
                                       maps.env_brdf_coeffs)
    elif fast_env:
        pre_int = point_sample(maps.preintegrated_ggx, lut_uv)
    else:
        pre_int = bilinear_sample(maps.preintegrated_ggx, lut_uv)

    # roughness-dependent Fresnel (Fdez-Aguera), PBR_Shading.fxh:254-262
    one_minus_r = 1.0 - srf.perceptual_roughness
    refl90 = torch.maximum(one_minus_r.expand(srf.reflectance0.shape),
                           srf.reflectance0)
    k_s = brdf.schlick_reflection(ndotv, srf.reflectance0, refl90)
    if shading.iridescence is not None:
        k_s = k_s + (shading.iridescence.fresnel - k_s) * \
            shading.iridescence.factor

    irradiance = torch.clamp(sh9_eval(n, maps.irradiance_sh), min=0.0)
    fss_ess = k_s * pre_int[..., 0:1] + pre_int[..., 1:2]
    ess = pre_int[..., 0:1] + pre_int[..., 1:2]
    ems = 1.0 - ess
    favg = srf.reflectance0 + (1.0 - srf.reflectance0) / 21.0
    fms = fss_ess * favg / (1.0 - ems * favg)
    edss = 1.0 - (fss_ess + fms * ems)
    k_d = srf.diffuse_color * edss
    diffuse_ibl = (fms * ems + k_d) * irradiance
    if shading.transmission is not None:
        # environment light refracted into the surface (air -> IOR 1.5)
        # replaces the diffuse lobe, tinted by the diffuse colour and
        # absorbed over the volume thickness (Beer-Lambert)
        eta = 1.0 / 1.5
        cos_i = ndotv
        kk = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
        t_dir = m3.normalize(eta * (-v) + (eta * cos_i - torch.sqrt(
            torch.clamp(kk, min=0.0))) * n)
        t_lod = srf.perceptual_roughness[..., 0] * last_mip
        t_light = _sample_prefiltered(maps, t_dir, t_lod)
        if (shading.volume_attenuation is not None
                and shading.volume_thickness is not None):
            t_light = t_light * torch.exp(
                -shading.volume_attenuation
                * torch.clamp(shading.volume_thickness, min=0.0))
        transmitted = t_light * srf.diffuse_color * (1.0 - k_s)
        diffuse_ibl = (diffuse_ibl * (1.0 - shading.transmission)
                       + transmitted * shading.transmission)

    # the specular reflection vector, about the anisotropic bent normal
    # (PBR_Shading.fxh:755-769)
    if shading.anisotropy is not None:
        a = shading.anisotropy
        aniso_tangent = m3.cross(a.bitangent, v)
        aniso_normal = m3.cross(aniso_tangent, a.bitangent)
        bend = 1.0 - a.strength * (1.0 - srf.perceptual_roughness)
        bend2 = bend * bend
        n_spec = m3.normalize(aniso_normal
                              + (n - aniso_normal) * (bend2 * bend2))
    else:
        n_spec = n
    l = normalize(reflect(-v, n_spec))
    lod = srf.perceptual_roughness[..., 0] * last_mip
    spec_light = _sample_prefiltered(maps, l, lod)
    specular_ibl = spec_light * (k_s * pre_int[..., 0:1] + pre_int[..., 1:2])

    new_sheen = lighting.sheen
    if shading.sheen is not None:
        s_uv = torch.cat([ndotv, shading.sheen.roughness], dim=-1)
        s_brdf = bilinear_sample(maps.preintegrated_charlie, s_uv)
        s_lod = shading.sheen.roughness[..., 0] * last_mip
        s_light = _sample_prefiltered(maps, normalize(reflect(-v, n)), s_lod)
        new_sheen = lighting.sheen._replace(
            specular_ibl=s_light * shading.sheen.color * s_brdf)

    new_cc = lighting.clearcoat
    if shading.clearcoat is not None:
        cc = shading.clearcoat
        cc_ndotv = torch.clamp(m3.dot(cc.normal, v), min=0.1)
        cc_uv = torch.cat([cc_ndotv, cc.srf.perceptual_roughness], dim=-1)
        cc_int = bilinear_sample(maps.preintegrated_ggx, cc_uv)
        cc_l = normalize(reflect(-v, cc.normal))
        cc_lod = cc.srf.perceptual_roughness[..., 0] * last_mip
        cc_light = _sample_prefiltered(maps, cc_l, cc_lod)
        new_cc = lighting.clearcoat._replace(
            specular_ibl=cc_light * (cc.srf.reflectance0 * cc_int[..., 0:1]
                                     + cc.srf.reflectance90
                                     * cc_int[..., 1:2]))

    return SurfaceLightingInfo(
        base=lighting.base._replace(diffuse_ibl=diffuse_ibl,
                                    specular_ibl=specular_ibl),
        sheen=new_sheen, clearcoat=new_cc)

