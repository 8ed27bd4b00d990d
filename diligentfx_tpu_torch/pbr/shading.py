"""Surface shading (the port of diligentfx_tpu/pbr/shading.py, base layer):
metallic-roughness / specular-glossiness reflectance, punctual lights with
range windowing (PBR_Shading.fxh:601-722) and multiple-scattering IBL
(PBR_Shading.fxh:724-795).  Every function shades whole framebuffers; the
light loop is a static Python loop over the (small) light count.

The extension layers (clear coat, sheen, anisotropy, iridescence,
transmission) are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from diligentfx_tpu_torch.attribs import LightType, PBRLightAttribs
from diligentfx_tpu_torch.math3d import normalize, reflect, saturate
from diligentfx_tpu_torch.ops.sampling import (bilinear_sample, dir_to_oct_uv,
                                               point_sample,
                                               sample_pyramid_packed, sh9_eval)
from diligentfx_tpu_torch.pbr import brdf
from diligentfx_tpu_torch.pbr.brdf import SurfaceReflectanceInfo

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


class SurfaceShadingInfo(NamedTuple):
    """PBR_Shading.fxh:515-552, base layer."""
    pos: Tensor
    view: Tensor
    occlusion: Tensor
    emissive: Tensor
    base: BaseLayerShadingInfo
    ibl_scale: Tensor


class LayerLightingInfo(NamedTuple):
    punctual: Tensor
    diffuse_ibl: Tensor
    specular_ibl: Tensor


def default_lighting(shape_like: Tensor) -> LayerLightingInfo:
    z = torch.zeros(shape_like.shape[:-1] + (3,), dtype=torch.float32,
                    device=shape_like.device)
    return LayerLightingInfo(z, z, z)


class IBLMaps(NamedTuple):
    """Precomputed IBL resources (pbr/ibl.py): octahedral irradiance, the
    GGX prefiltered octahedral mip chain, the split-sum LUT, the SH-9
    irradiance, the Chebyshev fit of the LUT and the footprint-packed
    prefiltered pyramid."""
    irradiance: Tensor            # (R, R, 3)
    prefiltered: Tuple[Tensor, ...]
    preintegrated_ggx: Tensor     # (L, L, 2)
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
                          lighting: LayerLightingInfo,
                          shadow_factors: Optional[Tensor] = None
                          ) -> LayerLightingInfo:
    """Accumulate all punctual lights (RenderPBR.psh:479-499).

    shadow_factors: optional (N_lights, H, W) visibility in [0, 1] from the
    shadow pass, applied to the lights with a shadow map index >= 0 (JAX
    shading.py:231-249)."""
    base_p = lighting.punctual
    for i in range(lights.count):
        prop_dir, att = _light_attenuation(shading.pos, lights, i)
        if shadow_factors is not None:
            att = att * torch.where(lights.shadow_map_index[i] >= 0,
                                    shadow_factors[i][..., None],
                                    torch.ones_like(att))
        intensity = lights.intensity[i] * att
        diffuse, spec, ndotl = brdf.smith_ggx_brdf(
            -prop_dir, shading.base.normal, shading.view, shading.base.srf)
        base_p = base_p + (diffuse + spec) * intensity * ndotl
    return lighting._replace(punctual=base_p)


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
              lighting: LayerLightingInfo,
              fast_env: bool = False) -> LayerLightingInfo:
    """ApplyIBL, multiple-scattering variant (JAX shading.py:333)."""
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

    irradiance = torch.clamp(sh9_eval(n, maps.irradiance_sh), min=0.0)
    fss_ess = k_s * pre_int[..., 0:1] + pre_int[..., 1:2]
    ess = pre_int[..., 0:1] + pre_int[..., 1:2]
    ems = 1.0 - ess
    favg = srf.reflectance0 + (1.0 - srf.reflectance0) / 21.0
    fms = fss_ess * favg / (1.0 - ems * favg)
    edss = 1.0 - (fss_ess + fms * ems)
    k_d = srf.diffuse_color * edss
    diffuse_ibl = (fms * ems + k_d) * irradiance

    l = normalize(reflect(-v, n))
    lod = srf.perceptual_roughness[..., 0] * last_mip
    spec_light = _sample_prefiltered(maps, l, lod)
    specular_ibl = spec_light * (k_s * pre_int[..., 0:1] + pre_int[..., 1:2])
    return lighting._replace(diffuse_ibl=diffuse_ibl,
                             specular_ibl=specular_ibl)



def resolve_lighting(shading: SurfaceShadingInfo,
                     lighting: LayerLightingInfo) -> Tensor:
    """Final forward colour of the base layer (JAX shading.py:450):
    punctual + occluded, scaled IBL + emissive."""
    base_ibl = ((lighting.diffuse_ibl + lighting.specular_ibl)
                * shading.ibl_scale * shading.occlusion)
    return lighting.punctual + base_ibl + shading.emissive
