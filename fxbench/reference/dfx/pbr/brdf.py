"""BRDF math (the port of diligentfx_tpu/pbr/brdf.py): Lambert diffuse,
Schlick Fresnel and its inverse, height-correlated Smith-GGX visibility
(isotropic and anisotropic), the GGX NDFs, Charlie sheen, thin-film
iridescence, GGX and cosine hemisphere sampling and the fitted split-sum
environment BRDF.  Leaves are (..., 3) / (..., 1) tensors.

The JAX package's integer powers (`x ** 2`, `x ** 4`) are XLA
multiplications, written out as multiplies here; small fixed contractions
(the XYZ -> RGB matrix) are explicit multiply-adds, never a matmul, which
could take TF32 on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fxbench.reference.dfx.math3d import dot, normalize, saturate

Tensor = torch.Tensor
PI = 3.141592653589793


def pow5(x):
    x2 = x * x
    return x2 * x2 * x


def lambertian_diffuse(diffuse_color: Tensor) -> Tensor:
    return diffuse_color / PI


def schlick_reflection(vdoth: Tensor, r0: Tensor, r90: Tensor) -> Tensor:
    """Schlick Fresnel (PBR_Common.fxh:82-91)."""
    return r0 + (r90 - r0) * pow5(torch.clamp(1.0 - vdoth, 0.0, 1.0))


def smith_ggx_visibility_correlated(ndotl, ndotv, alpha_roughness) -> Tensor:
    """Height-correlated Smith GGX visibility (PBR_Common.fxh:107-123)."""
    a2 = alpha_roughness * alpha_roughness
    ggx_v = ndotl * torch.sqrt(torch.clamp(ndotv * ndotv * (1.0 - a2) + a2,
                                           min=1e-7))
    ggx_l = ndotv * torch.sqrt(torch.clamp(ndotl * ndotl * (1.0 - a2) + a2,
                                           min=1e-7))
    return 0.5 / torch.clamp(ggx_v + ggx_l, min=1e-9)


def smith_ggx_visibility_correlated_anisotropic(
        ndotl, ndotv, tdotl, tdotv, bdotl, bdotv, alpha_t, alpha_b) -> Tensor:
    """PBR_Common.fxh:126-138 (Filament's anisotropic model)."""
    tv, bv = alpha_t * tdotv, alpha_b * bdotv
    tl, bl = alpha_t * tdotl, alpha_b * bdotl
    lv = ndotl * torch.clamp(torch.sqrt(tv * tv + bv * bv + ndotv * ndotv),
                             min=1e-3)
    ll = ndotv * torch.clamp(torch.sqrt(tl * tl + bl * bl + ndotl * ndotl),
                             min=1e-3)
    return 0.5 / torch.clamp(lv + ll, min=1e-9)


def ndf_ggx(ndoth: Tensor, alpha_roughness) -> Tensor:
    """GGX normal distribution (PBR_Common.fxh:181-194)."""
    a = torch.clamp(torch.as_tensor(alpha_roughness, dtype=torch.float32,
                                    device=ndoth.device), min=1e-3)
    a2 = a * a
    nh2 = ndoth * ndoth
    f = nh2 * a2 + (1.0 - nh2)
    return a2 / torch.clamp(PI * f * f, min=1e-9)


def ndf_ggx_anisotropic(ndoth, tdoth, bdoth, alpha_t, alpha_b) -> Tensor:
    """PBR_Common.fxh:197-208."""
    a2 = alpha_t * alpha_b
    x, y, z = alpha_b * tdoth, alpha_t * bdoth, a2 * ndoth
    v2 = x * x + y * y + z * z
    w2 = a2 / torch.clamp(v2, min=1e-6)
    return a2 * w2 * w2 * (1.0 / PI)


class AngularInfo(NamedTuple):
    ndotl: Tensor
    ndotv: Tensor
    ndoth: Tensor
    vdoth: Tensor
    h: Tensor


def get_angular_info(point_to_light: Tensor, normal: Tensor,
                     view: Tensor) -> AngularInfo:
    l = normalize(point_to_light)
    v = normalize(view)
    h = normalize(l + v)
    return AngularInfo(ndotl=saturate(dot(normal, l)),
                       ndotv=saturate(dot(normal, v)),
                       ndoth=saturate(dot(normal, h)),
                       vdoth=saturate(dot(v, h)), h=h)


class SurfaceReflectanceInfo(NamedTuple):
    perceptual_roughness: Tensor  # (..., 1)
    diffuse_color: Tensor         # (..., 3)
    reflectance0: Tensor          # (..., 3)
    reflectance90: Tensor         # (..., 3)


def smith_ggx_brdf(point_to_light: Tensor, normal: Tensor, view: Tensor,
                   srf: SurfaceReflectanceInfo
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """Cook-Torrance with correlated Smith-GGX (PBR_Common.fxh:371-404).
    Returns (diffuse_contrib, spec_contrib, ndotl)."""
    ang = get_angular_info(point_to_light, normal, view)
    alpha = srf.perceptual_roughness * srf.perceptual_roughness
    d = ndf_ggx(ang.ndoth, alpha)
    vis = smith_ggx_visibility_correlated(ang.ndotl, ang.ndotv, alpha)
    f = schlick_reflection(ang.vdoth, srf.reflectance0, srf.reflectance90)
    lit = (ang.ndotl > 0.0) | (ang.ndotv > 0.0)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    diffuse = torch.where(lit, (1.0 - f) * lambertian_diffuse(srf.diffuse_color),
                          zero)
    spec = torch.where(lit, f * (vis * d), zero)
    return diffuse, spec, ang.ndotl


def smith_ggx_brdf_anisotropic(point_to_light, normal, view, tangent,
                               bitangent, srf: SurfaceReflectanceInfo,
                               alpha_t, alpha_b
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """PBR_Common.fxh:407-457: (diffuse_contrib, spec_contrib, ndotl)."""
    ang = get_angular_info(point_to_light, normal, view)
    l = normalize(point_to_light)
    v = normalize(view)
    d = ndf_ggx_anisotropic(ang.ndoth, dot(tangent, ang.h),
                            dot(bitangent, ang.h), alpha_t, alpha_b)
    vis = smith_ggx_visibility_correlated_anisotropic(
        ang.ndotl, ang.ndotv, dot(tangent, l), dot(tangent, v),
        dot(bitangent, l), dot(bitangent, v), alpha_t, alpha_b)
    f = schlick_reflection(ang.vdoth, srf.reflectance0, srf.reflectance90)
    lit = (ang.ndotl > 0.0) | (ang.ndotv > 0.0)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    diffuse = torch.where(lit, (1.0 - f) * lambertian_diffuse(srf.diffuse_color),
                          zero)
    spec = torch.where(lit, f * (vis * d), zero)
    return diffuse, spec, ang.ndotl


# ---------------------------------------------------------------------------
# Charlie sheen (PBR_Common.fxh:460-511)
# ---------------------------------------------------------------------------


def ndf_charlie(ndoth: Tensor, sheen_roughness: Tensor) -> Tensor:
    r = torch.clamp(sheen_roughness, min=1e-6)
    alpha = r * r
    inv_a = 1.0 / alpha
    sin2h = torch.clamp(1.0 - ndoth * ndoth, min=0.0078125)
    return (2.0 + inv_a) * torch.pow(sin2h, inv_a * 0.5) / (2.0 * PI)


def _lambda_sheen_helper(x, alpha_g: Tensor) -> Tensor:
    t = 1.0 - alpha_g
    om = t * t
    a = 21.5473 + (25.32450 - 21.5473) * om
    b = 3.82987 + (3.32435 - 3.82987) * om
    c = 0.19823 + (0.16801 - 0.19823) * om
    d = -1.97760 + (-1.27393 + 1.97760) * om
    e = -4.32054 + (-4.85967 + 4.32054) * om
    x = torch.as_tensor(x, dtype=torch.float32, device=alpha_g.device)
    return a / (1.0 + b * torch.pow(torch.clamp(x, min=1e-12), c)) + d * x + e


def lambda_sheen(cos_theta: Tensor, alpha_g: Tensor) -> Tensor:
    ac = torch.abs(cos_theta)
    lo = torch.exp(_lambda_sheen_helper(ac, alpha_g))
    hi = torch.exp(2.0 * _lambda_sheen_helper(0.5, alpha_g)
                   - _lambda_sheen_helper(torch.clamp(1.0 - ac, min=1e-12),
                                          alpha_g))
    return torch.where(ac < 0.5, lo, hi)


def sheen_visibility(ndotl, ndotv, sheen_roughness) -> Tensor:
    r = torch.clamp(sheen_roughness, min=1e-6)
    alpha_g = r * r
    return saturate(1.0 / ((1.0 + lambda_sheen(ndotv, alpha_g)
                            + lambda_sheen(ndotl, alpha_g))
                           * torch.clamp(4.0 * ndotv * ndotl, min=5e-8)))


def sheen_specular_brdf(sheen_color, sheen_roughness, ndotl, ndotv,
                        ndoth) -> Tensor:
    """PBR_Common.fxh:504-509."""
    return sheen_color * ndf_charlie(ndoth, sheen_roughness) * \
        sheen_visibility(ndotl, ndotv, sheen_roughness)


# ---------------------------------------------------------------------------
# Thin-film iridescence (Belcour & Barla 2017, as KHR_materials_iridescence
# specifies it; the analogue of Shaders/PBR/private/Iridescence.fxh)
# ---------------------------------------------------------------------------

_SENS_VAL = (5.4856e-13, 4.4201e-13, 5.2481e-13)
_SENS_POS = (1.6810e6, 1.7953e6, 2.2084e6)
_SENS_VAR = (4.3278e9, 9.3046e9, 6.6121e9)
_XYZ_TO_RGB_ROWS = ((3.2404542, -1.5371385, -0.4985314),
                    (-0.9692660, 1.8760108, 0.0415560),
                    (0.0556434, -0.2040259, 1.0572252))


def sample_ggx_half_vector(u1, u2, alpha_roughness: Tensor) -> Tensor:
    """GGX NDF sample in tangent space, z-up (split-sum precompute)."""
    a2 = alpha_roughness * alpha_roughness
    cos_theta2 = (1.0 - u1) / (1.0 + (a2 - 1.0) * u1)
    cos_theta = torch.sqrt(torch.clamp(cos_theta2, min=0.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta2, min=0.0))
    phi = 2.0 * PI * u2
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def smith_ggx_sample_visible_normal(view_ts: Tensor, ax, ay, u1: Tensor,
                                    u2: Tensor) -> Tensor:
    """VNDF sampling (Heitz 2018), PBR_Common.fxh:222-268.  view_ts: (..., 3)
    tangent-space view, z-up; ax, ay broadcast against u1."""
    ax = torch.broadcast_to(torch.as_tensor(ax, dtype=u1.dtype,
                                            device=u1.device), u1.shape)
    ay = torch.broadcast_to(torch.as_tensor(ay, dtype=u1.dtype,
                                            device=u1.device), u1.shape)
    v = normalize(view_ts * torch.stack([ax, ay, torch.ones_like(u1)], dim=-1))
    lensq = v[..., 0] ** 2 + v[..., 1] ** 2
    inv = torch.rsqrt(torch.clamp(lensq, min=1e-12))
    t1 = torch.where(lensq[..., None] > 1e-9,
                     torch.stack([-v[..., 1] * inv, v[..., 0] * inv,
                                  torch.zeros_like(inv)], dim=-1),
                     torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype,
                                  device=v.device))
    t2 = torch.linalg.cross(v, t1, dim=-1)
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    n = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    n = torch.stack([ax * n[..., 0], ay * n[..., 1],
                     torch.clamp(n[..., 2], min=0.0)], dim=-1)
    return normalize(n)


def _cheb_list(x: Tensor, k: int) -> list:
    """T_0..T_{k-1} of 2x-1 as a list of per-pixel planes."""
    t = 2.0 * x - 1.0
    outs = [torch.ones_like(t), t]
    for _ in range(2, k):
        outs.append(2.0 * t * outs[-1] - outs[-2])
    return outs[:k]


def env_brdf_fitted(ndotv: Tensor, perceptual_roughness: Tensor,
                    coeffs: Tensor) -> Tensor:
    """Split-sum env BRDF (A, B) from the tensor-Chebyshev fit of the
    preintegrated GGX LUT (ibl.fit_env_brdf) -> (..., 2)."""
    k = coeffs.shape[0]
    tn = _cheb_list(ndotv[..., 0], k)
    tr = _cheb_list(perceptual_roughness[..., 0], k)
    a = torch.zeros_like(tn[0])
    b = torch.zeros_like(tn[0])
    for i in range(k):
        ai = torch.zeros_like(tr[0])
        bi = torch.zeros_like(tr[0])
        for j in range(k):
            ai = ai + tr[j] * coeffs[i, j, 0]
            bi = bi + tr[j] * coeffs[i, j, 1]
        a = a + tn[i] * ai
        b = b + tn[i] * bi
    return torch.stack([a, b], dim=-1)
