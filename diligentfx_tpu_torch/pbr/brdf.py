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

from diligentfx_tpu_torch.math3d import dot, normalize, saturate

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


def schlick_to_f0(vdoth: Tensor, f: Tensor, f90: Tensor) -> Tensor:
    """Inverse Schlick (PBR_Common.fxh:92-104)."""
    x5 = torch.clamp(pow5(torch.clamp(1.0 - vdoth, 0.0, 1.0)), 0.0, 0.9999)
    return (f - f90 * x5) / (1.0 - x5)


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


def _eval_sensitivity(opd_nm: Tensor, shift: Tensor) -> Tensor:
    """CIE-XYZ sensitivity of thin-film interference at the optical path
    difference `opd_nm` (...,) with the phase shift (..., 3) -> (..., 3)."""
    dev = opd_nm.device

    def c3(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    val, pos, var = c3(_SENS_VAL), c3(_SENS_POS), c3(_SENS_VAR)
    phase = 2.0 * PI * opd_nm[..., None] * 1e-9
    xyz = (val * torch.sqrt(2.0 * PI * var) * torch.cos(pos * phase + shift)
           * torch.exp(-var * phase * phase))
    p0 = phase[..., 0]
    x_extra = (9.7470e-14 * torch.sqrt(c3(2.0 * PI * 4.5282e9))
               * torch.cos(2.2399e6 * p0 + shift[..., 0])
               * torch.exp(-4.5282e9 * (p0 * p0)))
    xyz = torch.cat([(xyz[..., 0] + x_extra)[..., None], xyz[..., 1:]],
                    dim=-1)
    return xyz / 1.0685e-7


def _f0_to_ior(f0: Tensor) -> Tensor:
    s = torch.sqrt(torch.clamp(f0, 0.0, 0.9999))
    return (1.0 + s) / torch.clamp(1.0 - s, min=1e-4)


def _ior_to_f0(ior_t: Tensor, ior_i) -> Tensor:
    r = (ior_t - ior_i) / torch.clamp(ior_t + ior_i, min=1e-6)
    return r * r


def iridescence_fresnel(outside_ior, iridescence_ior: Tensor,
                        base_f0: Tensor, thickness_nm: Tensor,
                        cos_theta1: Tensor) -> Tensor:
    """Thin-film iridescence Fresnel -> (..., 3) RGB (JAX brdf.py:259;
    Schlick interfaces, interference orders m = 1, 2).  Arguments
    broadcast together; thickness in nanometers; cos_theta1 (..., 1)."""
    dev = base_f0.device
    eta1 = torch.as_tensor(outside_ior, dtype=torch.float32, device=dev)
    thin = torch.clamp(thickness_nm / 400.0, 0.0, 1.0)
    eta2 = eta1 + (torch.clamp(iridescence_ior, min=1.0001) - eta1) * \
        (1.0 - (1.0 - thin))
    eta2 = torch.clamp(eta2, min=1.0001)
    ct1 = torch.clamp(cos_theta1, 1e-4, 1.0)
    ratio = eta1 / eta2
    sin2 = (1.0 - ct1 * ct1) * (ratio * ratio)
    ct2 = torch.sqrt(torch.clamp(1.0 - sin2, min=0.0))
    pi = torch.full((), PI, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # air -> film interface (Schlick, scalar)
    r0_12 = _ior_to_f0(eta2, eta1)
    r12 = schlick_reflection(ct1, r0_12, torch.ones_like(r0_12))
    t121 = 1.0 - r12
    phi12 = torch.where(eta2 < eta1, pi, zero)
    phi21 = PI - phi12
    # film -> base interface, per channel of the base F0
    base_ior = _f0_to_ior(base_f0)
    r0_23 = _ior_to_f0(base_ior, eta2)
    r23 = schlick_reflection(ct2, r0_23, torch.ones_like(r0_23))
    phi23 = torch.where(base_ior < eta2, pi, zero)
    opd = (2.0 * eta2 * thickness_nm * ct2)[..., 0]
    phi = phi21 + phi23
    r123 = torch.clamp(r12 * r23, 1e-5, 0.9999)
    sqrt_r123 = torch.sqrt(r123)
    rs = (t121 * t121) * r23 / torch.clamp(1.0 - r123, min=1e-6)
    intensity = r12 + rs                       # m = 0
    cm = rs - t121
    for m in (1, 2):
        cm = cm * sqrt_r123
        sm = 2.0 * _eval_sensitivity(m * opd, m * phi)
        intensity = intensity + cm * sm
    i0, i1, i2 = intensity[..., 0], intensity[..., 1], intensity[..., 2]
    rgb = torch.stack([r[0] * i0 + r[1] * i1 + r[2] * i2
                       for r in _XYZ_TO_RGB_ROWS], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0)


def sample_ggx_half_vector(u1, u2, alpha_roughness: Tensor) -> Tensor:
    """GGX NDF sample in tangent space, z-up (split-sum precompute)."""
    a2 = alpha_roughness * alpha_roughness
    cos_theta2 = (1.0 - u1) / (1.0 + (a2 - 1.0) * u1)
    cos_theta = torch.sqrt(torch.clamp(cos_theta2, min=0.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta2, min=0.0))
    phi = 2.0 * PI * u2
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def sample_hemisphere_cosine(u1: Tensor, u2: Tensor) -> Tensor:
    """Cosine-weighted hemisphere sample, tangent space z-up."""
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], dim=-1)


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
