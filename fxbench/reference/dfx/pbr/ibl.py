"""IBL precompute (the port of diligentfx_tpu/pbr/ibl.py): split-sum BRDF
LUT, the Charlie sheen LUT, SH-9 irradiance, GGX-prefiltered octahedral mip chain, the
tensor-Chebyshev fit of the LUT and the footprint-packed pyramid.

Runs once at PBRRenderer construction; sample loops are plain Python loops
over whole-texture tensor ops.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fxbench.reference.dfx.math3d import normalize, saturate
from fxbench.reference.dfx.ops.sampling import (build_mip_chain,
                                               build_packed_pyramid,
                                               oct_pixel_dirs,
                                               oct_solid_angles,
                                               sample_env_oct, sh9_basis)
from fxbench.reference.dfx.pbr import brdf
from fxbench.reference.dfx.pbr.shading import IBLMaps

Tensor = torch.Tensor
PI = 3.141592653589793


def _hammersley(n: int, device=None) -> Tuple[Tensor, Tensor]:
    """Hammersley point set: (i + 0.5)/n and the base-2 radical inverse."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    m = 0xFFFFFFFF
    bits = ((i << 16) | (i >> 16)) & m
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    u2 = bits.to(torch.float32) * (1.0 / 4294967296.0)
    u1 = (i.to(torch.float32) + 0.5) / n
    return u1, u2


def precompute_brdf_lut(dim: int = 512, num_samples: int = 512,
                        device=None) -> Tensor:
    """(dim, dim, 2): x-axis NdotV, y-axis perceptual roughness; channels =
    (F0 scale, F0 bias) (PrecomputeBRDF.psh)."""
    t = (torch.arange(dim, dtype=torch.float32, device=device) + 0.5) / dim
    r, nv = torch.meshgrid(t, t, indexing="ij")
    nv = torch.clamp(nv, min=1e-3)
    v = torch.stack([torch.sqrt(1.0 - nv * nv), torch.zeros_like(nv), nv],
                    dim=-1)
    alpha = r * r
    u1, u2 = _hammersley(num_samples, device)
    acc = torch.zeros((dim, dim, 2), dtype=torch.float32, device=device)
    for i in range(num_samples):
        h = brdf.sample_ggx_half_vector(u1[i], u2[i], alpha)
        l = 2.0 * torch.sum(v * h, dim=-1, keepdim=True) * h - v
        ndotl = saturate(l[..., 2])
        ndoth = saturate(h[..., 2])
        vdoth = saturate(torch.sum(v * h, dim=-1))
        vis = brdf.smith_ggx_visibility_correlated(ndotl, nv, alpha)
        g_vis = torch.where(ndotl > 0, 4.0 * vis * ndotl * vdoth
                            / torch.clamp(ndoth, min=1e-6),
                            torch.zeros_like(ndotl))
        fc = brdf.pow5(1.0 - vdoth)
        acc = acc + torch.stack([(1.0 - fc) * g_vis, fc * g_vis], dim=-1)
    return acc / num_samples


def precompute_charlie_lut(dim: int = 64, num_samples: int = 256,
                           device=None) -> Tensor:
    """Preintegrated Charlie sheen BRDF (directional albedo), (dim, dim, 1):
    x-axis NdotV, y-axis sheen roughness; uniform hemisphere samples summed
    one after the other, in the JAX package's fori_loop order."""
    t = (torch.arange(dim, dtype=torch.float32, device=device) + 0.5) / dim
    r, nv = torch.meshgrid(t, t, indexing="ij")
    nv = torch.clamp(nv, min=1e-3)
    v = torch.stack([torch.sqrt(1.0 - nv * nv), torch.zeros_like(nv), nv],
                    dim=-1)
    u1, u2 = _hammersley(num_samples, device)
    ones = torch.ones_like(nv)
    acc = torch.zeros_like(nv)
    for i in range(num_samples):
        cos_t = u1[i]
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = 2.0 * PI * u2[i]
        l = torch.stack([sin_t * torch.cos(phi) * ones,
                         sin_t * torch.sin(phi) * ones, cos_t * ones], dim=-1)
        h = normalize(v + l)
        ndotl = saturate(l[..., 2])
        ndoth = saturate(h[..., 2])
        acc = acc + (brdf.ndf_charlie(ndoth, r)
                     * brdf.sheen_visibility(ndotl, nv, r) * ndotl)
    # the pdf of uniform hemisphere sampling is 1 / (2 pi)
    return (acc * (2.0 * PI) / num_samples)[..., None]


_SH_A = (PI, 2.0 * PI / 3.0, 2.0 * PI / 3.0, 2.0 * PI / 3.0,
         PI / 4.0, PI / 4.0, PI / 4.0, PI / 4.0, PI / 4.0)


def project_sh9(env_oct: Tensor) -> Tensor:
    """Octahedral env -> (9, 3) cosine-convolved SH irradiance coefficients
    scaled by 1/pi."""
    r = env_oct.shape[0]
    dirs = oct_pixel_dirs(r, env_oct.device).reshape(-1, 3)
    sa = oct_solid_angles(r, env_oct.device).reshape(-1, 1)
    basis = sh9_basis(dirs)                                    # (P, 9)
    vals = env_oct.reshape(-1, 3) * sa                         # (P, 3)
    l_coeff = torch.sum(basis[:, :, None] * vals[:, None, :], dim=0)
    a = torch.tensor(_SH_A, dtype=torch.float32, device=env_oct.device) / PI
    return l_coeff * a[:, None]


def precompute_irradiance_oct(env_oct: Tensor, out_dim: int = 64) -> Tensor:
    """Octahedral irradiance E(n) = int L(w) max(n.w, 0) dw / pi, evaluated
    from the SH-9 projection."""
    e_coeff = project_sh9(env_oct)
    out_basis = sh9_basis(oct_pixel_dirs(out_dim, env_oct.device))
    irr = sum(out_basis[..., k:k + 1] * e_coeff[k] for k in range(9))
    return torch.clamp(irr, min=0.0)


def prefilter_env_ggx_oct(env_oct: Tensor, base_dim: int = 256,
                          num_mips: int = 7,
                          num_samples: int = 256) -> Tuple[Tensor, ...]:
    """Split-sum specular prefilter: mip m holds the environment convolved
    with GGX of roughness m/(num_mips-1) (PrefilterEnvMap.psh), with
    filtered importance sampling from a box mip chain of the source."""
    dev = env_oct.device
    src_mips = build_mip_chain(env_oct, 6)
    src_res = env_oct.shape[0]
    u1, u2 = _hammersley(num_samples, dev)
    out = []
    for m in range(num_mips):
        dim = max(base_dim >> m, 4)
        rough = m / max(num_mips - 1, 1)
        alpha = max(rough * rough, 1e-4)
        n = oct_pixel_dirs(dim, dev)
        up = torch.where(torch.abs(n[..., 1:2]) < 0.999,
                         torch.tensor([0.0, 1.0, 0.0], device=dev).expand(n.shape),
                         torch.tensor([1.0, 0.0, 0.0], device=dev).expand(n.shape))
        t = normalize(torch.linalg.cross(up, n, dim=-1))
        b = torch.linalg.cross(n, t, dim=-1)
        if m == 0:
            out.append(env_oct if env_oct.shape[0] == dim else
                       sample_env_oct([env_oct], n,
                                      torch.zeros(n.shape[:-1], device=dev)))
            continue
        alpha_t = torch.tensor(alpha, dtype=torch.float32, device=dev)
        color = torch.zeros((dim, dim, 3), dtype=torch.float32, device=dev)
        weight = torch.zeros((dim, dim, 1), dtype=torch.float32, device=dev)
        sa_texel = 4.0 * PI / (src_res * src_res)
        for i in range(num_samples):
            h_ts = brdf.sample_ggx_half_vector(u1[i], u2[i], alpha_t)
            h = h_ts[0] * t + h_ts[1] * b + h_ts[2] * n
            l = normalize(2.0 * torch.sum(n * h, dim=-1, keepdim=True) * h - n)
            ndotl = saturate(torch.sum(n * l, dim=-1))
            ndoth = saturate(torch.sum(n * h, dim=-1))
            pdf = brdf.ndf_ggx(ndoth, alpha_t) * ndoth / torch.clamp(
                4.0 * ndoth, min=1e-6) + 1e-6
            sa_sample = 1.0 / (num_samples * pdf)
            lod = torch.clamp(0.5 * torch.log2(sa_sample / sa_texel), 0.0,
                              len(src_mips) - 1.0)
            c = sample_env_oct(src_mips, l, lod)
            w = ndotl[..., None]
            color = color + c * w
            weight = weight + w
        out.append(color / torch.clamp(weight, min=1e-6))
    return tuple(out)


def fit_env_brdf(lut: Tensor, k: int = 8) -> Tensor:
    """Least-squares tensor-Chebyshev fit of the (L, L, 2) preintegrated GGX
    LUT -> (k, k, 2) coefficients for brdf.env_brdf_fitted.  Host numpy in
    float64, once at precompute time."""
    a = lut.detach().cpu().numpy().astype(np.float64)
    dim = a.shape[0]
    nv = (np.arange(dim) + 0.5) / dim
    NV, RG = np.meshgrid(nv, nv, indexing="xy")

    def cheb(x):
        t = 2.0 * x - 1.0
        outs = [np.ones_like(t), t]
        for _ in range(2, k):
            outs.append(2.0 * t * outs[-1] - outs[-2])
        return np.stack(outs[:k], -1)

    bn = cheb(NV.ravel())
    br = cheb(RG.ravel())
    basis = (bn[:, :, None] * br[:, None, :]).reshape(-1, k * k)
    coeffs, *_ = np.linalg.lstsq(basis, a.reshape(-1, 2), rcond=None)
    return torch.as_tensor(coeffs.reshape(k, k, 2), dtype=torch.float32,
                           device=lut.device)


def precompute_ibl_maps(env_oct: Tensor, *, brdf_lut_dim: int = 512,
                        num_brdf_samples: int = 512, irradiance_dim: int = 64,
                        prefiltered_dim: int = 256, num_mips: int = 7,
                        num_spec_samples: int = 256,
                        charlie_dim: int = 64) -> IBLMaps:
    """One-stop IBL precompute (PBR_Renderer::PrecomputeCubemaps).  The
    sheen albedo-scaling LUT is the Charlie LUT itself (the same integral,
    as in the JAX package)."""
    lut = precompute_brdf_lut(brdf_lut_dim, num_brdf_samples, env_oct.device)
    charlie = precompute_charlie_lut(charlie_dim, 256, env_oct.device)
    pref = prefilter_env_ggx_oct(env_oct, prefiltered_dim, num_mips,
                                 num_spec_samples)
    return IBLMaps(
        irradiance=precompute_irradiance_oct(env_oct, irradiance_dim),
        prefiltered=pref,
        preintegrated_ggx=lut,
        preintegrated_charlie=charlie,
        sheen_albedo_scaling=charlie,
        irradiance_sh=project_sh9(env_oct),
        env_brdf_coeffs=fit_env_brdf(lut),
        pref_packed=build_packed_pyramid(pref),
    )
