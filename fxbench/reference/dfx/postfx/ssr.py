"""Screen-space reflections (the port of diligentfx_tpu/postfx/ssr.py):
GGX-VNDF jittered reflection rays, a screen-space march over a min-depth
pyramid with a fine-buffer secant, hit-normal rejection and fades, BRDF-
weighted spatial reconstruction, variance-guided temporal accumulation and
a roughness-aware bilateral cleanup, at the processing resolution, then an
upsample.

The route the benchmark's configurations take (the JAX package's
`use_pallas=False`): a fixed-step march of the fine depth (one batched
point tap per step), bilinear radiance tap, bilinear history tap.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fxbench.reference.dfx.attribs import CameraAttribs
from fxbench.reference.dfx.math3d import cross, normalize, reflect, saturate
from fxbench.reference.dfx.ops.sampling import (bilinear_sample, point_sample,
                                               upsample_bilinear)
from fxbench.reference.dfx.pbr.brdf import smith_ggx_sample_visible_normal
from fxbench.reference.dfx.postfx.context import (depth_to_camera_z,
                                                  pixel_grid, r2_noise_pair)
from fxbench.reference.dfx.postfx.ssao import f32, view_space_position

Tensor = torch.Tensor


class SSRSettings(NamedTuple):
    """ScreenSpaceReflectionAttribs analogue."""
    max_traversal_intersections: int = 48      # the fixed-step march budget
    depth_buffer_thickness: float = 0.15       # world units
    roughness_threshold: float = 0.4           # fade out above
    ggx_importance_sample_bias: float = 0.3
    temporal_stability_factor: float = 0.9
    spatial_reconstruction_radius: float = 3.0


class SSRState(NamedTuple):
    radiance: Tensor   # (h, w, 4) rgb + confidence history, processing res


def ssr_state_shape(height: int, width: int, resolution_divisor: int = 0,
                    half_resolution: bool = False) -> Tuple[int, int]:
    """Shape of the temporal history: the march resolution."""
    d = resolution_divisor or (2 if half_resolution else 1)
    return (-(-height // d), -(-width // d))


def _march(fine: Tensor, origin_uvz: Tensor, dir_uvz: Tensor,
           steps: int, thickness_ndc) -> Tuple[Tensor, Tensor]:
    """Fixed-step march + fine-buffer secant (JAX ssr.py:74) over the
    depth `fine`.  origin/dir in (u, v, ndc z).  Returns (hit_uvz,
    hit_mask)."""
    dt = 1.0 / steps

    ts = torch.arange(steps + 1, dtype=torch.float32,
                      device=origin_uvz.device) * dt
    p = origin_uvz[None] + dir_uvz[None] * ts[:, None, None, None]
    d = point_sample(fine[..., None], p[..., :2])[..., 0]     # (S+1,h,w)
    z = p[..., 2]
    f = z - d
    inside = ((p[..., 0] > 0) & (p[..., 0] < 1)
              & (p[..., 1] > 0) & (p[..., 1] < 1))
    # a hit is a front-to-back crossing within the thickness window,
    # tested against the entry texel's plane, the exit texel's and the
    # mixed secant
    win = thickness_ndc + torch.abs(dir_uvz[..., 2]) * dt

    def bracket(g0, g1):
        cross_ = (g0 <= 0) & (g1 > 0) & (g1 < win) & inside[1:]
        denom = g1 - g0
        frac = torch.where(torch.abs(denom) > 1e-12, -g0 / denom, 1.0)
        return cross_, torch.clamp(frac, 0.0, 1.0)

    c_a, fr_a = bracket(f[:-1], z[1:] - d[:-1])     # entry-texel plane
    c_b, fr_b = bracket(z[:-1] - d[1:], f[1:])      # exit-texel plane
    c_m, fr_m = bracket(f[:-1], f[1:])              # mixed secant
    crossed = c_a | c_b | c_m
    inf = torch.tensor(float("inf"), device=f.device)
    frac_all = torch.minimum(
        torch.minimum(torch.where(c_a, fr_a, inf),
                      torch.where(c_b, fr_b, inf)),
        torch.where(c_m, fr_m, inf))
    hit = crossed.any(dim=0)
    i0 = torch.argmax(crossed.to(torch.uint8), dim=0)       # first hit
    frac = torch.gather(
        torch.where(torch.isfinite(frac_all), frac_all, 1.0), 0,
        i0[None])[0]
    t_lo = i0.to(torch.float32) * dt
    t_hit = t_lo + frac * dt

    # fine-buffer correction: tap the fine depth at both bracket ends and
    # run a second secant on those values
    p_pair = (origin_uvz[None]
              + dir_uvz[None] * torch.stack([t_lo, t_hit])[..., None])
    d_fine = bilinear_sample(fine[..., None], p_pair[..., :2])[..., 0]
    f_lo = p_pair[0, ..., 2] - d_fine[0]
    f_hi = p_pair[1, ..., 2] - d_fine[1]
    denom = f_hi - f_lo
    frac2 = torch.clamp(torch.where(torch.abs(denom) > 1e-12, -f_lo / denom,
                                    1.0), 0.0, 1.0)
    bracketed = (f_hi > 0) & (f_lo < 0)
    t2 = torch.where(bracketed, t_lo + frac2 * (t_hit - t_lo), t_hit)
    return origin_uvz + dir_uvz * t2[..., None], hit


def _neighborhood_moments(x: Tensor) -> Tuple[Tensor, Tensor]:
    """3x3 mean and standard deviation (wrap-around shifts)."""
    acc = torch.zeros_like(x)
    acc2 = torch.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = torch.roll(x, (dy, dx), dims=(0, 1))
            acc = acc + s
            acc2 = acc2 + s * s
    mean = acc / 9.0
    var = torch.clamp(acc2 / 9.0 - mean * mean, min=0.0)
    return mean, torch.sqrt(var)


def bilateral_cleanup(radiance: Tensor, depth_r: Tensor, rough_r: Tensor,
                      camera: CameraAttribs, radius: int = 3) -> Tensor:
    """Depth- and roughness-aware separable blur whose strength scales with
    roughness (the reference's ComputeBilateralCleanup pass)."""
    z = depth_to_camera_z(depth_r, camera)
    rough = rough_r[..., 0]
    amount = saturate(rough * 4.0)
    out = radiance
    for axis in (0, 1):
        acc = out
        wacc = torch.ones_like(z)
        for d in range(1, radius + 1):
            for sgn in (-1, 1):
                s = torch.roll(out, sgn * d, dims=axis)
                zz = torch.roll(z, sgn * d, dims=axis)
                rr = torch.roll(rough, sgn * d, dims=axis)
                wz = torch.exp(-torch.abs(zz - z)
                               / (0.05 * torch.clamp(z, min=1e-3)))
                wr = torch.exp(-torch.abs(rr - rough) * 8.0)
                wg = math.exp(-0.5 * (d / max(radius * 0.6, 1e-3)) ** 2)
                wgt = wz * wr * wg * amount
                acc = acc + s * wgt[..., None]
                wacc = wacc + wgt
        out = acc / wacc[..., None]
    return out


def _to_uvz(p_vs: Tensor, camera: CameraAttribs) -> Tensor:
    """View-space points -> (u, v, ndc z)."""
    proj = camera.proj
    clip = torch.stack([p_vs[..., 0] * proj[0, 0], p_vs[..., 1] * proj[1, 1],
                        p_vs[..., 2] * proj[2, 2] + proj[3, 2],
                        -p_vs[..., 2]], dim=-1)
    wc = torch.clamp(clip[..., 3:4], min=1e-5)
    ndc = clip[..., :3] / wc
    return torch.stack([ndc[..., 0] * 0.5 + 0.5, 0.5 - ndc[..., 1] * 0.5,
                        ndc[..., 2]], dim=-1)


def _ggx_g1(ndx: Tensor, a2: Tensor) -> Tensor:
    return 2.0 * ndx / torch.clamp(
        ndx + torch.sqrt(a2 + (1.0 - a2) * ndx * ndx), min=1e-6)


def _ggx_d(ndoth: Tensor, a2: Tensor) -> Tensor:
    f = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(3.14159265 * f * f, min=1e-8)


def _thickness_ndc(settings: SSRSettings, camera: CameraAttribs) -> Tensor:
    """The depth-buffer thickness in NDC (an approximate scale), kept on
    the camera's device."""
    far, near = camera.far_z, camera.near_z
    return torch.tensor(settings.depth_buffer_thickness, device=far.device) \
        / torch.clamp(far - near, min=1e-3)


def _ray_setup(depth_r: Tensor, normal_r: Tensor, rough_r: Tensor,
               camera: CameraAttribs, frame_index: int,
               settings: SSRSettings):
    """The stochastic reflection rays at the processing resolution: view-
    space position and view vector, GGX-VNDF jittered reflection direction,
    and the ray in (u, v, ndc z) extended to the near/far plane, clipped to
    the screen and moved off the surface.  Returns (v, n, alpha, h_vs,
    r_dir, o_uvz, dir_uvz)."""
    h, w = depth_r.shape
    dev = depth_r.device
    pos = view_space_position(depth_r, camera)
    v = normalize(-pos)

    # GGX-VNDF jittered reflection direction in view space
    noise = r2_noise_pair(h, w, frame_index, device=dev)
    n = normal_r
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=dev)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
    up = torch.where(torch.abs(n[..., 2:3]) < 0.99, z_axis, x_axis)
    t_b = normalize(cross(up, n))
    b_b = cross(n, t_b)
    v_ts = torch.stack([torch.sum(v * t_b, -1), torch.sum(v * b_b, -1),
                        torch.sum(v * n, -1)], dim=-1)
    bias = f32(np.float32(1.0) - np.float32(settings.ggx_importance_sample_bias))
    alpha = torch.clamp(rough_r * rough_r * bias, 1e-4, 1.0)
    h_ts = smith_ggx_sample_visible_normal(v_ts, alpha[..., 0], alpha[..., 0],
                                           noise[..., 0], noise[..., 1])
    h_vs = (h_ts[..., 0:1] * t_b + h_ts[..., 1:2] * b_b
            + h_ts[..., 2:3] * n)
    r_dir = normalize(reflect(-v, normalize(h_vs)))

    # endpoints in (u, v, ndc z): extend the ray to the near/far plane, then
    # clip it to the screen rectangle
    rz_d = r_dir[..., 2]
    inf = torch.tensor(float("inf"), device=dev)
    t_far = torch.where(rz_d < -1e-6,
                        (-(camera.far_z * 0.99) - pos[..., 2]) / rz_d, inf)
    t_near = torch.where(rz_d > 1e-6,
                         (-(camera.near_z * 1.01) - pos[..., 2]) / rz_d, inf)
    ray_len = torch.minimum(torch.maximum(torch.minimum(t_far, t_near),
                                          torch.tensor(0.1, device=dev)),
                            2.0 * camera.far_z)[..., None]
    o_uvz = _to_uvz(pos, camera)
    e_uvz = _to_uvz(pos + r_dir * ray_len, camera)
    dir_uvz = e_uvz - o_uvz
    eps = 1e-6
    du, dvv = dir_uvz[..., 0], dir_uvz[..., 1]
    sx = torch.where(du > eps, (1.0 - o_uvz[..., 0]) / du,
                     torch.where(du < -eps, -o_uvz[..., 0] / du, inf))
    sy = torch.where(dvv > eps, (1.0 - o_uvz[..., 1]) / dvv,
                     torch.where(dvv < -eps, -o_uvz[..., 1] / dvv, inf))
    s = torch.clamp(torch.clamp(torch.minimum(sx, sy), max=1.0), 1e-4, 1.0)
    dir_uvz = dir_uvz * s[..., None]
    o_uvz = o_uvz + dir_uvz * 0.01          # off the surface
    return v, n, alpha, h_vs, r_dir, o_uvz, dir_uvz


def compute_ssr(color: Tensor, depth: Tensor, normal_vs: Tensor,
                roughness: Tensor, camera: CameraAttribs, frame_index: int,
                settings: SSRSettings = SSRSettings(),
                state: Optional[SSRState] = None,
                motion: Optional[Tensor] = None,
                half_resolution: bool = False, resolution_divisor: int = 0,
                disocclusion: Optional[Tensor] = None,
                enable_spatial: bool = True, enable_temporal: bool = True,
                enable_bilateral: bool = True) -> Tuple[Tensor, SSRState]:
    """Full SSR (JAX ssr.py:242): returns ((H, W, 4) radiance + confidence,
    new state).  color: the lit scene to reflect; normal_vs view space;
    roughness (H, W, 1)."""
    full_h, full_w = depth.shape
    d = resolution_divisor or (2 if half_resolution else 1)
    if d > 1:
        depth_r = depth[::d, ::d]
        normal_r = normal_vs[::d, ::d]
        rough_r = roughness[::d, ::d]
        half_resolution = True
    else:
        depth_r, normal_r, rough_r = depth, normal_vs, roughness
    h, w = depth_r.shape
    dev = depth.device

    v, n, alpha, h_vs, r_dir, o_uvz, dir_uvz = _ray_setup(
        depth_r, normal_r, rough_r, camera, frame_index, settings)
    hit_uvz, hit = _march(depth_r, o_uvz, dir_uvz,
                          settings.max_traversal_intersections,
                          _thickness_ndc(settings, camera))

    # reject hits whose surface does not face the ray, then tap the radiance
    n_hit = point_sample(normal_r, hit_uvz[..., :2])
    refl = bilinear_sample(color, hit_uvz[..., :2])
    hit = hit & (torch.sum(n_hit * r_dir, dim=-1) < -0.05)
    # fades: screen edge, roughness
    edge = (saturate(10.0 * (0.5 - torch.abs(hit_uvz[..., 0:1] - 0.5)))
            * saturate(10.0 * (0.5 - torch.abs(hit_uvz[..., 1:2] - 0.5))))
    thr = settings.roughness_threshold
    rough_fade = saturate((thr - rough_r) / max(thr, 1e-3) * 4.0)
    conf = hit[..., None].to(torch.float32) * edge * rough_fade
    radiance = torch.cat([refl * conf, conf], dim=-1)

    # spatial reconstruction: each neighbour's ray re-weighted by this
    # pixel's BRDF response over the neighbour's sampling pdf
    if enable_spatial:
        a_c = alpha[..., 0]
        a2 = a_c * a_c
        ndotv_c = torch.clamp(torch.sum(n * v, dim=-1), min=1e-4)
        ndoth_s = torch.clamp(torch.sum(n * normalize(h_vs), dim=-1), min=0.0)
        pdf_s = (_ggx_g1(ndotv_c, a2) * _ggx_d(ndoth_s, a2)
                 / torch.clamp(4.0 * ndotv_c, min=1e-4))
        acc = radiance
        wsum = torch.ones_like(rough_r[..., 0])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                r_j = torch.roll(r_dir, (dy, dx), dims=(0, 1))
                pdf_j = torch.roll(pdf_s, (dy, dx), dims=(0, 1))
                rad_j = torch.roll(radiance, (dy, dx), dims=(0, 1))
                h_t = normalize(v + r_j)
                ndoth_t = torch.clamp(torch.sum(n * h_t, dim=-1), min=0.0)
                ndotl_t = torch.clamp(torch.sum(n * r_j, dim=-1), min=0.0)
                w_j = (_ggx_d(ndoth_t, a2) * _ggx_g1(ndotv_c, a2) * ndotl_t
                       / torch.clamp(4.0 * ndotv_c * pdf_j, min=1e-4))
                w_j = torch.clamp(w_j, max=4.0)   # fireflies from tiny pdfs
                acc = acc + rad_j * w_j[..., None]
                wsum = wsum + w_j
        recon = acc / wsum[..., None]
        radiance = radiance + (recon - radiance) * saturate(rough_r * 4.0)

    # temporal accumulation at the processing resolution
    if enable_temporal and state is not None and motion is not None:
        motion_r = motion[::d, ::d] if d > 1 else motion
        y, x = pixel_grid(h, w, dev)
        prev_uv = torch.stack([(x + 0.5) / w, (y + 0.5) / h], -1) - motion_r
        hist = bilinear_sample(state.radiance, prev_uv)
        # clamp the history to the current 3x3 distribution ...
        mean, std = _neighborhood_moments(radiance)
        hist = torch.clamp(hist, mean - 2.0 * std, mean + 2.0 * std)
        reject = ~((prev_uv[..., 0] >= 0) & (prev_uv[..., 0] <= 1)
                   & (prev_uv[..., 1] >= 0) & (prev_uv[..., 1] <= 1))
        if disocclusion is not None:
            # ... and reject it where the previous depth sees another surface
            reject = reject | (disocclusion[::d, ::d] if d > 1
                               else disocclusion)
        keep = f32(np.float32(1.0)
                   - np.float32(settings.temporal_stability_factor))
        a = torch.where(reject[..., None], 1.0, keep)
        radiance = hist + (radiance - hist) * a
    if enable_bilateral:
        radiance = bilateral_cleanup(radiance, depth_r, rough_r, camera)
    new_state = SSRState(radiance=radiance)
    if half_resolution:
        radiance = upsample_bilinear(radiance, d, d)[:full_h, :full_w]
    return radiance, new_state
