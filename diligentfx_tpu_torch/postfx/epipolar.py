"""Epipolar light scattering (the port of diligentfx_tpu/postfx/epipolar.py):
a Rayleigh + Mie atmosphere with a precomputed optical-depth LUT and an
isotropic multiple-scattering LUT, inscattering computed on an epipolar
grid of `num_slices x samples_per_slice` points instead of per pixel,
shadowed ray marching (god rays, PCF on the cascades or the 1D min/max
shadow tree), the epipolar -> screen unwarp with depth-break correction,
and the sun disk.

The JAX package's three default-off modes are here too: sample refinement
(`refinement_factor` > 1: march every m-th sample plus a fixed budget of
depth-break samples, compacted, and interpolate the rest), the 1D min/max
shadow tree (`use_minmax_tree`) and the single-scattering LUT mode
(`single_sctr_lut`: per-frame cumulative tables replace the march).

Settings are float32 in the JAX package; their scalar combinations are
formed in float32 here too (`f32`).  Plain PyTorch: no kernel of the JAX
package lies on this path.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import CameraAttribs
from diligentfx_tpu_torch.components.shadow_map_manager import (
    filter_shadow_pcf, find_cascade)
from diligentfx_tpu_torch.ops.sampling import bilinear_sample
from diligentfx_tpu_torch.pbr.renderer import _camera_rays
from diligentfx_tpu_torch.postfx.context import depth_to_camera_z

Tensor = torch.Tensor
PI = 3.141592653589793

# Earth atmosphere constants (EpipolarLightScatteringStructures.fxh:180-246)
EARTH_RADIUS = 6_360_000.0
ATMOSPHERE_TOP = 6_420_000.0
BETA_RAYLEIGH = (5.802e-6, 13.558e-6, 33.1e-6)
BETA_MIE = (3.996e-6, 3.996e-6, 3.996e-6)
BETA_OZONE = (0.650e-6, 1.881e-6, 0.085e-6)
H_RAYLEIGH = 7994.0
H_MIE = 1200.0


def f32(x) -> float:
    """A Python float holding the float32 value of x."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def _betas(device: torch.device):
    """(rayleigh, mie, mie extinction, ozone) coefficients, (3,) float32,
    made once a device (the march reads them every step)."""
    br = torch.tensor(BETA_RAYLEIGH, dtype=torch.float32, device=device)
    bm = torch.tensor(BETA_MIE, dtype=torch.float32, device=device)
    bo = torch.tensor(BETA_OZONE, dtype=torch.float32, device=device)
    return br, bm, bm / 0.9, bo


class EpipolarSettings(NamedTuple):
    """EpipolarLightScatteringAttribs analogue; the ints and bools are
    structural (loop and grid sizes, modes)."""
    num_epipolar_slices: int = 512
    max_samples_in_slice: int = 256
    num_ray_march_steps: int = 32
    # sample refinement: > 1 marches only every refinement_factor-th sample
    # plus a budget of S*N // refinement_budget_div depth-break samples
    refinement_factor: int = 1
    refinement_budget_div: int = 8
    # 1D min/max shadow tree instead of PCF taps of the cascades
    use_minmax_tree: bool = False
    minmax_tree_res: int = 512
    # single-scattering LUT mode (cumulative tables replace the march)
    single_sctr_lut: bool = False
    mie_g: float = 0.76
    sun_intensity: float = 20.0
    scene_scale: float = 1.0            # world units -> meters
    base_altitude: float = 50.0
    sun_angular_radius: float = 0.00935  # ~0.535 degrees


def _density(h: Tensor) -> Tuple[Tensor, Tensor]:
    """(rayleigh, mie) relative densities at altitude h meters."""
    hc = torch.clamp(h, 0.0, ATMOSPHERE_TOP - EARTH_RADIUS)
    return torch.exp(-hc / H_RAYLEIGH), torch.exp(-hc / H_MIE)


def precompute_optical_depth_lut(height_res: int = 64, angle_res: int = 128,
                                 steps: int = 64, device=None) -> Tensor:
    """(height_res, angle_res, 2) optical depth (Rayleigh, Mie densities
    integrated) from altitude h toward zenith angle theta to the top of the
    atmosphere (PrecomputeNetDensityToAtmTop)."""
    h_top = ATMOSPHERE_TOP - EARTH_RADIUS
    hs = (torch.arange(height_res, dtype=torch.float32, device=device)
          + 0.5) / height_res
    hs = hs * hs * h_top                                 # quadratic packing
    cz = (torch.arange(angle_res, dtype=torch.float32, device=device)
          + 0.5) / angle_res * 2.0 - 1.0
    h, c = torch.meshgrid(hs, cz, indexing="ij")
    r0 = EARTH_RADIUS + h
    b = r0 * c
    disc = b * b - (r0 * r0 - ATMOSPHERE_TOP * ATMOSPHERE_TOP)
    t_exit = -b + torch.sqrt(torch.clamp(disc, min=0.0))
    ds = t_exit / steps
    odr = torch.zeros_like(h)
    odm = torch.zeros_like(h)
    for i in range(steps):
        t = (i + 0.5) * ds
        r = torch.sqrt(r0 * r0 + t * t + 2.0 * r0 * t * c)
        dr, dm = _density(r - EARTH_RADIUS)
        odr = odr + dr * ds
        odm = odm + dm * ds
    return torch.stack([odr, odm], dim=-1)


def precompute_multiple_scattering_lut(optical_lut: Tensor,
                                       height_res: int = 32,
                                       angle_res: int = 32,
                                       num_dirs: int = 64,
                                       steps: int = 20) -> Tensor:
    """(height_res, angle_res, 3) isotropic multiple-scattering transfer
    Psi_ms(altitude, sun cos-zenith) in the 2D formulation (Hillaire 2020):
    second-order inscatter L2 and the transfer factor f_ms integrated over
    a uniform sphere of directions, the higher orders closed as
    Psi = L2 / (1 - f_ms).  The JAX package vmaps over the directions; here
    they are a leading batch dimension."""
    dev = optical_lut.device
    br, bm, bme, _ = _betas(dev)
    h_top = ATMOSPHERE_TOP - EARTH_RADIUS
    hs = (torch.arange(height_res, dtype=torch.float32, device=dev)
          + 0.5) / height_res
    hs = hs * hs * h_top
    mu = (torch.arange(angle_res, dtype=torch.float32, device=dev)
          + 0.5) / angle_res * 2.0 - 1.0
    h, mu_s = torch.meshgrid(hs, mu, indexing="ij")       # (H, A)

    # Fibonacci sphere directions: only the zenith component matters (the
    # integrand is azimuth-symmetric once T_sun uses the local sun zenith)
    k = torch.arange(num_dirs, dtype=torch.float32, device=dev)
    dirs_y = 1.0 - 2.0 * (k + 0.5) / num_dirs
    c = dirs_y[:, None, None].expand(num_dirs, *h.shape)  # (D, H, A)
    r0 = EARTH_RADIUS + h
    b = r0 * c
    disc_top = b * b - (r0 * r0 - ATMOSPHERE_TOP * ATMOSPHERE_TOP)
    t_top = -b + torch.sqrt(torch.clamp(disc_top, min=0.0))
    disc_g = b * b - (r0 * r0 - EARTH_RADIUS * EARTH_RADIUS)
    hits_g = (disc_g > 0.0) & (c < 0.0)
    t_g = -b - torch.sqrt(torch.clamp(disc_g, min=0.0))
    t_end = torch.where(hits_g, torch.clamp(t_g, min=0.0), t_top)
    ds = t_end / steps
    mu_b = mu_s.expand_as(c)
    uniform_phase = 1.0 / (4.0 * PI)
    l2 = torch.zeros(c.shape + (3,), dtype=torch.float32, device=dev)
    fms = torch.zeros_like(l2)
    tau = torch.zeros_like(l2)
    for i in range(steps):
        t = (i + 0.5) * ds
        r = torch.sqrt(r0 * r0 + t * t + 2.0 * r0 * t * c)
        alt = r - EARTH_RADIUS
        dr, dm = _density(alt)
        sig_s = br * dr[..., None] + bm * dm[..., None]
        sig_t = br * dr[..., None] + bme * dm[..., None]
        trans = torch.exp(-tau)
        t_sun = _transmittance_to_sun(optical_lut, alt, mu_b)
        seg = ds[..., None]
        l2 = l2 + trans * sig_s * t_sun * uniform_phase * seg
        fms = fms + trans * sig_s * uniform_phase * seg
        tau = tau + sig_t * seg
    l2 = l2.mean(0) * (4.0 * PI)     # sphere integral of the dir average
    fms = fms.mean(0) * (4.0 * PI)
    return l2 / torch.clamp(1.0 - fms, min=1e-3)


def _lut_uv(h: Tensor, cos_zenith: Tensor) -> Tensor:
    h_top = ATMOSPHERE_TOP - EARTH_RADIUS
    u = (cos_zenith + 1.0) * 0.5
    v = torch.sqrt(torch.clamp(h / h_top, 0.0, 1.0))
    return torch.stack([u, v], dim=-1)


def _sample_ms_lut(ms_lut: Tensor, h: Tensor, cos_sun_zenith: Tensor) -> Tensor:
    return bilinear_sample(ms_lut, _lut_uv(h, cos_sun_zenith))


def _transmittance_to_sun(lut: Tensor, h: Tensor, cos_zenith: Tensor) -> Tensor:
    br, _, bme, bo = _betas(lut.device)
    od = bilinear_sample(lut, _lut_uv(h, cos_zenith))
    tau = (br * od[..., 0:1] + bme * od[..., 1:2]
           + bo * od[..., 0:1] * 6e-7 / 8e-6)
    return torch.exp(-tau)


def phase_rayleigh(c: Tensor) -> Tensor:
    return 3.0 / (16.0 * PI) * (1.0 + c * c)


def phase_mie(c: Tensor, g) -> Tensor:
    """Cornette-Shanks; g a float32 scalar."""
    g = np.float32(g)
    g2 = g * g
    k = np.float32(3.0 / (8.0 * PI)) * (np.float32(1.0) - g2)
    return (float(k) * (1.0 + c * c)
            / (float(np.float32(2.0) + g2) * torch.pow(torch.clamp(
                float(np.float32(1.0) + g2) - float(np.float32(2.0) * g) * c,
                min=1e-6), 1.5)))


ShadowFn = Callable[[Tensor], Tensor]


def _grid_jitter(shape, device) -> Tensor:
    """Golden-ratio hash over a 2-D ray grid (breaks the concentric step
    banding a fixed-step march produces)."""
    ji = torch.arange(shape[0], dtype=torch.float32, device=device)[:, None]
    jj = torch.arange(shape[1], dtype=torch.float32, device=device)[None, :]
    return torch.remainder(0.618034 * ji + 0.3247179 * jj, 1.0)


def _inscatter_march(lut, origins, directions, lengths, sun_dir,
                     s: EpipolarSettings, shadow_fn: Optional[ShadowFn] = None,
                     ms_lut=None, jitter=None):
    """Single-scattering inscatter + transmittance along rays, plus the
    isotropic multiple-scattering term when `ms_lut` is given.
    origins/directions (..., 3) world; lengths (...,); returns
    (inscatter (..., 3), transmittance (..., 3))."""
    dev = lengths.device
    br, bm, bme, _ = _betas(dev)
    steps = s.num_ray_march_steps
    scale = f32(s.scene_scale)
    base_alt = f32(s.base_altitude)
    ds = lengths / steps
    cos_theta = torch.sum(directions * (-sun_dir), dim=-1)  # view . to-sun
    ph_r = phase_rayleigh(cos_theta)[..., None]
    ph_m = phase_mie(cos_theta, s.mie_g)[..., None]
    if jitter is None:
        jitter = (_grid_jitter(lengths.shape, dev) if lengths.dim() == 2
                  else torch.zeros_like(lengths))
    cos_z = -sun_dir[1]
    seg_len = (ds * scale)[..., None]
    inscatter = torch.zeros(lengths.shape + (3,), dtype=torch.float32,
                            device=dev)
    tau_r = torch.zeros_like(lengths)
    tau_m = torch.zeros_like(lengths)
    for i in range(steps):
        t = (i + 0.25 + 0.5 * jitter) * ds
        p = origins + directions * t[..., None]
        h = base_alt + p[..., 1] * scale
        dr, dm = _density(h)
        tau_r = tau_r + dr * ds * scale
        tau_m = tau_m + dm * ds * scale
        # transmittance camera -> sample
        t_cam = torch.exp(-(br * tau_r[..., None] + bme * tau_m[..., None]))
        # transmittance sample -> sun from the LUT
        cz = cos_z.expand(h.shape)
        t_sun = _transmittance_to_sun(lut, h, cz)
        scatter = br * dr[..., None] * ph_r + bm * dm[..., None] * ph_m
        term = t_cam * t_sun * scatter
        if shadow_fn is not None:
            term = term * shadow_fn(p)[..., None]
        inscatter = inscatter + term * seg_len
        if ms_lut is not None:
            # multiple scattering: the uniform-phase ambient transfer
            # (unshadowed: higher orders arrive from every direction)
            psi = _sample_ms_lut(ms_lut, h, cz)
            sig_s = br * dr[..., None] + bm * dm[..., None]
            inscatter = inscatter + t_cam * sig_s * psi * seg_len
    trans = torch.exp(-(br * tau_r[..., None] + bme * tau_m[..., None]))
    return inscatter * f32(s.sun_intensity), trans


def _build_sctr_cumulative(lut, camera: CameraAttribs, sun_dir,
                           s: EpipolarSettings, t_max: Tensor, ms_lut=None,
                           v_res: int = 64, t_res: int = 128):
    """Per-frame cumulative single-scattering tables F(v_y, t) (the JAX
    package's recast of the reference's 4D single-scattering LUT: the flat
    atmosphere, the frame's fixed camera and sun leave two free variables,
    the ray's vertical direction component and the distance).  Returns one
    (v_res, t_res + 1, 11) table, channels [f_r(3), f_m(3), f_ms(3),
    tau_r, tau_m]; column k holds the integral over [0, k dt]."""
    dev = lut.device
    br, bm, bme, _ = _betas(dev)
    scale = f32(s.scene_scale)
    vy = (torch.arange(v_res, dtype=torch.float32, device=dev)
          + 0.5) / v_res * 2.0 - 1.0
    dt = t_max / t_res
    tm = (torch.arange(t_res, dtype=torch.float32, device=dev) + 0.5) * dt
    h = (f32(s.base_altitude)
         + (camera.position[1] + vy[:, None] * tm[None, :]) * scale)
    dr, dm = _density(h)                                   # (V, K)
    seg = dt * scale
    # optical depth camera -> midpoint k: full segments before k + half of k
    tau_r = (torch.cumsum(dr, dim=1) - 0.5 * dr) * seg
    tau_m = (torch.cumsum(dm, dim=1) - 0.5 * dm) * seg
    t_cam = torch.exp(-(br * tau_r[..., None] + bme * tau_m[..., None]))
    cos_z = (-sun_dir[1]).expand(h.shape)
    t_sun = _transmittance_to_sun(lut, h, cos_z)
    f_r = torch.cumsum(t_cam * t_sun * dr[..., None], dim=1) * seg
    f_m = torch.cumsum(t_cam * t_sun * dm[..., None], dim=1) * seg
    if ms_lut is not None:
        psi = _sample_ms_lut(ms_lut, h, cos_z)
        sig_s = br * dr[..., None] + bm * dm[..., None]
        f_ms = torch.cumsum(t_cam * sig_s * psi, dim=1) * seg
    else:
        f_ms = torch.zeros_like(f_r)
    cum = torch.cat([f_r, f_m, f_ms,
                     (torch.cumsum(dr, dim=1) * seg)[..., None],
                     (torch.cumsum(dm, dim=1) * seg)[..., None]], dim=-1)
    cum = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
    return cum, t_max


def _tap_sctr_cumulative(cum: Tensor, vy: Tensor, t: Tensor,
                         t_max: Tensor) -> Tensor:
    """Bilinear tap of the cumulative table at (v_y, t) -> (..., 11)."""
    v_res, kp1 = cum.shape[0], cum.shape[1]
    rf = torch.clamp((vy + 1.0) * 0.5 * v_res - 0.5, 0.0, v_res - 1.0)
    r0 = torch.floor(rf).long()
    r1 = torch.clamp(r0 + 1, max=v_res - 1)
    fr = (rf - r0.float())[..., None]
    cf = torch.clamp(t / t_max, 0.0, 1.0) * (kp1 - 1)
    c0 = torch.floor(cf).long()
    c1 = torch.clamp(c0 + 1, max=kp1 - 1)
    fc = (cf - c0.float())[..., None]
    a = cum[r0, c0] * (1.0 - fc) + cum[r0, c1] * fc
    b = cum[r1, c0] * (1.0 - fc) + cum[r1, c1] * fc
    return a * (1.0 - fr) + b * fr


def _lit_span(shadow_fn: ShadowFn, origins, dirs, lengths, steps: int,
              jitter=None):
    """Distance to the first lit point + total lit length along each ray
    (the reference's fDistToFirstLitSection / fTotalLitLength): a
    visibility-only march."""
    ds = lengths / steps
    if jitter is None:
        jitter = torch.zeros_like(lengths)
    first = torch.full_like(lengths, -1.0)
    lit = torch.zeros_like(lengths)
    for i in range(steps):
        t = (i + 0.25 + 0.5 * jitter) * ds
        p = origins + dirs * t[..., None]
        vis = shadow_fn(p)
        lit = lit + vis * ds
        first = torch.where((vis > 0.05) & (first < 0.0), t, first)
    first = torch.where(first < 0.0, lengths,
                        torch.clamp(first - 0.5 * ds, min=0.0))
    return first, torch.minimum(lit, lengths - first)


def _inscatter_lut(cum, t_max, origins, dirs, lengths, sun_dir,
                   s: EpipolarSettings, shadow_fn: Optional[ShadowFn] = None,
                   jitter=None):
    """LUT-mode inscatter (SINGLE_SCTR_MODE_LUT): two cumulative taps for
    the (contiguous-approximated) lit section and one for the whole ray's
    transmittance and ambient term."""
    br, bm, bme, _ = _betas(lengths.device)
    cos_theta = torch.sum(dirs * (-sun_dir), dim=-1)
    ph_r = phase_rayleigh(cos_theta)[..., None]
    ph_m = phase_mie(cos_theta, s.mie_g)[..., None]
    vy = dirs[..., 1]
    if shadow_fn is not None:
        t0, lit = _lit_span(shadow_fn, origins, dirs, lengths,
                            s.num_ray_march_steps, jitter)
        t1 = torch.minimum(t0 + lit, lengths)
    else:
        t0 = torch.zeros_like(lengths)
        t1 = lengths
    end = _tap_sctr_cumulative(cum, vy, lengths, t_max)
    a = _tap_sctr_cumulative(cum, vy, t0, t_max)
    b = _tap_sctr_cumulative(cum, vy, t1, t_max)
    d_single = b - a
    # the multiple-scattering ambient: unshadowed, the whole ray
    ins = (br * ph_r * d_single[..., 0:3] + bm * ph_m * d_single[..., 3:6]
           + end[..., 6:9])
    trans = torch.exp(-(br * end[..., 9:10] + bme * end[..., 10:11]))
    return ins * f32(s.sun_intensity), trans


def _epipolar_grid(light_uv: Tensor, num_slices: int, num_samples: int):
    """Slice entry/exit points on the screen rect + the sample uv grid
    (slices, samples, 2).  Each slice ray from light_uv is slab-clipped
    against [0, 1]^2 and its samples span only the on-screen chord, so an
    off-screen light wastes no samples; with the light on screen the entry
    is light_uv itself.  Returns (grid, ends (slices, 2))."""
    dev = light_uv.device
    a = (torch.arange(num_slices, dtype=torch.float32, device=dev)
         + 0.5) / num_slices * 2.0 * PI
    d = torch.stack([torch.cos(a), torch.sin(a)], dim=-1)   # (S, 2)
    eps = 1e-6
    big = 1e9

    def slab(p, dx):
        flat = torch.abs(dx) < eps
        safe = torch.where(flat, torch.full_like(dx, eps), dx)
        t0 = (0.0 - p) / safe
        t1 = (1.0 - p) / safe
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        # degenerate axis: inside the slab -> full range, outside -> empty
        inside = (p >= 0.0) & (p <= 1.0)
        in_big = torch.where(inside, torch.full_like(dx, big),
                             torch.full_like(dx, -big))
        lo = torch.where(flat, -in_big, lo)
        hi = torch.where(flat, in_big, hi)
        return lo, hi

    lx, hx = slab(light_uv[0], d[:, 0])
    ly, hy = slab(light_uv[1], d[:, 1])
    t_in = torch.clamp(torch.maximum(lx, ly), min=0.0)
    t_out = torch.minimum(hx, hy)
    valid = t_out > t_in                                    # crosses screen
    t_out = torch.maximum(t_out, t_in)
    starts = light_uv[None, :] + d * t_in[:, None]
    ends = light_uv[None, :] + d * t_out[:, None]
    f = ((torch.arange(num_samples, dtype=torch.float32, device=dev)
          + 0.5) / num_samples)[None, :, None]
    grid = starts[:, None, :] * (1.0 - f) + ends[:, None, :] * f
    # invalid slices collapse to their (clamped) start: harmless samples
    grid = torch.where(valid[:, None, None], grid,
                       torch.clamp(starts[:, None, :], 0.0, 1.0))
    return grid, ends


def _to_index(x: Tensor, hi: int) -> Tensor:
    """float -> integer index by truncation toward zero, then clamped to
    [0, hi]: the JAX package's astype(int32) + clip (the float is clamped
    first so no out-of-range conversion happens)."""
    return torch.clamp(torch.clamp(x, -1.0, hi + 1.0).to(torch.int64), 0, hi)


class ShadowLineTree(NamedTuple):
    """1D min/max shadow binary tree per (cascade, slice): every camera
    ray of an epipolar slice lies in the plane of the sun direction and the
    slice, so its shadow-map lookups fall on one line per cascade map.  The
    line is point-sampled once and min/max-reduced into a mip chain; the
    march tests a whole span with one gather (Build1DMinMaxMipMap)."""
    packed: Tensor     # (C*S*R_tot, 2) level-major flat (min, max) depths
    lv_xy0: Tensor     # (2,) light-view xy of the camera position
    u_dir: Tensor      # (S, 2) unit light-view-xy direction of each slice
    u_min: Tensor      # (S,) sampled u range start (light-view units)
    u_rng: Tensor      # (S,) sampled u range extent (>= eps)
    base_r: int
    levels: int


def build_shadow_line_tree(att, shadow_maps: Tensor, camera: CameraAttribs,
                           world_ends: Tensor, num_slices: int,
                           base_r: int = 512,
                           levels: int = 4) -> ShadowLineTree:
    """Sample each slice's shadow line per cascade and build the min/max
    mips.  world_ends (S, N, 3): the epipolar samples' world positions,
    whose light-view projections bound each slice's u range."""
    wl = att.world_to_light_view
    s_res = shadow_maps.shape[-1]
    lv0 = m3.transform_points(camera.position, wl)[:3]
    lv_ends = m3.transform_points(world_ends, wl)[..., :3]
    d_xy = lv_ends[..., :2] - lv0[:2]                        # (S, N, 2)
    # the largest-|u| endpoint represents the slice direction
    norms = torch.sqrt(torch.sum(d_xy * d_xy, dim=-1))
    pick = torch.argmax(norms, dim=1)
    rep = d_xy[torch.arange(d_xy.shape[0], device=d_xy.device), pick]
    u_dir = rep / torch.clamp(torch.sqrt(torch.sum(rep * rep, dim=-1,
                                                   keepdim=True)), min=1e-9)
    u = torch.sum(d_xy * u_dir[:, None, :], dim=-1)          # (S, N)
    u_min = torch.clamp(u.min(dim=1).values, max=0.0)
    u_max = torch.clamp(u.max(dim=1).values, min=0.0)
    u_rng = torch.clamp(u_max - u_min, min=1e-6)

    # every cascade map sampled along every slice line at base_r points
    j = (torch.arange(base_r, dtype=torch.float32, device=d_xy.device)
         + 0.5) / base_r
    u_j = u_min[:, None] + u_rng[:, None] * j[None, :]       # (S, R)
    line_xy = lv0[:2] + u_dir[:, None, :] * u_j[..., None]   # (S, R, 2)
    scale = att.light_space_scale
    bias = att.light_space_bias
    p_xy = (line_xy[None] * scale[:, None, None, :2]
            + bias[:, None, None, :2])                       # (C, S, R, 2)
    uv_x = p_xy[..., 0] * 0.5 + 0.5
    uv_y = 0.5 - p_xy[..., 1] * 0.5
    xi = _to_index(uv_x * s_res, s_res - 1)
    yi = _to_index(uv_y * s_res, s_res - 1)
    ci = torch.arange(xi.shape[0], device=xi.device)[:, None, None]
    base = shadow_maps.reshape(-1)[ci * (s_res * s_res) + yi * s_res + xi]

    mn, mx = base, base
    packs = [torch.stack([mn, mx], dim=-1)]
    for _ in range(levels - 1):
        mn = torch.minimum(mn[..., 0::2], mn[..., 1::2])
        mx = torch.maximum(mx[..., 0::2], mx[..., 1::2])
        packs.append(torch.stack([mn, mx], dim=-1))
    packed = torch.cat([p.reshape(-1, 2) for p in packs], dim=0)
    return ShadowLineTree(packed=packed, lv_xy0=lv0[:2], u_dir=u_dir,
                          u_min=u_min, u_rng=u_rng, base_r=base_r,
                          levels=levels)


def make_tree_shadow_fn(tree: ShadowLineTree, att, camera: CameraAttribs,
                        slice_ids: Tensor, du_cells: Tensor) -> ShadowFn:
    """Visibility function backed by the 1D min/max tree.  slice_ids:
    integer tensor broadcastable to the ray shape; du_cells: per-ray span
    (in base cells) one march step covers, which selects the tree level
    whose cell bounds the step."""
    wl = att.world_to_light_view
    c = att.light_space_scale.shape[0]
    s_cnt = tree.u_dir.shape[0]
    dev = tree.packed.device
    lvl_f = torch.clamp(torch.ceil(torch.log2(torch.clamp(du_cells,
                                                          min=1.0))),
                        0, tree.levels - 1).to(torch.int64)
    offs, acc = [], 0
    for k in range(tree.levels):      # level offsets into the flat table
        offs.append(acc)
        acc += c * s_cnt * (tree.base_r >> k)
    offs = torch.tensor(offs, dtype=torch.int64, device=dev)
    slice_ids = slice_ids.long()

    def fn(p: Tensor) -> Tensor:
        lv = m3.transform_points(p, wl)[..., :3]
        cam_z = -m3.transform_points(p, camera.view)[..., 2]
        info = find_cascade(att, lv, cam_z)
        u = torch.sum((lv[..., :2] - tree.lv_xy0) * tree.u_dir[slice_ids],
                      dim=-1)
        cell_f = (u - tree.u_min[slice_ids]) / tree.u_rng[slice_ids]
        lvl = lvl_f.expand(cell_f.shape)
        off = offs[lvl]
        r_l = tree.base_r >> lvl
        cell = torch.minimum(_to_index(cell_f * r_l.float(), tree.base_r),
                             r_l - 1)
        flat = off + (info.cascade_idx * s_cnt + slice_ids) * r_l + cell
        g = tree.packed[flat]
        zr = info.depth[..., 0] - 1e-3
        mn, mx = g[..., 0], g[..., 1]
        vis = torch.where(zr <= mn, torch.ones_like(zr),
                          torch.where(zr > mx, torch.zeros_like(zr),
                                      (mx - zr) / torch.clamp(mx - mn,
                                                              min=1e-5)))
        return torch.where(info.in_any, vis, torch.ones_like(vis))

    return fn


class EpipolarOutput(NamedTuple):
    color: Tensor          # (H, W, 3) scene with inscattering applied
    inscatter: Tensor      # (H, W, 3)
    transmittance: Tensor  # (H, W, 3)


def _uv_depth_to_world(uv: Tensor, depth: Tensor,
                       camera: CameraAttribs) -> Tensor:
    ndc = torch.stack([uv[..., 0] * 2.0 - 1.0, 1.0 - uv[..., 1] * 2.0,
                       depth, torch.ones_like(depth)], dim=-1)
    world = m3.vec_mat4(ndc, camera.view_proj_inv)
    return world[..., :3] / world[..., 3:4]


def _apply(color: Tensor, depth: Tensor, camera: CameraAttribs,
           sun_dir: Tensor, sun_intensity_rgb: Tensor, lut: Tensor,
           s: EpipolarSettings, shadow_data, ms_lut) -> EpipolarOutput:
    h, w = depth.shape
    dev = depth.device
    num_slices, num_samples = s.num_epipolar_slices, s.max_samples_in_slice
    steps, refine_m = s.num_ray_march_steps, s.refinement_factor

    # the sun projected to uv space.  A sun behind the camera lands, through
    # the negative w, on the antisolar point, where screen-space rays
    # converge; the slab-clipped grid handles it on or off screen alike.
    sun_clip = m3.transform_points(camera.position - sun_dir * 1e4,
                                   camera.view_proj)
    sun_w = torch.where(torch.abs(sun_clip[3]) < 1e-6,
                        torch.full_like(sun_clip[3], 1e-6), sun_clip[3])
    sun_ndc = sun_clip[:2] / sun_w
    light_uv = torch.stack([sun_ndc[0] * 0.5 + 0.5, 0.5 - sun_ndc[1] * 0.5])
    grid_uv, ends = _epipolar_grid(light_uv, num_slices, num_samples)

    # per-epipolar-sample ray setup from the depth buffer
    d_smp = bilinear_sample(depth[..., None], grid_uv)[..., 0]
    world = _uv_depth_to_world(grid_uv, d_smp, camera)
    origins = camera.position.expand(world.shape)
    delta = world - origins
    lengths = torch.sqrt(torch.clamp(torch.sum(delta * delta, dim=-1),
                                     min=1e-8))
    dirs = delta / lengths[..., None]

    tree = None

    def make_shadow_fn(slice_ids, du_cells):
        return None

    if shadow_data is not None:
        att, smaps = shadow_data
        if s.use_minmax_tree:
            tree = build_shadow_line_tree(att, smaps, camera, world,
                                          num_slices,
                                          base_r=s.minmax_tree_res)

            def make_shadow_fn(slice_ids, du_cells):   # noqa: F811
                return make_tree_shadow_fn(tree, att, camera, slice_ids,
                                           du_cells)
        else:
            def pcf_fn(p):
                plv = m3.transform_points(p, att.world_to_light_view)[..., :3]
                cam_z = -m3.transform_points(p, camera.view)[..., 2]
                info = find_cascade(att, plv, cam_z)
                lit = filter_shadow_pcf(smaps, info, 2, depth_bias=1e-3)
                return torch.where(info.in_any, lit, torch.ones_like(lit))

            def make_shadow_fn(slice_ids, du_cells):   # noqa: F811
                return pcf_fn

    def du_cells_of(lengths_, dirs_, slice_ids):
        """Per-ray march-step span in tree base cells (level selector)."""
        if tree is None:
            return torch.zeros_like(lengths_)
        d_xy = m3.transform_directions(
            dirs_, shadow_data[0].world_to_light_view)[..., :2]
        du = torch.abs(torch.sum(d_xy * tree.u_dir[slice_ids], dim=-1))
        return (lengths_ / steps) * du / (tree.u_rng[slice_ids]
                                          / tree.base_r)

    if s.single_sctr_lut:
        cum, cum_tmax = _build_sctr_cumulative(
            lut, camera, sun_dir, s, torch.clamp(torch.max(lengths),
                                                 min=1e-3), ms_lut=ms_lut)

        def inscatter_eval(o_, d_, l_, shadow_fn_, jitter_=None):
            return _inscatter_lut(cum, cum_tmax, o_, d_, l_, sun_dir, s,
                                  shadow_fn=shadow_fn_, jitter=jitter_)
    else:
        def inscatter_eval(o_, d_, l_, shadow_fn_, jitter_=None):
            return _inscatter_march(lut, o_, d_, l_, sun_dir, s, shadow_fn_,
                                    ms_lut=ms_lut, jitter=jitter_)

    if refine_m <= 1:
        sl_ids = torch.arange(num_slices, device=dev)[:, None].expand(
            lengths.shape)
        inscatter_e, trans_e = inscatter_eval(
            origins, dirs, lengths,
            make_shadow_fn(sl_ids, du_cells_of(lengths, dirs, sl_ids)))
    else:
        inscatter_e, trans_e = _refined_inscatter(
            s, camera, d_smp, origins, dirs, lengths, inscatter_eval,
            make_shadow_fn, du_cells_of)

    # ---- unwarp epipolar -> screen (depth-break-aware bilinear) ----------
    yy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    xx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    duv = torch.stack([xx[None, :].expand(h, w), yy[:, None].expand(h, w)],
                      dim=-1) - light_uv
    ang = torch.remainder(torch.atan2(duv[..., 1], duv[..., 0]), 2.0 * PI)
    slice_f = ang / (2.0 * PI) * num_slices - 0.5
    s_floor = torch.floor(slice_f)
    s0 = torch.remainder(s_floor.long(), num_slices)
    s1 = torch.remainder(s0 + 1, num_slices)
    sf = (slice_f - s_floor)[..., None]

    def frac_along(slice_idx):
        seg = ends[slice_idx] - light_uv
        seg_len2 = torch.clamp(torch.sum(seg * seg, dim=-1), min=1e-9)
        return torch.clamp(torch.sum(duv * seg, dim=-1) / seg_len2, 0.0, 1.0)

    cam_z_px = depth_to_camera_z(depth, camera)
    z_scale = 0.2 * cam_z_px + 1.0

    def gather_slice(slice_idx, f):
        smp_f = f * num_samples - 0.5
        i0 = torch.clamp(torch.floor(smp_f).long(), 0, num_samples - 1)
        i1 = torch.clamp(i0 + 1, max=num_samples - 1)
        wf = smp_f - i0.float()

        def tap(ii):
            dz = depth_to_camera_z(d_smp[slice_idx, ii], camera)
            return inscatter_e[slice_idx, ii], trans_e[slice_idx, ii], dz

        a_ins, a_tr, a_z = tap(i0)
        b_ins, b_tr, b_z = tap(i1)
        # depth-break correction: discount taps whose depth differs
        # strongly; the floor keeps the blend an average when both taps
        # disagree with the pixel depth (thin silhouettes stay lit)
        wa = (1.0 - wf) * (0.02 + torch.exp(-torch.abs(a_z - cam_z_px)
                                            / z_scale))
        wb = wf * (0.02 + torch.exp(-torch.abs(b_z - cam_z_px) / z_scale))
        tot = torch.clamp(wa + wb, min=1e-6)[..., None]
        return ((a_ins * wa[..., None] + b_ins * wb[..., None]) / tot,
                (a_tr * wa[..., None] + b_tr * wb[..., None]) / tot)

    ins0, tr0 = gather_slice(s0, frac_along(s0))
    ins1, tr1 = gather_slice(s1, frac_along(s1))
    inscatter = ins0 + (ins1 - ins0) * sf
    trans = tr0 + (tr1 - tr0) * sf

    # ---- sun disk (RenderSun) -----------------------------------------------
    ray = _camera_rays(camera, w, h)
    cos_sun = torch.sum(ray * (-sun_dir), dim=-1)
    sky = depth >= 0.9999
    cos_r = np.cos(np.float32(s.sun_angular_radius))
    disk = torch.clamp((cos_sun - float(cos_r))
                       / float(np.float32(1.0) - cos_r) * 4.0, 0.0, 1.0)
    sun_rgb = sun_intensity_rgb * f32(s.sun_intensity)
    sun = (disk * sky.float())[..., None] * sun_rgb
    out = color * trans + inscatter * sun_intensity_rgb + sun * trans
    return EpipolarOutput(color=out, inscatter=inscatter, transmittance=trans)


def _refined_inscatter(s: EpipolarSettings, camera, d_smp, origins, dirs,
                       lengths, inscatter_eval, make_shadow_fn, du_cells_of):
    """Sample refinement (RefineSampleLocations + the interpolation-source
    search as a fixed budget): march every m-th sample; samples whose
    interpolation sources straddle a depth break are compacted into a
    fixed refinement buffer and marched exactly; the rest interpolate
    along the slice.  The JAX package scatters with mode="drop" (an index
    past the end writes nothing); here the dropped writes go to one spare
    row or slot that is cut off afterwards."""
    num_slices, num_samples = s.num_epipolar_slices, s.max_samples_in_slice
    dev = lengths.device
    m_f = s.refinement_factor
    n_c = num_samples // m_f
    cap = max((num_slices * num_samples) // s.refinement_budget_div, 128)
    ic = torch.arange(n_c, device=dev) * m_f                  # coarse ids
    sl_c = torch.arange(num_slices, device=dev)[:, None].expand(num_slices,
                                                                n_c)
    oc, dc, lc = origins[:, ic], dirs[:, ic], lengths[:, ic]
    ins_c, tr_c = inscatter_eval(oc, dc, lc,
                                 make_shadow_fn(sl_c, du_cells_of(lc, dc,
                                                                  sl_c)))

    # depth breaks between adjacent epipolar samples (linear view z)
    z_lin = depth_to_camera_z(d_smp, camera)
    brk = (torch.abs(z_lin[:, 1:] - z_lin[:, :-1])
           > 0.1 * torch.minimum(z_lin[:, 1:], z_lin[:, :-1]))
    cum = torch.cat([torch.zeros((num_slices, 1), dtype=torch.int64,
                                 device=dev),
                     torch.cumsum(brk.long(), dim=1)], dim=1)  # (S, N)
    i_all = torch.arange(num_samples, device=dev)
    left = (i_all // m_f) * m_f
    right = torch.clamp(left + m_f, max=num_samples - 1)
    # breaks strictly inside (left, right]
    span_brk = cum[:, right] - cum[:, left]
    is_coarse = (i_all % m_f == 0)[None, :]
    refined = (~is_coarse) & (span_brk > 0)

    # interpolate along the slice from the coarse sources (the JAX gather
    # clamps an index past the last coarse sample; so does this)
    li = torch.clamp(left // m_f, max=n_c - 1)
    ri = torch.clamp(li + 1, max=n_c - 1)
    f = ((i_all - left) / m_f)[None, :, None]
    ins_i = ins_c[:, li] * (1.0 - f) + ins_c[:, ri] * f
    tr_i = tr_c[:, li] * (1.0 - f) + tr_c[:, ri] * f

    # compact refined sample ids into the fixed budget; slot `cap` is the
    # spare one that takes the dropped writes
    flat_mask = refined.reshape(-1)
    pos = torch.cumsum(flat_mask.long(), dim=0) - 1
    flat_ids = torch.arange(num_slices * num_samples, device=dev)
    buf = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    buf[torch.where(flat_mask & (pos < cap), pos,
                    torch.full_like(pos, cap))] = flat_ids
    buf = buf[:cap]
    r_s = torch.clamp(buf, min=0) // num_samples
    r_i = torch.clamp(buf, min=0) % num_samples
    orr, drr, lrr = origins[r_s, r_i], dirs[r_s, r_i], lengths[r_s, r_i]
    jit_r = torch.remainder(0.618034 * r_s.float() + 0.3247179 * r_i.float(),
                            1.0)
    ins_r, tr_r = inscatter_eval(
        orr, drr, lrr, make_shadow_fn(r_s, du_cells_of(lrr, drr, r_s)),
        jitter_=jit_r)
    # the exact marches over the interpolation; empty slots write to the
    # spare row num_slices
    tgt_s = torch.where(buf >= 0, r_s, torch.full_like(r_s, num_slices))

    def scatter(dst, src):
        spare = torch.cat([dst, torch.zeros_like(dst[:1])], dim=0)
        spare[tgt_s, r_i] = src
        return spare[:num_slices]

    return scatter(ins_i, ins_r), scatter(tr_i, tr_r)


def apply_light_scattering(color: Tensor, depth: Tensor,
                           camera: CameraAttribs, sun_dir, lut: Tensor,
                           settings: EpipolarSettings = EpipolarSettings(),
                           sun_intensity_rgb=(1.0, 0.96, 0.90),
                           shadow_data=None, ms_lut=None) -> EpipolarOutput:
    """The full effect (PrepareForNewFrame + PerformPostProcessing +
    RenderSun): color (H, W, 3) linear HDR, depth (H, W) NDC; shadow_data
    (ShadowMapAttribs, (C, S, S) cascade depth maps) or None."""
    sun_dir = m3.normalize(torch.as_tensor(sun_dir, dtype=torch.float32,
                                           device=depth.device))
    rgb = torch.as_tensor(sun_intensity_rgb, dtype=torch.float32,
                          device=depth.device)
    return _apply(color, depth, camera, sun_dir, rgb, lut, settings,
                  shadow_data, ms_lut)
