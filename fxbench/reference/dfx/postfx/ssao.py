"""Screen-space ambient occlusion (the port of diligentfx_tpu/postfx/ssao.py):
the GTAO horizon-slice integral at half resolution, a depth-aware bilateral
blur, and variance-guided temporal accumulation with convolved-depth
history validation.

Two routes compute the horizon taps, as in the JAX package:
  * `use_pallas=False`: bilinear taps of the depth, far steps on the
    prefiltered (2x2 mean) mips;
  * `use_pallas=True` (the kernel route): mip-0 taps through the bounded
    warp kernel (ops/warp.py, one launch a tap), offsets clamped to its
    (+-63, +-15) px halo.
On a CPU tensor the kernel route runs the kernels' plain versions.

The row-band arguments run the same code on one row band of a frame
(parallel/tiling.py): `row0` / `full_h` key the noise and the positions on
global rows, `max_tap_px` keeps the horizon taps inside a halo, and
`band` (a context.BandCtx) gives the temporal stage halo rows of the
history and of the AO.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fxbench.reference.dfx.attribs import CameraAttribs
from fxbench.reference.dfx.math3d import cross, normalize
from fxbench.reference.dfx.ops import warp
from fxbench.reference.dfx.ops.sampling import (bilinear_sample,
                                               upsample_bilinear)
from fxbench.reference.dfx.postfx.context import (BandCtx, depth_to_camera_z,
                                                 edge_pad,
                                                 interleaved_gradient_noise,
                                                 pixel_grid)

Tensor = torch.Tensor
PI = 3.141592653589793


def f32(x) -> float:
    """A Python float holding the float32 value of x (JAX keeps settings in
    float32; the port computes their combinations in float32 the same way)."""
    return float(np.float32(x))


class SSAOSettings(NamedTuple):
    """ScreenSpaceAmbientOcclusionAttribs analogue."""
    effect_radius: float = 1.0        # world units
    effect_falloff_range: float = 0.615
    radius_multiplier: float = 1.0
    depth_mip_sampling_offset: float = 3.3
    temporal_stability_factor: float = 0.9
    spatial_reconstruction_radius: float = 4.0


class SSAOState(NamedTuple):
    history: Tensor                         # (H, W)
    # the previous frame's convolved depth, reprojected and compared with
    # the current one to validate the history per pixel
    depth_history: Optional[Tensor] = None  # (H, W)


def view_space_position(depth: Tensor, camera: CameraAttribs, row0: int = 0,
                        full_h: int = 0) -> Tensor:
    """Per-pixel view-space position (x right, y up, looking down -Z); the
    local rows are rows [row0, row0 + h) of a full_h-row frame."""
    h, w = depth.shape
    z = depth_to_camera_z(depth, camera)
    y, x = pixel_grid(h, w, depth.device, row0)
    x_ndc = (x + 0.5) / w * 2 - 1
    y_ndc = 1 - (y + 0.5) / (full_h or h) * 2
    return torch.stack([x_ndc * z / camera.proj[0, 0],
                        y_ndc * z / camera.proj[1, 1], -z], dim=-1)


def build_avg_depth_pyramid(depth: Tensor, levels: int = 3) -> List[Tensor]:
    """Prefiltered (2x2 mean) depth mips: far AO taps read averaged depth."""
    mips = [depth]
    cur = depth
    for _ in range(levels - 1):
        h, w = cur.shape
        if h < 2 or w < 2:
            break
        c = cur[:h // 2 * 2, :w // 2 * 2]
        cur = 0.25 * (c[0::2, 0::2] + c[1::2, 0::2]
                      + c[0::2, 1::2] + c[1::2, 1::2])
        mips.append(cur)
    return mips


def _tap_depth(depth: Tensor, off_x: Tensor, off_y: Tensor,
               use_pallas: bool) -> Tensor:
    """Depth at pixel + offset px: a bilinear tap, or on the kernel route
    the bounded warp (edge-padded to its 8 x 128 grid, halo (16, 64))."""
    h, w = depth.shape
    if use_pallas:
        pad_h, pad_w = (-h) % warp.TILE_H, (-w) % warp.TILE_W
        d = edge_pad(depth, pad_h, pad_w).contiguous()
        off = edge_pad(torch.stack([off_x, off_y], dim=-1), pad_h,
                        pad_w).contiguous()
        return warp.warp_bilinear(d, off, halo_r=16, halo_c=64)[:h, :w]
    y, x = pixel_grid(h, w, depth.device)
    uv = torch.stack([(x + 0.5 + off_x) / w, (y + 0.5 + off_y) / h], dim=-1)
    return bilinear_sample(depth[..., None], uv)[..., 0]


def _uv_depth_to_view(uv: Tensor, depth: Tensor,
                      camera: CameraAttribs) -> Tensor:
    z = depth_to_camera_z(depth, camera)
    x_ndc = uv[..., 0] * 2.0 - 1.0
    y_ndc = 1.0 - uv[..., 1] * 2.0
    return torch.stack([x_ndc * z / camera.proj[0, 0],
                        y_ndc * z / camera.proj[1, 1], -z], dim=-1)


def _radius_px(view_z: Tensor, camera: CameraAttribs, settings: SSAOSettings,
               h: int, w: int) -> Tensor:
    """Screen-space radius: the world radius projected at this depth."""
    radius = f32(np.float32(settings.effect_radius)
                 * np.float32(settings.radius_multiplier))
    radius_px = (radius * camera.proj[1, 1] * (h * 0.5)
                 / torch.clamp(view_z, min=1e-4))
    return torch.clamp(radius_px, 2.0, float(max(h, w)) * 0.25)


def _tap_offset(noise: Tensor, radius_px: Tensor, s: int, sgn: float,
                step: int, num_slices: int, num_steps: int,
                use_pallas: bool, max_tap_px=None) -> Tensor:
    """Pixel offset (..., 2) = (dx, dy) of horizon tap `step` on side `sgn`
    of slice `s`; on the kernel route clamped to the warp's halo, and
    with max_tap_px to (+-dx, +-dy)."""
    phi_s = (s + noise) * (PI / num_slices)
    d_px = torch.stack([torch.cos(phi_s), -torch.sin(phi_s)], dim=-1)
    t = (step + 0.5 + 0.5 * noise) / num_steps
    t = t * t                                      # denser near the centre
    off = d_px * (sgn * t * radius_px)[..., None]
    if use_pallas:
        # the warp kernel's halo clamp, applied to the reconstructed
        # position too
        off = torch.stack([torch.clamp(off[..., 0], -63.0, 63.0),
                           torch.clamp(off[..., 1], -15.0, 15.0)], -1)
    if max_tap_px is not None:
        mx, my = (float(v) for v in max_tap_px)
        off = torch.stack([torch.clamp(off[..., 0], -mx, mx),
                           torch.clamp(off[..., 1], -my, my)], -1)
    return off


def compute_gtao(depth: Tensor, normal_vs: Tensor, camera: CameraAttribs,
                 frame_index: int, settings: SSAOSettings = SSAOSettings(),
                 num_slices: int = 3, num_steps: int = 6,
                 use_pallas: bool = False, row0=0, full_h: int = 0,
                 max_tap_px: Optional[Tuple[float, float]] = None,
                 use_mips: bool = True) -> Tensor:
    """GTAO horizon-slice integral (the SSAO ComputeAO pass, JAX
    ssao.py:102).  depth (H, W) NDC, normal_vs (H, W, 3) view space ->
    (H, W) ambient visibility in [0, 1].

    row0 / full_h: the depth holds rows [row0, row0 + h) of a full_h-row
    frame (noise and positions on global rows; the taps read the band's
    own rows, edge-clamped); max_tap_px clamps the tap offsets to (+-dx,
    +-dy) px, a halo's size; use_mips=False taps mip 0 only (a band's
    pyramid cannot match the frame's)."""
    h, w = depth.shape
    fh = full_h or h
    pos = view_space_position(depth, camera, row0, fh)
    view_z = -pos[..., 2]
    v = normalize(-pos)
    # noise keyed on global rows: a band evaluates the frame's pattern
    noise = interleaved_gradient_noise(h, w, frame_index, device=depth.device,
                                       row0=row0)

    radius = f32(np.float32(settings.effect_radius)
                 * np.float32(settings.radius_multiplier))
    radius_px = _radius_px(view_z, camera, settings, fh, w)
    falloff_range = f32(np.float32(settings.effect_falloff_range)
                        * np.float32(radius))
    falloff_from = f32(np.float32(radius)
                       * (np.float32(1.0)
                          - np.float32(settings.effect_falloff_range)))

    y, x = pixel_grid(h, w, depth.device, row0)
    xi, yi = x + 0.5, y + 0.5
    # prefiltered mips: near third of the steps taps mip 0, the middle
    # third mip 1, the far third mip 2 (the kernel route keeps mip 0)
    depth_pyr = (build_avg_depth_pyramid(depth, 3)
                 if (use_mips and not use_pallas) else [depth])

    visibility = torch.zeros((h, w), dtype=torch.float32, device=depth.device)
    for s in range(num_slices):
        phi = (s + noise) * (PI / num_slices)
        cos_p = torch.cos(phi)
        sin_p = torch.sin(phi)
        # the slice axis in view space, projected onto the tangent plane
        slice_dir = torch.stack([cos_p, sin_p, torch.zeros_like(cos_p)], -1)
        ortho = slice_dir - v * torch.sum(slice_dir * v, -1, keepdim=True)
        axis = normalize(cross(ortho, v))
        n_proj = normal_vs - axis * torch.sum(normal_vs * axis, -1,
                                              keepdim=True)
        n_proj_len = torch.sqrt(torch.clamp(torch.sum(n_proj * n_proj, -1),
                                            min=1e-8))
        cos_norm = torch.clamp(torch.sum(n_proj * v, -1) / n_proj_len,
                               -1.0, 1.0)
        n_angle = torch.arccos(cos_norm) * torch.sign(
            torch.sum(n_proj * ortho, -1))

        best_cos = [torch.full((h, w), -1.0, device=depth.device),
                    torch.full((h, w), -1.0, device=depth.device)]
        for side, sgn in ((0, 1.0), (1, -1.0)):
            for step in range(num_steps):
                mip = (0 if (use_pallas or not use_mips)
                       else min((3 * step) // max(num_steps, 1),
                                len(depth_pyr) - 1))
                off = _tap_offset(noise, radius_px, s, sgn, step,
                                  num_slices, num_steps, use_pallas,
                                  max_tap_px)
                if mip == 0:
                    d = _tap_depth(depth, off[..., 0], off[..., 1],
                                   use_pallas)
                else:
                    uv_m = torch.stack([(xi + off[..., 0]) / w,
                                        (yi + off[..., 1]) / fh], dim=-1)
                    d = bilinear_sample(depth_pyr[mip][..., None],
                                        uv_m)[..., 0]
                uv = torch.stack([(xi + off[..., 0]) / w,
                                  (yi + off[..., 1]) / fh], dim=-1)
                delta = _uv_depth_to_view(uv, d, camera) - pos
                dist = torch.sqrt(torch.clamp(torch.sum(delta * delta, -1),
                                              min=1e-10))
                cos_h = torch.sum(delta * v, -1) / dist
                # distance falloff (thin-object rejection)
                weight = torch.clamp(1.0 - (dist - falloff_from)
                                     / max(falloff_range, 1e-5), 0.0, 1.0)
                cos_h = cos_h * weight - (1.0 - weight)
                best_cos[side] = torch.maximum(best_cos[side], cos_h)

        # side 0 marches +dir_px = +ortho: its horizon is the positive h1
        h0 = -torch.arccos(torch.clamp(best_cos[1], -1.0, 1.0))
        h1 = torch.arccos(torch.clamp(best_cos[0], -1.0, 1.0))
        # clamp the horizons to the normal hemisphere
        h0 = n_angle + torch.clamp(h0 - n_angle, min=-PI / 2)
        h1 = n_angle + torch.clamp(h1 - n_angle, max=PI / 2)
        # cosine-weighted arc integral
        a = (0.25 * (-torch.cos(2.0 * h0 - n_angle) + torch.cos(n_angle)
                     + 2.0 * h0 * torch.sin(n_angle))
             + 0.25 * (-torch.cos(2.0 * h1 - n_angle) + torch.cos(n_angle)
                       + 2.0 * h1 * torch.sin(n_angle)))
        visibility = visibility + n_proj_len * a
    return torch.clamp(visibility / num_slices, 0.0, 1.0)


def bilateral_blur(ao: Tensor, depth: Tensor, camera: CameraAttribs,
                   radius: int = 3, depth_sigma: float = 0.05) -> Tensor:
    """Depth-aware separable blur (the SpatialReconstruction pass)."""
    z = depth_to_camera_z(depth, camera)
    out = ao
    for axis in (0, 1):
        acc = torch.zeros_like(out)
        wacc = torch.zeros_like(out)
        for d in range(-radius, radius + 1):
            a = torch.roll(out, -d, dims=axis)
            zz = torch.roll(z, -d, dims=axis)
            wz = torch.exp(-torch.abs(zz - z)
                           / (depth_sigma * torch.clamp(z, min=1e-3)))
            wg = math.exp(-0.5 * (d / max(radius * 0.6, 1e-3)) ** 2)
            acc = acc + a * wz * wg
            wacc = wacc + wz * wg
        out = acc / torch.clamp(wacc, min=1e-6)
    return out


def _window_source(x: Tensor, band: Optional[BandCtx]) -> Tensor:
    """x, or with `band` x on one wrap-exchanged halo row a side: rolled
    and cropped to rows [1, 1 + h), its 3x3 windows equal the whole
    frame's torch.roll windows."""
    return x if band is None else band.extend(x, 1, wrap=True)


def convolved_depth(depth: Tensor, band: Optional[BandCtx] = None
                    ) -> Tensor:
    """Depth blurred to the AO filter footprint (3x3 mean, wrap-around):
    the history-validation metric of the reference's denoiser (JAX
    ssao.py:349)."""
    h = depth.shape[0]
    src = _window_source(depth, band)
    conv = torch.zeros_like(depth)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = torch.roll(src, (dy, dx), dims=(0, 1))
            conv = conv + (s if band is None else s[1:1 + h])
    return conv / 9.0


def ssao_temporal(ao: Tensor, conv_depth: Tensor, state: Optional[SSAOState],
                  motion: Optional[Tensor],
                  settings: SSAOSettings = SSAOSettings(), *,
                  use_pallas: bool = False,
                  disocclusion: Optional[Tensor] = None,
                  band: Optional[BandCtx] = None
                  ) -> Tuple[Tensor, SSAOState]:
    """Variance-guided temporal accumulation with convolved-depth-validated
    resampled history (JAX ssao.py:365).  On the kernel route the history
    (AO and convolved depth, 2 channels) is reprojected by the bounded warp
    with halo (8, 64).  With `band`, the history warp reads halo-extended
    rows (vertical motion clamped to halo - 1 px) and the moment window a
    wrap halo: one implementation for the frame and its bands."""
    if state is None or motion is None:
        return ao, SSAOState(history=ao, depth_history=conv_depth)
    h, w = ao.shape
    y, x = pixel_grid(h, w, ao.device)
    xg = (x + 0.5) / w
    depth_hist = state.depth_history
    if band is None:
        prev_uv = torch.stack([xg, (y + 0.5) / h], dim=-1) - motion
        hist_src = torch.stack([state.history,
                                (depth_hist if depth_hist is not None
                                 else torch.zeros_like(state.history))],
                               dim=-1)
        samp_uv = prev_uv
        off_px = -motion * torch.tensor([w, h], dtype=torch.float32,
                                        device=ao.device)
    else:
        halo, fh, y0 = band.halo, band.full_h, float(band.y0)
        ygp = y + y0 + 0.5
        my = torch.clamp(motion[..., 1] * fh, -(halo - 1.0), halo - 1.0)
        prev_uv = torch.stack([xg - motion[..., 0], (ygp - my) / fh], dim=-1)
        # each channel extended alone: the same rows as one extend of the
        # stack
        hist = band.extend(state.history, halo, wrap=False)
        hist_src = torch.stack([hist, (band.extend(depth_hist, halo,
                                                   wrap=False)
                                       if depth_hist is not None
                                       else torch.zeros_like(hist))], dim=-1)
        samp_uv = torch.stack([prev_uv[..., 0],
                               (ygp - my - y0 + halo) / (h + 2.0 * halo)],
                              dim=-1)
        off_px = torch.stack([-motion[..., 0] * w, -my], dim=-1)
    if use_pallas:
        if band is not None:
            off_px = torch.nn.functional.pad(off_px, (0, 0, 0, 0, band.halo,
                                                      band.halo))
        warped = warp.warp_bilinear(hist_src.contiguous(), off_px.contiguous(),
                                    halo_r=8, halo_c=64)
        if band is not None:
            warped = warped[band.halo:band.halo + h]
    else:
        warped = bilinear_sample(hist_src, samp_uv)
    hist = warped[..., 0]
    hist_cd = warped[..., 1] if state.depth_history is not None else None

    # clamp the reprojected history to the current 3x3 AO distribution
    src = _window_source(ao, band)
    acc = torch.zeros_like(ao)
    acc2 = torch.zeros_like(ao)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = torch.roll(src, (dy, dx), dims=(0, 1))
            if band is not None:
                s = s[1:1 + h]
            acc = acc + s
            acc2 = acc2 + s * s
    mean = acc / 9.0
    std = torch.sqrt(torch.clamp(acc2 / 9.0 - mean * mean, min=0.0))
    hist = torch.clamp(hist, mean - 2.0 * std, mean + 2.0 * std)
    reject = ~((prev_uv[..., 0] >= 0) & (prev_uv[..., 0] <= 1)
               & (prev_uv[..., 1] >= 0) & (prev_uv[..., 1] <= 1))
    if disocclusion is not None:
        reject = reject | disocclusion
    keep = f32(np.float32(1.0) - np.float32(settings.temporal_stability_factor))
    alpha = torch.where(reject, 1.0, keep)
    if hist_cd is not None:
        # down-weight history whose reprojected convolved depth disagrees
        # with the current one
        rel = torch.abs(hist_cd - conv_depth) / torch.clamp(conv_depth,
                                                            min=1e-4)
        alpha = 1.0 - (1.0 - alpha) * torch.exp(-rel * 16.0)
    ao = hist + (ao - hist) * alpha
    return ao, SSAOState(history=ao, depth_history=conv_depth)


def apply_ssao(depth: Tensor, normal_vs: Tensor, camera: CameraAttribs,
               frame_index: int, settings: SSAOSettings = SSAOSettings(),
               state: Optional[SSAOState] = None,
               motion: Optional[Tensor] = None,
               half_resolution: bool = True, num_slices: int = 3,
               num_steps: int = 6, use_pallas: bool = False,
               disocclusion: Optional[Tensor] = None
               ) -> Tuple[Tensor, SSAOState]:
    """The SSAO effect (JAX ssao.py:314): GTAO (optionally at half
    resolution), bilateral denoise, upsample, temporal accumulation."""
    h, w = depth.shape
    if half_resolution:
        d2 = depth[::2, ::2]
        ao = compute_gtao(d2, normal_vs[::2, ::2], camera, frame_index,
                          settings, num_slices, num_steps,
                          use_pallas=use_pallas)
        ao = bilateral_blur(ao, d2, camera)
        ao = upsample_bilinear(ao, 2, 2)[:h, :w]
    else:
        ao = compute_gtao(depth, normal_vs, camera, frame_index, settings,
                          num_slices, num_steps, use_pallas=use_pallas)
        ao = bilateral_blur(ao, depth, camera)
    return ssao_temporal(ao, convolved_depth(depth), state, motion, settings,
                         use_pallas=use_pallas, disocclusion=disocclusion)
