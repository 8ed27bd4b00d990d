"""Depth of field (the port of diligentfx_tpu/postfx/dof.py): signed
circle of confusion from a thin-lens model, temporal CoC, separated
near/far fields, near-CoC dilation and separable blur, a half-resolution
disk-gather bokeh producing both fields from one set of taps, a fixed-ring
second bokeh pass, a tent postfilter and a far-then-near combine.

Two routes sample the bokeh taps, as in the JAX package:
  * `use_pallas=False`: bilinear taps of colour and both reach fields;
  * `use_pallas=True` (the kernel route): colour and both reach fields
    packed into one 5-channel image, edge-padded to the warp's 8 x 128
    grid, each tap one launch of the bounded warp kernel (ops/warp.py,
    halo (16, 64)).
On a CPU tensor the kernel route runs the warp's plain version.

Settings are float32 in the JAX package; their scalar combinations are
formed in float32 here too (`f32`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from diligentfx_tpu_torch.attribs import CameraAttribs
from diligentfx_tpu_torch.ops import warp
from diligentfx_tpu_torch.ops.sampling import (bilinear_sample,
                                               upsample_bilinear)
from diligentfx_tpu_torch.postfx.context import (depth_to_camera_z, edge_pad,
                                                 pixel_grid)

Tensor = torch.Tensor


def f32(x) -> float:
    """A Python float holding the float32 value of x."""
    return float(np.float32(x))


class DoFSettings(NamedTuple):
    """DepthOfFieldAttribs analogue."""
    focus_distance: float = 5.0        # meters
    f_stop: float = 5.6
    focal_length: float = 0.05         # meters (50mm)
    max_coc_px: float = 12.0           # max bokeh radius in pixels
    temporal_stability_factor: float = 0.9


class DoFState(NamedTuple):
    coc_history: Tensor                # (H, W)


def circle_of_confusion(depth: Tensor, camera: CameraAttribs,
                        s: DoFSettings) -> Tensor:
    """Signed CoC in [-1, 1] (negative = near field)."""
    z = depth_to_camera_z(depth, camera)
    f = np.float32(s.focal_length)
    aperture = f / np.float32(s.f_stop)
    fd = np.float32(s.focus_distance)
    coc_m = float(aperture * f) * (z - float(fd)) / torch.clamp(
        z * float(fd - f), min=1e-6)
    # sensor-plane CoC (meters) -> pixels: 24mm full-frame sensor height
    coc_px = coc_m * (depth.shape[0] / 0.024)
    return torch.clamp(coc_px / f32(s.max_coc_px), -1.0, 1.0)


def dilate_near_coc(coc: Tensor, radius: int = 4) -> Tensor:
    """Near-field CoC dilation: max-pool |near| (wrapping at the borders,
    as jnp.roll does) so sharp objects in front of blurred backgrounds
    bleed correctly."""
    d = torch.clamp(-coc, min=0.0)
    for axis in (0, 1):
        acc = d
        for k in range(1, radius + 1):
            acc = torch.maximum(acc, torch.roll(d, k, dims=axis))
            acc = torch.maximum(acc, torch.roll(d, -k, dims=axis))
        d = acc
    return d


def blur_coc_xy(coc: Tensor, radius: int = 3, sigma: float = 1.5) -> Tensor:
    """Separable Gaussian over the dilated near-CoC field (the reference's
    CoC blur X / Y passes)."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / torch.sum(k)).tolist()
    out = coc
    for axis in (0, 1):
        acc = torch.zeros_like(out)
        for j in range(2 * radius + 1):
            acc = acc + torch.roll(out, j - radius, dims=axis) * k[j]
        out = acc
    return out


def _disk_kernel(n: int) -> np.ndarray:
    """Golden-spiral unit disk points, (n, 2) float32."""
    ga = math.pi * (3.0 - math.sqrt(5.0))
    pts = []
    for i in range(n):
        r = math.sqrt((i + 0.5) / n)
        a = i * ga
        pts.append((r * math.cos(a), r * math.sin(a)))
    return np.asarray(pts, np.float32)


def bokeh_blur_separated(color: Tensor, coc: Tensor, near_coc: Tensor,
                         s: DoFSettings, kernel_size: int = 24,
                         use_pallas: bool = False) -> Tuple[Tensor, Tensor]:
    """Disk-gather bokeh producing the separated far and near fields from
    one set of taps: a tap adds to the far field where the sample's own far
    CoC reaches the centre, to the near field where the dilated near CoC at
    the sample does."""
    h, w = color.shape[:2]
    taps = _disk_kernel(kernel_size)
    max_coc = f32(s.max_coc_px)
    far_reach_img = torch.clamp(coc, min=0.0) * max_coc
    near_reach_img = near_coc * max_coc
    radius_px = torch.maximum(far_reach_img, near_reach_img)

    if use_pallas:
        packed = torch.cat([color, far_reach_img[..., None],
                            near_reach_img[..., None]], dim=-1)
        pad_h, pad_w = (-h) % warp.TILE_H, (-w) % warp.TILE_W
        packed = edge_pad(packed, pad_h, pad_w).contiguous()
    else:
        yg, xg = pixel_grid(h, w, color.device)
        xg, yg = xg + 0.5, yg + 0.5

    facc = color
    fwacc = torch.ones((h, w, 1), dtype=torch.float32, device=color.device)
    nacc = color
    nwacc = torch.ones_like(fwacc)
    for i in range(taps.shape[0]):
        tx, ty = taps[i]
        ox = float(tx) * radius_px
        oy = float(ty) * radius_px
        tap_r = float(np.sqrt(tx ** 2 + ty ** 2)) * radius_px
        if use_pallas:
            off = edge_pad(torch.stack([ox, oy], dim=-1), pad_h,
                           pad_w).contiguous()
            sampled = warp.warp_bilinear(packed, off, halo_r=16,
                                         halo_c=64)[:h, :w]
            c = sampled[..., :3]
            far_reach = sampled[..., 3]
            near_reach = sampled[..., 4]
        else:
            uv = torch.stack([(xg + ox) / w, (yg + oy) / h], dim=-1)
            c = bilinear_sample(color, uv)
            far_reach = bilinear_sample(far_reach_img[..., None], uv)[..., 0]
            near_reach = bilinear_sample(near_reach_img[..., None], uv)[..., 0]
        fw = torch.clamp((far_reach - tap_r) * 0.5 + 0.5, 0.0, 1.0)[..., None]
        nw = torch.clamp((near_reach - tap_r) * 0.5 + 0.5, 0.0,
                         1.0)[..., None]
        facc = facc + c * fw
        fwacc = fwacc + fw
        nacc = nacc + c * nw
        nwacc = nwacc + nw
    return facc / fwacc, nacc / nwacc


def bokeh_fill(img: Tensor, radius_px: Tensor, s: DoFSettings) -> Tensor:
    """Second bokeh pass (Bokeh2): a fixed small ring over the first pass's
    output fills undersampling gaps; per-pixel weights keep in-focus pixels
    sharp."""
    offsets = [(2, 0), (-2, 0), (0, 2), (0, -2), (1, 1), (-1, 1), (1, -1),
               (-1, -1)]
    amt = torch.clamp(radius_px / 4.0, 0.0, 1.0)[..., None]
    acc = img
    wacc = torch.ones_like(img[..., :1])
    for dy, dx in offsets:
        acc = acc + torch.roll(img, (dy, dx), dims=(0, 1)) * amt
        wacc = wacc + amt
    return acc / wacc


def tent_3x3(img: Tensor) -> Tensor:
    out = img
    for axis in (0, 1):
        out = (torch.roll(out, 1, dims=axis) * 0.25 + out * 0.5
               + torch.roll(out, -1, dims=axis) * 0.25)
    return out


def apply_dof(color: Tensor, depth: Tensor, camera: CameraAttribs,
              settings: DoFSettings = DoFSettings(),
              state: Optional[DoFState] = None,
              motion: Optional[Tensor] = None,
              use_temporal: bool = False,
              bokeh_kernel_size: int = 24,
              use_pallas: bool = False) -> Tuple[Tensor, DoFState]:
    """The DoF chain: CoC -> temporal CoC -> separated near/far -> near
    dilation -> CoC blur X/Y -> half-resolution prefilter -> bokeh (both
    fields) -> bokeh2 -> tent postfilter -> far-then-near combine.
    color (H, W, 3) with H and W even, depth (H, W) NDC."""
    h, w = depth.shape
    coc = circle_of_confusion(depth, camera, settings)

    if use_temporal and state is not None and motion is not None:
        yg, xg = pixel_grid(h, w, depth.device)
        prev_uv = torch.stack([(xg + 0.5) / w, (yg + 0.5) / h], -1) - motion
        hist = bilinear_sample(state.coc_history[..., None], prev_uv)[..., 0]
        coc = hist + (coc - hist) * float(
            np.float32(1.0) - np.float32(settings.temporal_stability_factor))

    # half-resolution prefilter
    c2 = 0.25 * (color[0::2, 0::2] + color[1::2, 0::2]
                 + color[0::2, 1::2] + color[1::2, 1::2])
    coc2 = coc[0::2, 0::2]
    # separated near CoC: dilate then blur X/Y
    near2 = blur_coc_xy(dilate_near_coc(coc2, radius=3))
    far_blur, near_blur = bokeh_blur_separated(
        c2, coc2, near2, settings, bokeh_kernel_size, use_pallas=use_pallas)
    max_coc = f32(settings.max_coc_px)
    far_blur = bokeh_fill(far_blur, torch.clamp(coc2, min=0.0) * max_coc,
                          settings)
    near_blur = bokeh_fill(near_blur, near2 * max_coc, settings)
    far_blur = tent_3x3(far_blur)
    near_blur = tent_3x3(near_blur)
    far_full = upsample_bilinear(far_blur, 2, 2)[:h, :w]
    near_full = upsample_bilinear(near_blur, 2, 2)[:h, :w]
    near_coc_full = upsample_bilinear(near2, 2, 2)[:h, :w]

    # combine: far field under, near field over (bleeds across sharp edges)
    far_blend = torch.clamp(torch.clamp(coc, min=0.0) * 2.0, 0.0,
                            1.0)[..., None]
    out = color + (far_full - color) * far_blend
    near_blend = torch.clamp(near_coc_full * 2.0, 0.0, 1.0)[..., None]
    out = out + (near_full - out) * near_blend
    return out, DoFState(coc_history=coc)
