"""Bounded-offset bilinear warp (the port of diligentfx_tpu/ops/warp_pallas.py
`warp_bilinear_pallas`), plain PyTorch on every device.

`warp_bilinear` samples every channel of an (H, W[, C]) image at
pixel + offset with the TPU kernel's clamp semantics: offsets clamp to
+-(halo - 1) px and taps stay inside a per-(8 x 128)-tile window whose
origin is clamped into the image and rounded down to the tile grid.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch


Tensor = torch.Tensor

TILE_H = 8
TILE_W = 128


@functools.lru_cache(maxsize=None)
def warp_geometry(h: int, w: int, halo_r: int, halo_c: int
                  ) -> Tuple[int, int, int, int, float, float]:
    """(halo_r, halo_c, win_h, win_w, cx, cy) after the small-image halo
    shrink (warp_pallas.py:117-135)."""
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"warp image {h}x{w} is not a multiple of "
                         f"{TILE_H}x{TILE_W}; pad it")
    if halo_c % 64 or halo_r % TILE_H:
        raise ValueError(f"halo ({halo_r}, {halo_c}) must be multiples of "
                         f"({TILE_H}, 64)")
    halo_r = min(halo_r, (h - TILE_H) // 2 // TILE_H * TILE_H)
    halo_c = min(halo_c, (w - TILE_W) // 2 // 64 * 64)
    win_h = TILE_H + 2 * halo_r
    win_w = TILE_W + 2 * halo_c
    if halo_c % TILE_W != 0 and win_w + TILE_W <= w:
        win_w += TILE_W
    win_w = min(win_w, w)
    cx = max(halo_c - 1.0, 0.0)
    cy = max(halo_r - 1.0, 0.0)
    return halo_r, halo_c, win_h, win_w, cx, cy


def warp_bilinear_plain(img: Tensor, offset_px: Tensor, *, halo_r: int = 16,
                        halo_c: int = 64) -> Tensor:
    """Plain PyTorch version of the warp kernel (same arithmetic order)."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    halo_r, halo_c, win_h, win_w, cx, cy = warp_geometry(h, w, halo_r, halo_c)
    dev = img.device
    y = torch.arange(h, device=dev)[:, None]
    x = torch.arange(w, device=dev)[None, :]
    y0 = (y // TILE_H) * TILE_H
    x0 = (x // TILE_W) * TILE_W
    ry = (torch.clamp(y0 - halo_r, 0, h - win_h) // TILE_H) * TILE_H
    rx = (torch.clamp(x0 - halo_c, 0, w - win_w) // TILE_W) * TILE_W
    ox = torch.clamp(offset_px[..., 0], -cx, cx)
    oy = torch.clamp(offset_px[..., 1], -cy, cy)
    sy = ((y - y0).float() + (y0 - ry).float()) + oy
    sx = ((x - x0).float() + (x0 - rx).float()) + ox
    sy = torch.clamp(sy, 0.0, win_h - 1.0)
    sx = torch.clamp(sx, 0.0, win_w - 1.0)
    yf = torch.floor(sy)
    xf = torch.floor(sx)
    fy = (sy - yf)[..., None]
    fx = (sx - xf)[..., None]
    yi = yf.long()
    xi = xf.long()
    xi1 = torch.clamp(xi + 1, max=win_w - 1)
    has1 = (yi + 1 < win_h)[..., None]
    yi1 = torch.clamp(yi + 1, max=win_h - 1)
    r0, r1 = ry + yi, ry + yi1
    c0, c1 = rx + xi, rx + xi1
    h0 = img[r0, c0] + (img[r0, c1] - img[r0, c0]) * fx
    h1 = img[r1, c0] + (img[r1, c1] - img[r1, c0]) * fx
    a = h0 * (1.0 - fy)
    out = torch.where(has1, a + h1 * fy, a)
    return out[..., 0] if squeeze else out


# dfx_warp_bilinear / dfx_warp_bilinear_multi(img, offset, out, params,
#                                             device, stream)


# The address bits the kernels' loads need clear: K2 loads a texel of C = 2
# or 4 floats as one float2 / float4 (C -> mask; a float otherwise), K6
# bulk-copies window rows from 16-byte aligned addresses, and both load an
# offset as one float2.


def warp_bilinear(img: Tensor, offset_px: Tensor, *, halo_r: int = 16,
                  halo_c: int = 64) -> Tensor:
    """Bilinear resample `img` ((H, W) or (H, W, C) f32, H % 8 == 0,
    W % 128 == 0) at pixel + offset_px ((H, W, 2) = (dx, dy) in pixels).

    Runs the plain version on any device."""
    return warp_bilinear_plain(img, offset_px, halo_r=halo_r, halo_c=halo_c)
