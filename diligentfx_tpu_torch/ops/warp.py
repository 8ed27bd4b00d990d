"""Bounded-offset bilinear warp (the port of diligentfx_tpu/ops/warp_pallas.py
`warp_bilinear_pallas` and `warp_bilinear_multi_pallas`).

`warp_bilinear` samples every channel of an (H, W[, C]) image at
pixel + offset with the TPU kernel's clamp semantics: offsets clamp to
+-(halo - 1) px and taps stay inside a per-(8 x 128)-tile window whose
origin is clamped into the image and rounded down to the tile grid.  On a
CUDA tensor it launches the hand-written kernel csrc/warp.cu; on a CPU
tensor it runs `warp_bilinear_plain`, the same function in PyTorch.

`warp_bilinear_multi` takes K offset fields of one (H, W) image in one
launch (csrc/warp_multi.cu: one block a tile, whose window in shared
memory serves all K taps); each tap equals `warp_bilinear` of its offsets
bit for bit.

Both wrappers keep their host cost small, since most of the frames'
launches are small: the launch parameters of a shape are one cached
ctypes struct, the launcher is bound once, and the C launcher takes the
tensor's device index and PyTorch's current raw stream and switches
devices only where the index is not the current one.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from diligentfx_tpu_torch.ops import cuda_build

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


class _WarpParams(ctypes.Structure):
    """csrc/warp.cu `Geo`: the image's shape and the warp geometry."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "h", "w", "c", "halo_r", "halo_c", "win_h", "win_w")] + [
        ("cx", ctypes.c_float), ("cy", ctypes.c_float)]


@functools.lru_cache(maxsize=None)
def _warp_params(h: int, w: int, c: int, halo_r: int, halo_c: int
                 ) -> Tuple[_WarpParams, int]:
    """K2's launch parameters for one shape, and their address (the cache
    keeps the struct alive)."""
    p = _WarpParams(h, w, c, *warp_geometry(h, w, halo_r, halo_c))
    return p, ctypes.addressof(p)


# dfx_warp_bilinear / dfx_warp_bilinear_multi(img, offset, out, params,
#                                             device, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _launcher(name: str, symbol: str):
    """csrc/<name>.cu's launcher, built, loaded and bound once."""
    return cuda_build.bind(name, symbol, _ARGTYPES)


def _current_stream(device: int) -> int:
    return torch._C._cuda_getCurrentRawStream(device)


# The address bits the kernels' loads need clear: K2 loads a texel of C = 2
# or 4 floats as one float2 / float4 (C -> mask; a float otherwise), K6
# bulk-copies window rows from 16-byte aligned addresses, and both load an
# offset as one float2.
_IMAGE_ALIGN = {2: 7, 4: 15}
_OFFSET_ALIGN = 7
_MULTI_IMAGE_ALIGN = 15


def _pointers(img: Tensor, offset: Tensor, out: Tensor, img_align: int
              ) -> Tuple[int, int, int]:
    """The three data pointers, the image's and the offsets' checked
    against the kernel's vector loads."""
    pi, po = img.data_ptr(), offset.data_ptr()
    if pi & img_align or po & _OFFSET_ALIGN:
        raise ValueError(f"the warp kernel takes an image aligned to "
                         f"{img_align + 1} bytes and offsets to "
                         f"{_OFFSET_ALIGN + 1}")
    return pi, po, out.data_ptr()


def _launch(img: Tensor, offset_px: Tensor, halo_r: int, halo_c: int) -> Tensor:
    shape = img.shape
    if len(shape) == 2:
        (h, w), c = shape, 1
    elif len(shape) == 3:
        h, w, c = shape
    else:
        raise ValueError(f"warp image shape {tuple(shape)} is not (H, W[, C])")
    if img.dtype != torch.float32 or offset_px.dtype != torch.float32:
        raise TypeError("warp_bilinear takes float32 tensors")
    if offset_px.shape != (h, w, 2):
        raise ValueError(f"offset shape {tuple(offset_px.shape)} != {(h, w, 2)}")
    device = img.get_device()
    if offset_px.get_device() != device:
        raise ValueError("img and offset_px must be on the same device")
    if not (img.is_contiguous() and offset_px.is_contiguous()):
        raise ValueError("warp_bilinear takes contiguous tensors")
    params = _warp_params(h, w, c, halo_r, halo_c)[1]
    out = torch.empty_like(img)
    err = _launcher("warp", "dfx_warp_bilinear")(
        *_pointers(img, offset_px, out, _IMAGE_ALIGN.get(c, 3)), params,
        device, _current_stream(device))
    cuda_build.check(err, "warp kernel launch")
    warp_bilinear.launches += 1
    return out


def warp_bilinear(img: Tensor, offset_px: Tensor, *, halo_r: int = 16,
                  halo_c: int = 64) -> Tensor:
    """Bilinear resample `img` ((H, W) or (H, W, C) f32, H % 8 == 0,
    W % 128 == 0) at pixel + offset_px ((H, W, 2) = (dx, dy) in pixels).

    A CUDA tensor goes to the kernel (or this raises); a CPU tensor runs
    the plain version.  `warp_bilinear.launches` counts kernel launches."""
    if img.is_cuda:
        return _launch(img, offset_px, halo_r, halo_c)
    if img.device.type != "cpu":
        raise ValueError(f"warp_bilinear: unsupported device {img.device}")
    return warp_bilinear_plain(img, offset_px, halo_r=halo_r, halo_c=halo_c)


warp_bilinear.launches = 0


# the shared memory one block may use on sm_90 (227 KB)
MAX_WINDOW_BYTES = 232448


def warp_bilinear_multi_plain(img: Tensor, offsets_px: Tensor, *,
                              halo_r: int = 16, halo_c: int = 64) -> Tensor:
    """Plain PyTorch version of the multi-tap kernel: K single-tap warps."""
    if img.dim() != 2:
        raise ValueError("warp_bilinear_multi takes an (H, W) image")
    taps = [warp_bilinear_plain(img, offsets_px[k], halo_r=halo_r,
                                halo_c=halo_c)
            for k in range(offsets_px.shape[0])]
    return torch.stack(taps) if taps else img.new_empty((0,) + img.shape)


_BARRIER_BYTES = 8                  # K6's mbarrier after the window


class _MultiParams(ctypes.Structure):
    """csrc/warp_multi.cu `Geo`: shape, warp geometry, shared memory."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "h", "w", "k", "halo_r", "halo_c", "win_h", "win_w")] + [
        ("cx", ctypes.c_float), ("cy", ctypes.c_float), ("smem", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _multi_params(h: int, w: int, k: int, halo_r: int, halo_c: int
                  ) -> Tuple[_MultiParams, int]:
    """K6's launch parameters for one shape, and their address.  Raises
    where the window does not fit in a block's shared memory."""
    geo = warp_geometry(h, w, halo_r, halo_c)
    win_h, win_w = geo[2:4]
    if 4 * win_h * win_w > MAX_WINDOW_BYTES:
        raise ValueError(f"warp window {win_h}x{win_w} needs "
                         f"{4 * win_h * win_w} B of shared memory, over "
                         f"{MAX_WINDOW_BYTES}")
    p = _MultiParams(h, w, k, *geo, 4 * win_h * win_w + _BARRIER_BYTES)
    return p, ctypes.addressof(p)


def _launch_multi(img: Tensor, offsets_px: Tensor, halo_r: int,
                  halo_c: int) -> Tensor:
    shape = img.shape
    if len(shape) != 2:
        raise ValueError("warp_bilinear_multi takes an (H, W) image")
    h, w = shape
    if img.dtype != torch.float32 or offsets_px.dtype != torch.float32:
        raise TypeError("warp_bilinear_multi takes float32 tensors")
    oshape = offsets_px.shape
    if len(oshape) != 4 or oshape[1:] != (h, w, 2):
        raise ValueError(f"offsets shape {tuple(oshape)} is not "
                         f"(K, {h}, {w}, 2)")
    device = img.get_device()
    if offsets_px.get_device() != device:
        raise ValueError("img and offsets_px must be on the same device")
    if not (img.is_contiguous() and offsets_px.is_contiguous()):
        raise ValueError("warp_bilinear_multi takes contiguous tensors")
    k = oshape[0]
    params = _multi_params(h, w, k, halo_r, halo_c)[1]
    out = img.new_empty((k, h, w))
    if k == 0:
        return out
    err = _launcher("warp_multi", "dfx_warp_bilinear_multi")(
        *_pointers(img, offsets_px, out, _MULTI_IMAGE_ALIGN), params, device,
        _current_stream(device))
    cuda_build.check(err, "warp_multi kernel launch")
    warp_bilinear_multi.launches += 1
    return out


def warp_bilinear_multi(img: Tensor, offsets_px: Tensor, *, halo_r: int = 16,
                        halo_c: int = 64) -> Tensor:
    """K bilinear taps of one (H, W) f32 image (H % 8 == 0, W % 128 == 0)
    at pixel + offsets_px[k] ((K, H, W, 2) = (dx, dy) in pixels) -> (K, H,
    W), with the single-tap warp's clamps.

    A CUDA tensor goes to the kernel (or this raises, also where a tile's
    window does not fit in one block's shared memory); a CPU tensor runs
    the plain version.  `warp_bilinear_multi.launches` counts launches."""
    if img.is_cuda:
        return _launch_multi(img, offsets_px, halo_r, halo_c)
    if img.device.type != "cpu":
        raise ValueError(f"warp_bilinear_multi: unsupported device "
                         f"{img.device}")
    return warp_bilinear_multi_plain(img, offsets_px, halo_r=halo_r,
                                     halo_c=halo_c)


warp_bilinear_multi.launches = 0
