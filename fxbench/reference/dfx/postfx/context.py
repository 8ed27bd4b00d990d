"""PostFX shared per-frame services (the port of
diligentfx_tpu/postfx/context.py): analytic noise, TAA jitter, depth
utilities, motion dilation and the history-disocclusion mask, whose
previous-depth tap is the warp kernel's first caller.

The row-band forms (`BandCtx`; `row0` / `full_h` of the pixel grids) let
the same effects run on one row band of a frame
(parallel/tiling.py render_frame_banded): noise and positions are keyed
on global rows, so a band evaluates the whole frame's values.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from fxbench.reference.dfx import math3d as m3
from fxbench.reference.dfx.attribs import CameraAttribs
from fxbench.reference.dfx.ops.sampling import bilinear_sample

Tensor = torch.Tensor


class BandCtx(NamedTuple):
    """Row-band context of the screen-space effects (JAX context.py:29):
    the band holds global rows [y0, y0 + h) of a full_h-row frame.

    extend(x, halo, wrap): x (one of the band's tensors, rows first) with
    `halo` rows of the neighbouring bands above and below.  wrap=True is
    the ring (band 0's top halo is the last band's bottom rows), so
    halo'd 3x3 windows equal the whole frame's torch.roll windows;
    wrap=False clamps to the frame's edge rows, bilinear_sample's clamp
    for the history warps."""
    extend: Callable[..., torch.Tensor]
    y0: int
    full_h: int
    halo: int = 16


class PostFXResources(NamedTuple):
    """Per-frame shared products handed to every effect."""
    camera: CameraAttribs
    prev_camera: CameraAttribs
    depth: Tensor               # (H, W) NDC depth
    prev_depth: Tensor          # (H, W)
    motion: Tensor              # (H, W, 2) uv motion (cur - prev)
    closest_motion: Tensor      # (H, W, 2) 3x3 closest-depth motion
    frame_index: int


def pixel_grid(h: int, w: int, device, row0: int = 0):
    """(y, x) float32 pixel indices of an (h, w) grid whose first row is
    row `row0` of the frame."""
    y = torch.arange(h, dtype=torch.float32, device=device)
    if row0:
        y = y + float(row0)
    y = y[:, None].expand(h, w)
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return y, x


def interleaved_gradient_noise(height: int, width: int, frame_index: int,
                               device=None, row0: int = 0) -> Tensor:
    """Jimenez interleaved gradient noise, temporally scrambled; keyed on
    global rows (row0: the frame row of local row 0), so a band evaluates
    the whole frame's pattern."""
    y, x = pixel_grid(height, width, device, row0)
    f = float(frame_index % 64)
    x = x + 5.588238 * f
    y = y + 5.588238 * f
    return torch.remainder(
        52.9829189 * torch.remainder(0.06711056 * x + 0.00583715 * y, 1.0),
        1.0)


def r2_noise_pair(height: int, width: int, frame_index: int,
                  device=None) -> Tensor:
    """(H, W, 2) R2-sequence pair per pixel."""
    y, x = pixel_grid(height, width, device)
    n = y * width + x + float(frame_index) * (width * height)
    g = 1.32471795724474602596
    a1, a2 = 1.0 / g, 1.0 / (g * g)
    return torch.stack([torch.remainder(0.5 + a1 * n, 1.0),
                        torch.remainder(0.5 + a2 * n, 1.0)], dim=-1)


def depth_to_camera_z(depth: Tensor, camera: CameraAttribs,
                      reversed_z: bool = False) -> Tensor:
    """NDC depth -> positive view-space distance."""
    n, f = camera.near_z, camera.far_z
    d = 1.0 - depth if reversed_z else depth
    return n * f / torch.clamp(f - d * (f - n), min=1e-12)


def _ndc_grid(h: int, w: int, full_h: int, device, row0: int = 0):
    y, x = pixel_grid(h, w, device, row0)
    x = (x + 0.5) / w * 2.0 - 1.0
    y = 1.0 - (y + 0.5) / (full_h or h) * 2.0
    return x, y


def reconstruct_world_pos(depth: Tensor, camera: CameraAttribs,
                          row0: int = 0, full_h: int = 0) -> Tensor:
    """Per-pixel world position from NDC depth through view_proj_inv (the
    exact inverse of the rasterization transform, jitter included); the
    local rows are rows [row0, row0 + h) of a full_h-row frame."""
    h, w = depth.shape
    x, y = _ndc_grid(h, w, full_h, depth.device, row0)
    ndc = torch.stack([x, y, depth, torch.ones_like(depth)], dim=-1)
    world = m3.vec_mat4(ndc, camera.view_proj_inv)
    return world[..., :3] / world[..., 3:4]


def compute_camera_motion(depth: Tensor, camera: CameraAttribs,
                          prev_camera: CameraAttribs) -> Tensor:
    """Static-geometry motion vectors in uv units (cur_uv - prev_uv)."""
    h, w = depth.shape
    world = reconstruct_world_pos(depth, camera)
    prev_clip = m3.transform_points(world, prev_camera.view_proj)
    pw = prev_clip[..., 3:4]
    prev_ndc = prev_clip[..., :2] / torch.where(torch.abs(pw) < 1e-9,
                                                torch.full_like(pw, 1e-9), pw)
    y, x = pixel_grid(h, w, depth.device)
    cur_uv = torch.stack([(x + 0.5) / w, (y + 0.5) / h], dim=-1)
    prev_uv = torch.stack([prev_ndc[..., 0] * 0.5 + 0.5,
                           0.5 - prev_ndc[..., 1] * 0.5], dim=-1)
    return cur_uv - prev_uv


def dilate_closest_motion(depth: Tensor, motion: Tensor,
                          reversed_z: bool = False) -> Tensor:
    """3x3 closest-depth motion dilation (wrap-around shifts, as the JAX
    package's jnp.roll)."""
    best_d, best_m = depth, motion
    sign = -1.0 if reversed_z else 1.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            d = torch.roll(depth, (-dy, -dx), dims=(0, 1))
            mv = torch.roll(motion, (-dy, -dx), dims=(0, 1))
            take = sign * d < sign * best_d
            best_d = torch.where(take, d, best_d)
            best_m = torch.where(take[..., None], mv, best_m)
    return best_m


def prepare_postfx_resources(depth: Tensor, camera: CameraAttribs,
                             prev_camera: CameraAttribs,
                             prev_depth: Optional[Tensor], frame_index: int,
                             object_motion: Optional[Tensor] = None,
                             reversed_z: bool = False) -> PostFXResources:
    """PostFXContext::PrepareResources + Execute analogue (JAX
    context.py:174).  With object_motion given (the G-buffer's motion) the
    camera-only motion is never needed, so it is not computed."""
    motion = (object_motion if object_motion is not None
              else compute_camera_motion(depth, camera, prev_camera))
    return PostFXResources(
        camera=camera, prev_camera=prev_camera, depth=depth,
        prev_depth=prev_depth if prev_depth is not None else depth,
        motion=motion,
        closest_motion=dilate_closest_motion(depth, motion, reversed_z),
        frame_index=int(frame_index))


# ---------------------------------------------------------------------------
# TAA jitter sequence
# ---------------------------------------------------------------------------


def halton(index: int, base: int) -> float:
    f, r, i = 1.0, 0.0, index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def taa_jitter_sequence(length: int = 16, device=None) -> Tensor:
    """(N, 2) Halton(2,3) jitter in [-0.5, 0.5] pixel units."""
    pts = [(halton(i + 1, 2) - 0.5, halton(i + 1, 3) - 0.5)
           for i in range(length)]
    return torch.tensor(pts, dtype=torch.float32, device=device)


def jitter_to_ndc(jitter_px: Tensor, width: int, height: int) -> Tensor:
    """Pixel-unit jitter -> NDC offset added to the projection."""
    return torch.stack([2.0 * jitter_px[0] / width,
                        -2.0 * jitter_px[1] / height])


def apply_jitter_to_proj(proj: Tensor, jitter_ndc: Tensor) -> Tensor:
    """Offset the projection so post-divide NDC shifts by `jitter_ndc`
    (row-vector, w_clip = -z_view: row 2 of columns 0/1 gets -j)."""
    out = proj.clone()
    out[2, 0] = out[2, 0] - jitter_ndc[0]
    out[2, 1] = out[2, 1] - jitter_ndc[1]
    return out


def reprojected_depth(depth: Tensor, camera: CameraAttribs,
                      prev_view_proj: Tensor, row0: int = 0,
                      full_h: int = 0) -> Tensor:
    """The NDC depth each current surface point had in the previous frame
    (row0 / full_h: the band's rows of the frame)."""
    h, w = depth.shape
    x, y = _ndc_grid(h, w, full_h, depth.device, row0)
    ndc = torch.stack([x, y, depth, torch.ones_like(depth)], dim=-1)
    world = m3.vec_mat4(ndc, camera.view_proj_inv)
    ww = world[..., 3:4]
    world = world / torch.where(torch.abs(ww) < 1e-12,
                                torch.full_like(ww, 1e-12), ww)
    prev_clip = m3.vec_mat4(world, prev_view_proj)
    return prev_clip[..., 2] / torch.clamp(prev_clip[..., 3], min=1e-6)


def edge_pad(x: Tensor, pad_h: int, pad_w: int) -> Tensor:
    """Pad the two leading dims at the bottom/right by edge replication."""
    if not pad_h and not pad_w:
        return x
    h, w = x.shape[0], x.shape[1]
    ys = torch.clamp(torch.arange(h + pad_h, device=x.device), max=h - 1)
    xs = torch.clamp(torch.arange(w + pad_w, device=x.device), max=w - 1)
    return x[ys][:, xs]


def disocclusion_mask(depth: Tensor, prev_depth: Tensor, motion: Tensor,
                      camera: CameraAttribs, prev_view_proj: Tensor, *,
                      relative_tolerance: float = 0.05,
                      use_pallas: bool = False,
                      band: Optional[BandCtx] = None) -> Tensor:
    """True where the history tap at (uv - motion) does not see the same
    surface: the previous depth buffer, sampled at the reprojected
    location, disagrees with the depth this surface should have had there
    (JAX context.py:251).  use_pallas routes the previous-depth tap through
    the bounded warp kernel (ops/warp.py), as the TPU path does.

    band: the band's rows of the frame; prev_depth is the band's slice,
    tapped bilinearly on halo-extended rows with the vertical motion
    clamped to the halo (use_pallas does not apply, as in the JAX
    package)."""
    h, w = depth.shape
    if band is not None:
        return _disocclusion_band(depth, prev_depth, motion, camera,
                                  prev_view_proj, relative_tolerance, band)
    zexp = reprojected_depth(depth, camera, prev_view_proj)
    y, x = pixel_grid(h, w, depth.device)
    prev_uv = torch.stack([(x + 0.5) / w, (y + 0.5) / h], dim=-1) - motion
    if use_pallas:
        from fxbench.reference.dfx.ops.warp import (TILE_H, TILE_W,
                                                   warp_bilinear)
        pad_h, pad_w = (-h) % TILE_H, (-w) % TILE_W
        dpad = edge_pad(prev_depth, pad_h, pad_w)
        off = -motion * torch.tensor([w, h], dtype=torch.float32,
                                     device=depth.device)
        off = edge_pad(off, pad_h, pad_w).contiguous()
        zprev = warp_bilinear(dpad.contiguous(), off, halo_r=16,
                              halo_c=64)[:h, :w]
    else:
        zprev = bilinear_sample(prev_depth[..., None], prev_uv)[..., 0]
    le = depth_to_camera_z(zexp, camera)
    lp = depth_to_camera_z(zprev, camera)
    mismatch = torch.abs(le - lp) > relative_tolerance * torch.minimum(le, lp)
    oob = ((prev_uv[..., 0] < 0) | (prev_uv[..., 0] > 1)
           | (prev_uv[..., 1] < 0) | (prev_uv[..., 1] > 1))
    return mismatch | oob


def _disocclusion_band(depth: Tensor, prev_depth: Tensor, motion: Tensor,
                       camera: CameraAttribs, prev_view_proj: Tensor,
                       relative_tolerance: float, band: BandCtx) -> Tensor:
    """disocclusion_mask on a row band (JAX context.py:266-281)."""
    h, w = depth.shape
    fh, halo, y0 = band.full_h, band.halo, float(band.y0)
    zexp = reprojected_depth(depth, camera, prev_view_proj, row0=band.y0,
                             full_h=fh)
    ext = band.extend(prev_depth, halo, wrap=False)
    yg, x = pixel_grid(h, w, depth.device, band.y0)
    x = (x + 0.5) / w
    yg = yg + 0.5
    my = torch.clamp(motion[..., 1] * fh, -(halo - 1.0), halo - 1.0)
    prev_uv = torch.stack([x - motion[..., 0], (yg - my) / fh], dim=-1)
    # tap the extended band at the band-local row
    ext_uv = torch.stack([prev_uv[..., 0],
                          (yg - my - y0 + halo) / (h + 2.0 * halo)], dim=-1)
    zprev = bilinear_sample(ext[..., None], ext_uv)[..., 0]
    le = depth_to_camera_z(zexp, camera)
    lp = depth_to_camera_z(zprev, camera)
    mismatch = torch.abs(le - lp) > relative_tolerance * torch.minimum(le, lp)
    oob = ((prev_uv[..., 0] < 0) | (prev_uv[..., 0] > 1)
           | (prev_uv[..., 1] < 0) | (prev_uv[..., 1] > 1))
    return mismatch | oob
