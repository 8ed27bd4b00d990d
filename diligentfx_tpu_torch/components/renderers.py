"""Small rendering components (the port of diligentfx_tpu/components/
renderers.py), image-space passes over a finished frame:

  * render_env_map: the environment as a full-screen ray pass
    (EnvMapRenderer), with an optional tone map and sRGB;
  * render_bound_box: the 12 dashed, depth-tested edges of a box
    (BoundBoxRenderer);
  * render_coordinate_grid: the ground grid and axes by per-pixel ray /
    plane intersection (CoordinateGridRenderer);
  * render_vector_field: a grid of motion-vector segments
    (VectorFieldRenderer).  The JAX package draws its up to 32 x 32
    segments one after the other over the whole frame, a later segment
    over an earlier one; `render_vector_field` visits only the pixels
    near each segment and keeps each pixel's last segment, with the same
    per-pixel arithmetic, so it equals the sequential form
    (`render_vector_field_plain`) bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import CameraAttribs
from diligentfx_tpu_torch.config import ToneMappingMode
from diligentfx_tpu_torch.ops.sampling import sample_env_oct
from diligentfx_tpu_torch.pbr.renderer import _camera_rays
from diligentfx_tpu_torch.postfx.tonemap import ToneMappingAttribs, tone_map

Tensor = torch.Tensor


def _f32(x, device) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _pixel_centres(h: int, w: int, device):
    """(xg, yg): each pixel's centre, (H, W) each."""
    yg, xg = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device) + 0.5,
        torch.arange(w, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")
    return xg, yg


def render_env_map(env_oct_mips, camera: CameraAttribs, width: int,
                   height: int, *, mip_level: float = 0.0, scale: float = 1.0,
                   tone_mapping_mode: ToneMappingMode = ToneMappingMode.NONE,
                   convert_to_srgb: bool = False,
                   ave_log_lum: float = 0.3) -> Tensor:
    """Full-screen environment pass (EnvMapRenderer::Render; JAX
    renderers.py:35): (height, width, 3)."""
    ray = _camera_rays(camera, width, height)
    mips = (list(env_oct_mips) if isinstance(env_oct_mips, (list, tuple))
            else [env_oct_mips])
    color = sample_env_oct(mips, ray, torch.full(ray.shape[:-1], mip_level,
                                                 device=ray.device)) * scale
    if tone_mapping_mode != ToneMappingMode.NONE:
        color = tone_map(color, tone_mapping_mode, ToneMappingAttribs(),
                         ave_log_lum=ave_log_lum)
    if convert_to_srgb:
        color = m3.linear_to_srgb(color)
    return color


class BoundBoxAttribs(NamedTuple):
    """BoundBoxRenderer::RenderAttribs."""
    color: tuple = (1.0, 0.75, 0.0, 1.0)
    pattern_length: float = 16.0      # the dash pattern's period in pixels
    pattern_mask: int = 0xFFFFFFFF


BOX_EDGES = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
             (0, 4), (1, 5), (2, 6), (3, 7))


def render_bound_box(color_buf: Tensor, depth_buf: Tensor,
                     camera: CameraAttribs, box_min, box_max,
                     transform: Optional[Tensor] = None,
                     attribs: BoundBoxAttribs = BoundBoxAttribs(),
                     thickness: float = 1.0) -> Tensor:
    """The box's 12 edges as screen-space segments over the frame (JAX
    renderers.py:68): a pixel within `thickness` px of an edge, on a dash
    (the first 3/4 of each pattern period along the edge) and not behind
    the scene's depth takes the box colour."""
    h, w = depth_buf.shape
    dev = depth_buf.device
    mn, mx = _f32(box_min, dev), _f32(box_max, dev)
    corners = torch.stack([torch.stack([mx[0] if i & 1 else mn[0],
                                        mx[1] if i & 2 else mn[1],
                                        mx[2] if i & 4 else mn[2]])
                           for i in range(8)])
    if transform is not None:
        corners = m3.transform_points(corners, transform)[..., :3]
    clip = m3.transform_points(corners, camera.view_proj)
    ndc = clip[:, :3] / torch.clamp(clip[:, 3:4], min=1e-6)
    sx = (ndc[:, 0] * 0.5 + 0.5) * w
    sy = (0.5 - ndc[:, 1] * 0.5) * h
    sz = ndc[:, 2]
    behind = clip[:, 3] < 1e-5
    xg, yg = _pixel_centres(h, w, dev)
    box_color = _f32(attribs.color[:3], dev)
    out = color_buf
    for a, b in BOX_EDGES:
        ax, ay, az = sx[a], sy[a], sz[a]
        dx, dy = sx[b] - ax, sy[b] - ay
        len2 = torch.clamp(dx * dx + dy * dy, min=1e-6)
        t = torch.clamp(((xg - ax) * dx + (yg - ay) * dy) / len2, 0.0, 1.0)
        ex, ey = xg - (ax + t * dx), yg - (ay + t * dy)
        on_line = ex * ex + ey * ey < thickness * thickness
        z = az + t * (sz[b] - az)
        visible = (z <= depth_buf + 1e-3) & ~(behind[a] | behind[b])
        dash = torch.remainder(t * torch.sqrt(len2) / attribs.pattern_length,
                               1.0) < 0.75
        out = torch.where((on_line & visible & dash)[..., None], box_color,
                          out)
    return out


class CoordinateGridAttribs(NamedTuple):
    """CoordinateGridRenderer::Attribs."""
    grid_scale: float = 1.0
    grid_subdivision: float = 10.0
    thickness_px: float = 1.0
    color_x_axis: tuple = (1.0, 0.3, 0.3)
    color_z_axis: tuple = (0.3, 0.3, 1.0)
    color_grid: tuple = (0.5, 0.5, 0.5)


def render_coordinate_grid(color_buf: Tensor, depth_buf: Tensor,
                           camera: CameraAttribs,
                           attribs: CoordinateGridAttribs =
                           CoordinateGridAttribs()) -> Tensor:
    """The XZ ground grid by per-pixel ray / plane intersection (JAX
    renderers.py:131): fine and coarse lines and the two axes, their width
    one pixel's world footprint, faded with distance and blended where the
    plane lies in front of the scene's depth.  Rays that miss the plane
    keep their colour (the JAX package's turn NaN just above the
    horizon)."""
    h, w = depth_buf.shape
    dev = depth_buf.device
    ray = _camera_rays(camera, w, h)
    eye = camera.position
    ry = ray[..., 1]
    t = -eye[1] / torch.where(torch.abs(ry) < 1e-6, _f32(1e-6, dev), ry)
    hit_plane = t > 0
    p = eye + ray * t[..., None]
    # one pixel's footprint in world units at the hit
    foot = torch.clamp(t * 2.0 / (h * torch.abs(camera.proj[1, 1])),
                       min=1e-6)

    def line_mask(coord, period):
        q = coord / period
        f = torch.abs(q - torch.round(q)) * period
        return torch.clamp(1.0 - f / (foot * attribs.thickness_px), 0.0, 1.0)

    cell = attribs.grid_scale
    coarse_cell = cell * attribs.grid_subdivision
    fine = torch.maximum(line_mask(p[..., 0], cell),
                         line_mask(p[..., 2], cell)) * 0.4
    coarse = torch.maximum(line_mask(p[..., 0], coarse_cell),
                           line_mask(p[..., 2], coarse_cell)) * 0.8
    axis_x = line_mask(p[..., 2], 1e30)      # z = 0: the x axis
    axis_z = line_mask(p[..., 0], 1e30)
    clip = m3.transform_points(p, camera.view_proj)
    gz = clip[..., 2] / torch.clamp(clip[..., 3], min=1e-6)
    visible = hit_plane & (gz <= depth_buf)
    # the distance fade where the ray meets the plane: the JAX package
    # takes exp(-t * 0.02) everywhere, which overflows to inf for rays just
    # above the horizon (t < -4435 m) and then makes inf * 0 = NaN of the
    # pixels its visibility masks out; elsewhere the two agree
    fade = torch.where(hit_plane, torch.exp(-t * 0.02), _f32(0.0, dev))
    color = torch.where(
        axis_x[..., None] > 0.5, _f32(attribs.color_x_axis, dev),
        torch.where(axis_z[..., None] > 0.5, _f32(attribs.color_z_axis, dev),
                    _f32(attribs.color_grid, dev)))
    alpha = (torch.maximum(torch.maximum(fine, coarse),
                           torch.maximum(axis_x, axis_z)) * fade
             * visible.to(torch.float32))[..., None]
    return color_buf + (color - color_buf) * alpha


class VectorFieldAttribs(NamedTuple):
    """VectorFieldRenderer::RenderAttribs."""
    grid_size: int = 32            # segments per axis
    scale: float = 20.0
    start_color: tuple = (1.0, 0.0, 0.0)
    end_color: tuple = (1.0, 1.0, 0.0)


def vector_field_segments(field: Tensor, h: int, w: int,
                          attribs: VectorFieldAttribs = VectorFieldAttribs()
                          ) -> Tensor:
    """The segments (S, 4) = (ax, ay, bx, by) in pixels, row-major over an
    n x n grid of anchors (n = grid_size, but at least 8 px apart): each
    from its anchor along the field's motion there (JAX
    renderers.py:200-206)."""
    n = min(attribs.grid_size, max(h // 8, 1), max(w // 8, 1))
    k = torch.arange(n, device=field.device) + 0.5
    gy, gx = torch.meshgrid(k / n * h, k / n * w, indexing="ij")
    mv = field[gy.to(torch.int64), gx.to(torch.int64)]
    ex = gx + mv[..., 0] * w * attribs.scale / 20.0
    ey = gy + mv[..., 1] * h * attribs.scale / 20.0
    return torch.stack([gx.reshape(-1), gy.reshape(-1), ex.reshape(-1),
                        ey.reshape(-1)], dim=-1)


def _segment_t_d2(xg, yg, ax, ay, bx, by):
    """The segment parameter t of the point nearest (xg, yg) and the
    squared distance to it, elementwise (JAX renderers.py:213-218)."""
    dx, dy = bx - ax, by - ay
    len2 = torch.clamp(dx * dx + dy * dy, min=1e-6)
    t = torch.clamp(((xg - ax) * dx + (yg - ay) * dy) / len2, 0.0, 1.0)
    ex, ey = xg - (ax + t * dx), yg - (ay + t * dy)
    return t, ex * ex + ey * ey


def _segment_color(t, attribs: VectorFieldAttribs, device):
    c0 = _f32(attribs.start_color, device)
    c1 = _f32(attribs.end_color, device)
    return c0 + (c1 - c0) * t[..., None]


def render_vector_field_plain(color_buf: Tensor, field: Tensor,
                              attribs: VectorFieldAttribs =
                              VectorFieldAttribs()) -> Tensor:
    """The sequential form of render_vector_field, as the JAX package's
    scan draws it (renderers.py:192): each segment over the whole frame in
    turn, a pixel within 1 px of it taking its start-to-end colour at the
    nearest point."""
    h, w = color_buf.shape[:2]
    dev = color_buf.device
    segs = vector_field_segments(field, h, w, attribs)
    xg, yg = _pixel_centres(h, w, dev)
    out = color_buf
    for s in range(segs.shape[0]):
        ax, ay, bx, by = segs[s]
        t, d2 = _segment_t_d2(xg, yg, ax, ay, bx, by)
        out = torch.where((d2 < 1.0)[..., None],
                          _segment_color(t, attribs, dev), out)
    return out


# The candidate pixels of a segment: along its major axis every pixel
# whose centre lies within MAJOR_PAD px of the segment's extent, across it
# the 2 * MINOR_HALF + 1 pixels around the line there.  A pixel within
# 1 px of the segment lies within 2 px of the line along the minor axis
# (the slope is at most 1), so both windows keep a margin of over 1 px
# beyond the float32 rounding of the same test.
MAJOR_PAD = 2.0
MINOR_HALF = 4


def render_vector_field(color_buf: Tensor, field: Tensor,
                        attribs: VectorFieldAttribs = VectorFieldAttribs()
                        ) -> Tensor:
    """The motion-vector overlay (the HnPostProcessTask debug field,
    cpp:928-943; JAX renderers.py:192), bit-equal to
    render_vector_field_plain: the (segment, pixel) pairs near each
    segment get the sequential form's test and colour arithmetic, and each
    pixel keeps its highest passing segment, the one the sequence draws
    last."""
    h, w = color_buf.shape[:2]
    dev = color_buf.device
    segs = vector_field_segments(field, h, w, attribs)
    ax, ay, bx, by = segs.unbind(-1)
    x_major = torch.abs(bx - ax) >= torch.abs(by - ay)
    a_maj = torch.where(x_major, ax, ay)
    b_maj = torch.where(x_major, bx, by)
    a_min = torch.where(x_major, ay, ax)
    d_maj, d_min = b_maj - a_maj, torch.where(x_major, by, bx) - a_min
    slope = torch.where(d_maj != 0, d_min / torch.where(
        d_maj != 0, d_maj, torch.ones_like(d_maj)), torch.zeros_like(d_maj))
    extent_maj = torch.where(x_major, w, h)
    extent_min = torch.where(x_major, h, w)
    # major-axis pixels i with centre i + 0.5 in [lo - pad, hi + pad]
    lo = torch.clamp(torch.floor(torch.minimum(a_maj, b_maj) - MAJOR_PAD
                                 - 0.5), min=0).to(torch.int64)
    hi = torch.minimum(torch.ceil(torch.maximum(a_maj, b_maj) + MAJOR_PAD
                                  - 0.5).to(torch.int64), extent_maj - 1)
    count = torch.clamp(hi - lo + 1, min=0)
    seg = torch.repeat_interleave(torch.arange(segs.shape[0], device=dev),
                                  count)
    if seg.numel() == 0:
        return color_buf
    start = torch.cumsum(count, 0) - count
    i = lo[seg] + torch.arange(seg.shape[0], device=dev) - start[seg]
    line = a_min[seg] + (i.to(torch.float32) + 0.5 - a_maj[seg]) * slope[seg]
    j = (torch.floor(line).to(torch.int64)[:, None]
         + torch.arange(-MINOR_HALF, MINOR_HALF + 1, device=dev))
    seg = seg[:, None].expand_as(j)
    i = i[:, None].expand_as(j)
    xm = x_major[seg]
    keep = (j >= 0) & (j < extent_min[seg])
    seg, i, j, xm = seg[keep], i[keep], j[keep], xm[keep]
    px = torch.where(xm, i, j)
    py = torch.where(xm, j, i)
    _, d2 = _segment_t_d2(px.to(torch.float32) + 0.5,
                          py.to(torch.float32) + 0.5,
                          ax[seg], ay[seg], bx[seg], by[seg])
    hit = d2 < 1.0
    flat = (py * w + px)[hit]
    last = torch.full((h * w,), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, flat, seg[hit], reduce="amax")
    last = last.view(h, w)
    drawn = last >= 0
    s = torch.clamp(last, min=0)
    xg, yg = _pixel_centres(h, w, dev)
    t, _ = _segment_t_d2(xg, yg, ax[s], ay[s], bx[s], by[s])
    return torch.where(drawn[..., None], _segment_color(t, attribs, dev),
                       color_buf)
