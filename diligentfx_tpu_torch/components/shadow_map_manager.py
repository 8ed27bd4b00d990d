"""Shadow maps (the port of diligentfx_tpu/components/shadow_map_manager.py):
the cascaded sun shadows, the Shadows.fxh filtering modes (PCF with the
receiver-plane depth bias, VSM, EVSM2, EVSM4) with the cascade blend, and
the per-light (spot / point) shadow slices.

  * `distribute_cascades`: cascade partitioning (linear <-> log blend),
    bounding-sphere extents, texel snapping, filter margins, z extension
    (ShadowMapManager.cpp:134-396), in float32 tensors.
  * `render_cascade_shadow_maps`: one two-pass raster (K4) per cascade,
    both faces, into a (C, S, S) depth array.
  * `sample_cascaded_shadows`: cascade selection, filtering and the blend
    with the next cascade near the transition edge.
  * `spot_view_proj`, `point_view_projs`, `render_light_shadow_maps`,
    `sample_light_shadow`: one perspective slice a spot light, six cube
    faces a point light (HnLight's shadow view / projection), rasterized
    by K4 and filtered by the PCF taps with the slice as the cascade;
    `light_shadow_factors` dispatches each light to its kind.

Depth convention: shadow projections give z in [0, 1], less = nearer.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.config import MAX_CASCADES, RasterizerConfig, \
    ShadowMode
from diligentfx_tpu_torch.ops import raster as rz

Tensor = torch.Tensor


class ShadowMapAttribs(NamedTuple):
    """ShadowMapAttribs / CascadeAttribs (BasicStructures.fxh:29-100):
    everything the filtering needs, leading dim C = cascades."""
    world_to_light_view: Tensor      # (4, 4)
    cascade_cam_z_end: Tensor        # (C,)
    cascade_start_end_z: Tensor      # (C, 2)
    light_space_scale: Tensor        # (C, 3)
    light_space_bias: Tensor         # (C, 3)
    margin_proj_space: Tensor        # (C, 4) x,y margins + z ext
    world_to_uv_depth: Tensor        # (C, 4, 4)
    shadow_map_dim: Tensor           # (4,) = (S, S, 1/S, 1/S)
    cascade_transition_region: Tensor  # ()
    receiver_plane_depth_bias_clamp: Tensor  # ()
    fixed_depth_bias: Tensor         # ()

    @property
    def num_cascades(self) -> int:
        return self.cascade_cam_z_end.shape[0]


def _f32(x, device) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def adjust_cascade_range(depth_range, cam_near, cam_far):
    """AdjustCascadeRange: tighten the cascade span to the scene's visible
    depth range (scene_near_z, scene_far_z).  Returns (near, far)."""
    dev = depth_range.scene_near_z.device
    near = torch.maximum(_f32(cam_near, dev), depth_range.scene_near_z * 0.99)
    far = torch.minimum(_f32(cam_far, dev), depth_range.scene_far_z * 1.01)
    far = torch.maximum(far, near * 1.05)
    return near, far


def basis_from_direction(direction, device=None) -> Tensor:
    """World -> light-view row-vector matrix looking along `direction`."""
    d = _f32(direction, device)
    d = d / torch.linalg.vector_norm(d)
    up = torch.where(torch.abs(d[1]) > 0.99, _f32([1.0, 0.0, 0.0], d.device),
                     _f32([0.0, 1.0, 0.0], d.device))
    x = torch.linalg.cross(up, d)
    x = x / torch.linalg.vector_norm(x)
    y = torch.linalg.cross(d, x)
    m = torch.eye(4, dtype=torch.float32, device=d.device)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = d
    return m


def _frustum_min_bounding_sphere(proj_00: Tensor, proj_11: Tensor,
                                 near: Tensor, far: Tensor):
    """Minimum bounding sphere of a camera sub-frustum
    (GetFrustumMinimumBoundingSphere).  Returns (center_view (3,), radius)."""
    k2 = (1.0 / proj_00) ** 2 + (1.0 / proj_11) ** 2
    center_z = torch.minimum(far, 0.5 * (near + far) * (1.0 + k2))
    r_far = torch.sqrt(far * far * k2 + (far - center_z) ** 2)
    r_near = torch.sqrt(near * near * k2 + (center_z - near) ** 2)
    radius = torch.maximum(r_far, r_near)
    zero = 0.0 * center_z
    return torch.stack([zero, zero, -center_z]), radius


def distribute_cascades(camera_view: Tensor, camera_world: Tensor,
                        proj_00, proj_11, cam_near, cam_far, light_dir, *,
                        num_cascades: int = 4, shadow_map_size: int = 1024,
                        partitioning_factor: float = 0.95,
                        stabilize_extents: bool = True,
                        snap_cascades: bool = True,
                        equalize_extents: bool = True,
                        filter_size: int = 3,
                        transition_region: float = 0.1,
                        receiver_plane_bias_clamp: float = 10.0,
                        fixed_depth_bias: float = 1e-4,
                        z_caster_extension: float = 50.0
                        ) -> ShadowMapAttribs:
    """ShadowMapManager::DistributeCascades (JAX shadow_map_manager.py:103),
    every scalar in float32 on camera_view's device."""
    if num_cascades > MAX_CASCADES:
        raise ValueError(f"at most {MAX_CASCADES} cascades")
    dev = camera_view.device
    world_to_light = basis_from_direction(light_dir, dev)
    sm = float(shadow_map_size)
    proj_00, proj_11 = _f32(proj_00, dev), _f32(proj_11, dev)
    cam_near, cam_far = _f32(cam_near, dev), _f32(cam_far, dev)
    pf = _f32(partitioning_factor, dev)
    rp_clamp = _f32(receiver_plane_bias_clamp, dev)

    z_prev = cam_near
    z_ends, starts, scales, biases, margins, mats_uv = [], [], [], [], [], []
    ratio = cam_far / cam_near
    rng = cam_far - cam_near
    fixed_margin = 0.5 if snap_cascades else 0.0
    margin_px = fixed_margin + filter_size / 2.0
    extension_px = 2.0 * margin_px
    uv_m = _f32([[0.5, 0, 0, 0], [0, -0.5, 0, 0], [0, 0, 1, 0],
                 [0.5, 0.5, 0, 1]], dev)

    for i in range(num_cascades):
        near_i = z_prev
        if i < num_cascades - 1:
            power = (i + 1) / num_cascades
            log_z = cam_near * torch.pow(ratio, power)
            uni_z = cam_near + rng * power
            far_i = pf * (log_z - uni_z) + uni_z
        else:
            far_i = cam_far
        z_prev = far_i
        z_ends.append(far_i)
        starts.append(near_i)

        if stabilize_extents:
            center_view, radius = _frustum_min_bounding_sphere(
                proj_00, proj_11, near_i, far_i)
            center_ls = m3.transform_points(
                m3.transform_points(center_view, camera_world)[:3],
                world_to_light)[:3]
            mn = center_ls - radius
            mx = center_ls + radius
        else:
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            sub_proj = torch.stack([
                torch.stack([proj_00, zero, zero, zero]),
                torch.stack([zero, proj_11, zero, zero]),
                torch.stack([zero, zero, -far_i / (far_i - near_i),
                             zero - 1.0]),
                torch.stack([zero, zero, -near_i * far_i / (far_i - near_i),
                             zero])])
            inv = m3.inverse(m3.mul44(camera_view, sub_proj))
            corners = _f32([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                            for z in (0, 1)], dev)
            world_h = m3.transform_points(corners, inv)
            world = world_h[..., :3] / world_h[..., 3:4]
            ls = m3.transform_points(world, world_to_light)[..., :3]
            mn = torch.amin(ls, dim=0)
            mx = torch.amax(ls, dim=0)

        extent = mx - mn
        center = (mx + mn) * 0.5
        if equalize_extents:
            e = torch.maximum(extent[0], extent[1])
            extent = torch.stack([e, e, extent[2]])
        # remap N x N -> (N - ext) x (N - ext)
        extent = torch.stack([extent[0] * (sm / (sm - extension_px)),
                              extent[1] * (sm / (sm - extension_px)),
                              extent[2]])
        if snap_cascades:
            texel = extent[:2] / sm
            center = torch.cat([torch.round(center[:2] / texel) * texel,
                                center[2:]])

        # pull the near plane toward the light so off-frustum casters still
        # cast into the view (the reference relies on depth clamp)
        z_min = mn[2] - z_caster_extension
        z_max = mx[2]
        z_ext_frac = torch.clamp(_f32(margin_px / sm, dev) * rp_clamp,
                                 max=0.25)
        z_extent = (z_max - z_min) / (1.0 - 2.0 * z_ext_frac)

        mn2 = torch.cat([center[:2] - extent[:2] * 0.5, z_min[None]])
        scale = torch.stack([2.0 / extent[0], 2.0 / extent[1],
                             1.0 / z_extent])
        bias = torch.stack([-mn2[0] * scale[0] - 1.0,
                            -mn2[1] * scale[1] - 1.0,
                            -mn2[2] * scale[2]])
        scales.append(scale)
        biases.append(bias)
        m_xy = _f32(margin_px * 2.0 / sm, dev)
        margins.append(torch.stack([m_xy, m_xy, z_ext_frac, z_ext_frac]))

        # world -> light proj [-1,1]^2 x [0,1] -> UV-depth
        proj = torch.diag(torch.cat([scale, torch.ones(1, device=dev)]))
        proj[3, :3] = bias
        mats_uv.append(m3.mul44(m3.mul44(world_to_light, proj), uv_m))

    return ShadowMapAttribs(
        world_to_light_view=world_to_light,
        cascade_cam_z_end=torch.stack(z_ends),
        cascade_start_end_z=torch.stack([torch.stack([s, e])
                                         for s, e in zip(starts, z_ends)]),
        light_space_scale=torch.stack(scales),
        light_space_bias=torch.stack(biases),
        margin_proj_space=torch.stack(margins),
        world_to_uv_depth=torch.stack(mats_uv),
        shadow_map_dim=_f32([sm, sm, 1.0 / sm, 1.0 / sm], dev),
        cascade_transition_region=_f32(transition_region, dev),
        receiver_plane_depth_bias_clamp=_f32(receiver_plane_bias_clamp, dev),
        fixed_depth_bias=_f32(fixed_depth_bias, dev))


def cascade_clip(world_positions: Tensor, attribs: ShadowMapAttribs,
                 i: int) -> Tensor:
    """World positions -> cascade i's clip space: xy in [-1, 1], z in
    [0, 1], w = 1 (orthographic)."""
    lv = m3.transform_points(world_positions,
                             attribs.world_to_light_view)[..., :3]
    p = lv * attribs.light_space_scale[i] + attribs.light_space_bias[i]
    return torch.cat([p[..., :2], p[..., 2:3], torch.ones_like(p[..., :1])],
                     dim=-1)


def render_cascade_shadow_maps(world_positions: Tensor, indices: Tensor,
                               attribs: ShadowMapAttribs, *,
                               shadow_map_size: int,
                               cfg: RasterizerConfig = RasterizerConfig()
                               ) -> Tensor:
    """Depth-only raster pass per cascade -> (C, S, S) depth (JAX
    shadow_map_manager.py:230): the two-pass raster, both faces (the
    reference draws casters with depth clamp and no culling).  Background
    (no caster) = 1.0 (far)."""
    maps = []
    both = torch.ones((indices.shape[0],), dtype=torch.bool,
                      device=indices.device)
    for i in range(attribs.num_cascades):
        vb, _ = rz.rasterize(cascade_clip(world_positions, attribs, i),
                             indices, width=shadow_map_size,
                             height=shadow_map_size, cfg=cfg,
                             double_sided=both)
        maps.append(torch.where(vb.tri_id >= 0,
                                torch.clamp(vb.depth, 0.0, 1.0),
                                torch.ones_like(vb.depth)))
    return torch.stack(maps)


# ---------------------------------------------------------------------------
# Sampling / filtering (Shadows.fxh)
# ---------------------------------------------------------------------------


class CascadeSamplingInfo(NamedTuple):
    """Shadows.fxh CascadeSamplingInfo, per pixel."""
    uv: Tensor                 # (..., 2)
    depth: Tensor              # (..., 1)
    cascade_idx: Tensor        # (...,) int64
    min_dist_to_margin: Tensor  # (..., 1)
    in_any: Tensor             # (...,) bool


def _margin_dist(p: Tensor, margin: Tensor) -> Tensor:
    return torch.minimum(
        torch.minimum(1.0 - margin[..., 0:1] - torch.abs(p[..., 0:1]),
                      1.0 - margin[..., 1:2] - torch.abs(p[..., 1:2])),
        torch.minimum(p[..., 2:3] - margin[..., 2:3],
                      1.0 - margin[..., 3:4] - p[..., 2:3]))


def _proj_uv(p: Tensor) -> Tensor:
    return torch.stack([p[..., 0] * 0.5 + 0.5, 0.5 - p[..., 1] * 0.5],
                       dim=-1)


def find_cascade(attribs: ShadowMapAttribs, pos_light_view: Tensor,
                 cam_view_z: Tensor) -> CascadeSamplingInfo:
    """Cascade selection by camera-space z (Shadows.fxh FindCascade, the
    vectorised variant at :94-110), then the scale/bias lookup."""
    c = attribs.num_cascades
    z = cam_view_z[..., None]
    idx = torch.sum((attribs.cascade_cam_z_end < z).to(torch.int64), dim=-1)
    in_any = idx < c
    ci = torch.clamp(idx, max=c - 1)
    p = (pos_light_view * attribs.light_space_scale[ci]
         + attribs.light_space_bias[ci])
    dist = _margin_dist(p, attribs.margin_proj_space[ci])
    return CascadeSamplingInfo(uv=_proj_uv(p), depth=p[..., 2:3],
                               cascade_idx=ci, min_dist_to_margin=dist,
                               in_any=in_any)


def _gather_cascade(shadow_maps: Tensor, cascade_idx: Tensor, y: Tensor,
                    x: Tensor) -> Tensor:
    """shadow_maps (C, S, S); per-pixel (cascade, y, x) via a flat index."""
    s = shadow_maps.shape[-1]
    yc = torch.clamp(y, 0, s - 1)
    xc = torch.clamp(x, 0, s - 1)
    return shadow_maps.reshape(-1)[cascade_idx * (s * s) + yc * s + xc]


def filter_shadow_pcf(shadow_maps: Tensor, info: CascadeSamplingInfo,
                      kernel_size: int = 3, depth_bias=1e-3,
                      receiver_plane_bias: Optional[Tensor] = None,
                      bias_clamp=10.0) -> Tensor:
    """Fixed-size PCF (PCF.fxh:7-155): bilinear-weighted comparison taps
    over a kernel_size footprint, optionally with the receiver-plane depth
    bias (Shadows.fxh:148; (..., 2) d(shadow z)/d(shadow uv), clamped to
    bias_clamp texels of slope).  Returns (...,) lit fraction in [0, 1]."""
    s = shadow_maps.shape[-1]
    fx = info.uv[..., 0] * s - 0.5
    fy = info.uv[..., 1] * s - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    tx = fx - x0f
    ty = fy - y0f
    x0, y0 = x0f.long(), y0f.long()
    ref = info.depth[..., 0] - depth_bias
    bu = bv = None
    if receiver_plane_bias is not None:
        bu = receiver_plane_bias[..., 0]
        bv = receiver_plane_bias[..., 1]
        # the bilinear footprint spans one texel: shift ref by the worst
        # in-footprint depth slope
        err = (torch.abs(bu) + torch.abs(bv)) / s
        ref = ref - torch.minimum(err, torch.as_tensor(bias_clamp / s,
                                                       device=err.device))

    half = kernel_size / 2.0
    r = kernel_size // 2 + 1
    total = torch.zeros_like(fx)
    wsum = torch.zeros_like(fx)
    for dy in range(-r, r + 1):
        wy = torch.clamp(torch.minimum(torch.full_like(ty, dy + 1.0),
                                       ty + half)
                         - torch.maximum(torch.full_like(ty, float(dy)),
                                         ty - half), 0.0, 1.0)
        for dx in range(-r, r + 1):
            wx = torch.clamp(torch.minimum(torch.full_like(tx, dx + 1.0),
                                           tx + half)
                             - torch.maximum(torch.full_like(tx, float(dx)),
                                             tx - half), 0.0, 1.0)
            d = _gather_cascade(shadow_maps, info.cascade_idx, y0 + dy,
                                x0 + dx)
            ref_t = ref
            if bu is not None:
                adj = (bu * dx + bv * dy) / s
                lim = bias_clamp / s
                ref_t = ref + torch.clamp(adj, -lim, lim)
            lit = (ref_t <= d).to(torch.float32)
            w = wx * wy
            total = total + lit * w
            wsum = wsum + w
    return total / torch.clamp(wsum, min=1e-6)


def convert_to_filterable(shadow_maps: Tensor, mode: ShadowMode,
                          positive_exp: float = 40.0,
                          negative_exp: float = 8.0,
                          emulate_16bit: bool = False) -> Tensor:
    """Depth (C, S, S) -> moments (ShadowConversions.fx): VSM (z, z^2);
    EVSM2 (e^{pz}, e^{2pz}); EVSM4 adds the negative warp.  emulate_16bit
    quantises VSM moments to RG16_UNORM steps."""
    z = shadow_maps
    if mode == ShadowMode.VSM:
        m = torch.stack([z, z * z], dim=-1)
        if emulate_16bit:
            m = torch.round(torch.clamp(m, 0.0, 1.0) * 65535.0) / 65535.0
        return m
    ep = torch.exp(positive_exp * z)
    if mode == ShadowMode.EVSM2:
        return torch.stack([ep, ep * ep], dim=-1)
    en = -torch.exp(-negative_exp * z)
    return torch.stack([ep, ep * ep, en, en * en], dim=-1)


def gaussian_blur_separable(maps: Tensor, radius: int = 2,
                            sigma: float = 1.5) -> Tensor:
    """Separable Gaussian over the two spatial dims of (C, S, S, M), edge
    padded; taps summed in kernel order as in the JAX package."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=maps.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / torch.sum(k)).tolist()
    out = maps
    for axis in (1, 2):
        n = out.shape[axis]
        first = out.narrow(axis, 0, 1)
        last = out.narrow(axis, n - 1, 1)
        p = torch.cat([first] * radius + [out] + [last] * radius, dim=axis)
        acc = torch.zeros_like(out)
        for j, w in enumerate(k):
            acc = acc + p.narrow(axis, j, n) * w
        out = acc
    return out


def _chebyshev_upper_bound(mean: Tensor, mean_sq: Tensor, ref: Tensor,
                           min_variance) -> Tensor:
    """Chebyshev bound with light-bleeding reduction (Shadows.fxh
    ChebyshevUpperBound :265-278)."""
    variance = torch.clamp(mean_sq - mean * mean, min=min_variance)
    d = ref - mean
    p_max = variance / (variance + d * d)
    p_max = torch.clamp((p_max - 0.2) / 0.8, 0.0, 1.0)
    return torch.where(ref <= mean, torch.ones_like(p_max), p_max)


def _bilinear_cascade(moments: Tensor, cascade_idx: Tensor,
                      uv: Tensor) -> Tensor:
    """moments (C, S, S, M) bilinear at the per-pixel cascade -> (..., M)."""
    s = moments.shape[1]
    m = moments.shape[-1]
    fx = uv[..., 0] * s - 0.5
    fy = uv[..., 1] * s - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    tx = (fx - x0f)[..., None]
    ty = (fy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    flat = moments.reshape(-1, m)

    def tap(yy, xx):
        yc = torch.clamp(yy, 0, s - 1)
        xc = torch.clamp(xx, 0, s - 1)
        return flat[cascade_idx * (s * s) + yc * s + xc]

    c00 = tap(y0, x0)
    c10 = tap(y0, x0 + 1)
    c01 = tap(y0 + 1, x0)
    c11 = tap(y0 + 1, x0 + 1)
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def filter_shadow_vsm(moments: Tensor, info: CascadeSamplingInfo,
                      mode: ShadowMode, positive_exp: float = 40.0,
                      negative_exp: float = 8.0,
                      min_variance: float = 1e-5) -> Tensor:
    """Shadows.fxh SampleFilterableShadowMap (:332-388)."""
    mom = _bilinear_cascade(moments, info.cascade_idx, info.uv)
    ref = info.depth[..., 0]
    mv = torch.tensor(min_variance, dtype=torch.float32)
    if mode == ShadowMode.VSM:
        return _chebyshev_upper_bound(mom[..., 0], mom[..., 1], ref,
                                      float(mv))
    ref_p = torch.exp(positive_exp * ref)
    p = _chebyshev_upper_bound(mom[..., 0], mom[..., 1], ref_p,
                               float(mv * positive_exp ** 2))
    if mode == ShadowMode.EVSM2:
        return p
    ref_n = -torch.exp(-negative_exp * ref)
    n = _chebyshev_upper_bound(mom[..., 2], mom[..., 3], ref_n,
                               float(mv * negative_exp ** 2))
    return torch.minimum(p, n)


def _clamped_diff(a: Tensor, axis: int) -> Tensor:
    """Forward differences, the last difference repeated at the border."""
    d = torch.diff(a, dim=axis)
    return torch.cat([d, d.narrow(axis, d.shape[axis] - 1, 1)], dim=axis)


def _plane_bias(info: CascadeSamplingInfo) -> Tensor:
    """Receiver-plane depth bias (Shadows.fxh:148): d(shadow z)/d(shadow
    uv) from screen-space differences of the shadow-space position."""
    uvz = torch.cat([info.uv, info.depth], dim=-1)
    ddx = _clamped_diff(uvz, 1)
    ddy = _clamped_diff(uvz, 0)
    det = ddx[..., 0] * ddy[..., 1] - ddx[..., 1] * ddy[..., 0]
    inv = torch.where(torch.abs(det) > 1e-12, 1.0 / det,
                      torch.zeros_like(det))
    b_u = (ddy[..., 1] * ddx[..., 2] - ddx[..., 1] * ddy[..., 2]) * inv
    b_v = (ddx[..., 0] * ddy[..., 2] - ddy[..., 0] * ddx[..., 2]) * inv
    return torch.stack([b_u, b_v], dim=-1)


def sample_cascaded_shadows(world_pos: Tensor, cam_view_z: Tensor,
                            attribs: ShadowMapAttribs, shadow_maps: Tensor,
                            mode: ShadowMode = ShadowMode.PCF,
                            pcf_kernel_size: int = 3,
                            moments: Optional[Tensor] = None,
                            blend_cascades: bool = True) -> Tensor:
    """Cascade shadow factor per pixel: select the cascade, filter, blend
    with the next cascade near the transition edge (Shadows.fxh
    FilterShadowMap + GetNextCascadeBlendAmount; JAX
    shadow_map_manager.py:461).  Outside every cascade: lit."""
    plv = m3.transform_points(world_pos, attribs.world_to_light_view)[..., :3]
    info = find_cascade(attribs, plv, cam_view_z)
    rp_bias = None
    if mode == ShadowMode.PCF and world_pos.dim() == 3:
        rp_bias = _plane_bias(info)

    def one(info_):
        if mode == ShadowMode.PCF:
            return filter_shadow_pcf(
                shadow_maps, info_, pcf_kernel_size,
                depth_bias=attribs.fixed_depth_bias,
                receiver_plane_bias=rp_bias,
                bias_clamp=float(attribs.receiver_plane_depth_bias_clamp))
        return filter_shadow_vsm(moments, info_, mode)

    lit = one(info)
    if blend_cascades:
        c = attribs.num_cascades
        next_idx = torch.clamp(info.cascade_idx + 1, max=c - 1)
        p = (plv * attribs.light_space_scale[next_idx]
             + attribs.light_space_bias[next_idx])
        dist_n = _margin_dist(p, attribs.margin_proj_space[next_idx])
        info_n = CascadeSamplingInfo(uv=_proj_uv(p), depth=p[..., 2:3],
                                     cascade_idx=next_idx,
                                     min_dist_to_margin=dist_n,
                                     in_any=info.in_any)
        start_end = attribs.cascade_start_end_z[info.cascade_idx]
        dist_edge = (start_end[..., 1] - cam_view_z) / torch.clamp(
            start_end[..., 1] - start_end[..., 0], min=1e-6)
        blend = (torch.clamp(1.0 - dist_edge
                             / attribs.cascade_transition_region, 0.0, 1.0)
                 * torch.clamp(dist_n[..., 0] / 0.01, 0.0, 1.0)
                 * (info.cascade_idx < c - 1))
        lit = lit + (one(info_n) - lit) * blend
    return torch.where(info.in_any, lit, torch.ones_like(lit))


def _cascade_factor(pos_px: Tensor, info, mode: ShadowMode,
                    pcf_kernel_size: int) -> Tensor:
    """The cascaded shadow factor of the frame's sun (JAX deferred.py:505)."""
    cam_view_z = -m3.transform_points(pos_px, info.camera.view)[..., 2]
    return sample_cascaded_shadows(
        pos_px, cam_view_z, info.shadow_attribs, info.shadow_maps, mode=mode,
        pcf_kernel_size=pcf_kernel_size, moments=info.shadow_moments)


def cascaded_shadow_factors(pos_px: Tensor, info, mode: ShadowMode,
                            pcf_kernel_size: int = 3) -> Tensor:
    """(N_lights, H, W) visibility of each light: the cascaded shadow factor
    for lights with a shadow map index >= 0, 1 for the others (the shading
    passes of JAX deferred.py:502-550 and renderer.py:357-373).  `info` is
    the frame's RenderInfo with its shadow attribs, maps and moments."""
    factor = _cascade_factor(pos_px, info, mode, pcf_kernel_size)
    ones = torch.ones_like(factor)
    return torch.stack([torch.where(info.lights.shadow_map_index[i] >= 0,
                                    factor, ones)
                        for i in range(info.lights.count)], dim=0)


# ---------------------------------------------------------------------------
# Per-light (spot / point / single-slice directional) shadow slices: the
# HnLight shadow view / projection, one slice a spot or directional light,
# six cube-face slices a point light, chosen per pixel by the dominant axis
# of the light -> surface vector.
# ---------------------------------------------------------------------------

# cube faces in slice order +X -X +Y -Y +Z -Z (point_shadow_face's order)
_CUBE_FACE_DIRS = ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                   (0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))


def spot_view_proj(position, direction, outer_angle, near: float = 0.05,
                   far: float = 100.0, device=None) -> Tensor:
    """World -> spot-light clip (JAX shadow_map_manager.py:552): field of
    view twice the outer cone angle, square aspect."""
    position = _f32(position, device)
    direction = _f32(direction, position.device)
    view = m3.look_at(position, position + direction, device=position.device)
    proj = m3.perspective(2.0 * float(outer_angle), 1.0, near, far,
                          device=position.device)
    return m3.mul44(view, proj)


def point_view_projs(position, near: float = 0.05, far: float = 100.0,
                     device=None) -> Tensor:
    """World -> clip of a point light's six 90-degree cube faces, (6, 4, 4)
    in the order +X -X +Y -Y +Z -Z (JAX shadow_map_manager.py:569).  The
    +-Y faces take look_at's fallback up vector."""
    position = _f32(position, device)
    dev = position.device
    proj = m3.perspective(math.pi / 2.0, 1.0, near, far, device=dev)
    return torch.stack([m3.mul44(m3.look_at(position,
                                            position + _f32(d, dev),
                                            device=dev), proj)
                        for d in _CUBE_FACE_DIRS])


def point_shadow_face(v: Tensor) -> Tensor:
    """Cube-face index (0..5, int64) from the light -> surface vector by its
    dominant axis (JAX shadow_map_manager.py:582); of equal magnitudes the
    first axis wins, as jnp.argmax takes the first maximum."""
    av = torch.abs(v)
    x_wins = (av[..., 0] >= av[..., 1]) & (av[..., 0] >= av[..., 2])
    axis = torch.where(x_wins, 0, torch.where(av[..., 1] >= av[..., 2], 1, 2))
    comp = torch.gather(v, -1, axis[..., None])[..., 0]
    return axis * 2 + (comp < 0).to(torch.int64)


def render_light_shadow_maps(world_positions: Tensor, indices: Tensor,
                             view_projs: Tensor, *, shadow_map_size: int,
                             cfg: RasterizerConfig = RasterizerConfig()
                             ) -> Tensor:
    """Depth-only raster per slice (JAX shadow_map_manager.py:590):
    view_projs (K, 4, 4) -> (K, S, S) depth in [0, 1], 1 where no caster.
    One two-pass raster (K4) a slice, both faces."""
    maps = []
    both = torch.ones((indices.shape[0],), dtype=torch.bool,
                      device=indices.device)
    for i in range(view_projs.shape[0]):
        vb, _ = rz.rasterize(m3.transform_points(world_positions,
                                                 view_projs[i]),
                             indices, width=shadow_map_size,
                             height=shadow_map_size, cfg=cfg,
                             double_sided=both)
        maps.append(torch.where(vb.tri_id >= 0,
                                torch.clamp(vb.depth, 0.0, 1.0),
                                torch.ones_like(vb.depth)))
    return torch.stack(maps)


def sample_light_shadow(world_pos: Tensor, view_projs: Tensor, maps: Tensor,
                        face_idx: Optional[Tensor] = None,
                        pcf_kernel_size: int = 3,
                        depth_bias: float = 2e-3) -> Tensor:
    """Shadow factor from a light's own slices (JAX
    shadow_map_manager.py:608): world_pos (..., 3), view_projs (F, 4, 4),
    maps (F, S, S), face_idx (...,) the slice of each pixel (None: slice
    0).  Each pixel is projected by its own slice's matrix in exact fp32
    (the JAX package projects by every slice and sums a one-hot selection,
    which adds exact zeros); points outside the slice's frustum are lit.
    The PCF taps filter with the slice as the cascade."""
    clip = m3.transform_points(world_pos, view_projs[0])
    if face_idx is None:
        fi = torch.zeros(world_pos.shape[:-1], dtype=torch.int64,
                         device=world_pos.device)
    else:
        fi = face_idx.long()
        for f in range(1, view_projs.shape[0]):
            clip = torch.where((fi == f)[..., None],
                               m3.transform_points(world_pos, view_projs[f]),
                               clip)
    w = clip[..., 3]
    valid = w > 1e-6
    wi = 1.0 / torch.clamp(w, min=1e-6)
    u = clip[..., 0] * wi * 0.5 + 0.5
    v = 0.5 - clip[..., 1] * wi * 0.5
    z = clip[..., 2] * wi
    inside = (valid & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
              & (z >= 0) & (z <= 1))
    info = CascadeSamplingInfo(
        uv=torch.stack([u, v], dim=-1), depth=z[..., None], cascade_idx=fi,
        min_dist_to_margin=torch.zeros_like(z[..., None]), in_any=inside)
    lit = filter_shadow_pcf(maps, info, kernel_size=pcf_kernel_size,
                            depth_bias=depth_bias)
    return torch.where(inside, lit, torch.ones_like(lit))


# slices a light of each kind takes, in the packed per-light layout
SLICES_PER_KIND = {"dir": 1, "spot": 1, "point": 6}


def light_shadow_factors(pos_px: Tensor, info, kinds: tuple,
                         mode: Optional[ShadowMode],
                         pcf_kernel_size: int = 3) -> Tensor:
    """(N_lights, H, W) visibility of each light by its shadow kind (the
    per-light dispatch of JAX deferred.py:512-540): "csm" takes the
    cascaded factor when `mode` is set; "spot" and "dir" one slice, "point"
    six, the face chosen by pos_px - the light's position, each light's
    slices following the previous light's in info.light_shadow_maps /
    light_shadow_view_projs; any other kind, and lights past the tuple,
    are lit."""
    if any(k in SLICES_PER_KIND for k in kinds) and (
            info.light_shadow_maps is None
            or info.light_shadow_view_projs is None):
        raise ValueError(f"light_shadow_kinds {kinds} need "
                         "info.light_shadow_maps and light_shadow_view_projs")
    csm = (_cascade_factor(pos_px, info, mode, pcf_kernel_size)
           if mode is not None and "csm" in kinds else None)
    ones = torch.ones(pos_px.shape[:-1], dtype=torch.float32,
                      device=pos_px.device)
    factors, base = [], 0
    for i in range(info.lights.count):
        kind = kinds[i] if i < len(kinds) else "none"
        if kind == "csm" and csm is not None:
            factors.append(csm)
        elif kind in SLICES_PER_KIND:
            n = SLICES_PER_KIND[kind]
            face = (point_shadow_face(pos_px - info.lights.position[i])
                    if kind == "point" else None)
            factors.append(sample_light_shadow(
                pos_px, info.light_shadow_view_projs[base:base + n],
                info.light_shadow_maps[base:base + n], face_idx=face,
                pcf_kernel_size=pcf_kernel_size))
            base += n
        else:
            factors.append(ones)
    return torch.stack(factors, dim=0)
