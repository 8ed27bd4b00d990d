"""Deferred G-buffer rendering (the port of diligentfx_tpu/pbr/deferred.py),
cut to what the benchmark's configurations run:

  1. visibility by the fused raster (K1's plain version): it rasterizes,
     interpolates the per-vertex attributes and fetches the material row
     per pixel (rasterize_fused, channel-first output); world position is
     reconstructed from the raster depth (the JAX package's default
     DFX_RECON=on behaviour);
  2. shading with the sun and the IBL maps, no textures, shadows or
     material extension layers, split into the layers the post chain
     composites: direct (punctual + emissive), ambient diffuse, ambient
     specular and the split-sum environment factor.

Shading is pixel-local, so it can run in row bands: `render_gbuffer_banded`
rasterizes the frame once and shades it band by band (the JAX package's
4K form).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fxbench.reference.dfx import math3d as m3
from fxbench.reference.dfx.config import RasterizerConfig
from fxbench.reference.dfx.ops import raster as rz
from fxbench.reference.dfx.ops.raster_kernel import raster_tiles_fused
from fxbench.reference.dfx.ops.sampling import bilinear_sample, sample_env_oct
from fxbench.reference.dfx.pbr import brdf, shading as sh
from fxbench.reference.dfx.pbr.renderer import (RenderInfo, ScenePrimitives,
                                               _camera_rays,
                                               transform_vertices)
from fxbench.reference.dfx.postfx.context import reconstruct_world_pos

Tensor = torch.Tensor

class GBufferData(NamedTuple):
    """HnFrameRenderTargets analogue: every AOV the tasks consume."""
    depth: Tensor             # (H, W) NDC depth (background = 1)
    mesh_id: Tensor           # (H, W) int32 node id, -1 background
    normal_world: Tensor      # (H, W, 3)
    normal_view: Tensor       # (H, W, 3)
    base_color: Tensor        # (H, W, 3)
    material_data: Tensor     # (H, W, 3) = metallic, roughness, occlusion
    motion: Tensor            # (H, W, 2) uv motion
    world_pos: Tensor         # (H, W, 3)
    direct: Tensor            # (H, W, 3) punctual + emissive
    ambient_diffuse: Tensor   # (H, W, 3)
    ambient_specular: Tensor  # (H, W, 3)
    spec_env_factor: Tensor   # (H, W, 3) k_s * A + B
    background: Tensor        # (H, W, 3)
    hit: Tensor               # (H, W) bool


def _material_table(mats) -> Tensor:
    """The aligned (M, 20) material table fetched per pixel by the kernel."""
    m = mats.metallic_factor.shape[0]
    return torch.cat([
        mats.base_color_factor,                          # 0:4
        mats.emissive_factor,                            # 4:7
        mats.metallic_factor[:, None],                   # 7
        mats.roughness_factor[:, None],                  # 8
        mats.normal_scale[:, None],                      # 9
        mats.occlusion_factor[:, None],                  # 10
        mats.workflow[:, None].to(torch.float32),        # 11
        mats.clearcoat_factor[:, None],                  # 12
        mats.clearcoat_roughness_factor[:, None],        # 13
        mats.specular_factor,                            # 14:17
        mats.alpha_mask_cutoff[:, None],                 # 17
        torch.zeros((m, 2), dtype=torch.float32,
                    device=mats.metallic_factor.device),
    ], dim=-1)


def _vertex_inputs(scene: ScenePrimitives, info: RenderInfo):
    """Per-vertex data: (clip, winv, packed attrs (V, C), n_ch) with attrs
    = [world normal (3), previous clip x, y, w (3)] (JAX deferred.py:72;
    the fused path reconstructs position from depth instead of
    interpolating it)."""
    world_pos, world_nrm, _ = transform_vertices(scene, info.model_transform)
    clip = m3.transform_points(world_pos, info.camera.view_proj)
    w = clip[:, 3]
    winv = torch.where(torch.abs(w) > 1e-12, 1.0 / w, torch.zeros_like(w))
    prev_world, _, _ = transform_vertices(scene, info.model_transform,
                                          previous=True)
    prev_vp = (info.prev_view_proj if info.prev_view_proj is not None
               else info.camera.view_proj)
    prev_clip = m3.transform_points(prev_world, prev_vp)
    # interpolate previous CLIP x, y, w and divide per pixel (a per-vertex
    # divide breaks for triangles crossing the previous near plane)
    prev_cxyw = torch.stack([prev_clip[:, 0], prev_clip[:, 1],
                             prev_clip[:, 3]], dim=-1)
    packed = torch.cat([world_nrm, prev_cxyw], dim=-1)
    return clip, winv, packed, packed.shape[1]


UV0 = 6     # channels of the packed attributes (normal, prev clip)


def fused_raster_inputs(scene: ScenePrimitives, info: RenderInfo, *,
                        pad_w: int, pad_h: int, cfg: RasterizerConfig
                        ) -> rz.FusedKernelInputs:
    """Vertex stage + triangle setup + binning: the fused tile kernel's
    inputs for this scene and camera (per-triangle consts = material id,
    node id; the material table rides transposed)."""
    clip, winv, packed, n_ch = _vertex_inputs(scene, info)
    # the opaque prefix: a mask tail, forced through the fused path, is
    # dropped as in the JAX package
    n_op = scene.num_opaque
    indices = scene.indices[:n_op]
    tri_node = scene.vertex_node[indices[:, 0].long()]
    consts = torch.stack([scene.tri_material[:n_op].to(torch.float32),
                          tri_node.to(torch.float32)], dim=-1)
    mat_table_t = _material_table(scene.materials).t().contiguous()
    return rz.prepare_fused(clip, indices, packed, winv, consts,
                            mat_table_t, width=pad_w, height=pad_h, cfg=cfg,
                            n_ch=n_ch,
                            double_sided=scene.tri_double_sided[:n_op])


def _fused_raster(scene: ScenePrimitives, info: RenderInfo, *, pad_w: int,
                  pad_h: int, cfg: RasterizerConfig):
    """Raster + in-kernel interpolation + material fetch.  Returns (vb,
    fused channels (C, H, W))."""
    k = fused_raster_inputs(scene, info, pad_w=pad_w, pad_h=pad_h, cfg=cfg)
    z, tid, out = raster_tiles_fused(k.setup, k.planes, k.candidates,
                                     k.counts, k.mat_table, k.rects,
                                     **k.kernel_kw)
    return rz.VisibilityBuffer(depth=z, tri_id=tid), out


def _shade_band(scene: ScenePrimitives, info: RenderInfo, ibl_maps, env_oct,
                vb, fused_px: Tensor, *, pad_w: int, pad_h: int,
                use_ibl: bool, use_lights: bool, row0: int = 0,
                band_h: Optional[int] = None) -> GBufferData:
    """Deferred shading of rows [row0, row0 + band_h) of the padded
    pad_h-row frame (JAX deferred.py:224; band_h None: the whole frame),
    from the fused kernel's channel-first output `fused_px`.  `vb` and
    `fused_px` cover the whole frame and the band's rows are sliced out.
    Returns the PADDED band."""
    band_h = pad_h if band_h is None else band_h
    if band_h != pad_h:
        rows = slice(row0, row0 + band_h)
        vb = rz.VisibilityBuffer(
            depth=vb.depth[rows], tri_id=vb.tri_id[rows],
            bary=None if vb.bary is None else vb.bary[rows])
        fused_px = fused_px[:, rows]
    dev = vb.depth.device
    hit = vb.tri_id >= 0
    hit_m = hit[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    izero = torch.zeros((), dtype=torch.int32, device=dev)

    def grp(a, b):
        return torch.where(hit_m, torch.stack([fused_px[c] for c in
                                               range(a, b)], dim=-1), zero)

    # channels: normal (3) + previous clip (3), then the ids
    o = UV0
    mat_id = torch.where(hit, fused_px[o].to(torch.int32), izero)
    node_id = torch.where(hit, fused_px[o + 1].to(torch.int32), izero)
    m0 = o + 2                          # material-table row channels

    def mgrp(a, b):
        return grp(m0 + a, m0 + b)

    pos_px = reconstruct_world_pos(vb.depth, info.camera, row0=row0,
                                   full_h=pad_h)
    pos_px = torch.where(hit_m, pos_px, zero)
    ao = 0                              # channel of the normal
    nrm_px = m3.normalize(grp(ao, ao + 3))
    pw = grp(ao + 5, ao + 6)
    pw = torch.where(torch.abs(pw) > 1e-9, pw, torch.full_like(pw, 1e-9))
    prev_ndc = grp(ao + 3, ao + 5) / pw
    prev_uv = torch.stack([prev_ndc[..., 0] * 0.5 + 0.5,
                           0.5 - prev_ndc[..., 1] * 0.5], dim=-1)
    xg = (torch.arange(pad_w, dtype=torch.float32, device=dev) + 0.5) / pad_w
    yg = (torch.arange(band_h, dtype=torch.float32, device=dev) + float(row0)
          + 0.5) / pad_h
    cur_uv = torch.stack([xg[None, :].expand(band_h, pad_w),
                          yg[:, None].expand(band_h, pad_w)], dim=-1)
    motion = torch.where(hit_m, cur_uv - prev_uv, zero)

    base_color = mgrp(0, 3)
    emissive = mgrp(4, 7)
    metallic = mgrp(7, 8)
    roughness = mgrp(8, 9)
    occlusion = torch.ones_like(metallic)

    view = m3.normalize(info.camera.position - pos_px)
    srf = sh.get_surface_reflectance_mr(base_color, metallic, roughness)
    workflow = mgrp(11, 12)
    is_sg = workflow == float(sh.PBR_WORKFLOW_SPECULAR_GLOSSINESS)
    srf_sg = sh.get_surface_reflectance_sg(base_color, mgrp(14, 17),
                                           1.0 - roughness)
    srf = brdf.SurfaceReflectanceInfo(*(torch.where(is_sg, b, a)
                                        for a, b in zip(srf, srf_sg)))
    ndotv = torch.clamp(m3.dot(nrm_px, view), 0.0, 1.0)

    rp = info.renderer_params
    shading = sh.SurfaceShadingInfo(
        pos=pos_px, view=view, occlusion=occlusion,
        emissive=emissive * rp.emission_scale,
        base=sh.BaseLayerShadingInfo(srf=srf, metallic=metallic,
                                     normal=nrm_px, ndotv=ndotv),
        ibl_scale=rp.ibl_scale[:3])
    lighting = sh.default_lighting(pos_px, with_sheen=False,
                                   with_clearcoat=False)
    if use_lights:
        lighting = sh.apply_punctual_lights(shading, info.lights, lighting)

    scale = rp.ibl_scale[:3]
    if use_ibl and ibl_maps is not None:
        lighting = sh.apply_ibl(shading, ibl_maps, lighting, fast_env=False)
        amb_d = lighting.base.diffuse_ibl * scale
        amb_s = lighting.base.specular_ibl * scale
        pre_int = bilinear_sample(ibl_maps.preintegrated_ggx,
                                  torch.cat([ndotv, srf.perceptual_roughness],
                                            dim=-1))
        one_minus_r = 1.0 - srf.perceptual_roughness
        refl90 = torch.maximum(one_minus_r.expand(srf.reflectance0.shape),
                               srf.reflectance0)
        k_s = brdf.schlick_reflection(ndotv, srf.reflectance0, refl90)
        spec_factor = k_s * pre_int[..., 0:1] + pre_int[..., 1:2]
    else:
        amb_d = torch.zeros_like(base_color)
        amb_s = torch.zeros_like(base_color)
        spec_factor = torch.zeros_like(base_color)

    direct = lighting.base.punctual + shading.emissive
    unlit = workflow == float(sh.PBR_WORKFLOW_UNLIT)
    direct = torch.where(unlit, base_color, direct)
    amb_d = torch.where(unlit, zero, amb_d)
    amb_s = torch.where(unlit, zero, amb_s)
    spec_factor = torch.where(unlit, zero, spec_factor)

    ray = _camera_rays(info.camera, pad_w, pad_h, row0=row0, band_h=band_h)
    bg = sample_env_oct([env_oct], ray,
                        torch.zeros(ray.shape[:-1], device=dev))
    nrm_view = m3.transform_directions(nrm_px, info.camera.view)

    return GBufferData(
        depth=torch.where(hit, vb.depth, torch.ones((), device=dev)),
        mesh_id=torch.where(hit, node_id,
                            torch.full((), -1, dtype=torch.int32, device=dev)),
        normal_world=torch.where(hit_m, nrm_px, zero),
        normal_view=torch.where(hit_m, nrm_view, zero),
        base_color=torch.where(hit_m, base_color, zero),
        material_data=torch.where(
            hit_m, torch.cat([metallic, roughness, occlusion], dim=-1), zero),
        motion=motion,
        world_pos=pos_px,
        direct=torch.where(hit_m, direct, zero),
        ambient_diffuse=torch.where(hit_m, amb_d, zero),
        ambient_specular=torch.where(hit_m, amb_s, zero),
        spec_env_factor=torch.where(hit_m, spec_factor, zero),
        background=bg,
        hit=hit,
    )


def render_gbuffer(scene: ScenePrimitives, info: RenderInfo, ibl_maps,
                   env_oct, *, width: int, height: int, cfg: RasterizerConfig,
                   use_ibl: bool = True, use_lights: bool = True
                   ) -> GBufferData:
    """The G-buffer main pass (JAX deferred.py:111): the fused K1 raster
    and the shading of every pixel."""
    pad_w, pad_h = rz.pad_viewport(width, height, cfg)
    vb, fused_px = _fused_raster(scene, info, pad_w=pad_w, pad_h=pad_h,
                                 cfg=cfg)
    gb = _shade_band(scene, info, ibl_maps, env_oct, vb, fused_px,
                     pad_w=pad_w, pad_h=pad_h, use_ibl=use_ibl,
                     use_lights=use_lights)
    return _crop(gb, width, height)


def render_gbuffer_banded(scene: ScenePrimitives, info: RenderInfo, ibl_maps,
                          env_oct, *, width: int, height: int,
                          cfg: RasterizerConfig, bands: int = 4,
                          use_ibl: bool = True, use_lights: bool = True
                          ) -> GBufferData:
    """render_gbuffer as one raster of the padded frame and `bands`
    shading passes over its row bands, concatenated and cropped (JAX
    deferred.py:712).  `bands` drops to the largest count that divides
    the padded height.  Shading is pixel-local, so each band's rows equal
    render_gbuffer's."""
    pad_w, pad_h = rz.pad_viewport(width, height, cfg)
    while pad_h % bands:
        bands -= 1
    band_h = pad_h // bands
    vb, fused_px = _fused_raster(scene, info, pad_w=pad_w, pad_h=pad_h,
                                 cfg=cfg)
    parts = [_shade_band(scene, info, ibl_maps, env_oct, vb, fused_px,
                         pad_w=pad_w, pad_h=pad_h, use_ibl=use_ibl,
                         use_lights=use_lights, row0=b * band_h,
                         band_h=band_h)
             for b in range(bands)]
    gb = GBufferData(*(torch.cat(xs, dim=0) if xs[0] is not None else None
                       for xs in zip(*parts)))
    return _crop(gb, width, height)


def _crop(gb: GBufferData, width: int, height: int) -> GBufferData:
    """The G-buffer's viewport of the padded frame."""
    return GBufferData(*(x[:height, :width] if isinstance(x, Tensor) else x
                         for x in gb))
