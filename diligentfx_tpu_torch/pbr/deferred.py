"""Deferred G-buffer rendering (the port of diligentfx_tpu/pbr/deferred.py).

  1. visibility, on one of two paths:
     - fused: the fused raster kernel K1 rasterizes, interpolates the
       per-vertex attributes (with UV derivatives when textured) and
       fetches the material row per pixel (rasterize_fused, channel-first
       output); world position is reconstructed from the raster depth
       (the JAX package's default DFX_RECON=on behaviour);
     - two-pass: the tile raster K4 writes depth, triangle id and
       barycentrics (ops/raster.py rasterize), the ALPHA_MODE_MASK tail
       depth-merges through the K-layer alpha test (pbr/oit.py
       resolve_alpha_mask), and one gather interpolates the attributes,
       world position included; the UV derivatives come from
       `interpolate_with_derivs`;
  2. material textures (the atlas or the texture heap: base colour, normal
     map, phys-desc, emissive, occlusion with the LOD from the
     derivatives);
  3. shading, with the material extension layers the scene uses (clear
     coat, sheen, anisotropy, iridescence, transmission, volume), split
     into the layers the post chain composites: direct (punctual,
     shadowed by the cascaded shadow factor or by each light's own shadow
     slices, + emissive), ambient diffuse, ambient specular and the
     split-sum environment factor.

Shading is pixel-local, so it can run in row bands: `render_gbuffer_banded`
rasterizes the frame once and shades it band by band (the JAX package's
4K form, whose shading graph overwhelmed its compiler), and
`render_gbuffer_band_sp` rasterizes and shades one band's viewport window
alone (the building block of parallel/tiling.py).

The port reads no environment: the `fuse` arguments stand for the JAX
package's DFX_FUSE.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.components.shadow_map_manager import (
    cascaded_shadow_factors, light_shadow_factors)
from diligentfx_tpu_torch.config import RasterizerConfig
from diligentfx_tpu_torch.ops import raster as rz
from diligentfx_tpu_torch.ops.raster_kernel import raster_tiles_fused
from diligentfx_tpu_torch.ops.texture import (apply_uv_transform,
                                              sample_material_texture,
                                              texture_base_size)
from diligentfx_tpu_torch.ops.sampling import (bilinear_sample, dir_to_oct_uv,
                                               point_sample, sample_env_oct,
                                               upsample_bilinear)
from diligentfx_tpu_torch.pbr import brdf, shading as sh
from diligentfx_tpu_torch.pbr.renderer import (RenderInfo, ScenePrimitives,
                                               _camera_rays,
                                               transform_vertices)
from diligentfx_tpu_torch.postfx.context import reconstruct_world_pos

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
    debug: Optional[dict] = None


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


def _vertex_inputs(scene: ScenePrimitives, info: RenderInfo,
                   use_textures: bool = False, include_pos: bool = False):
    """Per-vertex data shared by the two paths: (clip, winv, packed attrs
    (V, C), n_ch) with attrs = [world position (3) when include_pos, world
    normal (3), previous clip x, y, w (3)] and, when textured, [uv (2),
    node-transformed tangent (3), tangent sign (1)] (JAX deferred.py:72;
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
    attrs = ([world_pos] if include_pos else []) + [world_nrm, prev_cxyw]
    if use_textures:
        attrs += [scene.uvs, _node_tangents(scene), scene.tangents[:, 3:4]]
    packed = torch.cat(attrs, dim=-1)
    return clip, winv, packed, packed.shape[1]


def _node_tangents(scene: ScenePrimitives) -> Tensor:
    """World tangents (V, 3) for the shading: transformed like normals
    (rigid / uniform scale) by the NODE matrices alone, skinned or not, as
    the JAX package does (deferred.py:97-102)."""
    vm = scene.node_matrices[scene.vertex_node.long()]
    t = scene.tangents
    return m3.normalize(t[:, 0:1] * vm[:, 0, :3] + t[:, 1:2] * vm[:, 1, :3]
                        + t[:, 2:3] * vm[:, 2, :3])


UV0 = 6     # channel of u in the packed attributes (after normal, prev clip)


def fused_raster_inputs(scene: ScenePrimitives, info: RenderInfo, *,
                        pad_w: int, pad_h: int, cfg: RasterizerConfig,
                        use_textures: bool = False, screen_size=None,
                        screen_offset=(0, 0)) -> rz.FusedKernelInputs:
    """Vertex stage + triangle setup + binning: the fused tile kernel's
    inputs for this scene and camera (per-triangle consts = material id,
    node id; the material table rides transposed; textured scenes add the
    UV derivative channels).  screen_size / screen_offset: the pad_w x
    pad_h framebuffer is the window at screen_offset of a screen_size
    frame (a row band)."""
    clip, winv, packed, n_ch = _vertex_inputs(scene, info, use_textures)
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
                            deriv_channels=((UV0, UV0 + 1) if use_textures
                                            else ()),
                            double_sided=scene.tri_double_sided[:n_op],
                            screen_size=screen_size,
                            screen_offset=screen_offset)


def _fused_raster(scene: ScenePrimitives, info: RenderInfo, *, pad_w: int,
                  pad_h: int, cfg: RasterizerConfig, use_textures: bool,
                  screen_size=None, screen_offset=(0, 0)):
    """Raster + in-kernel interpolation + material fetch.  Returns (vb,
    fused channels (C, H, W), stats)."""
    if scene.materials_anisotropy is not None and not use_textures:
        raise ValueError("anisotropy without textures needs the two-pass "
                         "route (fuse 'auto' or 'off'): the fused raster "
                         "carries no tangents")
    with torch.profiler.record_function("dfx.raster_inputs"):
        k = fused_raster_inputs(scene, info, pad_w=pad_w, pad_h=pad_h,
                                cfg=cfg, use_textures=use_textures,
                                screen_size=screen_size,
                                screen_offset=screen_offset)
    z, tid, out = raster_tiles_fused(k.setup, k.planes, k.candidates,
                                     k.counts, k.mat_table, k.rects,
                                     **k.kernel_kw)
    return rz.VisibilityBuffer(depth=z, tri_id=tid), out, k.stats


def _two_pass_raster(scene: ScenePrimitives, info: RenderInfo, *,
                     pad_w: int, pad_h: int, cfg: RasterizerConfig,
                     atlas, use_textures: bool):
    """The two-pass visibility (JAX deferred.py:133-142): K4 over the
    opaque prefix of the index buffer, then the alpha-mask resolve of the
    tail.  Returns (vb with barycentrics, clip, winv, packed attrs with
    world position)."""
    clip, winv, packed, _ = _vertex_inputs(scene, info, use_textures,
                                           include_pos=True)
    n_op = scene.num_opaque
    vb, _stats = rz.rasterize(clip, scene.indices[:n_op], width=pad_w,
                              height=pad_h, cfg=cfg,
                              double_sided=scene.tri_double_sided[:n_op])
    if scene.mask_indices is not None:
        from diligentfx_tpu_torch.pbr.oit import resolve_alpha_mask
        with torch.profiler.record_function("dfx.alpha_mask"):
            vb = resolve_alpha_mask(vb, clip, scene, winv, width=pad_w,
                                    height=pad_h, cfg=cfg, atlas=atlas,
                                    use_textures=use_textures)
    return vb, clip, winv, packed


def _fuse_ok(scene: ScenePrimitives, fuse: str, use_textures: bool) -> bool:
    """Whether the fused raster K1 serves this scene (JAX deferred.py:172):
    "on" and "off" force it (the port's stand-in for DFX_FUSE); "auto"
    fuses unless the scene has an alpha-mask tail, whose resolve rewrites
    the raster's winners, or anisotropy without textures: K1 then carries
    no tangents, and the two-pass route interpolates them from its
    barycentrics.  The JAX package fuses only on its accelerator; K1 has
    a plain version wherever the port runs, and the port has taken the
    fused path on every device since it began, so "auto" keeps that choice
    for the other scenes."""
    if fuse not in ("auto", "on", "off"):
        raise ValueError(f"fuse must be auto, on or off, got {fuse!r}")
    if fuse != "auto":
        return fuse == "on"
    return scene.mask_indices is None and (
        use_textures or scene.materials_anisotropy is None)


def _slot_sample(scene: ScenePrimitives, info: RenderInfo, atlas,
                 mat_id: Tensor, uv_px: Tensor, duv_dx: Tensor,
                 duv_dy: Tensor, slot: int):
    """(texel (H, W, 4), bound (H, W, 1)) of each pixel's material texture
    in `slot`, with the LOD from the UV derivatives scaled to the texture's
    base size (JAX deferred.py:342-365).  Unbound slots (-1) sample texture
    0 and are masked by `bound`."""
    s_tid = scene.tex_ids[mat_id, slot]
    bound = (s_tid >= 0)[..., None]
    xf = scene.tex_uv_transform[mat_id, slot]
    wraps = scene.tex_wraps[mat_id, slot]
    uv_t = apply_uv_transform(uv_px, xf[..., :4], xf[..., 4:6])
    safe = torch.clamp(s_tid, min=0)
    eff_w, eff_h = texture_base_size(atlas, safe)
    size = torch.stack([eff_w, eff_h], dim=-1)
    dx = duv_dx * size
    dy = duv_dy * size
    rho2 = torch.maximum(dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1],
                         dy[..., 0] * dy[..., 0] + dy[..., 1] * dy[..., 1])
    lod = 0.5 * torch.log2(torch.clamp(rho2, min=1e-12))
    lod = lod + info.renderer_params.mip_bias
    val = sample_material_texture(atlas, safe, uv_t, lod, wrap_u=wraps[..., 0],
                                  wrap_v=wraps[..., 1])
    return val, bound


def _shade_band(scene: ScenePrimitives, info: RenderInfo, ibl_maps, env_oct,
                vb, fused_px: Optional[Tensor], *, pad_w: int, pad_h: int,
                use_ibl: bool, use_lights: bool, fast_env: bool,
                atlas=None, use_textures: bool = False, shadow_mode=None,
                pcf_kernel_size: int = 3, light_shadow_kinds: tuple = (),
                two_pass=None, enable_clearcoat: bool = False,
                emit_debug: bool = False, row0: int = 0,
                band_h: Optional[int] = None,
                vb_local: bool = False) -> GBufferData:
    """Deferred shading of rows [row0, row0 + band_h) of the padded
    pad_h-row frame (JAX deferred.py:224; band_h None: the whole frame),
    from the fused kernel's channel-first output `fused_px`, or, when it
    is None, from the two-pass visibility `vb` (with barycentrics) and
    `two_pass` = (clip, winv, packed attrs with world position).  `vb` and
    `fused_px` cover the whole frame and the band's rows are sliced out,
    or with `vb_local` they hold the band's rows alone.  With
    `emit_debug`, `debug` carries the per-pixel products of the debug
    views (debug_payload).  Returns the PADDED band."""
    band_h = pad_h if band_h is None else band_h
    if band_h != pad_h and not vb_local:
        rows = slice(row0, row0 + band_h)
        vb = rz.VisibilityBuffer(
            depth=vb.depth[rows], tri_id=vb.tri_id[rows],
            bary=None if vb.bary is None else vb.bary[rows])
        if fused_px is not None:
            fused_px = fused_px[:, rows]
    dev = vb.depth.device
    hit = vb.tri_id >= 0
    hit_m = hit[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    izero = torch.zeros((), dtype=torch.int32, device=dev)

    if fused_px is not None:
        def grp(a, b):
            return torch.where(hit_m, torch.stack([fused_px[c] for c in
                                                   range(a, b)], dim=-1),
                               zero)

        # channels: normal (3) + previous clip (3) [+ uv (2), tangent (3),
        # sign]
        n_ch = UV0 + 6 if use_textures else UV0
        o = n_ch
        if use_textures:
            duv_dx = grp(o, o + 2)          # the kernel's derivative pairs,
            duv_dy = grp(o + 2, o + 4)      # grouped as the JAX package does
            o += 4
        mat_id = torch.where(hit, fused_px[o].to(torch.int32), izero)
        node_id = torch.where(hit, fused_px[o + 1].to(torch.int32), izero)
        m0 = o + 2                          # material-table row channels

        def mgrp(a, b):
            return grp(m0 + a, m0 + b)

        pos_px = reconstruct_world_pos(vb.depth, info.camera, row0=row0,
                                       full_h=pad_h)
        pos_px = torch.where(hit_m, pos_px, zero)
        ao = 0                              # channel of the normal
    else:
        clip, winv, packed = two_pass
        interp = rz.interpolate_all(vb, scene.indices, packed, winv)
        tid = torch.clamp(vb.tri_id, min=0).long()
        # node << 16 | material: both ride one per-pixel gather; the mesh-id
        # AOV is the node id, not the material slot
        tri_node = scene.vertex_node[scene.indices[:, 0].long()]
        tri_packed = (tri_node << 16) | scene.tri_material
        packed_px = tri_packed[tid]
        mat_id = packed_px & 0xFFFF
        node_id = packed_px >> 16
        mrow = _material_table(scene.materials)[mat_id.long()]

        def grp(a, b):
            return interp[..., a:b]

        def mgrp(a, b):
            return mrow[..., a:b]

        pos_px = grp(0, 3)
        ao = 3
        if use_textures and atlas is not None:
            # analytic UV derivatives, (du, dv) by x and by y
            setup_b = rz.bary_setup_from_clip(clip, scene.indices, pad_w,
                                              pad_h)
            _, duv_dx, duv_dy = rz.interpolate_with_derivs(
                vb, scene.indices, scene.uvs, setup_b, winv)
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

    if use_textures:
        uv_px = grp(ao + 6, ao + 8)
        tan_px = grp(ao + 8, ao + 11)
        tan_sign = grp(ao + 11, ao + 12)
    if use_textures and atlas is not None:
        slot_sample = functools.partial(_slot_sample, scene, info, atlas,
                                        mat_id.long(), uv_px, duv_dx, duv_dy)
        bc_t, bc_on = slot_sample(0)
        base_color = torch.where(
            bc_on, base_color * m3.srgb_to_linear(bc_t[..., :3]), base_color)
        n_t, n_on = slot_sample(1)
        # tangent-space normal perturbation (PerturbNormal analogue)
        t_b = m3.normalize(tan_px - nrm_px * m3.dot(tan_px, nrm_px))
        b_b = m3.cross(nrm_px, t_b) * tan_sign
        nscale = mgrp(9, 10)
        n_ts = n_t[..., :3] * 2.0 - 1.0
        n_ts = n_ts * torch.cat([nscale, nscale, torch.ones_like(nscale)],
                                dim=-1)
        n_mapped = m3.normalize(n_ts[..., 0:1] * t_b + n_ts[..., 1:2] * b_b
                                + n_ts[..., 2:3] * nrm_px)
        nrm_px = torch.where(n_on, n_mapped, nrm_px)
        pd_t, pd_on = slot_sample(2)
        roughness = torch.where(pd_on, roughness * pd_t[..., 1:2], roughness)
        metallic = torch.where(pd_on, metallic * pd_t[..., 2:3], metallic)
        em_t, em_on = slot_sample(3)
        emissive = torch.where(
            em_on, emissive * m3.srgb_to_linear(em_t[..., :3]), emissive)
        ao_t, ao_on = slot_sample(4)
        occl_strength = mgrp(10, 11)
        occlusion = torch.where(
            ao_on, 1.0 + occl_strength * (ao_t[..., 0:1] - 1.0), occlusion)

    view = m3.normalize(info.camera.position - pos_px)
    srf = sh.get_surface_reflectance_mr(base_color, metallic, roughness)
    workflow = mgrp(11, 12)
    is_sg = workflow == float(sh.PBR_WORKFLOW_SPECULAR_GLOSSINESS)
    srf_sg = sh.get_surface_reflectance_sg(base_color, mgrp(14, 17),
                                           1.0 - roughness)
    srf = brdf.SurfaceReflectanceInfo(*(torch.where(is_sg, b, a)
                                        for a, b in zip(srf, srf_sg)))
    ndotv = torch.clamp(m3.dot(nrm_px, view), 0.0, 1.0)

    # ---- the material extension layers (JAX deferred.py:417-497), each
    # on for the whole frame once a material of the scene uses it (the
    # analogue of the ENABLE_* macros) ---------------------------------------
    mid = mat_id.long()
    clearcoat = None
    if enable_clearcoat:
        clearcoat = sh.ClearcoatShadingInfo(
            srf=sh.get_surface_reflectance_clearcoat(mgrp(13, 14)),
            normal=nrm_px, factor=mgrp(12, 13))
    sheen = None
    if scene.materials_sheen is not None:
        ms = scene.materials_sheen
        sheen = sh.SheenShadingInfo(
            color=ms.color_factor[mid],
            roughness=torch.clamp(ms.roughness_factor[mid][..., None],
                                  min=0.03))
    anisotropy = None
    if scene.materials_anisotropy is not None:
        ma = scene.materials_anisotropy
        strength = ma.strength[mid][..., None]
        rot = ma.rotation[mid][..., None]
        if not use_textures:
            # the two-pass route (render_gbuffer): interpolate the tangents
            packed_t = torch.cat([_node_tangents(scene),
                                  scene.tangents[:, 3:4]], dim=-1)
            ti = rz.interpolate_all(vb, scene.indices, packed_t,
                                    two_pass[1])
            tan_v, tan_s = ti[..., :3], ti[..., 3:4]
        else:
            tan_v, tan_s = tan_px, tan_sign
        t_o = m3.normalize(tan_v - nrm_px * m3.dot(tan_v, nrm_px))
        b_o = m3.cross(nrm_px, t_o) * tan_s
        t_rot = m3.normalize(t_o * torch.cos(rot) + b_o * torch.sin(rot))
        b_rot = m3.normalize(m3.cross(nrm_px, t_rot))
        alpha_r = torch.clamp(roughness * roughness, min=1e-3)
        anisotropy = sh.AnisotropyShadingInfo(
            strength=strength, tangent=t_rot, bitangent=b_rot,
            alpha_roughness_t=torch.clamp(alpha_r * (1.0 + strength),
                                          min=1e-3),
            alpha_roughness_b=alpha_r)
    iridescence = None
    if scene.materials_iridescence is not None:
        mi = scene.materials_iridescence
        factor = mi.factor[mid][..., None]
        thickness = mi.thickness_maximum[mid][..., None]
        iri_f = brdf.iridescence_fresnel(1.0, mi.ior[mid][..., None],
                                         srf.reflectance0, thickness, ndotv)
        iri_f0 = brdf.schlick_to_f0(ndotv, iri_f, torch.ones_like(iri_f))
        # the base F0 mixed toward the thin film's (RenderPBR.psh:236-255)
        srf = srf._replace(reflectance0=srf.reflectance0
                           + (iri_f0 - srf.reflectance0) * factor)
        iridescence = sh.IridescenceShadingInfo(
            factor=factor, thickness=thickness, fresnel=iri_f, f0=iri_f0)
    transmission = None
    if scene.materials_transmission is not None:
        transmission = scene.materials_transmission.factor[mid][..., None]
    volume_thickness = volume_attenuation = None
    if scene.materials_volume is not None:
        mv = scene.materials_volume
        volume_thickness = mv.thickness_factor[mid][..., None]
        # Beer-Lambert sigma_t = -ln(attenuation colour) / distance, a
        # material's row
        sigma = (-torch.log(torch.clamp(mv.attenuation_color, min=1e-4))
                 / torch.clamp(mv.attenuation_distance[..., None],
                               min=1e-6))
        volume_attenuation = sigma[mid]

    rp = info.renderer_params
    shading = sh.SurfaceShadingInfo(
        pos=pos_px, view=view, occlusion=occlusion,
        emissive=emissive * rp.emission_scale,
        base=sh.BaseLayerShadingInfo(srf=srf, metallic=metallic,
                                     normal=nrm_px, ndotv=ndotv),
        ibl_scale=rp.ibl_scale[:3], clearcoat=clearcoat, sheen=sheen,
        anisotropy=anisotropy, iridescence=iridescence,
        transmission=transmission, volume_thickness=volume_thickness,
        volume_attenuation=volume_attenuation)
    # the sheen albedo-scaling LUT stays out, as in the JAX package's
    # deferred shading (its crude fallback)
    lighting = sh.default_lighting(pos_px, with_sheen=sheen is not None,
                                   with_clearcoat=clearcoat is not None)
    if use_lights:
        shadow_factors = None
        if light_shadow_kinds:
            shadow_factors = light_shadow_factors(pos_px, info,
                                                  light_shadow_kinds,
                                                  shadow_mode,
                                                  pcf_kernel_size)
        elif shadow_mode is not None:
            shadow_factors = cascaded_shadow_factors(pos_px, info,
                                                     shadow_mode,
                                                     pcf_kernel_size)
        lighting = sh.apply_punctual_lights(shading, info.lights, lighting,
                                            shadow_factors=shadow_factors)

    scale = rp.ibl_scale[:3]
    if use_ibl and ibl_maps is not None:
        lighting = sh.apply_ibl(shading, ibl_maps, lighting, fast_env=fast_env)
        amb_d = lighting.base.diffuse_ibl * scale
        amb_s = lighting.base.specular_ibl * scale
        # the split-sum factor SSR substitutes with: the iridescent F0 mix
        # in, the iridescence k_s mix out, as in the JAX package
        if fast_env and ibl_maps.env_brdf_coeffs is not None:
            pre_int = brdf.env_brdf_fitted(ndotv, srf.perceptual_roughness,
                                           ibl_maps.env_brdf_coeffs)
        else:
            pre_int = bilinear_sample(ibl_maps.preintegrated_ggx,
                                      torch.cat([ndotv,
                                                 srf.perceptual_roughness],
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
    # the extension layers fold into the direct / ambient split as
    # ResolveLighting composes them (PBR_Shading.fxh:847-879)
    if sheen is not None and lighting.sheen is not None:
        direct = direct + lighting.sheen.punctual
        amb_s = amb_s + lighting.sheen.specular_ibl * scale
    if clearcoat is not None and lighting.clearcoat is not None:
        cc_ndotv = torch.clamp(m3.dot(clearcoat.normal, view), min=0.1)
        cc_fresnel = brdf.schlick_reflection(
            cc_ndotv, clearcoat.srf.reflectance0[..., 0:1],
            clearcoat.srf.reflectance90[..., 0:1])
        atten = 1.0 - clearcoat.factor * cc_fresnel
        direct = (direct * atten
                  + lighting.clearcoat.punctual * clearcoat.factor)
        amb_d = amb_d * atten
        amb_s = (amb_s * atten
                 + lighting.clearcoat.specular_ibl * scale * clearcoat.factor)

    ray = _camera_rays(info.camera, pad_w, pad_h, row0=row0, band_h=band_h)
    if fast_env:
        # half-res point taps + bilinear phase upsample of the background
        bg2 = point_sample(env_oct, dir_to_oct_uv(ray[::2, ::2]))
        bg = upsample_bilinear(bg2, 2, 2)[:band_h, :pad_w]
    else:
        bg = sample_env_oct([env_oct], ray,
                            torch.zeros(ray.shape[:-1], device=dev))
    nrm_view = m3.transform_directions(nrm_px, info.camera.view)
    debug = None
    if emit_debug:
        debug = debug_payload(
            uv_px if use_textures else torch.zeros_like(motion), mgrp(3, 4),
            emissive, srf, ndotv, clearcoat, sheen, anisotropy, iridescence,
            transmission, volume_thickness, lighting)

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
        debug=debug,
    )


def debug_payload(texcoord0, transparency, emissive, srf, ndotv, clearcoat,
                  sheen, anisotropy, iridescence, transmission,
                  volume_thickness, lighting) -> dict:
    """The per-pixel products of the debug views that the G-buffer's other
    AOVs do not carry (JAX deferred.py:617-657; PBR_Renderer.hpp:401-439):
    21 entries, zeros for an extension the scene does not use, as a shader
    compiled without it renders it."""
    z1 = torch.zeros_like(ndotv)
    z3 = torch.zeros_like(emissive)

    def of(layer, name, zero):
        return getattr(layer, name) if layer is not None else zero
    return dict(
        texcoord0=texcoord0, transparency=transparency, emissive=emissive,
        diffuse_color=srf.diffuse_color, specular_color=srf.reflectance0,
        reflectance90=srf.reflectance90, ndotv=ndotv,
        clearcoat_factor=of(clearcoat, "factor", z1),
        clearcoat_roughness=(clearcoat.srf.perceptual_roughness
                             if clearcoat is not None else z1),
        clearcoat_normal=of(clearcoat, "normal", z3),
        clearcoat_lit=of(lighting.clearcoat, "punctual", z3),
        sheen_color=of(sheen, "color", z3),
        sheen_roughness=of(sheen, "roughness", z1),
        sheen_lit=of(lighting.sheen, "punctual", z3),
        anisotropy_strength=of(anisotropy, "strength", z1),
        anisotropy_direction=of(anisotropy, "tangent", z3),
        iridescence_fresnel=of(iridescence, "fresnel", z3),
        iridescence_factor=of(iridescence, "factor", z1),
        iridescence_thickness=of(iridescence, "thickness", z1),
        transmission=transmission if transmission is not None else z1,
        thickness=volume_thickness if volume_thickness is not None else z1)


def _vis_only_gbuffer(vb) -> GBufferData:
    """The visibility-only G-buffer of `vis_only` (JAX deferred.py:135-153):
    the raster's depth and triangle id, every other channel filled with
    depth-derived values so the effects downstream still do their work."""
    hit = vb.tri_id >= 0
    d1 = torch.where(hit, vb.depth, torch.ones((), device=vb.depth.device))
    c1 = d1[..., None]
    c3 = torch.cat([c1, c1, c1], dim=-1)
    return GBufferData(
        depth=d1, mesh_id=vb.tri_id, normal_world=c3, normal_view=c3,
        base_color=c3, material_data=c3,
        motion=torch.cat([c1, c1], dim=-1) * 1e-3, world_pos=c3, direct=c3,
        ambient_diffuse=c3, ambient_specular=c3, spec_env_factor=c3,
        background=c3, hit=hit)


def render_gbuffer(scene: ScenePrimitives, info: RenderInfo, ibl_maps,
                   env_oct, *, width: int, height: int, cfg: RasterizerConfig,
                   use_ibl: bool = True, use_lights: bool = True,
                   shadow_mode=None, pcf_kernel_size: int = 3, atlas=None,
                   use_textures: bool = False, enable_clearcoat: bool = False,
                   fast_env: bool = False, emit_debug: bool = False,
                   light_shadow_kinds: tuple = (),
                   fuse: str = "auto", vis_only: bool = False
                   ) -> GBufferData:
    """The G-buffer main pass (JAX deferred.py:111): the fused K1 raster
    with UV derivatives when textured, or the two-pass K4 raster with the
    alpha-mask resolve (`_fuse_ok` chooses; "auto" takes the two-pass path
    for a scene with a mask tail), material textures from a TextureAtlas or
    a TextureHeap, and the lights' shadows: with `light_shadow_kinds`, each
    light by its kind (components/shadow_map_manager.py
    light_shadow_factors: info carries the per-light slices, and the
    cascades for "csm"), else the cascaded shadow factor when
    `shadow_mode` is set (info carries the shadow attribs, maps and
    moments).  The scene's material extensions (sheen, anisotropy,
    iridescence, transmission, volume) and, with `enable_clearcoat`, the
    clear coat of the material table shade every pixel once present;
    skinned scenes blend their joints in the vertex stage.  `emit_debug`
    adds the debug views' payload (`debug`); `vis_only` stops after the
    raster (_vis_only_gbuffer), a profiling switch."""
    if shadow_mode is not None and info.shadow_attribs is None:
        raise ValueError("shadow_mode needs info.shadow_attribs and maps")
    pad_w, pad_h = rz.pad_viewport(width, height, cfg)
    vb, fused_px, two_pass = _raster_stage(scene, info, atlas, pad_w=pad_w,
                                           pad_h=pad_h, cfg=cfg,
                                           use_textures=use_textures,
                                           fuse=fuse)
    if vis_only:
        return _crop(_vis_only_gbuffer(vb), width, height)
    gb = _shade_band(scene, info, ibl_maps, env_oct, vb, fused_px,
                     pad_w=pad_w, pad_h=pad_h, use_ibl=use_ibl,
                     use_lights=use_lights, fast_env=fast_env, atlas=atlas,
                     use_textures=use_textures, shadow_mode=shadow_mode,
                     pcf_kernel_size=pcf_kernel_size,
                     light_shadow_kinds=light_shadow_kinds,
                     two_pass=two_pass, enable_clearcoat=enable_clearcoat,
                     emit_debug=emit_debug)
    return _crop(gb, width, height)


def _raster_stage(scene: ScenePrimitives, info: RenderInfo, atlas, *,
                  pad_w: int, pad_h: int, cfg: RasterizerConfig,
                  use_textures: bool, fuse: str = "auto"):
    """The G-buffer's visibility over the whole padded frame (JAX
    deferred.py:680): the fused K1 raster, or the two-pass K4 raster with
    the alpha-mask resolve (`_fuse_ok` chooses).  Returns (vb, fused
    channels or None, two_pass = (clip, winv, packed attrs) or None)."""
    if _fuse_ok(scene, fuse, use_textures):
        vb, fused_px, _stats = _fused_raster(
            scene, info, pad_w=pad_w, pad_h=pad_h, cfg=cfg,
            use_textures=use_textures)
        return vb, fused_px, None
    vb, *two_pass = _two_pass_raster(scene, info, pad_w=pad_w, pad_h=pad_h,
                                     cfg=cfg, atlas=atlas,
                                     use_textures=use_textures)
    return vb, None, two_pass


def render_gbuffer_banded(scene: ScenePrimitives, info: RenderInfo, ibl_maps,
                          env_oct, *, width: int, height: int,
                          cfg: RasterizerConfig, bands: int = 4,
                          use_ibl: bool = True, use_lights: bool = True,
                          shadow_mode=None, pcf_kernel_size: int = 3,
                          atlas=None, use_textures: bool = False,
                          enable_clearcoat: bool = False,
                          fast_env: bool = False,
                          light_shadow_kinds: tuple = (),
                          fuse: str = "auto") -> GBufferData:
    """render_gbuffer as one raster of the padded frame and `bands`
    shading passes over its row bands, concatenated and cropped (JAX
    deferred.py:712).  `bands` drops to the largest count that divides
    the padded height.  Shading is pixel-local, so each band's rows equal
    render_gbuffer's, but for fast_env's background, whose half-resolution
    upsample edge-clamps at each band's last row."""
    if shadow_mode is not None and info.shadow_attribs is None:
        raise ValueError("shadow_mode needs info.shadow_attribs and maps")
    pad_w, pad_h = rz.pad_viewport(width, height, cfg)
    while pad_h % bands:
        bands -= 1
    band_h = pad_h // bands
    vb, fused_px, two_pass = _raster_stage(scene, info, atlas, pad_w=pad_w,
                                           pad_h=pad_h, cfg=cfg,
                                           use_textures=use_textures,
                                           fuse=fuse)
    parts = [_shade_band(scene, info, ibl_maps, env_oct, vb, fused_px,
                         pad_w=pad_w, pad_h=pad_h, use_ibl=use_ibl,
                         use_lights=use_lights, fast_env=fast_env,
                         atlas=atlas, use_textures=use_textures,
                         shadow_mode=shadow_mode,
                         pcf_kernel_size=pcf_kernel_size,
                         light_shadow_kinds=light_shadow_kinds,
                         two_pass=two_pass,
                         enable_clearcoat=enable_clearcoat, row0=b * band_h,
                         band_h=band_h)
             for b in range(bands)]
    gb = GBufferData(*(torch.cat(xs, dim=0) if xs[0] is not None else None
                       for xs in zip(*parts)))
    return _crop(gb, width, height)


def render_gbuffer_band_sp(scene: ScenePrimitives, info: RenderInfo,
                           ibl_maps, env_oct, *, width: int, band_h: int,
                           full_height: int, band_y0: int,
                           cfg: RasterizerConfig, use_ibl: bool = True,
                           use_lights: bool = True, shadow_mode=None,
                           pcf_kernel_size: int = 3, atlas=None,
                           use_textures: bool = False,
                           enable_clearcoat: bool = False,
                           fast_env: bool = False,
                           light_shadow_kinds: tuple = (),
                           fuse: str = "auto") -> GBufferData:
    """One row band of the G-buffer (JAX deferred.py:749): raster the
    band's viewport window, rows [band_y0, band_y0 + band_h) of a
    width x full_height frame (K1 or K4 at screen_offset (0, band_y0)),
    and shade it band-locally.  As in the JAX package, the two-pass route
    rasterizes the opaque prefix without the alpha-mask resolve."""
    if width % cfg.tile_w or band_h % cfg.tile_h:
        raise ValueError(f"a {width} x {band_h} band is not tile-aligned "
                         f"({cfg.tile_w} x {cfg.tile_h} tiles)")
    if shadow_mode is not None and info.shadow_attribs is None:
        raise ValueError("shadow_mode needs info.shadow_attribs and maps")
    window = dict(screen_size=(width, full_height),
                  screen_offset=(0, int(band_y0)))
    two_pass = None
    if _fuse_ok(scene, fuse, use_textures):
        vb, fused_px, _stats = _fused_raster(
            scene, info, pad_w=width, pad_h=band_h, cfg=cfg,
            use_textures=use_textures, **window)
    else:
        clip, winv, packed, _ = _vertex_inputs(scene, info, use_textures,
                                               include_pos=True)
        n_op = scene.num_opaque
        vb, _stats = rz.rasterize(clip, scene.indices[:n_op], width=width,
                                  height=band_h, cfg=cfg,
                                  double_sided=scene.tri_double_sided[:n_op],
                                  **window)
        fused_px, two_pass = None, (clip, winv, packed)
    return _shade_band(scene, info, ibl_maps, env_oct, vb, fused_px,
                       pad_w=width, pad_h=full_height, use_ibl=use_ibl,
                       use_lights=use_lights, fast_env=fast_env, atlas=atlas,
                       use_textures=use_textures, shadow_mode=shadow_mode,
                       pcf_kernel_size=pcf_kernel_size,
                       light_shadow_kinds=light_shadow_kinds,
                       two_pass=two_pass, enable_clearcoat=enable_clearcoat,
                       row0=int(band_y0), band_h=band_h, vb_local=True)


def _crop(gb: GBufferData, width: int, height: int) -> GBufferData:
    """The G-buffer's (and its debug payload's) viewport of the padded
    frame."""
    def crop(x):
        if isinstance(x, dict):
            return {k: crop(v) for k, v in x.items()}
        return x[:height, :width] if isinstance(x, torch.Tensor) else x
    return GBufferData(*(crop(x) for x in gb))
