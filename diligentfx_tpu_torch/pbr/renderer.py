"""Scene packing, vertex stage and the forward renderer (the port of
diligentfx_tpu/pbr/renderer.py).

The whole scene is one "mega draw": a vertex/index soup with per-vertex
node ids and per-triangle material ids.  PBRRenderer owns the environment
map and the precomputed IBL resources, and `render` draws one forward
frame: vertex stage -> raster (the fused kernel K1, or the two-pass
kernel K4 + interpolate_all) -> per-pixel material -> shading with the
cascaded shadow factor -> background -> tone map -> sRGB.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                          PBRMaterialBasicAttribs,
                                          PBRRendererShaderParameters,
                                          stack_materials)
from diligentfx_tpu_torch.components.shadow_map_manager import \
    cascaded_shadow_factors
from diligentfx_tpu_torch.config import (DebugViewType, PBRRendererCreateInfo,
                                         PSOFlags, RasterizerConfig,
                                         ShadowMode, ToneMappingMode)
from diligentfx_tpu_torch.device import resolve_device
from diligentfx_tpu_torch.gltf.primitives import MeshData
from diligentfx_tpu_torch.ops import raster as rz
from diligentfx_tpu_torch.ops.sampling import oct_pixel_dirs, sample_env_oct
from diligentfx_tpu_torch.pbr import shading as sh
from diligentfx_tpu_torch.pbr.ibl import precompute_ibl_maps
from diligentfx_tpu_torch.postfx.tonemap import ToneMappingAttribs, tone_map
from diligentfx_tpu_torch.utils.cache import (ibl_cache_key, load_ibl_maps,
                                              save_ibl_maps)

Tensor = torch.Tensor


class ScenePrimitives(NamedTuple):
    """Packed scene (JAX renderer.py:47).

    materials_sheen ... materials_volume: the stacked extension attribs
    (attribs.py), each None when no material uses it.  joints (V, 4) int32
    (-1 for an unskinned vertex) and weights (V, 4) blend the world-space
    joint matrices (J, 4, 4) (inverse bind @ joint world, from the host);
    prev_joint_matrices are the previous frame's, for motion vectors.

    mask_indices: the ALPHA_MODE_MASK triangles, which are the TAIL of
    `indices` (the opaque raster takes indices[:T - Tm]; the tail goes
    through the K-layer alpha test, pbr/oit.py resolve_alpha_mask).
    blend_indices / blend_tri_material: the ALPHA_MODE_BLEND geometry,
    rendered through K-layer OIT by the task manager."""
    positions: Tensor       # (V, 3) object space
    normals: Tensor         # (V, 3)
    uvs: Tensor             # (V, 2)
    tangents: Tensor        # (V, 4)
    indices: Tensor         # (T, 3) int32
    vertex_node: Tensor     # (V,) int32
    tri_material: Tensor    # (T,) int32
    tri_double_sided: Tensor  # (T,) bool
    node_matrices: Tensor   # (N, 4, 4) current world transforms
    prev_node_matrices: Tensor  # (N, 4, 4) previous frame
    materials: PBRMaterialBasicAttribs  # stacked
    tex_ids: Optional[Tensor] = None
    tex_uv_transform: Optional[Tensor] = None
    tex_wraps: Optional[Tensor] = None
    materials_sheen: object = None
    materials_anisotropy: object = None
    materials_iridescence: object = None
    materials_transmission: object = None
    materials_volume: object = None
    blend_indices: Optional[Tensor] = None
    blend_tri_material: Optional[Tensor] = None
    mask_indices: Optional[Tensor] = None
    joints: Optional[Tensor] = None
    weights: Optional[Tensor] = None
    joint_matrices: Optional[Tensor] = None
    prev_joint_matrices: Optional[Tensor] = None

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def num_opaque(self) -> int:
        """The opaque prefix of `indices`: all but the mask tail."""
        return self.indices.shape[0] - (self.mask_indices.shape[0]
                                        if self.mask_indices is not None
                                        else 0)


def build_scene(meshes: Sequence[Tuple[MeshData, np.ndarray,
                                       PBRMaterialBasicAttribs]],
                double_sided_flags: Optional[Sequence[bool]] = None,
                device=None) -> ScenePrimitives:
    """Pack (mesh, node_matrix, material) tuples into one ScenePrimitives on
    `device` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    pos, nrm, uv, tan, idx = [], [], [], [], []
    vnode, tmat, tds, mats, nodes = [], [], [], [], []
    v_off = 0
    for i, (mesh, node, mat) in enumerate(meshes):
        pos.append(mesh.positions)
        nrm.append(mesh.normals)
        uv.append(mesh.uvs)
        tan.append(mesh.tangents)
        idx.append(mesh.indices + v_off)
        nv, nt = mesh.positions.shape[0], mesh.indices.shape[0]
        vnode.append(np.full(nv, i, np.int32))
        tmat.append(np.full(nt, i, np.int32))
        ds = double_sided_flags[i] if double_sided_flags else False
        tds.append(np.full(nt, ds, bool))
        nodes.append(np.asarray(node, np.float32))
        mats.append(mat)
        v_off += nv

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    node_m = t(np.stack(nodes))
    idx_np = np.concatenate(idx)
    tmat_np = np.concatenate(tmat)
    tds_np = np.concatenate(tds)
    # ALPHA_MODE_MASK triangles move to the tail so the opaque raster can
    # exclude them with a slice (see ScenePrimitives.mask_indices)
    is_mask = np.array([int(m.alpha_mode) == 1 for m in mats])[tmat_np]
    mask_idx = None
    if is_mask.any():
        order = np.argsort(is_mask, kind="stable")
        idx_np, tmat_np, tds_np = idx_np[order], tmat_np[order], tds_np[order]
        mask_idx = t(idx_np[-int(is_mask.sum()):], torch.int32)
    return ScenePrimitives(
        positions=t(np.concatenate(pos), torch.float32),
        normals=t(np.concatenate(nrm), torch.float32),
        uvs=t(np.concatenate(uv), torch.float32),
        tangents=t(np.concatenate(tan), torch.float32),
        indices=t(idx_np, torch.int32),
        vertex_node=t(np.concatenate(vnode), torch.int32),
        tri_material=t(tmat_np, torch.int32),
        tri_double_sided=t(tds_np, torch.bool),
        mask_indices=mask_idx,
        node_matrices=node_m,
        prev_node_matrices=node_m,
        materials=stack_materials(mats, dev),
    )


class RenderInfo(NamedTuple):
    """Dynamic per-frame inputs (GLTF_PBR_Renderer::RenderInfo + the frame
    constants).  shadow_attribs / shadow_maps / shadow_moments are the
    cascaded shadow pass's products; light_shadow_maps (K, S, S) and
    light_shadow_view_projs (K, 4, 4) the per-light slices in light order
    (components/shadow_atlas.py packed_for_lights), which the deferred
    G-buffer reads."""
    camera: CameraAttribs
    lights: PBRLightAttribs
    renderer_params: PBRRendererShaderParameters
    model_transform: Optional[Tensor] = None
    shadow_attribs: object = None
    shadow_maps: Optional[Tensor] = None
    shadow_moments: Optional[Tensor] = None
    light_shadow_maps: Optional[Tensor] = None
    light_shadow_view_projs: Optional[Tensor] = None
    prev_view_proj: Optional[Tensor] = None


def transform_vertices(scene: ScenePrimitives, model: Optional[Tensor] = None,
                       previous: bool = False):
    """Vertex stage: node matrix per vertex + batched exact-fp32 transform;
    with skinning data, the four-joint blend of the current (or, with
    `previous`, the previous frame's) joint matrices replaces the node
    matrix of every vertex whose weights sum above 1e-6 (JAX
    renderer.py:187-196; RenderPBR.vsh).  The blend is fp32 multiply-adds,
    w0 M[j0] + ... + w3 M[j3], in the range dfx.skinning.
    Returns (world_pos (V,3), world_normal (V,3), world_tangent (V,3))."""
    mats = scene.prev_node_matrices if previous else scene.node_matrices
    if model is not None:
        mats = torch.stack([m3.mul44(m, model) for m in mats])
    vm = mats.reshape(-1, 16)[scene.vertex_node.long()].reshape(-1, 4, 4)
    if scene.joints is not None:
        with torch.profiler.record_function("dfx.skinning"):
            jm = (scene.prev_joint_matrices
                  if previous and scene.prev_joint_matrices is not None
                  else scene.joint_matrices).reshape(-1, 16)
            jidx = torch.clamp(scene.joints, min=0).long()
            jw = scene.weights
            skin_m = jw[:, 0:1] * jm[jidx[:, 0]]
            for k in range(1, 4):
                skin_m = skin_m + jw[:, k:k + 1] * jm[jidx[:, k]]
            skinned = torch.sum(jw, dim=-1, keepdim=True) > 1e-6
            vm = torch.where(skinned[..., None], skin_m.reshape(-1, 4, 4),
                             vm)
    p = scene.positions
    world = (p[:, 0:1] * vm[:, 0, :3] + p[:, 1:2] * vm[:, 1, :3]
             + p[:, 2:3] * vm[:, 2, :3] + vm[:, 3, :3])

    def dir3(d):
        return (d[:, 0:1] * vm[:, 0, :3] + d[:, 1:2] * vm[:, 1, :3]
                + d[:, 2:3] * vm[:, 2, :3])

    return (world, m3.normalize(dir3(scene.normals)),
            m3.normalize(dir3(scene.tangents[:, :3])))


def _camera_rays(camera: CameraAttribs, width: int, height: int,
                 row0: int = 0, band_h: Optional[int] = None) -> Tensor:
    """World-space view ray per pixel (JAX renderer.py:418)."""
    dev = camera.view_proj_inv.device
    x = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width \
        * 2.0 - 1.0
    rows = torch.arange(band_h if band_h is not None else height,
                        dtype=torch.float32, device=dev) + float(row0)
    y = 1.0 - (rows + 0.5) / height * 2.0
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    ndc = torch.stack([xx, yy, torch.full_like(xx, 0.5), torch.ones_like(xx)],
                      dim=-1)
    world = m3.vec_mat4(ndc, camera.view_proj_inv)
    world = world[..., :3] / world[..., 3:4]
    return m3.normalize(world - camera.position)


def default_env_oct(device=None) -> Tensor:
    """The default gradient sky (128^2 octahedral)."""
    d = oct_pixel_dirs(128, device)
    sky = torch.tensor([0.35, 0.5, 0.85], device=device)
    ground = torch.tensor([0.18, 0.16, 0.14], device=device)
    t = d[..., 1:2] * 0.5 + 0.5
    return ground + (sky - ground) * t


class PBRRenderer:
    """Owns the environment map and precomputed IBL resources and renders
    forward frames (JAX renderer.py:208; PBR_Renderer construction +
    PrecomputeCubemaps + the GLTF render loop)."""

    def __init__(self, ci: PBRRendererCreateInfo = PBRRendererCreateInfo(),
                 env_oct: Optional[Tensor] = None,
                 raster_cfg: RasterizerConfig = RasterizerConfig(),
                 device=None, ibl_maps=None,
                 ibl_cache_dir: Optional[str] = None):
        """`ibl_maps`, when given, are used as they are; else, with
        `ibl_cache_dir`, the maps of this env map and precompute size are
        read from that directory (utils/cache.py) or precomputed and saved
        there."""
        self.device = resolve_device(device)
        self.ci = ci
        self.raster_cfg = raster_cfg
        self.env_oct = (default_env_oct(self.device) if env_oct is None
                        else env_oct.to(self.device))
        if ibl_maps is not None:
            self.ibl_maps = ibl_maps
        elif ci.enable_ibl:
            cache_path = None
            if ibl_cache_dir:
                cache_path = os.path.join(
                    ibl_cache_dir, f"ibl_{ibl_cache_key(self.env_oct, ci)}.npz")
                cached = load_ibl_maps(cache_path, self.device)
                if cached is not None:
                    self.ibl_maps = cached
                    return
            self.ibl_maps = precompute_ibl_maps(
                self.env_oct, brdf_lut_dim=ci.brdf_lut_dim,
                num_brdf_samples=ci.num_brdf_samples,
                irradiance_dim=ci.irradiance_cube_dim,
                prefiltered_dim=ci.prefiltered_env_map_dim,
                num_spec_samples=ci.num_specular_env_samples)
            if cache_path:
                save_ibl_maps(cache_path, self.ibl_maps)
        else:
            self.ibl_maps = None

    def render(self, scene: ScenePrimitives, info: RenderInfo, *,
               width: int, height: int, flags: PSOFlags = None,
               debug_view: DebugViewType = DebugViewType.NONE,
               tone_mapping_mode: ToneMappingMode = ToneMappingMode.UNCHARTED2,
               convert_output_to_srgb: bool = True,
               shadow_mode: ShadowMode = None, fuse: str = "auto") -> Tensor:
        """Render one forward frame -> (height, width, 3) (JAX
        renderer.py:257).  fuse="auto" takes the fused raster K1 on CUDA and
        the two-pass path on the CPU, as the JAX package takes the fused
        kernel on its accelerator only, and the two-pass path wherever the
        scene has an alpha-mask tail (its resolve rewrites the raster's
        winners); "on" and "off" force a branch ("off" runs K4 on the
        card; "on" rasterizes the opaque prefix alone).  The fused branch
        raises ValueError where a material tensor requires grad: its kernel
        carries no gradient."""
        if flags is None:
            flags = PSOFlags.DEFAULT()
        use_shadows = bool(self.ci.enable_shadows
                           and info.shadow_attribs is not None)
        return _render_frame(
            scene, info, self.ibl_maps, self.env_oct, width=width,
            height=height, cfg=self.raster_cfg,
            use_ibl=bool(self.ci.enable_ibl and (PSOFlags.USE_IBL in flags)),
            use_lights=bool(PSOFlags.USE_LIGHTS in flags),
            debug_view=debug_view,
            tone_mapping_mode=(tone_mapping_mode
                               if PSOFlags.ENABLE_TONE_MAPPING in flags
                               else ToneMappingMode.NONE),
            convert_output_to_srgb=convert_output_to_srgb,
            shadow_mode=(shadow_mode or ShadowMode.PCF) if use_shadows
            else None,
            pcf_kernel_size=self.ci.pcf_kernel_size, fuse=fuse)


def _render_frame(scene: ScenePrimitives, info: RenderInfo, ibl_maps, env_oct,
                  *, width: int, height: int, cfg: RasterizerConfig,
                  use_ibl: bool, use_lights: bool, debug_view: DebugViewType,
                  tone_mapping_mode: ToneMappingMode,
                  convert_output_to_srgb: bool, shadow_mode=None,
                  pcf_kernel_size: int = 3, fuse: str = "auto") -> Tensor:
    """The forward frame (JAX renderer.py:296); a debug view replaces the
    colour before the tone map (_debug_color)."""
    if fuse not in ("auto", "on", "off"):
        raise ValueError(f"fuse must be auto, on or off, got {fuse!r}")
    pad_w, pad_h = rz.pad_viewport(width, height, cfg)
    dev = scene.positions.device

    # ---- vertex stage -----------------------------------------------------
    world_pos, world_nrm, _ = transform_vertices(scene, info.model_transform)
    clip = m3.transform_points(world_pos, info.camera.view_proj)
    w = clip[:, 3]
    winv = torch.where(torch.abs(w) > 1e-12, 1.0 / w, torch.zeros_like(w))
    packed_attrs = torch.cat([world_pos, world_nrm], dim=-1)
    # the opaque prefix of the index buffer; the ALPHA_MODE_MASK tail
    # resolves after the raster (the fused branch, forced on, drops it as
    # the JAX package's does)
    n_op = scene.num_opaque
    fused = fuse == "on" or (fuse == "auto" and dev.type == "cuda"
                             and scene.mask_indices is None)
    if fused and torch.is_grad_enabled() and any(
            isinstance(t, Tensor) and t.requires_grad
            for t in scene.materials):
        # K1 fetches the material table in the kernel, whose outputs carry
        # no gradient; its plain version on the CPU would carry one
        raise ValueError("the fused raster (K1) drops the material "
                         "table's gradient; render with fuse=\"off\" to "
                         "differentiate the material parameters")
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if fused:
        # fused raster + interpolation + material fetch (K1)
        from diligentfx_tpu_torch.pbr.deferred import _material_table
        consts = scene.tri_material[:n_op].to(torch.float32)[:, None]
        vb, fused_cx, _stats = rz.rasterize_fused(
            clip, scene.indices[:n_op], packed_attrs, winv, consts,
            _material_table(scene.materials).t().contiguous(),
            width=pad_w, height=pad_h, cfg=cfg, n_ch=6,
            double_sided=scene.tri_double_sided[:n_op])
        hit = vb.tri_id >= 0
        hm = hit[..., None]

        def grp(a, b, o=0):
            g = torch.stack([fused_cx[c] for c in range(o + a, o + b)], -1)
            return torch.where(hm, g, zero)

        interp = grp(0, 6)
        m0 = 7                                   # after the one const
        base_color = grp(0, 3, m0)
        emissive = grp(4, 7, m0)
        metallic = grp(7, 8, m0)
        roughness = grp(8, 9, m0)
    else:
        # two-pass: the K4 raster [+ the alpha-mask resolve of the tail],
        # then one interpolation gather
        vb, _stats = rz.rasterize(clip, scene.indices[:n_op], width=pad_w,
                                  height=pad_h, cfg=cfg,
                                  double_sided=scene.tri_double_sided[:n_op])
        if scene.mask_indices is not None:
            from diligentfx_tpu_torch.pbr.oit import resolve_alpha_mask
            vb = resolve_alpha_mask(vb, clip, scene, winv, width=pad_w,
                                    height=pad_h, cfg=cfg)
        interp = rz.interpolate_all(vb, scene.indices, packed_attrs, winv)
        hit = vb.tri_id >= 0
        mat_id = scene.tri_material[torch.clamp(vb.tri_id, min=0).long()]
        mats = scene.materials
        mid = mat_id.long()
        # float64, by an embedding lookup, for the gradient's sum over the
        # pixels (parallel/tiling.py _shade_band)
        base_color = F.embedding(mid, mats.base_color_factor.double()[:, :3]
                                 ).float()
        metallic = mats.metallic_factor[mid][..., None]
        roughness = mats.roughness_factor[mid][..., None]
        emissive = mats.emissive_factor[mid]
    pos_px = interp[..., 0:3]
    nrm_px = m3.normalize(interp[..., 3:6])
    occlusion = torch.ones_like(metallic)

    # ---- shading ----------------------------------------------------------
    view = m3.normalize(info.camera.position - pos_px)
    srf = sh.get_surface_reflectance_mr(base_color, metallic, roughness)
    ndotv = torch.clamp(m3.dot(nrm_px, view), 0.0, 1.0)
    rp = info.renderer_params
    shading = sh.SurfaceShadingInfo(
        pos=pos_px, view=view, occlusion=occlusion,
        emissive=emissive * rp.emission_scale,
        base=sh.BaseLayerShadingInfo(srf=srf, metallic=metallic,
                                     normal=nrm_px, ndotv=ndotv),
        ibl_scale=rp.ibl_scale[:3])
    lighting = sh.default_lighting(pos_px)
    if use_lights:
        shadow_factors = None
        if shadow_mode is not None:
            shadow_factors = cascaded_shadow_factors(pos_px, info,
                                                     shadow_mode,
                                                     pcf_kernel_size)
        lighting = sh.apply_punctual_lights(shading, info.lights, lighting,
                                            shadow_factors=shadow_factors)
    if use_ibl and ibl_maps is not None:
        lighting = sh.apply_ibl(shading, ibl_maps, lighting)
    color = sh.resolve_lighting(shading, lighting)

    # ---- background: the env map along the view ray -----------------------
    ray = _camera_rays(info.camera, pad_w, pad_h)
    bg = sample_env_oct([env_oct], ray, torch.zeros(ray.shape[:-1],
                                                    device=dev))
    color = torch.where(hit[..., None], color, bg)

    if debug_view != DebugViewType.NONE:
        color = _debug_color(debug_view, vb, base_color, metallic, roughness,
                             nrm_px, ndotv, emissive, srf, lighting, color)
        return color[:height, :width]

    # ---- tone map + sRGB ---------------------------------------------------
    if tone_mapping_mode != ToneMappingMode.NONE:
        color = tone_map(color, tone_mapping_mode, ToneMappingAttribs(
            middle_gray=rp.middle_gray, white_point=rp.white_point),
            ave_log_lum=rp.average_log_lum)
    if convert_output_to_srgb:
        color = m3.linear_to_srgb(color)
    return color[:height, :width]


def _debug_color(view: DebugViewType, vb, base_color, metallic, roughness,
                 normal, ndotv, emissive, srf, lighting, color) -> Tensor:
    """The forward renderer's debug views (RenderPBR.psh:574-613; JAX
    renderer.py:437): 13 views of the shading inputs and lighting terms,
    the lit colour for the others; zero where nothing was hit."""
    V = DebugViewType
    hit = vb.tri_id >= 0
    ones3 = torch.ones_like(base_color)
    views = {
        V.BASE_COLOR: lambda: base_color,
        V.METALLIC: lambda: metallic * ones3,
        V.ROUGHNESS: lambda: roughness * ones3,
        V.DIFFUSE_COLOR: lambda: srf.diffuse_color,
        V.SPECULAR_COLOR: lambda: srf.reflectance0,
        V.REFLECTANCE90: lambda: srf.reflectance90,
        V.SHADING_NORMAL: lambda: normal * 0.5 + 0.5,
        V.NDOTV: lambda: ndotv * ones3,
        V.PUNCTUAL_LIGHTING: lambda: lighting.base.punctual,
        V.DIFFUSE_IBL: lambda: lighting.base.diffuse_ibl,
        V.SPECULAR_IBL: lambda: lighting.base.specular_ibl,
        V.EMISSIVE: lambda: emissive,
        V.SCENE_DEPTH: lambda: torch.where(
            hit, vb.depth, torch.ones((), device=hit.device))[..., None]
        * ones3,
    }
    out = views.get(view, lambda: color)()
    return torch.where(hit[..., None], out, torch.zeros((), device=hit.device))
