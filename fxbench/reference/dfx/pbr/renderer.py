"""Scene packing, the vertex stage and the renderer's IBL resources (the
port of diligentfx_tpu/pbr/renderer.py, without its forward frame).

The whole scene is one "mega draw": a vertex/index soup with per-vertex
node ids and per-triangle material ids.  PBRRenderer owns the environment
map and the precomputed IBL resources.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fxbench.reference.dfx import math3d as m3
from fxbench.reference.dfx.attribs import (CameraAttribs, PBRLightAttribs,
                                          PBRMaterialBasicAttribs,
                                          PBRRendererShaderParameters,
                                          stack_materials)
from fxbench.reference.dfx.config import (PBRRendererCreateInfo,
                                          RasterizerConfig)
from fxbench.reference.dfx.device import resolve_device
from fxbench.reference.dfx.gltf.primitives import MeshData
from fxbench.reference.dfx.ops.sampling import oct_pixel_dirs
from fxbench.reference.dfx.pbr.ibl import precompute_ibl_maps

Tensor = torch.Tensor


class ScenePrimitives(NamedTuple):
    """Packed scene (JAX renderer.py:47).

    materials_sheen ... materials_volume: the stacked extension attribs
    (attribs.py), each None when no material uses it.  joints (V, 4) int32
    (-1 for an unskinned vertex) and weights (V, 4) blend the world-space
    joint matrices (J, 4, 4) (inverse bind @ joint world, from the host);
    prev_joint_matrices are the previous frame's, for motion vectors.

    mask_indices: the ALPHA_MODE_MASK triangles, which are the TAIL of
    `indices` (the opaque raster takes indices[:T - Tm]; the reference
    drops the tail, as the fused raster does).
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
                 device=None, ibl_maps=None):
        """`ibl_maps`, when given, are used as they are; else they are
        precomputed from the env map."""
        self.device = resolve_device(device)
        self.ci = ci
        self.raster_cfg = raster_cfg
        self.env_oct = (default_env_oct(self.device) if env_oct is None
                        else env_oct.to(self.device))
        if ibl_maps is not None:
            self.ibl_maps = ibl_maps
        elif ci.enable_ibl:
            self.ibl_maps = precompute_ibl_maps(
                self.env_oct, brdf_lut_dim=ci.brdf_lut_dim,
                num_brdf_samples=ci.num_brdf_samples,
                irradiance_dim=ci.irradiance_cube_dim,
                prefiltered_dim=ci.prefiltered_env_map_dim,
                num_spec_samples=ci.num_specular_env_samples)
        else:
            self.ibl_maps = None

