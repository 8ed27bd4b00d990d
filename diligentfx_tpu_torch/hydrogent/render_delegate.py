"""Hydra render delegate (the port of the JAX package's
hydrogent/render_delegate.py) — the analogue of Hydrogent's
HnRenderDelegate (interface/HnRenderDelegate.hpp:156-539) and its prims
HnMesh / HnMaterial / HnLight / HnCamera / HnRenderBuffer, HnRenderParam,
and the memory-stats surface (interface:68-146).

The delegate exposes Hydra's prim-oriented protocol directly (create prims
by id → set primvars/topology → CommitResources → execute the task graph);
`usd_adapter.py` binds these prims to a pxr-shaped module.  Geometry goes
through the deduplicated pool (geometry_pool.py), whose device tensors the
committed scene gathers from; textures through the registry's atlas
(texture_registry.py).  The delegate and everything it builds live on one
device, CUDA unless the caller asks for the CPU; a SOLID frame runs
HnTaskManager.execute (K1 on the fused route, K2, K3), an EDGES frame the
two-pass raster (K4).

Topology handling mirrors HnMeshUtils: polygon face sets are
fan-triangulated by the native runtime (dfx_triangulate_faces).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                          PBRMaterialBasicAttribs,
                                          PBRRendererShaderParameters,
                                          stack_materials)
from diligentfx_tpu_torch.config import PBRRendererCreateInfo
from diligentfx_tpu_torch.device import resolve_device
# _area_normals and TextureDescriptor are re-exported, as the JAX module does
from diligentfx_tpu_torch.hydrogent.geometry_pool import (  # noqa: F401
    HnGeometryPool, _area_normals)
from diligentfx_tpu_torch.hydrogent.material_network import (  # noqa: F401
    HnMaterialNetwork, TextureDescriptor, normalized_payload)
from diligentfx_tpu_torch.hydrogent.task_manager import (FrameOutput,
                                                         HnTaskManager,
                                                         TaskManagerCreateInfo)
from diligentfx_tpu_torch.hydrogent.texture_registry import HnTextureRegistry
from diligentfx_tpu_torch.native import binding as native
from diligentfx_tpu_torch.ops import raster as rz
from diligentfx_tpu_torch.pbr.renderer import (PBRRenderer, RenderInfo,
                                               ScenePrimitives,
                                               transform_vertices)

_IDENTITY_UV = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# Render param (HnRenderParam: include/HnRenderParam.hpp:67-154)
# ---------------------------------------------------------------------------


class HnGeometryMode:
    SOLID = 0
    EDGES = 1
    POINTS = 2


@dataclass
class HnRenderParam:
    """Global mutable state with per-attribute version counters
    (MakeAttribDirty include:126)."""
    geometry_mode: int = HnGeometryMode.SOLID
    frame_number: int = 0
    elapsed_time: float = 0.0
    _versions: Dict[str, int] = field(default_factory=dict)

    def make_attrib_dirty(self, name: str) -> None:
        self._versions[name] = self._versions.get(name, 0) + 1

    def get_attrib_version(self, name: str) -> int:
        return self._versions.get(name, 0)


# ---------------------------------------------------------------------------
# Prims
# ---------------------------------------------------------------------------


class HnMesh:
    """Rprim: topology + primvars + transform (HnMesh.cpp:192-1408)."""

    def __init__(self, prim_id: str, delegate: "HnRenderDelegate"):
        self.id = prim_id
        self._d = delegate
        self.points: Optional[np.ndarray] = None
        self.normals: Optional[np.ndarray] = None
        self.uvs: Optional[np.ndarray] = None
        self.indices: Optional[np.ndarray] = None
        self.transform = np.eye(4, dtype=np.float32)
        self.material_id: str = ""
        self.visible = True
        self.dirty = True
        # geometry subsets (HdGeomSubset): per-face-set material bindings
        self.geom_subsets: list = []
        self.tri_face: Optional[np.ndarray] = None   # (T,) original face id

    def set_topology(self, face_counts, face_indices) -> None:
        """Arbitrary polygons → triangles (HnMeshUtils proxy indices)."""
        fc = np.asarray(face_counts, np.int32)
        self.indices = native.triangulate_faces(
            fc, np.asarray(face_indices, np.int32))
        # fan triangulation emits each face's triangles consecutively →
        # the face-of-triangle map is a repeat over (count - 2)
        self.tri_face = np.repeat(np.arange(len(fc), dtype=np.int32),
                                  np.maximum(fc - 2, 0))
        self.dirty = True
        self._d._bump("mesh_topology")

    def set_triangles(self, indices) -> None:
        self.indices = np.asarray(indices, np.int32).reshape(-1, 3)
        self.tri_face = np.arange(self.indices.shape[0], dtype=np.int32)
        self.dirty = True
        self._d._bump("mesh_topology")

    def set_geom_subsets(self, subsets) -> None:
        """HdGeomSubset face sets: [(material_id, face_indices), ...] — faces
        index the ORIGINAL (pre-triangulation) faces.  Later subsets win on
        overlap, unassigned faces keep the mesh material (a per-triangle
        material relabel: the mega-draw needs no draw-item split)."""
        self.geom_subsets = [(str(mid), np.asarray(f, np.int32))
                             for mid, f in subsets]
        self.dirty = True
        self._d._bump("mesh_topology")

    def set_points(self, points) -> None:
        self.points = np.asarray(points, np.float32)
        self.dirty = True
        self._d._bump("mesh_geometry")

    def set_primvar(self, name: str, value) -> None:
        v = np.asarray(value, np.float32)
        if name == "normals":
            self.normals = v
        elif name in ("st", "uv", "uv0"):
            self.uvs = v
        self.dirty = True
        self._d._bump("mesh_geometry")

    def set_transform(self, m) -> None:
        self.transform = np.asarray(m, np.float32)
        # transform-only change: NOT a scene rebuild — execute() updates the
        # node matrices in place (commit stays O(changed), not O(scene))
        self._d._transform_dirty.add(self.id)
        self._d.render_param.make_attrib_dirty("mesh_transform")

    def set_material(self, material_id: str) -> None:
        self.material_id = material_id
        self.dirty = True
        self._d._bump("mesh_material")

    def set_visibility(self, visible: bool) -> None:
        self.visible = bool(visible)
        self._d._bump("mesh_visibility")


class HnMaterial:
    """Sprim (HnMaterial.cpp:1375)."""

    def __init__(self, prim_id: str, delegate: "HnRenderDelegate"):
        self.id = prim_id
        self._d = delegate
        self.network = HnMaterialNetwork()
        self.dirty = True

    def set_network(self, network: dict) -> None:
        self.network = HnMaterialNetwork(network)
        self.dirty = True
        self._d._bump("material")


class HnLight:
    """Sprim for dir/point/spot/dome lights (HnLight.cpp:699).  `execute`
    reads type, color, intensity, direction, position, cone_angles and
    range; cast_shadows and dome_env are stored and not read, as in the
    JAX package."""

    def __init__(self, prim_id: str, delegate: "HnRenderDelegate"):
        self.id = prim_id
        self._d = delegate
        self.type = "distant"
        self.color = (1.0, 1.0, 1.0)
        self.intensity = 1.0
        self.direction = (0.0, -1.0, 0.0)
        self.position = (0.0, 0.0, 0.0)
        self.cone_angles = (0.0, 0.785)
        self.range = 100.0
        self.cast_shadows = False
        self.dome_env: Optional[np.ndarray] = None   # octahedral env for dome

    def set_params(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self, k, v)
        self._d._bump("light")


class HnCamera:
    """Sprim camera (HnCamera 143 LoC)."""

    def __init__(self, prim_id: str, delegate: "HnRenderDelegate"):
        self.id = prim_id
        self._d = delegate
        self.eye = (0.0, 1.0, 5.0)
        self.target = (0.0, 0.0, 0.0)
        self.fov_y = 1.0
        self.near_z = 0.1
        self.far_z = 100.0

    def set_params(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self, k, v)
        self._d._bump("camera")


class HnRenderBuffer:
    """Bprim: a named AOV view over the last frame's G-buffer."""

    def __init__(self, prim_id: str, delegate: "HnRenderDelegate", aov: str):
        self.id = prim_id
        self.aov = aov
        self._d = delegate

    def read(self):
        out = self._d.last_output
        if out is None:
            return None
        if self.aov == "color":
            return out.color
        return getattr(out.gbuffer, self.aov)


# ---------------------------------------------------------------------------
# Delegate
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HnRenderDelegateCreateInfo:
    """HnRenderDelegate::CreateInfo (interface:159-278, the subset the
    delegate reads)."""
    atlas_size: int = 1024
    texture_load_budget_bytes: int = 32 << 20
    geometry_load_budget_bytes: int = 64 << 20
    allow_parallel_sync: bool = True


@dataclass
class HnRenderDelegateMemoryStats:
    """interface:68-146 analogue."""
    vertex_pool_capacity: int = 0
    vertex_pool_used: int = 0
    index_pool_capacity: int = 0
    index_pool_used: int = 0
    atlas_bytes: int = 0
    num_meshes: int = 0
    num_materials: int = 0
    num_lights: int = 0


class HnRenderDelegate:
    """Owns prims + pools + the frame task graph; CommitResources packs dirty
    prims into the device scene (HnRenderDelegate::CommitResources,
    interface:402).  `renderer`, when given, must live on `device`."""

    SUPPORTED_RPRIMS = ("mesh",)
    SUPPORTED_SPRIMS = ("material", "light", "camera")
    SUPPORTED_BPRIMS = ("renderBuffer",)

    def __init__(self, ci: HnRenderDelegateCreateInfo =
                 HnRenderDelegateCreateInfo(), renderer=None,
                 task_manager_ci=None, device=None):
        self.device = resolve_device(device)
        if renderer is not None and renderer.device != self.device:
            raise ValueError(f"the renderer is on {renderer.device}, the "
                             f"delegate on {self.device}")
        self.ci = ci
        self.meshes: Dict[str, HnMesh] = {}
        self.materials: Dict[str, HnMaterial] = {}
        self.lights: Dict[str, HnLight] = {}
        self.cameras: Dict[str, HnCamera] = {}
        self.buffers: Dict[str, HnRenderBuffer] = {}
        self.render_param = HnRenderParam()
        # content-deduplicated, budgeted geometry pool with persistent device
        # storage (HnGeometryPool.cpp dedup + dirty-range commit + budget)
        self.geometry_pool = HnGeometryPool(
            load_budget_bytes=ci.geometry_load_budget_bytes,
            device=self.device)
        self._scene: Optional[ScenePrimitives] = None
        self._scene_dirty = True
        self._node_matrices: Optional[np.ndarray] = None   # host copy
        self._tm: Optional[HnTaskManager] = None
        self._tm_ci = task_manager_ci
        self._renderer = renderer
        self._state = None
        self.last_output: Optional[FrameOutput] = None
        self._mesh_geo: Dict[str, bytes] = {}   # prim id → pool content key
        # HnTextureRegistry analogue: async loads + dedup + budgeted commit
        self.texture_registry = HnTextureRegistry(
            atlas_dim=ci.atlas_size,
            upload_budget_bytes=ci.texture_load_budget_bytes,
            device=self.device)
        self._atlas = None
        self._transform_dirty: set = set()
        self._mesh_slots: Dict[str, int] = {}

    # -- prim factories (HnRenderDelegate prim factories, interface:344-387) --

    def create_rprim(self, type_id: str, prim_id: str) -> HnMesh:
        if type_id != "mesh":
            raise ValueError(type_id)
        m = HnMesh(prim_id, self)
        self.meshes[prim_id] = m
        return m

    def create_sprim(self, type_id: str, prim_id: str):
        if type_id == "material":
            p = HnMaterial(prim_id, self)
            self.materials[prim_id] = p
        elif type_id == "light":
            p = HnLight(prim_id, self)
            self.lights[prim_id] = p
        elif type_id == "camera":
            p = HnCamera(prim_id, self)
            self.cameras[prim_id] = p
        else:
            raise ValueError(type_id)
        return p

    def create_bprim(self, type_id: str, prim_id: str, aov: str = "color"):
        if type_id != "renderBuffer":
            raise ValueError(type_id)
        b = HnRenderBuffer(prim_id, self, aov)
        self.buffers[prim_id] = b
        return b

    def destroy_prim(self, prim_id: str) -> None:
        for store in (self.meshes, self.materials, self.lights,
                      self.cameras, self.buffers):
            if prim_id in store:
                if store is self.meshes and prim_id in self._mesh_geo:
                    self.geometry_pool.release(self._mesh_geo.pop(prim_id))
                del store[prim_id]
                self._bump("prims")
                # 'prims' bumps alone don't dirty the scene (creation happens
                # before data arrives), but removal must force a rebuild or
                # the destroyed mesh keeps rendering
                self._scene_dirty = True
                return

    def _bump(self, what: str) -> None:
        self.render_param.make_attrib_dirty(what)
        if what != "prims":
            self._scene_dirty = True

    # -- commit (geometry-pool commit + scene build) ---------------------------

    def _prepare(self, dirty) -> list:
        """The per-mesh host prep (content hash, area normals, tangents) of
        the dirty meshes, on a thread pool when parallel sync is allowed
        (HnRenderDelegate::IsParallelSyncEnabled, interface:405)."""
        pool = self.geometry_pool

        def prep(pm):
            m = pm[1]
            return pool.prepare_content(m.points, m.normals, m.uvs, m.indices)
        if self.ci.allow_parallel_sync and len(dirty) > 1:
            workers = min(len(dirty), max(os.cpu_count() or 1, 2), 16)
            with ThreadPoolExecutor(max_workers=workers) as ex:
                return list(ex.map(prep, dirty))
        return [prep(pm) for pm in dirty]

    def commit_resources(self) -> ScenePrimitives:
        """Packs all visible meshes into one ScenePrimitives on the device
        (the upload point of HnGeometryPool::Commit + the texture registry
        commit)."""
        dev = self.device
        mats: List[PBRMaterialBasicAttribs] = []
        mat_index: Dict[str, int] = {}
        mat_tex: List[List[int]] = []      # per material: 5 slot tex ids
        mat_uvxf: List[List[Tuple[float, ...]]] = []  # (5, 6) uv transforms
        mat_wraps: List[List[Tuple[int, int]]] = []   # (5, 2) wrap u/v

        def material_slot(mid: str) -> int:
            if mid in mat_index:
                return mat_index[mid]
            net = (self.materials[mid].network if mid in self.materials
                   else HnMaterialNetwork())
            alpha_mode = {"default": 0, "masked": 1, "translucent": 2}[net.tag]
            mats.append(PBRMaterialBasicAttribs.create(
                base_color_factor=(*net.diffuse_color, net.opacity),
                emissive_factor=net.emissive_color,
                metallic_factor=net.metallic,
                roughness_factor=net.roughness,
                alpha_mode=alpha_mode,
                alpha_mask_cutoff=net.opacity_threshold,
                clearcoat_factor=net.clearcoat,
                clearcoat_roughness_factor=net.clearcoat_roughness))
            # per-slot texture descriptors carry sampler state (wrap modes,
            # UV transform from UsdTransform2d, channel swizzle): the
            # HnMaterial texture-allocation path with
            # PBRMaterialTextureAttribs semantics (PBR_Structures.fxh:245-255)
            slots = [-1, -1, -1, -1, -1]
            uvxfs = [_IDENTITY_UV] * 5
            wraps = [(0, 0)] * 5
            for slot in range(5):
                desc = net.texture_for_slot(slot)
                if desc is None:
                    continue
                payload = normalized_payload(desc, slot)
                if payload is None:
                    continue
                slots[slot] = self.texture_registry.allocate(
                    np.asarray(payload) if not callable(payload) else payload)
                uvxfs[slot] = desc.uv_transform
                wraps[slot] = (desc.wrap_u, desc.wrap_v)
            mat_tex.append(slots)
            mat_uvxf.append(uvxfs)
            mat_wraps.append(wraps)
            mat_index[mid] = len(mats) - 1
            return mat_index[mid]

        # ---- geometry: every mesh through the deduplicated pool ------------
        # The host prep fans out (_prepare); the stateful pool registration
        # runs serially in prim order, so offsets and dedup never depend on
        # thread completion order.
        pool = self.geometry_pool
        dirty = [(pid, mesh) for pid, mesh in self.meshes.items()
                 if (mesh.visible and mesh.points is not None
                     and mesh.indices is not None
                     and (mesh.dirty or pid not in self._mesh_geo))]
        for (pid, mesh), (key, staged) in zip(dirty, self._prepare(dirty)):
            new_key = pool.acquire_prepared(key, staged)
            old = self._mesh_geo.get(pid)
            if old is not None:
                pool.release(old)
            self._mesh_geo[pid] = new_key
            mesh.dirty = False
        pool_dev = pool.commit()        # budgeted: entries past the budget
                                        # stay PENDING until a later commit

        instances = []                  # (pid, key) resident this frame
        # slots are valid only for meshes in THIS expansion: a stale slot
        # from a PENDING mesh would alias another instance's node row on the
        # next transform-only commit
        self._mesh_slots = {}
        vnode, tmat, node_m = [], [], []
        for pid, mesh in self.meshes.items():
            key = self._mesh_geo.get(pid)
            if (not mesh.visible or mesh.points is None
                    or mesh.indices is None or key is None
                    or not pool.is_resident(key)):
                continue
            slot = len(instances)
            _, v_len, _, t_len = pool.range_of(key)
            instances.append((pid, key))
            vnode.append(np.full(v_len, slot, np.int32))
            mslot = material_slot(mesh.material_id)
            tm = np.full(t_len, mslot, np.int32)
            if mesh.geom_subsets and mesh.tri_face is not None:
                # per-face-set material bindings (HdGeomSubset)
                nf = int(mesh.tri_face.max()) + 1 if t_len else 0
                face_mat = np.full(nf, mslot, np.int32)
                for sub_mid, faces in mesh.geom_subsets:
                    face_mat[faces[(faces >= 0) & (faces < nf)]] = \
                        material_slot(sub_mid)
                tm = face_mat[mesh.tri_face]
            tmat.append(tm)
            node_m.append(mesh.transform)
            self._mesh_slots[pid] = slot

        if instances:
            # device-side expansion: contiguous-range gathers out of the
            # pool (no geometry crosses to the device here)
            ranges = [pool.range_of(k) for _, k in instances]
            vgather = torch.from_numpy(np.concatenate([
                np.arange(v0, v0 + vl, dtype=np.int64)
                for v0, vl, _, _ in ranges])).to(dev)
            pos, nrm, uv, tan = (pool_dev[n][vgather]
                                 for n, _ in HnGeometryPool.VSTREAMS)
            pieces, off = [], 0
            for v0, vl, t0, tl in ranges:
                pieces.append(pool_dev["indices"][t0:t0 + tl] + (off - v0))
                off += vl
            idx = torch.cat(pieces)
        else:
            # empty stage: render background-only frames (mesh_id = -1
            # everywhere) through the normal pipeline via one degenerate
            # zero-area triangle — Hydrogent keeps rendering when the last
            # Rprim is removed (HnRenderDelegate::DestroyRprim)
            f32 = dict(dtype=torch.float32, device=dev)
            pos = torch.zeros((3, 3), **f32)
            nrm = torch.tensor([[0.0, 0.0, 1.0]], **f32).repeat(3, 1)
            uv = torch.zeros((3, 2), **f32)
            tan = torch.tensor([[1.0, 0.0, 0.0, 1.0]], **f32).repeat(3, 1)
            idx = torch.tensor([[0, 1, 2]], dtype=torch.int32, device=dev)
            vnode.append(np.zeros(3, np.int32))
            tmat.append(np.zeros(1, np.int32))
            node_m.append(np.eye(4, dtype=np.float32))
        if not mats:
            mats.append(PBRMaterialBasicAttribs.create())
            mat_tex.append([-1] * 5)
            mat_uvxf.append([_IDENTITY_UV] * 5)
            mat_wraps.append([(0, 0)] * 5)
        # texture registry commit: budgeted atlas build (HnTextureRegistry)
        self._atlas = self.texture_registry.commit()

        def t(a, dtype):
            # a copy: the host arrays (the node matrices above all) stay
            # the delegate's to edit, also where the device is the CPU
            return torch.tensor(a, dtype=dtype, device=dev)
        tex_kwargs = {}
        if self._atlas is not None and any(x >= 0 for row in mat_tex
                                           for x in row):
            tex_kwargs = dict(
                tex_ids=t(np.asarray(mat_tex, np.int32), torch.int32),
                tex_uv_transform=t(np.asarray(mat_uvxf, np.float32),
                                   torch.float32),
                tex_wraps=t(np.asarray(mat_wraps, np.int32), torch.int32))
        tmat_np = np.concatenate(tmat)
        self._node_matrices = np.stack(node_m).astype(np.float32)
        nm = t(self._node_matrices, torch.float32)
        self._scene = ScenePrimitives(
            positions=pos, normals=nrm, uvs=uv, tangents=tan, indices=idx,
            vertex_node=t(np.concatenate(vnode), torch.int32),
            tri_material=t(tmat_np, torch.int32),
            tri_double_sided=torch.zeros(tmat_np.shape[0], dtype=torch.bool,
                                         device=dev),
            node_matrices=nm, prev_node_matrices=nm,
            materials=stack_materials(mats, dev), **tex_kwargs)
        self._transform_dirty.clear()
        return self._scene

    def _commit_transforms(self) -> None:
        """Transform-only commit: the changed prims' rows of the node
        matrices, one upload of (N, 4, 4) floats, no geometry; the previous
        matrices keep the motion vectors honest."""
        nm = self._node_matrices
        for pid in self._transform_dirty:
            sl = self._mesh_slots.get(pid)
            if sl is not None and pid in self.meshes:
                nm[sl] = self.meshes[pid].transform
        self._scene = self._scene._replace(
            node_matrices=torch.from_numpy(nm.copy()).to(self.device),
            prev_node_matrices=self._scene.node_matrices)
        self._transform_dirty.clear()

    # -- execution -------------------------------------------------------------

    def _task_manager(self) -> HnTaskManager:
        if self._tm is None:
            renderer = self._renderer or PBRRenderer(
                PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                                      irradiance_cube_dim=16,
                                      prefiltered_env_map_dim=32,
                                      num_specular_env_samples=16),
                device=self.device)
            self._tm = HnTaskManager(renderer,
                                     self._tm_ci or TaskManagerCreateInfo())
            self._renderer = renderer
        return self._tm

    def frame_info(self, width: int, height: int,
                   camera_id: Optional[str] = None) -> RenderInfo:
        """The frame's camera (the named camera prim, else the first, else
        a default) and lights (a dim sun when the stage has none)."""
        dev = self.device
        cam_prim = (self.cameras.get(camera_id) if camera_id
                    else next(iter(self.cameras.values()), None)) \
            or HnCamera("", self)
        view = m3.look_at(list(cam_prim.eye), list(cam_prim.target),
                          device=dev)
        proj = m3.perspective(cam_prim.fov_y, width / height,
                              cam_prim.near_z, cam_prim.far_z, device=dev)
        cam = CameraAttribs.create(view, proj, list(cam_prim.eye),
                                   cam_prim.near_z, cam_prim.far_z,
                                   width, height, device=dev)
        lights = []
        for lt in self.lights.values():
            col = tuple(np.asarray(lt.color) * lt.intensity)
            if lt.type in ("distant", "directional"):
                lights.append(PBRLightAttribs.directional(lt.direction, col,
                                                          device=dev))
            elif lt.type == "point":
                lights.append(PBRLightAttribs.point(
                    lt.position, col, range=lt.range, device=dev))
            elif lt.type == "spot":
                lights.append(PBRLightAttribs.spot(
                    lt.position, lt.direction, col, lt.cone_angles[0],
                    lt.cone_angles[1], range=lt.range, device=dev))
        if not lights:
            lights.append(PBRLightAttribs.directional((0, -1, 0), (3, 3, 3),
                                                      device=dev))
        return RenderInfo(
            camera=cam, lights=PBRLightAttribs.concat(lights),
            renderer_params=PBRRendererShaderParameters.create(device=dev))

    def execute(self, width: int, height: int,
                camera_id: Optional[str] = None) -> Optional[FrameOutput]:
        """HdEngine::Execute(GetTasks()) analogue: commit + run the frame."""
        if self._scene is None or self._scene_dirty:
            self.commit_resources()
            self._scene_dirty = False
        elif self._transform_dirty:
            self._commit_transforms()
        # async-decoded / budget-deferred textures become resident on later
        # frames WITHOUT a scene rebuild: pump the registry per frame and
        # swap the atlas when its layout version changed
        if (self._scene.tex_ids is not None
                and self.texture_registry.num_pending > 0):
            sv = self.texture_registry.storage_version
            atlas = self.texture_registry.commit()
            if self.texture_registry.storage_version != sv:
                self._atlas = atlas
        # budget-deferred geometry becomes resident on later frames: rebuild
        # the scene (a device-side re-gather, not a re-upload) once the pool
        # commits more entries (HnGeometryPool PENDING semantics)
        if self.geometry_pool.num_pending > 0:
            sv = self.geometry_pool.storage_version
            self.geometry_pool.commit()
            if self.geometry_pool.storage_version != sv:
                self.commit_resources()

        tm = self._task_manager()
        # textures committed through the registry ride the task manager's
        # atlas (the texture-array "atlas" binding mode)
        tm.atlas = self._atlas if self._scene.tex_ids is not None else None
        if self._state is None:
            self._state = tm.initial_state(width, height)
        info = self.frame_info(width, height, camera_id)
        if self.render_param.geometry_mode != HnGeometryMode.SOLID:
            # HnRenderParam geometry mode (HnTypes.hpp solid/edges/points):
            # edges from the barycentric distance, points as vertex splats
            color = render_geometry_mode(
                self._scene, info, width=width, height=height,
                cfg=self._renderer.raster_cfg,
                mode=int(self.render_param.geometry_mode))
            out = FrameOutput(color=color, gbuffer=None, state=self._state)
        else:
            out = tm.execute(self._scene, info, self._state,
                             width=width, height=height)
            self._state = out.state
        self.last_output = out
        self.render_param.frame_number += 1
        self._fold_prev_transforms()
        return out

    def _fold_prev_transforms(self) -> None:
        """After a frame consumed a transform delta, advance prev → current
        so motion vectors return to zero on the next static frame."""
        sc = self._scene
        if sc is not None and sc.prev_node_matrices is not sc.node_matrices:
            self._scene = sc._replace(prev_node_matrices=sc.node_matrices)

    def read_rprim_id(self, x: int, y: int) -> int:
        """Picking (HnReadRprimIdTask): one element of the last frame's
        `mesh_id` AOV read back to the host; no kernel runs."""
        if self.last_output is None or self.last_output.gbuffer is None:
            return -1
        return int(self.last_output.gbuffer.mesh_id[y, x])

    def get_memory_stats(self) -> HnRenderDelegateMemoryStats:
        vcap, vused, _, _ = self.geometry_pool._valloc.stats()
        icap, iused, _, _ = self.geometry_pool._talloc.stats()
        return HnRenderDelegateMemoryStats(
            vertex_pool_capacity=vcap * 48, vertex_pool_used=vused * 48,
            index_pool_capacity=icap * 12, index_pool_used=iused * 12,
            atlas_bytes=self.texture_registry.resident_bytes,
            num_meshes=len(self.meshes), num_materials=len(self.materials),
            num_lights=len(self.lights))


def bind_usd():
    """The bound pxr.HdRenderDelegate adapter classes when OpenUSD is
    importable; raises ImportError otherwise (usd_adapter.py)."""
    from diligentfx_tpu_torch.hydrogent.usd_adapter import bind_usd as _bind
    return _bind()


def render_geometry_mode(scene: ScenePrimitives, info: RenderInfo, *,
                         width: int, height: int, cfg, mode: int):
    """EDGES / POINTS geometry modes (HnRenderParam geometry mode;
    HnMeshUtils edge + point proxy geometry).

    A visibility buffer already carries per-pixel barycentrics, so EDGES is
    a screen-space barycentric-distance test on the triangles the two-pass
    raster (K4 on the card) draws, and POINTS splats the projected vertices
    with a scatter-max; no extra geometry."""
    pad_w, pad_h = rz.pad_viewport(width, height, cfg)
    dev = scene.positions.device
    wp, _, _ = transform_vertices(scene, info.model_transform)
    clip = m3.transform_points(wp, info.camera.view_proj)
    bg = torch.full((pad_h, pad_w, 3), 0.12, dtype=torch.float32, device=dev)
    fg = torch.tensor([0.85, 0.9, 1.0], dtype=torch.float32, device=dev)
    if mode == int(HnGeometryMode.EDGES):
        vb, _ = rz.rasterize(clip, scene.indices, width=pad_w, height=pad_h,
                             cfg=cfg, double_sided=scene.tri_double_sided)
        l0 = vb.bary[..., 0]
        l1 = vb.bary[..., 1]
        d = torch.minimum(torch.minimum(l0, l1), 1.0 - l0 - l1)
        hit = vb.tri_id >= 0
        edge = hit & (d < 0.06)
        color = torch.where(edge[..., None], fg,
                            torch.where(hit[..., None], bg * 1.5, bg))
    else:
        # POINTS: project every vertex and splat a dot (scatter-max)
        w = torch.clamp(clip[:, 3], min=1e-6)
        ndc = clip[:, :3] / w[:, None]
        # clamped to [-1, pad] before the truncation: the same pixel and
        # the same inside test as an unclamped cast, with no float→int
        # overflow
        px = torch.clamp((ndc[:, 0] * 0.5 + 0.5) * pad_w, -1.0,
                         float(pad_w)).to(torch.int32)
        py = torch.clamp((0.5 - ndc[:, 1] * 0.5) * pad_h, -1.0,
                         float(pad_h)).to(torch.int32)
        inside = ((clip[:, 3] > 0) & (px >= 0) & (px < pad_w)
                  & (py >= 0) & (py < pad_h))
        px = torch.clamp(px, 0, pad_w - 1)
        py = torch.clamp(py, 0, pad_h - 1)
        mask = torch.zeros(pad_h * pad_w, dtype=torch.float32, device=dev)
        mask = mask.scatter_reduce(0, (py * pad_w + px).long(),
                                   inside.to(torch.float32), "amax")
        color = bg + mask.reshape(pad_h, pad_w, 1) * (fg - bg)
    return color[:height, :width]
