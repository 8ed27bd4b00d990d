"""Radient render pipeline + drawable cache (the port of the JAX package's
radient/render_pipeline.py) — the analogue of RadientRenderPipeline
(src/Render/RadientRenderPipeline.cpp:55-199) and RadientSceneDrawableCache
(443 LoC): per-frame Update (prepare targets → upload GPU assets → sync the
drawable cache from the scene change log → prepare passes) and Render
(geometry → skybox → post).

Every tensor lives on the engine's device.  Headless mode (no device
rendering requested) short-circuits Render to OK — the reference's
null-device test seam (RadientRenderPipeline.cpp:128-131) and the declared
hook where the REMOTE backend plugs in.

As in the JAX package: a sync with no change keeps the last transform
delta's previous matrices (so the frame after a move still carries that
move's motion), the materials' texture handles never reach the frame (the
scene stacks factors only and the task manager gets no atlas), and
LightComponent.cast_shadows is not read.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                          PBRMaterialBasicAttribs,
                                          PBRRendererShaderParameters,
                                          stack_materials)
from diligentfx_tpu_torch.config import PBRRendererCreateInfo, RasterizerConfig
from diligentfx_tpu_torch.hydrogent.task_manager import (HnTaskManager,
                                                         TaskManagerCreateInfo)
from diligentfx_tpu_torch.pbr.renderer import (PBRRenderer, RenderInfo,
                                               ScenePrimitives)
from diligentfx_tpu_torch.radient.scene_state import ChangeKind, SceneState
from diligentfx_tpu_torch.radient.types import LoadStatus, RadientStatus

_STRUCTURAL = (ChangeKind.CREATED, ChangeKind.DESTROYED, ChangeKind.MESH,
               ChangeKind.MATERIAL, ChangeKind.HIERARCHY,
               ChangeKind.VISIBILITY)


class RadientDrawableCache:
    """Consumes the scene change log into packed draw data
    (RadientSceneDrawableCache::SyncScene semantics: incremental when the
    delta log suffices, full rebuild on OUT_OF_DATE)."""

    def __init__(self, state: SceneState, asset_manager):
        self._state = state
        self._am = asset_manager
        self._base_revision = 0
        self._scene_prims = None       # pbr.renderer.ScenePrimitives
        self._entity_order: List[int] = []
        self.full_rebuilds = 0
        self.incremental_syncs = 0

    def sync_scene(self) -> RadientStatus:
        status, changes = self._state.get_changes(self._base_revision)
        if (status == RadientStatus.OK and not changes
                and self._scene_prims is not None):
            return RadientStatus.OK

        structural = (status == RadientStatus.OUT_OF_DATE
                      or self._scene_prims is None
                      or any(c[1] in _STRUCTURAL for c in changes))
        if structural:
            st = self._full_rebuild()
            if st != RadientStatus.OK:
                return st
            self.full_rebuilds += 1
        else:
            # transform-only delta: one upload of the node matrices
            mats = [np.asarray(self._state.world_transform(e), np.float32)
                    for e in self._entity_order]
            if mats:
                self._scene_prims = self._scene_prims._replace(
                    prev_node_matrices=self._scene_prims.node_matrices,
                    node_matrices=torch.tensor(np.stack(mats),
                                               device=self._am.device))
            self.incremental_syncs += 1
        self._base_revision = self._state.revision
        return RadientStatus.OK

    def _full_rebuild(self) -> RadientStatus:
        dev = self._am.device
        renderables = self._state.renderable_meshes()
        pos, nrm, uv, tan, idx = [], [], [], [], []
        vnode, tmat, tds = [], [], []
        node_mats, mats, order = [], [], []
        v_off = 0
        slot = 0
        for e, mc, world in renderables:
            mesh = self._am.meshes.get(mc.mesh_asset)
            if mesh is None:
                return RadientStatus.NOT_FOUND
            if mesh.status in (LoadStatus.QUEUED, LoadStatus.LOADING):
                return RadientStatus.PENDING
            if mesh.status == LoadStatus.LOADED_HOST:
                return RadientStatus.NO_GPU_DATA
            if mesh.status == LoadStatus.FAILED:
                return RadientStatus.FAILED
            mat_asset = self._am.materials.get(mc.material_asset)
            attribs = (mat_asset.attribs if mat_asset is not None
                       else PBRMaterialBasicAttribs.create())
            ds = mat_asset.double_sided if mat_asset is not None else False
            d = mesh.device
            v = d["positions"].shape[0]
            nt = d["indices"].shape[0]
            pos.append(d["positions"])
            nrm.append(d["normals"])
            uv.append(d["uvs"])
            tan.append(d["tangents"])
            idx.append(d["indices"] + v_off)
            vnode.append(torch.full((v,), slot, dtype=torch.int32,
                                    device=dev))
            tmat.append(torch.full((nt,), slot, dtype=torch.int32,
                                   device=dev))
            tds.append(torch.full((nt,), bool(ds), dtype=torch.bool,
                                  device=dev))
            node_mats.append(np.asarray(world, np.float32))
            mats.append(attribs)
            order.append(e)
            v_off += v
            slot += 1

        if not pos:
            self._scene_prims = None
            self._entity_order = []
            return RadientStatus.OK

        node_m = torch.tensor(np.stack(node_mats), device=dev)
        self._scene_prims = ScenePrimitives(
            positions=torch.cat(pos),
            normals=torch.cat(nrm),
            uvs=torch.cat(uv),
            tangents=torch.cat(tan),
            indices=torch.cat(idx),
            vertex_node=torch.cat(vnode),
            tri_material=torch.cat(tmat),
            tri_double_sided=torch.cat(tds),
            node_matrices=node_m,
            prev_node_matrices=node_m,
            materials=stack_materials(mats, dev),
        )
        self._entity_order = order
        return RadientStatus.OK

    @property
    def scene_primitives(self):
        return self._scene_prims

    def light_list(self):
        dev = self._am.device
        lights = []
        for e, lc, world in self._state.active_lights():
            pos = world[3, :3]
            d = -world[2, :3]
            n = np.linalg.norm(d)
            d = d / n if n > 1e-9 else np.array([0, -1, 0], np.float32)
            intensity = tuple(np.asarray(lc.color) * lc.intensity)
            if lc.type == "directional":
                lights.append(PBRLightAttribs.directional(d, intensity,
                                                          device=dev))
            elif lc.type == "point":
                lights.append(PBRLightAttribs.point(pos, intensity,
                                                    range=lc.range,
                                                    device=dev))
            else:
                lights.append(PBRLightAttribs.spot(
                    pos, d, intensity, lc.inner_cone_angle,
                    lc.outer_cone_angle, range=lc.range, device=dev))
        return PBRLightAttribs.concat(lights) if lights else None


class RadientRenderer:
    """IRadientRenderer: Update + Render over a view, on the engine's
    device.  The PBRRenderer (from `renderer_ci` and `raster_cfg`) and its
    HnTaskManager (from `task_manager_ci`) are built at the first render."""

    def __init__(self, engine, headless: bool = False, task_manager_ci=None,
                 renderer_ci=None, raster_cfg=None):
        self._engine = engine
        self._headless = headless
        self._caches: Dict[int, RadientDrawableCache] = {}
        self._tm = None
        self._tm_ci = task_manager_ci
        self._renderer_ci = renderer_ci
        self._raster_cfg = raster_cfg
        self._frame_states: Dict[int, object] = {}

    def _cache_for(self, state: SceneState) -> RadientDrawableCache:
        key = id(state)
        if key not in self._caches:
            self._caches[key] = RadientDrawableCache(
                state, self._engine.asset_manager)
        return self._caches[key]

    def task_manager(self) -> HnTaskManager:
        """The renderer's HnTaskManager, built on the engine's device at
        the first call."""
        if self._tm is None:
            renderer = PBRRenderer(
                self._renderer_ci or PBRRendererCreateInfo(),
                raster_cfg=self._raster_cfg or RasterizerConfig(),
                device=self._engine.device)
            self._tm = HnTaskManager(
                renderer, self._tm_ci or TaskManagerCreateInfo())
        return self._tm

    def update(self, state: SceneState) -> RadientStatus:
        """RadientRenderPipeline::Update (cpp:55-110)."""
        self._engine.asset_manager.update_gpu_resources()
        return self._cache_for(state).sync_scene()

    def render(self, state: SceneState, view) -> RadientStatus:
        """RadientRenderPipeline::Render (cpp:112-199).  Headless →
        short-circuit OK (test seam / remote-backend hook, cpp:128-131)."""
        cache = self._cache_for(state)
        if cache.scene_primitives is None:
            st = cache.sync_scene()
            if st != RadientStatus.OK:
                return st
        if self._headless:
            return RadientStatus.OK
        if cache.scene_primitives is None:
            return RadientStatus.OK  # empty scene renders nothing

        tm = self.task_manager()
        vkey = id(view)
        if vkey not in self._frame_states:
            self._frame_states[vkey] = tm.initial_state(view.width,
                                                        view.height)
        out = tm.execute(cache.scene_primitives, self.frame_info(state, view),
                         self._frame_states[vkey],
                         width=view.width, height=view.height)
        self._frame_states[vkey] = out.state
        view.last_frame = out.color
        return RadientStatus.OK

    def frame_info(self, state: SceneState, view) -> RenderInfo:
        """The frame's camera (the view's) and lights (the scene's active
        lights; a black sun when it has none), on the engine's device."""
        dev = self._engine.device
        vm = m3.look_at(view.eye, view.target, device=dev)
        proj = m3.perspective(view.fov_y, view.width / view.height,
                              view.near_z, view.far_z, device=dev)
        cam = CameraAttribs.create(vm, proj, view.eye, view.near_z,
                                   view.far_z, view.width, view.height,
                                   device=dev)
        lights = self._cache_for(state).light_list()
        if lights is None:
            lights = PBRLightAttribs.directional([0.0, -1.0, 0.0],
                                                 [0.0, 0.0, 0.0], device=dev)
        return RenderInfo(
            camera=cam, lights=lights,
            renderer_params=PBRRendererShaderParameters.create(device=dev))
