"""Radient engine (the port of the JAX package's radient/engine.py) — the
analogue of the public Radient API (Radient/interface/RadientEngine.h:77-126:
CreateRadientEngine → IRadientEngine → backend / asset manager /
scene(+writer/importer) / renderer / view).

The read/write split of the reference (IRadientScene vs IRadientSceneWriter)
is preserved: `RadientScene` exposes const queries, `RadientSceneWriter`
mutations; `RadientSceneImporter` builds a scene from glTF through the asset
manager.  The engine runs on one device, CUDA unless the caller asks for
the CPU (`create_radient_engine(ci, device="cpu")`); its asset manager, the
texture registry and the renderer take it.  The renderer short-circuits to
OK in headless mode — the test seam of RadientRenderPipeline.cpp:128-131 —
and is the declared hook for the REMOTE (multi-host) backend.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from diligentfx_tpu_torch.attribs import PBRMaterialBasicAttribs
from diligentfx_tpu_torch.device import resolve_device
from diligentfx_tpu_torch.gltf.loader import load_gltf_bytes
from diligentfx_tpu_torch.radient.asset_manager import AssetManager
from diligentfx_tpu_torch.radient.render_pipeline import RadientRenderer
from diligentfx_tpu_torch.radient.scene_state import (CameraComponent,
                                                      LightComponent,
                                                      SceneState)
from diligentfx_tpu_torch.radient.types import (RadientBackendType,
                                                RadientError, RadientStatus)
from diligentfx_tpu_torch.radient.validation import validate_scene_load


@dataclass(frozen=True)
class RadientEngineCreateInfo:
    """RadientEngineCreateInfo analogue (interface RadientEngine.h:43-58)."""
    backend_type: RadientBackendType = RadientBackendType.LOCAL
    remote_endpoint: str = ""
    num_loading_threads: int = 2
    upload_budget_bytes: int = 64 << 20
    headless: bool = False


class RadientScene:
    """Read-only scene interface."""

    def __init__(self, state: SceneState):
        self._state = state

    @property
    def revision(self) -> int:
        return self._state.revision

    def entity_count(self) -> int:
        return self._state.entity_count

    def world_transform(self, e) -> np.ndarray:
        return self._state.world_transform(e)

    def is_visible(self, e) -> bool:
        return self._state.effective_visible(e)

    def get_changes(self, base_revision: int):
        return self._state.get_changes(base_revision)


class RadientSceneWriter:
    """Mutating scene interface (IRadientSceneWriter)."""

    def __init__(self, state: SceneState):
        self._state = state

    def create_entity(self):
        return self._state.create_entity()

    def destroy_entity(self, e):
        self._state.destroy_entity(e)

    def set_transform(self, e, m):
        self._state.set_transform(e, m)

    def set_mesh(self, e, mesh_asset, material_asset=-1):
        self._state.set_mesh(e, mesh_asset, material_asset)

    def set_material(self, e, material_asset):
        self._state.set_material(e, material_asset)

    def set_light(self, e, **kw):
        self._state.set_light(e, LightComponent(**kw))

    def set_camera(self, e, **kw):
        self._state.set_camera(e, CameraComponent(**kw))

    def set_visible(self, e, visible):
        self._state.set_visible(e, visible)

    def set_parent(self, e, parent):
        self._state.set_parent(e, parent)

    def set_display_color(self, e, color):
        self._state.set_display_color(e, color)


class RadientSceneImporter:
    """IRadientSceneImporter: glTF file → assets + entities."""

    def __init__(self, engine: "RadientEngine", state: SceneState):
        self._engine = engine
        self._state = state

    def import_gltf(self, path: str) -> RadientStatus:
        am = self._engine.asset_manager
        err = validate_scene_load(path)
        if err is not None:
            return RadientStatus.INVALID_ARGUMENT
        # URI → bytes through the resolver chain (filesystem roots, mem://,
        # file:// — RadientFilesystemAssetResolver.cpp analogue)
        found = am.resolver.resolve(path)
        if found is None:
            return RadientStatus.NOT_FOUND
        base = (os.path.dirname(found.location)
                if os.path.isfile(found.location) else ".")
        model = load_gltf_bytes(found.data, base)

        mat_handles = []
        for m in model.materials or []:
            attribs = PBRMaterialBasicAttribs.create(
                base_color_factor=m.base_color_factor,
                metallic_factor=m.metallic_factor,
                roughness_factor=m.roughness_factor,
                emissive_factor=m.emissive_factor)
            mat_handles.append(am.create_material(attribs, m.double_sided))
        if not mat_handles:
            mat_handles = [am.create_material(
                PBRMaterialBasicAttribs.create(), False)]

        writer = RadientSceneWriter(self._state)
        for ni in model.default_scene_nodes:
            node = model.nodes[ni]
            if node.mesh < 0:
                continue
            for prim in model.meshes[node.mesh]:
                mh = am.create_mesh(prim.positions, prim.indices,
                                    prim.normals, prim.uv0, prim.tangents)
                e = writer.create_entity()
                writer.set_transform(e, node.world)
                mat = (mat_handles[prim.material]
                       if 0 <= prim.material < len(mat_handles)
                       else mat_handles[0])
                writer.set_mesh(e, mh, mat)
        for ni in model.default_scene_nodes:
            node = model.nodes[ni]
            if 0 <= node.light < len(model.lights):
                l = model.lights[node.light]
                e = writer.create_entity()
                writer.set_transform(e, node.world)
                writer.set_light(e, type=l.type, color=l.color,
                                 intensity=l.intensity,
                                 range=l.range or 100.0,
                                 inner_cone_angle=l.inner_cone_angle,
                                 outer_cone_angle=l.outer_cone_angle)
        return RadientStatus.OK


class RadientView:
    """IRadientView: camera + viewport + output target."""

    def __init__(self, width: int = 640, height: int = 480):
        self.width = width
        self.height = height
        self.eye = np.array([0.0, 1.0, 5.0], np.float32)
        self.target = np.array([0.0, 0.0, 0.0], np.float32)
        self.fov_y = 1.0
        self.near_z = 0.1
        self.far_z = 100.0
        self.last_frame = None

    def set_camera(self, eye, target, fov_y=1.0, near_z=0.1, far_z=100.0):
        self.eye = np.asarray(eye, np.float32)
        self.target = np.asarray(target, np.float32)
        self.fov_y, self.near_z, self.far_z = fov_y, near_z, far_z


class RadientEngine:
    """IRadientEngine: owns the backend + asset manager + thread pool, on
    `device` (CUDA unless the caller asks for the CPU; raises when CUDA is
    wanted but absent)."""

    def __init__(self, ci: RadientEngineCreateInfo = RadientEngineCreateInfo(),
                 device=None):
        if (ci.backend_type == RadientBackendType.REMOTE
                and not ci.remote_endpoint):
            raise RadientError(RadientStatus.INVALID_ARGUMENT,
                               "REMOTE backend requires an endpoint "
                               "(the remote host's address)")
        self.ci = ci
        self.device = resolve_device(device)
        self.asset_manager = AssetManager(
            num_threads=ci.num_loading_threads,
            upload_budget_bytes=ci.upload_budget_bytes, device=self.device)
        self._scenes: List[SceneState] = []

    def create_scene(self) -> Tuple[RadientScene, SceneState]:
        state = SceneState()
        self._scenes.append(state)
        return RadientScene(state), state

    def create_scene_writer(self, state: SceneState) -> RadientSceneWriter:
        return RadientSceneWriter(state)

    def create_scene_importer(self, state: SceneState) -> RadientSceneImporter:
        return RadientSceneImporter(self, state)

    def create_renderer(self, **kw) -> RadientRenderer:
        return RadientRenderer(self, headless=self.ci.headless, **kw)

    def create_view(self, width: int = 640, height: int = 480) -> RadientView:
        return RadientView(width, height)

    def shutdown(self):
        self.asset_manager.stop()


def create_radient_engine(ci: RadientEngineCreateInfo = RadientEngineCreateInfo(),
                          device=None) -> RadientEngine:
    """CreateRadientEngine (RadientEngine.h:124), on `device` (CUDA unless
    the caller asks for the CPU)."""
    return RadientEngine(ci, device)
