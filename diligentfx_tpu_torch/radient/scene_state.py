"""ECS scene state with incremental change logs (the port of the JAX
package's radient/scene_state.py) — the analogue of
RadientSceneState (Radient/include/Scene/RadientSceneState.hpp:58-115,
src 1,595 LoC): entity/component storages, transform hierarchy with cached
world matrices and effective visibility, revision counters, and delta change
logs with base-revision invalidation semantics (consumers holding a base
revision older than the log window receive OUT_OF_DATE and must resync).

Like the reference (RadientSceneState.hpp:57-60) this class is NOT internally
synchronized; the read/write split lives in engine.py (Scene vs SceneWriter).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

import numpy as np

from diligentfx_tpu_torch.radient.types import RadientStatus

Entity = int
INVALID_ENTITY: Entity = -1


class ChangeKind(enum.IntEnum):
    CREATED = 0
    DESTROYED = 1
    TRANSFORM = 2
    MESH = 3
    MATERIAL = 4
    VISIBILITY = 5
    LIGHT = 6
    CAMERA = 7
    HIERARCHY = 8
    DISPLAY_COLOR = 9


@dataclass
class TransformComponent:
    local: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))


@dataclass
class MeshComponent:
    mesh_asset: int = -1        # asset-manager handle
    material_asset: int = -1


@dataclass
class LightComponent:
    type: str = "directional"   # directional | point | spot
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    range: float = 100.0
    inner_cone_angle: float = 0.0
    outer_cone_angle: float = 0.7853981634
    cast_shadows: bool = False


@dataclass
class CameraComponent:
    fov_y: float = 1.0
    near_z: float = 0.1
    far_z: float = 100.0


@dataclass
class DisplayColorComponent:
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


_MAX_LOG = 4096  # change-log window before consumers go OUT_OF_DATE


class SceneState:
    def __init__(self):
        self._next_entity: Entity = 0
        self._alive: Set[Entity] = set()
        self.transforms: Dict[Entity, TransformComponent] = {}
        self.meshes: Dict[Entity, MeshComponent] = {}
        self.lights: Dict[Entity, LightComponent] = {}
        self.cameras: Dict[Entity, CameraComponent] = {}
        self.display_colors: Dict[Entity, DisplayColorComponent] = {}
        self.visibility: Dict[Entity, bool] = {}
        self.parents: Dict[Entity, Entity] = {}
        self._children: Dict[Entity, List[Entity]] = {}
        # cached derived state
        self._world: Dict[Entity, np.ndarray] = {}
        self._effective_visible: Dict[Entity, bool] = {}
        self._dirty_world: Set[Entity] = set()
        # revision + change log
        self.revision: int = 0
        self._log: List[Tuple[int, ChangeKind, Entity]] = []

    # -- entity lifecycle ---------------------------------------------------

    def create_entity(self) -> Entity:
        e = self._next_entity
        self._next_entity += 1
        self._alive.add(e)
        self.transforms[e] = TransformComponent()
        self.visibility[e] = True
        self.parents[e] = INVALID_ENTITY
        self._dirty_world.add(e)
        self._record(ChangeKind.CREATED, e)
        return e

    def destroy_entity(self, e: Entity) -> None:
        self._check(e)
        for child in list(self._children.get(e, [])):
            self.set_parent(child, INVALID_ENTITY)
        parent = self.parents.get(e, INVALID_ENTITY)
        if parent != INVALID_ENTITY:
            self._children[parent].remove(e)
        self._alive.discard(e)
        for store in (self.transforms, self.meshes, self.lights, self.cameras,
                      self.display_colors, self.visibility, self.parents,
                      self._world, self._effective_visible):
            store.pop(e, None)
        self._children.pop(e, None)
        self._dirty_world.discard(e)
        self._record(ChangeKind.DESTROYED, e)

    def is_alive(self, e: Entity) -> bool:
        return e in self._alive

    @property
    def entity_count(self) -> int:
        return len(self._alive)

    # -- components ----------------------------------------------------------

    def set_transform(self, e: Entity, local: np.ndarray) -> None:
        self._check(e)
        self.transforms[e].local = np.asarray(local, np.float32)
        self._mark_subtree_dirty(e)
        self._record(ChangeKind.TRANSFORM, e)

    def set_mesh(self, e: Entity, mesh_asset: int, material_asset: int = -1) -> None:
        self._check(e)
        self.meshes[e] = MeshComponent(mesh_asset, material_asset)
        self._record(ChangeKind.MESH, e)

    def set_material(self, e: Entity, material_asset: int) -> None:
        self._check(e)
        if e not in self.meshes:
            self.meshes[e] = MeshComponent()
        self.meshes[e].material_asset = material_asset
        self._record(ChangeKind.MATERIAL, e)

    def set_light(self, e: Entity, light: LightComponent) -> None:
        self._check(e)
        self.lights[e] = light
        self._record(ChangeKind.LIGHT, e)

    def set_camera(self, e: Entity, camera: CameraComponent) -> None:
        self._check(e)
        self.cameras[e] = camera
        self._record(ChangeKind.CAMERA, e)

    def set_display_color(self, e: Entity, color) -> None:
        self._check(e)
        self.display_colors[e] = DisplayColorComponent(tuple(color))
        self._record(ChangeKind.DISPLAY_COLOR, e)

    def set_visible(self, e: Entity, visible: bool) -> None:
        self._check(e)
        self.visibility[e] = bool(visible)
        self._mark_subtree_dirty(e)
        self._record(ChangeKind.VISIBILITY, e)

    def set_parent(self, e: Entity, parent: Entity) -> None:
        self._check(e)
        if parent != INVALID_ENTITY:
            self._check(parent)
            # reject cycles
            p = parent
            while p != INVALID_ENTITY:
                if p == e:
                    raise ValueError("hierarchy cycle")
                p = self.parents.get(p, INVALID_ENTITY)
        old = self.parents.get(e, INVALID_ENTITY)
        if old != INVALID_ENTITY:
            self._children[old].remove(e)
        self.parents[e] = parent
        if parent != INVALID_ENTITY:
            self._children.setdefault(parent, []).append(e)
        self._mark_subtree_dirty(e)
        self._record(ChangeKind.HIERARCHY, e)

    # -- derived state --------------------------------------------------------

    def world_transform(self, e: Entity) -> np.ndarray:
        self._check(e)
        self._update_derived(e)
        return self._world[e]

    def effective_visible(self, e: Entity) -> bool:
        self._check(e)
        self._update_derived(e)
        return self._effective_visible[e]

    def _update_derived(self, e: Entity) -> None:
        if e not in self._dirty_world and e in self._world:
            return
        # walk up to the root, then accumulate top-down
        # (row-vector: world = local @ parent_world)
        chain = []
        p = e
        while p != INVALID_ENTITY:
            chain.append(p)
            p = self.parents.get(p, INVALID_ENTITY)
        w = np.eye(4, dtype=np.float32)
        vis = True
        for node in reversed(chain):
            w = self.transforms[node].local @ w
            vis = vis and self.visibility.get(node, True)
            self._world[node] = w
            self._effective_visible[node] = vis
            self._dirty_world.discard(node)

    # -- enumeration (RadientSceneState renderable enumeration) ---------------

    def renderable_meshes(self) -> List[Tuple[Entity, MeshComponent, np.ndarray]]:
        out = []
        for e, mc in self.meshes.items():
            if self.effective_visible(e) and mc.mesh_asset >= 0:
                out.append((e, mc, self.world_transform(e)))
        return out

    def active_lights(self) -> List[Tuple[Entity, LightComponent, np.ndarray]]:
        return [(e, lc, self.world_transform(e))
                for e, lc in self.lights.items() if self.effective_visible(e)]

    # -- change log (delta semantics, RadientSceneState.hpp:58-115) ------------

    def _record(self, kind: ChangeKind, e: Entity) -> None:
        self.revision += 1
        self._log.append((self.revision, kind, e))
        if len(self._log) > _MAX_LOG:
            self._log = self._log[-_MAX_LOG:]

    def get_changes(self, base_revision: int):
        """Returns (status, changes_since_base). OUT_OF_DATE when the base is
        older than the retained log window — consumer must full-resync."""
        if base_revision > self.revision:
            return RadientStatus.INVALID_ARGUMENT, []
        if base_revision == self.revision:
            return RadientStatus.OK, []
        if self._log and self._log[0][0] > base_revision + 1:
            return RadientStatus.OUT_OF_DATE, []
        return RadientStatus.OK, [c for c in self._log if c[0] > base_revision]

    # -- util -----------------------------------------------------------------

    def _mark_subtree_dirty(self, e: Entity) -> None:
        stack = [e]
        while stack:
            n = stack.pop()
            self._dirty_world.add(n)
            stack.extend(self._children.get(n, []))

    def _check(self, e: Entity) -> None:
        if e not in self._alive:
            raise KeyError(f"entity {e} is not alive")
