"""Packed multi-light shadow-map atlas (the port of
diligentfx_tpu/components/shadow_atlas.py): the analogue of Hydrogent's
HnShadowMapManager (a resizable D32F texture array with one slice a shadow
view) and HnLight's per-light slice allocation.

The atlas is one (capacity, S, S) float32 depth tensor, the leading axis
the slice index.  A host-side free-list allocator hands out slices as
lights turn shadow-casting and takes them back when lights go: one slice a
directional (fitted ortho) or spot light, six consecutive ones a point
light (its cube faces).  The capacity grows by powers of two up to
`max_slices`, as the reference re-allocates its texture array.

Per frame (HnRenderShadowsTask analogue):
  view_projs = atlas.build_view_projs(params, bounds_min, bounds_max)
  maps       = atlas.render(world_pos, indices, view_projs)   # K4 a slice
  vps, lmaps = atlas.packed_for_lights(view_projs, maps)
  info = info._replace(light_shadow_maps=lmaps,
                       light_shadow_view_projs=vps)
  execute(..., light_shadow_kinds=atlas.light_shadow_kinds())
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import LightType
from diligentfx_tpu_torch.components import shadow_map_manager as smm
from diligentfx_tpu_torch.config import RasterizerConfig
from diligentfx_tpu_torch.device import resolve_device

Tensor = torch.Tensor

SLICES_PER_KIND = smm.SLICES_PER_KIND


def directional_view_proj(direction, bounds_min, bounds_max,
                          pad: float = 1.05, device=None) -> Tensor:
    """World -> clip of a single fitted-ortho directional slice over the
    scene bounds (JAX shadow_atlas.py:43), in the cascades' light basis
    (`basis_from_direction`): xy in [-1, 1] over the bounds' light-space
    box widened by `pad`, z in [0, 1]."""
    bmin = smm._f32(bounds_min, device)
    dev = bmin.device
    bmax = smm._f32(bounds_max, dev)
    world_to_light = smm.basis_from_direction(direction, dev)
    corners = torch.stack([
        torch.where(torch.tensor([i & 1, i & 2, i & 4], device=dev) > 0,
                    bmax, bmin) for i in range(8)])
    lc = m3.transform_points(corners, world_to_light)
    lo = torch.amin(lc, dim=0)
    hi = torch.amax(lc, dim=0)
    center = (lo + hi) * 0.5
    half = torch.clamp((hi - lo) * 0.5 * pad, min=1e-3)
    scale = torch.cat([1.0 / half[:2], 1.0 / (2.0 * half[2:3])])
    ortho = torch.eye(4, dtype=torch.float32, device=dev)
    ortho[0, 0], ortho[1, 1], ortho[2, 2] = scale[0], scale[1], scale[2]
    ortho[3, 0] = -center[0] * scale[0]
    ortho[3, 1] = -center[1] * scale[1]
    ortho[3, 2] = 0.5 - center[2] * scale[2]
    return m3.mul44(world_to_light, ortho)


@dataclass
class ShadowAtlasManager:
    """Slice allocator and renderer of the packed light-shadow atlas (JAX
    shadow_atlas.py:83): `add_light` when a light turns shadow-casting,
    `remove_light` frees its slices for reuse; the capacity only grows."""
    slice_size: int = 1024
    initial_slices: int = 8
    max_slices: int = 256
    _capacity: int = field(init=False, default=0)
    _free: List[int] = field(init=False, default_factory=list)
    # light id -> (kind, [slice indices]), in insertion order
    _lights: Dict[object, Tuple[str, List[int]]] = field(
        init=False, default_factory=dict)

    def __post_init__(self):
        self._capacity = self.initial_slices
        self._free = list(range(self.initial_slices))

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def used_slices(self) -> int:
        return self._capacity - len(self._free)

    def slices_of(self, light_id) -> Optional[List[int]]:
        ent = self._lights.get(light_id)
        return list(ent[1]) if ent is not None else None

    def add_light(self, light_id, kind: str) -> List[int]:
        """Allocate this light's slices, the lowest free ones (a same-kind
        re-add returns the slices it has).  kind: dir, spot or point."""
        if kind not in SLICES_PER_KIND:
            raise ValueError(f"unknown shadow kind {kind!r}")
        prev = self._lights.get(light_id)
        if prev is not None:
            if prev[0] == kind:
                return list(prev[1])
            self.remove_light(light_id)
        need = SLICES_PER_KIND[kind]
        while len(self._free) < need:
            self._grow()
        got = [self._free.pop(0) for _ in range(need)]
        self._lights[light_id] = (kind, got)
        return list(got)

    def remove_light(self, light_id) -> None:
        ent = self._lights.pop(light_id, None)
        if ent is not None:
            self._free.extend(ent[1])
            self._free.sort()

    def _grow(self) -> None:
        new_cap = min(max(self._capacity * 2, 1), self.max_slices)
        if new_cap <= self._capacity:
            raise RuntimeError(
                f"shadow atlas exhausted at {self._capacity} slices "
                f"(max_slices={self.max_slices})")
        self._free.extend(range(self._capacity, new_cap))
        self._capacity = new_cap

    def light_order(self) -> List[object]:
        """Light ids in insertion order (the per-light dispatch order)."""
        return list(self._lights.keys())

    def light_shadow_kinds(self) -> Tuple[str, ...]:
        """The kinds tuple of the per-light dispatch, in insertion order."""
        return tuple(kind for kind, _ in self._lights.values())

    def light_order_slices(self) -> np.ndarray:
        """Atlas slice indices in light order (a point light's six faces
        consecutive)."""
        out: List[int] = []
        for _, slices in self._lights.values():
            out.extend(slices)
        return np.asarray(out, np.int32)

    def build_view_projs(self, params: Dict[object, dict], bounds_min=None,
                         bounds_max=None, device=None) -> Tensor:
        """View-projection of every atlas slice, (capacity, 4, 4) on `device`
        (CUDA unless the caller asks for the CPU); free slices get the
        identity.  params[light_id] describes the light:
          dir:   {"direction"}                  (needs bounds_min / max)
          spot:  {"position", "direction", "outer_angle", ["near"], ["far"]}
          point: {"position", ["near"], ["far"]}"""
        dev = resolve_device(device)
        vps = [torch.eye(4, dtype=torch.float32, device=dev)] * self._capacity
        for light_id, (kind, slices) in self._lights.items():
            p = params[light_id]
            if kind == "dir":
                if bounds_min is None or bounds_max is None:
                    raise ValueError("directional slices need scene bounds")
                vps[slices[0]] = directional_view_proj(
                    p["direction"], bounds_min, bounds_max, device=dev)
            elif kind == "spot":
                vps[slices[0]] = smm.spot_view_proj(
                    p["position"], p["direction"], p["outer_angle"],
                    near=p.get("near", 0.05), far=p.get("far", 100.0),
                    device=dev)
            else:
                faces = smm.point_view_projs(
                    p["position"], near=p.get("near", 0.05),
                    far=p.get("far", 100.0), device=dev)
                for f in range(6):
                    vps[slices[f]] = faces[f]
        return torch.stack(vps)

    def render(self, world_positions: Tensor, indices: Tensor,
               view_projs: Tensor, *,
               cfg: RasterizerConfig = RasterizerConfig()) -> Tensor:
        """Depth-raster every atlas slice, the free ones too (one raster of
        the identity view each, as the reference re-renders its whole
        array) -> (capacity, S, S).  The range
        dfx.light_shadows marks it for torch.profiler."""
        with torch.profiler.record_function("dfx.light_shadows"):
            return smm.render_light_shadow_maps(
                world_positions, indices, view_projs,
                shadow_map_size=self.slice_size, cfg=cfg)

    def packed_for_lights(self, view_projs: Tensor, maps: Tensor
                          ) -> Tuple[Tensor, Tensor]:
        """The slices in light order, as the deferred shading reads them
        (RenderInfo.light_shadow_view_projs / light_shadow_maps)."""
        perm = torch.from_numpy(self.light_order_slices()).to(
            maps.device).long()
        return view_projs[perm], maps[perm]


def kinds_from_lights(lights) -> Tuple[str, ...]:
    """A kinds tuple from a PBRLightAttribs, every light shadow-casting:
    DIRECTIONAL -> dir, SPOT -> spot, anything else -> point."""
    out = []
    for t in lights.type.tolist():
        if t == LightType.DIRECTIONAL:
            out.append("dir")
        elif t == LightType.SPOT:
            out.append("spot")
        else:
            out.append("point")
    return tuple(out)
