"""The system under test: a configuration built on the port's own entry
points (`build_scene`, `PBRRenderer`, `HnTaskManager.execute` /
`execute_split`) from the scene arrays the benchmark made.

Nothing here computes a frame: the port does.  This module only turns the
configuration's plain values into the port's objects, and the port's
FrameState into the plain dict the reference reads.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                          PBRMaterialBasicAttribs,
                                          PBRRendererShaderParameters)
from diligentfx_tpu_torch.config import PBRRendererCreateInfo, RasterizerConfig
from diligentfx_tpu_torch.gltf.primitives import MeshData
from diligentfx_tpu_torch.hydrogent.task_manager import (FrameSettings,
                                                         FrameState,
                                                         HnTaskManager,
                                                         TaskManagerCreateInfo)
from diligentfx_tpu_torch.pbr.renderer import (PBRRenderer, RenderInfo,
                                               build_scene)
from diligentfx_tpu_torch.postfx.ssr import SSRSettings
from diligentfx_tpu_torch.postfx.taa import TAAFeatureFlags

from fxbench.reference.frame import camera_pose


class ProgramFrame:
    """A configuration on the port, ready to submit frames.  `phases`
    holds the seconds of each step of its set-up."""

    def __init__(self, cfg: dict, entries, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.width, self.height = cfg["width"], cfg["height"]
        self.phases: Dict[str, float] = {}
        t = time.perf_counter()
        self.scene = build_scene(
            [(MeshData(*mesh), node, PBRMaterialBasicAttribs.create(**mat))
             for mesh, node, mat in entries], device=self.device)
        self._sync()
        self.phases["scene_upload_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.renderer = PBRRenderer(PBRRendererCreateInfo(**cfg["renderer"]),
                                    raster_cfg=RasterizerConfig(**cfg["raster"]),
                                    device=self.device)
        self._sync()
        self.phases["ibl_precompute_s"] = time.perf_counter() - t
        opts = dict(cfg["task_manager"])
        if "taa_feature_flags" in opts:
            flags = 0
            for name in opts["taa_feature_flags"]:
                flags |= getattr(TAAFeatureFlags, name)
            opts["taa_feature_flags"] = flags
        self.tm = HnTaskManager(self.renderer, TaskManagerCreateInfo(**opts))
        self.settings = FrameSettings(ssr=SSRSettings(
            max_traversal_intersections=cfg["ssr_max_traversal_intersections"]))
        entry = cfg["entry"]
        if entry not in ("execute", "execute_split"):
            raise ValueError(f"unknown entry {entry!r}")
        self._split = entry == "execute_split"
        self._constants = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def info(self, angle: float) -> RenderInfo:
        """The frame's camera and sun, built by the port's own helpers as
        examples/benchmark_suite.py `atrium_info` builds them, on the host,
        and sent to the device from pinned memory by copies that do not
        wait for the stream: a frame's inputs never hold back the frames
        in flight."""
        c, s = self.cfg["camera"], self.cfg["sun"]
        eye, target = camera_pose(self.cfg, angle)
        view = m3.look_at(eye, target, device="cpu")
        proj = m3.perspective(c["fov"], self.width / self.height, c["near"],
                              c["far"], device="cpu")
        cam = CameraAttribs.create(view, proj, eye, c["near"], c["far"],
                                   self.width, self.height, device="cpu")
        if self._constants is None:
            self._constants = (
                upload(PBRLightAttribs.directional(
                    s["direction"], s["intensity"], device="cpu"),
                    self.device),
                upload(PBRRendererShaderParameters.create(device="cpu"),
                       self.device))
        lights, params = self._constants
        return RenderInfo(camera=upload(cam, self.device), lights=lights,
                          renderer_params=params)

    def initial_state(self) -> FrameState:
        return self.tm.initial_state(self.width, self.height)

    def submit(self, info: RenderInfo, state: FrameState):
        """Enqueue one frame through the configuration's entry."""
        kw = dict(width=self.width, height=self.height,
                  settings=self.settings)
        if self._split:
            return self.tm.execute_split(
                self.scene, info, state,
                gbuffer_bands=self.cfg["gbuffer_bands"], **kw)
        return self.tm.execute(self.scene, info, state, **kw)


def upload(attribs, device):
    """A tuple of host tensors on `device`: each through pinned memory by a
    copy that does not block the host (the caching host allocator keeps
    the pinned block until the copy has run)."""
    device = torch.device(device)
    if device.type != "cuda":
        return attribs
    return type(attribs)(*[
        f.pin_memory().to(device, non_blocking=True) if torch.is_tensor(f)
        else f for f in attribs])


def state_dict(state: FrameState, clone: bool = False) -> Dict:
    """The port's FrameState as the plain dict the reference reads; with
    `clone`, copies of its tensors, which no later frame can overwrite."""
    d = {"frame_index": state.frame_index,
         "prev_view_proj": state.prev_view_proj}
    if state.taa is not None:
        d["taa_color"] = state.taa.color
        d["taa_sample_count"] = state.taa.sample_count
    if state.ssr is not None:
        d["ssr_radiance"] = state.ssr.radiance
    if state.ssao is not None:
        d["ssao_history"] = state.ssao.history
        d["ssao_depth_history"] = state.ssao.depth_history
    if state.prev_depth is not None:
        d["prev_depth"] = state.prev_depth
    if clone:
        d = {k: v.clone() if torch.is_tensor(v) else v for k, v in d.items()}
    return d
