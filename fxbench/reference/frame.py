"""The reference frame: one frame of a configuration, computed by the
frozen plain copy in `fxbench.reference.dfx` from the configuration's own
numbers and the seed, with no object, weight or table of the port.

It follows the port's frame task graph (hydrogent/task_manager.py
`execute` / `execute_split` with `_frame_fx` and `_frame_post`) for the
stages a benchmark configuration may turn on: BeginFrame with the TAA
jitter, the G-buffer (whole or in row bands), the post-processing context
and the history disocclusion, SSAO, SSR, the composite, TAA, bloom, the
tone map and sRGB.  A configuration that turns on another stage is
refused.

`lowp=True` makes the precision control: the same frame with the vertex
buffer, every float image of the G-buffer, the composite and the carried
history rounded to bfloat16 at each stage boundary (what a change that
stores them in bfloat16 would compute).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fxbench.reference.dfx import math3d as m3
from fxbench.reference.dfx.attribs import (CameraAttribs, PBRLightAttribs,
                                           PBRMaterialBasicAttribs,
                                           PBRRendererShaderParameters)
from fxbench.reference.dfx.config import (PBRRendererCreateInfo,
                                          RasterizerConfig, ToneMappingMode)
from fxbench.reference.dfx.gltf.primitives import MeshData
from fxbench.reference.dfx.pbr.deferred import (render_gbuffer,
                                                render_gbuffer_banded)
from fxbench.reference.dfx.pbr.renderer import (PBRRenderer, RenderInfo,
                                                build_scene)
from fxbench.reference.dfx.postfx import bloom as fx_bloom
from fxbench.reference.dfx.postfx import ssao as fx_ssao
from fxbench.reference.dfx.postfx import ssr as fx_ssr
from fxbench.reference.dfx.postfx import taa as fx_taa
from fxbench.reference.dfx.postfx.context import (apply_jitter_to_proj,
                                                  disocclusion_mask,
                                                  jitter_to_ndc,
                                                  prepare_postfx_resources,
                                                  taa_jitter_sequence)
from fxbench.reference.dfx.postfx.tonemap import ToneMappingAttribs, tone_map

Tensor = torch.Tensor

# the task manager's create-info fields a configuration may set, with the
# port's defaults (TaskManagerCreateInfo); any other key is refused
TASK_DEFAULTS = dict(
    enable_ssao=True, ssao_half_resolution=True, ssao_use_pallas=False,
    ssao_num_slices=3, ssao_num_steps=6, enable_ssr=True,
    ssr_half_resolution=False, enable_taa=True, enable_bloom=True,
    taa_feature_flags=["BICUBIC_FILTER", "YCOCG_COLOR_SPACE",
                       "GAUSSIAN_WEIGHTING"])
STATE_KEYS = ("taa_color", "taa_sample_count", "ssr_radiance",
              "ssao_history", "ssao_depth_history", "prev_depth")


def task_options(cfg: dict) -> dict:
    unknown = set(cfg["task_manager"]) - set(TASK_DEFAULTS)
    if unknown:
        raise ValueError(f"the reference has no stage for {sorted(unknown)}")
    out = dict(TASK_DEFAULTS, **cfg["task_manager"])
    flags = 0
    for name in out["taa_feature_flags"]:
        flags |= getattr(fx_taa.TAAFeatureFlags, name)
    out["taa_flags"] = flags
    return out


def _bf16(t: Optional[Tensor]) -> Optional[Tensor]:
    if t is None or not t.is_floating_point():
        return t
    return t.to(torch.bfloat16).to(torch.float32)


def camera_pose(cfg: dict, angle: float):
    """The eye and target of the configuration's camera at `angle` rad
    round its orbit (examples/benchmark_suite.py atrium_info)."""
    c = cfg["camera"]
    eye = [c["radius"] * float(np.sin(angle)), c["height"],
           c["radius"] * float(np.cos(angle))]
    return eye, c["target"]


def _on(attribs, device):
    return type(attribs)(*[f.to(device) if torch.is_tensor(f) else f
                           for f in attribs])


def camera(cfg: dict, angle: float, device) -> CameraAttribs:
    """The configuration's camera at `angle` rad round its orbit, worked
    out on the host (as the benchmark hands it to the port) and moved to
    `device`."""
    c = cfg["camera"]
    eye, target = camera_pose(cfg, angle)
    view = m3.look_at(eye, target, device="cpu")
    proj = m3.perspective(c["fov"], cfg["width"] / cfg["height"], c["near"],
                          c["far"], device="cpu")
    return _on(CameraAttribs.create(view, proj, eye, c["near"], c["far"],
                                    cfg["width"], cfg["height"],
                                    device="cpu"), device)


class ReferenceFrame:
    """A configuration's scene, IBL maps and frame function on `device`."""

    def __init__(self, cfg: dict, entries, device, lowp: bool = False,
                 ibl_from: Optional["ReferenceFrame"] = None):
        """`ibl_from`: a ReferenceFrame of the same renderer settings whose
        environment and IBL maps this one takes instead of computing them
        again (the maps depend on no seed)."""
        self.cfg, self.device, self.lowp = cfg, torch.device(device), lowp
        self.opt = task_options(cfg)
        self.width, self.height = cfg["width"], cfg["height"]
        meshes = []
        for mesh, node, mat in entries:
            m = MeshData(*mesh)
            if lowp:
                m = m._replace(positions=_bf16(torch.from_numpy(
                    m.positions)).numpy(), normals=_bf16(torch.from_numpy(
                        m.normals)).numpy())
            meshes.append((m, node, PBRMaterialBasicAttribs.create(**mat)))
        self.scene = build_scene(meshes, device=self.device)
        self.raster_cfg = RasterizerConfig(**cfg["raster"])
        shared = {} if ibl_from is None else dict(
            env_oct=ibl_from.renderer.env_oct,
            ibl_maps=ibl_from.renderer.ibl_maps)
        self.renderer = PBRRenderer(PBRRendererCreateInfo(**cfg["renderer"]),
                                    raster_cfg=self.raster_cfg,
                                    device=self.device, **shared)
        if self.renderer.ci.enable_clear_coat:
            raise ValueError("the reference has no clear coat layer")
        self.jitter_seq = taa_jitter_sequence(16, self.device)
        self.ssr_settings = fx_ssr.SSRSettings(
            max_traversal_intersections=cfg["ssr_max_traversal_intersections"])

    def info(self, angle: float) -> RenderInfo:
        s, dev = self.cfg["sun"], self.device
        return RenderInfo(
            camera=camera(self.cfg, angle, dev),
            lights=_on(PBRLightAttribs.directional(
                s["direction"], s["intensity"], device="cpu"), dev),
            renderer_params=_on(PBRRendererShaderParameters.create(
                device="cpu"), dev))

    def initial_state(self) -> Dict:
        """The task manager's initial_state, as a plain dict."""
        o, dev, h, w = self.opt, self.device, self.height, self.width
        z1 = torch.zeros((h, w), dtype=torch.float32, device=dev)
        st = {"frame_index": 0,
              "prev_view_proj": torch.eye(4, dtype=torch.float32, device=dev)}
        if o["enable_taa"]:
            st["taa_color"] = torch.zeros((h, w, 3), dtype=torch.float32,
                                          device=dev)
            st["taa_sample_count"] = z1
        if o["enable_ssr"]:
            shape = fx_ssr.ssr_state_shape(h, w, 0, o["ssr_half_resolution"])
            st["ssr_radiance"] = torch.zeros(shape + (4,), dtype=torch.float32,
                                             device=dev)
        if o["enable_ssao"]:
            st["ssao_history"] = z1 + 1.0
            st["ssao_depth_history"] = z1 + 1.0
        if o["enable_taa"] or o["enable_ssr"] or o["enable_ssao"]:
            st["prev_depth"] = z1 + 1.0
        return st

    def frame(self, info: RenderInfo, state: Dict):
        """One frame from `state` -> (sRGB colour (H, W, 3), depth (H, W),
        node id (H, W), the state the frame hands on)."""
        o, ren = self.opt, self.renderer
        w, h = self.width, self.height
        st = {k: v.to(self.device) if torch.is_tensor(v) else v
              for k, v in state.items()}
        first_frame = st["frame_index"] == 0
        # BeginFrame: the TAA jitter and the previous view-projection
        cam = info.camera
        if o["enable_taa"]:
            j_px = self.jitter_seq[st["frame_index"] % self.jitter_seq.shape[0]]
            j_ndc = jitter_to_ndc(j_px, w, h)
            cam = CameraAttribs.create(cam.view,
                                       apply_jitter_to_proj(cam.proj, j_ndc),
                                       cam.position, cam.near_z, cam.far_z,
                                       w, h, jitter=j_ndc)
        prev_vp = cam.view_proj if first_frame else st["prev_view_proj"]
        info = info._replace(camera=cam, prev_view_proj=prev_vp)
        kw = dict(width=w, height=h, cfg=ren.raster_cfg,
                  use_ibl=ren.ci.enable_ibl, use_lights=True)
        bands = self.cfg["gbuffer_bands"]
        if self.cfg["entry"] == "execute_split" and bands > 1:
            gb = render_gbuffer_banded(self.scene, info, ren.ibl_maps,
                                       ren.env_oct, bands=bands, **kw)
        else:
            gb = render_gbuffer(self.scene, info, ren.ibl_maps, ren.env_oct,
                                **kw)
        if self.lowp:
            gb = gb._replace(**{f: _bf16(getattr(gb, f)) for f in (
                "normal_world", "normal_view", "base_color", "material_data",
                "motion", "world_pos", "direct", "ambient_diffuse",
                "ambient_specular", "spec_env_factor", "background")})
        color, new_st = self._effects(gb, info, st, first_frame)
        return color, gb.depth, gb.mesh_id, new_st

    def _effects(self, gb, info, st, first_frame):
        o, dev = self.opt, self.device
        prev_depth = st.get("prev_depth", gb.depth)
        res = prepare_postfx_resources(gb.depth, info.camera, info.camera,
                                       prev_depth, st["frame_index"],
                                       object_motion=gb.motion)
        disocc = None
        if "prev_depth" in st:
            use_pl = bool(o["ssao_use_pallas"] or (
                o["taa_flags"] & fx_taa.TAAFeatureFlags.PALLAS_WARP))
            disocc = disocclusion_mask(gb.depth, prev_depth, gb.motion,
                                       info.camera, st["prev_view_proj"],
                                       use_pallas=use_pl)
            if first_frame:
                disocc = torch.ones_like(disocc)
        new_st = {"frame_index": st["frame_index"] + 1,
                  "prev_view_proj": info.camera.view_proj}
        ao = None
        if o["enable_ssao"]:
            ao, ssao_st = fx_ssao.apply_ssao(
                gb.depth, gb.normal_view, info.camera, st["frame_index"],
                fx_ssao.SSAOSettings(),
                state=fx_ssao.SSAOState(st["ssao_history"],
                                        st["ssao_depth_history"]),
                motion=gb.motion, half_resolution=o["ssao_half_resolution"],
                num_slices=o["ssao_num_slices"],
                num_steps=o["ssao_num_steps"],
                use_pallas=o["ssao_use_pallas"], disocclusion=disocc)
            # ssao_scale 1, applied as the port applies it: 1 - (1 - ao)
            # may differ from ao in the last bit
            ao = 1.0 - (1.0 - ao) * 1.0
            new_st["ssao_history"] = ssao_st.history
            new_st["ssao_depth_history"] = ssao_st.depth_history
        ssr_rad = None
        if o["enable_ssr"]:
            refl_src = torch.where(
                gb.hit[..., None],
                gb.direct + gb.ambient_diffuse + gb.ambient_specular,
                gb.background)
            ssr_rad, ssr_st = fx_ssr.compute_ssr(
                refl_src, gb.depth, gb.normal_view,
                gb.material_data[..., 1:2], info.camera, st["frame_index"],
                self.ssr_settings,
                state=fx_ssr.SSRState(st["ssr_radiance"]), motion=gb.motion,
                half_resolution=o["ssr_half_resolution"],
                resolution_divisor=0, disocclusion=disocc,
                enable_spatial=True, enable_bilateral=True)
            new_st["ssr_radiance"] = ssr_st.radiance
        # the composite: AO on both ambient terms, SSR into the specular
        spec = gb.ambient_specular
        if ssr_rad is not None:
            conf = torch.clamp(ssr_rad[..., 3:4] * 1.0, 0.0, 1.0)
            spec = spec + (ssr_rad[..., :3] * gb.spec_env_factor - spec) * conf
        ao1 = ao[..., None] if ao is not None else 1.0
        color = gb.direct + ao1 * gb.ambient_diffuse + ao1 * spec
        color = torch.where(gb.hit[..., None], color, gb.background)
        if self.lowp:
            color = _bf16(color)
        if o["enable_taa"]:
            taa_st = (fx_taa.TAAState(color=color,
                                      sample_count=torch.ones_like(gb.depth))
                      if first_frame else
                      fx_taa.TAAState(st["taa_color"], st["taa_sample_count"]))
            color, taa_new = fx_taa.taa_accumulate(
                color, taa_st, res, fx_taa.TAASettings(),
                feature_flags=o["taa_flags"], disocclusion=disocc)
            new_st["taa_color"] = taa_new.color
            new_st["taa_sample_count"] = taa_new.sample_count
        if o["enable_bloom"]:
            color = fx_bloom.apply_bloom(color, fx_bloom.BloomSettings())
        color = tone_map(color, ToneMappingMode.UNCHARTED2,
                         ToneMappingAttribs(),
                         ave_log_lum=info.renderer_params.average_log_lum)
        color = m3.linear_to_srgb(color)
        if "prev_depth" in st:
            new_st["prev_depth"] = gb.depth
        if self.lowp:
            new_st = {k: _bf16(v) if torch.is_tensor(v) and k in STATE_KEYS
                      else v for k, v in new_st.items()}
        return color, new_st

