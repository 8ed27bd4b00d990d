"""Carry the JAX package's state into the port.

Each function takes the JAX package's object (its arrays are read through
numpy, so this module imports neither JAX nor the JAX package) and returns
the port's counterpart with tensors on `device`.  Tests use it to feed both
sides the same scene, IBL maps and frame state.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                          PBRMaterialAnisotropyAttribs,
                                          PBRMaterialBasicAttribs,
                                          PBRMaterialIridescenceAttribs,
                                          PBRMaterialSheenAttribs,
                                          PBRMaterialTransmissionAttribs,
                                          PBRMaterialVolumeAttribs,
                                          PBRRendererShaderParameters)
from diligentfx_tpu_torch.components.depth_range import DepthRange
from diligentfx_tpu_torch.components.shadow_atlas import ShadowAtlasManager
from diligentfx_tpu_torch.components.shadow_map_manager import \
    ShadowMapAttribs
from diligentfx_tpu_torch.config import RasterizerConfig
from diligentfx_tpu_torch.hydrogent.task_manager import (BoundBoxParams,
                                                         FrameSettings,
                                                         FrameState,
                                                         TaskManagerCreateInfo)
from diligentfx_tpu_torch.ops.texture import TextureAtlas, TextureHeap
from diligentfx_tpu_torch.pbr.deferred import GBufferData
from diligentfx_tpu_torch.pbr.renderer import RenderInfo, ScenePrimitives
from diligentfx_tpu_torch.pbr.shading import IBLMaps
from diligentfx_tpu_torch.postfx.dof import DoFState
from diligentfx_tpu_torch.postfx.epipolar import EpipolarSettings
from diligentfx_tpu_torch.postfx.ssao import SSAOState
from diligentfx_tpu_torch.postfx.ssr import SSRState
from diligentfx_tpu_torch.postfx.taa import TAAState


def tensor(x, device=None) -> torch.Tensor:
    """One array -> tensor on `device` (dtype kept; bools stay bool)."""
    return torch.as_tensor(np.array(x)).to(device)


def _fields(obj, cls, device):
    return cls(*(tensor(getattr(obj, f), device) for f in cls._fields))


_EXTENSIONS = {"materials_sheen": PBRMaterialSheenAttribs,
               "materials_anisotropy": PBRMaterialAnisotropyAttribs,
               "materials_iridescence": PBRMaterialIridescenceAttribs,
               "materials_transmission": PBRMaterialTransmissionAttribs,
               "materials_volume": PBRMaterialVolumeAttribs}


def scene_from_jax(scene, device=None) -> ScenePrimitives:
    """ScenePrimitives with its texture bindings (tex_ids,
    tex_uv_transform, tex_wraps), the alpha-mask tail (mask_indices), the
    blend geometry (blend_indices, blend_tri_material), the stacked
    material-extension attribs and the skinning data (joints, weights,
    joint_matrices, prev_joint_matrices) when present.  Takes a JAX
    RenderScene's scene (gltf/model.py) as well as a ScenePrimitives of
    build_scene."""
    base = {f: tensor(getattr(scene, f), device)
            for f in ("positions", "normals", "uvs", "tangents", "indices",
                      "vertex_node", "tri_material", "tri_double_sided",
                      "node_matrices", "prev_node_matrices")}
    for f in ("tex_ids", "tex_uv_transform", "tex_wraps", "mask_indices",
              "blend_indices", "blend_tri_material", "joints", "weights",
              "joint_matrices", "prev_joint_matrices"):
        if getattr(scene, f) is not None:
            base[f] = tensor(getattr(scene, f), device)
    for f, cls in _EXTENSIONS.items():
        if getattr(scene, f) is not None:
            base[f] = _fields(getattr(scene, f), cls, device)
    return ScenePrimitives(
        materials=_fields(scene.materials, PBRMaterialBasicAttribs, device),
        **base)


def ibl_maps_from_jax(maps, device=None) -> IBLMaps:
    """IBLMaps: the fields the port's shading reads."""
    return IBLMaps(
        irradiance=tensor(maps.irradiance, device),
        prefiltered=tuple(tensor(m, device) for m in maps.prefiltered),
        preintegrated_ggx=tensor(maps.preintegrated_ggx, device),
        preintegrated_charlie=tensor(maps.preintegrated_charlie, device),
        sheen_albedo_scaling=tensor(maps.sheen_albedo_scaling, device),
        irradiance_sh=tensor(maps.irradiance_sh, device),
        env_brdf_coeffs=tensor(maps.env_brdf_coeffs, device),
        pref_packed=tensor(maps.pref_packed, device))


def camera_from_jax(cam, device=None) -> CameraAttribs:
    return _fields(cam, CameraAttribs, device)


def cameras_from_jax(batched_cams, device=None) -> List[CameraAttribs]:
    """The views of a batched CameraAttribs (jax.vmap of a camera maker:
    every field with a leading view axis), one port camera each."""
    fields = {f: np.asarray(getattr(batched_cams, f))
              for f in CameraAttribs._fields}
    return [CameraAttribs(**{f: tensor(a[i], device)
                             for f, a in fields.items()})
            for i in range(fields["view"].shape[0])]


def lights_from_jax(lights, device=None) -> PBRLightAttribs:
    return _fields(lights, PBRLightAttribs, device)


def shader_params_from_jax(params, device=None) -> PBRRendererShaderParameters:
    return _fields(params, PBRRendererShaderParameters, device)


def atlas_from_jax(atlas, device=None) -> TextureAtlas:
    """TextureAtlas (mips, scale_bias, layer)."""
    return TextureAtlas(mips=tuple(tensor(m, device) for m in atlas.mips),
                        scale_bias=tensor(atlas.scale_bias, device),
                        layer=tensor(atlas.layer, device))


def heap_from_jax(heap, device=None) -> TextureHeap:
    """TextureHeap (texels, mip_base, mip_size, num_mips)."""
    return TextureHeap(texels=tensor(heap.texels, device),
                       mip_base=tensor(heap.mip_base, device),
                       mip_size=tensor(heap.mip_size, device),
                       num_mips=int(heap.num_mips))


def shadow_atlas_from_jax(atlas) -> ShadowAtlasManager:
    """ShadowAtlasManager with the JAX manager's sizes and allocator state:
    capacity, free list, and each light's kind and slices in insertion
    order."""
    out = ShadowAtlasManager(slice_size=atlas.slice_size,
                             initial_slices=atlas.initial_slices,
                             max_slices=atlas.max_slices)
    out._capacity = atlas.capacity
    out._free = list(atlas._free)
    out._lights = {k: (kind, list(sl))
                   for k, (kind, sl) in atlas._lights.items()}
    return out


def shadow_attribs_from_jax(attribs, device=None) -> ShadowMapAttribs:
    """ShadowMapAttribs of distribute_cascades."""
    return _fields(attribs, ShadowMapAttribs, device)


def render_info_from_jax(info, device=None) -> RenderInfo:
    """RenderInfo with the cascaded shadow inputs (attribs, maps, moments)
    and the per-light shadow slices (maps, view-projections)."""
    opt = {f: (tensor(getattr(info, f), device)
               if getattr(info, f) is not None else None)
           for f in ("model_transform", "prev_view_proj", "shadow_maps",
                     "shadow_moments", "light_shadow_maps",
                     "light_shadow_view_projs")}
    att = (shadow_attribs_from_jax(info.shadow_attribs, device)
           if info.shadow_attribs is not None else None)
    return RenderInfo(camera=camera_from_jax(info.camera, device),
                      lights=lights_from_jax(info.lights, device),
                      renderer_params=shader_params_from_jax(
                          info.renderer_params, device), shadow_attribs=att,
                      **opt)


def _settings(obj, cls):
    """A settings NamedTuple of Python numbers, field by field, each of the
    type of the port's default (the JAX package keeps float32 scalars)."""
    return cls(**{f: type(d)(np.asarray(getattr(obj, f)).item())
                  for f, d in zip(cls._fields, cls())})


def frame_settings_from_jax(settings, device=None) -> FrameSettings:
    """FrameSettings: the effects' settings, the selected ids and the bound
    box (tensors on `device`)."""
    port = FrameSettings()
    kw = {f: _settings(getattr(settings, f), type(d))
          for f, d in zip(FrameSettings._fields, port)
          if f not in ("selected_ids", "bound_box")}
    if settings.selected_ids is not None:
        kw["selected_ids"] = tensor(settings.selected_ids, device)
    bb = settings.bound_box
    if bb is not None:
        kw["bound_box"] = BoundBoxParams(
            box_min=tensor(bb.box_min, device).to(torch.float32),
            box_max=tensor(bb.box_max, device).to(torch.float32),
            transform=(tensor(bb.transform, device)
                       if bb.transform is not None else None))
    return FrameSettings(**kw)


def gbuffer_from_jax(gb, device=None) -> GBufferData:
    """GBufferData with its debug payload (the JAX package's `debug` dict)
    when present; AOVs the JAX frame dropped stay None."""
    def opt(x):
        return tensor(x, device) if x is not None else None
    fields = {f: opt(getattr(gb, f)) for f in GBufferData._fields
              if f != "debug"}
    debug = ({k: tensor(v, device) for k, v in gb.debug.items()}
             if gb.debug is not None else None)
    return GBufferData(**fields, debug=debug)


def depth_range_from_jax(dr, device=None) -> DepthRange:
    """DepthRange of compute_depth_range (0-dim tensors)."""
    return _fields(dr, DepthRange, device)


def epipolar_settings_from_jax(settings) -> EpipolarSettings:
    """EpipolarSettings: the structural ints and modes and the float32
    scalars, field by field."""
    return _settings(settings, EpipolarSettings)


def frame_state_from_jax(state, device=None) -> FrameState:
    """FrameState: TAA, SSR, SSAO and DoF histories, the adapted exposure
    and the previous depth."""

    def opt(x):
        return tensor(x, device) if x is not None else None

    taa = (TAAState(color=tensor(state.taa.color, device),
                    sample_count=tensor(state.taa.sample_count, device))
           if state.taa is not None else None)
    ssr = (SSRState(radiance=tensor(state.ssr.radiance, device))
           if state.ssr is not None else None)
    ssao = (SSAOState(history=tensor(state.ssao.history, device),
                      depth_history=opt(state.ssao.depth_history))
            if state.ssao is not None else None)
    dof = (DoFState(coc_history=tensor(state.dof.coc_history, device))
           if state.dof is not None else None)
    return FrameState(frame_index=int(np.asarray(state.frame_index)),
                      prev_view_proj=tensor(state.prev_view_proj, device),
                      taa=taa, ssr=ssr, ssao=ssao, dof=dof,
                      average_log_lum=opt(state.average_log_lum),
                      prev_depth=opt(state.prev_depth))


def raster_config_from_jax(cfg) -> RasterizerConfig:
    """RasterizerConfig (the profiling knobs must be off)."""
    if getattr(cfg, "bin_cut", "") or getattr(cfg, "skip_pair_compaction",
                                              False):
        raise NotImplementedError("profiling knobs are not ported")
    names = {f.name for f in dataclasses.fields(RasterizerConfig)}
    return RasterizerConfig(**{n: getattr(cfg, n) for n in names})


def task_manager_ci_from_jax(ci) -> TaskManagerCreateInfo:
    """TaskManagerCreateInfo with the same switches (enums by value)."""
    kw = {}
    for f in dataclasses.fields(TaskManagerCreateInfo):
        v = getattr(ci, f.name)
        default = f.default
        kw[f.name] = type(default)(int(v)) if isinstance(
            default, (int,)) and not isinstance(default, bool) else v
    return TaskManagerCreateInfo(**kw)


def mesh_from_jax(mesh, device="cpu"):
    """A RenderMesh of the JAX mesh's shape and axis names, every device
    mapped to `device` (the JAX tests' virtual host devices: the CPU, or
    one card, repeated)."""
    from diligentfx_tpu_torch.parallel.mesh import RenderMesh
    grid = np.empty(np.shape(mesh.devices), dtype=object)
    grid[...] = torch.device(device)
    return RenderMesh(grid, tuple(mesh.axis_names))


def banded_state_from_jax(state, mesh):
    """BandedFrameState of the port on `mesh` (a RenderMesh) from the JAX
    package's (parallel/tiling.py): the band-sharded entries split into
    the mesh's bands, each on its device, the replicated ones copied to
    each distinct device."""
    from diligentfx_tpu_torch.parallel.mesh import band_sharding, replicated
    from diligentfx_tpu_torch.parallel.tiling import BandedFrameState
    devices = band_sharding(mesh)
    repl = replicated(mesh)

    def bands(x):
        if x is None:
            return None
        parts = np.split(np.asarray(x), len(devices), axis=0)
        return [tensor(p, d) for p, d in zip(parts, devices)]

    def copies(x):
        return None if x is None else [tensor(x, d) for d in repl]
    return BandedFrameState(
        frame_index=int(np.asarray(state.frame_index)),
        prev_view_proj=copies(state.prev_view_proj),
        taa_color=bands(state.taa_color), taa_count=bands(state.taa_count),
        ssao_history=bands(state.ssao_history),
        ssao_depth_history=bands(state.ssao_depth_history),
        ssr_radiance=copies(state.ssr_radiance),
        dof_coc=copies(state.dof_coc), prev_depth=bands(state.prev_depth))
