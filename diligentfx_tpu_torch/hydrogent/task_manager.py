"""Frame task graph (the port of diligentfx_tpu/hydrogent/task_manager.py):
[shadow pass] -> BeginFrame (TAA jitter) -> G-buffer main pass (textured
from the atlas or the texture heap, shadowed by the cascades or by each
light's slices of the shadow atlas, alpha-masked geometry resolved)
-> PostFX context + history disocclusion -> SSAO -> SSR -> composite ->
K-layer OIT of the blend geometry -> the editor components (coordinate
grid, bound box, selection desaturation and outline, depth bounds) ->
epipolar light scattering -> auto exposure -> TAA -> DoF -> bloom -> [a
debug view] -> tone map -> sRGB -> [the motion-vector field].

`execute_split` renders the same frame through the same three stages,
with the G-buffer optionally shaded in row bands (`gbuffer_bands`; the
JAX package's 4K form).

`FrameState` carries the temporal history between frames.  The SSR
profiling knobs raise NotImplementedError when the task manager is built;
no switch is silently ignored.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import CameraAttribs
from diligentfx_tpu_torch.components import renderers as comp
from diligentfx_tpu_torch.components import selection as sel
from diligentfx_tpu_torch.components import shadow_map_manager as smm
from diligentfx_tpu_torch.components.depth_range import (DepthRange,
                                                         compute_depth_range)
from diligentfx_tpu_torch.config import (DebugViewType, ShadowMode,
                                         ToneMappingMode)
from diligentfx_tpu_torch.ops.raster import pad_viewport
from diligentfx_tpu_torch.pbr import oit
from diligentfx_tpu_torch.pbr.deferred import (GBufferData, render_gbuffer,
                                               render_gbuffer_banded)
from diligentfx_tpu_torch.pbr.renderer import (PBRRenderer, RenderInfo,
                                               ScenePrimitives,
                                               transform_vertices)
from diligentfx_tpu_torch.postfx import bloom as fx_bloom
from diligentfx_tpu_torch.postfx import dof as fx_dof
from diligentfx_tpu_torch.postfx import epipolar as fx_epi
from diligentfx_tpu_torch.postfx import ssao as fx_ssao
from diligentfx_tpu_torch.postfx import ssr as fx_ssr
from diligentfx_tpu_torch.postfx import taa as fx_taa
from diligentfx_tpu_torch.postfx.context import (PostFXResources,
                                                 apply_jitter_to_proj,
                                                 disocclusion_mask,
                                                 jitter_to_ndc,
                                                 prepare_postfx_resources,
                                                 taa_jitter_sequence)
from diligentfx_tpu_torch.postfx.tonemap import (ToneMappingAttribs,
                                                 average_log_luminance,
                                                 reverse_exp_tone_map,
                                                 tone_map)

Tensor = torch.Tensor


@dataclass(frozen=True)
class TaskManagerCreateInfo:
    """Static pipeline configuration; same fields and defaults as the JAX
    package's TaskManagerCreateInfo."""
    enable_shadows: bool = False
    shadow_mode: ShadowMode = ShadowMode.PCF
    num_cascades: int = 4
    shadow_map_size: int = 1024
    enable_ssao: bool = True
    ssao_half_resolution: bool = True
    enable_ssr: bool = True
    ssr_half_resolution: bool = False
    ssr_resolution_divisor: int = 0
    enable_taa: bool = True
    enable_dof: bool = False
    enable_bloom: bool = True
    tone_mapping_mode: ToneMappingMode = ToneMappingMode.UNCHARTED2
    convert_output_to_srgb: bool = True
    ssr_scale: float = 1.0
    ssao_scale: float = 1.0
    oit_layer_count: int = 4
    taa_feature_flags: int = (fx_taa.TAAFeatureFlags.BICUBIC_FILTER
                              | fx_taa.TAAFeatureFlags.YCOCG_COLOR_SPACE
                              | fx_taa.TAAFeatureFlags.GAUSSIAN_WEIGHTING)
    ssao_num_slices: int = 3
    ssao_num_steps: int = 6
    ssao_use_pallas: bool = False
    ssr_use_pallas: bool = False
    ssr_enable_spatial: bool = True
    ssr_enable_bilateral: bool = True
    ssr_stage_cut: str = ""
    ssr_march_sweep: str = "dyn"
    fast_env_taps: bool = False
    dof_use_pallas: bool = False
    view_mode: DebugViewType = DebugViewType.NONE
    enable_light_scattering: bool = False
    epipolar_slices: int = 256
    epipolar_samples: int = 128
    epipolar_march_steps: int = 24
    epipolar_use_minmax_tree: bool = False
    epipolar_refinement_factor: int = 1
    epipolar_single_sctr_lut: bool = False
    enable_auto_exposure: bool = False
    exposure_adaptation_rate: float = 0.05
    enable_selection: bool = False
    selection_outline_width: float = 3.0
    desaturation_factor: float = 0.5
    enable_grid: bool = False
    enable_bound_box: bool = False
    enable_vector_field: bool = False
    enable_depth_bounds: bool = False
    emit_aovs: bool = True
    use_lights: bool = True
    vis_only: bool = False


def _check_ci(ci: TaskManagerCreateInfo) -> None:
    if ci.ssr_stage_cut or ci.ssr_march_sweep != "dyn":
        raise NotImplementedError(
            "ssr_stage_cut and ssr_march_sweep are TPU profiling knobs and "
            "are not ported (every march sweep computes the same result)")


class BoundBoxParams(NamedTuple):
    """A frame's bound box (the RenderBoundBox task's input): its corners
    and an optional (4, 4) transform."""
    box_min: Tensor
    box_max: Tensor
    transform: Optional[Tensor] = None


class FrameSettings(NamedTuple):
    """Dynamic per-frame parameters: the effects' settings, the selected
    prim (node) ids, -1 padded (ProcessSelection; with enable_selection),
    and the bound box to draw (with enable_bound_box)."""
    ssr: fx_ssr.SSRSettings = fx_ssr.SSRSettings()
    ssao: fx_ssao.SSAOSettings = fx_ssao.SSAOSettings()
    taa: fx_taa.TAASettings = fx_taa.TAASettings()
    dof: fx_dof.DoFSettings = fx_dof.DoFSettings()
    bloom: fx_bloom.BloomSettings = fx_bloom.BloomSettings()
    tone_mapping: ToneMappingAttribs = ToneMappingAttribs()
    selected_ids: Optional[Tensor] = None
    bound_box: Optional[BoundBoxParams] = None


class FrameState(NamedTuple):
    """Temporal history carried between frames (the JAX package's
    FrameState).  frame_index is a host integer: the TAA jitter index, the
    effects' noise and the first-frame test need no device round trip;
    average_log_lum is the adapted exposure, a 0-dim tensor."""
    frame_index: int
    prev_view_proj: Tensor
    taa: Optional[fx_taa.TAAState] = None
    ssr: Optional[fx_ssr.SSRState] = None
    ssao: Optional[fx_ssao.SSAOState] = None
    dof: Optional[fx_dof.DoFState] = None
    average_log_lum: Optional[Tensor] = None
    prev_depth: Optional[Tensor] = None


class FrameOutput(NamedTuple):
    color: Tensor           # (H, W, 3) final
    gbuffer: GBufferData
    state: FrameState
    # the ComputeDepthBounds product (enable_depth_bounds): feeds the next
    # frame's cascade fitting through smm.adjust_cascade_range
    depth_range: Optional[DepthRange] = None


class FrameBegin(NamedTuple):
    """Seam between the G-buffer pass and the effects."""
    gb: GBufferData
    info: RenderInfo
    first_frame: bool


class FrameFx(NamedTuple):
    """Seam between the screen-space effects and the temporal + tone-map
    stage."""
    color: Tensor
    gb: GBufferData
    info: RenderInfo
    resources: PostFXResources
    first_frame: bool
    disocclusion: Optional[Tensor] = None
    new_ssao: Optional[fx_ssao.SSAOState] = None
    new_ssr: Optional[fx_ssr.SSRState] = None
    new_exposure: Optional[Tensor] = None
    ao: Optional[Tensor] = None              # SSAO's factor (None: off)
    depth_range: Optional[DepthRange] = None


class HnTaskManager:
    """Owns the renderer + pipeline config; `execute` runs one frame."""

    def __init__(self, renderer: PBRRenderer,
                 ci: TaskManagerCreateInfo = TaskManagerCreateInfo(),
                 atlas=None):
        """`atlas`: the material textures, a TextureAtlas or a TextureHeap
        (ops/texture.py), or None for an untextured scene."""
        _check_ci(ci)
        self.renderer = renderer
        self.ci = ci
        self.atlas = atlas
        self.device = renderer.device
        self.jitter_seq = taa_jitter_sequence(16, self.device)
        # the atmosphere's optical-depth and multiple-scattering LUTs, once
        self.atmosphere_lut = None
        if ci.enable_light_scattering:
            od = fx_epi.precompute_optical_depth_lut(device=self.device)
            self.atmosphere_lut = (
                od, fx_epi.precompute_multiple_scattering_lut(od))

    def initial_state(self, width: int, height: int) -> FrameState:
        ci, dev = self.ci, self.device
        z1 = torch.zeros((height, width), dtype=torch.float32, device=dev)
        z3 = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
        ssr_shape = fx_ssr.ssr_state_shape(height, width,
                                           ci.ssr_resolution_divisor,
                                           ci.ssr_half_resolution)
        return FrameState(
            frame_index=0,
            prev_view_proj=torch.eye(4, dtype=torch.float32, device=dev),
            taa=(fx_taa.TAAState(color=z3, sample_count=z1)
                 if ci.enable_taa else None),
            ssr=(fx_ssr.SSRState(radiance=torch.zeros(
                ssr_shape + (4,), dtype=torch.float32, device=dev))
                 if ci.enable_ssr else None),
            ssao=(fx_ssao.SSAOState(history=z1 + 1.0, depth_history=z1 + 1.0)
                  if ci.enable_ssao else None),
            dof=fx_dof.DoFState(coc_history=z1) if ci.enable_dof else None,
            average_log_lum=(torch.tensor(0.3, dtype=torch.float32,
                                          device=dev)
                             if ci.enable_auto_exposure else None),
            prev_depth=(z1 + 1.0 if (ci.enable_taa or ci.enable_ssr
                                     or ci.enable_ssao) else None))

    def reset_taa(self, state: FrameState) -> FrameState:
        """HnTaskManager::ResetTAA (JAX task_manager.py:255): the next frame
        rejects the TAA history (a camera cut, a resize); the other
        temporal products stay."""
        if state.taa is None:
            return state
        return state._replace(taa=state.taa._replace(
            sample_count=torch.zeros_like(state.taa.sample_count)))

    def suspend_super_sampling(self, state: FrameState) -> FrameState:
        """HnTaskManager::SuspendSuperSampling: reset_taa, the jitter
        sequence being stateless."""
        return self.reset_taa(state)

    def render_shadows(self, scene: ScenePrimitives, info: RenderInfo,
                       attribs: smm.ShadowMapAttribs, *,
                       shadow_map_size: int) -> RenderInfo:
        """The cascaded shadow pass of a frame, as bench.py's frame_info
        runs it before `execute` (bench.py:190-206): the cascade depth maps
        (K4 once per cascade), and for the filterable modes the moments,
        blurred.  Returns `info` carrying attribs, maps and moments.  The
        range dfx.shadows marks it for torch.profiler."""
        with torch.profiler.record_function("dfx.shadows"):
            wp, _, _ = transform_vertices(scene, info.model_transform)
            maps = smm.render_cascade_shadow_maps(
                wp, scene.indices, attribs, shadow_map_size=shadow_map_size,
                cfg=self.renderer.raster_cfg)
            moments = None
            if self.ci.shadow_mode != ShadowMode.PCF:
                moments = smm.gaussian_blur_separable(
                    smm.convert_to_filterable(maps, self.ci.shadow_mode))
        return info._replace(shadow_attribs=attribs, shadow_maps=maps,
                             shadow_moments=moments)

    def execute(self, scene: ScenePrimitives, info: RenderInfo,
                state: FrameState, *, width: int, height: int,
                settings: FrameSettings = FrameSettings(),
                light_shadow_kinds: tuple = (),
                fuse: str = "auto") -> FrameOutput:
        """One frame.  `light_shadow_kinds` gives each light's shadow kind
        ("csm", "spot", "dir", "point" or none; info carries the per-light
        slices, components/shadow_atlas.py).  `fuse` chooses the G-buffer's
        raster path (pbr/deferred.py render_gbuffer; the JAX package reads
        DFX_FUSE instead).  The blend geometry, when the scene has some and
        oit_layer_count > 0, composites through K-layer OIT after the
        screen-space effects (range dfx.oit); the editor components run in
        the range dfx.components, a debug view in dfx.debug_view."""
        # named ranges: torch.profiler attributes host and device time to
        # the frame's three stages (a few microseconds a frame otherwise);
        # the effects' own ranges nest inside them
        with torch.profiler.record_function("dfx.gbuffer"):
            begin = _frame_begin(scene, info, state, self.renderer,
                                 self.jitter_seq, self.ci, width, height,
                                 self.atlas, light_shadow_kinds, fuse=fuse)
        return self._effects(begin, scene, state, settings)

    def execute_split(self, scene: ScenePrimitives, info: RenderInfo,
                      state: FrameState, *, width: int, height: int,
                      settings: FrameSettings = FrameSettings(),
                      light_shadow_kinds: tuple = (),
                      gbuffer_bands: int = 1,
                      fuse: str = "auto") -> FrameOutput:
        """The frame of `execute` as its three stages, the G-buffer, the
        screen-space effects and the temporal + tone-map stage (JAX
        task_manager.py:285, where each stage is a program of its own).
        gbuffer_bands > 1 shades the G-buffer in row bands after one raster
        (pbr/deferred.py render_gbuffer_banded); a debug view and vis_only
        need the whole G-buffer and refuse the bands.  The same FrameOutput
        as `execute`."""
        if gbuffer_bands <= 1:
            return self.execute(scene, info, state, width=width,
                                height=height, settings=settings,
                                light_shadow_kinds=light_shadow_kinds,
                                fuse=fuse)
        if self.ci.view_mode != DebugViewType.NONE or self.ci.vis_only:
            raise ValueError("the banded G-buffer has no debug payload and "
                             "no vis_only form: a debug view or vis_only "
                             "takes gbuffer_bands=1")
        with torch.profiler.record_function("dfx.gbuffer"):
            info2, first_frame, shadow_mode = _begin_camera(
                info, state, self.jitter_seq, self.ci, width, height)
            ren = self.renderer
            gb = render_gbuffer_banded(
                scene, info2, ren.ibl_maps, ren.env_oct, width=width,
                height=height, cfg=ren.raster_cfg, bands=gbuffer_bands,
                use_ibl=ren.ci.enable_ibl, use_lights=self.ci.use_lights,
                shadow_mode=shadow_mode,
                pcf_kernel_size=ren.ci.pcf_kernel_size, atlas=self.atlas,
                use_textures=self.atlas is not None,
                enable_clearcoat=ren.ci.enable_clear_coat,
                fast_env=self.ci.fast_env_taps,
                light_shadow_kinds=light_shadow_kinds, fuse=fuse)
            begin = FrameBegin(gb=gb, info=info2, first_frame=first_frame)
        return self._effects(begin, scene, state, settings)

    def _effects(self, begin: FrameBegin, scene: ScenePrimitives,
                 state: FrameState, settings: FrameSettings) -> FrameOutput:
        """The stages after the G-buffer: context, SSAO, SSR, composite,
        OIT, components, scattering, exposure, then TAA, DoF, bloom, the
        debug view, tone map and sRGB."""
        with torch.profiler.record_function("dfx.context_composite"):
            fx = _frame_fx(begin, state, settings, self.ci,
                           self.atmosphere_lut, scene=scene,
                           renderer=self.renderer)
        with torch.profiler.record_function("dfx.taa_bloom_tonemap"):
            return _frame_post(fx, state, settings, self.ci)


def _begin_camera(info: RenderInfo, state: FrameState, jitter_seq: Tensor,
                  ci: TaskManagerCreateInfo, width: int, height: int):
    """BeginFrame: TAA camera jitter + previous view-projection + the
    shadow mode (the configured one when shadows are on and the frame
    carries shadow attribs, else None)."""
    cam = info.camera
    first_frame = state.frame_index == 0
    if ci.enable_taa:
        j_px = jitter_seq[state.frame_index % jitter_seq.shape[0]]
        j_ndc = jitter_to_ndc(j_px, width, height)
        proj_j = apply_jitter_to_proj(cam.proj, j_ndc)
        cam = CameraAttribs.create(cam.view, proj_j, cam.position, cam.near_z,
                                   cam.far_z, width, height, jitter=j_ndc)
        info = info._replace(camera=cam)
    prev_vp = info.camera.view_proj if first_frame else state.prev_view_proj
    shadow_mode = (ci.shadow_mode if ci.enable_shadows
                   and info.shadow_attribs is not None else None)
    return info._replace(prev_view_proj=prev_vp), first_frame, shadow_mode


def _frame_begin(scene, info: RenderInfo, state: FrameState,
                 renderer: PBRRenderer, jitter_seq, ci: TaskManagerCreateInfo,
                 width: int, height: int, atlas=None,
                 light_shadow_kinds: tuple = (),
                 fuse: str = "auto") -> FrameBegin:
    """BeginFrame (TAA jitter) + the G-buffer main pass."""
    info, first_frame, shadow_mode = _begin_camera(info, state, jitter_seq,
                                                   ci, width, height)
    gb = render_gbuffer(scene, info, renderer.ibl_maps, renderer.env_oct,
                        width=width, height=height, cfg=renderer.raster_cfg,
                        use_ibl=renderer.ci.enable_ibl,
                        use_lights=ci.use_lights, shadow_mode=shadow_mode,
                        pcf_kernel_size=renderer.ci.pcf_kernel_size,
                        atlas=atlas, use_textures=atlas is not None,
                        enable_clearcoat=renderer.ci.enable_clear_coat,
                        fast_env=ci.fast_env_taps,
                        light_shadow_kinds=light_shadow_kinds, fuse=fuse,
                        emit_debug=ci.view_mode != DebugViewType.NONE,
                        vis_only=ci.vis_only)
    return FrameBegin(gb=gb, info=info, first_frame=first_frame)


def _oit(color: Tensor, gb: GBufferData, info: RenderInfo,
         scene: ScenePrimitives, renderer: PBRRenderer,
         ci: TaskManagerCreateInfo):
    """BeginOITPass / the OIT layers / EndOITPass (JAX task_manager.py:
    497-531): the blend geometry's K nearest fragments a pixel, carrying
    each triangle's base-colour alpha and colour for the tail, shaded and
    composited front to back over `color`.  Returns (colour, the cropped
    KLayerBuffer)."""
    height, width = gb.depth.shape
    cfg = renderer.raster_cfg
    pad_w, pad_h = pad_viewport(width, height, cfg)
    wp, wn, _ = transform_vertices(scene, info.model_transform)
    clip_b = m3.transform_points(wp, info.camera.view_proj)
    w = clip_b[:, 3]
    winv_b = torch.where(torch.abs(w) > 1e-12, 1.0 / w, torch.zeros_like(w))
    blend_scene = scene._replace(tri_material=scene.blend_tri_material,
                                 indices=scene.blend_indices)
    blend_bc = scene.materials.base_color_factor[
        scene.blend_tri_material.long()]
    # the tail carries each dropped fragment's own unshaded base colour
    kl = oit.rasterize_klayers(clip_b, scene.blend_indices, width=pad_w,
                               height=pad_h, cfg=cfg,
                               num_layers=ci.oit_layer_count,
                               tri_alpha=blend_bc[:, 3],
                               tri_rgb=blend_bc[:, :3])
    kl = oit.KLayerBuffer(
        depth=kl.depth[:, :height, :width],
        tri_id=kl.tri_id[:, :height, :width],
        bary=kl.bary[:, :height, :width],
        overflow=kl.overflow[:height, :width],
        tail_alpha=kl.tail_alpha[:height, :width],
        tail_color=kl.tail_color[:height, :width])
    lcol, lalpha, lalb = oit.shade_klayers(
        blend_scene, info, renderer.ibl_maps, kl, wp, wn, winv_b,
        use_ibl=renderer.ci.enable_ibl)
    return oit.composite_klayers(color, gb.depth, kl, lcol, lalpha,
                                 layer_albedos=lalb), kl


def _frame_fx(begin: FrameBegin, state: FrameState, settings: FrameSettings,
              ci: TaskManagerCreateInfo, atmosphere_lut=None, *,
              scene: Optional[ScenePrimitives] = None,
              renderer: Optional[PBRRenderer] = None) -> FrameFx:
    """PostFX context + history disocclusion + SSAO + SSR + composite +
    K-layer OIT (when `scene` has blend geometry and oit_layer_count > 0;
    `renderer` supplies the raster config and IBL) + epipolar light
    scattering + auto exposure."""
    gb, info, first_frame = begin.gb, begin.info, begin.first_frame
    prev_depth = state.prev_depth if state.prev_depth is not None else gb.depth
    resources = prepare_postfx_resources(
        gb.depth, info.camera, info.camera, prev_depth, state.frame_index,
        object_motion=gb.motion)
    disocclusion = None
    if state.prev_depth is not None:
        use_pl = bool(ci.ssao_use_pallas or (
            ci.taa_feature_flags & fx_taa.TAAFeatureFlags.PALLAS_WARP))
        disocclusion = disocclusion_mask(
            gb.depth, prev_depth, gb.motion, info.camera,
            state.prev_view_proj, use_pallas=use_pl)
        if first_frame:
            disocclusion = torch.ones_like(disocclusion)

    ao = None
    new_ssao = state.ssao
    if ci.enable_ssao:
        with torch.profiler.record_function("dfx.ssao"):
            ao, new_ssao = fx_ssao.apply_ssao(
                gb.depth, gb.normal_view, info.camera, state.frame_index,
                settings.ssao, state=state.ssao, motion=gb.motion,
                half_resolution=ci.ssao_half_resolution,
                num_slices=ci.ssao_num_slices, num_steps=ci.ssao_num_steps,
                use_pallas=ci.ssao_use_pallas, disocclusion=disocclusion)
            ao = 1.0 - (1.0 - ao) * ci.ssao_scale

    ssr_rad = None
    new_ssr = state.ssr
    if ci.enable_ssr:
        with torch.profiler.record_function("dfx.ssr"):
            # reflect the lit scene (direct + ambient + background)
            refl_src = torch.where(
                gb.hit[..., None],
                gb.direct + gb.ambient_diffuse + gb.ambient_specular,
                gb.background)
            ssr_rad, new_ssr = fx_ssr.compute_ssr(
                refl_src, gb.depth, gb.normal_view,
                gb.material_data[..., 1:2], info.camera, state.frame_index,
                settings.ssr, state=state.ssr, motion=gb.motion,
                half_resolution=ci.ssr_half_resolution,
                resolution_divisor=ci.ssr_resolution_divisor,
                disocclusion=disocclusion, use_pallas=ci.ssr_use_pallas,
                enable_spatial=ci.ssr_enable_spatial,
                enable_bilateral=ci.ssr_enable_bilateral)

    # composite (HnPostProcess.psh analogue): AO on both ambient terms, the
    # SSR confidence blend into the specular term
    spec = gb.ambient_specular
    if ssr_rad is not None:
        conf = torch.clamp(ssr_rad[..., 3:4] * ci.ssr_scale, 0.0, 1.0)
        spec = spec + (ssr_rad[..., :3] * gb.spec_env_factor - spec) * conf
    ao1 = ao[..., None] if ao is not None else 1.0
    color = gb.direct + ao1 * gb.ambient_diffuse + ao1 * spec
    color = torch.where(gb.hit[..., None], color, gb.background)

    if (scene is not None and scene.blend_indices is not None
            and ci.oit_layer_count > 0):
        with torch.profiler.record_function("dfx.oit"):
            color, _ = _oit(color, gb, info, scene, renderer, ci)

    depth_range = None
    if (ci.enable_grid or ci.enable_bound_box or ci.enable_selection
            or ci.enable_depth_bounds):
        with torch.profiler.record_function("dfx.components"):
            color, depth_range = _components(color, gb, info, settings, ci)

    if ci.enable_light_scattering and atmosphere_lut is not None:
        with torch.profiler.record_function("dfx.light_scattering"):
            shadow_data = None
            if info.shadow_attribs is not None and \
                    info.shadow_maps is not None:
                shadow_data = (info.shadow_attribs, info.shadow_maps)
            eps = fx_epi.EpipolarSettings(
                num_epipolar_slices=ci.epipolar_slices,
                max_samples_in_slice=ci.epipolar_samples,
                num_ray_march_steps=ci.epipolar_march_steps,
                use_minmax_tree=ci.epipolar_use_minmax_tree,
                refinement_factor=ci.epipolar_refinement_factor,
                single_sctr_lut=ci.epipolar_single_sctr_lut)
            od_lut, ms_lut = atmosphere_lut
            color = fx_epi.apply_light_scattering(
                color, gb.depth, info.camera, info.lights.direction[0],
                od_lut, eps, shadow_data=shadow_data, ms_lut=ms_lut).color

    # auto exposure (UpdateAverageLuminance): measure, adapt, and hand the
    # adapted value to the tone map through the shader parameters
    new_exposure = state.average_log_lum
    if ci.enable_auto_exposure:
        with torch.profiler.record_function("dfx.exposure"):
            measured = average_log_luminance(color)
            new_exposure = (measured if first_frame else
                            state.average_log_lum
                            + (measured - state.average_log_lum)
                            * ci.exposure_adaptation_rate)
            info = info._replace(renderer_params=info.renderer_params._replace(
                average_log_lum=new_exposure))
    return FrameFx(color=color, gb=gb, info=info, resources=resources,
                   first_frame=first_frame, disocclusion=disocclusion,
                   new_ssao=new_ssao, new_ssr=new_ssr,
                   new_exposure=new_exposure, ao=ao, depth_range=depth_range)


def _frame_post(fx: FrameFx, state: FrameState, settings: FrameSettings,
                ci: TaskManagerCreateInfo) -> FrameOutput:
    """Temporal stack (TAA, DoF with its temporal CoC) + bloom + tone map +
    sRGB."""
    color, gb, info = fx.color, fx.gb, fx.info
    new_taa = state.taa
    if ci.enable_taa:
        taa_state = (fx_taa.TAAState(color=color,
                                     sample_count=torch.ones_like(gb.depth))
                     if fx.first_frame else state.taa)
        color, new_taa = fx_taa.taa_accumulate(
            color, taa_state, fx.resources, settings.taa,
            feature_flags=ci.taa_feature_flags,
            disocclusion=fx.disocclusion)
    new_dof = state.dof
    if ci.enable_dof:
        with torch.profiler.record_function("dfx.dof"):
            color, new_dof = fx_dof.apply_dof(
                color, gb.depth, info.camera, settings.dof, state=state.dof,
                motion=gb.motion, use_temporal=True,
                use_pallas=ci.dof_use_pallas)
    if ci.enable_bloom:
        color = fx_bloom.apply_bloom(color, settings.bloom)
    view = ci.view_mode != DebugViewType.NONE
    if view:
        # the AOV replaces the colour and skips the tone map and sRGB
        with torch.profiler.record_function("dfx.debug_view"):
            color = _debug_aov(ci.view_mode, gb, fx.ao)
    if not view and ci.tone_mapping_mode != ToneMappingMode.NONE:
        color = tone_map(color, ci.tone_mapping_mode, settings.tone_mapping,
                         ave_log_lum=info.renderer_params.average_log_lum)
    if not view and ci.convert_output_to_srgb:
        color = m3.linear_to_srgb(color)
    if ci.enable_vector_field:
        with torch.profiler.record_function("dfx.components"):
            color = comp.render_vector_field(color, gb.motion)
    new_state = FrameState(
        frame_index=state.frame_index + 1,
        prev_view_proj=info.camera.view_proj, taa=new_taa, ssr=fx.new_ssr,
        ssao=fx.new_ssao, dof=new_dof,
        average_log_lum=(fx.new_exposure if ci.enable_auto_exposure
                         else state.average_log_lum),
        prev_depth=gb.depth if state.prev_depth is not None else None)
    if not (ci.emit_aovs or view):
        # only what an application reads back: colour, depth, the mesh id
        # (picking), motion
        gb = gb._replace(
            normal_world=None, normal_view=None, base_color=None,
            material_data=None, world_pos=None, direct=None,
            ambient_diffuse=None, ambient_specular=None,
            spec_env_factor=None, background=None, debug=None)
    return FrameOutput(color=color, gbuffer=gb, state=new_state,
                       depth_range=fx.depth_range)


def _components(color: Tensor, gb: GBufferData, info: RenderInfo,
                settings: FrameSettings, ci: TaskManagerCreateInfo):
    """The editor's composite tasks in the JAX order (task_manager.py:
    538-571): the coordinate grid, the bound box, the selection
    (desaturation, then the outline, its colour pre-compensated for the
    tone map as ReverseExpToneMap does, clamped to 20) and the depth
    bounds.  Returns (colour, DepthRange or None)."""
    if ci.enable_grid:
        color = comp.render_coordinate_grid(color, gb.depth, info.camera)
    if ci.enable_bound_box and settings.bound_box is not None:
        bb = settings.bound_box
        color = comp.render_bound_box(color, gb.depth, info.camera,
                                      bb.box_min, bb.box_max,
                                      transform=bb.transform)
    if ci.enable_selection and settings.selected_ids is not None:
        ids = settings.selected_ids.to(gb.mesh_id.device)
        selected = ((gb.mesh_id[..., None] == ids) & (ids >= 0)).any(-1)
        color = sel.desaturate_unselected(color, selected,
                                          desaturation=ci.desaturation_factor)
        oc = reverse_exp_tone_map(
            torch.tensor([0.95, 0.6, 0.1], device=color.device),
            ave_log_lum=info.renderer_params.average_log_lum)
        color = sel.selection_outline(
            color, selected, outline_width=ci.selection_outline_width,
            outline_color=torch.clamp(oc, max=20.0))
    depth_range = None
    if ci.enable_depth_bounds:
        depth_range = compute_depth_range(gb.depth, info.camera)
    return color, depth_range


def _debug_aov(view: DebugViewType, gb: GBufferData,
               ao: Optional[Tensor]) -> Tensor:
    """The debug view `view` of the G-buffer (JAX task_manager.py:689; the
    35-entry DebugViewType table, PBR_Renderer.hpp:401-439), zero where
    nothing was hit.  `ao` is SSAO's factor (None: no SSAO).  The extension
    views read gb.debug (render_gbuffer's emit_debug); an absent entry
    renders black."""
    V = DebugViewType
    ones3 = torch.ones_like(gb.base_color)
    dbg = gb.debug or {}

    def d(key):
        if key in dbg:
            v = dbg[key]
            return v * ones3 if v.shape[-1] == 1 else v
        return torch.zeros_like(ones3)

    def texcoord():
        # one UV set: TEXCOORD1 aliases TEXCOORD0
        uv = dbg.get("texcoord0")
        if uv is None:
            return torch.zeros_like(ones3)
        return torch.cat([torch.remainder(uv, 1.0),
                          torch.zeros_like(uv[..., :1])], -1)

    def occlusion():
        occ = gb.material_data[..., 2:3]
        return (occ * ao[..., None] if ao is not None else occ) * ones3

    def white_base_color():
        # the lighting with a white base colour: the diffuse ambient term's
        # base colour divided out
        return gb.direct + gb.ambient_diffuse / torch.clamp(gb.base_color,
                                                            min=1e-3)

    views = {
        V.TEXCOORD0: texcoord, V.TEXCOORD1: texcoord,
        V.BASE_COLOR: lambda: gb.base_color,
        V.TRANSPARENCY: lambda: d("transparency"),
        V.OCCLUSION: occlusion,
        V.EMISSIVE: lambda: d("emissive"),
        V.METALLIC: lambda: gb.material_data[..., 0:1] * ones3,
        V.ROUGHNESS: lambda: gb.material_data[..., 1:2] * ones3,
        V.DIFFUSE_COLOR: lambda: d("diffuse_color"),
        V.SPECULAR_COLOR: lambda: d("specular_color"),
        V.REFLECTANCE90: lambda: d("reflectance90"),
        V.MESH_NORMAL: lambda: gb.normal_view * 0.5 + 0.5,
        V.SHADING_NORMAL: lambda: gb.normal_world * 0.5 + 0.5,
        V.MOTION_VECTORS: lambda: torch.cat(
            [torch.abs(gb.motion) * 20.0,
             torch.zeros_like(gb.motion[..., :1])], -1),
        V.NDOTV: lambda: d("ndotv"),
        V.PUNCTUAL_LIGHTING: lambda: gb.direct,
        V.DIFFUSE_IBL: lambda: gb.ambient_diffuse,
        V.SPECULAR_IBL: lambda: gb.ambient_specular,
        V.WHITE_BASE_COLOR: white_base_color,
        V.CLEAR_COAT: lambda: d("clearcoat_lit"),
        V.CLEAR_COAT_FACTOR: lambda: d("clearcoat_factor"),
        V.CLEAR_COAT_ROUGHNESS: lambda: d("clearcoat_roughness"),
        V.CLEAR_COAT_NORMAL: lambda: d("clearcoat_normal") * 0.5 + 0.5,
        V.SHEEN: lambda: d("sheen_lit"),
        V.SHEEN_COLOR: lambda: d("sheen_color"),
        V.SHEEN_ROUGHNESS: lambda: d("sheen_roughness"),
        V.ANISOTROPY_STRENGTH: lambda: d("anisotropy_strength"),
        V.ANISOTROPY_DIRECTION: lambda: d("anisotropy_direction") * 0.5
        + 0.5,
        V.IRIDESCENCE: lambda: d("iridescence_fresnel"),
        V.IRIDESCENCE_FACTOR: lambda: d("iridescence_factor"),
        # against the glTF-typical 1200 nm ceiling
        V.IRIDESCENCE_THICKNESS: lambda: d("iridescence_thickness") / 1200.0,
        V.TRANSMISSION: lambda: d("transmission"),
        V.THICKNESS: lambda: d("thickness"),
        V.SCENE_DEPTH: lambda: gb.depth[..., None] * ones3,
    }
    out = views.get(view, lambda: gb.base_color)()
    return torch.where(gb.hit[..., None], out,
                       torch.zeros((), device=out.device))
