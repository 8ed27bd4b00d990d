"""Row-banded rendering (the port of diligentfx_tpu/parallel/tiling.py):
the framebuffer's tile-row bands spread over the devices of a mesh axis,
every band rasterized at its own viewport window and shaded alone, the
scene replicated.

The JAX package runs one band function under shard_map, with the bands'
collectives inside it.  Here one process runs that function's stages in
turn, each a loop over the bands, split where the JAX function places a
collective: (1) the G-buffer, (2) the context's halos and the
disocclusion, (3) the SSAO gather, (4) SSAO's temporal stage, (5) the
SSR gather, (6) the composite and OIT, (7) TAA's halos, (8) the DoF and
bloom gathers, (9) the tone map.  A halo exchange reads the neighbouring
bands' rows (parallel/mesh.py), an all_gather concatenates the bands on
each distinct device, and the work the JAX package replicates on every
device (SSAO's AO on the gathered inputs, SSR, DoF, bloom) runs once a
distinct device.  Each band's work runs under its device
(`torch.cuda.device`), where the kernels launch.

`render_forward_banded` is the forward PBR + IBL frame; `render_frame_banded`
the whole deferred frame of HnTaskManager.execute.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.config import RasterizerConfig
from diligentfx_tpu_torch.ops import raster as rz
from diligentfx_tpu_torch.ops.sampling import sample_env_oct
from diligentfx_tpu_torch.parallel.mesh import (RenderMesh, band_sharding,
                                                halo_extend, replicated)
from diligentfx_tpu_torch.pbr import shading as sh
from diligentfx_tpu_torch.pbr.renderer import (RenderInfo, ScenePrimitives,
                                               transform_vertices)
from diligentfx_tpu_torch.postfx.context import BandCtx

Tensor = torch.Tensor


def _on(device: torch.device):
    """The band's device as the current CUDA device (the kernels launch
    there, on its current stream); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _replicate(obj, device: torch.device):
    """obj (tensors in named tuples, tuples, lists) on `device`."""
    if isinstance(obj, Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_replicate(x, device) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_replicate(x, device) for x in obj)
    return obj


def _gather(bands: Sequence[Tensor], device: torch.device) -> Tensor:
    """all_gather of the bands along rows, on `device`."""
    return torch.cat([t.to(device) for t in bands], dim=0)


def _check_bands(height: int, n_bands: int, cfg: RasterizerConfig) -> int:
    if height % (n_bands * cfg.tile_h):
        raise ValueError(f"height {height} must split into {n_bands} bands "
                         f"of whole {cfg.tile_h}-row tiles")
    return height // n_bands


def _shade_band(scene: ScenePrimitives, info: RenderInfo, ibl_maps, env_oct,
                vb, clip: Tensor, world_pos: Tensor, world_nrm: Tensor,
                band_y0: int, width: int, band_h: int, full_h: int,
                use_ibl: bool) -> Tensor:
    """Forward PBR + IBL of a band's visibility, background from band-local
    camera rays (JAX tiling.py:34)."""
    w = clip[:, 3]
    winv = torch.where(torch.abs(w) > 1e-12, 1.0 / w, torch.zeros_like(w))
    packed = torch.cat([world_pos, world_nrm], dim=-1)
    interp = rz.interpolate_all(vb, scene.indices, packed, winv)
    pos_px = interp[..., 0:3]
    nrm_px = m3.normalize(interp[..., 3:6])
    hit = vb.tri_id >= 0

    mat_id = scene.tri_material[torch.clamp(vb.tri_id, min=0).long()].long()
    mats = scene.materials
    # fetched in float64 by an embedding lookup: the gradient of the base
    # colours sums each material's pixels (in no fixed order on the card)
    # and rounds to float32 once, and the lookup's backward reduces the
    # sorted ids by segments, where index_put_'s accumulation serialises
    # the many pixels of one material (62 ms a 1920 x 272 band on an H100)
    base_color = F.embedding(mat_id, mats.base_color_factor.double()[:, :3]
                             ).float()
    metallic = mats.metallic_factor[mat_id][..., None]
    roughness = mats.roughness_factor[mat_id][..., None]

    view = m3.normalize(info.camera.position - pos_px)
    srf = sh.get_surface_reflectance_mr(base_color, metallic, roughness)
    ndotv = torch.clamp(m3.dot(nrm_px, view), 0.0, 1.0)
    shading = sh.SurfaceShadingInfo(
        pos=pos_px, view=view, occlusion=torch.ones_like(metallic),
        emissive=mats.emissive_factor[mat_id],
        base=sh.BaseLayerShadingInfo(srf=srf, metallic=metallic,
                                     normal=nrm_px, ndotv=ndotv),
        ibl_scale=info.renderer_params.ibl_scale[:3])
    lighting = sh.default_lighting(pos_px)
    lighting = sh.apply_punctual_lights(shading, info.lights, lighting)
    if use_ibl and ibl_maps is not None:
        lighting = sh.apply_ibl(shading, ibl_maps, lighting)
    color = sh.resolve_lighting(shading, lighting)

    # band-local background rays: rows band_y0 + [0, band_h) of the frame
    dev = pos_px.device
    x = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width \
        * 2 - 1
    yg = (torch.arange(band_h, dtype=torch.float32, device=dev)
          + float(band_y0) + 0.5)
    y = 1.0 - yg / full_h * 2.0
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    ndc = torch.stack([xx, yy, torch.full_like(xx, 0.5), torch.ones_like(xx)],
                      dim=-1)
    wpt = m3.vec_mat4(ndc, info.camera.view_proj_inv)
    ray = m3.normalize(wpt[..., :3] / wpt[..., 3:4] - info.camera.position)
    bg = sample_env_oct([env_oct], ray, torch.zeros(ray.shape[:-1],
                                                    device=dev))
    return torch.where(hit[..., None], color, bg)


def band_layout(height: int, n_bands: int, cfg: RasterizerConfig
                ) -> List[Tuple[int, int]]:
    """Each band's (first row, rows) in a frame of `height` rows padded to
    the tile grid (ops/raster.py pad_viewport, as _render_frame pads):
    the padded frame's tile rows split into `n_bands` runs of whole tiles,
    the first runs one tile longer where they do not divide."""
    tiles = rz.pad_viewport(cfg.tile_w, height, cfg)[1] // cfg.tile_h
    if tiles < n_bands:
        raise ValueError(f"{height} rows pad to {tiles} tile rows of "
                         f"{cfg.tile_h}, fewer than the {n_bands} bands")
    per, extra = divmod(tiles, n_bands)
    out, y0 = [], 0
    for b in range(n_bands):
        rows = (per + (b < extra)) * cfg.tile_h
        out.append((y0, rows))
        y0 += rows
    return out


def forward_bands(replicas, devices: Sequence[torch.device], *, width: int,
                  height: int, cfg: RasterizerConfig,
                  use_ibl: bool) -> List[Tensor]:
    """The forward frame's row bands (band_layout), band b on devices[b]
    from that device's (scene, info, ibl_maps, env_oct), replicas[device]:
    the two-pass raster (K4) at the band's window of the frame padded to
    the tile grid, then _shade_band, which with no emission and no tone
    map computes what _render_frame's two-pass branch does.  Each band is
    cropped to the frame: `width` columns, no padding row.  Every step is
    differentiable in the replicas' material tables."""
    pad_w, pad_h = rz.pad_viewport(width, height, cfg)
    bands = []
    for dev, (y0, rows) in zip(devices,
                               band_layout(height, len(devices), cfg)):
        scene, info, ibl_maps, env_oct = replicas[dev]
        with _on(dev):
            world_pos, world_nrm, _ = transform_vertices(
                scene, info.model_transform)
            clip = m3.transform_points(world_pos, info.camera.view_proj)
            vb, _stats = rz.rasterize(
                clip, scene.indices, width=pad_w, height=rows, cfg=cfg,
                double_sided=scene.tri_double_sided,
                screen_size=(pad_w, pad_h), screen_offset=(0, y0))
            color = _shade_band(scene, info, ibl_maps, env_oct, vb, clip,
                                world_pos, world_nrm, y0, pad_w, rows, pad_h,
                                use_ibl)
        bands.append(color[:max(0, min(rows, height - y0)), :width])
    return bands


def render_forward_banded(scene: ScenePrimitives, info: RenderInfo, ibl_maps,
                          env_oct, mesh: RenderMesh, *, width: int,
                          height: int,
                          cfg: RasterizerConfig = RasterizerConfig(),
                          use_ibl: bool = True, axis_name: str = "sp"):
    """One forward frame of any viewport with the framebuffer row-banded
    over `axis_name` (JAX tiling.py:77): padded to the tile grid, each band
    rasterizes its viewport window through the two-pass raster (K4) and
    shades it (forward_bands).  Returns (the bands' colours, each on its
    device and cropped to the frame; the assembled (height, width, 3)
    image on the first band's device)."""
    devices = band_sharding(mesh, axis_name)
    replicas = {dev: _replicate((scene, info, ibl_maps, env_oct), dev)
                for dev in dict.fromkeys(devices)}
    bands = forward_bands(replicas, devices, width=width, height=height,
                          cfg=cfg, use_ibl=use_ibl)
    return bands, _gather(bands, devices[0])


# ---------------------------------------------------------------------------
# The full deferred frame, row-banded
# ---------------------------------------------------------------------------


class BandedFrameState(NamedTuple):
    """Temporal history of the banded frame (JAX tiling.py:120).  The
    image-shaped entries are band-sharded: a list of (band_h, W, ...)
    tensors, each on its band's device.  The SSR history (at march
    resolution), the DoF CoC history and prev_view_proj are replicated
    (their effects read gathered inputs): a list with one copy a distinct
    device (parallel.mesh.replicated).  frame_index is a host integer, as
    in the port's FrameState."""
    frame_index: int
    prev_view_proj: List[Tensor]
    taa_color: Optional[List[Tensor]] = None
    taa_count: Optional[List[Tensor]] = None
    ssao_history: Optional[List[Tensor]] = None
    ssao_depth_history: Optional[List[Tensor]] = None
    ssr_radiance: Optional[List[Tensor]] = None
    dof_coc: Optional[List[Tensor]] = None
    prev_depth: Optional[List[Tensor]] = None


def _edge_clamped_halo(bands: Sequence[Tensor], b: int, halo: int) -> Tensor:
    """halo_extend, but the frame's first and last bands repeat their edge
    row into the outer halo (single-device clamp-to-edge sampling) instead
    of zeros (JAX tiling.py:136)."""
    ext = halo_extend(bands, b, halo)
    x = bands[b]
    if b == 0:
        ext[:halo] = x[:1]
    if b == len(bands) - 1:
        ext[-halo:] = x[-1:]
    return ext


class _Halos:
    """The band tensors a stage may extend.  BandCtx.extend(x, ...) of band
    b finds the registered list whose band b is x (its neighbours' rows
    are the halo), so the effects keep the JAX package's form."""

    def __init__(self):
        self.lists: List[Sequence[Tensor]] = []

    def add(self, *lists: Sequence[Tensor]) -> None:
        self.lists.extend(lists)

    def ctx(self, b: int, band_h: int, full_h: int, halo: int) -> BandCtx:
        def extend(x: Tensor, hl: int, wrap: bool = False) -> Tensor:
            for bands in self.lists:
                if bands[b] is x:
                    return (halo_extend(bands, b, hl, wrap=True) if wrap
                            else _edge_clamped_halo(bands, b, hl))
            raise ValueError("BandCtx.extend: not a registered band tensor")
        return BandCtx(extend=extend, y0=b * band_h, full_h=full_h, halo=halo)


def initial_banded_state(width: int, height: int, mesh: RenderMesh, *,
                         enable_taa: bool = True, enable_ssao: bool = True,
                         enable_ssr: bool = True, enable_dof: bool = False,
                         ssr_divisor: int = 2,
                         axis_name: str = "sp") -> BandedFrameState:
    """The first frame's history (JAX tiling.py:149)."""
    from diligentfx_tpu_torch.postfx.ssr import ssr_state_shape
    devices = band_sharding(mesh, axis_name)
    repl = replicated(mesh)
    band_h = height // len(devices)
    hs, ws = ssr_state_shape(height, width, ssr_divisor, False)

    def bands(value, *shape):
        return [torch.full((band_h, width) + shape, value,
                           dtype=torch.float32, device=d) for d in devices]
    return BandedFrameState(
        frame_index=0,
        prev_view_proj=[torch.eye(4, dtype=torch.float32, device=d)
                        for d in repl],
        taa_color=bands(0.0, 3) if enable_taa else None,
        taa_count=bands(0.0) if enable_taa else None,
        ssao_history=bands(1.0) if enable_ssao else None,
        ssao_depth_history=bands(1.0) if enable_ssao else None,
        ssr_radiance=([torch.zeros((hs, ws, 4), dtype=torch.float32,
                                   device=d) for d in repl]
                      if enable_ssr else None),
        dof_coc=([torch.zeros((height, width), dtype=torch.float32, device=d)
                  for d in repl] if enable_dof else None),
        prev_depth=bands(1.0))


def render_frame_banded(scene: ScenePrimitives, info: RenderInfo, ibl_maps,
                        env_oct, state: BandedFrameState, mesh: RenderMesh, *,
                        width: int, height: int,
                        cfg: RasterizerConfig = RasterizerConfig(),
                        use_ibl: bool = True,
                        enable_ssao: bool = True,
                        enable_ssr: bool = True,
                        enable_taa: bool = True,
                        enable_bloom: bool = True,
                        enable_dof: bool = False,
                        oit_layer_count: int = 4,
                        ssr_divisor: int = 2,
                        ssr_steps: int = 24,
                        ssr_use_pallas: bool = False,
                        ssao_half_resolution: bool = True,
                        ssao_num_slices: int = 2, ssao_num_steps: int = 4,
                        taa_feature_flags: Optional[int] = None,
                        tone_mapping_mode=None,
                        convert_output_to_srgb: bool = False,
                        jitter_seq: Optional[Tensor] = None,
                        halo: int = 16, axis_name: str = "sp"):
    """The whole deferred frame (G-buffer -> SSAO -> SSR -> composite ->
    OIT -> TAA -> DoF -> bloom -> tone map) with the framebuffer
    row-banded over `axis_name` (JAX tiling.py:176), each effect the
    single-frame implementation:
      * G-buffer and OIT's K layers: each band's viewport window
        (render_gbuffer_band_sp; the K-layer raster at the band's offset);
      * the context's closest-motion dilation: a one-row wrap halo;
      * SSAO: GTAO on the gathered half-resolution depth and normals
        (its mip taps read the whole frame), then the temporal stage on
        halo rows (ssao_temporal with a BandCtx);
      * SSR: compute_ssr on the gathered full-resolution inputs, with the
        single frame's arguments (K3 with ssr_use_pallas);
      * TAA: taa_accumulate with a BandCtx;
      * DoF and bloom: on the gathered colour.
    Returns (the bands' colours, the new BandedFrameState, the assembled
    (height, width, 3) image on the first band's device)."""
    from diligentfx_tpu_torch.attribs import CameraAttribs
    from diligentfx_tpu_torch.ops.sampling import upsample_bilinear
    from diligentfx_tpu_torch.pbr import oit
    from diligentfx_tpu_torch.pbr.deferred import render_gbuffer_band_sp
    from diligentfx_tpu_torch.postfx import bloom as fx_bloom
    from diligentfx_tpu_torch.postfx import dof as fx_dof
    from diligentfx_tpu_torch.postfx import ssao as fx_ssao
    from diligentfx_tpu_torch.postfx import ssr as fx_ssr
    from diligentfx_tpu_torch.postfx import taa as fx_taa
    from diligentfx_tpu_torch.postfx.context import (PostFXResources,
                                                     apply_jitter_to_proj,
                                                     dilate_closest_motion,
                                                     disocclusion_mask,
                                                     jitter_to_ndc)
    from diligentfx_tpu_torch.postfx.tonemap import ToneMappingAttribs, tone_map

    if taa_feature_flags is None:
        taa_feature_flags = (fx_taa.TAAFeatureFlags.BICUBIC_FILTER
                             | fx_taa.TAAFeatureFlags.YCOCG_COLOR_SPACE
                             | fx_taa.TAAFeatureFlags.GAUSSIAN_WEIGHTING)
    devices = band_sharding(mesh, axis_name)
    repl = replicated(mesh)
    n = len(devices)
    band_h = _check_bands(height, n, cfg)
    if band_h % 2:
        raise ValueError(f"band height {band_h} must be even")
    rep_of = [repl.index(d) for d in devices]
    st = state
    first = st.frame_index == 0

    # BeginFrame's TAA jitter (HnTaskManager._begin_camera's sequence and
    # indexing), then the inputs replicated on each distinct device
    if jitter_seq is not None and enable_taa:
        cam = info.camera
        j_px = jitter_seq[st.frame_index % jitter_seq.shape[0]]
        j_ndc = jitter_to_ndc(j_px, width, height)
        info = info._replace(camera=CameraAttribs.create(
            cam.view, apply_jitter_to_proj(cam.proj, j_ndc), cam.position,
            cam.near_z, cam.far_z, width, height, jitter=j_ndc))
    inputs = []
    for r, dev in enumerate(repl):
        scene_, info_, ibl_, env_ = _replicate(
            (scene, info, ibl_maps, env_oct), dev)
        info_ = info_._replace(prev_view_proj=(
            info_.camera.view_proj if first else st.prev_view_proj[r]))
        inputs.append((scene_, info_, ibl_, env_))
    bands = range(n)

    def at(b):
        return inputs[rep_of[b]]
    halos = _Halos()

    def ctx(b):
        return halos.ctx(b, band_h, height, halo)

    # (1) the G-buffer: each band's viewport window
    gbs = []
    for b in bands:
        scene_, info_, ibl_, env_ = at(b)
        with _on(devices[b]):
            gbs.append(render_gbuffer_band_sp(
                scene_, info_, ibl_, env_, width=width, band_h=band_h,
                full_height=height, band_y0=b * band_h, cfg=cfg,
                use_ibl=use_ibl))
    depth = [g.depth for g in gbs]
    motion = [g.motion for g in gbs]
    halos.add(depth, motion)
    if st.prev_depth is not None:
        halos.add(st.prev_depth)

    # (2) the context: closest-motion dilation over a wrap halo; the
    # history disocclusion
    resources, disocc = [], []
    for b in bands:
        info_ = at(b)[1]
        c = ctx(b)
        with _on(devices[b]):
            closest = dilate_closest_motion(
                c.extend(depth[b], 1, wrap=True),
                c.extend(motion[b], 1, wrap=True))[1:1 + band_h]
            resources.append(PostFXResources(
                camera=info_.camera, prev_camera=info_.camera,
                depth=depth[b],
                prev_depth=(st.prev_depth[b] if st.prev_depth is not None
                            else depth[b]),
                motion=motion[b], closest_motion=closest,
                frame_index=st.frame_index))
            d = None
            if st.prev_depth is not None:
                d = disocclusion_mask(depth[b], st.prev_depth[b], motion[b],
                                      info_.camera,
                                      st.prev_view_proj[rep_of[b]], band=c)
                if first:
                    d = torch.ones_like(d)
            disocc.append(d)

    # (3) SSAO: GTAO on the gathered (half-resolution) depth and normals,
    # once a distinct device
    ao = [torch.ones((band_h, width), dtype=torch.float32, device=d)
          for d in devices]
    new_ssao, new_ssao_cd = st.ssao_history, st.ssao_depth_history
    if enable_ssao:
        s = 2 if ssao_half_resolution else 1
        ao_full = []
        for r, dev in enumerate(repl):
            info_ = inputs[r][1]
            with _on(dev):
                d_g = _gather([x[::s, ::s] for x in depth], dev)
                n_g = _gather([g.normal_view[::s, ::s] for g in gbs], dev)
                a = fx_ssao.compute_gtao(d_g, n_g, info_.camera,
                                         st.frame_index,
                                         num_slices=ssao_num_slices,
                                         num_steps=ssao_num_steps)
                a = fx_ssao.bilateral_blur(a, d_g, info_.camera)
                if s > 1:
                    a = upsample_bilinear(a, s, s)[:height, :width]
                ao_full.append(a)
        ao = [ao_full[rep_of[b]][b * band_h:(b + 1) * band_h]
              for b in bands]
        # (4) the temporal stage on halo rows
        halos.add(ao)
        if st.ssao_history is not None:
            halos.add(st.ssao_history, st.ssao_depth_history)
        out, new_ssao, new_ssao_cd = [], [], []
        for b in bands:
            c = ctx(b)
            with _on(devices[b]):
                conv_depth = fx_ssao.convolved_depth(depth[b], band=c)
                sstate = (fx_ssao.SSAOState(
                    history=st.ssao_history[b],
                    depth_history=st.ssao_depth_history[b])
                    if st.ssao_history is not None else None)
                a, sres = fx_ssao.ssao_temporal(
                    ao[b], conv_depth, sstate, motion[b],
                    disocclusion=disocc[b], band=c)
            out.append(a)
            new_ssao.append(sres.history)
            new_ssao_cd.append(sres.depth_history)
        ao = out

    # (5) SSR on the gathered full-resolution inputs, once a distinct
    # device
    new_ssr = st.ssr_radiance
    ssr_rad = None
    if enable_ssr:
        refl = [torch.where(g.hit[..., None],
                            g.direct + g.ambient_diffuse + g.ambient_specular,
                            g.background) for g in gbs]
        rad_full, new_ssr = [], []
        for r, dev in enumerate(repl):
            info_ = inputs[r][1]
            with _on(dev):
                rad, sstate = fx_ssr.compute_ssr(
                    _gather(refl, dev), _gather(depth, dev),
                    _gather([g.normal_view for g in gbs], dev),
                    _gather([g.material_data[..., 1:2] for g in gbs], dev),
                    info_.camera, st.frame_index,
                    fx_ssr.SSRSettings(max_traversal_intersections=ssr_steps),
                    state=(fx_ssr.SSRState(radiance=st.ssr_radiance[r])
                           if st.ssr_radiance is not None else None),
                    motion=_gather(motion, dev),
                    disocclusion=(_gather(disocc, dev)
                                  if disocc[0] is not None else None),
                    half_resolution=False, resolution_divisor=ssr_divisor,
                    use_pallas=ssr_use_pallas)
            rad_full.append(rad)
            new_ssr.append(sstate.radiance)
        ssr_rad = [rad_full[rep_of[b]][b * band_h:(b + 1) * band_h]
                   for b in bands]

    # (6) the composite, then OIT's K layers at the band's viewport
    colors = []
    for b in bands:
        g = gbs[b]
        scene_, info_, ibl_, _ = at(b)
        with _on(devices[b]):
            spec = g.ambient_specular
            if ssr_rad is not None:
                conf = torch.clamp(ssr_rad[b][..., 3:4], 0.0, 1.0)
                spec = spec + (ssr_rad[b][..., :3] * g.spec_env_factor
                               - spec) * conf
            ao1 = ao[b][..., None]
            color = g.direct + ao1 * g.ambient_diffuse + ao1 * spec
            color = torch.where(g.hit[..., None], color, g.background)
            if scene_.blend_indices is not None and oit_layer_count > 0:
                wp, wn, _ = transform_vertices(scene_, info_.model_transform)
                clip_b = m3.transform_points(wp, info_.camera.view_proj)
                w = clip_b[:, 3]
                winv_b = torch.where(torch.abs(w) > 1e-12, 1.0 / w,
                                     torch.zeros_like(w))
                blend_scene = scene_._replace(
                    tri_material=scene_.blend_tri_material,
                    indices=scene_.blend_indices)
                blend_bc = scene_.materials.base_color_factor[
                    scene_.blend_tri_material.long()]
                kl = oit.rasterize_klayers(
                    clip_b, scene_.blend_indices, width=width, height=band_h,
                    cfg=cfg, num_layers=oit_layer_count,
                    tri_alpha=blend_bc[:, 3], tri_rgb=blend_bc[:, :3],
                    screen_size=(width, height),
                    screen_offset=(0, b * band_h))
                lcol, lalpha, lalb = oit.shade_klayers(
                    blend_scene, info_, ibl_, kl, wp, wn, winv_b,
                    use_ibl=use_ibl)
                color = oit.composite_klayers(color, g.depth, kl, lcol,
                                              lalpha, layer_albedos=lalb)
        colors.append(color)

    # (7) TAA with the history warp and moments on halo rows
    new_taa_c, new_taa_n = st.taa_color, st.taa_count
    if enable_taa and st.taa_color is not None:
        hist_c = [colors[b] if first else st.taa_color[b] for b in bands]
        hist_n = [torch.ones((band_h, width), dtype=torch.float32,
                             device=devices[b]) if first else st.taa_count[b]
                  for b in bands]
        halos.add(colors, hist_c, hist_n)
        out, new_taa_c, new_taa_n = [], [], []
        for b in bands:
            with _on(devices[b]):
                c, tres = fx_taa.taa_accumulate(
                    colors[b], fx_taa.TAAState(color=hist_c[b],
                                               sample_count=hist_n[b]),
                    resources[b], feature_flags=taa_feature_flags,
                    disocclusion=disocc[b], band=ctx(b))
            out.append(c)
            new_taa_c.append(tres.color)
            new_taa_n.append(tres.sample_count)
        colors = out

    # (8) DoF and bloom on the gathered colour, once a distinct device
    new_dof = st.dof_coc
    if enable_dof:
        dof_full, new_dof = [], []
        for r, dev in enumerate(repl):
            with _on(dev):
                dstate = (fx_dof.DoFState(coc_history=st.dof_coc[r])
                          if st.dof_coc is not None else None)
                full, dres = fx_dof.apply_dof(
                    _gather(colors, dev), _gather(depth, dev),
                    inputs[r][1].camera, state=dstate,
                    motion=_gather(motion, dev),
                    use_temporal=st.dof_coc is not None)
            dof_full.append(full)
            new_dof.append(dres.coc_history)
        if st.dof_coc is None:      # keep the state's form fixed
            new_dof = None
        colors = [dof_full[rep_of[b]][b * band_h:(b + 1) * band_h]
                  for b in bands]
    if enable_bloom:
        bloomed = []
        for dev in repl:
            with _on(dev):
                bloomed.append(fx_bloom.apply_bloom(_gather(colors, dev)))
        colors = [bloomed[rep_of[b]][b * band_h:(b + 1) * band_h]
                  for b in bands]

    # (9) the tone map
    for b in bands:
        with _on(devices[b]):
            if tone_mapping_mode is not None:
                colors[b] = tone_map(
                    colors[b], tone_mapping_mode, ToneMappingAttribs(),
                    ave_log_lum=at(b)[1].renderer_params.average_log_lum)
            if convert_output_to_srgb:
                colors[b] = m3.linear_to_srgb(colors[b])

    new_state = BandedFrameState(
        frame_index=st.frame_index + 1,
        prev_view_proj=[inp[1].camera.view_proj for inp in inputs],
        taa_color=new_taa_c, taa_count=new_taa_n,
        ssao_history=new_ssao, ssao_depth_history=new_ssao_cd,
        ssr_radiance=new_ssr, dof_coc=new_dof, prev_depth=depth)
    return colors, new_state, _gather(colors, devices[0])
