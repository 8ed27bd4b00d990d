"""The BASELINE.json configurations (the port of
examples/benchmark_suite.py, with configuration 1 from
examples/render_mr_spheres.py).

Each `config_N_*` builds one configuration on a device, with the JAX
function's create-info, raster config, camera, lights and settings, and
returns a BenchConfig: the objects it renders with and `step(i)`, which
renders frame i and returns its colour.  Procedural stand-ins replace the
glTF sample assets (MetalRoughSpheres, DamagedHelmet, Sponza, Kitchen);
triangle counts match or exceed the originals.

- cfg1: the mr_spheres grid through PBRRenderer.render at 512 x 512.
- cfg2: a 27,360-triangle sphere over a 40 m plane at 1920 x 1080; each
  frame renders four 2048^2 cascades, EVSM2 moments and their blur, then
  PBRRenderer.render with the cascades.
- cfg3: the 24-column atrium through HnTaskManager.execute at 1080p, SSAO
  on the per-tap warp route and SSR, no TAA or bloom.
- cfg4: the 12-column atrium, the full post chain and a circling camera.
- cfg5: the 24-column atrium at 4K through execute_split with the G-buffer
  in four bands.

`main` prints one JSON line a configuration: its metric, the mean frame
time in ms over --frames frames after a warm-up frame (host clock ending
in torch.cuda.synchronize()), and the card's name and power limit.  A
configuration that fails raises, and the run exits non-zero.

Usage: python -m diligentfx_tpu_torch.examples.benchmark_suite [--configs 1,2,3,4,5] [--frames N]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                          PBRMaterialBasicAttribs,
                                          PBRRendererShaderParameters)
from diligentfx_tpu_torch.components.shadow_map_manager import (
    ShadowMapAttribs, convert_to_filterable, distribute_cascades,
    gaussian_blur_separable, render_cascade_shadow_maps)
from diligentfx_tpu_torch.config import (PBRRendererCreateInfo,
                                         RasterizerConfig, ShadowMode)
from diligentfx_tpu_torch.device import resolve_device
from diligentfx_tpu_torch.examples.render_mr_spheres import (
    build_mr_spheres_scene, mr_spheres_create_info, mr_spheres_info,
    mr_spheres_raster_config)
from diligentfx_tpu_torch.gltf.primitives import cube, plane, uv_sphere
from diligentfx_tpu_torch.hydrogent.task_manager import (
    FrameSettings, HnTaskManager, TaskManagerCreateInfo)
from diligentfx_tpu_torch.pbr.renderer import (PBRRenderer, RenderInfo,
                                               ScenePrimitives, build_scene,
                                               transform_vertices)
from diligentfx_tpu_torch.postfx.ssr import SSRSettings
from diligentfx_tpu_torch.postfx.taa import TAAFeatureFlags

Tensor = torch.Tensor

SUN = [-0.4, -1.0, -0.2]              # configs 3-5 (benchmark_suite.py:167)
_TAA_FLAGS = (TAAFeatureFlags.YCOCG_COLOR_SPACE
              | TAAFeatureFlags.GAUSSIAN_WEIGHTING
              | TAAFeatureFlags.PALLAS_WARP)


@dataclasses.dataclass
class BenchConfig:
    """One configuration, built on its device and ready to render."""
    metric: str                       # the name its JSON line carries
    width: int
    height: int
    cfg: RasterizerConfig
    renderer: PBRRenderer
    scene: ScenePrimitives
    info: Callable[[int], RenderInfo]     # frame i's camera, lights, params
    step: Callable[[int], Tensor]         # renders frame i -> its colour
    task_manager: Optional[HnTaskManager] = None
    settings: Optional[FrameSettings] = None
    shadow_attribs: Optional[ShadowMapAttribs] = None
    # what the last step made: "out" and "state" (a task manager's frame),
    # "shadow_maps", "shadow_moments" and "info" (cfg2's)
    last: dict = dataclasses.field(default_factory=dict)


def _timeit(step: Callable[[int], Tensor], n: int) -> float:
    """Mean ms a frame over step(0) .. step(n - 1), after a warm-up
    step(0) (benchmark_suite.py:24-33); the clock stops at a
    torch.cuda.synchronize()."""
    step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1000.0


def make_camera(eye, target, w, h, fov=0.8, near=0.1, far=100.0,
                device=None) -> CameraAttribs:
    dev = resolve_device(device)
    view = m3.look_at(eye, target, device=dev)
    proj = m3.perspective(fov, w / h, near, far, device=dev)
    return CameraAttribs.create(view, proj, eye, near, far, w, h, device=dev)


def sponza_like_entries(n_columns: int = 24, wall_segments: int = 24):
    """sponza_like_scene's (mesh, node matrix, material) entries: columns
    (high-poly capitals on box shafts), a 60 m floor and 40 clutter spheres
    drawn from np.random.default_rng(0) in the JAX builder's order."""
    rng = np.random.default_rng(0)
    entries = []
    col = uv_sphere(0.5, 40, 56)   # high-poly column capitals
    box = cube(1.0)
    for i in range(n_columns):
        x = (i % (n_columns // 2)) * 2.5 - (n_columns // 4) * 2.5
        z = -4.0 if i < n_columns // 2 else 4.0
        node = np.eye(4, dtype=np.float32)
        node[3, :3] = [x, 1.8, z]
        entries.append((col, node, PBRMaterialBasicAttribs.create(
            base_color_factor=(0.75, 0.7, 0.6, 1.0), roughness_factor=0.55)))
        shaft = np.diag([0.5, 3.6, 0.5, 1.0]).astype(np.float32)
        shaft[3, :3] = [x, 0.9, z]
        entries.append((box, shaft, PBRMaterialBasicAttribs.create(
            base_color_factor=(0.7, 0.65, 0.55, 1.0), roughness_factor=0.6)))
    floor = plane(60.0, segments=wall_segments)
    entries.append((floor, np.eye(4, dtype=np.float32),
                    PBRMaterialBasicAttribs.create(
                        base_color_factor=(0.5, 0.45, 0.4, 1.0),
                        roughness_factor=0.25)))
    for i in range(40):   # clutter spheres
        node = np.eye(4, dtype=np.float32)
        node[3, :3] = [rng.uniform(-12, 12), 0.4, rng.uniform(-3, 3)]
        entries.append((uv_sphere(0.35, 24, 32), node,
                        PBRMaterialBasicAttribs.create(
                            base_color_factor=tuple(rng.uniform(0.2, 0.9, 3))
                            + (1.0,),
                            metallic_factor=float(rng.uniform(0, 1)),
                            roughness_factor=float(rng.uniform(0.1, 0.9)))))
    return entries


def sponza_like_scene(n_columns: int = 24, wall_segments: int = 24,
                      device=None) -> ScenePrimitives:
    """The procedural atrium: 165,152 triangles at 24 columns, 112,592 at
    12."""
    return build_scene(sponza_like_entries(n_columns, wall_segments),
                       device=resolve_device(device))


def _renderer(ci, cfg, device, ibl_from: Optional[PBRRenderer]):
    """A PBRRenderer of create-info `ci`; with `ibl_from`, on that
    renderer's env map and IBL maps instead of a precompute of its own."""
    if ibl_from is None:
        return PBRRenderer(ci, raster_cfg=cfg, device=device)
    return PBRRenderer(ci, raster_cfg=cfg, device=device,
                       env_oct=ibl_from.env_oct.to(device),
                       ibl_maps=ibl_from.ibl_maps.to(device))


def atrium_info(i: int, w: int, h: int, device=None) -> RenderInfo:
    """Frame i of the atrium configurations: the camera 10 m out at 2 m,
    looking at (0, 1, 0), circling 0.02 rad a frame (config 4; configs 3
    and 5 hold frame 0's), and the sun at 4 (:167-171, :219-228)."""
    dev = resolve_device(device)
    a = i * 0.02
    eye = [10.0 * np.sin(a), 2.0, 10.0 * np.cos(a)]
    return RenderInfo(camera=make_camera(eye, [0, 1, 0], w, h, device=dev),
                      lights=PBRLightAttribs.directional(SUN, [4, 4, 4],
                                                         device=dev),
                      renderer_params=PBRRendererShaderParameters.create(
                          device=dev))


def _execute_config(metric, w, h, cfg, renderer, scene, tm, info_of,
                    split_bands: int = 0) -> BenchConfig:
    """A configuration rendered by tm.execute (or, with split_bands,
    execute_split with the G-buffer in that many bands) with SSR's 24
    intersections, its frame state carried from step to step."""
    settings = FrameSettings(ssr=SSRSettings(max_traversal_intersections=24))
    last = {"state": tm.initial_state(w, h)}

    def step(i):
        if split_bands:
            out = tm.execute_split(scene, info_of(i), last["state"], width=w,
                                   height=h, settings=settings,
                                   gbuffer_bands=split_bands)
        else:
            out = tm.execute(scene, info_of(i), last["state"], width=w,
                             height=h, settings=settings)
        last["state"], last["out"] = out.state, out
        return out.color

    return BenchConfig(metric, w, h, cfg, renderer, scene, info_of, step,
                       task_manager=tm, settings=settings, last=last)


def config_1_mr_spheres(device=None, size: int = 512,
                        ibl_from: Optional[PBRRenderer] = None
                        ) -> BenchConfig:
    """MetalRoughSpheres-class grid with IBL, forward PBR at 512 x 512
    (render_mr_spheres.py:46-70): 16 spheres of uv_sphere(0.42, 24, 32)."""
    dev = resolve_device(device)
    cfg = mr_spheres_raster_config()
    renderer = _renderer(mr_spheres_create_info(), cfg, dev, ibl_from)
    scene = build_mr_spheres_scene(device=dev)
    info = mr_spheres_info(size, size, dev)

    def step(i):
        return renderer.render(scene, info, width=size, height=size)

    return BenchConfig("cfg1_512_mr_spheres_frame_ms", size, size, cfg,
                       renderer, scene, lambda i: info, step)


def config_2_raster_config() -> RasterizerConfig:
    """:102-103."""
    return RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=1024,
                            max_tiles_per_tri=16, big_tri_capacity=64,
                            chunk=8)


def config_2_shadows(device=None, width: int = 1920, height: int = 1080,
                     shadow_map_size: int = 2048,
                     ibl_from: Optional[PBRRenderer] = None) -> BenchConfig:
    """DamagedHelmet-class mesh at 1080p with CSM (EVSM2; :80-137)."""
    dev = resolve_device(device)
    w, h = width, height
    helmet = uv_sphere(1.2, 96, 144)     # ~27k tris ~ DamagedHelmet class
    ground = plane(40.0)
    gn = np.eye(4, dtype=np.float32)
    gn[3, 1] = -1.3
    scene = build_scene([
        (helmet, np.eye(4, dtype=np.float32), PBRMaterialBasicAttribs.create(
            base_color_factor=(0.7, 0.55, 0.35, 1.0), metallic_factor=0.8,
            roughness_factor=0.35)),
        (ground, gn, PBRMaterialBasicAttribs.create(
            base_color_factor=(0.45, 0.45, 0.5, 1.0), roughness_factor=0.7)),
    ], device=dev)
    cfg = config_2_raster_config()
    renderer = _renderer(PBRRendererCreateInfo(enable_shadows=True), cfg,
                         dev, ibl_from)
    eye = [0.0, 1.2, 4.5]
    cam = make_camera(eye, [0, 0, 0], w, h, device=dev)
    sun = [-0.5, -1.0, -0.4]
    lights = PBRLightAttribs.directional(sun, [4, 4, 4], shadow_map_index=0,
                                         device=dev)
    att = distribute_cascades(cam.view, m3.inverse(cam.view),
                              float(cam.proj[0, 0]), float(cam.proj[1, 1]),
                              0.1, 100.0, sun, num_cascades=4,
                              shadow_map_size=shadow_map_size)
    wp, _, _ = transform_vertices(scene)
    params = PBRRendererShaderParameters.create(device=dev)
    last = {}

    def step(i):
        smaps = render_cascade_shadow_maps(wp, scene.indices, att,
                                           shadow_map_size=shadow_map_size,
                                           cfg=cfg)
        moments = gaussian_blur_separable(
            convert_to_filterable(smaps, ShadowMode.EVSM2))
        info = RenderInfo(camera=cam, lights=lights, renderer_params=params,
                          shadow_attribs=att, shadow_maps=smaps,
                          shadow_moments=moments)
        last.update(shadow_maps=smaps, shadow_moments=moments, info=info)
        return renderer.render(scene, info, width=w, height=h,
                               shadow_mode=ShadowMode.EVSM2)

    return BenchConfig(
        "cfg2_1080p_csm_evsm_frame_ms", w, h, cfg, renderer, scene,
        lambda i: RenderInfo(camera=cam, lights=lights,
                             renderer_params=params, shadow_attribs=att),
        step, shadow_attribs=att, last=last)


def config_3_raster_config() -> RasterizerConfig:
    """:145-146: the unsegmented binning (sub_bins 1), lists of 1,536."""
    return RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=1536,
                            max_tiles_per_tri=16, big_tri_capacity=64,
                            chunk=8)


def config_3_task_manager_ci() -> TaskManagerCreateInfo:
    """:148-152: SSAO on the per-tap warp route at half resolution (2
    slices x 4 steps), SSR at half resolution off the kernel route, no
    TAA, no bloom."""
    return TaskManagerCreateInfo(
        enable_ssao=True, ssao_half_resolution=True, ssao_use_pallas=True,
        ssao_num_slices=2, ssao_num_steps=4,
        enable_ssr=True, ssr_half_resolution=True,
        enable_taa=False, enable_bloom=False)


def config_3_sponza(device=None, width: int = 1920, height: int = 1080,
                    n_columns: int = 24,
                    ibl_from: Optional[PBRRenderer] = None) -> BenchConfig:
    """Sponza-class deferred + SSAO + SSR at 1080p (:140-179)."""
    dev = resolve_device(device)
    scene = sponza_like_scene(n_columns, device=dev)
    cfg = config_3_raster_config()
    renderer = _renderer(PBRRendererCreateInfo(), cfg, dev, ibl_from)
    tm = HnTaskManager(renderer, config_3_task_manager_ci())
    info = atrium_info(0, width, height, dev)
    return _execute_config("cfg3_1080p_sponza_deferred_ssao_ssr_frame_ms",
                           width, height, cfg, renderer, scene, tm,
                           lambda i: info)


def config_4_raster_config() -> RasterizerConfig:
    """:198-199 (config 3's)."""
    return config_3_raster_config()


def config_4_task_manager_ci() -> TaskManagerCreateInfo:
    """:201-214: SSAO on the per-tap warp route, SSR off the kernel route,
    TAA with the warp history, bloom, DoF on the warp route, fast env
    taps, epipolar light scattering and auto exposure."""
    return TaskManagerCreateInfo(
        enable_ssao=True, ssao_half_resolution=True, ssao_use_pallas=True,
        ssao_num_slices=2, ssao_num_steps=4,
        enable_ssr=True, ssr_half_resolution=True,
        enable_taa=True, enable_bloom=True, enable_dof=True,
        dof_use_pallas=True, fast_env_taps=True,
        enable_light_scattering=True, enable_auto_exposure=True,
        taa_feature_flags=_TAA_FLAGS)


def config_4_animated(device=None, width: int = 1920, height: int = 1080,
                      n_columns: int = 12,
                      ibl_from: Optional[PBRRenderer] = None) -> BenchConfig:
    """Full post chain at 1080p, animated camera (TAA, bloom, DoF,
    epipolar light scattering, auto exposure; :182-232)."""
    dev = resolve_device(device)
    scene = sponza_like_scene(n_columns=n_columns, device=dev)
    cfg = config_4_raster_config()
    renderer = _renderer(PBRRendererCreateInfo(), cfg, dev, ibl_from)
    tm = HnTaskManager(renderer, config_4_task_manager_ci())
    return _execute_config("cfg4_1080p_animated_full_chain_frame_ms", width,
                           height, cfg, renderer, scene, tm,
                           lambda i: atrium_info(i, width, height, dev))


def config_5_raster_config() -> RasterizerConfig:
    """:249-250: lists of 1,024."""
    return RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=1024,
                            max_tiles_per_tri=16, big_tri_capacity=64,
                            chunk=8)


def config_5_task_manager_ci() -> TaskManagerCreateInfo:
    """:252-258: SSAO on the per-tap warp route, SSR at half resolution
    off the kernel route, TAA with the warp history, bloom."""
    return TaskManagerCreateInfo(
        enable_ssao=True, ssao_half_resolution=True, ssao_use_pallas=True,
        ssao_num_slices=2, ssao_num_steps=4,
        enable_ssr=True, ssr_half_resolution=True,
        enable_taa=True, enable_bloom=True, taa_feature_flags=_TAA_FLAGS)


def config_5_4k(device=None, width: int = 3840, height: int = 2160,
                n_columns: int = 24,
                ibl_from: Optional[PBRRenderer] = None) -> BenchConfig:
    """Kitchen-class scene, full pipeline at 4K, through execute_split with
    the G-buffer in four row bands (:235-275)."""
    dev = resolve_device(device)
    scene = sponza_like_scene(n_columns, device=dev)
    cfg = config_5_raster_config()
    renderer = _renderer(PBRRendererCreateInfo(), cfg, dev, ibl_from)
    tm = HnTaskManager(renderer, config_5_task_manager_ci())
    info = atrium_info(0, width, height, dev)
    return _execute_config("cfg5_4k_full_chain_frame_ms", width, height, cfg,
                           renderer, scene, tm, lambda i: info,
                           split_bands=4)


CONFIGS: Dict[int, Callable[..., BenchConfig]] = {
    1: config_1_mr_spheres, 2: config_2_shadows, 3: config_3_sponza,
    4: config_4_animated, 5: config_5_4k}


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", type=str, default="2,3,4")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)
    resolve_device("cuda")
    card = card_name()
    for c in [int(x) for x in args.configs.split(",")]:
        bc = CONFIGS[c](device="cuda")
        ms = _timeit(bc.step, args.frames)
        print(json.dumps({"metric": bc.metric, "value": ms, "unit": "ms",
                          "frames": args.frames, "width": bc.width,
                          "height": bc.height, "card": card}), flush=True)
        del bc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
