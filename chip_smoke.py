#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (diligentfx_tpu_torch) on one NVIDIA
GPU: builds the port's CUDA kernels, holds each against its plain PyTorch
version on the card, renders the 1080p bench frame with the full bench.py
feature set (G-buffer -> half-resolution GTAO SSAO -> divisor-2 SSR ->
composite -> TAA -> bloom -> tone map), the textured --csm frame, the
full-chain frame (DoF, epipolar light scattering, auto exposure), the
mask / blend frame of a glTF file it writes (alpha-masked screens, glass
panes through K-layer OIT), the light / heap frame of another (spot,
point and sun shadows through the shadow atlas, textures at their native
sizes in the texture heap) and the ext_skin frame of a third (the glTF
material extensions, skinned figures and their animation) and that
showroom's editor frame (selection, grid, bound box, vector field, depth
bounds, the debug views), a Hydra stage through the Hydrogent front end
(the pxr adapter, the render delegate, AsyncFramePipeline) and an atrium
through the Radient front end (engine, ECS scene, async assets, resolver,
drawable cache, C API), the 4K cfg5 frame through execute_split with the
G-buffer in row bands, the row-banded frame of parallel/tiling.py, and
the inverse-rendering step of diligentfx_tpu_torch/entry.py (a gradient
step on the bench scene's base colours over a dp x sp mesh), and
BASELINE.json's configurations 1-3 as the port's
diligentfx_tpu_torch/examples/benchmark_suite.py builds them, and checks
them.

Phases (any failure exits non-zero; no phase is skipped):
  1. build csrc/*.cu with nvcc (one process per source, all at once);
  2. K1, the fused tile raster kernel, vs raster_tiles_fused_plain at the
     bench scene, bench raster config and 1920x1080 (padded to 1088x1920);
     its time (CUDA events and device time) and its candidate-pixel tests
     counted on whole segments and inside the candidates' rectangles
     (raster.candidate_rects), with the bound from each count;
  3. K2, the bounded warp kernel, vs warp_bilinear_plain: the frames' six
     launch shapes (the full-chain DoF taps' five channels included), five
     channels at 1080p, halos (16, 64) and (8, 64), offsets beyond the
     halo, and a 128-wide image (halo shrink), all exact; times per shape
     beside grid_sample (CUDA events and device time), over the bench
     frame's 20 launches and the full-chain frame's 43, and the wrapper's
     host cost a call (each frame's warm-up checks that these are the
     shapes it launches K2 at);
  4. the main path: HnTaskManager.execute on the bench scene at 1920x1080,
     one warm-up frame, then --frames timed frames; the kernels' launch
     counts are zeroed just before and read just after the timed frames
     (K1 1, K2 20, K3 1 a frame);
  5. K3, the SSR row-DDA march, vs march_dda_plain at the inputs compute_ssr
     builds from the frame's G-buffer (exact), on random rays with flat
     ones, and on 128-, 447-, 454- and 600-row tables (both kernel
     variants and both shared pitches); its lane efficiency at the frame's rays (the rows each ray
     walks over 32 x the longest walk of each warp);
  6. K5, the fused GTAO, vs gtao_fused_plain and against the per-tap route
     on the frame's half-resolution depth and normals, and vs
     gtao_fused_plain on random 64 x 256 and 100 x 700 inputs; the mean
     32-byte sectors a warp-wide tap load touches in global memory;
     then its own path, apply_ssao(use_pallas=True, fused=True) on the
     frame's G-buffer, with the counts zeroed just before and read just
     after (both phases time the kernel by CUDA events and by the
     profiler's device time, with the card's SM clock and power draw
     sampled under load);
  7. the bench frame and the first slice's frame (SSAO and SSR off) at
     256x128 on the GPU against the port's CPU path (the plain versions,
     which the CPU tests hold against the JAX package);
  8. K1 again at the --csm frame's G-buffer inputs (the textured bench
     scene: UV-derivative channels); K4, the two-pass tile raster, vs
     raster_tiles_plain on the bench's four 2048^2 shadow cascades of the
     textured bench scene, with each cascade's raster statistics (equal to
     the reference's), and reversed depth on one cascade; both timed and
     their tests counted as in phase 2, and held to the tile rasters'
     goals;
  9. the --csm frame: the textured bench scene with four-cascade EVSM2
     shadows re-rendered every frame (HnTaskManager.render_shadows, then
     execute, as bench.py --csm runs them), one warm-up frame, then
     --frames timed frames with the counts zeroed just before and read just
     after (K1 1, K2 20, K3 1, K4 4 a frame);
 10. a 256x128 csm frame (2 cascades at 256^2, a small atlas) and the
     forward renderer PBRRenderer.render on the csm_256 golden scene (fused
     K1 and two-pass K4 branches) on the GPU against the port's CPU path;
 11. K1 at the full-chain frame's G-buffer inputs (the atrium scene, the
     unsegmented route: sub_bins 1, bin capacity 1536);
 12. the full-chain frame (examples/benchmark_suite.py config_4_animated):
     the atrium scene, SSAO, SSR, TAA, DoF on the warp kernel route,
     bloom, epipolar light scattering and auto exposure, the camera
     circling the atrium; one warm-up frame, then --frames timed frames
     with the counts zeroed just before and read just after (K1 1, K2 43
     a frame);
 13. K6, the multi-tap warp, vs warp_bilinear_multi_plain and against 16
     K2 launches at its natural shape (the full-chain frame's 16 SSAO
     horizon-tap offset fields on its half-resolution depth, edge-padded
     to 544 x 1024) and more (17 taps at 1080p), all exact; then its own
     path, the entry point once with the counts zeroed just before and
     read just after; its fill's re-read of the image;
 14. a 256x128 full-chain frame (two frames, moving camera) on the GPU
     against the port's CPU path;
 15. K4 vs raster_tiles_plain at the mask / blend frame's G-buffer inputs
     (the glTF atrium's opaque prefix at 1088x1920, standard depth, the
     materials' double-sided flags), bit for bit, timed and counted as in
     phase 8;
 16. the mask / blend frame: a .glb written at run time (the full-chain
     atrium, twelve lattice screens of ALPHA_MODE_MASK with a 256x256
     texture of alpha 0 / 1 holes, six glass panes of ALPHA_MODE_BLEND
     0.25 m apart), load_gltf -> build_render_scene -> HnTaskManager
     (the atlas) -> execute at 1920x1080 with the bench effects and K = 4
     OIT layers; one warm-up frame (mask fragments both passed and
     discarded, some pixel's OIT overflowing the layers, no raster's bin,
     big or near-clip overflow), then --frames timed frames with the counts
     zeroed just before and read just after (K4 1, K2 20, K3 1, K1 0 a
     frame); the K-layer stage alone and 3 profiled frames (the dfx.oit and
     dfx.alpha_mask ranges);
 17. two 256x128 mask / blend frames of the atrium with 4 columns (two-pass
     K4 G-buffer + OIT) and two without the screens (blend only: fused K1
     + OIT) on the GPU against the port's CPU path;
 18. K4 at the per-light inputs of the light / heap frame (phase 19's
     scene): every shadow-atlas slice's raster statistics (no bin, big or
     near-clip overflow), then K4 vs raster_tiles_plain bit for bit at the
     spot's slice, the point light's cube face with the most candidates
     and the sun's slice, timed and counted as in phase 15;
 19. the light / heap frame: a .glb written at run time (phase 16's
     atrium with a back wall, material textures at their native sizes: a
     2048^2 floor, a 1000 x 600 wall, a 512^2 normal map on the columns,
     the 256^2 lattice; a spot lamp and a point light as
     KHR_lights_punctual nodes, the sun added), build_render_scene in
     "array" mode (the texture heap) -> HnTaskManager; per frame the
     shadow pass (ShadowAtlasManager: build_view_projs, render with K4 on
     8 slices of 1024^2, packed_for_lights) and execute with
     light_shadow_kinds at 1920x1080, the bench effects and K = 4 OIT
     layers; one warm-up frame (each light's shadows cast, the floor's
     lone texels exact through sample_heap at lod 0 where the atlas loses
     them, mask fragments kept and cut out, OIT overflow, every raster's
     overflow counts), then --frames timed frames with the counts zeroed
     just before and read just after (K4 9, K2 20, K3 1, K1 0 a frame), 3
     profiled frames (the dfx.light_shadows, dfx.gbuffer, dfx.alpha_mask
     and dfx.oit ranges) and the dfx.gbuffer device time of one frame of
     the scene built in atlas mode;
 20. two 256x128 light / heap frames of the atrium with 4 columns and
     256^2 slices on the GPU against the port's CPU path;
 21. K1 against its plain version at the ext_skin frame's textured
     G-buffer inputs (frame 0) and K4 bit for bit at its four 2048^2
     cascades, every cascade's raster statistics printed (none
     overflowing ext_skin_raster_config's lists of 65,536);
 22. the ext_skin frame: a .glb written at run time (the opaque atrium of
     phase 19 with its textures in the heap; six showroom spheres, one
     material each: clear coat, sheen, anisotropy with a normal map,
     iridescence, transmission with volume, all five; six skinned figures
     of 32 joints under parent nodes, one 2 s animation with LINEAR,
     CUBICSPLINE and STEP channels; 240,592 triangles, 192 joints); per
     frame update_animation at t = i / 60 s, the circling camera,
     render_shadows (the sun's four EVSM2 cascades) and execute with the
     clear coat on; one warm-up frame (every raster's overflow and
     longest list), the probes (a figure moves, its motion vectors, each
     sphere's extension), then --frames timed frames with the counts
     zeroed just before and read just after (K1 1, K2 20, K3 1, K4 4 a
     frame), update_animation alone and 3 profiled frames (the
     dfx.gbuffer, dfx.shadows and dfx.skinning ranges);
 23. two 256x128 ext_skin frames of the showroom without the atrium on
     the GPU against the port's CPU path;
 24. the editor frame: phase 22's showroom and frame with the editor's
     components on (selection, coordinate grid, bound box, vector field,
     depth bounds): figure 0 and sphere 0 selected, the bound box around
     figure 0's skinned vertices, each frame's cascades fitted to the
     previous frame's depth range; one warm-up frame, then --frames timed
     frames with the counts zeroed just before and read just after (K1 1,
     K2 20, K3 1, K4 4 a frame); the probes (the selection keeps its
     colour and desaturates the rest, one outline band at most
     selection_outline_width px wide, the grid, box and vector field
     change pixels, the depth range and the cascades fitted to it,
     reset_taa, emit_aovs=False bit-equal, vis_only on both raster
     routes); 3 profiled frames with the IRIDESCENCE view (the
     dfx.components and dfx.debug_view ranges); every debug view but NONE,
     one frame each, timed as a whole, finite, zero where nothing was hit,
     each extension view differing between its sphere and the columns;
 25. two 256x128 editor frames of the showroom without the atrium (the
     overlays, the IRIDESCENCE view; the first on the fused K1 route, the
     second on the two-pass K4 route) on the GPU against the port's CPU
     path;
 26. the Hydra stage through the Hydrogent front end: the full-chain
     atrium's meshes and 24 Kitchen-shaped props (quads, pentagons, geom
     subsets), 12 UsdPreviewSurface networks (8 textured at 512^2, normal
     maps, UsdTransform2d), a distant and a sphere light and a camera,
     authored in the fake pxr of tests/torch_pxr_shim.py, populated,
     Synced and committed through the port's pxr adapter (timed; the
     capitals, the shafts and the clutter spheres one pool entry each);
     K1 against its plain version at the stage's G-buffer inputs and K4
     bit for bit at its EDGES frame's; then the render task (HnRenderDelegate.execute -> HnTaskManager.execute)
     at 1920x1080 with the bench renderer and task manager on the stage's
     raster lists (hydra_raster_config); one warm-up frame, then --frames
     timed frames with the counts zeroed just before and read just after
     (K1 1, K2 20, K3 1, K4 0 a frame), the task manager alone beside
     them; the probes: picking at six props' centroids against a host ray
     cast, an EDGES frame (K4 1) and a POINTS frame (no kernel), a
     transform-only edit of three props (no geometry byte uploaded, motion
     on them and none elsewhere, none after the fold), a points edit (its
     entry's bytes exactly), a material edit, a destroy_prim, a small
     geometry budget (entries PENDING, rendered on later frames); and
     AsyncFramePipeline in a child process with no kernel built (FALLBACK,
     then OK; each kernel library built once);
 27. two 256x128 frames of the Hydra stage on the GPU against the port's
     CPU path;
 28. the Radient atrium through the Radient front end alone
     (create_radient_engine on the card): the full-chain atrium's meshes
     in a .glb with a spot, a point and a directional KHR light, imported
     from mem:// through the resolver chain (the capitals, shafts and
     clutter spheres deduplicated by the asset manager), four textures
     through load_texture (two PNGs by a relative path and a file:// URI,
     a numpy payload and its duplicate with a release callback) into the
     atlas, and a carousel of 24 spheres (one asset) under a parent
     entity; the renderer with the bench task manager and a view at
     1920x1080 on the circling camera; one warm-up frame (the raster
     statistics), K1 against its plain version at the frame's G-buffer
     inputs, then --frames timed frames, the carousel turned each (a
     transform-only change), with the counts zeroed just before and read
     just after (K1 1, K2 20, K3 1, K4 0 a frame; no full rebuild, one
     incremental sync a frame; update, render and the whole frame timed);
     the probes: the carousel hidden (one full rebuild, its pixels
     change), a fresh scene whose mesh is loading (PENDING), a budget
     smaller than one mesh (NO_GPU_DATA, then OK), a headless engine (OK,
     no kernel); the same meshes and hierarchy through the C API (dedups,
     world matrices, renderables); PBRRenderer(ibl_cache_dir) cold then
     warm (bit-equal maps); vertex packing on the card against the CPU;
 29. two 256x128 frames of the Radient atrium on the GPU against the
     port's CPU path;
 30. K1 against its plain version at the 4K cfg5 G-buffer inputs
     (examples/benchmark_suite.py config_5_4k: the atrium with 24 columns,
     32 x 128 tiles, lists of 1,024, padded to 2176 x 3840), its events
     and device ms, bound and candidate-pixel tests, and the raster
     statistics (cfg5's lists may drop pairs at 4K; reported as they are);
 31. the 4K cfg5 frame: HnTaskManager.execute_split(gbuffer_bands=4) at
     3840 x 2160 (SSAO on the per-tap warp route, SSR at half resolution,
     TAA with the warp history, bloom); one warm-up frame whose launches
     are printed (K1 1, K3 0, K4 0), then --frames timed frames with the
     counts zeroed just before and read just after, held to the warm-up
     frame's; from one copied state one frame each of execute_split with
     4 bands and with 1 and of execute, their colour and G-buffer
     differences (within 1e-5) and each call's peak device memory;
 32. the row-banded frame of parallel/tiling.py at 1920 x 1088 over four
     bands on the one card (tests/test_multichip.py:125-199's scene: a red
     and a blue BLEND sphere over a plane, 8 x 128 tiles): K1 at each
     band's render_gbuffer_band_sp inputs (screen_offset 0 / 272 / 544 /
     816) against its plain version and the unbanded K1 output's rows; K4
     at each band of render_forward_banded against its plain version;
     render_forward_banded with four bands bit-equal to one (K4 4
     launches); K3 at the gathered SSR inputs; two render_frame_banded
     frames with four bands against execute (4e-3) and against one band
     (2e-3); --frames timed banded frames with the counts zeroed just
     before and read just after (K1 4, K2 1, K3 1 a frame) beside --frames
     execute frames;
 33. the 256x128 cfg5 frame through execute_split with 4 bands and the
     256x128 banded frame with 2 bands on the GPU against the port's CPU
     path;
 34. the inverse-rendering step (entry.py train_step) on the bench scene
     at 1920x1088, four orbit views over a dp 2 x sp 4 mesh of the one
     card: the raster statistics of every view and band (no drop); K4 at
     each band of one view against its plain version; the targets at the
     scene's colours, the parameters from seeded noise; a warm-up step,
     then --frames timed steps with the counts zeroed just before and read
     just after (K4 16, K1 0 a step), forward and backward timed apart
     (backward K4 0), the peak memory of a step; the loss falling; loss
     and gradients against a 1 x 1 mesh (1e-5); the dry run's 64x64 step
     on the card against the CPU path (1e-5 relative, 1e-4 of the largest
     gradient) and entry()'s frame above 50 dB against the CPU path;
 35. BASELINE.json configuration 1 (benchmark_suite.config_1_mr_spheres):
     16 spheres of uv_sphere(0.42, 24, 32) through PBRRenderer.render at
     512 x 512 with their own small IBL (8 x 128 tiles, lists of 4,096,
     chunk 32); one warm-up frame whose K1 inputs are recorded: its raster
     statistics against the CPU path's at the same inputs, K1 against its
     plain version there; --frames timed frames with the counts zeroed just
     before and read just after (K1 1 a frame); a 128 x 128 copy on the GPU
     against the port's CPU path;
 36. configuration 2 (config_2_shadows): a sphere of 27,360 triangles over
     a 40 m plane at 1920 x 1080, per frame four 2048^2 cascades (K4),
     EVSM2 moments and their blur, then PBRRenderer.render with the
     cascades (the fused forward, K1); from the warm-up frame K4 bit for
     bit at each cascade's inputs and K1 at the frame's against their plain
     versions, each cascade's raster statistics against the CPU path's; the
     fused forward with EVSM2 against its two-pass branch (K4) on the card;
     --frames timed frames (K4 4, K1 1 a frame); a 256 x 128 copy with
     256^2 cascades against the CPU path;
 37. configuration 3 (config_3_sponza): the 24-column atrium (165,152
     triangles) through HnTaskManager.execute at 1920 x 1080 (lists of
     1,536, sub_bins 1, SSAO on the per-tap warp route, SSR off the kernel
     route, no TAA or bloom); from the warm-up frame the raster statistics
     (the pairs and big triangles the lists drop) against the CPU path's
     at the same inputs, K1 against its plain version and K2 at each of
     the frame's launches, exactly; --frames timed frames (K1 1, K3 0, K2
     the warm-up frame's count a frame); a 256 x 128 copy of the atrium
     with 4 columns against the CPU path.

Prints the median frame times, one JSON line with each kernel's launches,
times and bound, the card's name and power limit, and last
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--frames N] [--out-png PATH] [--profile PATH]
       python3 chip_smoke.py --only warp [--root DIR]
       python3 chip_smoke.py --only raster [--root DIR]
       python3 chip_smoke.py --only csm [--profile PATH] [--root DIR]
       python3 chip_smoke.py --only march_gtao [--root DIR]
       python3 chip_smoke.py --only oit [--profile PATH] [--root DIR]
       python3 chip_smoke.py --only lights [--profile PATH] [--root DIR]
       python3 chip_smoke.py --only ext_skin [--profile PATH] [--root DIR]
       python3 chip_smoke.py --only editor [--profile PATH] [--root DIR]
       python3 chip_smoke.py --only hydra [--profile PATH] [--root DIR]
       python3 chip_smoke.py --only radient [--profile PATH] [--root DIR]
       python3 chip_smoke.py --only split4k [--frames N] [--out-png PATH]
       python3 chip_smoke.py --only banded [--frames N]
       python3 chip_smoke.py --only inverse [--frames N]
       python3 chip_smoke.py --only baseline [--frames N]
(the second runs phases 1, 3 and 13 alone, K6 on random taps; the third
phases 1, 2, 8 without the csm frame, and 11 without the full-chain frame;
the fourth phases 1 and 9; the fifth phase 1, one bench frame for its
G-buffer, and phases 5 and 6; the sixth phases 1, 15 and 16; the seventh
phases 1, 18 and 19; the eighth phases 1, 21 and 22; the ninth phases 1,
24 and 25; the tenth phases 1, 26 and 27; the eleventh phases 1, 28
and 29; the twelfth phases 1, 30 and 31; the thirteenth phases 1, 32 and
33; the fourteenth phases 1 and 34; the last phases 1 and 35-37, and it
ends in the kernels line, the card line and the ok line as the whole run
does; each on the port of
the checkout DIR: run it in two checkouts in turn, A B B A, to compare
them in one call)
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = HERE                  # the checkout the port is imported from (--root)

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

DEVICE = "cuda"
W, H = 1920, 1080
SMALL_W, SMALL_H = 256, 128
SUN = [-0.5, -0.7, -0.5]
SHADOW_SIZE, NUM_CASCADES = 2048, 4      # bench.py --csm
FULL_CHAIN_SUN = [-0.4, -1.0, -0.2]      # examples/benchmark_suite.py:217


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# `--only march_gtao --root DIR` may time an earlier checkout of the port,
# which lacks the counters of K3's and K5's work; everywhere else they are
# required
EARLIER_CHECKOUT_OK = False


def counter_fn(module, name: str):
    """module.name; under `--only march_gtao --root` an earlier checkout
    may lack it (None, with a note), anywhere else its absence fails."""
    fn = getattr(module, name, None)
    if fn is None:
        check(EARLIER_CHECKOUT_OK, f"{module.__name__} has no {name}")
        print(f"{module.__name__}: this checkout has no {name}", flush=True)
    return fn


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# the bench scene and frame configuration (bench.py)
# ---------------------------------------------------------------------------


def bench_scene(rows, cols, sphere_res, device):
    from diligentfx_tpu_torch.attribs import PBRMaterialBasicAttribs
    from diligentfx_tpu_torch.gltf.primitives import plane, uv_sphere
    from diligentfx_tpu_torch.pbr.renderer import build_scene
    mesh = uv_sphere(0.42, stacks=sphere_res, slices=sphere_res + 8)
    ground = plane(40.0, segments=8)
    entries = []
    for r in range(rows):
        for c in range(cols):
            node = np.eye(4, dtype=np.float32)
            node[3, :3] = [c - (cols - 1) / 2, (rows - 1) / 2 - r, 0.0]
            mat = PBRMaterialBasicAttribs.create(
                base_color_factor=(0.8, 0.3, 0.25, 1.0),
                metallic_factor=r / max(rows - 1, 1),
                roughness_factor=max(c / max(cols - 1, 1), 0.03))
            entries.append((mesh, node, mat))
    gnode = np.eye(4, dtype=np.float32)
    gnode[3, :3] = [0.0, -rows / 2 - 0.5, 0.0]
    entries.append((ground, gnode, PBRMaterialBasicAttribs.create(
        base_color_factor=(0.5, 0.5, 0.55, 1.0), metallic_factor=0.0,
        roughness_factor=0.6)))
    return build_scene(entries, device=device)


def bench_raster_config():
    from diligentfx_tpu_torch.config import RasterizerConfig
    return RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=1024,
                            max_tiles_per_tri=8, big_tri_capacity=64, chunk=8,
                            pair_compaction_cap=1 << 17, sub_bins=4,
                            big_tile_capacity=16)


def bench_task_manager_ci():
    """bench.py:149-161 without --csm: every effect on its kernel route."""
    from diligentfx_tpu_torch.hydrogent.task_manager import \
        TaskManagerCreateInfo
    from diligentfx_tpu_torch.postfx.taa import TAAFeatureFlags
    return TaskManagerCreateInfo(
        enable_ssao=True, ssao_half_resolution=True, ssao_num_slices=2,
        ssao_num_steps=4, ssao_use_pallas=True, ssr_use_pallas=True,
        fast_env_taps=True, enable_ssr=True, ssr_half_resolution=True,
        ssr_resolution_divisor=2, enable_taa=True, enable_bloom=True,
        enable_dof=False,
        taa_feature_flags=(TAAFeatureFlags.YCOCG_COLOR_SPACE
                           | TAAFeatureFlags.GAUSSIAN_WEIGHTING
                           | TAAFeatureFlags.PALLAS_WARP))


def bench_settings():
    from diligentfx_tpu_torch.hydrogent.task_manager import FrameSettings
    from diligentfx_tpu_torch.postfx.ssr import SSRSettings
    return FrameSettings(ssr=SSRSettings(max_traversal_intersections=24))


def render_info(w, h, device, csm=False):
    """The bench camera and lights; with csm the sun casts the cascaded
    shadows (shadow map index 0), as in bench.py --csm."""
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                              PBRRendererShaderParameters)
    from diligentfx_tpu_torch.pbr.renderer import RenderInfo
    eye = [0.0, 1.0, 7.5]
    view = m3.look_at(eye, [0.0, 0.0, 0.0], device=device)
    proj = m3.perspective(0.7, w / h, 0.1, 100.0, device=device)
    cam = CameraAttribs.create(view, proj, eye, 0.1, 100.0, w, h,
                               device=device)
    lights = PBRLightAttribs.concat([
        PBRLightAttribs.directional(SUN, [3.0, 3.0, 3.0],
                                    shadow_map_index=0 if csm else -1,
                                    device=device),
        PBRLightAttribs.point([2.0, 2.0, 2.0], [8.0, 7.0, 6.0], range=30.0,
                              device=device)])
    return RenderInfo(camera=cam, lights=lights,
                      renderer_params=PBRRendererShaderParameters.create(
                          device=device))


# ---------------------------------------------------------------------------
# the full-chain configuration (examples/benchmark_suite.py config 4): the
# scene builders, configs and cameras come from the port's module
# diligentfx_tpu_torch/examples/benchmark_suite.py; these are its names here
# ---------------------------------------------------------------------------


def suite():
    """diligentfx_tpu_torch.examples.benchmark_suite (imported once the
    port's checkout is on the path)."""
    from diligentfx_tpu_torch.examples import benchmark_suite
    return benchmark_suite


def full_chain_scene(n_columns=12, wall_segments=24, device=DEVICE):
    """sponza_like_scene: 112,592 triangles at 12 columns."""
    return suite().sponza_like_scene(n_columns, wall_segments, device=device)


def full_chain_entries(n_columns=12, wall_segments=24):
    """full_chain_scene's (mesh, node matrix, material) entries."""
    return suite().sponza_like_entries(n_columns, wall_segments)


def full_chain_raster_config():
    """config 4's: the unsegmented binning (sub_bins 1), lists of 1,536."""
    return suite().config_4_raster_config()


def full_chain_task_manager_ci():
    """config 4's effects (epipolar light scattering: 256 slices x 128
    samples x 24 steps)."""
    return suite().config_4_task_manager_ci()


def full_chain_info(i, w, h, device):
    """Frame i of config_4_animated: the camera circles the atrium at 10 m
    (0.02 rad a frame) looking at (0, 1, 0); one directional light."""
    return suite().atrium_info(i, w, h, device)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from diligentfx_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build(cuda_build.KERNELS)
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(key in line for key in ("entry function", "registers",
                                           "spill", "smem")):
                print(f"  {name}: {line.strip()}")


def _tile_tests(cand, used, r0, n, rects, tiles_x, th, tw):
    """Candidate-pixel tests of a tile raster on these inputs: each used
    slot ((tiles, cap) bool) on its tile's columns and its segment's rows
    [r0, r0 + n) of the tile (the whole-segment loop's count), and, with
    `rects`, only on the pixels inside the slot's candidate rectangle
    (raster.candidate_rects): what the inputs need, whatever kernel runs.
    Returns (unculled tests, tests inside, the most inside one tile); the
    last two None without rects (a checkout from before the rectangles,
    under --only raster alone)."""
    import torch
    unculled = int((used * n).sum()) * tw
    if rects is None:
        return unculled, None, None
    tile = torch.arange(cand.shape[0], device=cand.device)[:, None]
    x0 = (tile % tiles_x) * tw
    y0 = (tile // tiles_x) * th + r0
    r = rects[torch.clamp(cand.long(), min=0)].long()     # (tiles, cap, 4)
    cols = torch.clamp(torch.minimum(r[..., 2], x0 + tw - 1)
                       - torch.maximum(r[..., 0], x0) + 1, min=0)
    rows = torch.clamp(torch.minimum(r[..., 3], y0 + n - 1)
                       - torch.maximum(r[..., 1], y0) + 1, min=0)
    inside = (used * cols * rows).sum(1)
    return unculled, int(inside.sum()), int(inside.max())


def _raster_work(k, rects, z, tid, out):
    """What K1's function needs on this run's data: the bytes (each needed
    input element read once, each output written once) and the
    candidate-pixel tests of the z-loop, unculled and inside the candidates'
    rectangles `rects` (None: not counted)."""
    import torch
    from diligentfx_tpu_torch.ops.raster_kernel import \
        raster_tiles_winners_plain
    kw = k.kernel_kw
    th, tw, sub = kw["th"], kw["tw"], kw["sub"]
    counts = k.counts.long()
    slots = torch.arange(k.candidates.shape[1], device=counts.device)
    if sub > 0:
        # slot -> segment; small segments test th // sub rows, the big one th
        seg = torch.clamp(slots // kw["cap_sub"], max=sub)
        local = slots - seg * kw["cap_sub"]
        lim = torch.where(seg < sub, torch.clamp(counts[:, seg],
                                                 max=kw["cap_sub"]),
                          torch.clamp(counts[:, sub:sub + 1], max=kw["big_cap"]))
        rows = torch.where(seg < sub, th // sub, th)
        r0 = torch.where(seg < sub, seg * (th // sub), 0)
    else:
        local, rows = slots, torch.full_like(slots, th)
        r0 = torch.zeros_like(slots)
        lim = torch.clamp(counts.reshape(-1, 1), max=k.candidates.shape[1])
    used = local[None, :] < lim                     # (tiles, cap) slots read
    unculled, tests, _ = _tile_tests(k.candidates, used, r0[None, :],
                                     rows[None, :], rects, kw["tiles_x"], th,
                                     tw)
    tris = torch.unique(k.candidates[used].long())     # setup rows read
    _, win = raster_tiles_winners_plain(
        k.setup, k.candidates, k.counts, th=th, tw=tw, tiles_x=kw["tiles_x"],
        depth_less=kw["depth_less"], sub=sub, cap_sub=kw["cap_sub"],
        big_cap=kw["big_cap"], screen_offset=kw["screen_offset"])
    winners = torch.unique(win)                         # plane rows read
    c0 = 3 + 3 * kw["n_ch"]
    n_mat = k.mat_table.shape[1]
    mats = torch.unique(torch.clamp(k.planes[winners, c0].long(), 0,
                                    n_mat - 1))         # material columns
    # per setup row read: its 9 plane coefficients (the rectangles are the
    # kernels' own culling input, not work of the function)
    n_bytes = 4 * (9 * tris.numel() + k.planes.shape[1] * winners.numel()
                   + int(used.sum()) + k.counts.numel()
                   + k.mat_table.shape[0] * mats.numel()
                   + z.numel() + tid.numel() + out.numel())
    return n_bytes, unculled, tests


def phase_raster(scene, info, cfg, use_textures=False, label="bench",
                 legacy=False, width=W, height=H, band=None,
                 outputs=None, inputs=None):
    """K1 vs its plain version at the main path's shapes: the bench frame's
    inputs, the csm frame's (use_textures: UV-derivative channels) or the
    full-chain frame's (the unsegmented route), at width x height.
    `band` = (y0, band_h): the inputs of a row band's viewport window,
    rows [y0, y0 + band_h) of the padded frame (render_gbuffer_band_sp).
    `legacy` (--only raster on a checkout from before the candidate
    rectangles): the kernel takes none, and the tests inside them are not
    counted.  `outputs`, a list, receives the kernel's (z, tid, out).
    `inputs`: the FusedKernelInputs a frame built (frame_captures), in
    place of fused_raster_inputs's of scene and info."""
    import torch
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.ops.raster_kernel import (
        raster_tiles_fused, raster_tiles_fused_plain)
    from diligentfx_tpu_torch.pbr.deferred import fused_raster_inputs
    pad_w, pad_h = rz.pad_viewport(width, height, cfg)
    window = {}
    if band is not None:
        window = dict(screen_size=(pad_w, pad_h), screen_offset=(0, band[0]))
        pad_h = band[1]
    k = inputs if inputs is not None else fused_raster_inputs(
        scene, info, pad_w=pad_w, pad_h=pad_h, cfg=cfg,
        use_textures=use_textures, **window)
    st = {f: int(v) for f, v in zip(k.stats._fields, k.stats)}
    print(f"{label} raster stats at {pad_w}x{pad_h}: {st}", flush=True)
    rects = None if legacy else k.rects
    args = (k.setup, k.planes, k.candidates, k.counts, k.mat_table) + (
        () if legacy else (rects,))
    z, tid, out = raster_tiles_fused(*args, **k.kernel_kw)
    torch.cuda.synchronize()
    zp, tidp, outp = raster_tiles_fused_plain(*args, **k.kernel_kw)
    check(z.shape == (pad_h, pad_w) and out.shape == outp.shape,
          f"raster shapes {tuple(z.shape)} {tuple(out.shape)}")
    id_mismatch = int((tid != tidp).sum())
    hit = (tid >= 0) & (tid == tidp)
    # a band may cover nothing (the sky above a horizon): then only the
    # ids are compared
    any_hit = bool(hit.any())
    z_err = float((z - zp).abs()[hit].max()) if any_hit else 0.0
    ch_err = float((out - outp).abs()[:, hit].max()) if any_hit else 0.0
    ch_tol = float(1e-5 * torch.clamp(outp[:, hit].abs().max(), min=1.0)) \
        if any_hit else 0.0
    # the derivative channels (after the n_ch values) are small, so they are
    # also held to 1e-5 of their own largest magnitude
    n_ch, n_d = k.kernel_kw["n_ch"], 2 * len(k.kernel_kw["deriv_channels"])
    d_err = d_tol = 0.0
    if n_d and any_hit:
        d_ref = outp[n_ch:n_ch + n_d][:, hit]
        d_err = float((out[n_ch:n_ch + n_d][:, hit] - d_ref).abs().max())
        d_tol = float(1e-5 * d_ref.abs().max())
    # bit for bit: the ids everywhere, depth and channels where hit
    bit_equal = id_mismatch == 0 and z_err == ch_err == d_err == 0.0
    print(f"{label} raster_fused vs plain: {out.shape[0]} channels ({n_d} "
          f"derivatives), bit-equal {bit_equal}, id mismatches "
          f"{id_mismatch} of {tid.numel()}, hit "
          f"px {int(hit.sum())}, z max err {z_err:.3g}, channel max err "
          f"{ch_err:.3g} (tol {ch_tol:.3g}), derivative max err {d_err:.3g} "
          f"(tol {d_tol:.3g})", flush=True)
    check(id_mismatch == 0, "raster kernel tri ids differ from the plain "
          "version")
    check(z_err <= 1e-6, f"raster kernel depth error {z_err}")
    check(ch_err <= ch_tol, f"raster kernel channel error {ch_err}")
    check(d_err <= d_tol, f"raster kernel derivative error {d_err}")
    check(any_hit or band is not None, "raster kernel covered no pixel")
    if outputs is not None:
        outputs.append((z, tid, out))

    def k1():
        return raster_tiles_fused(*args, **k.kernel_kw)
    ms = cuda_ms(k1, 20, 2)
    dev_ms = kernel_device_ms(k1, "raster_fused_kernel", 10)
    plain_ms = cuda_ms(lambda: raster_tiles_fused_plain(*args, **k.kernel_kw),
                       3, 1)
    n_bytes, unculled, tests = _raster_work(k, rects, z, tid, out)
    # operations: 15 flops a candidate-pixel test (two edge planes, the third
    # edge, the depth plane and its sign), 5 + 5 a channel in the epilogue,
    # 3 a derivative
    epi_ops = (5 + 5 * n_ch + 3 * n_d) * z.numel()
    old_ms, old_by = bound_ms(n_bytes, 15 * unculled + epi_ops)
    b_ms, b_by = (bound_ms(n_bytes, 15 * tests + epi_ops) if tests is not None
                  else (old_ms, old_by))
    print(f"{label} raster_fused: candidate-pixel tests {unculled / 1e6:.2f} M "
          f"on whole segments, "
          f"{'not counted' if tests is None else f'{tests / 1e6:.2f} M'} "
          f"inside the rectangles; {n_bytes / 1e6:.1f} MB the function "
          f"needs; {ms:.4f} ms CUDA events, device {dev_ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms; bound {b_ms:.4f} ms ({b_by}; counted on "
          f"whole segments {old_ms:.4f} ms, {old_by})", flush=True)
    return dict(name="raster_tiles_fused", route="cuda",
                source="diligentfx_tpu_torch/csrc/raster_fused.cu",
                replaces="diligentfx_tpu/ops/raster_pallas.py:261",
                max_abs_err=max(z_err, ch_err, d_err), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_ms,
                candidate_pixel_tests=tests,
                candidate_pixel_tests_unculled=unculled,
                bound_ms_unculled=old_ms, raster_stats=st,
                bit_equal=bit_equal)


def _warp_case(h, w, c, halo, gen):
    import torch
    img = torch.rand((h, w, c) if c > 1 else (h, w), generator=gen,
                     device=DEVICE)
    lim = torch.tensor([3.0 * halo[1], 3.0 * halo[0]], device=DEVICE)
    off = (torch.rand((h, w, 2), generator=gen, device=DEVICE) * 2 - 1) * lim
    return img.contiguous(), off.contiguous()


def _grid_sample_fn(img, off):
    """One PyTorch call computing a bilinear tap at pixel + offset with
    border clamp (the library yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    h, w = off.shape[:2]
    x = torch.arange(w, device=DEVICE, dtype=torch.float32)[None, :]
    y = torch.arange(h, device=DEVICE, dtype=torch.float32)[:, None]
    grid = torch.stack([(x + 0.5 + off[..., 0]) / w * 2 - 1,
                        (y + 0.5 + off[..., 1]) / h * 2 - 1], -1)[None]
    src = (img[None, None] if img.dim() == 2
           else img.permute(2, 0, 1)[None]).contiguous()
    return lambda: F.grid_sample(src, grid, mode="bilinear",
                                 padding_mode="border", align_corners=False)


# K2's launch shapes on the frames' paths: name -> (h, w, channels, halo,
# the pixels the caller keeps).  SSAO and SSR warp the half-resolution
# 540 x 960 grid edge-padded to the warp's 8 x 128 and crop the result, so
# their bound counts only the 540 x 960 pixels.
HALF_H, HALF_W = -(-(H // 2) // 8) * 8, -(-(W // 2) // 128) * 128
HALF_PX = (H // 2) * (W // 2)
WARP_SHAPES = {
    "disocclusion": (H, W, 1, (16, 64), H * W),
    "ssao_tap": (HALF_H, HALF_W, 1, (16, 64), HALF_PX),  # 2 x 2 sides x 4
    "ssao_history": (H, W, 2, (8, 64), H * W),
    "ssr_history": (HALF_H, HALF_W, 4, (16, 64), HALF_PX),
    "taa_history": (H, W, 4, (8, 64), H * W),
    # the DoF bokeh taps gather the half-resolution prefiltered colour and
    # the two reaches (postfx/dof.py:143, :207-214)
    "dof_tap": (HALF_H, HALF_W, 5, (16, 64), HALF_PX),
    # five channels at full resolution, on no frame's path
    "c5_1080p": (H, W, 5, (16, 64), H * W),
}
# K2's launches a frame by shape: the bench (and csm) frame's 20 and the
# full-chain frame's 43 (SSR keeps its history without the warp there)
WARP_FRAME = {"disocclusion": 1, "ssao_tap": 16, "ssao_history": 1,
              "ssr_history": 1, "taa_history": 1}
WARP_FULL_CHAIN = {"disocclusion": 1, "ssao_tap": 16, "ssao_history": 1,
                   "taa_history": 1, "dof_tap": 24}


# the profiler rows of K2's kernels (warp_tap_vec / warp_tap_elem; the
# whole name also matches an earlier checkout's warp_kernel under --root)
K2_KERNELS = "warp"


def host_us(fn, n=1000):
    """Host clock a call over n enqueues of fn, with no synchronise among
    them (the wrapper's host cost while the card keeps up)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def phase_warp():
    """K2 vs its plain version at every launch shape of the three frames
    (the DoF taps' five channels included) and more (five channels at
    1080p), all exact.  Times per shape, CUDA events and device time, of K2
    and of grid_sample on the same inputs, summed over the bench frame's 20
    launches and the full-chain frame's 43; the wrapper's host cost a
    call."""
    import torch
    from diligentfx_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_plain
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    max_err = 0.0
    cases = [(h, w, c, halo) for h, w, c, halo, _ in WARP_SHAPES.values()]
    cases += [(H, W, 4, (16, 64)), (H, W, 1, (8, 64)),
              (256, 128, 4, (8, 64)), (64, 384, 1, (16, 64))]
    for h, w, c, halo in cases:
        img, off = _warp_case(h, w, c, halo, gen)
        a = warp_bilinear(img, off, halo_r=halo[0], halo_c=halo[1])
        torch.cuda.synchronize()
        b = warp_bilinear_plain(img, off, halo_r=halo[0], halo_c=halo[1])
        err = float((a - b).abs().max())
        print(f"warp {h}x{w}x{c} halo {halo}: max err {err:.3g}", flush=True)
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              "warp output shape / finiteness")
        check(err == 0.0, f"warp kernel error {err} at {h}x{w}x{c} {halo}")
        max_err = max(max_err, err)

    per_shape = {}
    for name, (h, w, c, halo, px) in WARP_SHAPES.items():
        img, off = _warp_case(h, w, c, halo, gen)
        kw = dict(halo_r=halo[0], halo_c=halo[1])
        k2 = lambda: warp_bilinear(img, off, **kw)        # noqa: E731
        lib = _grid_sample_fn(img, off)
        # over the kept pixels: image and output (c floats a pixel) plus the
        # offsets (2 floats); about 20 flops of tap coordinates a pixel and
        # 9 a channel
        b, by = bound_ms(4 * px * (2 * c + 2), px * (20 + 9 * c))
        per_shape[name] = dict(
            shape=[h, w, c], halo=list(halo), ms=cuda_ms(k2, 50, 3),
            device_ms=kernel_device_ms(k2, K2_KERNELS, 20),
            library_ms=cuda_ms(lib, 50, 3),
            library_device_ms=kernel_device_ms(lib, "grid_sampler", 20),
            plain_ms=cuda_ms(lambda: warp_bilinear_plain(img, off, **kw),
                             10, 2),
            bound_ms=b, bound_by=by)
        s = per_shape[name]
        print(f"warp {name} {h}x{w}x{c} halo {halo}: {s['ms']:.4f} ms "
              f"events, device {s['device_ms']:.4f} (bound {b:.4f} = "
              f"{b / s['device_ms']:.0%} of it); grid_sample "
              f"{s['library_ms']:.4f} / device {s['library_device_ms']:.4f}; "
              f"plain {s['plain_ms']:.3f}", flush=True)

    def launch_set(launches):
        return {key: sum(n * per_shape[name][key]
                         for name, n in launches.items())
                for key in ("ms", "device_ms", "library_ms",
                            "library_device_ms", "plain_ms", "bound_ms")}
    bench, fc = launch_set(WARP_FRAME), launch_set(WARP_FULL_CHAIN)
    img, off = _warp_case(HALF_H, HALF_W, 1, (16, 64), gen)
    host = dict(warp_bilinear=host_us(lambda: warp_bilinear(img, off)),
                grid_sample=host_us(_grid_sample_fn(img, off)))
    for label, t, n in (("bench", bench, 20), ("full-chain", fc, 43)):
        print(f"warp: the {label} frame's {n} launches {t['ms']:.4f} ms "
              f"events, device {t['device_ms']:.4f}; grid_sample "
              f"{t['library_ms']:.4f} / device {t['library_device_ms']:.4f};"
              f" bound {t['bound_ms']:.4f}", flush=True)
    half_bound = {name: "held" if s["device_ms"] <= 2 * s["bound_ms"]
                  else "missed" for name, s in per_shape.items()}
    print(f"warp goals: bench events below grid_sample's "
          f"{'held' if bench['ms'] < bench['library_ms'] else 'missed'}; "
          f"device time at least half the bound at the DoF taps "
          f"{half_bound['dof_tap']}, at five channels at 1080p "
          f"{half_bound['c5_1080p']}; host us a call: K2 "
          f"{host['warp_bilinear']:.2f}, grid_sample "
          f"{host['grid_sample']:.2f}", flush=True)
    return dict(name="warp_bilinear", route="cuda",
                source="diligentfx_tpu_torch/csrc/warp.cu",
                replaces="diligentfx_tpu/ops/warp_pallas.py:34",
                max_abs_err=max_err, ms=bench["ms"],
                plain_ms=bench["plain_ms"], bound_ms=bench["bound_ms"],
                bound_by="/".join(sorted({s["bound_by"]
                                          for s in per_shape.values()})),
                library_ms=bench["library_ms"],
                device_ms=bench["device_ms"],
                library_device_ms=bench["library_device_ms"],
                timed="the bench frame's 20 launches: " + ", ".join(
                    f"{n} x {name}" for name, n in WARP_FRAME.items()),
                full_chain_launch_set=dict(fc, launches=", ".join(
                    f"{n} x {name}" for name, n in WARP_FULL_CHAIN.items())),
                host_us=host, per_shape=per_shape)


def _launch_counters():
    from diligentfx_tpu_torch.ops.gtao import gtao_fused
    from diligentfx_tpu_torch.ops.march import march_small_table
    from diligentfx_tpu_torch.ops.raster_kernel import raster_tiles_fused
    from diligentfx_tpu_torch.ops.raster_tiles import raster_tiles
    from diligentfx_tpu_torch.ops.warp import (warp_bilinear,
                                               warp_bilinear_multi)
    return {"raster_tiles_fused": raster_tiles_fused,
            "warp_bilinear": warp_bilinear,
            "march_small_table": march_small_table, "gtao_fused": gtao_fused,
            "raster_tiles": raster_tiles,
            "warp_bilinear_multi": warp_bilinear_multi}


def zero_launches():
    for fn in _launch_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _launch_counters().items()}


# launches a bench frame makes of each kernel (K5 and K6 are off the
# frames' paths; K4 runs only in the --csm frame's shadow pass)
FRAME_LAUNCHES = {"raster_tiles_fused": 1, "warp_bilinear": 20,
                  "march_small_table": 1, "gtao_fused": 0, "raster_tiles": 0,
                  "warp_bilinear_multi": 0}
# a --csm frame: K4 once per shadow cascade
CSM_FRAME_LAUNCHES = {**FRAME_LAUNCHES, "raster_tiles": 4}
# a full-chain frame: K2 for the disocclusion tap 1, the SSAO taps 16 and
# history 1, the TAA history 1 and the DoF bokeh taps 24; SSR takes its
# non-kernel march and keeps its history without the warp
FULL_CHAIN_LAUNCHES = {**FRAME_LAUNCHES, "warp_bilinear": 43,
                       "march_small_table": 0}


def frame_captures(fn, **targets):
    """fn() with each target (module, attribute name) wrapped to record
    its calls: returns (fn's result, {target: [(args, kwargs, result)]}).
    The wrapped functions run as always; this only watches them."""
    calls = {name: [] for name in targets}
    saved = {name: getattr(mod, attr) for name, (mod, attr) in targets.items()}

    def recorder(name, orig):
        def record(*args, **kwargs):
            out = orig(*args, **kwargs)
            calls[name].append((args, kwargs, out))
            return out
        return record
    for name, (mod, attr) in targets.items():
        setattr(mod, attr, recorder(name, saved[name]))
    try:
        result = fn()
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, saved[name])
    return result, calls


def warp_launch_shapes(fn):
    """fn() and the ((h, w, c), halo) of each K2 launch it made, the way
    phase 3 names them (fn runs K2 through its wrapper as always)."""
    from diligentfx_tpu_torch.ops import warp
    out, calls = frame_captures(fn, k2=(warp, "_launch"))
    return out, sorted(((tuple(img.shape) + (1,))[:3], (halo_r, halo_c))
                       for (img, _, halo_r, halo_c), _, _ in calls["k2"])


def frame_args(scene, frame_info):
    """(scene, info) of the next frame: frame_info() first (it may advance
    an animation), then the scene, or `scene()` when a frame makes its own
    scene (the ext_skin frame's update_animation)."""
    info = frame_info()
    return (scene() if callable(scene) else scene), info


def timed_frames(tm, scene, frame_info, frames, expected, label,
                 warp_launches, warmup_wrap=None, execute_kw=None,
                 settings_of=None, on_output=None):
    """One warm-up frame of tm.execute on frame_info() (called once a
    frame), which must launch K2 at the shapes of `warp_launches`
    (WARP_SHAPES name -> launches), then `frames` timed frames (host clock
    ending in a synchronise, CUDA events beside it), with the launch counts
    zeroed just before and read just after and held to `expected` a frame.
    `warmup_wrap(fn)`, when given, wraps the warm-up frame's call (to
    observe it); `execute_kw` are more keywords of execute;
    `settings_of()`, when given, makes each frame's FrameSettings (after
    frame_info), else bench_settings(); `on_output(out)` sees each
    frame's output.  Returns (last output, state, host ms list, device ms
    list, launches)."""
    import torch
    settings_of = settings_of or bench_settings
    on_output = on_output or (lambda out: None)
    state = tm.initial_state(W, H)
    execute_kw = execute_kw or {}

    def frame(state):
        args = frame_args(scene, frame_info)
        out = tm.execute(*args, state, width=W, height=H,
                         settings=settings_of(), **execute_kw)
        on_output(out)
        return out

    def warmup():
        return frame(state)
    out, shapes = warp_launch_shapes(warmup_wrap(warmup) if warmup_wrap
                                     else warmup)
    want = sorted(((h, w, c), halo) for name, n in warp_launches.items()
                  for h, w, c, halo, _ in [WARP_SHAPES[name]] * n)
    check(shapes == want, f"{label} frame launched K2 at {shapes}, phase 3 "
          f"times {want}")
    state = out.state
    torch.cuda.synchronize()
    check(tuple(out.color.shape) == (H, W, 3), f"{label} frame shape")
    check(bool(torch.isfinite(out.color).all()),
          f"{label} warm-up frame not finite")

    zero_launches()
    host_ms, dev_ms = [], []
    for _ in range(frames):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        out = frame(state)
        state = out.state
        ev1.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(ev0.elapsed_time(ev1))
    launches = read_launches()
    color = out.color
    check(bool(torch.isfinite(color).all()), f"{label} frame not finite")
    check(float(color.min()) >= 0.0 and float(color.max()) <= 1.0,
          f"{label} sRGB output outside [0, 1]")
    hit = float(out.gbuffer.hit.float().mean())
    check(0.2 < hit < 1.0, f"{label} hit fraction {hit}")
    for name, per_frame in expected.items():
        check(launches[name] == per_frame * frames,
              f"{label}: {name} launched {launches[name]} times in {frames} "
              f"frames, expected {per_frame} a frame")
    ao = state.ssao.history
    conf = state.ssr.radiance[..., 3]
    check(bool(torch.isfinite(ao).all()) and float(ao.min()) >= 0.0
          and float(ao.max()) <= 1.0, f"{label} SSAO history outside [0, 1]")
    check(bool(torch.isfinite(state.ssr.radiance).all()),
          f"{label} SSR not finite")
    print(f"{label} frame {W}x{H}: median {np.median(host_ms):.3f} ms host "
          f"clock, {np.median(dev_ms):.3f} ms CUDA events, min "
          f"{min(host_ms):.3f}, max {max(host_ms):.3f} ({frames} frames), "
          f"hit {hit:.3f}, mean color {float(color.mean()):.4f}, mean AO "
          f"{float(ao.mean()):.4f}, SSR confidence > 0 on "
          f"{float((conf > 0).float().mean()):.4f} of the march grid",
          flush=True)
    return out, state, host_ms, dev_ms, launches


def _write_png(path, color):
    from diligentfx_tpu_torch.utils.image import write_png
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, color.cpu().numpy())


def phase_frame(scene, info, cfg, frames, out_png):
    """The main path: the bench frame on the bench scene at 1080p."""
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    t0 = time.perf_counter()
    renderer = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg,
                           device=DEVICE)
    torch.cuda.synchronize()
    print(f"renderer + IBL precompute: {time.perf_counter() - t0:.2f} s",
          flush=True)
    tm = HnTaskManager(renderer, bench_task_manager_ci())
    out, state, host_ms, dev_ms, launches = timed_frames(
        tm, scene, lambda: info, frames, FRAME_LAUNCHES, "bench",
        WARP_FRAME)
    if out_png:
        _write_png(out_png, out.color)
    return (tm, launches, float(np.median(host_ms)), float(np.median(dev_ms)),
            out.gbuffer, state)


# K3's operations for one crossed table row: the row's t-interval (2
# divisions, 2 subtractions, 2 multiplications, min, max, 2 clamps, the
# test, the midpoint: 14) and 2 sub-intervals of 68 (entry/exit columns 6,
# z 4, slop and window 3, the inside test 4, t span and slack 2, and 3 plane
# tests of 15: f0, f1, 4 comparisons, the denominator, its test, the
# division, the clamp, t* and the running-min test)
MARCH_OPS_PER_ROW = 14 + 2 * 68


def _march_rows_crossed(coarse, origin, direction) -> int:
    """Table rows with a non-empty t-interval, summed over the rays: the
    rows the march must test on this data (march_dda_plain's `has`)."""
    import torch
    rows = coarse.shape[0]
    ov, dv = origin[..., 1], direction[..., 1]
    flat = torch.abs(dv) <= 1e-7
    inv_dv = 1.0 / torch.where(flat, torch.full_like(dv, 1e-7), dv)
    r = torch.arange(rows + 1, device=ov.device, dtype=torch.float32) / rows
    crossed = flat.sum()
    for i in range(rows):
        ta = (r[i] - ov) * inv_dv
        tb = (r[i + 1] - ov) * inv_dv
        tin = torch.clamp(torch.minimum(ta, tb), 0.0, 1.0)
        tout = torch.clamp(torch.maximum(ta, tb), 0.0, 1.0)
        crossed = crossed + ((tout > tin) & ~flat).sum()
    return int(crossed)


def _flat_rays(gen, h, w, rows, cols, flat_share=0.2):
    """A random table and rays, `flat_share` of them nearly horizontal
    (|dv| <= 1e-7, half of those exactly 0)."""
    import torch

    def u(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=DEVICE)
    coarse = u(0.35, 0.95, (rows, cols))
    o = torch.stack([u(0.02, 0.98, (h, w)), u(0.02, 0.98, (h, w)),
                     u(0.05, 0.6, (h, w))], -1)
    d = torch.stack([u(-0.6, 0.6, (h, w)), u(-0.6, 0.6, (h, w)),
                     u(-0.1, 0.8, (h, w))], -1)
    flat = torch.rand((h, w), generator=gen, device=DEVICE) < flat_share
    tiny = torch.where(torch.rand((h, w), generator=gen, device=DEVICE) < 0.5,
                       torch.zeros((h, w), device=DEVICE), u(-1e-7, 1e-7, (h, w)))
    d[..., 1] = torch.where(flat, tiny, d[..., 1])
    return coarse.contiguous(), o.contiguous(), d.contiguous()


def march_lanes(origin, direction, rows):
    """K3's lane efficiency at these rays: the rows each ray walks
    (ops/march.py `march_row_span`, the kernel's loop bounds) summed, over
    the sum over warps of 32 x the longest walk in the warp; with warps as
    csrc/march.cu maps them where it sorts (ops/march.py
    `march_warp_walks`) and as 32 neighbouring rays of one grid row (the
    unsorted mapping).  Empty, and the sorted one left out, where an
    earlier checkout lacks those functions (`counter_fn`)."""
    from diligentfx_tpu_torch.ops import march
    row_span = counter_fn(march, "march_row_span")
    if row_span is None:
        return {}
    r0, r1 = row_span(origin[..., 1], direction[..., 1], rows)
    walk = (r1 - r0).clamp(min=0)
    h, w = walk.shape

    def efficiency(warps):
        return float(walk.sum()) / float(32 * warps.max(-1).values.sum())
    row_eff = efficiency(walk.reshape(h, w // 32, 32))
    out = dict(rows_walked_per_ray=float(walk.float().mean()),
               lane_efficiency_grid_rows=row_eff)
    warp_walks = counter_fn(march, "march_warp_walks")
    if warp_walks is not None:
        out["lane_efficiency"] = efficiency(warp_walks(walk))
    print(f"march lanes: {out['rows_walked_per_ray']:.2f} rows walked a ray; "
          f"lane efficiency {out.get('lane_efficiency', row_eff):.4f} as the "
          f"kernel maps warps, {row_eff:.4f} for warps of one grid row",
          flush=True)
    return out


def card_under_load(fn, seconds=0.5):
    """nvidia-smi's name, power limit, SM clock and power draw, sampled
    every 50 ms while fn runs back to back for about `seconds` (the median
    sample); the sampler is stopped before this returns."""
    import torch
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader", "-lms", "50"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[len(lines) // 2] if lines else "nvidia-smi gave no sample"


def phase_march(gb, info):
    """K3 vs march_dda_plain at the inputs compute_ssr builds from the
    frame's G-buffer (the kernel route: mip 3 of the divisor-2 grid, rays
    padded to 544 x 1024; exact there), on random rays with flat ones, and
    on 128-, 447-, 454- and 600-row tables (the table in shared memory at
    an odd pitch and at pitch 128, and read from global memory); its
    events and device time, the lane efficiency at the frame's rays and the
    card's clock and power under load."""
    import torch
    from diligentfx_tpu_torch.ops import march
    from diligentfx_tpu_torch.ops.march import (march_dda_plain,
                                                march_small_table)
    coarse, origin, direction, args, thick = march_inputs(
        gb.depth, gb.normal_view, gb.material_data[..., 1:2], info.camera, 1,
        bench_settings().ssr)
    print(f"march: table {tuple(coarse.shape)}, rays {tuple(args[1].shape)}",
          flush=True)
    # the walk-down to <= 128 columns lands on mip 3: 67 x 120 at 1080p
    check(tuple(coarse.shape) == (H // 2 // 8, W // 2 // 8) and
          tuple(args[1].shape) == (HALF_H, HALF_W, 3),
          "the march does not take the frame's mip-3 table")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    max_err = 0.0
    # beside the frame's table: flat rays, a 1024x1024 frame's 128 x 128
    # mip 2 (64 KB: shared memory above 48 KB), 447 rows (the tallest
    # table shared memory holds, at pitch 128) and 454 and 600 rows (read
    # from global memory): both kernel variants and both shared pitches
    pitch_of = counter_fn(march, "march_table_pitch")

    def route(rows, cols):
        if pitch_of is None:
            return "route not known"
        pitch = pitch_of(rows, cols)
        return f"shared, pitch {pitch}" if pitch else "global"
    for name, case in (("frame", args),
                       ("flat_rays", _flat_rays(gen, 64, 256, 67, 120)),
                       ("table_128x128", _flat_rays(gen, 64, 256, 128, 128,
                                                    0.05)),
                       ("table_447x128", _flat_rays(gen, 64, 256, 447, 128,
                                                    0.05)),
                       ("table_454x128", _flat_rays(gen, 64, 256, 454, 128,
                                                    0.05)),
                       ("table_600x128", _flat_rays(gen, 64, 256, 600, 128,
                                                    0.05))):
        a = march_small_table(*case, thick)
        torch.cuda.synchronize()
        b = march_dda_plain(*case, thick)
        flips = int((a[2] != b[2]).sum())
        err = max(float((a[0] - b[0]).abs().max()),
                  float((a[1] - b[1]).abs().max()))
        print(f"march {name}: table {tuple(case[0].shape)} "
              f"({route(*case[0].shape)}), hit "
              f"{float(b[2].float().mean()):.4f} of "
              f"{b[2].numel()}, hit mismatches {flips}, t max err {err:.3g}",
              flush=True)
        check(flips == 0, f"march kernel hits differ from the plain version "
                          f"({name}: {flips})")
        check(err <= (0.0 if name == "frame" else 1e-6),
              f"march kernel t error {err} ({name})")
        max_err = max(max_err, err)
    def run():
        return march_small_table(*args, thick)
    ms = cuda_ms(run, 20, 2)
    dev_ms = kernel_device_ms(run, "march_kernel", 20)
    plain_ms = cuda_ms(lambda: march_dda_plain(*args, thick), 3, 1)
    card = card_under_load(run)
    # the work over the rays compute_ssr keeps (540 x 960; the edge-padded
    # copies up to 544 x 1024 are cropped away): table and rays read once,
    # t_lo, t_hit and hit written once
    crossed = _march_rows_crossed(coarse, origin, direction)
    px = origin.shape[0] * origin.shape[1]
    n_bytes = 4 * coarse.numel() + px * (24 + 9)
    b_ms, b_by = bound_ms(n_bytes, MARCH_OPS_PER_ROW * crossed)
    lanes = march_lanes(args[1], args[2], coarse.shape[0])
    print(f"march: {crossed / px:.2f} crossed rows a ray over {px} rays "
          f"({args[1].shape[0] * args[1].shape[1]} launched), "
          f"{MARCH_OPS_PER_ROW * crossed / 1e6:.1f} M ops; {ms:.4f} ms "
          f"events, {dev_ms:.4f} device, bound {b_ms:.4f} ({b_by}): "
          f"{b_ms / dev_ms:.1%} of it; {card}", flush=True)
    return dict(name="march_small_table", route="cuda",
                source="diligentfx_tpu_torch/csrc/march.cu",
                replaces="diligentfx_tpu/ops/march_pallas.py:95",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, device_ms=dev_ms,
                rows_crossed_per_ray=crossed / px, **lanes,
                card_under_load=card,
                shapes=f"table {tuple(coarse.shape)}, rays "
                       f"{tuple(origin.shape)} padded to "
                       f"{tuple(args[1].shape)}")


def march_inputs(depth, normal_view, roughness, camera, frame_index, st,
                 divisor=2):
    """K3's inputs as compute_ssr builds them on the kernel route at
    resolution divisor `divisor`: (the table, the rays' origins and
    directions, the kernel's padded arguments, the thickness)."""
    from diligentfx_tpu_torch.postfx import ssr
    d = divisor
    depth_r = depth[::d, ::d]
    *_, origin, direction = ssr._ray_setup(
        depth_r, normal_view[::d, ::d], roughness[::d, ::d], camera,
        frame_index, st)
    coarse = ssr._coarse_table(ssr.build_min_depth_pyramid(depth_r, 4), 2,
                               True)
    return (coarse, origin, direction,
            ssr._kernel_march_args(coarse, origin, direction),
            ssr._thickness_ndc(st, camera))


def _gtao_ops(px: int, slices: int, steps: int) -> int:
    """K5's operations: per pixel 45 (view position and vector, noise, tap
    radius), per slice 75 (slice geometry 45, two polynomial arccos 20, the
    arc 10, counting sqrt, division and cosine as one each), per tap 55
    (offsets 8, window tap 17, reconstruction 12, distance and cosine 13,
    falloff 5)."""
    return px * (45 + slices * (75 + 2 * steps * 55))


def gtao_sectors(d2, sc, kw):
    """K5's sectors a tap load: the mean number of distinct 32-byte
    sectors of the padded depth that one warp-wide texel load touches,
    over every launched warp (32 neighbouring pixels of one row) and each
    of a tap's four texel loads (the second row's where it is read), from
    the plain version's tap coordinates (ops/gtao.py `gtao_taps`).  Empty
    where an earlier checkout lacks `gtao_taps` (`counter_fn`)."""
    import torch
    from diligentfx_tpu_torch.ops import gtao
    taps = counter_fn(gtao, "gtao_taps")
    if taps is None:
        return {}
    sectors = loads = 0.0
    for t in taps(d2, sc, **kw):
        hp, wp = t.r0.shape
        for r, c, live in ((t.r0, t.c0, None), (t.r0, t.c1, None),
                           (t.r1, t.c0, t.has1), (t.r1, t.c1, t.has1)):
            sec = (r * wp + c) // 8
            if live is not None:
                sec = torch.where(live, sec, -1)
            sec = sec.reshape(hp, wp // 32, 32).sort(-1).values
            distinct = 1 + (sec[..., 1:] != sec[..., :-1]).sum(-1)
            if live is not None:          # idle lanes load nothing
                idle = (sec[..., 0] < 0).long()
                distinct = distinct - idle
                loads += float((distinct > 0).sum())
            else:
                loads += distinct.numel()
            sectors += float(distinct.sum())
    print(f"gtao: {sectors / loads:.2f} sectors a warp-wide tap load",
          flush=True)
    return dict(sectors_per_tap_load=sectors / loads)


def phase_gtao(gb, info, frame_state):
    """K5 vs gtao_fused_plain and against the per-tap route on the frame's
    half-resolution depth and normals (and vs gtao_fused_plain on random
    64 x 256 and 100 x 700 inputs), its events and device time, the sectors
    a warp-wide tap load touches and the card's clock and power under load;
    then its own path: apply_ssao on the kernel route with fused=True, on
    the frame's G-buffer."""
    import torch
    from diligentfx_tpu_torch.ops.gtao import gtao_fused, gtao_fused_plain
    from diligentfx_tpu_torch.postfx import ssao
    ci = bench_task_manager_ci()
    kw = dict(num_slices=ci.ssao_num_slices, num_steps=ci.ssao_num_steps)
    d2 = gb.depth[::2, ::2].contiguous()
    n2 = gb.normal_view[::2, ::2].contiguous()
    h2, w2 = d2.shape
    sc = ssao.gtao_scalars(info.camera, 1, ssao.SSAOSettings())
    a = gtao_fused(d2, n2, sc, **kw)
    torch.cuda.synchronize()
    b = gtao_fused_plain(d2, n2, sc, **kw)
    err = float((a - b).abs().max())
    per_tap = ssao.compute_gtao(d2, n2, info.camera, 1, ssao.SSAOSettings(),
                                use_pallas=True, **kw)
    dev_tap = (a - per_tap).abs()[2:-2, 2:-2]
    p99 = float(torch.quantile(dev_tap.flatten(), 0.99))
    print(f"gtao {h2}x{w2}: fused vs plain max err {err:.3g}; vs the per-tap "
          f"route p99 {p99:.3g}, max {float(dev_tap.max()):.3g}; mean AO "
          f"{float(a.mean()):.4f}", flush=True)
    check(bool(torch.isfinite(a).all()) and float(a.min()) >= 0.0
          and float(a.max()) <= 1.0, "gtao output outside [0, 1]")
    check(err <= 1e-5, f"gtao kernel error {err}")
    # random depth at the smallest open-halo grid and at a grid whose
    # window widens and whose origin rounds down (the reach clipped)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    for h3, w3 in ((64, 256), (100, 700)):
        d3 = 0.3 + 0.6 * torch.rand((h3, w3), generator=gen, device=DEVICE)
        n3 = torch.nn.functional.normalize(torch.rand(
            (h3, w3, 3), generator=gen, device=DEVICE) - 0.5, dim=-1)
        e3 = float((gtao_fused(d3, n3, sc, **kw)
                    - gtao_fused_plain(d3, n3, sc, **kw)).abs().max())
        print(f"gtao {h3}x{w3} random: fused vs plain max err {e3:.3g}",
              flush=True)
        check(e3 <= 1e-5, f"gtao kernel error {e3} at {h3}x{w3}")
        err = max(err, e3)
    # tests/test_gtao_pallas.py:41's bounds for the fused against per-tap
    check(p99 < 1e-3 and float(dev_tap.max()) < 6e-3,
          "fused GTAO disagrees with the per-tap route")

    def run():
        return gtao_fused(d2, n2, sc, **kw)
    ms = cuda_ms(run, 20, 2)
    dev_ms = kernel_device_ms(run, "gtao_kernel", 20)
    card = card_under_load(run)
    plain_ms = cuda_ms(lambda: gtao_fused_plain(d2, n2, sc, **kw), 3, 1)
    sectors = gtao_sectors(d2, sc, kw)
    per_tap_ms = cuda_ms(lambda: ssao.compute_gtao(
        d2, n2, info.camera, 1, ssao.SSAOSettings(), use_pallas=True, **kw),
        10, 2)
    # over the pixels the caller keeps (the kernel runs the grid padded to
    # 32 x 128 and crops): depth, normal and output once, the 8 scalars
    b_ms, b_by = bound_ms(4 * (h2 * w2 * (1 + 3 + 1)) + 32,
                          _gtao_ops(h2 * w2, kw["num_slices"], kw["num_steps"]))
    print(f"gtao: fused {ms:.4f} ms events, {dev_ms:.4f} device, bound "
          f"{b_ms:.5f} ({b_by}): {b_ms / dev_ms:.1%} of it; per-tap route "
          f"(16 warp launches and glue) {per_tap_ms:.4f} ms; {card}",
          flush=True)

    # K5's path: the SSAO entry point with the fused kernel selected
    hist = frame_state.ssao
    zero_launches()
    ao, _ = ssao.apply_ssao(gb.depth, gb.normal_view, info.camera, 1,
                            state=hist, motion=gb.motion,
                            half_resolution=True, use_pallas=True, fused=True,
                            **kw)
    launches = read_launches()
    torch.cuda.synchronize()
    check(tuple(ao.shape) == (H, W) and bool(torch.isfinite(ao).all()),
          "fused apply_ssao output")
    check(launches["gtao_fused"] == 1 and launches["warp_bilinear"] == 1,
          f"apply_ssao(fused=True) launched {launches}")
    return dict(name="gtao_fused", route="cuda",
                source="diligentfx_tpu_torch/csrc/gtao.cu",
                replaces="diligentfx_tpu/ops/gtao_pallas.py:63",
                launches=launches["gtao_fused"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_ms,
                per_tap_route_ms=per_tap_ms, **sectors,
                card_under_load=card,
                path="apply_ssao(use_pallas=True, fused=True) on the 1080p "
                     "G-buffer, once (the frame takes the per-tap route)",
                shapes=f"depth ({h2},{w2}) padded to 544x1024")


# the port's kernels (csrc/*.cu), launched through ctypes: the profiler
# ties their device time to no op, so it is in no dfx.* range's device time
PORT_KERNELS = ("raster_fused_kernel", "warp_tap_", "march_kernel",
                "raster_tiles_kernel", "gtao_kernel", "warp_multi_kernel")
STAGES = ("dfx.shadows", "dfx.light_shadows", "dfx.gbuffer",
          "dfx.raster_inputs", "dfx.skinning",
          "dfx.alpha_mask", "dfx.context_composite", "dfx.ssao", "dfx.ssr",
          "dfx.oit", "dfx.components", "dfx.light_scattering",
          "dfx.exposure", "dfx.taa_bloom_tonemap", "dfx.debug_view",
          "dfx.dof")


# the kernel-name keys whose device time came from CUDA events because
# torch.profiler showed none (kernel_device_ms)
DEVICE_MS_FROM_EVENTS = []


def _device_us(event, field):
    """A profiler event's device time (older PyTorch names it cuda_*)."""
    if hasattr(event, field):
        return getattr(event, field)
    return getattr(event, field.replace("device", "cuda"))


def phase_raster_inputs_host(scene, info, cfg, frames):
    """Host time of the vertex stage, setup and binning
    (fused_raster_inputs) alone, which synchronise the host with the
    device."""
    import torch
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.pbr.deferred import fused_raster_inputs
    pad_w, pad_h = rz.pad_viewport(W, H, cfg)
    host = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_raster_inputs(scene, info, pad_w=pad_w, pad_h=pad_h, cfg=cfg)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    print(f"profile raster inputs alone (vertex stage, setup, binning): "
          f"median {np.median(host):.3f} ms host clock, device synchronised",
          flush=True)


def phase_profile(tm, scene, frame_info, frames, path, label,
                  ranges=("dfx.shadows",), execute_kw=None,
                  settings_of=None):
    """Where a frame's time goes: torch.profiler over `frames` frames of
    HnTaskManager.execute on frame_info() (the csm and light / heap frames'
    shadow passes included): device time of each stage (the dfx.* ranges;
    dfx.raster_inputs and dfx.alpha_mask lie inside dfx.gbuffer, dfx.ssao,
    dfx.ssr, dfx.oit, dfx.components, dfx.light_scattering and
    dfx.exposure inside dfx.context_composite, dfx.dof, dfx.debug_view
    and the vector field's dfx.components inside dfx.taa_bloom_tonemap,
    dfx.shadows and dfx.light_shadows before them all) and
    of each kernel, and the device's idle share; for the stages of `ranges`
    that ran, their kernels and host ops (range_breakdown).  A stage's
    device time leaves out the port's own kernels (PORT_KERNELS), printed
    on a line of their own.  `execute_kw` are more keywords of execute,
    `settings_of()` makes each frame's FrameSettings (bench_settings by
    default).  Writes the profiler's table to `path` (none when empty);
    returns the stages' and ranges' numbers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    settings_of = settings_of or bench_settings
    execute_kw = execute_kw or {}
    state = tm.execute(*frame_args(scene, frame_info),
                       tm.initial_state(W, H), width=W, height=H,
                       settings=settings_of(), **execute_kw).state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            args = frame_args(scene, frame_info)
            state = tm.execute(*args, state, width=W, height=H,
                               settings=settings_of(), **execute_kw).state
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_frame = wall_ms / frames
    stage_ms = {name: [0.0, 0.0] for name in STAGES}
    for e in prof.events():    # the host-side ranges; device time of kernels
        if e.name in stage_ms and e.device_type == DeviceType.CPU:
            dev_us = _device_us(e, "device_time_total")
            stage_ms[e.name][0] += e.cpu_time_total / 1e3 / frames
            stage_ms[e.name][1] += dev_us / 1e3 / frames
    rows = []     # device-side kernel rows only (the aten rows repeat them)
    for e in prof.key_averages():
        dev_us = _device_us(e, "self_device_time_total")
        if dev_us > 0 and str(e.device_type).endswith("CUDA") and \
                e.key not in stage_ms:
            rows.append((dev_us / 1e3 / frames, e.count // frames, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile {label}: {per_frame:.3f} ms a frame under the profiler, "
          f"device busy {busy:.3f} ms ({100 * busy / per_frame:.1f}%), idle "
          f"{100 * (1 - busy / per_frame):.1f}%, "
          f"{sum(r[1] for r in rows)} kernel launches a frame", flush=True)
    for name, (cpu_ms, dev_ms) in stage_ms.items():
        print(f"profile {label} stage {name}: device {dev_ms:.3f} ms, host "
              f"{cpu_ms:.3f} ms under the profiler", flush=True)
    for ms, n, key in rows[:12]:
        print(f"profile {label} kernel {ms:.4f} ms x{n}/frame {key[:90]}")
    own = [(key[key.index(k):].split("(")[0], ms, n) for ms, n, key in rows
           for k in PORT_KERNELS if k in key]
    print(f"profile {label}: the port's kernels, in no stage's device time: "
          + "; ".join(f"{name} {ms:.4f} ms x{n}" for name, ms, n in own),
          flush=True)
    breakdown = {name: range_breakdown(prof, name, frames, label)
                 for name in ranges if stage_ms[name][0] > 0}
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                              row_limit=80))
    return dict(frame_ms_profiled=per_frame, device_busy_ms=busy,
                launches=sum(r[1] for r in rows),
                stages={k: dict(host_ms=v[0], device_ms=v[1])
                        for k, v in stage_ms.items() if v[0] > 0},
                ranges=breakdown)


def range_breakdown(prof, name, frames, label, top=10):
    """Inside the ranges `name`: the kernels by device time and the ops the
    range called directly by host time, a frame, largest first.  Returns
    the kernel launches and their device ms, and the host ops' calls and
    ms, a frame."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    dev = defaultdict(lambda: [0.0, 0])
    host = defaultdict(lambda: [0.0, 0])

    def walk(e):
        for k in e.kernels:
            dev[k.name][0] += k.duration
            dev[k.name][1] += 1
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name == name and e.device_type == DeviceType.CPU:
            walk(e)
            for c in e.cpu_children:
                host[c.name][0] += c.cpu_time_total
                host[c.name][1] += 1
    totals = {}
    for what, acc in (("kernel", dev), ("host op", host)):
        n = sum(v[1] for v in acc.values())
        ms = sum(v[0] for v in acc.values()) / 1e3 / frames
        totals[what] = dict(calls=n // frames, ms=ms)
        print(f"profile {label} {name}: {n // frames} {what} calls a frame, "
              f"{ms:.3f} ms", flush=True)
        for key, (us, cnt) in sorted(acc.items(), key=lambda kv: -kv[1][0])[
                :top]:
            print(f"profile {label} {name} {what} {us / 1e3 / frames:.4f} ms "
                  f"x{cnt // frames}/frame {key[:90]}", flush=True)
    return totals


def slice_task_manager_ci():
    """The first slice's frame: the bench effects less SSAO and SSR (the
    composite then applies no AO and blends no reflection)."""
    import dataclasses
    return dataclasses.replace(bench_task_manager_ci(), enable_ssao=False,
                               enable_ssr=False)


def small_frames(task_ci, device):
    """Two 256x128 frames of the small bench scene under `task_ci`, on the
    CPU path (the plain versions) and on `device`: (cpu colour, colour)."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ci = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=32,
                               num_specular_env_samples=16)
    cfg = bench_raster_config()
    ref = PBRRenderer(ci, raster_cfg=cfg, device="cpu")
    colors = []
    for dev in ("cpu", device):
        ren = (ref if dev == "cpu" else
               PBRRenderer(ci, raster_cfg=cfg, device=dev,
                           env_oct=ref.env_oct, ibl_maps=ref.ibl_maps.to(dev)))
        tm = HnTaskManager(ren, task_ci)
        scene = bench_scene(2, 2, 12, dev)
        info = render_info(SMALL_W, SMALL_H, dev)
        state = tm.initial_state(SMALL_W, SMALL_H)
        for _ in range(2):
            out = tm.execute(scene, info, state, width=SMALL_W,
                             height=SMALL_H, settings=bench_settings())
            state = out.state
        colors.append(out.color.cpu().numpy())
    return colors[0], colors[1]


def phase_reference():
    """The first slice's frame and the bench frame at 256x128 on the GPU
    against the port's CPU path."""
    from diligentfx_tpu_torch.utils.image import psnr
    for name, task_ci in (("slice-1", slice_task_manager_ci()),
                          ("bench", bench_task_manager_ci())):
        cpu, gpu = small_frames(task_ci, DEVICE)
        p = psnr(cpu, gpu)
        print(f"256x128 {name} frame, GPU vs the port's CPU path: PSNR "
              f"{p:.2f} dB, max abs diff {np.abs(cpu - gpu).max():.3g}",
              flush=True)
        check(np.isfinite(gpu).all(), f"small {name} frame not finite")
        check(p > 50.0, f"GPU {name} frame disagrees with the CPU path: "
                        f"{p:.2f} dB")


# ---------------------------------------------------------------------------
# the --csm configuration (bench.py --csm)
# ---------------------------------------------------------------------------


def bench_atlas(num_materials, device, tex_size=256):
    """The bench's procedural material textures (bench.py `_bench_atlas`,
    its own numpy copy): a checker base colour, a bumpy tangent-space
    normal map and a phys-desc map, 6 box-filtered mips, bound to every
    material with a x4 uv tiling and wrap mode 1 in both directions.
    Returns (atlas, tex_ids, tex_uv_transform, tex_wraps)."""
    import torch
    from diligentfx_tpu_torch.gltf.model import (NUM_SLOTS, SLOT_BASE_COLOR,
                                                 SLOT_NORMAL, SLOT_PHYS_DESC)
    from diligentfx_tpu_torch.ops.texture import AtlasBuilder
    rng = np.random.default_rng(42)
    b = AtlasBuilder(size=tex_size)
    yy, xx = np.mgrid[0:tex_size, 0:tex_size].astype(np.float32) / tex_size
    checker = ((np.floor(yy * 8) + np.floor(xx * 8)) % 2)[..., None]
    base = (0.35 + 0.5 * checker * np.ones((1, 1, 3), np.float32)
            + 0.08 * rng.random((tex_size, tex_size, 3), dtype=np.float32))
    bc_id = b.add(np.clip(base, 0.0, 1.0).astype(np.float32))
    h_field = np.sin(yy * 40.0) * np.cos(xx * 40.0) * 0.5
    nx, ny = np.gradient(h_field)
    nrm = np.stack([-nx * 4, -ny * 4, np.ones_like(nx)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    n_id = b.add((nrm * 0.5 + 0.5).astype(np.float32))
    pd = np.stack([np.zeros_like(yy), 0.4 + 0.5 * checker[..., 0],
                   0.2 + 0.3 * (1 - checker[..., 0])], axis=-1)
    pd_id = b.add(pd.astype(np.float32))
    atlas = b.build(num_mips=6, device=device)
    tex_ids = np.full((num_materials, NUM_SLOTS), -1, np.int32)
    tex_ids[:, SLOT_BASE_COLOR] = bc_id
    tex_ids[:, SLOT_NORMAL] = n_id
    tex_ids[:, SLOT_PHYS_DESC] = pd_id
    xform = np.tile(np.array([4, 0, 0, 4, 0, 0], np.float32),
                    (num_materials, NUM_SLOTS, 1))
    wraps = np.ones((num_materials, NUM_SLOTS, 2), np.int32)
    return (atlas, torch.from_numpy(tex_ids).to(device),
            torch.from_numpy(xform).to(device),
            torch.from_numpy(wraps).to(device))


def csm_scene(rows, cols, sphere_res, device, tex_size=256):
    """The bench scene with the bench's textures: (scene, atlas)."""
    scene = bench_scene(rows, cols, sphere_res, device)
    atlas, ids, xform, wraps = bench_atlas(
        scene.materials.base_color_factor.shape[0], device, tex_size)
    return scene._replace(tex_ids=ids, tex_uv_transform=xform,
                          tex_wraps=wraps), atlas


def csm_attribs(info, num_cascades, size):
    """bench.py --csm's cascades for the (unjittered) bench camera."""
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.components.shadow_map_manager import \
        distribute_cascades
    cam = info.camera
    return distribute_cascades(cam.view, m3.inverse(cam.view),
                               float(cam.proj[0, 0]), float(cam.proj[1, 1]),
                               0.1, 100.0, SUN, num_cascades=num_cascades,
                               shadow_map_size=size)


def csm_task_manager_ci():
    """bench.py:149-161 with --csm: the bench effects plus EVSM2 shadows."""
    import dataclasses
    from diligentfx_tpu_torch.config import ShadowMode
    return dataclasses.replace(bench_task_manager_ci(), enable_shadows=True,
                               shadow_mode=ShadowMode.EVSM2)


# the reference's raster statistics of the bench's four cascades (the JAX
# package's _triangle_setup + _bin_triangles on the CPU): valid triangles,
# the sum of the per-tile candidate counts, bin_overflow, big_overflow
CASCADE_STATS_JAX = ((6, 6144, 0, 0), (100996, 151552, 6582, 0),
                     (111683, 122238, 81384, 15), (111722, 4461, 109256, 0))


def kernel_device_ms(fn, key, iters, tries=5):
    """Device time a call of the kernels whose name contains `key` ("" for
    all), from torch.profiler's kernel rows over `iters` calls of fn.  A
    profile with no such row (the profiler can come back without device
    activity) is taken again, `tries` times in all; after that the CUDA
    events time of a call stands in, and the line printed says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
        us = sum(_device_us(e, "self_device_time_total") for e in rows
                 if key in e.key)
        if us > 0:
            return us / 1e3 / iters
        print(f"profiler: no device time for kernels named {key!r} "
              f"(try {attempt} of {tries}; {len(rows)} device rows: "
              f"{[e.key[:40] for e in rows[:4]]})", flush=True)
    ms = cuda_ms(fn, iters)
    DEVICE_MS_FROM_EVENTS.append(key)
    print(f"profiler: device time for kernels named {key!r} not measured; "
          f"CUDA events {ms:.4f} ms a call stand in", flush=True)
    return ms


def phase_shadow_raster(cfg, scene, legacy=False):
    """K4 vs raster_tiles_plain on the bench's four 2048^2 cascades of the
    textured bench scene, as the shadow pass builds their inputs; each
    cascade's raster statistics against the reference's; reversed depth
    (depth_less=False) on cascade 1.  `legacy` as phase_raster's."""
    import torch
    from diligentfx_tpu_torch.components import shadow_map_manager as smm
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.ops.raster_tiles import (raster_tiles,
                                                       raster_tiles_plain)
    from diligentfx_tpu_torch.pbr.renderer import transform_vertices
    info = render_info(W, H, DEVICE, csm=True)
    att = csm_attribs(info, NUM_CASCADES, SHADOW_SIZE)
    wp, _, _ = transform_vertices(scene)
    both = torch.ones((scene.num_triangles,), dtype=torch.bool,
                      device=DEVICE)
    s = SHADOW_SIZE
    th, tw = cfg.tile_h, cfg.tile_w
    cases, max_err, stats = [], 0.0, []
    for i in range(NUM_CASCADES):
        clip = smm.cascade_clip(wp, att, i)
        setup, valid, bbox, _, clip_ovf = rz._triangle_setup(
            clip, scene.indices, s, s, both, True, 1e-3)
        cand, counts, max_count, ovf, big_ovf = rz._bin_triangles(
            valid, bbox, s, s, cfg)
        kw = dict(th=th, tw=tw, tiles_x=s // tw)
        st = (int(valid.sum()), int(counts.sum()), int(ovf + clip_ovf),
              int(big_ovf))
        exp = CASCADE_STATS_JAX[i]
        print(f"cascade {i}: valid {st[0]}, sum of tile counts {st[1]}, "
              f"max tile count {int(counts.max())} (cap {cand.shape[1]}), "
              f"max bin count {int(max_count)}, bin_overflow {st[2]}, "
              f"big_overflow {st[3]} (the reference: {exp})", flush=True)
        check(st == exp, f"cascade {i} raster stats {st} are not the "
                         f"reference's {exp}")
        stats.append(dict(cascade=i, valid=st[0], counts=st[1],
                          max_count=int(counts.max()),
                          max_bin_count=int(max_count), bin_overflow=st[2],
                          big_overflow=st[3]))
        rects = None if legacy else rz.candidate_rects(setup, s, s)
        args = (setup, cand, counts) + (() if legacy else (rects,))
        for depth_less in ((False, True) if i == 1 else (True,)):
            a = raster_tiles(*args, depth_less=depth_less, **kw)
            torch.cuda.synchronize()
            b = raster_tiles_plain(*args, depth_less=depth_less, **kw)
            ids = int((a[1] != b[1]).sum())
            hit = b[1] >= 0
            errs = [float((x - y).abs()[hit].max()) if bool(hit.any())
                    else 0.0 for x, y in ((a[0], b[0]), (a[2], b[2]),
                                          (a[3], b[3]))]
            clear = float("inf") if depth_less else float("-inf")
            misses_ok = bool((a[0][~hit] == clear).all()
                             and (a[2][~hit] == 0).all()
                             and (a[3][~hit] == 0).all())
            print(f"raster_tiles cascade {i} depth_less={depth_less}: id "
                  f"mismatches {ids} of {b[1].numel()}, covered "
                  f"{float(hit.float().mean()):.4f}, max err z "
                  f"{errs[0]:.3g} b0 {errs[1]:.3g} b1 {errs[2]:.3g}",
                  flush=True)
            check(ids == 0, f"K4 ids differ from the plain version "
                            f"(cascade {i}, depth_less={depth_less})")
            check(max(errs) <= 1e-6, f"K4 error {errs} (cascade {i})")
            check(misses_ok, f"K4 clear values wrong (cascade {i})")
            max_err = max(max_err, *errs)
        cases.append((args, kw, b, rects))

    def k4_all():
        for args, kw, _, _ in cases:
            raster_tiles(*args, **kw)

    def plain_all():
        for args, kw, _, _ in cases:
            raster_tiles_plain(*args, **kw)

    ms = cuda_ms(k4_all, 10, 2)
    dev_ms = kernel_device_ms(k4_all, "raster_tiles_kernel", 5)
    plain_ms = cuda_ms(plain_all, 1, 1)
    # the rectangles K4 takes: what computing them adds to the shadow pass
    rects_ms = rects_dev_ms = None
    if not legacy:
        def rects_all():
            for (setup, *_), _, _, _ in cases:
                rz.candidate_rects(setup, s, s)
        rects_ms = cuda_ms(rects_all, 10, 2)
        rects_dev_ms = kernel_device_ms(rects_all, "", 5)
        print(f"candidate_rects for the 4 cascades: {rects_ms:.4f} ms CUDA "
              f"events, device {rects_dev_ms:.4f} ms", flush=True)
    # the work of the 4 cascades: each used candidate tested on its tile's
    # pixels (unculled) or on those inside its rectangle; the setup rows the
    # loop reads (9 floats; the rectangles are the kernel's own culling
    # input, not work of the function) and the winners' (7 more), the
    # candidate ids and counts read once, 16 B a pixel out
    tests = unculled = n_bytes = 0
    heaviest = []
    for (setup, cand, counts, *_), kw, b, rects in cases:
        used = (torch.arange(cand.shape[1], device=DEVICE)[None, :]
                < torch.clamp(counts.long(), max=cand.shape[1])[:, None])
        old, new, most = _tile_tests(cand, used, 0, th, rects, kw["tiles_x"],
                                     th, tw)
        unculled += old
        tests = None if new is None or tests is None else tests + new
        heaviest.append(most)
        rows = torch.unique(cand[used].long()).numel()
        winners = torch.unique(b[1][b[1] >= 0]).numel()
        n_bytes += 4 * (9 * rows + 7 * winners + int(used.sum())
                        + counts.numel()) + 16 * b[1].numel()
    # 15 flops a candidate-pixel test (as K1's), 8 a covered pixel for the
    # two barycentric planes
    covered = sum(int((c[2][1] >= 0).sum()) for c in cases)
    old_ms, old_by = bound_ms(n_bytes, 15 * unculled + 8 * covered)
    b_ms, b_by = (bound_ms(n_bytes, 15 * tests + 8 * covered)
                  if tests is not None else (old_ms, old_by))
    print(f"raster_tiles: 4 cascades {ms:.4f} ms CUDA events, device "
          f"{dev_ms:.4f} ms; candidate-pixel tests {unculled / 1e9:.4f} G on "
          f"whole tiles, "
          f"{'not counted' if tests is None else f'{tests / 1e6:.2f} M'} "
          f"inside the rectangles (the most in one tile of {th * tw} pixels, "
          f"by cascade: {heaviest}); {n_bytes / 1e6:.1f} MB; bound "
          f"{b_ms:.4f} ms ({b_by}; counted on whole tiles {old_ms:.4f} ms, "
          f"{old_by}); plain {plain_ms:.2f} ms", flush=True)
    return dict(name="raster_tiles", route="cuda",
                source="diligentfx_tpu_torch/csrc/raster_tiles.cu",
                replaces="diligentfx_tpu/ops/raster_pallas.py:35",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, device_ms=dev_ms,
                candidate_pixel_tests=tests,
                candidate_pixel_tests_unculled=unculled,
                bound_ms_unculled=old_ms, rects_ms=rects_ms,
                rects_device_ms=rects_dev_ms, cascade_stats=stats,
                shapes=f"{NUM_CASCADES} cascades of {s}x{s}, tiles "
                       f"{th}x{tw}, cap {cases[0][0][1].shape[1]}")


def phase_csm_frame(cfg, scene, atlas, frames, out_png, ibl_source):
    """The --csm frame: the textured bench scene, four-cascade EVSM2 shadows
    re-rendered every frame (render_shadows, then execute)."""
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    info = render_info(W, H, DEVICE, csm=True)
    att = csm_attribs(info, NUM_CASCADES, SHADOW_SIZE)
    renderer = PBRRenderer(PBRRendererCreateInfo(enable_shadows=True),
                           raster_cfg=cfg, device=DEVICE,
                           env_oct=ibl_source.env_oct,
                           ibl_maps=ibl_source.ibl_maps)
    tm = HnTaskManager(renderer, csm_task_manager_ci(), atlas=atlas)

    def frame_info():
        return tm.render_shadows(scene, info, att,
                                 shadow_map_size=SHADOW_SIZE)

    out, state, host_ms, dev_ms, launches = timed_frames(
        tm, scene, frame_info, frames, CSM_FRAME_LAUNCHES, "csm",
        WARP_FRAME)
    sinfo = frame_info()
    maps = sinfo.shadow_maps
    check(tuple(maps.shape) == (NUM_CASCADES, SHADOW_SIZE, SHADOW_SIZE)
          and bool(torch.isfinite(sinfo.shadow_moments).all())
          and float(maps.min()) >= 0.0 and float(maps.max()) <= 1.0,
          "shadow maps outside [0, 1] or moments not finite")
    cover = [round(float((m < 1.0).float().mean()), 4) for m in maps]
    print(f"csm shadow maps: caster coverage by cascade {cover}", flush=True)
    if out_png:
        root, ext = os.path.splitext(out_png)
        _write_png(f"{root}_csm{ext or '.png'}", out.color)
    return (tm, scene, frame_info, launches, float(np.median(host_ms)),
            float(np.median(dev_ms)))


def small_csm_frames(device):
    """Two 256x128 csm frames of the small textured bench scene (2 cascades
    at 256^2, a 64^2 atlas) on the CPU path and on `device`: (cpu colour,
    colour)."""
    import dataclasses
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ci = PBRRendererCreateInfo(enable_shadows=True, brdf_lut_dim=32,
                               num_brdf_samples=16, irradiance_cube_dim=16,
                               prefiltered_env_map_dim=32,
                               num_specular_env_samples=16)
    cfg = bench_raster_config()
    ref = PBRRenderer(ci, raster_cfg=cfg, device="cpu")
    task_ci = dataclasses.replace(csm_task_manager_ci(), num_cascades=2,
                                  shadow_map_size=256)
    colors = []
    for dev in ("cpu", device):
        ren = (ref if dev == "cpu" else
               PBRRenderer(ci, raster_cfg=cfg, device=dev,
                           env_oct=ref.env_oct, ibl_maps=ref.ibl_maps.to(dev)))
        scene, atlas = csm_scene(2, 2, 12, dev, tex_size=64)
        tm = HnTaskManager(ren, task_ci, atlas=atlas)
        info = render_info(SMALL_W, SMALL_H, dev, csm=True)
        att = csm_attribs(info, 2, 256)
        state = tm.initial_state(SMALL_W, SMALL_H)
        for _ in range(2):
            out = tm.execute(scene, tm.render_shadows(scene, info, att,
                                                      shadow_map_size=256),
                             state, width=SMALL_W, height=SMALL_H,
                             settings=bench_settings())
            state = out.state
        colors.append(out.color.cpu().numpy())
    return colors[0], colors[1]


def forward_csm_frame(device, fuse):
    """PBRRenderer.render of the csm_256 golden scene (tests/golden/
    generate.py render_csm_golden: a sphere on a ground plane, 2-cascade
    EVSM2 shadows at 256^2, 256x128) on `device`."""
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                              PBRMaterialBasicAttribs,
                                              PBRRendererShaderParameters)
    from diligentfx_tpu_torch.components import shadow_map_manager as smm
    from diligentfx_tpu_torch.config import (PBRRendererCreateInfo,
                                             RasterizerConfig, ShadowMode)
    from diligentfx_tpu_torch.gltf.primitives import plane, uv_sphere
    from diligentfx_tpu_torch.pbr.renderer import (PBRRenderer, RenderInfo,
                                                   build_scene,
                                                   transform_vertices)
    w, h = 256, 128
    gn = np.eye(4, dtype=np.float32)
    gn[3, 1] = -1.0
    scene = build_scene([
        (uv_sphere(0.9, 24, 32), np.eye(4, dtype=np.float32),
         PBRMaterialBasicAttribs.create(base_color_factor=(0.7, 0.55, 0.35, 1),
                                        metallic_factor=0.6,
                                        roughness_factor=0.35)),
        (plane(20.0), gn, PBRMaterialBasicAttribs.create(
            base_color_factor=(0.45, 0.45, 0.5, 1.0), roughness_factor=0.7)),
    ], device=device)
    cfg = RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=512,
                           max_tiles_per_tri=16, big_tri_capacity=32, chunk=8)
    ren = PBRRenderer(PBRRendererCreateInfo(
        enable_shadows=True, brdf_lut_dim=32, num_brdf_samples=16,
        irradiance_cube_dim=16, prefiltered_env_map_dim=32,
        num_specular_env_samples=16), raster_cfg=cfg, device=device)
    eye = [0.0, 1.2, 4.0]
    cam = CameraAttribs.create(
        m3.look_at(eye, [0, 0, 0], device=device),
        m3.perspective(0.8, w / h, 0.1, 100.0, device=device), eye, 0.1,
        100.0, w, h, device=device)
    sun = [-0.5, -1.0, -0.4]
    att = smm.distribute_cascades(cam.view, m3.inverse(cam.view),
                                  float(cam.proj[0, 0]),
                                  float(cam.proj[1, 1]), 0.1, 100.0, sun,
                                  num_cascades=2, shadow_map_size=256)
    wp, _, _ = transform_vertices(scene)
    maps = smm.render_cascade_shadow_maps(wp, scene.indices, att,
                                          shadow_map_size=256, cfg=cfg)
    moments = smm.gaussian_blur_separable(
        smm.convert_to_filterable(maps, ShadowMode.EVSM2))
    info = RenderInfo(camera=cam, lights=PBRLightAttribs.directional(
        sun, [4, 4, 4], shadow_map_index=0, device=device),
        renderer_params=PBRRendererShaderParameters.create(device=device),
        shadow_attribs=att, shadow_maps=maps, shadow_moments=moments)
    return ren.render(scene, info, width=w, height=h,
                      shadow_mode=ShadowMode.EVSM2, fuse=fuse).cpu().numpy()


def phase_csm_reference():
    """The 256x128 csm frame and the forward csm_256 frame (two-pass K4 and
    fused K1 branches) on the GPU against the port's CPU path."""
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu = small_csm_frames(DEVICE)
    p = psnr(cpu, gpu)
    print(f"256x128 csm frame, GPU vs the port's CPU path: PSNR {p:.2f} dB, "
          f"max abs diff {np.abs(cpu - gpu).max():.3g}", flush=True)
    check(np.isfinite(gpu).all(), "small csm frame not finite")
    check(p > 50.0, f"GPU csm frame disagrees with the CPU path: {p:.2f} dB")
    cpu = forward_csm_frame("cpu", "auto")
    for fuse, kernel in (("off", "raster_tiles"), ("on", "raster_tiles_fused")):
        zero_launches()
        gpu = forward_csm_frame(DEVICE, fuse)
        launches = read_launches()
        p = psnr(cpu, gpu)
        print(f"forward csm_256 frame, fuse={fuse}, GPU vs the port's CPU "
              f"path: PSNR {p:.2f} dB; launches {launches}", flush=True)
        check(np.isfinite(gpu).all(), f"forward frame ({fuse}) not finite")
        check(p > 50.0, f"forward frame ({fuse}) disagrees with the CPU path: "
                        f"{p:.2f} dB")
        # the two shadow cascades run K4 either way; the frame K4 or K1
        expect = {"raster_tiles": 3 if fuse == "off" else 2,
                  "raster_tiles_fused": 1 if fuse == "on" else 0}
        check(all(launches[k] == v for k, v in expect.items()),
              f"forward frame ({fuse}) launched {launches}")


def phase_full_chain_frame(cfg, scene, frames, out_png, ibl_source):
    """The full-chain frame (config_4_animated) at 1080p: frame i of the
    circling camera, one warm-up frame and `frames` timed ones."""
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    renderer = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg,
                           device=DEVICE, env_oct=ibl_source.env_oct,
                           ibl_maps=ibl_source.ibl_maps)
    t0 = time.perf_counter()
    tm = HnTaskManager(renderer, full_chain_task_manager_ci())
    torch.cuda.synchronize()
    print(f"full-chain task manager + atmosphere LUTs: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    frame = [0]

    def frame_info():
        info = full_chain_info(frame[0], W, H, DEVICE)
        frame[0] += 1
        return info

    out, state, host_ms, dev_ms, launches = timed_frames(
        tm, scene, frame_info, frames, FULL_CHAIN_LAUNCHES, "full-chain",
        WARP_FULL_CHAIN)
    coc = state.dof.coc_history
    lum = float(state.average_log_lum)
    check(bool(torch.isfinite(coc).all()) and float(coc.min()) >= -1.0
          and float(coc.max()) <= 1.0, "DoF CoC history outside [-1, 1]")
    check(np.isfinite(lum) and lum > 0.0, f"adapted exposure {lum}")
    print(f"full-chain state: CoC in [{float(coc.min()):.3f}, "
          f"{float(coc.max()):.3f}], adapted average log luminance "
          f"{lum:.5f}", flush=True)
    if out_png:
        root, ext = os.path.splitext(out_png)
        _write_png(f"{root}_full_chain{ext or '.png'}", out.color)
    return (tm, frame_info, launches, float(np.median(host_ms)),
            float(np.median(dev_ms)), out.gbuffer, state, frame[0] - 1)


def ssao_tap_fields(gb, frame_i, frame_index):
    """K6's natural inputs: the full-chain frame's 16 SSAO horizon-tap
    offset fields (2 slices x 2 sides x 4 steps) on its half-resolution
    depth, edge-padded to 544 x 1024."""
    import torch
    from diligentfx_tpu_torch.postfx import ssao
    from diligentfx_tpu_torch.postfx.context import edge_pad
    ci = full_chain_task_manager_ci()
    cam = full_chain_info(frame_i, W, H, DEVICE).camera
    d2 = gb.depth[::2, ::2]
    offs = ssao.gtao_tap_offsets(d2, cam, frame_index, ssao.SSAOSettings(),
                                 ci.ssao_num_slices, ci.ssao_num_steps)
    ph, pw = HALF_H - d2.shape[0], HALF_W - d2.shape[1]
    img = edge_pad(d2, ph, pw).contiguous()
    off = torch.stack([edge_pad(o, ph, pw) for o in offs]).contiguous()
    check(tuple(off.shape) == (16, HALF_H, HALF_W, 2),
          f"SSAO tap offsets {tuple(off.shape)}")
    return img, off


def random_tap_fields(seed=7):
    """16 random tap offset fields within the halo (16, 64) on a random
    544 x 1024 image: K6's inputs where no frame is rendered (--only)."""
    import torch
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    img = torch.rand((HALF_H, HALF_W), generator=gen, device=DEVICE)
    lim = torch.tensor([63.0, 15.0], device=DEVICE)
    off = (torch.rand((16, HALF_H, HALF_W, 2), generator=gen, device=DEVICE)
           * 2 - 1) * lim
    return img, off.contiguous()


def phase_warp_multi(img, off):
    """K6 vs its plain version and against 16 K2 launches at its natural
    shape (img, off: `ssao_tap_fields`); then halo (8, 64), offsets beyond
    the halo, a 128-wide image, K = 1 and 17 taps at 1080p; all exact.
    Then its own path: the entry point once, the counts zeroed just before
    and read just after; times (CUDA events and device time) beside 16 K2
    launches and one grid_sample call; the fill's re-read of the image."""
    import torch
    import torch.nn.functional as F
    from diligentfx_tpu_torch.ops.warp import (warp_bilinear,
                                               warp_bilinear_multi,
                                               warp_bilinear_multi_plain,
                                               warp_geometry)
    k = off.shape[0]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(6)

    def rand_case(h, w, kk, reach):
        lim = torch.tensor(reach, device=DEVICE)
        return (torch.rand((h, w), generator=gen, device=DEVICE),
                ((torch.rand((kk, h, w, 2), generator=gen, device=DEVICE)
                  * 2 - 1) * lim).contiguous())

    cases = [("ssao_taps", img, off, (16, 64)),
             ("ssao_taps_halo8", img, off, (8, 64)),
             ("beyond_halo", *rand_case(HALF_H, HALF_W, 16, [192.0, 48.0]),
              (16, 64)),
             ("w128_shrink", *rand_case(64, 128, 4, [20.0, 20.0]), (16, 64)),
             ("k1", img, off[:1].contiguous(), (16, 64)),
             # 1080p: 135 tile rows; K not a multiple of the kernel's tap
             # chunk
             ("k17_1080p", *rand_case(H, W, 17, [100.0, 30.0]), (16, 64))]
    max_err = 0.0
    for name, im, of, halo in cases:
        kw = dict(halo_r=halo[0], halo_c=halo[1])
        a = warp_bilinear_multi(im, of, **kw)
        torch.cuda.synchronize()
        b = warp_bilinear_multi_plain(im, of, **kw)
        c = torch.stack([warp_bilinear(im, of[i].contiguous(), **kw)
                         for i in range(of.shape[0])])
        err = float((a - b).abs().max())
        err_k2 = float((a - c).abs().max())
        win = warp_geometry(im.shape[0], im.shape[1], *halo)[2:4]
        print(f"warp_multi {name}: {tuple(of.shape)}, window {win[0]}x"
              f"{win[1]} ({4 * win[0] * win[1]} B), max err vs plain "
              f"{err:.3g}, vs {of.shape[0]} K2 launches {err_k2:.3g}",
              flush=True)
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"warp_multi {name} output shape / finiteness")
        check(err == 0.0 and err_k2 == 0.0,
              f"warp_multi kernel error {err} / {err_k2} ({name})")
        max_err = max(max_err, err, err_k2)

    # its own path: the entry point at the SSAO-tap shape
    zero_launches()
    warp_bilinear_multi(img, off)
    launches = read_launches()
    torch.cuda.synchronize()
    check(launches["warp_bilinear_multi"] == 1
          and sum(launches.values()) == 1,
          f"warp_bilinear_multi's path launched {launches}")

    ms = cuda_ms(lambda: warp_bilinear_multi(img, off), 50, 3)
    dev_ms = kernel_device_ms(lambda: warp_bilinear_multi(img, off),
                              "warp_multi_kernel", 10)
    plain_ms = cuda_ms(lambda: warp_bilinear_multi_plain(img, off), 5, 1)
    taps = [off[i].contiguous() for i in range(k)]

    def k2_taps():
        for o in taps:
            warp_bilinear(img, o)
    k2_ms = cuda_ms(k2_taps, 20, 2)
    k2_dev_ms = kernel_device_ms(k2_taps, K2_KERNELS, 5)
    # the library yardstick: one grid_sample call taking the 16 taps as
    # one (16 H, W) grid of the image, border clamp
    hh, ww = img.shape
    x = torch.arange(ww, device=DEVICE, dtype=torch.float32)[None, None, :]
    y = torch.arange(hh, device=DEVICE, dtype=torch.float32)[None, :, None]
    grid = torch.stack([(x + 0.5 + off[..., 0]) / ww * 2 - 1,
                        (y + 0.5 + off[..., 1]) / hh * 2 - 1],
                       -1).reshape(1, k * hh, ww, 2)
    src = img[None, None]
    lib = lambda: F.grid_sample(src, grid, mode="bilinear",  # noqa: E731
                                padding_mode="border", align_corners=False)
    lib_ms = cuda_ms(lib, 50, 3)
    lib_dev_ms = kernel_device_ms(lib, "grid_sampler", 10)
    # one window a tile, bulk-copied into shared memory
    win_h, win_w = warp_geometry(hh, ww, 16, 64)[2:4]
    reread = (hh // 8) * (ww // 128) * win_h * win_w / (hh * ww)
    # each input read once, each output written once: the image, 8 B of
    # offsets and 4 B of output a tap-pixel; about 20 flops of tap
    # coordinates and 9 of the bilinear lerps a tap-pixel
    px = hh * ww
    n_bytes = 4 * px + k * px * (8 + 4)
    b_ms, b_by = bound_ms(n_bytes, k * px * 29)
    print(f"warp_multi: {k} taps at {hh}x{ww}: {ms:.4f} ms CUDA events, "
          f"device {dev_ms:.4f} ms; {k} K2 launches {k2_ms:.4f} ms (device "
          f"{k2_dev_ms:.4f}); grid_sample {lib_ms:.4f} ms (device "
          f"{lib_dev_ms:.4f}); plain {plain_ms:.3f} ms; {n_bytes / 1e6:.1f} "
          f"MB, bound {b_ms:.4f} ms ({b_by}); fill re-reads the image "
          f"{reread:.2f}x", flush=True)
    print(f"warp_multi goals: device time at most 0.065 ms "
          f"{'held' if dev_ms <= 0.065 else 'missed'}; events below "
          f"grid_sample's {'held' if ms < lib_ms else 'missed'}", flush=True)
    return dict(name="warp_bilinear_multi", route="cuda",
                source="diligentfx_tpu_torch/csrc/warp_multi.cu",
                replaces="diligentfx_tpu/ops/warp_pallas.py:181",
                launches=launches["warp_bilinear_multi"], max_abs_err=max_err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, device_ms=dev_ms,
                library_device_ms=lib_dev_ms, k2_taps_ms=k2_ms,
                k2_taps_device_ms=k2_dev_ms,
                fill_reread=reread,
                path="warp_bilinear_multi, its own entry point, once at the "
                     "SSAO-tap shape (no frame calls it)",
                shapes=f"img ({hh},{ww}), offsets ({k},{hh},{ww},2), halo "
                       f"(16, 64)")


def small_full_chain_frames(device):
    """Two 256x128 full-chain frames (moving camera) of the atrium with 4
    columns, on the CPU path and on `device`: (cpu colour, colour)."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ci = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=32,
                               num_specular_env_samples=16)
    cfg = full_chain_raster_config()
    ref = PBRRenderer(ci, raster_cfg=cfg, device="cpu")
    colors = []
    for dev in ("cpu", device):
        ren = (ref if dev == "cpu" else
               PBRRenderer(ci, raster_cfg=cfg, device=dev,
                           env_oct=ref.env_oct, ibl_maps=ref.ibl_maps.to(dev)))
        tm = HnTaskManager(ren, full_chain_task_manager_ci())
        scene = full_chain_scene(4, device=dev)
        state = tm.initial_state(SMALL_W, SMALL_H)
        for i in range(2):
            out = tm.execute(scene, full_chain_info(i, SMALL_W, SMALL_H, dev),
                             state, width=SMALL_W, height=SMALL_H,
                             settings=bench_settings())
            state = out.state
        colors.append(out.color.cpu().numpy())
    return colors[0], colors[1]


def phase_full_chain_reference():
    """The 256x128 full-chain frame on the GPU against the port's CPU
    path."""
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu = small_full_chain_frames(DEVICE)
    p = psnr(cpu, gpu)
    print(f"256x128 full-chain frame, GPU vs the port's CPU path: PSNR "
          f"{p:.2f} dB, max abs diff {np.abs(cpu - gpu).max():.3g}",
          flush=True)
    check(np.isfinite(gpu).all(), "small full-chain frame not finite")
    check(p > 50.0, f"GPU full-chain frame disagrees with the CPU path: "
                    f"{p:.2f} dB")


# ---------------------------------------------------------------------------
# the mask / blend configuration: the atrium as a glTF file with cut-out
# screens (ALPHA_MODE_MASK) and glass panes (ALPHA_MODE_BLEND)
# ---------------------------------------------------------------------------

OIT_LAYERS = 4                 # TaskManagerCreateInfo.oit_layer_count
ATRIUM_TRIANGLES = 112592      # the opaque atrium at 12 columns


def grid_mesh(nx, ny, sx, sy):
    """An nx x ny grid of quads over [-sx/2, sx/2] x [-sy/2, sy/2] in the
    XY plane, facing +Z (MeshData with tangents)."""
    from diligentfx_tpu_torch.gltf.primitives import MeshData, compute_tangents
    xs = np.linspace(-sx / 2, sx / 2, nx + 1, dtype=np.float32)
    ys = np.linspace(-sy / 2, sy / 2, ny + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    pos = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    nrm = np.tile(np.array([0, 0, 1], np.float32), (pos.shape[0], 1))
    u, v = np.meshgrid(np.linspace(0, 1, nx + 1), np.linspace(1, 0, ny + 1))
    uv = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)
    i = (np.arange(ny)[:, None] * (nx + 1) + np.arange(nx)[None, :]).ravel()
    idx = np.concatenate([np.stack([i, i + 1, i + nx + 2], -1),
                          np.stack([i, i + nx + 2, i + nx + 1], -1)])
    idx = idx.astype(np.int32)
    return MeshData(pos, nrm, uv, idx, compute_tangents(pos, nrm, uv, idx))


def lattice_texture(size=256, holes=8):
    """A procedural RGBA lattice: alpha 0 in the square holes, 1 on the
    bars (uint8)."""
    y, x = np.mgrid[0:size, 0:size]
    cell = size // holes
    bar = cell // 4
    solid = ((x % cell) < bar) | ((y % cell) < bar)
    img = np.empty((size, size, 4), np.uint8)
    img[..., 0] = 150 + 60 * (x * holes // size % 2)
    img[..., 1] = 110
    img[..., 2] = 70
    img[..., 3] = np.where(solid, 255, 0)
    return img


REPEAT, MIRROR = 10497, 33648      # glTF sampler wrap modes


def write_glb(path, items, textures=(), lights=(), skins=(), animation=()):
    """A binary glTF of `items` ((MeshData, row-vector node matrix,
    material dict[, skin binding]) each: one mesh, one node with its
    matrix; meshes that are the same object share their accessors; the
    optional binding {"skin": s, "joints": (V, 4), "weights": (V, 4)} adds
    JOINTS_0 / WEIGHTS_0 and binds the node to skin s), `textures` ((uint8
    RGBA image, (wrapS, wrapT)) each: image, sampler and texture i, the
    image embedded as a PNG), `lights` ((KHR_lights_punctual light dict,
    row-vector node matrix) each, on a node of its own after the meshes'),
    `skins` ((row-vector matrix of the skeleton's parent node, [(parent
    joint or -1, local translation)], inverse bind matrices (J, 4, 4)) each:
    a parent node after the lights', its joint nodes after it, and the
    skin) and `animation` ((skin, joint, path, times (N,), values (N, C),
    or (N, 3, C) for CUBICSPLINE, interpolation) each: one glTF animation,
    a sampler a channel).  The port's write_png encodes the images."""
    import struct
    import tempfile
    from diligentfx_tpu_torch.utils.image import write_png
    blob = bytearray()
    views, accessors, meshes, nodes, materials = [], [], [], [], []

    def view(data):
        blob.extend(b"\0" * (-len(blob) % 4))
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(data)})
        blob.extend(data)
        return len(views) - 1

    def accessor(arr, ctype, atype):
        arr = np.ascontiguousarray(arr)
        accessors.append({"bufferView": view(arr.tobytes()),
                          "componentType": ctype, "count": int(arr.shape[0]),
                          "type": atype})
        return len(accessors) - 1

    def matrix(m):
        # glTF's column-major matrix is the row-vector matrix read row-major
        return [float(v) for v in np.asarray(m, np.float32).ravel()]

    shared = {}
    for mesh, node, mat, *bind in items:
        if id(mesh) not in shared:
            shared[id(mesh)] = {
                "POSITION": accessor(mesh.positions.astype(np.float32), 5126,
                                     "VEC3"),
                "NORMAL": accessor(mesh.normals.astype(np.float32), 5126,
                                   "VEC3"),
                "TEXCOORD_0": accessor(mesh.uvs.astype(np.float32), 5126,
                                       "VEC2"),
                "TANGENT": accessor(mesh.tangents.astype(np.float32), 5126,
                                    "VEC4"),
                "indices": accessor(mesh.indices.astype(np.uint32).ravel(),
                                    5125, "SCALAR")}
        acc = dict(shared[id(mesh)])
        ind = acc.pop("indices")
        node_dict = {"matrix": matrix(node)}
        if bind:
            acc["JOINTS_0"] = accessor(bind[0]["joints"].astype(np.uint16),
                                       5123, "VEC4")
            acc["WEIGHTS_0"] = accessor(
                bind[0]["weights"].astype(np.float32), 5126, "VEC4")
            node_dict["skin"] = bind[0]["skin"]
        materials.append(mat)
        meshes.append({"primitives": [{"attributes": acc, "indices": ind,
                                       "material": len(materials) - 1}]})
        nodes.append({"mesh": len(meshes) - 1, **node_dict})
    for i, (_, node) in enumerate(lights):
        nodes.append({"matrix": matrix(node), "extensions": {
            "KHR_lights_punctual": {"light": i}}})
    roots = list(range(len(nodes)))
    skin_docs, joint_node = [], []
    for parent, joints, ibm in skins:
        roots.append(len(nodes))
        nodes.append({"matrix": matrix(parent), "children": []})
        first = len(nodes)
        joint_node.append(first)
        for j, (pj, t) in enumerate(joints):
            nodes.append({"translation": [float(v) for v in t]})
            owner = nodes[first + pj] if pj >= 0 else nodes[first - 1]
            owner.setdefault("children", []).append(first + j)
        skin_docs.append({"joints": list(range(first, first + len(joints))),
                          "skeleton": first, "inverseBindMatrices": accessor(
                              np.asarray(ibm, np.float32).reshape(-1, 16),
                              5126, "MAT4")})
    doc = {"asset": {"version": "2.0"}, "scene": 0,
           "scenes": [{"nodes": roots}], "nodes": nodes,
           "meshes": meshes, "materials": materials}
    if skin_docs:
        doc["skins"] = skin_docs
    if animation:
        samplers, channels = [], []
        for skin, joint, path_, times, values, interp in animation:
            values = np.asarray(values, np.float32)
            samplers.append({
                "input": accessor(np.asarray(times, np.float32), 5126,
                                  "SCALAR"),
                "output": accessor(values.reshape(-1, values.shape[-1]),
                                   5126, f"VEC{values.shape[-1]}"),
                "interpolation": interp})
            channels.append({"sampler": len(samplers) - 1, "target": {
                "node": joint_node[skin] + joint, "path": path_}})
        doc["animations"] = [{"samplers": samplers, "channels": channels}]
    used = sorted({k for m in materials for k in m.get("extensions", {})})
    if used:
        doc["extensionsUsed"] = used
    if lights:
        doc["extensions"] = {"KHR_lights_punctual": {
            "lights": [light for light, _ in lights]}}
    if textures:
        images = []
        with tempfile.TemporaryDirectory() as tmp:
            for i, (img, _) in enumerate(textures):
                png = os.path.join(tmp, f"texture{i}.png")
                write_png(png, img)
                with open(png, "rb") as f:
                    images.append({"bufferView": view(f.read()),
                                   "mimeType": "image/png"})
        doc["images"] = images
        doc["samplers"] = [{"wrapS": ws, "wrapT": wt}
                           for _, (ws, wt) in textures]
        doc["textures"] = [{"source": i, "sampler": i}
                           for i in range(len(textures))]
    doc.update(accessors=accessors, bufferViews=views,
               buffers=[{"byteLength": len(blob)}])
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    bin_ = bytes(blob) + b"\0" * (-len(blob) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(bin_), 0x004E4942) + bin_)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
    return path


def _gltf_material(m):
    """A glTF material dict of a PBRMaterialBasicAttribs."""
    return {"pbrMetallicRoughness": {
        "baseColorFactor": [float(v) for v in m.base_color_factor],
        "metallicFactor": float(m.metallic_factor),
        "roughnessFactor": float(m.roughness_factor)}}


def atrium_items(n_columns=12, screens=True, opaque_material=None):
    """The mask / blend atrium's items for write_glb: the full-chain
    atrium's entries (opaque; `opaque_material(i, mat)` gives entry i's
    glTF material, default _gltf_material), one double-sided lattice
    screen (MASK, cutoff 0.5, texture 0's alpha 0 or 1) beside each column
    (1.6 x 2.4 m in 8 x 12 cells), and six double-sided glass panes
    (BLEND, base-colour alpha 0.3-0.5, each tinted differently; 3 x 2 m in
    12 x 8 cells) 0.25 m apart between the camera and the front columns,
    so that the pixels behind all six see more fragments than the four
    layers.  Cells of 0.2 m and 0.25 m keep every triangle under 16 of the
    32 x 128 tiles at 1080p."""
    items = [(mesh, node, opaque_material(i, mat) if opaque_material
              else _gltf_material(mat))
             for i, (mesh, node, mat) in enumerate(
                 full_chain_entries(n_columns))]
    if screens:
        screen = grid_mesh(8, 12, 1.6, 2.4)
        lattice = {"alphaMode": "MASK", "alphaCutoff": 0.5,
                   "doubleSided": True, "pbrMetallicRoughness": {
                       "baseColorTexture": {"index": 0},
                       "metallicFactor": 0.0, "roughnessFactor": 0.7}}
        for i in range(n_columns):
            x = (i % (n_columns // 2)) * 2.5 - (n_columns // 4) * 2.5
            node = np.eye(4, dtype=np.float32)
            node[3, :3] = [x + 1.25, 1.2, -4.0 if i < n_columns // 2 else 4.0]
            items.append((screen, node, lattice))
    pane = grid_mesh(12, 8, 3.0, 2.0)
    tints = ((0.6, 0.8, 1.0), (1.0, 0.6, 0.5), (0.6, 1.0, 0.6),
             (1.0, 1.0, 0.5), (0.8, 0.5, 1.0), (0.5, 1.0, 1.0))
    for i, tint in enumerate(tints):
        node = np.eye(4, dtype=np.float32)
        node[3, :3] = [-0.5, 1.0, 7.0 - 0.25 * i]
        items.append((pane, node, {
            "alphaMode": "BLEND", "doubleSided": True,
            "pbrMetallicRoughness": {
                "baseColorFactor": list(tint) + [0.3 + 0.04 * i],
                "metallicFactor": 0.0, "roughnessFactor": 0.1}}))
    return items


def oit_atrium_glb(path, n_columns=12, screens=True):
    """The mask / blend atrium (atrium_items) as a .glb at `path`, the
    lattice texture its texture 0."""
    return write_glb(path, atrium_items(n_columns, screens),
                     [(lattice_texture(), (REPEAT, REPEAT))] if screens
                     else ())


def oit_render_scene(device, n_columns=12, screens=True):
    """load_gltf -> build_render_scene of oit_atrium_glb, written into a
    temporary directory: the RenderScene (scene, atlas, lights)."""
    import tempfile
    from diligentfx_tpu_torch.gltf.loader import load_gltf
    from diligentfx_tpu_torch.gltf.model import build_render_scene
    with tempfile.TemporaryDirectory() as tmp:
        path = oit_atrium_glb(os.path.join(tmp, "atrium.glb"), n_columns,
                              screens)
        return build_render_scene(load_gltf(path), device=device)


def oit_task_manager_ci():
    """The bench effects (SSAO half-res on the K2 route, divisor-2 SSR with
    K3, TAA, bloom) with K = 4 OIT layers."""
    import dataclasses
    return dataclasses.replace(bench_task_manager_ci(),
                               oit_layer_count=OIT_LAYERS)


# a mask / blend frame: K4 once (the G-buffer's two-pass raster), no K1;
# the bench effects' K2 and K3 launches
OIT_FRAME_LAUNCHES = {**FRAME_LAUNCHES, "raster_tiles_fused": 0,
                      "raster_tiles": 1}


def oit_gbuffer_raster_inputs(rs, cfg):
    """K4's inputs in the mask / blend frame's G-buffer pass (frame 0's
    camera without the TAA jitter): the opaque prefix of the index buffer,
    set up and binned at the padded 1088 x 1920; (setup, compact, counts,
    rects, kernel keywords, stats)."""
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.pbr.deferred import _vertex_inputs
    scene = rs.scene
    info = full_chain_info(0, W, H, DEVICE)
    pad_w, pad_h = rz.pad_viewport(W, H, cfg)
    clip, _, _, _ = _vertex_inputs(scene, info, True, include_pos=True)
    n_op = scene.num_opaque
    setup, valid, bbox, _, clip_ovf = rz._triangle_setup(
        clip, scene.indices[:n_op], pad_w, pad_h,
        scene.tri_double_sided[:n_op], True, 1e-3)
    cand, counts, max_count, ovf, big_ovf = rz._bin_triangles(
        valid, bbox, pad_w, pad_h, cfg)
    rects = rz.candidate_rects(setup, pad_w, pad_h)
    kw = dict(th=cfg.tile_h, tw=cfg.tile_w, tiles_x=pad_w // cfg.tile_w,
              chunk=cfg.chunk)
    stats = dict(valid=int(valid.sum()), max_count=int(counts.max()),
                 max_bin_count=int(max_count),
                 bin_overflow=int(ovf + clip_ovf), big_overflow=int(big_ovf))
    return setup, cand, counts, rects, kw, stats


def k4_against_plain(args, kw, label, may_be_empty=False):
    """K4 vs raster_tiles_plain on one input set `args` = (setup,
    candidates, counts, rects), bit for bit (z, id, b0, b1); timed by CUDA
    events and device time, with its candidate-pixel tests and bound
    counted as phase 8 counts them; `may_be_empty`: a band that may cover
    no pixel.  Returns its numbers."""
    import torch
    from diligentfx_tpu_torch.ops.raster_tiles import (raster_tiles,
                                                       raster_tiles_plain)
    setup, cand, counts, rects = args
    a = raster_tiles(*args, **kw)
    torch.cuda.synchronize()
    b = raster_tiles_plain(*args, **kw)
    names = ("z", "id", "b0", "b1")
    diff = {n: int((x != y).sum()) for n, x, y in zip(names, a, b)}
    hit = b[1] >= 0
    print(f"raster_tiles {label} vs plain: values differing "
          f"{diff}, covered {float(hit.float().mean()):.4f}", flush=True)
    check(all(v == 0 for v in diff.values()),
          f"K4 differs from its plain version {label}: {diff}")
    check(may_be_empty or bool(hit.any()), f"K4 covered no pixel {label}")

    def k4():
        return raster_tiles(*args, **kw)
    ms = cuda_ms(k4, 20, 2)
    dev_ms = kernel_device_ms(k4, "raster_tiles_kernel", 10)
    plain_ms = cuda_ms(lambda: raster_tiles_plain(*args, **kw), 1, 1)
    th, tw = kw["th"], kw["tw"]
    used = (torch.arange(cand.shape[1], device=DEVICE)[None, :]
            < torch.clamp(counts.long(), max=cand.shape[1])[:, None])
    unculled, tests, most = _tile_tests(cand, used, 0, th, rects,
                                        kw["tiles_x"], th, tw)
    rows = torch.unique(cand[used].long()).numel()
    winners = torch.unique(b[1][hit]).numel()
    n_bytes = (4 * (9 * rows + 7 * winners + int(used.sum()) + counts.numel())
               + 16 * b[1].numel())
    covered = int(hit.sum())
    b_ms, b_by = bound_ms(n_bytes, 15 * tests + 8 * covered)
    old_ms, old_by = bound_ms(n_bytes, 15 * unculled + 8 * covered)
    print(f"raster_tiles {label}: {ms:.4f} ms CUDA events, "
          f"device {dev_ms:.4f} ms, plain {plain_ms:.2f} ms; candidate-pixel "
          f"tests {unculled / 1e6:.2f} M on whole tiles, {tests / 1e6:.2f} M "
          f"inside the rectangles (the most in one tile {most}); "
          f"{n_bytes / 1e6:.1f} MB; bound {b_ms:.4f} ms ({b_by}; on whole "
          f"tiles {old_ms:.4f} ms, {old_by})", flush=True)
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, bound_ms_unculled=old_ms, max_abs_err=0.0,
                candidate_pixel_tests=tests,
                candidate_pixel_tests_unculled=unculled)


def phase_gbuffer_k4(rs, cfg):
    """K4 vs raster_tiles_plain at the mask / blend frame's G-buffer inputs
    (standard depth, the glTF materials' double-sided flags), bit for bit
    (z, id, b0, b1); timed by CUDA events and device time, with its
    candidate-pixel tests and bound counted as phase 8 counts them."""
    setup, cand, counts, rects, kw, stats = oit_gbuffer_raster_inputs(rs,
                                                                      cfg)
    print(f"mask/blend G-buffer raster inputs: {stats}", flush=True)
    check(stats["bin_overflow"] == 0 and stats["big_overflow"] == 0,
          f"the G-buffer raster overflows: {stats}")
    return dict(k4_against_plain((setup, cand, counts, rects), kw,
                                 "at the G-buffer inputs"),
                raster_stats=stats)


def oit_probes():
    """(wrap, seen): `wrap(fn)` runs fn with the K-layer raster, the
    alpha-mask resolve, the binning (both layouts) and the triangle setup
    observed; `seen` then holds the K-layer buffers' overflow maxima by
    call (the mask resolve's first), the resolve's passed and discarded
    fragment counts, and every binning's (bin, big) overflow counts and
    longest list and every setup's near-clip overflow, in call order."""
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.pbr import oit
    seen = {"klayer_overflow": [], "tally": {}, "bin": [], "longest": [],
            "clip": []}

    def wrap(fn):
        def run():
            saved = (oit.rasterize_klayers, oit.resolve_alpha_mask,
                     rz._bin_triangles, rz._bin_triangles_sub,
                     rz._triangle_setup)

            def klayers(*a, **k):
                out = saved[0](*a, **k)
                seen["klayer_overflow"].append(int(out.overflow.max()))
                return out

            def resolve(*a, **k):
                return saved[1](*a, tally=seen["tally"], **k)

            def binned(binning):
                def run_binning(*a, **k):
                    out = binning(*a, **k)
                    seen["bin"].append((int(out[3]), int(out[4])))
                    seen["longest"].append(int(out[2]))
                    return out
                return run_binning

            def setup(*a, **k):
                out = saved[4](*a, **k)
                seen["clip"].append(int(out[-1]))
                return out
            oit.rasterize_klayers, oit.resolve_alpha_mask = klayers, resolve
            rz._bin_triangles, rz._bin_triangles_sub = map(binned,
                                                           saved[2:4])
            rz._triangle_setup = setup
            try:
                return fn()
            finally:
                (oit.rasterize_klayers, oit.resolve_alpha_mask,
                 rz._bin_triangles, rz._bin_triangles_sub,
                 rz._triangle_setup) = saved
        return run
    return wrap, seen


def phase_oit_frame(cfg, rs, frames, out_png, ibl_source, profile=""):
    """The mask / blend frame at 1080p: HnTaskManager.execute on the glTF
    atrium (the atlas of its lattice texture), the bench effects with K = 4
    OIT layers, frame 0 of the full-chain camera; one warm-up frame
    (observed: the mask fragments passed and discarded, the OIT overflow,
    the rasters' overflow counts), then `frames` timed frames with the
    counts zeroed just before and read just after (K4 1, K2 20, K3 1, K1 0
    a frame); then the K-layer stage alone (synchronised host clock and
    CUDA events) and 3 profiled frames (the dfx.oit and dfx.alpha_mask
    ranges' launches and host and device ms)."""
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent import task_manager as ttm
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    scene = rs.scene
    n_mask = scene.mask_indices.shape[0]
    n_op = scene.num_opaque
    n_blend = scene.blend_indices.shape[0]
    print(f"mask/blend atrium: {n_op} opaque, {n_mask} masked, {n_blend} "
          f"blend triangles, {scene.num_vertices} vertices; atlas "
          f"{tuple(rs.atlas.mips[0].shape)}", flush=True)
    check(n_op == ATRIUM_TRIANGLES, f"the atrium has {n_op} opaque triangles")
    renderer = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg,
                           device=DEVICE, env_oct=ibl_source.env_oct,
                           ibl_maps=ibl_source.ibl_maps)
    tm = ttm.HnTaskManager(renderer, oit_task_manager_ci(), atlas=rs.atlas)
    wrap, seen = oit_probes()
    out, state, host_ms, dev_ms, launches = timed_frames(
        tm, scene, lambda: full_chain_info(0, W, H, DEVICE), frames,
        OIT_FRAME_LAUNCHES, "mask/blend", WARP_FRAME, warmup_wrap=wrap)
    tally = {k: int(v) for k, v in seen["tally"].items()}
    ovf = seen["klayer_overflow"]
    print(f"mask/blend warm-up: mask fragments {tally}, K-layer overflow "
          f"maxima {ovf} (mask resolve, OIT), binning (bin, big) overflow "
          f"{seen['bin']}, near-clip overflow {seen['clip']}", flush=True)
    check(tally.get("passed", 0) > 0 and tally.get("discarded", 0) > 0,
          f"mask fragments neither both passed and discarded: {tally}")
    check(len(ovf) == 2 and ovf[1] > 0,
          f"no pixel's OIT overflowed the {OIT_LAYERS} layers: {ovf}")
    check(all(b == (0, 0) for b in seen["bin"]) and len(seen["bin"]) == 3
          and not any(seen["clip"]),
          f"a raster reports bin or big overflow: {seen}")
    if out_png:
        root, ext = os.path.splitext(out_png)
        _write_png(f"{root}_mask_blend{ext or '.png'}", out.color)

    # the K-layer stage alone, on the last frame's G-buffer and camera
    info = full_chain_info(0, W, H, DEVICE)
    color = torch.zeros((H, W, 3), device=DEVICE)

    def oit_stage():
        return ttm._oit(color, out.gbuffer, info, scene, renderer, tm.ci)
    oit_stage()
    oit_host, oit_ev = [], []
    for _ in range(3):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        oit_stage()
        ev1.record()
        torch.cuda.synchronize()
        oit_host.append((time.perf_counter() - t0) * 1e3)
        oit_ev.append(ev0.elapsed_time(ev1))
    print(f"mask/blend K-layer OIT stage alone: median "
          f"{np.median(oit_host):.3f} ms host clock, "
          f"{np.median(oit_ev):.3f} ms CUDA events", flush=True)
    prof = phase_profile(tm, scene, lambda: info, 3, profile, "mask/blend",
                         ranges=("dfx.oit", "dfx.alpha_mask"))
    return dict(frame_ms_median=float(np.median(host_ms)),
                frame_events_ms_median=float(np.median(dev_ms)),
                frames=frames, launches=launches,
                oit_stage_host_ms=float(np.median(oit_host)),
                oit_stage_events_ms=float(np.median(oit_ev)),
                mask_fragments=tally, klayer_overflow_max=ovf,
                triangles=dict(opaque=n_op, mask=n_mask, blend=n_blend),
                profile=prof)


def small_oit_frames(device, screens):
    """Two 256x128 frames (moving camera) of the mask / blend atrium with 4
    columns, with the lattice screens (two-pass K4 G-buffer + OIT) or
    without (blend only: fused K1 + OIT), on the CPU path and on `device`:
    (cpu colour, colour, the device's launches)."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ci = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=32,
                               num_specular_env_samples=16)
    cfg = full_chain_raster_config()
    ref = PBRRenderer(ci, raster_cfg=cfg, device="cpu")
    colors = []
    for dev in ("cpu", device):
        ren = (ref if dev == "cpu" else
               PBRRenderer(ci, raster_cfg=cfg, device=dev,
                           env_oct=ref.env_oct, ibl_maps=ref.ibl_maps.to(dev)))
        rs = oit_render_scene(dev, n_columns=4, screens=screens)
        tm = HnTaskManager(ren, oit_task_manager_ci(), atlas=rs.atlas)
        state = tm.initial_state(SMALL_W, SMALL_H)
        zero_launches()
        for i in range(2):
            out = tm.execute(rs.scene, full_chain_info(i, SMALL_W, SMALL_H,
                                                       dev),
                             state, width=SMALL_W, height=SMALL_H,
                             settings=bench_settings())
            state = out.state
        colors.append(out.color.cpu().numpy())
    return colors[0], colors[1], read_launches()


def phase_oit_reference():
    """The 256x128 mask / blend frames on the GPU against the port's CPU
    path: with the lattice screens (two-pass K4 G-buffer, the alpha-mask
    resolve, OIT) and blend only (fused K1, OIT)."""
    from diligentfx_tpu_torch.utils.image import psnr
    for name, screens, kernel in (("mask/blend", True, "raster_tiles"),
                                  ("blend-only", False,
                                   "raster_tiles_fused")):
        cpu, gpu, launches = small_oit_frames(DEVICE, screens)
        p = psnr(cpu, gpu)
        print(f"256x128 {name} frame, GPU vs the port's CPU path: PSNR "
              f"{p:.2f} dB, max abs diff {np.abs(cpu - gpu).max():.3g}; "
              f"launches in 2 frames {launches}", flush=True)
        check(np.isfinite(gpu).all(), f"small {name} frame not finite")
        check(p > 50.0, f"GPU {name} frame disagrees with the CPU path: "
                        f"{p:.2f} dB")
        other = ({"raster_tiles", "raster_tiles_fused"} - {kernel}).pop()
        check(launches[kernel] == 2 and launches[other] == 0,
              f"the {name} G-buffer raster launched {launches}")


# ---------------------------------------------------------------------------
# the light / heap configuration: the mask / blend atrium with material
# textures at their native sizes (the texture heap) and three shadow-casting
# lights through the shadow atlas
# ---------------------------------------------------------------------------

LIGHT_SLICE = 1024             # ShadowAtlasManager's default slice size
LIGHT_KINDS = ("point", "spot", "dir")    # the loader's order, then the sun
FLOOR_TEX = 2048               # above the atlas's 1024 layer
FLOOR_DOT = (5, 9)             # a lone white texel (row, column) a 64-cell
LIGHT_HEAP_OPAQUE = ATRIUM_TRIANGLES + 128     # the atrium and the back wall
WALL_TEX = (600, 1000)         # (h, w): odd mip edges at 125 x 75 -> 63 x 38
SPOT_POS, SPOT_AT, SPOT_OUTER = [1.0, 3.5, -2.0], [1.0, 0.0, 1.0], 0.6
POINT_POS = [-1.25, 1.8, -2.2]
LIGHT_NEAR = 0.05


def floor_texture(size=FLOOR_TEX):
    """A 16 x 16 checker with fine texel-scale stripes and, in every 64 x 64
    cell, one white texel at FLOOR_DOT (odd coordinates: the atlas's
    nearest-neighbour downscale to 1024 drops every one)."""
    y, x = np.mgrid[0:size, 0:size]
    checker = ((x // (size // 16) + y // (size // 16)) % 2).astype(np.int64)
    img = np.empty((size, size, 4), np.uint8)
    img[..., 0] = 90 + 60 * checker + (x * 7) % 23
    img[..., 1] = 80 + 50 * checker + (y * 5) % 19
    img[..., 2] = 60 + 40 * checker
    img[..., 3] = 255
    dot = ((y % 64) == FLOOR_DOT[0]) & ((x % 64) == FLOOR_DOT[1])
    img[dot] = 255
    return img


def wall_texture(shape=WALL_TEX):
    """Brick courses on a (h, w) = 600 x 1000 texture."""
    h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    row = y // 50
    mortar = ((y % 50) < 4) | (((x + 60 * (row % 2)) % 120) < 4)
    img = np.empty((h, w, 4), np.uint8)
    img[..., 0] = np.where(mortar, 200, 150 + (row * 13) % 40)
    img[..., 1] = np.where(mortar, 195, 70 + (x * 3) % 17)
    img[..., 2] = np.where(mortar, 185, 50)
    img[..., 3] = 255
    return img


def normal_texture(size=512):
    """A bumpy tangent-space normal map (RGB = n * 0.5 + 0.5)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    hf = np.sin(yy * 60.0) * np.cos(xx * 60.0) * 0.5
    ny, nx = np.gradient(hf)
    n = np.stack([-nx * 6, -ny * 6, np.ones_like(nx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    img = np.full((size, size, 4), 255, np.uint8)
    img[..., :3] = np.round((n * 0.5 + 0.5) * 255).astype(np.uint8)
    return img


def textured_atrium_items(n_columns=12, screens=True, floor_tex=1,
                          wall_tex=2, normal_tex=3):
    """atrium_items with the light / heap frame's textures (texture
    indices as given): the normal map on the columns' capitals and shafts,
    the floor texture (uv 0-8 through KHR_texture_transform), and a 40 x 6
    m back wall behind the columns (the sky shows above it) with the wall
    texture (uv 0-5 by 0-1.5).  Without `screens`, no lattice screens and
    no glass panes: the opaque atrium."""
    n_entries = 2 * n_columns + 1             # columns, shafts, the floor

    def opaque(i, mat):
        m = _gltf_material(mat)
        if i < 2 * n_columns:
            m["normalTexture"] = {"index": normal_tex}
        elif i == n_entries - 1:
            m["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": floor_tex, "extensions": {"KHR_texture_transform": {
                    "scale": [8.0, 8.0]}}}
        return m

    items = atrium_items(n_columns, screens, opaque)
    if not screens:
        items = items[:len(full_chain_entries(n_columns))]
    wall = np.eye(4, dtype=np.float32)
    wall[3, :3] = [0.0, 3.0, -7.5]
    items.append((grid_mesh(16, 4, 40.0, 6.0), wall, {
        "pbrMetallicRoughness": {
            "baseColorTexture": {"index": wall_tex, "extensions": {
                "KHR_texture_transform": {"scale": [5.0, 1.5]}}},
            "metallicFactor": 0.0, "roughnessFactor": 0.8}}))
    return items


def light_heap_glb(path, n_columns=12):
    """The light / heap atrium as a .glb at `path`: textured_atrium_items
    (the lattice screens' texture 0, 256^2; the 2048^2 floor texture 1,
    REPEAT; the 1000 x 600 wall texture 2, MIRROR; the 512^2 normal map
    texture 3) and two KHR_lights_punctual lights: a spot lamp 3.5 m above
    the floor aimed at the clutter spheres in front of it (its shadows fall
    toward the camera) and a point light between the columns."""
    return write_glb(path, textured_atrium_items(n_columns),
                     [(lattice_texture(), (REPEAT, REPEAT)),
                      (floor_texture(), (REPEAT, REPEAT)),
                      (wall_texture(), (MIRROR, MIRROR)),
                      (normal_texture(), (REPEAT, REPEAT))],
                     spot_point_lights())


def light_node(position, aim):
    """A light node's row-vector matrix at `position` whose local -Z (the
    way a glTF spot or directional light shines) points along `aim`."""
    z = -np.asarray(aim, np.float32)
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = x, np.cross(z, x), z
    m[3, :3] = position
    return m


def spot_point_lights():
    """The light / heap atrium's KHR_lights_punctual lights for write_glb:
    a spot lamp 3.5 m above the floor aimed at the clutter spheres in front
    of it and a point light between the columns."""
    point = np.eye(4, dtype=np.float32)
    point[3, :3] = POINT_POS
    return [({"type": "spot", "color": [1.0, 0.9, 0.75], "intensity": 60.0,
              "range": 20.0, "spot": {"innerConeAngle": 0.4,
                                      "outerConeAngle": SPOT_OUTER}},
             light_node(SPOT_POS, np.asarray(SPOT_AT, np.float32)
                        - np.asarray(SPOT_POS, np.float32))),
            ({"type": "point", "color": [0.7, 0.8, 1.0], "intensity": 25.0,
              "range": 20.0}, point)]


def light_heap_render_scene(device, n_columns=12, binding="array"):
    """load_gltf -> build_render_scene of light_heap_glb, written into a
    temporary directory, with the sun (FULL_CHAIN_SUN) as an extra light:
    the RenderScene (scene, the heap or the atlas, lights spot, point,
    sun)."""
    import tempfile
    from diligentfx_tpu_torch.attribs import PBRLightAttribs
    from diligentfx_tpu_torch.gltf.loader import load_gltf
    from diligentfx_tpu_torch.gltf.model import build_render_scene
    with tempfile.TemporaryDirectory() as tmp:
        model = load_gltf(light_heap_glb(os.path.join(tmp, "atrium.glb"),
                                         n_columns))
    return build_render_scene(
        model, texture_binding_mode=binding, device=device,
        extra_lights=PBRLightAttribs.directional(FULL_CHAIN_SUN, [3, 3, 3],
                                                 device=device))


def light_shadow_setup(rs, slice_size=LIGHT_SLICE):
    """The shadow atlas of the three lights, in the scene's light order
    (point, spot, sun: 6 + 1 + 1 slices, the manager's initial 8), each
    light's view parameters, and the scene's world bounds for the sun's
    fitted slice: (ShadowAtlasManager, params, bounds_min, bounds_max)."""
    from diligentfx_tpu_torch.components.shadow_atlas import (
        ShadowAtlasManager, kinds_from_lights)
    from diligentfx_tpu_torch.pbr.renderer import transform_vertices
    lights = rs.lights
    kinds = kinds_from_lights(lights)
    check(kinds == LIGHT_KINDS, f"the scene's lights are {kinds}")
    atlas = ShadowAtlasManager(slice_size=slice_size)
    params = {}
    for i, kind in enumerate(kinds):
        atlas.add_light(i, kind)
        pos, d = lights.position[i], lights.direction[i]
        if kind == "spot":
            params[i] = {"position": pos, "direction": d,
                         "outer_angle": SPOT_OUTER, "near": LIGHT_NEAR}
        elif kind == "point":
            params[i] = {"position": pos, "near": LIGHT_NEAR}
        else:
            params[i] = {"direction": d}
    wp, _, _ = transform_vertices(rs.scene)
    return atlas, params, wp.amin(dim=0), wp.amax(dim=0)


def light_slice_raster_config():
    """The slices' raster: 8 x 128 tiles (1,024 a 1024^2 slice) and lists
    long enough that no slice of the light / heap frames drops a (tile,
    triangle) pair or a big triangle.  The sun's fitted slice sees the
    whole scene: the most candidates in one tile are 6,042 at 1024^2 and
    14,978 in the 256^2 slices of phase 20's 4-column atrium (32-row tiles
    would need 14,985 and 33,665); a cube face has up to 39 big triangles.
    Phase 18 prints every slice's counts."""
    from diligentfx_tpu_torch.config import RasterizerConfig
    return RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=16384,
                            max_tiles_per_tri=16, big_tri_capacity=128,
                            chunk=8)


def light_heap_info(rs, i, w, h, device):
    """Frame i of the full-chain camera lit by the scene's three lights,
    every one shadow-casting (a light's shadow factor applies where its
    shadow map index is >= 0)."""
    import torch
    lights = rs.lights._replace(shadow_map_index=torch.arange(
        rs.lights.count, dtype=torch.int32, device=device))
    return full_chain_info(i, w, h, device)._replace(lights=lights)


def light_shadow_pass(scene, setup, cfg, device):
    """The frame's per-light shadow pass, as a user runs it before execute:
    build_view_projs, render (K4 a slice, range dfx.light_shadows),
    packed_for_lights.  Returns info -> info with the slices."""
    from diligentfx_tpu_torch.pbr.renderer import transform_vertices
    atlas, params, bmin, bmax = setup

    def run(info):
        vps = atlas.build_view_projs(params, bmin, bmax, device=device)
        wp, _, _ = transform_vertices(scene, info.model_transform)
        maps = atlas.render(wp, scene.indices, vps, cfg=cfg)
        pv, pm = atlas.packed_for_lights(vps, maps)
        return info._replace(light_shadow_maps=pm, light_shadow_view_projs=pv)
    return run


def slice_labels(atlas):
    """Atlas slice -> a name: "spot", "sun" or "point +X" ... "point -Z"."""
    faces = ("+X", "-X", "+Y", "-Y", "+Z", "-Z")
    names = {}
    for kind, light in zip(atlas.light_shadow_kinds(), atlas.light_order()):
        for f, sl in enumerate(atlas.slices_of(light)):
            names[sl] = {"dir": "sun", "spot": "spot"}.get(
                kind, f"point {faces[f]}")
    return names


def light_slice_inputs(rs, setup, cfg):
    """K4's inputs of every slice of the light / heap frame's shadow pass
    (the casters: the scene's opaque and masked triangles, both faces):
    [(label, (setup, candidates, counts, rects), kernel keywords, stats)]
    in slice order."""
    import torch
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.pbr.renderer import transform_vertices
    atlas, params, bmin, bmax = setup
    scene = rs.scene
    vps = atlas.build_view_projs(params, bmin, bmax, device=DEVICE)
    wp, _, _ = transform_vertices(scene)
    s = atlas.slice_size
    both = torch.ones((scene.num_triangles,), dtype=torch.bool,
                      device=DEVICE)
    labels = slice_labels(atlas)
    out = []
    for i in range(vps.shape[0]):
        setup_i, valid, bbox, _, clip_ovf = rz._triangle_setup(
            m3.transform_points(wp, vps[i]), scene.indices, s, s, both, True,
            1e-3)
        cand, counts, max_count, ovf, big_ovf = rz._bin_triangles(
            valid, bbox, s, s, cfg)
        kw = dict(th=cfg.tile_h, tw=cfg.tile_w, tiles_x=s // cfg.tile_w,
                  chunk=cfg.chunk)
        stats = dict(valid=int(valid.sum()), candidates=int(counts.sum()),
                     max_count=int(counts.max()),
                     max_bin_count=int(max_count), bin_overflow=int(ovf),
                     big_overflow=int(big_ovf), clip_overflow=int(clip_ovf))
        out.append((labels[i], (setup_i, cand, counts,
                                rz.candidate_rects(setup_i, s, s)), kw,
                    stats))
    return out


def phase_light_k4(rs, setup):
    """K4 vs raster_tiles_plain at the per-light inputs: every slice's
    raster statistics (no bin, big or near-clip overflow in any), then bit
    for bit (z, id, b0, b1), timed and counted as phase 15, at the spot's
    slice, the point light's cube face with the most candidates and the
    sun's slice."""
    cfg = light_slice_raster_config()
    slices = light_slice_inputs(rs, setup, cfg)
    for label, _, _, st in slices:
        print(f"light slice {label} ({setup[0].slice_size}^2): {st}",
              flush=True)
    bad = [(label, st) for label, _, _, st in slices
           if st["bin_overflow"] or st["big_overflow"] or st["clip_overflow"]]
    check(not bad, f"a light slice drops candidates: {bad}")
    faces = [sl for sl in slices if sl[0].startswith("point")]
    busiest = max(faces, key=lambda sl: sl[3]["candidates"])
    cases = {}
    for label, args, kw, st in slices:
        if label in ("spot", "sun") or label == busiest[0]:
            cases[label] = dict(k4_against_plain(args, kw,
                                                 f"at the {label} slice"),
                                raster_stats=st)
    return dict(slices={label: st for label, _, _, st in slices},
                cases=cases, busiest_face=busiest[0])


# a light / heap frame: K4 for the G-buffer and once a slice (8)
LIGHT_FRAME_LAUNCHES = {**OIT_FRAME_LAUNCHES, "raster_tiles": 9}


def light_heap_probes(out, sinfo, kinds, heap):
    """The warm-up frame's probes: each light's shadow factor at the
    G-buffer's pixels (below 0.5 somewhere, 1 elsewhere), and the 2048^2
    floor texture's lone texels through sample_heap at lod 0, exact, where
    the atlas's sample of the same image falls below 0.5."""
    import torch
    from diligentfx_tpu_torch.components.shadow_map_manager import \
        light_shadow_factors
    from diligentfx_tpu_torch.ops.texture import (AtlasBuilder, sample_atlas,
                                                  sample_heap)
    gb = out.gbuffer
    fac = light_shadow_factors(gb.world_pos[gb.hit], sinfo, kinds, None)
    shares = {kind: (round(float((f < 0.5).float().mean()), 4),
                     round(float((f == 1.0).float().mean()), 4))
              for kind, f in zip(kinds, fac)}
    print(f"light/heap shadow factor at the G-buffer's pixels, share below "
          f"0.5 and share 1, by light: {shares}", flush=True)
    check(all(a > 0 and b > 0 for a, b in shares.values()),
          f"a light casts no shadow, or shadows everything: {shares}")
    tex = [i for i, wh in enumerate(heap.mip_size[:, 0].tolist())
           if wh == [FLOOR_TEX, FLOOR_TEX]]
    check(len(tex) == 1, f"the heap's native sizes {heap.mip_size[:, 0]}")
    cells = torch.arange(0, FLOOR_TEX, 64 * 7, device=DEVICE).float()
    u = (cells + FLOOR_DOT[1] + 0.5) / FLOOR_TEX
    v = (cells + FLOOR_DOT[0] + 0.5) / FLOOR_TEX
    uv = torch.stack([u, v], dim=-1)
    tid = torch.full((uv.shape[0],), tex[0], dtype=torch.int32,
                     device=DEVICE)
    zero = torch.zeros((uv.shape[0],), device=DEVICE)
    got = sample_heap(heap, tid, uv, zero)
    ab = AtlasBuilder(size=1024)
    ab.add(floor_texture())
    atlas_val = sample_atlas(ab.build(device=DEVICE), torch.zeros_like(tid),
                             uv, zero)
    # the white texel: 1 in every channel through the heap; the atlas's
    # samples show the checker around it (blue at most 100 / 255)
    atlas_min = float(atlas_val[:, :3].amin(dim=-1).max())
    print(f"floor texel probe at lod 0, {uv.shape[0]} lone white texels: "
          f"heap {got[:, :3].min().item()}-{got[:, :3].max().item()}, the "
          f"atlas's least channel {atlas_min:.4f} at most", flush=True)
    check(bool((got == 1.0).all()), "the heap does not keep the floor's "
          "lone texels")
    check(atlas_min < 0.5, "the atlas kept the lone texels (the probe shows "
          "nothing)")
    return dict(shadow_shares=shares, atlas_texel_least_channel=atlas_min)


def phase_light_heap_frame(cfg, rs, setup, frames, out_png, ibl_source,
                           profile=""):
    """The light / heap frame at 1080p: per frame the shadow pass
    (light_shadow_pass) and HnTaskManager.execute with the heap and
    light_shadow_kinds, the bench effects with K = 4 OIT layers, frame 0 of
    the full-chain camera; one warm-up frame (the probes: each light's
    shadows, the floor's lone texels, the mask fragments kept and cut out,
    the OIT overflow, every raster's overflow counts, the slices' first),
    then `frames` timed frames with the counts zeroed just before and read
    just after (K4 9, K2 20, K3 1, K1 0 a frame); 3 profiled frames (the
    dfx.light_shadows, dfx.gbuffer, dfx.alpha_mask and dfx.oit ranges);
    and one profiled frame of the scene built in atlas mode, for its
    dfx.gbuffer device time."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent import task_manager as ttm
    from diligentfx_tpu_torch.ops.texture import TextureHeap
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    scene = rs.scene
    check(isinstance(rs.atlas, TextureHeap), "the scene has no texture heap")
    atlas_mgr = setup[0]
    kinds = atlas_mgr.light_shadow_kinds()
    n_mask, n_blend = scene.mask_indices.shape[0], scene.blend_indices.shape[0]
    print(f"light/heap atrium: {scene.num_opaque} opaque, {n_mask} masked, "
          f"{n_blend} blend triangles; heap {tuple(rs.atlas.texels.shape)} "
          f"texels, native sizes {rs.atlas.mip_size[:, 0].tolist()}; lights "
          f"{kinds}, {atlas_mgr.capacity} slices of {atlas_mgr.slice_size}^2 "
          f"({atlas_mgr.capacity * atlas_mgr.slice_size ** 2 * 4 / 1e6:.1f} "
          f"MB of depth)", flush=True)
    check(scene.num_opaque == LIGHT_HEAP_OPAQUE,
          f"the atrium has {scene.num_opaque} opaque triangles")
    check(atlas_mgr.used_slices == atlas_mgr.capacity == 8,
          f"{atlas_mgr.used_slices} of {atlas_mgr.capacity} slices used")
    renderer = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg,
                           device=DEVICE, env_oct=ibl_source.env_oct,
                           ibl_maps=ibl_source.ibl_maps)
    tm = ttm.HnTaskManager(renderer, oit_task_manager_ci(), atlas=rs.atlas)
    shadow_pass = light_shadow_pass(scene, setup,
                                    light_slice_raster_config(), DEVICE)

    def frame_info():
        return shadow_pass(light_heap_info(rs, 0, W, H, DEVICE))

    kw = dict(light_shadow_kinds=kinds)
    wrap, seen = oit_probes()
    out, state, host_ms, dev_ms, launches = timed_frames(
        tm, scene, frame_info, frames, LIGHT_FRAME_LAUNCHES, "light/heap",
        WARP_FRAME, warmup_wrap=wrap, execute_kw=kw)
    tally = {k: int(v) for k, v in seen["tally"].items()}
    ovf = seen["klayer_overflow"]
    print(f"light/heap warm-up: mask fragments {tally}, K-layer overflow "
          f"maxima {ovf} (mask resolve, OIT); binning (bin, big) overflow "
          f"{seen['bin']} and near-clip overflow {seen['clip']} (the 8 "
          f"slices, the G-buffer, the two K-layer rasters)", flush=True)
    check(tally.get("passed", 0) > 0 and tally.get("discarded", 0) > 0,
          f"mask fragments neither both passed and discarded: {tally}")
    check(len(ovf) == 2 and ovf[1] > 0,
          f"no pixel's OIT overflowed the {OIT_LAYERS} layers: {ovf}")
    check(len(seen["bin"]) == 11 and all(b == (0, 0) for b in seen["bin"])
          and not any(seen["clip"]),
          f"a raster reports bin, big or near-clip overflow: {seen}")
    probes = light_heap_probes(out, frame_info(), kinds, rs.atlas)
    if out_png:
        root, ext = os.path.splitext(out_png)
        _write_png(f"{root}_light_heap{ext or '.png'}", out.color)
    prof = phase_profile(tm, scene, frame_info, 3, profile, "light/heap",
                         ranges=("dfx.light_shadows", "dfx.gbuffer",
                                 "dfx.alpha_mask", "dfx.oit"),
                         execute_kw=kw)
    # the same scene with its textures in the atlas: the G-buffer's cost of
    # the atlas gathers against the heap's two levels
    rs_atlas = light_heap_render_scene(DEVICE, binding="atlas")
    tm_atlas = ttm.HnTaskManager(renderer, oit_task_manager_ci(),
                                 atlas=rs_atlas.atlas)
    atlas_pass = light_shadow_pass(rs_atlas.scene, setup,
                                   light_slice_raster_config(), DEVICE)
    prof_atlas = phase_profile(
        tm_atlas, rs_atlas.scene,
        lambda: atlas_pass(light_heap_info(rs_atlas, 0, W, H, DEVICE)), 1,
        "", "light/atlas", ranges=(), execute_kw=kw)
    heap_gb = prof["stages"]["dfx.gbuffer"]["device_ms"]
    atlas_gb = prof_atlas["stages"]["dfx.gbuffer"]["device_ms"]
    print(f"light/heap dfx.gbuffer device ms a frame: heap {heap_gb:.3f}, "
          f"the same scene in atlas mode {atlas_gb:.3f} (information for "
          f"the atlas-gather work, not a claim)", flush=True)
    return dict(frame_ms_median=float(np.median(host_ms)),
                frame_events_ms_median=float(np.median(dev_ms)),
                frames=frames, launches=launches, mask_fragments=tally,
                klayer_overflow_max=ovf, probes=probes, profile=prof,
                gbuffer_device_ms_heap=heap_gb,
                gbuffer_device_ms_atlas=atlas_gb,
                triangles=dict(opaque=scene.num_opaque, mask=n_mask,
                               blend=n_blend))


def small_light_heap_frames(device):
    """Two 256x128 light / heap frames (moving camera) of the atrium with 4
    columns and 256^2 slices, on the CPU path and on `device`: (cpu
    colour, colour, the device's launches)."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ci = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=32,
                               num_specular_env_samples=16)
    cfg = full_chain_raster_config()
    ref = PBRRenderer(ci, raster_cfg=cfg, device="cpu")
    colors = []
    for dev in ("cpu", device):
        ren = (ref if dev == "cpu" else
               PBRRenderer(ci, raster_cfg=cfg, device=dev,
                           env_oct=ref.env_oct, ibl_maps=ref.ibl_maps.to(dev)))
        rs = light_heap_render_scene(dev, n_columns=4)
        setup = light_shadow_setup(rs, slice_size=256)
        shadow_pass = light_shadow_pass(rs.scene, setup,
                                        light_slice_raster_config(), dev)
        tm = HnTaskManager(ren, oit_task_manager_ci(), atlas=rs.atlas)
        state = tm.initial_state(SMALL_W, SMALL_H)
        zero_launches()
        for i in range(2):
            out = tm.execute(rs.scene, shadow_pass(light_heap_info(
                rs, i, SMALL_W, SMALL_H, dev)), state, width=SMALL_W,
                height=SMALL_H, settings=bench_settings(),
                light_shadow_kinds=setup[0].light_shadow_kinds())
            state = out.state
        colors.append(out.color.cpu().numpy())
    return colors[0], colors[1], read_launches()


def phase_light_heap_reference():
    """The 256x128 light / heap frames on the GPU against the port's CPU
    path (two-pass K4 G-buffer, 8 slices a frame, the heap, OIT)."""
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu, launches = small_light_heap_frames(DEVICE)
    p = psnr(cpu, gpu)
    print(f"256x128 light/heap frame, GPU vs the port's CPU path: PSNR "
          f"{p:.2f} dB, max abs diff {np.abs(cpu - gpu).max():.3g}; "
          f"launches in 2 frames {launches}", flush=True)
    check(np.isfinite(gpu).all(), "small light/heap frame not finite")
    check(p > 50.0, f"GPU light/heap frame disagrees with the CPU path: "
                    f"{p:.2f} dB")
    check(launches["raster_tiles"] == 18 and
          launches["raster_tiles_fused"] == 0,
          f"the light/heap frames launched {launches}")
    return p


def lights_only(frames, profile):
    """Phases 18 and 19 alone: K4 at the per-light inputs and the 1080p
    light / heap frame, for A/B runs."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    cfg = full_chain_raster_config()
    rs = light_heap_render_scene(DEVICE)
    setup = light_shadow_setup(rs)
    k4 = phase_light_k4(rs, setup)
    ibl = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg, device=DEVICE)
    frame = phase_light_heap_frame(cfg, rs, setup, frames, "", ibl, profile)
    return dict(k4_light_inputs=k4, light_heap_frame=frame)


# ---------------------------------------------------------------------------
# the ext_skin configuration: the glTF material extensions, skinning and
# animation in a 1080p showroom of the textured atrium
# ---------------------------------------------------------------------------

EXT_FIGURES = 6
EXT_SPINE, EXT_LIMB = 8, 6                 # joints of the spine, of a limb
EXT_JOINTS = EXT_SPINE + 4 * EXT_LIMB      # 32 a figure
EXT_TUBE = (24, 8)                         # a tube's segments around, rings
                                           # a bone: 12,288 triangles a figure
EXT_SPHERE = (48, 96)                      # stacks, slices: 9,216 triangles
EXT_FPS = 60.0
EXT_KINDS = ("clearcoat", "sheen", "anisotropy", "iridescence",
             "transmission", "all")        # the showroom spheres, in order
# the atrium, six spheres of 9,024 and six figures of 12,288 triangles
EXT_TRIANGLES = LIGHT_HEAP_OPAQUE + 6 * 9024 + EXT_FIGURES * 12288


def _tube(start, axis, length, radius, rings, segs):
    """An open tube of `rings` x (segs + 1) vertices along `axis` from
    `start`, facing out: (positions, normals, uvs, indices (T, 3), each
    vertex's distance along the axis)."""
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    u = np.cross(axis, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u)
    w = np.cross(axis, u)
    d, th = np.meshgrid(np.linspace(0.0, length, rings),
                        np.linspace(0.0, 2.0 * np.pi, segs + 1),
                        indexing="ij")
    radial = np.cos(th)[..., None] * u + np.sin(th)[..., None] * w
    pos = np.asarray(start) + d[..., None] * axis + radius * radial
    uv = np.stack([th / (2.0 * np.pi), d / length], -1)
    i0 = (np.arange(rings - 1)[:, None] * (segs + 1)
          + np.arange(segs)[None, :]).ravel()
    i1, i2 = i0 + 1, i0 + segs + 1
    idx = np.concatenate([np.stack([i0, i1, i2], -1),
                          np.stack([i1, i2 + 1, i2], -1)])
    return (pos.reshape(-1, 3), radial.reshape(-1, 3), uv.reshape(-1, 2),
            idx, d.ravel())


def figure(tube=EXT_TUBE):
    """One figure in its bind pose: a tube trunk on an 8-joint spine (hips
    at 0.9 m, 0.2 m bones) and four 6-joint limbs of 0.15 m bones (arms
    from the 7th spine joint along +-x, legs from the hips down).  Each
    vertex blends the joints of its chain whose bone centres lie within
    1.6 bones of it (up to four near a joint; a limb's first rings also
    the spine joint it hangs from), the weights normalised.  Returns
    (MeshData, joints (V, 4), weights (V, 4), [(parent, local
    translation)], inverse bind matrices (32, 4, 4))."""
    from diligentfx_tpu_torch.gltf.primitives import MeshData, compute_tangents
    segs, per_bone = tube
    joints, pos_j = [], []
    for k in range(EXT_SPINE):
        pos_j.append(np.array([0.0, 0.9 + 0.2 * k, 0.0]))
        joints.append(k - 1)
    chains = [(0, 0.2, list(range(EXT_SPINE)), None, 0.16)]
    for start, axis, attach, radius in (
            ((0.18, 2.1, 0.0), (1, 0, 0), 6, 0.06),
            ((-0.18, 2.1, 0.0), (-1, 0, 0), 6, 0.06),
            ((0.1, 0.85, 0.0), (0, -1, 0), 0, 0.07),
            ((-0.1, 0.85, 0.0), (0, -1, 0), 0, 0.07)):
        first = len(joints)
        for m in range(EXT_LIMB):
            pos_j.append(np.asarray(start) + 0.15 * m * np.asarray(axis))
            joints.append(attach if m == 0 else first + m - 1)
        chains.append((first, 0.15, list(range(first, first + EXT_LIMB)),
                       attach, radius))
    pos, nrm, uv, idx, jo, wt = [], [], [], [], [], []
    v0 = 0
    for first, seg, chain, attach, radius in chains:
        n = len(chain)
        p0 = pos_j[chain[0]]
        axis = pos_j[chain[1]] - p0
        p, nm, u, ix, d = _tube(p0, axis, seg * n, radius, n * per_bone + 1,
                                segs)
        w = np.clip(1.0 - np.abs(d[:, None] - (np.arange(n) + 0.5) * seg)
                    / (1.6 * seg), 0.0, None)
        cand = np.array(chain)[None, :].repeat(len(d), 0)
        if attach is not None:
            w = np.concatenate([w, np.clip(1.0 - d / (0.6 * seg), 0.0,
                                           None)[:, None] * 0.8], 1)
            cand = np.concatenate([cand, np.full((len(d), 1), attach)], 1)
        top = np.argsort(-w, axis=1, kind="stable")[:, :4]
        w4 = np.take_along_axis(w, top, 1)
        j4 = np.where(w4 > 0, np.take_along_axis(cand, top, 1), 0)
        pos.append(p)
        nrm.append(nm)
        uv.append(u)
        idx.append(ix + v0)
        jo.append(j4)
        wt.append(w4 / w4.sum(1, keepdims=True))
        v0 += len(p)
    pos, nrm, uv = (np.concatenate(x).astype(np.float32)
                    for x in (pos, nrm, uv))
    idx = np.concatenate(idx).astype(np.int32)
    mesh = MeshData(pos, nrm, uv, idx, compute_tangents(pos, nrm, uv, idx))
    local = [(pj, pos_j[k] - (pos_j[pj] if pj >= 0 else 0.0))
             for k, pj in enumerate(joints)]
    ibm = np.tile(np.eye(4, dtype=np.float32), (EXT_JOINTS, 1, 1))
    ibm[:, 3, :3] = -np.asarray(pos_j)
    return (mesh, np.concatenate(jo).astype(np.uint16),
            np.concatenate(wt).astype(np.float32), local, ibm)


def _quat(axis, angle):
    """Quaternions (x, y, z, w) of `angle` (N,) about a unit axis."""
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([np.sin(angle / 2)[:, None] * axis,
                           np.cos(angle / 2)[:, None]], 1)


def figure_animation(skin, phase, step_scale=False):
    """The 2 s loop of one figure, as write_glb's animation channels:
    LINEAR rotations (slerp) of the spine, CUBICSPLINE rotations of the
    limbs (tangents dq/dt), a LINEAR translation of the root and, with
    `step_scale`, a STEP scale of the top spine joint."""
    out = []
    tk = np.linspace(0.0, 2.0, 9)
    for k in range(EXT_SPINE):
        ang = 0.12 * np.sin(np.pi * tk + phase + 0.4 * k)
        out.append((skin, k, "rotation", tk, _quat((0.3, 0.0, 1.0), ang),
                    "LINEAR"))
    tc = np.linspace(0.0, 2.0, 5)
    for limb, axis in enumerate(((0, 0, 1), (0, 0, 1), (1, 0, 0),
                                 (1, 0, 0))):
        for m in range(EXT_LIMB):
            arg = np.pi * tc + phase + 0.6 * m + limb
            ang, dang = 0.35 * np.sin(arg), 0.35 * np.pi * np.cos(arg)
            q = _quat(axis, ang)
            a = np.asarray(axis, np.float64)
            dq = np.concatenate([np.cos(ang / 2)[:, None] * a,
                                 -np.sin(ang / 2)[:, None]], 1) * (
                dang / 2)[:, None]
            out.append((skin, EXT_SPINE + EXT_LIMB * limb + m, "rotation",
                        tc, np.stack([dq, q, dq], 1), "CUBICSPLINE"))
    bob = np.stack([0.15 * np.sin(np.pi * tk + phase),
                    0.9 + 0.05 * np.sin(2 * np.pi * tk + phase),
                    np.zeros_like(tk)], 1)
    out.append((skin, 0, "translation", tk, bob, "LINEAR"))
    if step_scale:
        s = np.array([1.0, 1.25, 1.0, 0.8, 1.0])[:, None].repeat(3, 1)
        out.append((skin, EXT_SPINE - 1, "scale", tc, s, "STEP"))
    return out


def showroom_materials(normal_tex):
    """The six showroom materials (EXT_KINDS): car paint (clear coat 1.0,
    roughness 0.05), velvet (sheen), brushed metal (anisotropy 0.8 at 0.5
    rad, with the normal map `normal_tex`), soap film (iridescence), amber
    glass (transmission and volume) and all five extensions with a clear
    coat."""
    def mat(rgb, metallic, rough, **ext):
        m = {"pbrMetallicRoughness": {"baseColorFactor": list(rgb) + [1.0],
                                      "metallicFactor": metallic,
                                      "roughnessFactor": rough},
             "extensions": {f"KHR_materials_{k}": v for k, v in ext.items()}}
        return m
    cc = {"clearcoatFactor": 1.0, "clearcoatRoughnessFactor": 0.05}
    sheen = {"sheenColorFactor": [0.8, 0.2, 0.4], "sheenRoughnessFactor": 0.5}
    aniso = {"anisotropyStrength": 0.8, "anisotropyRotation": 0.5}
    irid = {"iridescenceFactor": 1.0, "iridescenceIor": 1.3,
            "iridescenceThicknessMinimum": 100.0,
            "iridescenceThicknessMaximum": 600.0}
    trans = {"transmissionFactor": 1.0}
    vol = {"thicknessFactor": 0.5, "attenuationColor": [0.9, 0.5, 0.2],
           "attenuationDistance": 0.3}
    brushed = mat((0.9, 0.9, 0.92), 1.0, 0.35, anisotropy=aniso)
    brushed["normalTexture"] = {"index": normal_tex}
    every = mat((0.7, 0.6, 0.5), 0.3, 0.3, clearcoat=dict(
        cc, clearcoatFactor=0.5), sheen=sheen, anisotropy=aniso,
        iridescence=irid, transmission=trans, volume=vol)
    every["normalTexture"] = {"index": normal_tex}
    return [mat((0.6, 0.05, 0.05), 1.0, 0.4, clearcoat=cc),
            mat((0.15, 0.02, 0.08), 0.0, 0.8, sheen=sheen), brushed,
            mat((0.9, 0.9, 0.9), 0.0, 0.1, iridescence=irid),
            mat((1.0, 0.8, 0.5), 0.0, 0.05, transmission=trans, volume=vol),
            every]


def ext_skin_glb(path, n_columns=12, n_figures=EXT_FIGURES,
                 sphere=EXT_SPHERE, tube=EXT_TUBE, atrium=True,
                 normal_size=512):
    """The ext_skin scene as a .glb at `path`: the opaque textured atrium
    (textured_atrium_items without screens and panes: the 2048^2 floor
    texture 0, the 1000 x 600 wall texture 1, the normal map texture 2),
    when `atrium` (else the normal map alone, texture 0); six showroom spheres of radius 0.55 (uv_sphere of
    `sphere` stacks and slices), one material each (showroom_materials),
    1.2 m above the floor between the front columns; and `n_figures`
    skinned figures (figure) behind them, each under a parent node of its
    own (a turn about y and its place), all moved by one 2 s animation
    (figure_animation; the STEP scale on the first).  Returns (path, a
    dict of the spheres' and figures' node indices and material
    indices)."""
    from diligentfx_tpu_torch.gltf.primitives import uv_sphere
    items = (textured_atrium_items(n_columns, False, floor_tex=0,
                                   wall_tex=1, normal_tex=2)
             if atrium else [])
    xs = (np.arange(6) - 2.5) * 2.5
    ball = uv_sphere(0.55, stacks=sphere[0], slices=sphere[1])
    sphere_nodes = []
    for x, m in zip(xs, showroom_materials(2 if atrium else 0)):
        node = np.eye(4, dtype=np.float32)
        node[3, :3] = [x, 1.2, 1.5]
        sphere_nodes.append(len(items))
        items.append((ball, node, m))
    skins, anim, figure_nodes = [], [], []
    for f in range(n_figures):
        mesh, jo, wt, local, ibm = figure(tube)
        a = 0.4 * (f - 2.5)
        parent = np.eye(4, dtype=np.float32)
        parent[0, [0, 2]] = [np.cos(a), -np.sin(a)]
        parent[2, [0, 2]] = [np.sin(a), np.cos(a)]
        parent[3, :3] = [xs[f % 6], 0.0, -1.5 - 1.0 * (f // 6)]
        skins.append((parent, local, ibm))
        anim += figure_animation(f, 0.9 * f, step_scale=f == 0)
        figure_nodes.append(len(items))
        items.append((mesh, np.eye(4, dtype=np.float32), {
            "pbrMetallicRoughness": {
                "baseColorFactor": [0.75, 0.55 - 0.05 * (f % 3), 0.45, 1.0],
                "metallicFactor": 0.0, "roughnessFactor": 0.6}},
            {"skin": f, "joints": jo, "weights": wt}))
    textures = ([(floor_texture(), (REPEAT, REPEAT)),
                 (wall_texture(), (MIRROR, MIRROR))] if atrium else []) + [
        (normal_texture(normal_size), (REPEAT, REPEAT))]
    # one material an item: a node's index is its material's
    meta = dict(sphere_nodes=sphere_nodes, figure_nodes=figure_nodes,
                sphere_materials=sphere_nodes)
    return write_glb(path, items, textures, skins=skins,
                     animation=anim), meta


def ext_skin_model(device, **kw):
    """load_gltf -> build_render_scene ("array": the texture heap) of
    ext_skin_glb, written into a temporary directory, with the sun
    (FULL_CHAIN_SUN, shadow map index 0: the cascades) as the scene's
    light, and the animation's player: (model, RenderScene, player,
    the builder's node and material indices)."""
    import tempfile
    from diligentfx_tpu_torch.attribs import PBRLightAttribs
    from diligentfx_tpu_torch.gltf.animation import AnimationPlayer
    from diligentfx_tpu_torch.gltf.loader import load_gltf
    from diligentfx_tpu_torch.gltf.model import build_render_scene
    with tempfile.TemporaryDirectory() as tmp:
        path, meta = ext_skin_glb(os.path.join(tmp, "showroom.glb"), **kw)
        model = load_gltf(path)
    rs = build_render_scene(
        model, texture_binding_mode="array", device=device,
        extra_lights=PBRLightAttribs.directional(
            FULL_CHAIN_SUN, [4, 4, 4], shadow_map_index=0, device=device))
    return model, rs, AnimationPlayer(model, model.animations), meta


def ext_skin_raster_config():
    """The ext_skin frame's raster (the G-buffer's and the cascades'):
    the bench G-buffer configuration with lists long enough that no raster
    of the frames drops a candidate.  The far cascades draw the six
    figures and spheres into a few tiles: 51,878 candidates in one 32 x
    128 tile of a 2048^2 cascade (8,192 would drop 163,637); phases 21
    and 22 print every raster's longest list and overflow."""
    from diligentfx_tpu_torch.config import RasterizerConfig
    return RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=65536,
                            max_tiles_per_tri=16, big_tri_capacity=256,
                            chunk=8, pair_compaction_cap=1 << 20, sub_bins=4,
                            big_tile_capacity=64)


def ext_skin_info(i, w, h, device):
    """Frame i of the full-chain camera, the sun casting the cascades."""
    import torch
    info = full_chain_info(i, w, h, device)
    return info._replace(lights=info.lights._replace(
        shadow_map_index=torch.zeros((1,), dtype=torch.int32,
                                     device=device)))


def ext_skin_attribs(info, size=SHADOW_SIZE):
    """The four cascades of the sun for the frame's (unjittered) camera."""
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.components.shadow_map_manager import \
        distribute_cascades
    cam = info.camera
    return distribute_cascades(cam.view, m3.inverse(cam.view),
                               float(cam.proj[0, 0]), float(cam.proj[1, 1]),
                               0.1, 100.0, FULL_CHAIN_SUN,
                               num_cascades=NUM_CASCADES,
                               shadow_map_size=size)


def ext_skin_frames(tm, model, rs, player, w, h, device, size=SHADOW_SIZE):
    """(frame_info, scene): frame_info() runs frame i's update_animation at
    t = i / 60 s (previous time one frame earlier), the circling camera
    and the sun's cascades (render_shadows: K4 a cascade) and returns the
    info; scene() is the animated scene of that frame."""
    from diligentfx_tpu_torch.gltf.model import update_animation
    cur = {"rs": rs, "i": 0}

    def frame_info():
        i = cur["i"]
        cur["i"] += 1
        t = i / EXT_FPS
        cur["rs"] = update_animation(cur["rs"], model, player, t,
                                     t - 1.0 / EXT_FPS)
        info = ext_skin_info(i, w, h, device)
        return tm.render_shadows(cur["rs"].scene, info,
                                 ext_skin_attribs(info, size),
                                 shadow_map_size=size)
    return frame_info, (lambda: cur["rs"].scene)


def ext_cascade_inputs(scene, att, cfg, size=SHADOW_SIZE):
    """K4's inputs of the four cascades of the ext_skin frame's shadow pass
    (render_cascade_shadow_maps's: every triangle, both faces):
    [((setup, candidates, counts, rects), kernel keywords, stats)]."""
    import torch
    from diligentfx_tpu_torch.components import shadow_map_manager as smm
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.pbr.renderer import transform_vertices
    wp, _, _ = transform_vertices(scene)
    both = torch.ones((scene.num_triangles,), dtype=torch.bool,
                      device=wp.device)
    out = []
    for i in range(NUM_CASCADES):
        setup, valid, bbox, _, clip_ovf = rz._triangle_setup(
            smm.cascade_clip(wp, att, i), scene.indices, size, size, both,
            True, 1e-3)
        cand, counts, max_count, ovf, big_ovf = rz._bin_triangles(
            valid, bbox, size, size, cfg)
        kw = dict(th=cfg.tile_h, tw=cfg.tile_w, tiles_x=size // cfg.tile_w,
                  chunk=cfg.chunk)
        stats = dict(valid=int(valid.sum()), candidates=int(counts.sum()),
                     max_count=int(counts.max()),
                     max_bin_count=int(max_count), bin_overflow=int(ovf),
                     big_overflow=int(big_ovf), clip_overflow=int(clip_ovf))
        out.append(((setup, cand, counts, rz.candidate_rects(setup, size,
                                                             size)),
                    kw, stats))
    return out


def phase_ext_skin_kernels(cfg, model, rs, player):
    """K1 and K4 against their plain versions at the ext_skin frame's
    inputs (frame 0: the animation at t = 0 and the sun's cascades for its
    camera): K1 at the textured G-buffer inputs (phase_raster's checks),
    K4 bit for bit at each of the four cascades, with every cascade's
    raster statistics (no overflow)."""
    from diligentfx_tpu_torch.gltf.model import update_animation
    scene = update_animation(rs, model, player, 0.0, -1.0 / EXT_FPS).scene
    info = ext_skin_info(0, W, H, DEVICE)
    k1 = phase_raster(scene, info, cfg, use_textures=True, label="ext_skin")
    st = k1["raster_stats"]
    check(st["bin_overflow"] == 0 and st["big_overflow"] == 0,
          f"the ext_skin G-buffer raster overflows: {st}")
    cases = ext_cascade_inputs(scene, ext_skin_attribs(info), cfg)
    for i, (_, _, st) in enumerate(cases):
        print(f"ext_skin cascade {i} ({SHADOW_SIZE}^2): {st}", flush=True)
    bad = [st for _, _, st in cases
           if st["bin_overflow"] or st["big_overflow"] or st["clip_overflow"]]
    check(not bad, f"an ext_skin cascade drops candidates: {bad}")
    k4 = {f"cascade_{i}": dict(k4_against_plain(args, kw,
                                                f"at ext_skin cascade {i}"),
                               raster_stats=st)
          for i, (args, kw, st) in enumerate(cases)}
    return k1, k4


def _without(scene, kind, mat):
    """`scene` with the extension(s) of showroom kind `kind` taken off
    material `mat` (its factor, strength or colour set to 0)."""
    def zero(attribs, field):
        v = getattr(attribs, field).clone()
        v[mat] = 0.0
        return attribs._replace(**{field: v})
    out = scene
    if kind in ("clearcoat", "all"):
        out = out._replace(materials=zero(out.materials, "clearcoat_factor"))
    if kind in ("sheen", "all"):
        out = out._replace(materials_sheen=zero(out.materials_sheen,
                                                "color_factor"))
    if kind in ("anisotropy", "all"):
        out = out._replace(materials_anisotropy=zero(
            out.materials_anisotropy, "strength"))
    if kind in ("iridescence", "all"):
        out = out._replace(materials_iridescence=zero(
            out.materials_iridescence, "factor"))
    if kind in ("transmission", "all"):
        out = out._replace(
            materials_transmission=zero(out.materials_transmission,
                                        "factor"),
            materials_volume=zero(out.materials_volume, "thickness_factor"))
    return out


def ext_skin_probes(tm, model, rs, player, meta):
    """What the frame claims to render: a vertex of figure 0 (a limb's)
    moves between frames 0 and 5 (both projected with frame 0's camera) by
    more than 3 pixels; with the camera held still (previous view-projection = the
    current one), the motion vectors of frame 5 are nonzero on the
    figures and zero on the still atrium and spheres (a median below 0.01
    px, all but 1% of their pixels within 0.1 px); each showroom sphere's lit
    G-buffer differs from the same sphere with its extension(s) taken
    off."""
    import torch
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.gltf.model import update_animation
    from diligentfx_tpu_torch.pbr.deferred import render_gbuffer
    from diligentfx_tpu_torch.pbr.renderer import transform_vertices
    ren = tm.renderer
    slot = {n: rs.mesh_node_ids.index(n)
            for n in meta["sphere_nodes"] + meta["figure_nodes"]}
    fig0 = rs.scene.vertex_node == slot[meta["figure_nodes"][0]]
    info0 = ext_skin_info(0, W, H, DEVICE)
    px = []
    for t in (0.0, 5.0 / EXT_FPS):
        wp, _, _ = transform_vertices(update_animation(
            rs, model, player, t).scene)
        c = m3.transform_points(wp[fig0], info0.camera.view_proj)
        px.append(torch.stack([(c[:, 0] / c[:, 3] * 0.5 + 0.5) * W,
                               (0.5 - c[:, 1] / c[:, 3] * 0.5) * H], -1))
    shift = torch.linalg.vector_norm(px[1] - px[0], dim=-1)
    tip = int(shift.argmax())
    tip_px = float(shift[tip])
    print(f"ext_skin probe: figure 0's vertices move up to {tip_px:.2f} px "
          f"between frames 0 and 5 (frame 0's camera; bind position "
          f"{rs.scene.positions[fig0][tip].tolist()})", flush=True)
    check(tip_px > 3.0, f"the figure moved {tip_px:.2f} px at most")

    rs5 = update_animation(rs, model, player, 5.0 / EXT_FPS, 4.0 / EXT_FPS)
    info5 = ext_skin_info(5, W, H, DEVICE)
    info5 = info5._replace(prev_view_proj=info5.camera.view_proj)
    kw = dict(width=W, height=H, cfg=ren.raster_cfg, use_lights=True,
              atlas=tm.atlas, use_textures=True, enable_clearcoat=True)
    gb = render_gbuffer(rs5.scene, info5, ren.ibl_maps, ren.env_oct, **kw)
    mot = torch.linalg.vector_norm(gb.motion * torch.tensor(
        [W, H], dtype=torch.float32, device=DEVICE), dim=-1)
    figs = torch.zeros_like(gb.hit)
    for n in meta["figure_nodes"]:
        figs |= gb.mesh_id == slot[n]
    still = gb.hit & ~figs
    check(bool(figs.any()) and bool(still.any()),
          "no figure or no still pixel in frame 5")
    moving = float((mot[figs] > 0.1).float().mean())
    fig_max = float(mot[figs].max())
    still_max = float(mot[still].max())
    still_moving = float((mot[still] > 0.1).float().mean())
    print(f"ext_skin probe: motion vectors with the camera held, frame 5: "
          f"{int(figs.sum())} figure pixels, share above 0.1 px {moving:.4f}"
          f" (median {float(mot[figs].median()):.3f}, max {fig_max:.2f} px);"
          f" {int(still.sum())} still pixels, share above 0.1 px "
          f"{still_moving:.2e} (median {float(mot[still].median()):.2e}, "
          f"max {still_max:.3g} px)", flush=True)
    check(moving > 0.3 and fig_max > 1.0, f"the figures' motion vectors: "
          f"{moving:.4f} of their pixels above 0.1 px, at most {fig_max}")
    worst = torch.bincount(gb.mesh_id[still & (mot > 0.1)].long())
    print(f"ext_skin probe: still pixels above 0.1 px by mesh slot, the "
          f"most: {sorted(enumerate(worst.tolist()), key=lambda x: -x[1])[:4]}"
          f" of {len(rs.mesh_node_ids)} slots", flush=True)
    # still pixels: zero but for the interpolation's rounding, which a few
    # ill-conditioned pixels amplify (0.087% above 0.1 px, up to 4.85 px,
    # in the first measurement)
    check(float(mot[still].median()) < 0.01 and still_moving < 1e-2,
          f"{still_moving:.3g} of the still pixels move more than 0.1 px")

    scene0 = update_animation(rs, model, player, 0.0).scene

    def lit(scene):
        g = render_gbuffer(scene, info0, ren.ibl_maps, ren.env_oct, **kw)
        return g, g.direct + g.ambient_diffuse + g.ambient_specular
    gb0, full = lit(scene0)
    diffs = {}
    for kind, n, mat in zip(EXT_KINDS, meta["sphere_nodes"],
                            meta["sphere_materials"]):
        _, bare = lit(_without(scene0, kind, mat))
        px_ = gb0.mesh_id == slot[n]
        diffs[kind] = (int(px_.sum()),
                       float((full - bare).abs()[px_].mean()))
    print(f"ext_skin probe: each sphere's pixels and the mean |change| of "
          f"its lit layers with its extension taken off: {diffs}",
          flush=True)
    check(all(n > 500 and d > 1e-3 for n, d in diffs.values()),
          f"a showroom sphere is hidden or shows no extension: {diffs}")
    return dict(vertex_shift_px=tip_px, figure_motion_share=moving,
                figure_motion_max_px=fig_max,
                still_motion_max_px=still_max,
                still_motion_share=still_moving, sphere_changes=diffs)


def phase_ext_skin_frame(cfg, model, rs, player, meta, frames, out_png,
                         ibl_source, profile=""):
    """The ext_skin frame at 1080p: per frame update_animation, the
    circling camera, render_shadows (the sun's four 2048^2 EVSM2
    cascades, K4 4) and execute with the clear coat on
    (PBRRendererCreateInfo(enable_clear_coat=True)), the heap and the bench
    effects; one warm-up frame (every raster's overflow and longest list
    printed, none overflowing), the probes, then `frames` timed frames with
    the counts zeroed just before and read just after (K1 1, K2 20, K3 1,
    K4 4 a frame); 3 profiled frames (the dfx.gbuffer, dfx.shadows and
    dfx.skinning ranges) and update_animation's host time."""
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.gltf.model import update_animation
    from diligentfx_tpu_torch.hydrogent import task_manager as ttm
    from diligentfx_tpu_torch.ops.texture import TextureHeap
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    scene = rs.scene
    check(isinstance(rs.atlas, TextureHeap), "the scene has no texture heap")
    ext = [f for f in scene._fields if f.startswith("materials_")
           and getattr(scene, f) is not None]
    n_skinned = int((scene.weights.sum(-1) > 1e-6).sum())
    print(f"ext_skin showroom: {scene.num_triangles} triangles "
          f"({scene.num_vertices} vertices, {n_skinned} skinned), "
          f"{scene.joint_matrices.shape[0]} joints in {len(model.skins)} "
          f"skins, {len(model.animations[0].channels)} animation channels, "
          f"extensions {ext}; heap {tuple(rs.atlas.texels.shape)} texels",
          flush=True)
    check(len(ext) == 5 and scene.joint_matrices.shape[0] == 192
          and scene.num_triangles == EXT_TRIANGLES,
          "the showroom lacks an extension, joints or triangles")
    renderer = PBRRenderer(PBRRendererCreateInfo(enable_shadows=True,
                                                 enable_clear_coat=True),
                           raster_cfg=cfg, device=DEVICE,
                           env_oct=ibl_source.env_oct,
                           ibl_maps=ibl_source.ibl_maps)
    tm = ttm.HnTaskManager(renderer, csm_task_manager_ci(), atlas=rs.atlas)
    frame_info, scene_of = ext_skin_frames(tm, model, rs, player, W, H,
                                           DEVICE)
    wrap, seen = oit_probes()
    out, state, host_ms, dev_ms, launches = timed_frames(
        tm, scene_of, frame_info, frames, CSM_FRAME_LAUNCHES, "ext_skin",
        WARP_FRAME, warmup_wrap=wrap)
    print(f"ext_skin warm-up rasters (4 cascades, the G-buffer): (bin, "
          f"big) overflow {seen['bin']}, longest lists {seen['longest']}, "
          f"near-clip overflow {seen['clip']}", flush=True)
    check(len(seen["bin"]) == 5 and all(b == (0, 0) for b in seen["bin"])
          and not any(seen["clip"]),
          f"an ext_skin raster overflows: {seen}")
    if out_png:
        root, ext_ = os.path.splitext(out_png)
        _write_png(f"{root}_ext_skin{ext_ or '.png'}", out.color)
    probes = ext_skin_probes(tm, model, rs, player, meta)
    # update_animation alone, synchronised: the host numpy and the upload
    anim_ms = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update_animation(rs, model, player, i / EXT_FPS,
                         (i - 1) / EXT_FPS)
        torch.cuda.synchronize()
        anim_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"ext_skin update_animation alone: median {np.median(anim_ms):.3f}"
          f" ms host clock, device synchronised", flush=True)
    pinfo, pscene = ext_skin_frames(tm, model, rs, player, W, H, DEVICE)
    prof = phase_profile(tm, pscene, pinfo, 3, profile, "ext_skin",
                         ranges=("dfx.gbuffer", "dfx.shadows",
                                 "dfx.skinning"))
    return dict(frame_ms_median=float(np.median(host_ms)),
                frame_events_ms_median=float(np.median(dev_ms)),
                frames=frames, launches=launches, rasters=seen,
                probes=probes, profile=prof,
                update_animation_host_ms=float(np.median(anim_ms)),
                triangles=scene.num_triangles)


def small_ext_skin_frames(device):
    """Two 256x128 ext_skin frames (t = 0 and 1 / 60 s, the circling
    camera, 256^2 cascades) of the showroom without the atrium (two
    figures, spheres of 12 x 24), on the CPU path and on `device`: (cpu
    colour, colour, the device's launches)."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ci = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=32,
                               num_specular_env_samples=16,
                               enable_shadows=True, enable_clear_coat=True)
    cfg = ext_skin_raster_config()
    ref = PBRRenderer(ci, raster_cfg=cfg, device="cpu")
    colors = []
    for dev in ("cpu", device):
        ren = (ref if dev == "cpu" else
               PBRRenderer(ci, raster_cfg=cfg, device=dev,
                           env_oct=ref.env_oct, ibl_maps=ref.ibl_maps.to(dev)))
        model, rs, player, _ = ext_skin_model(
            dev, atrium=False, n_figures=2, sphere=(12, 24), tube=(8, 2),
            normal_size=64)
        tm = HnTaskManager(ren, csm_task_manager_ci(), atlas=rs.atlas)
        frame_info, scene_of = ext_skin_frames(tm, model, rs, player,
                                               SMALL_W, SMALL_H, dev,
                                               size=256)
        state = tm.initial_state(SMALL_W, SMALL_H)
        zero_launches()
        for _ in range(2):
            out = tm.execute(*frame_args(scene_of, frame_info), state,
                             width=SMALL_W, height=SMALL_H,
                             settings=bench_settings())
            state = out.state
        colors.append(out.color.cpu().numpy())
    return colors[0], colors[1], read_launches()


def phase_ext_skin_reference():
    """The 256x128 ext_skin frames on the GPU against the port's CPU path
    (the fused K1 G-buffer of the skinned, extension-material showroom, K4
    on its four 256^2 cascades a frame)."""
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu, launches = small_ext_skin_frames(DEVICE)
    p = psnr(cpu, gpu)
    print(f"256x128 ext_skin frame, GPU vs the port's CPU path: PSNR "
          f"{p:.2f} dB, max abs diff {np.abs(cpu - gpu).max():.3g}; "
          f"launches in 2 frames {launches}", flush=True)
    check(np.isfinite(gpu).all(), "small ext_skin frame not finite")
    check(p > 50.0, f"GPU ext_skin frame disagrees with the CPU path: "
                    f"{p:.2f} dB")
    check(launches["raster_tiles"] == 8 and
          launches["raster_tiles_fused"] == 2,
          f"the ext_skin frames launched {launches}")
    return p


def ext_skin_only(frames, profile):
    """Phases 21 and 22 alone: K1 and K4 at the ext_skin frame's inputs and
    the 1080p ext_skin frame, for A/B runs."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    cfg = ext_skin_raster_config()
    model, rs, player, meta = ext_skin_model(DEVICE)
    k1, k4 = phase_ext_skin_kernels(cfg, model, rs, player)
    ibl = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg, device=DEVICE)
    frame = phase_ext_skin_frame(cfg, model, rs, player, meta, frames, "",
                                 ibl, profile)
    return dict(k1_ext_skin_inputs=k1, k4_ext_skin_cascades=k4,
                ext_skin_frame=frame)


# ---------------------------------------------------------------------------
# the editor frame: the ext_skin showroom with the editor's components
# (selection, coordinate grid, bound box, vector field, depth bounds) and
# the debug views
# ---------------------------------------------------------------------------

EDITOR_SWITCHES = ("enable_selection", "enable_grid", "enable_bound_box",
                   "enable_vector_field", "enable_depth_bounds")
# each extension view (DebugViewType value) -> the showroom sphere
# (EXT_KINDS index) whose extension it shows
EXT_VIEW_SPHERE = {20: 0, 21: 0, 22: 0, 23: 0, 24: 1, 25: 1, 26: 1, 27: 2,
                   28: 2, 29: 3, 30: 3, 31: 3, 32: 4, 33: 4}
EDITOR_VIEW = "IRIDESCENCE"    # the profiled frames' view and phase 25's


def editor_task_manager_ci(**kw):
    """The ext_skin frame's configuration (csm_task_manager_ci) with the
    editor's five switches on."""
    import dataclasses
    return dataclasses.replace(csm_task_manager_ci(),
                               **{name: True for name in EDITOR_SWITCHES},
                               **kw)


def editor_frames(tm, model, rs, player, meta, w, h, device,
                  size=SHADOW_SIZE):
    """The editor frame's inputs, as ext_skin_frames gives the ext_skin
    frame's, with frame i's cascades fitted to frame i-1's depth range
    (its depth_range through adjust_cascade_range(..., 0.1, 100.0) into
    distribute_cascades; the camera's range on the first frame): the
    ComputeDepthBounds task's purpose.  Returns (frame_info, scene_of,
    settings_of, on_output, cur): settings_of() is the frame's
    FrameSettings, bench_settings with the selection (figure 0's and
    sphere 0's mesh slots, -1 padded to 4) and the bound box of figure 0's
    skinned vertices grown by 5 cm; on_output(out) keeps the frame's depth
    range; cur holds the last depth range, the far distance the last
    cascades were fitted to and their attribs."""
    import torch
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.components.shadow_map_manager import (
        adjust_cascade_range, distribute_cascades)
    from diligentfx_tpu_torch.gltf.model import update_animation
    from diligentfx_tpu_torch.hydrogent.task_manager import BoundBoxParams
    from diligentfx_tpu_torch.pbr.renderer import transform_vertices
    fig = rs.mesh_node_ids.index(meta["figure_nodes"][0])
    ball = rs.mesh_node_ids.index(meta["sphere_nodes"][0])
    ids = torch.tensor([fig, ball, -1, -1], dtype=torch.int32, device=device)
    fig_vertices = torch.nonzero(rs.scene.vertex_node == fig)[:, 0]
    cur = {"rs": rs, "i": 0, "depth_range": None, "fit_far": None,
           "attribs": None}

    def frame_info():
        i = cur["i"]
        cur["i"] += 1
        t = i / EXT_FPS
        cur["rs"] = update_animation(cur["rs"], model, player, t,
                                     t - 1.0 / EXT_FPS)
        info = ext_skin_info(i, w, h, device)
        near, far = 0.1, 100.0
        if cur["depth_range"] is not None:
            near, far = adjust_cascade_range(cur["depth_range"], 0.1, 100.0)
            cur["fit_far"] = cur["depth_range"].scene_far_z
        cam = info.camera
        cur["attribs"] = distribute_cascades(
            cam.view, m3.inverse(cam.view), cam.proj[0, 0], cam.proj[1, 1],
            near, far, FULL_CHAIN_SUN, num_cascades=NUM_CASCADES,
            shadow_map_size=size)
        return tm.render_shadows(cur["rs"].scene, info, cur["attribs"],
                                 shadow_map_size=size)

    def settings_of():
        wp = transform_vertices(cur["rs"].scene)[0][fig_vertices]
        return bench_settings()._replace(
            selected_ids=ids, bound_box=BoundBoxParams(
                box_min=wp.amin(0) - 0.05, box_max=wp.amax(0) + 0.05))

    def on_output(out):
        cur["depth_range"] = out.depth_range
    return frame_info, (lambda: cur["rs"].scene), settings_of, on_output, cur


def _saturation(color):
    return color.amax(-1) - color.amin(-1)


def editor_probes(renderer, rs, meta, inputs, selection_width):
    """What the editor frame claims, on one frame of its inputs (`inputs`
    = (info, scene, settings)) rendered with TAA and bloom off, so each
    overlay's pixels are exact: against the same frame with the overlays
    off, the selected figure's and sphere's pixels keep their colour
    (within 1e-5) and the other covered pixels lose saturation; the
    outline band (unselected pixels over 0.5 and at most
    `selection_width` px from the selection, by the port's jump flood)
    takes one colour, which no pixel farther out has; the grid, the bound
    box and the vector field each change pixels of the frame."""
    import dataclasses
    import torch
    from diligentfx_tpu_torch.components.selection import \
        closest_selected_location
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    info, scene, settings = inputs
    base = dataclasses.replace(csm_task_manager_ci(), enable_taa=False,
                               enable_bloom=False)

    def frame(**switches):
        tm = HnTaskManager(renderer, dataclasses.replace(base, **switches),
                           atlas=rs.atlas)
        return tm.execute(scene, info, tm.initial_state(W, H), width=W,
                          height=H, settings=settings)
    off = frame()
    gb = off.gbuffer
    ids = settings.selected_ids
    selected = ((gb.mesh_id[..., None] == ids) & (ids >= 0)).any(-1)
    sel = frame(enable_selection=True)
    n_sel = int(selected.sum())
    kept = float((sel.color - off.color).abs()[selected].max())
    loc = closest_selected_location(selected)
    yg, xg = torch.meshgrid(torch.arange(H, device=DEVICE),
                            torch.arange(W, device=DEVICE), indexing="ij")
    d = torch.sqrt((loc[..., 0] - xg) ** 2 + (loc[..., 1] - yg) ** 2)
    band = (d > 0.5) & (d <= selection_width) & ~selected
    rest = gb.hit & ~selected & ~band
    sat_ratio = float(_saturation(sel.color)[rest].mean()
                      / _saturation(off.color)[rest].mean())
    # the band's pixels all take the (tone-mapped) outline colour, up to
    # the rounding of c + (o - c)
    outline = sel.color[band]
    oc = outline[0]
    spread = float((outline - oc).abs().max())
    far_out = (~selected & (d > selection_width + 0.5))
    stray = int(((sel.color - oc).abs().amax(-1) <= 1e-5)[far_out].sum())
    print(f"editor probe: {n_sel} selected pixels (figure 0, sphere 0) keep "
          f"their colour within {kept:.3g}; the other covered pixels' "
          f"saturation {sat_ratio:.3f} of the frame without the selection; "
          f"outline band {int(band.sum())} pixels of colour "
          f"{oc.tolist()} (spread {spread:.3g}), {stray} pixels of it "
          f"farther than {selection_width} px", flush=True)
    check(n_sel > 500 and kept <= 1e-5,
          f"the selected pixels ({n_sel}) changed by {kept}")
    check(sat_ratio < 0.8, f"unselected saturation ratio {sat_ratio}")
    check(int(band.sum()) > 100 and spread <= 1e-5 and stray == 0,
          "the selection outline is not one band of one colour at most "
          f"{selection_width} px wide")
    changed = {}
    for name, least in (("enable_grid", 0.005 * W * H),
                        ("enable_bound_box", 200),
                        ("enable_vector_field", 1024)):
        out = frame(**{name: True})
        changed[name] = int(((out.color - off.color).abs().amax(-1)
                             > 1e-3).sum())
        check(changed[name] > least,
              f"{name} changed {changed[name]} pixels, expected > {least}")
    print(f"editor probe: pixels each overlay changes: {changed}",
          flush=True)
    return dict(selected_pixels=n_sel, selected_max_change=kept,
                unselected_saturation_ratio=sat_ratio,
                outline_pixels=int(band.sum()), overlay_pixels=changed)


def editor_api_probes(tm, renderer, rs, frame_info, scene_of, settings_of,
                      cur, state):
    """The rest of the task manager's API on the editor frame: the depth
    range (0 < near < far) and the cascades fitted to it, which end at or
    before scene_far_z * 1.01; reset_taa zeroes the TAA sample counts (and
    suspend_super_sampling); an emit_aovs=False frame's colour equals the
    emit_aovs=True frame's bit for bit and has no shading AOVs; a
    vis_only frame runs on the fused route (K1 1, K4 4: the cascades) and
    on the two-pass route (K4 5)."""
    import dataclasses
    import torch
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    dr = cur["depth_range"]
    near, far = float(dr.scene_near_z), float(dr.scene_far_z)
    end = float(cur["attribs"].cascade_cam_z_end[-1])
    fit = float(cur["fit_far"])
    print(f"editor probe: depth range {near:.4f}-{far:.4f} m, the last "
          f"cascades fitted to {fit:.4f} m end at {end:.4f} m", flush=True)
    check(0.0 < near < far, f"depth range {near}-{far}")
    check(end <= fit * 1.01 * (1 + 1e-6),
          f"the cascades end at {end} m, past {fit} * 1.01")
    counts = [float(f(state).taa.sample_count.max())
              for f in (lambda s: s, tm.reset_taa,
                        tm.suspend_super_sampling)]
    check(counts[0] >= 1.0 and counts[1] == counts[2] == 0.0,
          f"reset_taa: sample counts {counts}")
    inputs = (frame_info(), scene_of(), settings_of())
    outs = {}
    for emit in (True, False):
        t = HnTaskManager(renderer, dataclasses.replace(tm.ci,
                                                        emit_aovs=emit),
                          atlas=rs.atlas)
        outs[emit] = t.execute(inputs[1], inputs[0], state, width=W,
                               height=H, settings=inputs[2])
    same = torch.equal(outs[True].color, outs[False].color)
    dropped = [f for f in ("normal_world", "base_color", "direct",
                           "ambient_specular", "background", "debug")
               if getattr(outs[False].gbuffer, f) is not None]
    print(f"editor probe: the emit_aovs=False frame's colour bit-equal to "
          f"the emit_aovs=True frame's: {same}; AOVs it kept of those it "
          f"drops: {dropped}", flush=True)
    check(same and not dropped and outs[True].gbuffer.direct is not None,
          "emit_aovs=False changed the colour or kept a shading AOV")
    vis = {}
    for fuse in ("auto", "off"):
        t = HnTaskManager(renderer, dataclasses.replace(tm.ci,
                                                        vis_only=True),
                          atlas=rs.atlas)
        zero_launches()
        out = t.execute(scene_of(), frame_info(), t.initial_state(W, H),
                        width=W, height=H, settings=settings_of(), fuse=fuse)
        torch.cuda.synchronize()
        n = read_launches()
        vis[fuse] = (n["raster_tiles_fused"], n["raster_tiles"])
        check(bool(torch.isfinite(out.color).all()),
              "the vis_only frame is not finite")
    print(f"editor probe: vis_only frames' (K1, K4) launches, shadow pass "
          f"included: fused {vis['auto']}, two-pass {vis['off']}",
          flush=True)
    check(vis == {"auto": (1, 4), "off": (0, 5)},
          f"vis_only frames launched {vis}")
    return dict(depth_range_m=(near, far), cascades_end_m=end,
                cascades_fit_far_m=fit, emit_aovs_bit_equal=same,
                vis_only_launches=vis)


def debug_view_sweep(renderer, rs, meta, inputs):
    """Every view but NONE, one frame each on an HnTaskManager with that
    view_mode (the ext_skin configuration, the frame's inputs): finite and
    zero where nothing was hit; each extension view (20-33) differs
    between the sphere that carries its extension and the plain column
    shafts (the means of their pixels, by more than 1e-3).  Returns the
    sweep's seconds (synchronised) and the extension views' differences."""
    import dataclasses
    import torch
    from diligentfx_tpu_torch.config import DebugViewType
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    info, scene, _ = inputs
    slot = rs.mesh_node_ids.index
    shafts = torch.tensor([slot(n) for n in range(1, 24, 2)], device=DEVICE)
    views = [v for v in DebugViewType if v != DebugViewType.NONE]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = {}
    for view in views:
        tm = HnTaskManager(renderer, dataclasses.replace(
            csm_task_manager_ci(), view_mode=view), atlas=rs.atlas)
        outs[view] = tm.execute(scene, info, tm.initial_state(W, H), width=W,
                                height=H, settings=bench_settings())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    diffs = {}
    for view, out in outs.items():
        color, gb = out.color, out.gbuffer
        check(bool(torch.isfinite(color).all()), f"{view.name} not finite")
        check(bool((color[~gb.hit] == 0).all()),
              f"{view.name} is not zero where nothing was hit")
        if view in EXT_VIEW_SPHERE:
            ball = gb.mesh_id == slot(
                meta["sphere_nodes"][EXT_VIEW_SPHERE[view]])
            column = (gb.mesh_id[..., None] == shafts).any(-1)
            diffs[view.name] = float((color[ball].mean(0)
                                      - color[column].mean(0)).abs().max())
            check(int(ball.sum()) > 500 and int(column.sum()) > 500
                  and diffs[view.name] > 1e-3,
                  f"{view.name} does not show its extension: "
                  f"{diffs[view.name]}")
    print(f"editor debug-view sweep: {len(views)} views, one frame each, "
          f"{seconds:.3f} s (synchronised); extension views, |sphere - "
          f"column| of their means: {diffs}", flush=True)
    return seconds, len(views), diffs


def phase_editor_frame(cfg, model, rs, player, meta, frames, out_png,
                       ibl_source, profile=""):
    """The editor frame at 1080p: the ext_skin frame (per frame
    update_animation, the circling camera, render_shadows and execute with
    the clear coat on) with the editor's five switches on
    (editor_task_manager_ci), the selection and bound box of editor_frames
    and the cascades fitted to the previous frame's depth range; one
    warm-up frame, then `frames` timed frames with the counts zeroed just
    before and read just after (K1 1, K2 20, K3 1, K4 4 a frame, the
    ext_skin frame's); the probes (editor_probes, editor_api_probes); 3
    profiled frames with the EDITOR_VIEW debug view on (the dfx.components
    and dfx.debug_view ranges); and the sweep of every debug view."""
    import torch
    from diligentfx_tpu_torch.config import (DebugViewType,
                                             PBRRendererCreateInfo)
    from diligentfx_tpu_torch.hydrogent import task_manager as ttm
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    renderer = PBRRenderer(PBRRendererCreateInfo(enable_shadows=True,
                                                 enable_clear_coat=True),
                           raster_cfg=cfg, device=DEVICE,
                           env_oct=ibl_source.env_oct,
                           ibl_maps=ibl_source.ibl_maps)
    ci = editor_task_manager_ci()
    tm = ttm.HnTaskManager(renderer, ci, atlas=rs.atlas)
    frame_info, scene_of, settings_of, on_output, cur = editor_frames(
        tm, model, rs, player, meta, W, H, DEVICE)
    out, state, host_ms, dev_ms, launches = timed_frames(
        tm, scene_of, frame_info, frames, CSM_FRAME_LAUNCHES, "editor",
        WARP_FRAME, settings_of=settings_of, on_output=on_output)
    print(f"editor frame launches over {frames} frames: {launches} (the "
          f"ext_skin frame's K1 1, K2 20, K3 1, K4 4 a frame: the "
          f"components launch no kernel of the port)", flush=True)
    if out_png:
        root, ext_ = os.path.splitext(out_png)
        _write_png(f"{root}_editor{ext_ or '.png'}", out.color)
    api = editor_api_probes(tm, renderer, rs, frame_info, scene_of,
                            settings_of, cur, state)
    inputs = (frame_info(), scene_of(), settings_of())
    probes = editor_probes(renderer, rs, meta, inputs,
                           ci.selection_outline_width)
    view = DebugViewType[EDITOR_VIEW]
    ptm = ttm.HnTaskManager(renderer, editor_task_manager_ci(view_mode=view),
                            atlas=rs.atlas)
    pinfo, pscene, psettings, pout, _ = editor_frames(
        ptm, model, rs, player, meta, W, H, DEVICE)
    prof = phase_profile(ptm, pscene, pinfo, 3, profile, "editor",
                         ranges=("dfx.components", "dfx.debug_view"),
                         settings_of=psettings)
    sweep_s, n_views, sweep = debug_view_sweep(renderer, rs, meta, inputs)
    return dict(frame_ms_median=float(np.median(host_ms)),
                frame_events_ms_median=float(np.median(dev_ms)),
                frames=frames, launches=launches, probes=probes,
                api_probes=api, profile=prof, profiled_view=EDITOR_VIEW,
                sweep_seconds=sweep_s, sweep_views=n_views,
                sweep_extension_differences=sweep)


def small_editor_frames(device):
    """Two 256x128 editor frames (t = 0 and 1 / 60 s, the circling camera,
    256^2 cascades fitted to the depth range) of the showroom without the
    atrium (two figures, spheres of 12 x 24), the overlays on, the
    EDITOR_VIEW debug view, the first frame on the fused K1 route and the
    second on the two-pass K4 route, on the CPU path and on `device`:
    (cpu colour, colour, the device's launches)."""
    from diligentfx_tpu_torch.config import (DebugViewType,
                                             PBRRendererCreateInfo)
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ci = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=32,
                               num_specular_env_samples=16,
                               enable_shadows=True, enable_clear_coat=True)
    cfg = ext_skin_raster_config()
    ref = PBRRenderer(ci, raster_cfg=cfg, device="cpu")
    colors = []
    for dev in ("cpu", device):
        ren = (ref if dev == "cpu" else
               PBRRenderer(ci, raster_cfg=cfg, device=dev,
                           env_oct=ref.env_oct, ibl_maps=ref.ibl_maps.to(dev)))
        model, rs, player, meta = ext_skin_model(
            dev, atrium=False, n_figures=2, sphere=(12, 24), tube=(8, 2),
            normal_size=64)
        tm = HnTaskManager(ren, editor_task_manager_ci(
            view_mode=DebugViewType[EDITOR_VIEW]), atlas=rs.atlas)
        frame_info, scene_of, settings_of, on_output, _ = editor_frames(
            tm, model, rs, player, meta, SMALL_W, SMALL_H, dev, size=256)
        state = tm.initial_state(SMALL_W, SMALL_H)
        zero_launches()
        for fuse in ("auto", "off"):
            out = tm.execute(*frame_args(scene_of, frame_info), state,
                             width=SMALL_W, height=SMALL_H,
                             settings=settings_of(), fuse=fuse)
            on_output(out)
            state = out.state
        colors.append(out.color.cpu().numpy())
    return colors[0], colors[1], read_launches()


def phase_editor_reference():
    """The 256x128 editor frames on the GPU against the port's CPU path:
    both debug-payload routes (K1's fused G-buffer, then K4's two-pass
    one), the overlays and the view."""
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu, launches = small_editor_frames(DEVICE)
    p = psnr(cpu, gpu)
    print(f"256x128 editor frame ({EDITOR_VIEW} view), GPU vs the port's "
          f"CPU path: PSNR {p:.2f} dB, max abs diff "
          f"{np.abs(cpu - gpu).max():.3g}; launches in 2 frames {launches}",
          flush=True)
    check(np.isfinite(gpu).all(), "small editor frame not finite")
    check(p > 50.0, f"GPU editor frame disagrees with the CPU path: "
                    f"{p:.2f} dB")
    check(launches["raster_tiles"] == 9 and
          launches["raster_tiles_fused"] == 1,
          f"the editor frames launched {launches}")
    return p


def editor_only(frames, profile):
    """Phases 24 and 25 alone: the 1080p editor frame and its 256x128
    frames against the CPU path, for A/B runs."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    cfg = ext_skin_raster_config()
    model, rs, player, meta = ext_skin_model(DEVICE)
    ibl = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg, device=DEVICE)
    frame = phase_editor_frame(cfg, model, rs, player, meta, frames, "", ibl,
                               profile)
    return dict(editor_frame=frame, editor_psnr=phase_editor_reference())


# ---------------------------------------------------------------------------
# the Hydra stage (phases 26-27): the Hydrogent front end of the port
# ---------------------------------------------------------------------------

HYDRA_TEX = 512                       # the textured materials' textures
HYDRA_PROPS_AT = (0.0, 1.8, 5.5)      # the prop wall, before the atrium
HYDRA_PROP_DENSITY = 4                # the corpus's grids, x4 on each axis


def _prop(k):
    return f"/Kitchen/Geom/prop{k:03d}"


# six props of the wall's front row, picked at their centroids; three moved
# by a transform-only edit; one edited point by point; one destroyed
HYDRA_PICKS = tuple(_prop(k) for k in (0, 3, 9, 12, 18, 21))
HYDRA_MOVED = tuple(_prop(k) for k in (1, 10, 20))
HYDRA_EDITED, HYDRA_DESTROYED = _prop(2), _prop(15)
HYDRA_CAM = "/Atrium/cam"
HYDRA_LIGHTS = ("/Atrium/sun", "/Atrium/bulb")
HYDRA_BUDGET = 64 << 10               # the geometry budget probe's bytes
HYDRA_ASYNC_LIMIT_S = 300.0           # FALLBACK -> OK within this time
# an EDGES frame launches K4 once (its two-pass raster), a POINTS frame none
EDGES_LAUNCHES = {**{k: 0 for k in FRAME_LAUNCHES}, "raster_tiles": 1}
POINTS_LAUNCHES = {k: 0 for k in FRAME_LAUNCHES}
MODE_FRAMES = 3                # EDGES and POINTS frames timed after a warm-up


def hydra_raster_config(small=False):
    """The bench raster config's 32 x 128 tiles, 4 sub-bins and setup, with
    the lists the Hydra stage needs: at 1920x1080 its longest sub-bin list
    holds 510 candidates, where the bench config keeps 256 a sub-bin and
    drops 4,145 (tile, triangle) pairs and 106 big triangles; at 256x128
    (`small`) the longest holds 8,805."""
    import dataclasses
    return dataclasses.replace(
        bench_raster_config(), bin_capacity=(1 << 16) if small else 2048,
        big_tri_capacity=256, big_tile_capacity=64)


def _pxr_shim():
    from tests import torch_pxr_shim
    return torch_pxr_shim


def hydra_stage(n_columns=12, tex_size=HYDRA_TEX):
    """The Hydra stage, authored into the fake pxr's scene delegate
    (tests/torch_pxr_shim.py): the full-chain atrium's meshes
    (full_chain_entries: the floor and the shafts as quads, the capitals
    and the 40 clutter spheres as triangles, with their normals and uvs,
    each at its node matrix) and the 24 Kitchen-shaped props of
    tests/test_usd_kitchen_corpus.py at HYDRA_PROP_DENSITY x their grid
    density (quads, triangles, pentagons, two geom subsets on every fourth)
    as a wall before the atrium; 12 UsdPreviewSurface networks (8 textured
    with seeded tex_size² textures, two of those with normal maps and two
    through UsdTransform2d; the capitals', shafts', floor's and first clutter
    sphere's colour, roughness and metallic on the other four); a distant
    light along the full-chain sun, a sphere light, and a camera at
    full_chain_info(0)'s eye and target.  Returns (scene delegate, mesh
    ids, material ids, light ids, camera id)."""
    shim = _pxr_shim()
    sd = shim.FakeSceneDelegate()
    entries = full_chain_entries(n_columns)

    def look(k):
        m = entries[k][2]
        return (tuple(float(x) for x in m.base_color_factor[:3]),
                float(m.roughness_factor), float(m.metallic_factor))
    n = n_columns
    mats = shim.kitchen_materials(sd, tex_size=tex_size, colors=[
        look(0), look(1), look(2 * n), look(2 * n + 1)])
    meshes = []

    def post(pid, mesh, node, counts, faces, mat):
        sd.data[pid] = {
            "topology": shim.FakeMeshTopology(counts, faces),
            "points": np.asarray(mesh.positions, np.float32),
            "normals": np.asarray(mesh.normals, np.float32),
            "st": np.asarray(mesh.uvs, np.float32),
            "transform": np.asarray(node, np.float32), "materialId": mat}
        meshes.append(pid)

    def triangles(mesh):
        t = mesh.indices.shape[0]
        return [3] * t, mesh.indices.reshape(-1).tolist()

    def quads(mesh):
        """A mesh whose triangles pair up as (a, b, c), (a, c, d) or, for
        the plane, (a, b, d), (d, b, c): its quads, in face order."""
        tris = mesh.indices.reshape(-1, 2, 3)
        same = tris[:, 0, 0] == tris[:, 1, 0]
        q = np.where(same[:, None],
                     np.stack([tris[:, 0, 0], tris[:, 0, 1], tris[:, 0, 2],
                               tris[:, 1, 2]], -1),
                     np.stack([tris[:, 0, 0], tris[:, 0, 1], tris[:, 1, 2],
                               tris[:, 0, 2]], -1))
        return [4] * q.shape[0], q.reshape(-1).tolist()
    for i in range(n):
        mesh, node, _ = entries[2 * i]
        post(f"/Atrium/Geom/capital{i:02d}", mesh, node, *triangles(mesh),
             mats[8])
        mesh, node, _ = entries[2 * i + 1]
        post(f"/Atrium/Geom/shaft{i:02d}", mesh, node, *quads(mesh), mats[9])
    mesh, node, _ = entries[2 * n]
    post("/Atrium/Geom/floor", mesh, node, *quads(mesh), mats[10])
    for i, (mesh, node, _) in enumerate(entries[2 * n + 1:]):
        post(f"/Atrium/Geom/clutter{i:02d}", mesh, node, *triangles(mesh),
             mats[11] if i % 5 == 0 else mats[i % 8])
    meshes += shim.kitchen_props(sd, mats, 24, density=HYDRA_PROP_DENSITY,
                                 origin=HYDRA_PROPS_AT, spacing=(1.0, 0.85))
    eye, target = [0.0, 2.0, 10.0], [0.0, 1.0, 0.0]    # full_chain_info(0)
    sd.data[HYDRA_CAM] = {"transform": shim.look_transform(eye, target),
                          "fov": float(np.degrees(0.8)),
                          "clippingRange": (0.1, 100.0)}
    sun = np.asarray(FULL_CHAIN_SUN, np.float64)
    sd.data[HYDRA_LIGHTS[0]] = {
        "transform": shim.look_transform(-10.0 * sun / np.linalg.norm(sun),
                                         [0.0, 0.0, 0.0]),
        "color": (1.0, 1.0, 1.0), "intensity": 4.0}
    bulb = np.eye(4, dtype=np.float32)
    bulb[3, :3] = (1.0, 3.0, 7.0)
    sd.data[HYDRA_LIGHTS[1]] = {"transform": bulb, "color": (1.0, 0.8, 0.6),
                                "intensity": 8.0, "range": 30.0}
    return sd, meshes, mats, list(HYDRA_LIGHTS), HYDRA_CAM


def hydra_delegate(stage, renderer, device, w, h, ci=None):
    """The stage through the port's pxr adapter: a DfxHdRenderDelegate on
    `device` with `renderer` and the bench task manager, every prim created,
    Synced with every bit dirty and committed (shim.populate).  Returns
    (render delegate, prims, render task, seconds of populate -> Sync ->
    CommitResources, device synchronised)."""
    import torch
    from diligentfx_tpu_torch.hydrogent.render_delegate import \
        HnRenderDelegateCreateInfo
    from diligentfx_tpu_torch.hydrogent.usd_adapter import build_adapter
    shim = _pxr_shim()
    sd, meshes, mats, lights, cam = stage
    classes = build_adapter(shim.make_fake_pxr())
    t0 = time.perf_counter()
    rd = classes["RenderDelegate"](ci or HnRenderDelegateCreateInfo(),
                                   renderer=renderer,
                                   task_manager_ci=bench_task_manager_ci(),
                                   device=device)
    prims = shim.populate(rd, sd, meshes, mats, lights, cam)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    task = classes["RenderTask"](rd.inner, width=w, height=h, camera_id=cam)
    return rd, prims, task, seconds


def _frame_ok(out, label, w=None, h=None):
    """A frame's colour: (h, w, 3) (W x H by default), finite, within
    [0, 1]."""
    _color_ok(out.color, label, w, h)


def _color_ok(c, label, w=None, h=None):
    """_frame_ok of a colour tensor."""
    import torch
    w, h = w or W, h or H
    check(tuple(c.shape) == (h, w, 3), f"{label}: colour shape {c.shape}")
    check(bool(torch.isfinite(c).all()), f"{label}: colour not finite")
    check(float(c.min()) >= 0.0 and float(c.max()) <= 1.0,
          f"{label}: colour outside [0, 1]")


def _world_triangles(d):
    """Every visible mesh prim's triangles in world space (float64, host):
    (T, 3, 3) and each triangle's prim id."""
    tris, owners = [], []
    for pid, m in d.meshes.items():
        if not m.visible or m.points is None:
            continue
        p = np.asarray(m.points, np.float64)
        xf = np.asarray(m.transform, np.float64)
        world = p @ xf[:3, :3] + xf[3, :3]
        tris.append(world[m.indices])
        owners += [pid] * m.indices.shape[0]
    return np.concatenate(tris), np.asarray(owners)


def _ray_cast(tris, owners, origin, direction):
    """The nearest prim a ray meets (Moller-Trumbore over every triangle,
    both faces), or None."""
    e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    p = np.cross(direction, e2)
    det = np.einsum("ij,ij->i", e1, p)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    s = origin - tris[:, 0]
    u = np.einsum("ij,ij->i", s, p) * inv
    q = np.cross(s, e1)
    v = (q @ direction) * inv
    t = np.einsum("ij,ij->i", e2, q) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
    if not hit.any():
        return None
    return owners[np.where(hit, t, np.inf).argmin()]


def hydra_centroid_pixel(d, pid):
    """The pixel at prim `pid`'s centroid (its world-space vertices' mean,
    projected by the stage camera) in a W x H frame."""
    w, h = W, H
    vp = d.frame_info(w, h).camera.view_proj.cpu().double().numpy()
    m = d.meshes[pid]
    xf = np.asarray(m.transform, np.float64)
    c = np.asarray(m.points, np.float64).mean(0) @ xf[:3, :3] + xf[3, :3]
    clip = np.append(c, 1.0) @ vp
    return (int((clip[0] / clip[3] * 0.5 + 0.5) * w),
            int((0.5 - clip[1] / clip[3] * 0.5) * h))


def hydra_pick(d, x, y):
    """At pixel (x, y) of a W x H frame: the prim a host ray cast through
    the pixel's centre finds nearest, its slot (-1: none) and
    read_rprim_id's."""
    import torch
    w, h = W, H
    info = d.frame_info(w, h)
    inv = torch.linalg.inv(info.camera.view_proj.cpu().double()).numpy()
    far = np.array([(x + 0.5) / w * 2 - 1, 1 - (y + 0.5) / h * 2, 0.5,
                    1.0]) @ inv
    eye = np.asarray(d.cameras[HYDRA_CAM].eye, np.float64)
    ray = far[:3] / far[3] - eye
    owner = _ray_cast(*_world_triangles(d), eye, ray / np.linalg.norm(ray))
    want = -1 if owner is None else d._mesh_slots[owner]
    return owner, want, d.read_rprim_id(x, y)


def _timed(fn, frames):
    """`frames` calls of fn(), each timed on the host clock ending in a
    synchronise and by CUDA events: (last output, host ms, events ms)."""
    import torch
    host, dev = [], []
    out = None
    for _ in range(frames):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(ev0.elapsed_time(ev1))
    return out, host, dev


def _motion_px(gb):
    """Each pixel's motion in pixels (of a W x H frame), less the frame's
    uniform TAA jitter step (the median motion of `gb`'s hit pixels, which
    every still pixel carries)."""
    import torch
    w, h = W, H
    scale = torch.tensor([w, h], dtype=torch.float32, device=gb.motion.device)
    mot = gb.motion * scale
    step = mot[gb.hit].median(dim=0).values
    return torch.linalg.vector_norm(mot - step, dim=-1), step


def hydra_probes(rd, prims, task, stage):
    """Phase 26's probes, in order, each a failure when it fails: picking
    (six props' centroids, against a host ray cast); an EDGES frame (K4 1
    and nothing else) and a POINTS frame (no kernel); a transform-only edit
    of three props (no geometry byte uploaded, the same device streams;
    motion on the moved props' pixels and none on still pixels, none
    anywhere after the fold); a points edit of one prop (exactly its new
    entry's bytes uploaded); a material edit (the shafts' base colour, and
    nothing else, changes); a destroy_prim (its slot gone, the ray cast's
    next prim picked at its centroid)."""
    import torch
    from diligentfx_tpu_torch.hydrogent.render_delegate import HnGeometryMode
    from diligentfx_tpu_torch.hydrogent.geometry_pool import (TRIANGLE_BYTES,
                                                              VERTEX_BYTES)
    shim = _pxr_shim()
    sd, meshes, mats, _, _ = stage
    d = rd.inner
    pool = d.geometry_pool
    res = {}
    picks = {}
    for pid in HYDRA_PICKS:
        x, y = hydra_centroid_pixel(d, pid)
        picks[pid] = (x, y, *hydra_pick(d, x, y)[1:])
    print(f"hydra probe: picking at the props' centroids (x, y, ray cast's "
          f"slot, read slot): {picks}", flush=True)
    for pid, (x, y, want, got) in picks.items():
        check(want == d._mesh_slots[pid], f"{pid}'s centroid pixel ({x}, "
              f"{y}) shows another prim (the stage's layout)")
        check(got == want, f"read_rprim_id({x}, {y}) = {got}, {pid} is slot "
              f"{want}")
    res["picks"] = picks

    fg = torch.tensor([0.85, 0.9, 1.0], device=DEVICE)
    for mode, want, label in ((HnGeometryMode.EDGES, EDGES_LAUNCHES, "edges"),
                              (HnGeometryMode.POINTS, POINTS_LAUNCHES,
                               "points")):
        d.render_param.geometry_mode = mode
        task.Execute()                       # warm-up
        zero_launches()
        out, host, dev = _timed(task.Execute, MODE_FRAMES)
        got = read_launches()
        _frame_ok(out, f"{label} frame")
        share = float(((out.color - fg).abs().amax(-1) < 1e-6).float()
                      .mean())
        print(f"hydra probe: {label.upper()} frame {np.median(host):.3f} ms "
              f"host, {np.median(dev):.3f} ms CUDA events; launches over "
              f"{MODE_FRAMES} frames {got}; {share:.4f} of the pixels in the "
              "line colour", flush=True)
        check(all(got[k] == MODE_FRAMES * want[k] for k in want),
              f"{MODE_FRAMES} {label} frames launched {got}, expected "
              f"{MODE_FRAMES} x {want}")
        check(share > 1e-3, f"{label} frame draws nothing")
        res[f"{label}_launches"] = got
        res[f"{label}_frame_ms"] = float(np.median(host))
        res[f"{label}_share"] = share
    d.render_param.geometry_mode = HnGeometryMode.SOLID
    task.Execute()

    total0, scene0 = pool.total_upload_bytes, d._scene
    for pid in HYDRA_MOVED:
        xf = np.array(sd.data[pid]["transform"])
        xf[3, 0] += 0.12
        sd.data[pid]["transform"] = xf
        prims[meshes.index(pid)].Sync(sd, None,
                                      shim._ChangeTracker.DirtyTransform)
    out = task.Execute()
    _frame_ok(out, "transform-edit frame")
    check(pool.total_upload_bytes == total0, "a transform-only edit uploaded "
          f"{pool.total_upload_bytes - total0} geometry bytes")
    check(d._scene.positions is scene0.positions and
          d._scene.indices is scene0.indices,
          "a transform-only edit rebuilt the device streams")
    mot, step = _motion_px(out.gbuffer)
    moved = torch.zeros_like(out.gbuffer.hit)
    for pid in HYDRA_MOVED:
        moved |= out.gbuffer.mesh_id == d._mesh_slots[pid]
    still = out.gbuffer.hit & ~moved
    moving = float((mot[moved] > 0.1).float().mean())
    still_share = float((mot[still] > 0.1).float().mean())
    g2 = task.Execute().gbuffer
    after = _motion_px(g2)[0][g2.hit]
    after_share = float((after > 0.1).float().mean())
    print(f"hydra probe: transform-only edit of {len(HYDRA_MOVED)} props: "
          f"0 geometry bytes uploaded; motion less the jitter step "
          f"{step.tolist()} px: {int(moved.sum())} moved pixels, share above "
          f"0.1 px {moving:.4f} (median {float(mot[moved].median()):.2f} px);"
          f" {int(still.sum())} still pixels, share above 0.1 px "
          f"{still_share:.2e} (median {float(mot[still].median()):.2e}); the "
          f"next frame (folded) share above 0.1 px {after_share:.2e}",
          flush=True)
    check(moving > 0.9 and float(mot[moved].median()) > 1.0,
          f"the moved props carry no motion ({moving:.4f})")
    check(float(mot[still].median()) < 0.01 and still_share < 1e-2,
          f"{still_share:.3g} of the still pixels carry motion")
    check(float(after.median()) < 0.01 and after_share < 1e-2,
          f"{after_share:.3g} of the pixels carry motion after the fold")
    res.update(moved_motion_share=moving, still_motion_share=still_share,
               folded_motion_share=after_share)

    pid = HYDRA_EDITED
    pts = np.array(sd.data[pid]["points"])
    pts[:, 2] += 0.05 * np.sin(7.0 * pts[:, 0])
    sd.data[pid]["points"] = pts
    prims[meshes.index(pid)].Sync(sd, None, shim._ChangeTracker.DirtyPoints)
    total0 = pool.total_upload_bytes
    _frame_ok(task.Execute(), "points-edit frame")
    _, v_len, _, t_len = pool.range_of(d._mesh_geo[pid])
    want = v_len * VERTEX_BYTES + t_len * TRIANGLE_BYTES
    sent = pool.total_upload_bytes - total0
    print(f"hydra probe: points edit of {pid}: {sent} bytes uploaded, its "
          f"entry's v_len {v_len} x 48 + t_len {t_len} x 12 = {want}",
          flush=True)
    check(sent == want, f"a points edit uploaded {sent} bytes, not {want}")
    res["points_edit_bytes"] = sent

    def mean_base(gb, group):
        on = torch.zeros_like(gb.hit)
        for i in range(12):
            on |= gb.mesh_id == d._mesh_slots[f"/Atrium/Geom/{group}{i:02d}"]
        return gb.base_color[on].mean(0), int(on.sum())
    gb0 = d.last_output.gbuffer
    shafts0, caps0 = mean_base(gb0, "shaft")[0], mean_base(gb0, "capital")[0]
    sd.data[mats[9]] = {"material": shim.preview_surface_network(
        mats[9], diffuse=(0.9, 0.1, 0.1), rough=0.6, metallic=0.0)}
    prims[len(meshes) + 9].Sync(sd, None, shim._ChangeTracker.AllDirty)
    gb = task.Execute().gbuffer
    (shafts, n_px), caps = mean_base(gb, "shaft"), mean_base(gb, "capital")[0]
    want = torch.tensor([0.9, 0.1, 0.1], device=DEVICE)
    print(f"hydra probe: material edit of the shafts' network: their "
          f"{n_px} pixels' mean base colour {shafts0.tolist()} -> "
          f"{shafts.tolist()}; the capitals' {caps0.tolist()} -> "
          f"{caps.tolist()}", flush=True)
    check(float((shafts - want).abs().max()) < 1e-4,
          f"the shafts' base colour {shafts.tolist()} after the edit")
    check(float((caps - caps0).abs().max()) < 1e-5,
          "the material edit changed the capitals")
    res["material_edit_base_color"] = shafts.tolist()

    pid = HYDRA_DESTROYED
    nodes0, inst0 = d._scene.node_matrices.shape[0], pool.stats()[
        "instances"]
    x, y = hydra_centroid_pixel(d, pid)
    rd.DestroyRprim(prims[meshes.index(pid)])
    _frame_ok(task.Execute(), "destroy frame")
    owner, want, got = hydra_pick(d, x, y)
    print(f"hydra probe: destroy_prim {pid}: {d._scene.node_matrices.shape[0]}"
          f" nodes (were {nodes0}), {pool.stats()['instances']} pool "
          f"instances (were {inst0}); at its centroid ({x}, {y}) the ray "
          f"cast finds {owner} (slot {want}), read_rprim_id {got}",
          flush=True)
    check(pid not in d._mesh_slots and
          d._scene.node_matrices.shape[0] == nodes0 - 1 and
          pool.stats()["instances"] == inst0 - 1, "destroy_prim left the prim")
    check(got == want, f"after destroy_prim, read_rprim_id({x}, {y}) = {got}"
          f", the ray cast's prim is slot {want}")
    res["destroyed_pick"] = (x, y, want, got)
    return res


def hydra_k4(d, cfg):
    """K4 vs raster_tiles_plain at the Hydra stage's EDGES frame inputs
    (rz.rasterize's: the whole index buffer, standard depth, the stage
    camera without jitter, set up and binned at the padded 1088 x 1920),
    bit for bit, timed and counted as phase 15 does."""
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.pbr.renderer import transform_vertices
    scene = d._scene
    pad_w, pad_h = rz.pad_viewport(W, H, cfg)
    wp, _, _ = transform_vertices(scene)
    clip = m3.transform_points(wp, d.frame_info(W, H).camera.view_proj)
    setup, valid, bbox, _, clip_ovf = rz._triangle_setup(
        clip, scene.indices, pad_w, pad_h, scene.tri_double_sided, True,
        1e-3)
    cand, counts, max_count, ovf, big_ovf = rz._bin_triangles(
        valid, bbox, pad_w, pad_h, cfg)
    rects = rz.candidate_rects(setup, pad_w, pad_h)
    kw = dict(th=cfg.tile_h, tw=cfg.tile_w, tiles_x=pad_w // cfg.tile_w,
              chunk=cfg.chunk)
    stats = dict(valid=int(valid.sum()), max_count=int(counts.max()),
                 max_bin_count=int(max_count),
                 bin_overflow=int(ovf + clip_ovf), big_overflow=int(big_ovf))
    print(f"hydra EDGES raster inputs: {stats}", flush=True)
    check(stats["bin_overflow"] == 0 and stats["big_overflow"] == 0,
          f"the EDGES raster overflows: {stats}")
    return dict(k4_against_plain((setup, cand, counts, rects), kw,
                                 "at the hydra EDGES inputs"),
                raster_stats=stats)


def hydra_budget_probe(stage, renderer):
    """A second delegate on the stage with a geometry budget of
    HYDRA_BUDGET bytes a commit: the first frame leaves entries PENDING and
    renders what is resident; each later frame brings more in until none is
    pending; every frame finite and within [0, 1]."""
    from diligentfx_tpu_torch.hydrogent.render_delegate import \
        HnRenderDelegateCreateInfo
    rd, _, task, _ = hydra_delegate(
        stage, renderer, DEVICE, W, H,
        HnRenderDelegateCreateInfo(geometry_load_budget_bytes=HYDRA_BUDGET))
    d = rd.inner
    seen = []
    for i in range(40):
        _frame_ok(task.Execute(), f"budget frame {i}")
        seen.append((d._scene.node_matrices.shape[0],
                     d.geometry_pool.num_pending))
        if not d.geometry_pool.num_pending:
            break
    print(f"hydra probe: geometry budget {HYDRA_BUDGET} bytes a commit: "
          f"(nodes rendered, entries pending) a frame {seen}", flush=True)
    check(seen[0][1] > 0, "the budget left no entry pending")
    check(seen[-1][1] == 0 and seen[-1][0] == len(d.meshes),
          "the pending entries never all rendered")
    check(all(a[0] < b[0] for a, b in zip(seen, seen[1:])),
          "a frame brought no pending entry in")
    return seen


def phase_hydra_frame(cfg, frames, out_png, ibl_source, profile=""):
    """Phase 26, the main path of the Hydrogent front end: the Hydra stage
    (hydra_stage) populated, Synced and committed through the pxr adapter
    (timed); K1 against its plain version at the stage's G-buffer inputs
    and K4 at its EDGES frame's (hydra_k4); then HnTaskManager.execute at 1920x1080 through the render
    task with the bench renderer (on `cfg`, hydra_raster_config) and task
    manager; one warm-up frame, then
    `frames` timed frames with the counts zeroed just before and read just
    after (K1 1, K2 20, K3 1, K4 0 a frame); the same frames of the task
    manager alone on the committed scene (the delegate's own cost a frame);
    the probes (hydra_probes, hydra_budget_probe); with `profile`, 3
    profiled frames; and AsyncFramePipeline from no built kernel
    (hydra_async_probe)."""
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import FrameSettings
    from diligentfx_tpu_torch.pbr.deferred import fused_raster_inputs
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    renderer = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg,
                           device=DEVICE, env_oct=ibl_source.env_oct,
                           ibl_maps=ibl_source.ibl_maps)
    t0 = time.perf_counter()
    stage = hydra_stage()
    author_s = time.perf_counter() - t0
    rd, prims, task, commit_s = hydra_delegate(stage, renderer, DEVICE, W,
                                               H)
    d = rd.inner
    sd, meshes = stage[:2]
    pool = d.geometry_pool
    st = pool.stats()
    scene = d._scene
    groups = {g: {d._mesh_geo[m] for m in meshes if m.startswith(g)}
              for g in ("/Atrium/Geom/capital", "/Atrium/Geom/shaft",
                        "/Atrium/Geom/clutter")}
    print(f"hydra stage: {len(meshes)} mesh prims, {st['entries']} pool "
          f"entries ({st['instances']} instances, {st['pooled_bytes']} "
          f"bytes), {scene.num_triangles} triangles, {scene.num_vertices} "
          f"vertices, {d.texture_registry.num_textures} textures; authored "
          f"in {author_s:.2f} s, populate -> Sync -> CommitResources "
          f"{commit_s * 1e3:.1f} ms", flush=True)
    check(all(len(k) == 1 for k in groups.values()),
          f"the capitals, shafts and clutter spheres do not share one pool "
          f"entry each: {[len(k) for k in groups.values()]}")
    check(st["entries"] == 28 and st["instances"] == len(meshes),
          f"pool entries {st['entries']} of {st['instances']} instances, "
          f"expected 28 of {len(meshes)}")
    check(scene.num_triangles > 112592, "the stage's triangles")
    pad_w, pad_h = (-(-W // cfg.tile_w) * cfg.tile_w,
                    -(-H // cfg.tile_h) * cfg.tile_h)
    stats = {}
    for name, c in (("bench", bench_raster_config()), ("hydra", cfg)):
        k = fused_raster_inputs(scene, d.frame_info(W, H), pad_w=pad_w,
                                pad_h=pad_h, cfg=c, use_textures=True)
        stats[name] = {f: int(getattr(k.stats, f)) for f in k.stats._fields}
    print(f"hydra stage raster statistics, the bench config "
          f"{stats['bench']}, the stage's (hydra_raster_config) "
          f"{stats['hydra']}", flush=True)
    check(stats["hydra"]["bin_overflow"] == 0 and
          stats["hydra"]["big_overflow"] == 0,
          f"the stage overflows its raster config: {stats['hydra']}")
    k1 = phase_raster(scene, d.frame_info(W, H), cfg, use_textures=True,
                      label="hydra")
    k4 = hydra_k4(d, cfg)

    _frame_ok(task.Execute(), "hydra warm-up frame")
    check(d.texture_registry.num_pending == 0,
          "textures still pending after the warm-up frame")
    zero_launches()
    out, host_ms, dev_ms = _timed(task.Execute, frames)
    launches = read_launches()
    _frame_ok(out, "hydra frame")
    hit = float(out.gbuffer.hit.float().mean())
    for name, per_frame in FRAME_LAUNCHES.items():
        check(launches[name] == per_frame * frames,
              f"hydra: {name} launched {launches[name]} times in {frames} "
              f"frames, expected {per_frame} a frame")
    tm, info, state = d._task_manager(), d.frame_info(W, H), d._state
    _, tm_ms, tm_dev_ms = _timed(
        lambda: tm.execute(d._scene, info, state, width=W, height=H), frames)
    print(f"hydra frame {W}x{H}: median {np.median(host_ms):.3f} ms host "
          f"clock, {np.median(dev_ms):.3f} ms CUDA events, min "
          f"{min(host_ms):.3f}, max {max(host_ms):.3f} ({frames} frames); "
          f"the task manager alone on the committed scene "
          f"{np.median(tm_ms):.3f} ms host, {np.median(tm_dev_ms):.3f} ms "
          f"events; hit {hit:.3f}, mean colour {float(out.color.mean()):.4f};"
          f" launches {launches}", flush=True)
    if out_png:
        root, ext_ = os.path.splitext(out_png)
        _write_png(f"{root}_hydra{ext_ or '.png'}", out.color)
    probes = hydra_probes(rd, prims, task, stage)
    probes["budget_frames"] = hydra_budget_probe(stage, renderer)
    prof = None
    if profile:
        prof = phase_profile(tm, d._scene, lambda: d.frame_info(W, H), 3,
                             profile, "hydra", ranges=("dfx.gbuffer",),
                             settings_of=FrameSettings)
    async_ = hydra_async_probe()
    return dict(frame_ms_median=float(np.median(host_ms)),
                frame_events_ms_median=float(np.median(dev_ms)),
                task_manager_ms_median=float(np.median(tm_ms)),
                task_manager_events_ms_median=float(np.median(tm_dev_ms)),
                frames=frames, launches=launches, commit_ms=commit_s * 1e3,
                pool=st, triangles=scene.num_triangles, raster_stats=stats,
                probes=probes, profile=prof, async_pipeline=async_,
                k1_inputs=k1, k4_edges_inputs=k4)


def hydra_async_probe():
    """AsyncFramePipeline from no built kernel: hydra_async_child in a
    child process (a fresh process, so no kernel library is loaded), its
    kernels built into an empty directory under build/.  Its frames are
    FALLBACK first, then OK within HYDRA_ASYNC_LIMIT_S; each kernel library
    its frames launch is built exactly once (nvcc starts counted)."""
    import shutil
    import tempfile
    base = os.path.join(HERE, "build")
    os.makedirs(base, exist_ok=True)
    build_dir = tempfile.mkdtemp(prefix="async_kernels_", dir=base)
    try:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--async-child", build_dir, "--root",
                            ROOT], capture_output=True, text=True,
                           timeout=HYDRA_ASYNC_LIMIT_S + 300)
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)
    check(r.returncode == 0, f"the AsyncFramePipeline child failed "
          f"(rc {r.returncode}):\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    fallback = res["results"].index(0) if 0 in res["results"] else -1
    print(f"hydra probe: AsyncFramePipeline from no built kernel: "
          f"{fallback} FALLBACK frames, then OK after "
          f"{res['seconds_to_ok']:.2f} s (limit {HYDRA_ASYNC_LIMIT_S} s); "
          f"nvcc starts {res['nvcc_starts']}; the background frame "
          f"{res['background_s']:.2f} s; fallback frames "
          f"{res['fallback_ms']} ms", flush=True)
    check(res["results"][0] == 1 and fallback > 0,
          f"the pipeline's frames: {res['results']}")
    check(all(r_ == 0 for r_ in res["results"][fallback:]),
          f"a FALLBACK frame after the first OK: {res['results']}")
    check(res["nvcc_starts"] == {"raster_fused": 1, "warp": 1, "march": 1},
          f"kernel builds {res['nvcc_starts']}: each library once, K1, K2 "
          f"and K3 only")
    return res


def hydra_async_child(build_dir):
    """The child of hydra_async_probe: the kernels build into `build_dir`
    (empty); the stage through the delegate; AsyncFramePipeline with the
    bench task manager at 1920x1080 until its first OK frame, then two
    more; prints one JSON line."""
    import pathlib
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.async_compile import (
        AsyncFramePipeline, ExecuteResult)
    from diligentfx_tpu_torch.ops import cuda_build
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    cuda_build.BUILD_DIR = pathlib.Path(build_dir)
    check(not list(cuda_build.BUILD_DIR.glob("*.so")) and
          not cuda_build._loaded, "the child starts with kernels built")
    renderer = PBRRenderer(PBRRendererCreateInfo(),
                           raster_cfg=hydra_raster_config(), device=DEVICE)
    rd, _, _, _ = hydra_delegate(hydra_stage(), renderer, DEVICE, W, H)
    d = rd.inner
    scene, atlas, info = d._scene, d._atlas, d.frame_info(W, H)
    torch.cuda.synchronize()
    pipe = AsyncFramePipeline(renderer, bench_task_manager_ci(), width=W,
                              height=H, atlas=atlas)
    results, fallback_ms, out, ok_at = [], [], None, None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < HYDRA_ASYNC_LIMIT_S:
        t1 = time.perf_counter()
        out, res = pipe.execute(scene, info, out.state if out else None)
        torch.cuda.synchronize()
        _frame_ok(out, f"async frame {len(results)}")
        results.append(int(res))
        if res == ExecuteResult.OK:
            ok_at = time.perf_counter() - t0
            if results.count(0) == 3:
                break
        else:
            fallback_ms.append(round((time.perf_counter() - t1) * 1e3, 3))
    check(ok_at is not None, f"no OK frame within {HYDRA_ASYNC_LIMIT_S} s")
    print(json.dumps(dict(results=results, seconds_to_ok=ok_at,
                          nvcc_starts=cuda_build.nvcc_starts,
                          fallback_ms=fallback_ms[:8],
                          background_s=pipe.background_seconds)))
    return 0


def small_hydra_frames(device, frames=2):
    """The Hydra stage at 256x128 (the small IBL, hydra_raster_config's
    small lists) on the CPU path and on `device`, through the pxr adapter:
    `frames` SOLID frames each, (cpu colour, colour, the device's
    launches)."""
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ci = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=32,
                               num_specular_env_samples=16)
    cfg = hydra_raster_config(small=True)
    ref = PBRRenderer(ci, raster_cfg=cfg, device="cpu")
    stage = hydra_stage()
    colors = []
    for dev in ("cpu", device):
        ren = (ref if dev == "cpu" else
               PBRRenderer(ci, raster_cfg=cfg, device=dev,
                           env_oct=ref.env_oct, ibl_maps=ref.ibl_maps.to(dev)))
        _, _, task, _ = hydra_delegate(stage, ren, dev, SMALL_W, SMALL_H)
        zero_launches()
        for _ in range(frames):
            out = task.Execute()
        _frame_ok(out, f"256x128 hydra frame ({dev})", SMALL_W, SMALL_H)
        colors.append(out.color.cpu().numpy())
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
    return colors[0], colors[1], read_launches()


def phase_hydra_reference():
    """Phase 27: the Hydra stage at 256x128 on the GPU against the port's
    CPU path, above 50 dB, K1 1, K2 20, K3 1 a frame."""
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu, launches = small_hydra_frames(DEVICE)
    p = psnr(cpu, gpu)
    print(f"256x128 hydra frame, GPU vs the port's CPU path: PSNR {p:.2f} "
          f"dB, max abs diff {np.abs(cpu - gpu).max():.3g}; launches in 2 "
          f"frames {launches}", flush=True)
    check(p > 50.0, f"GPU hydra frame disagrees with the CPU path: "
                    f"{p:.2f} dB")
    check(all(launches[k] == 2 * v for k, v in FRAME_LAUNCHES.items()),
          f"the 256x128 hydra frames launched {launches}")
    return p


def hydra_only(frames, profile):
    """Phases 26 and 27 alone: the Hydra stage's 1080p frames, its probes,
    AsyncFramePipeline and its 256x128 frames against the CPU path."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    cfg = hydra_raster_config()
    ibl = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg, device=DEVICE)
    frame = phase_hydra_frame(cfg, frames, "", ibl, profile)
    return dict(hydra_frame=frame, hydra_psnr=phase_hydra_reference())


# ---------------------------------------------------------------------------
# the Radient atrium (phases 28 and 29)
# ---------------------------------------------------------------------------

RADIENT_CAROUSEL = 24              # the carousel parent's children
RADIENT_RING = (2.5, 3.2)          # their ring's radius and height, m
RADIENT_SPIN = 0.05                # the carousel's turn a frame, rad
RADIENT_SUN = {"type": "directional", "color": [1.0, 0.95, 0.9],
               "intensity": 3.0}
RADIENT_BUDGET = 1 << 10           # the budget probe's bytes: < one mesh
RADIENT_PIXEL_CHANGE = 0.05        # a pixel changed: a channel moved this far


def radient_lights():
    """The Radient atrium's KHR_lights_punctual lights: the light / heap
    atrium's spot and point light, and a directional sun along
    FULL_CHAIN_SUN."""
    return spot_point_lights() + [
        (RADIENT_SUN, light_node([0.0, 10.0, 0.0], FULL_CHAIN_SUN))]


def radient_glb(entries, lights):
    """The bytes of a .glb (write_glb) of `entries` ((MeshData, node
    matrix, PBRMaterialBasicAttribs) each, opaque) and `lights`."""
    import tempfile
    items = [(mesh, node, _gltf_material(mat)) for mesh, node, mat in entries]
    with tempfile.TemporaryDirectory() as tmp:
        with open(write_glb(os.path.join(tmp, "scene.glb"), items, (),
                            lights), "rb") as f:
            return f.read()


def radient_dedup_hits(n_columns, carousel):
    """The asset manager's dedup hits for radient_scene: create_mesh hashes
    each imported primitive's payload, and the atrium's capitals, shafts
    (each n_columns of one MeshData) and its 40 clutter spheres (distinct
    MeshData of equal payloads) are one asset each; the carousel's spheres
    are one; load_texture dedups the numpy payload's duplicate."""
    return 2 * (n_columns - 1) + (40 - 1) + (carousel - 1) + 1


def carousel_matrix(i):
    """The carousel parent's matrix at frame i: turned RADIENT_SPIN * i
    about +Y at the ring's height."""
    a = RADIENT_SPIN * i
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = np.cos(a), -np.sin(a), np.sin(a), \
        np.cos(a)
    m[3, 1] = RADIENT_RING[1]
    return m


def radient_camera(view, i):
    """full_chain_info(i)'s circling camera on a RadientView."""
    a = i * 0.02
    view.set_camera([10.0 * np.sin(a), 2.0, 10.0 * np.cos(a)],
                    [0.0, 1.0, 0.0], fov_y=0.8, near_z=0.1, far_z=100.0)


def radient_textures(eng, root):
    """Four load_texture calls: two PNGs written into `root` and resolved
    by a FilesystemAssetResolver pushed to the front of the chain (one by
    a path relative to `root`, one by its file:// URI), a numpy payload,
    and its duplicate with a release callback.  (handles, release calls)."""
    from diligentfx_tpu_torch.radient.resolver import FilesystemAssetResolver
    from diligentfx_tpu_torch.utils.image import write_png
    am = eng.asset_manager
    am.resolver.push_front(FilesystemAssetResolver([root]))
    write_png(os.path.join(root, "lattice.png"), lattice_texture(128))
    os.makedirs(os.path.join(root, "maps"), exist_ok=True)
    normal = os.path.join(root, "maps", "normal.png")
    write_png(normal, normal_texture(256))
    payload = np.random.default_rng(13).random((64, 64, 4)).astype(np.float32)
    released = []
    handles = [am.load_texture("lattice.png"),
               am.load_texture("file://" + normal),
               am.load_texture(payload),
               am.load_texture(payload.copy(),
                               release_callback=lambda: released.append(1))]
    return handles, released


def radient_carousel(eng, state, n=RADIENT_CAROUSEL, textures=()):
    """The carousel through the engine's API: a parent entity and n
    children, each create_mesh of an identical uv_sphere(0.3, 24, 32)
    payload (one asset, n - 1 dedup hits) with a material of its own (a
    texture handle stored on some, which nothing binds to the frame, as in
    the reference), on a ring of RADIENT_RING parented with set_parent.
    (parent, children)."""
    from diligentfx_tpu_torch.attribs import PBRMaterialBasicAttribs
    from diligentfx_tpu_torch.gltf.primitives import uv_sphere
    am = eng.asset_manager
    w = eng.create_scene_writer(state)
    parent = w.create_entity()
    w.set_transform(parent, carousel_matrix(0))
    children = []
    for k in range(n):
        s = uv_sphere(0.3, 24, 32)
        mesh = am.create_mesh(s.positions, s.indices, s.normals, s.uvs,
                              s.tangents)
        hue = 2 * np.pi * k / n
        mat = am.create_material(PBRMaterialBasicAttribs.create(
            base_color_factor=(0.55 + 0.4 * np.cos(hue),
                               0.55 + 0.4 * np.cos(hue - 2.1),
                               0.55 + 0.4 * np.cos(hue + 2.1), 1.0),
            metallic_factor=(k % 4) / 3, roughness_factor=0.2 + (k % 3) * 0.3),
            texture_handles=({"base_color": textures[k % len(textures)]}
                             if textures and k % 2 else {}))
        e = w.create_entity()
        w.set_mesh(e, mesh, mat)
        local = np.eye(4, dtype=np.float32)
        local[3, :3] = (RADIENT_RING[0] * np.cos(hue), 0.0,
                        RADIENT_RING[0] * np.sin(hue))
        w.set_transform(e, local)
        w.set_parent(e, parent)
        children.append(e)
    return parent, children


def radient_wait(am):
    """Wait for every queued mesh and texture load of `am`."""
    for h in list(am.meshes) + list(am.textures):
        am.wait_for_asset_load(h)


def radient_scene(eng, n_columns=12, carousel=RADIENT_CAROUSEL):
    """The Radient atrium through the port's Radient API on `eng`: the
    bytes of radient_glb (full_chain_entries(n_columns), no screens or
    panes, and radient_lights) in a MemoryAssetResolver pushed to the front
    of the chain and imported with import_gltf("mem://atrium.glb"); the
    four textures (radient_textures, written into a temporary root); the
    carousel; every load waited for.  A dict: state, scene, parent,
    children, textures, released, import status, seconds."""
    import tempfile
    from diligentfx_tpu_torch.radient.resolver import MemoryAssetResolver
    t0 = time.perf_counter()
    am = eng.asset_manager
    glb = radient_glb(full_chain_entries(n_columns), radient_lights())
    am.resolver.push_front(MemoryAssetResolver({"atrium.glb": glb}))
    scene, state = eng.create_scene()
    status = eng.create_scene_importer(state).import_gltf("mem://atrium.glb")
    with tempfile.TemporaryDirectory() as root:
        textures, released = radient_textures(eng, root)
        parent, children = radient_carousel(eng, state, carousel, textures)
        radient_wait(am)
    return dict(state=state, scene=scene, parent=parent, children=children,
                textures=textures, released=released, import_status=status,
                glb_bytes=len(glb), seconds=time.perf_counter() - t0)


def radient_raster_config(small=False):
    """The bench raster config's 32 x 128 tiles, 4 sub-bins and setup, with
    lists that hold the Radient atrium (the warm-up frame prints its longest
    sub-bin list): 1,024 a sub-bin at 1920x1080, 16,384 at 256x128
    (`small`)."""
    import dataclasses
    return dataclasses.replace(
        bench_raster_config(), bin_capacity=(1 << 16) if small else 4096,
        big_tri_capacity=256, big_tile_capacity=64)


def radient_step(renderer, state, view, writer, parent, i):
    """Frame i: the carousel turned (a transform-only change), the circling
    camera, update, render; (update status, render status, update ms,
    render ms), each time on the host clock ending in a synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    writer.set_transform(parent, carousel_matrix(i))
    radient_camera(view, i)
    st_u = renderer.update(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st_r = renderer.render(state, view)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return st_u, st_r, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def _pixel(view_proj, p, w, h):
    """The pixel (x, y) of world point p under a row-vector view-proj."""
    c = np.append(np.asarray(p, np.float64), 1.0) @ view_proj
    return (int((c[0] / c[3] * 0.5 + 0.5) * w),
            int((0.5 - c[1] / c[3] * 0.5) * h))


def radient_probes(eng, renderer, sc, view, frames):
    """Phase 28's probes: set_visible(False) on the carousel (one full
    rebuild; the carousel's centre pixels change), a fresh scene whose mesh
    is still loading (PENDING, then OK), a budget smaller than one mesh
    (NO_GPU_DATA, then OK on the next frame) and a headless engine (OK,
    no kernel launched)."""
    import threading
    import torch
    from diligentfx_tpu_torch.attribs import PBRMaterialBasicAttribs
    from diligentfx_tpu_torch.gltf.primitives import uv_sphere
    from diligentfx_tpu_torch.radient.engine import (RadientEngineCreateInfo,
                                                     create_radient_engine)
    from diligentfx_tpu_torch.radient.types import LoadStatus, RadientStatus
    state, parent = sc["state"], sc["parent"]
    writer = eng.create_scene_writer(state)
    cache = renderer._cache_for(state)
    am = eng.asset_manager
    res = {}

    # the carousel hidden, then shown: one full rebuild each
    before = view.last_frame.clone()
    rebuilds = cache.full_rebuilds
    tris = cache.scene_primitives.num_triangles
    writer.set_visible(parent, False)
    st = radient_step(renderer, state, view, writer, parent, frames)[:2]
    hidden = view.last_frame
    vp = renderer.frame_info(state, view).camera.view_proj.cpu().numpy()
    moved = (hidden - before).abs().amax(dim=-1).cpu().numpy()
    centres = [_pixel(vp, state.world_transform(e)[3, :3], W, H)
               for e in sc["children"]]
    changed = sum(1 for x, y in centres if 0 <= x < W and 0 <= y < H
                  and moved[y, x] > RADIENT_PIXEL_CHANGE)
    res.update(hidden_rebuilds=cache.full_rebuilds - rebuilds,
               hidden_triangles=cache.scene_primitives.num_triangles,
               hidden_pixels=int((moved > RADIENT_PIXEL_CHANGE).sum()),
               hidden_centres_changed=changed)
    writer.set_visible(parent, True)
    st2 = radient_step(renderer, state, view, writer, parent, frames)[:2]
    res["shown_rebuilds"] = cache.full_rebuilds - rebuilds
    print(f"radient probe: set_visible(False) on the carousel: {st}, full "
          f"rebuilds +{res['hidden_rebuilds']}, triangles {tris} -> "
          f"{res['hidden_triangles']}, {res['hidden_pixels']} pixels "
          f"changed, {changed} of {len(centres)} sphere centres changed; "
          f"shown again: {st2}, rebuilds +{res['shown_rebuilds']}",
          flush=True)
    check(st == st2 == (RadientStatus.OK, RadientStatus.OK),
          f"the visibility frames: {st}, {st2}")
    check(res["hidden_rebuilds"] == 1 and res["shown_rebuilds"] == 2,
          "set_visible is a structural change: one full rebuild each")
    mesh_tris = sum(int(am.meshes[state.meshes[e].mesh_asset]
                        .device["indices"].shape[0]) for e in sc["children"])
    check(res["hidden_triangles"] == tris - mesh_tris,
          f"the hidden carousel left {tris - res['hidden_triangles']} "
          f"triangles, not its {mesh_tris}")
    check(changed >= 0.75 * len(centres),
          f"only {changed} of {len(centres)} carousel centres changed")

    # a fresh scene whose mesh is still loading: PENDING, then OK
    gate = threading.Event()
    for _ in range(eng.ci.num_loading_threads):
        am._pool.submit(gate.wait, 60.0)
    _, fresh = eng.create_scene()
    fw = eng.create_scene_writer(fresh)
    s = uv_sphere(0.2, 10, 14)
    mesh = am.create_mesh(s.positions, s.indices, s.normals, s.uvs)
    e = fw.create_entity()
    fw.set_mesh(e, mesh, am.create_material(
        PBRMaterialBasicAttribs.create()))
    queued = am.get_status(mesh)
    pending = (renderer.update(fresh), renderer.render(fresh, view))
    gate.set()
    am.wait_for_asset_load(mesh)
    after = renderer.update(fresh)
    res.update(pending=[int(x) for x in pending], pending_after=int(after))
    print(f"radient probe: a fresh scene, its mesh {queued.name}: update "
          f"and render {[x.name for x in pending]}; once loaded, update "
          f"{after.name}", flush=True)
    check(queued == LoadStatus.QUEUED and pending == (
        RadientStatus.PENDING, RadientStatus.PENDING)
        and after == RadientStatus.OK, "the loading mesh's statuses")

    # a budget smaller than one mesh: NO_GPU_DATA, then OK
    small = create_radient_engine(RadientEngineCreateInfo(
        upload_budget_bytes=RADIENT_BUDGET, headless=True), device=DEVICE)
    _, bst = small.create_scene()
    bw = small.create_scene_writer(bst)
    sizes = []
    for k, res_ in enumerate(((12, 16), (14, 18))):
        s = uv_sphere(0.25, *res_)
        sizes.append(s.positions.nbytes + s.indices.nbytes)
        e = bw.create_entity()
        bw.set_mesh(e, small.asset_manager.create_mesh(
            s.positions, s.indices), -1)
    radient_wait(small.asset_manager)
    br = small.create_renderer()
    budget = []
    for _ in range(3):
        budget.append((br.update(bst), br.render(bst, small.create_view(
            SMALL_W, SMALL_H))))
    res["budget"] = [[int(a), int(b)] for a, b in budget]
    print(f"radient probe: a {RADIENT_BUDGET}-byte budget, meshes of "
          f"{sizes} bytes: update, render {[(a.name, b.name) for a, b in budget]}",
          flush=True)
    check(budget[0][0] == RadientStatus.NO_GPU_DATA and
          budget[1] == (RadientStatus.OK, RadientStatus.OK),
          f"the budget frames: {budget}")
    small.shutdown()

    # a headless engine: OK and no kernel launched
    head = create_radient_engine(RadientEngineCreateInfo(headless=True),
                                 device=DEVICE)
    _, hst = head.create_scene()
    hw = head.create_scene_writer(hst)
    s = uv_sphere(0.3, 24, 32)
    e = hw.create_entity()
    hw.set_mesh(e, head.asset_manager.create_mesh(s.positions, s.indices),
                -1)
    radient_wait(head.asset_manager)
    hr = head.create_renderer(task_manager_ci=bench_task_manager_ci())
    torch.cuda.synchronize()
    zero_launches()
    hstat = (hr.update(hst), hr.render(hst, head.create_view(W, H)))
    torch.cuda.synchronize()
    res["headless_launches"] = read_launches()
    print(f"radient probe: headless engine: {[x.name for x in hstat]}, "
          f"launches {res['headless_launches']}", flush=True)
    check(hstat == (RadientStatus.OK, RadientStatus.OK) and
          not any(res["headless_launches"].values()),
          "the headless engine's frame launched a kernel or failed")
    head.shutdown()
    return res


def radient_c_api_probe(eng, state):
    """The Radient atrium's meshes and hierarchy through the C API
    (NativeEngine, NativeScene): a node for each entity (its parent's node
    as parent, its local matrix, its visibility), a native mesh for each
    mesh entity from its asset's host payload, a native material for each
    material asset.  Its dedup count, its world matrices and its
    renderables must equal the Python SceneState's: the dedups and the
    renderables exactly; the world matrices within float32 rounding of the
    4x4 products (the C layer sums each product's terms in order, numpy's
    matmul does not): 4 ulp of the matrix's largest entry."""
    from diligentfx_tpu_torch.radient.c_api import NativeEngine
    from diligentfx_tpu_torch.radient.scene_state import INVALID_ENTITY
    am = eng.asset_manager
    ne = NativeEngine()
    ns = ne.create_scene()
    node, natmesh, natmat = {}, {}, {}
    deduped = 0
    todo = sorted(state._alive)
    while todo:
        e = todo.pop(0)
        p = state.parents[e]
        if p != INVALID_ENTITY and p not in node:
            todo.append(e)
            continue
        node[e] = ns.create_node(node[p] if p != INVALID_ENTITY else -1)
        ns.set_transform(node[e], state.transforms[e].local)
        ns.set_visible(node[e], state.visibility[e])
        mc = state.meshes.get(e)
        if mc is None or mc.mesh_asset < 0:
            continue
        a = am.meshes[mc.mesh_asset]
        m = ne.create_mesh(a.positions, a.indices, a.normals, a.uvs)
        deduped += m.deduped
        natmesh.setdefault(mc.mesh_asset, set()).add(m.handle)
        if mc.material_asset not in natmat:
            attribs = am.materials[mc.material_asset].attribs
            natmat[mc.material_asset] = ne.create_material(np.concatenate([
                attribs.base_color_factor.numpy(),
                [float(attribs.metallic_factor),
                 float(attribs.roughness_factor)]]))
        ns.set_mesh(node[e], m, natmat[mc.material_asset])
    py_mesh_entities = [e for e, mc in state.meshes.items()
                        if mc.mesh_asset >= 0]
    py_dedups = len(py_mesh_entities) - len({state.meshes[e].mesh_asset
                                             for e in py_mesh_entities})
    worlds = ns.world_matrices()
    err, exact = 0.0, 0
    for e, n in node.items():
        want = state.world_transform(e)
        d = np.abs(worlds[n] - want)
        tol = 4 * np.spacing(np.float32(max(1.0, np.abs(want).max())))
        err = max(err, float((d / tol).max()))
        exact += bool((d == 0).all())
    nodes, meshes, _ = ns.renderables()
    entity_of = {n: e for e, n in node.items()}
    native = sorted((entity_of[int(n)], int(h)) for n, h in zip(nodes,
                                                                 meshes))
    python = sorted((e, mc.mesh_asset) for e, mc, _ in
                    state.renderable_meshes())
    same_nodes = [e for e, _ in native] == [e for e, _ in python]
    same_meshes = same_nodes and all(
        h in natmesh[a] for (_, h), (_, a) in zip(native, python))
    print(f"radient C API: {len(node)} nodes, {len(py_mesh_entities)} mesh "
          f"nodes, dedups native {deduped} / Python {py_dedups}; world "
          f"matrices {exact} of {len(node)} bit-equal, the largest "
          f"difference {err:.3f} of the 4-ulp tolerance; renderables "
          f"{len(native)} native / {len(python)} Python, the same nodes "
          f"{same_nodes}, the same meshes {same_meshes}", flush=True)
    check(all(len(v) == 1 for v in natmesh.values()),
          "one Python mesh asset became several native meshes")
    check(deduped == py_dedups, f"native dedups {deduped}, Python "
          f"{py_dedups}")
    check(err <= 1.0, "native world matrices differ from SceneState's")
    check(same_nodes and same_meshes, "native renderables differ")
    ns.release()
    ne.release()
    return dict(nodes=len(node), dedups=deduped, world_bit_equal=exact,
                world_err_of_tol=err, renderables=len(native))


def radient_ibl_cache_probe():
    """PBRRenderer(ibl_cache_dir=...) at the default precompute sizes on
    the card, cold (precompute and save) then warm (load): the maps
    bit-equal; both times."""
    import tempfile
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    times = []
    with tempfile.TemporaryDirectory() as tmp:
        maps = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            maps.append(PBRRenderer(PBRRendererCreateInfo(), device=DEVICE,
                                    ibl_cache_dir=tmp).ibl_maps)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        files = os.listdir(tmp)
    cold, warm = maps

    def flat(m):
        return [t for x in m for t in (x if isinstance(x, tuple) else (x,))]
    same = all(torch.equal(a, b) and b.device == a.device
               for a, b in zip(flat(cold), flat(warm)))
    print(f"radient IBL cache: cold {times[0]:.1f} ms (precompute and save),"
          f" warm {times[1]:.1f} ms (load); {files}; the maps bit-equal "
          f"{same}", flush=True)
    check(same and len(files) == 1, "the cached IBL maps differ")
    return dict(cold_ms=times[0], warm_ms=times[1])


def radient_packing_probe(mesh):
    """ops/packing.py on the card and on the CPU on the carousel sphere's
    normals, positions and UVs: the packed words and the unpacked values
    bit-equal."""
    import torch
    from diligentfx_tpu_torch.ops import packing as pk
    out = {}
    for dev in ("cpu", DEVICE):
        n = torch.tensor(mesh.normals, device=dev)
        p = torch.tensor(mesh.positions, device=dev)
        uv = torch.tensor(mesh.uvs, device=dev)
        pn, pp, pu = pk.pack_normal(n), pk.pack_positions(p), pk.pack_uv(uv)
        out[dev] = [t.cpu() for t in (
            pn, pp.lo, pp.hi, pu, pk.unpack_normal(pn),
            pk.unpack_positions(pp), pk.unpack_uv(pu))]
    names = ("pack_normal", "pack_positions lo", "pack_positions hi",
             "pack_uv", "unpack_normal", "unpack_positions", "unpack_uv")
    differ = {name: int((a != b).sum()) for name, a, b in
              zip(names, out["cpu"], out[DEVICE]) if not torch.equal(a, b)}
    same = not differ
    err = float((out["cpu"][5] - torch.tensor(mesh.positions)).abs().max())
    print(f"radient packing: {mesh.positions.shape[0]} vertices on the card "
          f"and the CPU bit-equal {same} (values that differ: {differ}); "
          f"position round trip max error {err:.3g} m", flush=True)
    check(same, "packing differs between the card and the CPU")
    return dict(vertices=int(mesh.positions.shape[0]), bit_equal=same)


def phase_radient_frame(cfg, frames, out_png, profile=""):
    """Phase 28, the main path of the Radient front end: the Radient atrium
    (radient_scene) through create_radient_engine on the card; its dedup
    hits, the textures' release callback and atlas; the renderer
    (create_renderer with the bench task manager and `cfg`) and a
    create_view(1920, 1080) on the circling camera; one warm-up frame
    (update, render; the raster statistics on the bench config and on
    `cfg`); K1 against its plain version at the frame's G-buffer inputs;
    `frames` timed frames, the carousel turned each (a transform-only
    change), with the counts zeroed just before and read just after (K1 1,
    K2 20, K3 1, K4 0 a frame) and the drawable cache's counters; the
    probes (radient_probes), the C API (radient_c_api_probe), the IBL cache
    and packing; with `profile`, 3 profiled frames of the renderer's task
    manager on the committed scene."""
    import torch
    from diligentfx_tpu_torch.gltf.primitives import uv_sphere
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.pbr.deferred import fused_raster_inputs
    from diligentfx_tpu_torch.radient.engine import create_radient_engine
    from diligentfx_tpu_torch.radient.types import LoadStatus, RadientStatus
    eng = create_radient_engine(device=DEVICE)
    sc = radient_scene(eng)
    state, am = sc["state"], eng.asset_manager
    want_dedup = radient_dedup_hits(12, RADIENT_CAROUSEL)
    print(f"radient scene: import {sc['import_status'].name} of a "
          f"{sc['glb_bytes']}-byte glb, {state.entity_count} entities "
          f"({len(state.meshes)} meshes, {len(state.lights)} lights), "
          f"{am.stats.meshes} mesh assets, {am.stats.materials} materials, "
          f"{am.stats.textures} textures, dedup hits {am.stats.dedup_hits} "
          f"(expected {want_dedup}), release callbacks {sc['released']}; "
          f"built in {sc['seconds']:.2f} s", flush=True)
    check(sc["import_status"] == RadientStatus.OK, "import_gltf failed")
    check(am.stats.dedup_hits == want_dedup, "the dedup hits")
    check(sc["released"] == [1], "the duplicate texture's release callback")
    check(len(state.lights) == 3 and len(state.meshes) == 65 +
          RADIENT_CAROUSEL, "the scene's lights and meshes")

    renderer = eng.create_renderer(task_manager_ci=bench_task_manager_ci(),
                                   raster_cfg=cfg)
    view = eng.create_view(W, H)
    writer = eng.create_scene_writer(state)
    warm = radient_step(renderer, state, view, writer, sc["parent"], 0)
    check(warm[:2] == (RadientStatus.OK, RadientStatus.OK),
          f"the warm-up frame: {warm[:2]}")
    _color_ok(view.last_frame, "radient warm-up frame")
    tex_ok = all(am.get_status(h) == LoadStatus.COMMITTED
                 for h in sc["textures"])
    check(tex_ok and am.get_atlas() is not None and
          renderer.task_manager().atlas is None,
          "the textures: committed to the atlas, not bound to the frame")
    cache = renderer._cache_for(state)
    scene = cache.scene_primitives
    info = renderer.frame_info(state, view)
    pad_w, pad_h = rz.pad_viewport(W, H, cfg)
    stats = {}
    for name, c in (("bench", bench_raster_config()), ("radient", cfg)):
        k = fused_raster_inputs(scene, info, pad_w=pad_w, pad_h=pad_h, cfg=c)
        stats[name] = {f: int(getattr(k.stats, f)) for f in k.stats._fields}
    print(f"radient atrium: {scene.num_triangles} triangles, "
          f"{scene.num_vertices} vertices, {scene.node_matrices.shape[0]} "
          f"nodes; raster statistics at {pad_w}x{pad_h}, the bench config "
          f"{stats['bench']}, radient_raster_config {stats['radient']} "
          f"(longest sub-bin list {stats['radient']['max_bin_count']} of "
          f"{cfg.bin_capacity // cfg.sub_bins})", flush=True)
    check(stats["radient"]["bin_overflow"] == 0 and
          stats["radient"]["big_overflow"] == 0,
          f"the atrium overflows its raster config: {stats['radient']}")
    k1 = phase_raster(scene, info, cfg, label="radient")
    check(k1["bit_equal"], "K1 at the Radient inputs is not bit-equal to "
          "its plain version")

    rebuilds, syncs = cache.full_rebuilds, cache.incremental_syncs
    upd, ren, whole, ev = [], [], [], []
    zero_launches()
    for i in range(1, frames + 1):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        st_u, st_r, u_ms, r_ms = radient_step(renderer, state, view, writer,
                                               sc["parent"], i)
        e1.record()
        torch.cuda.synchronize()
        check((st_u, st_r) == (RadientStatus.OK, RadientStatus.OK),
              f"radient frame {i}: {st_u.name}, {st_r.name}")
        upd.append(u_ms)
        ren.append(r_ms)
        whole.append(u_ms + r_ms)
        ev.append(e0.elapsed_time(e1))
    launches = read_launches()
    _color_ok(view.last_frame, "radient frame")
    # the bench effects on the fused K1 route, no shadow pass: a bench
    # frame's launches
    for name, per_frame in FRAME_LAUNCHES.items():
        check(launches[name] == per_frame * frames,
              f"radient: {name} launched {launches[name]} times in {frames} "
              f"frames, expected {per_frame} a frame")
    counters = dict(full_rebuilds=cache.full_rebuilds - rebuilds,
                    incremental_syncs=cache.incremental_syncs - syncs)
    check(counters == dict(full_rebuilds=0, incremental_syncs=frames),
          f"the drawable cache over the timed frames: {counters}")
    print(f"radient frame {W}x{H}: median {np.median(whole):.3f} ms host "
          f"clock (update {np.median(upd):.3f} ms, render "
          f"{np.median(ren):.3f} ms), {np.median(ev):.3f} ms CUDA events, "
          f"min {min(whole):.3f}, max {max(whole):.3f} ({frames} frames); "
          f"the cache {counters}; mean colour "
          f"{float(view.last_frame.mean()):.4f}; launches {launches}",
          flush=True)
    if out_png:
        root, ext_ = os.path.splitext(out_png)
        _write_png(f"{root}_radient{ext_ or '.png'}", view.last_frame)
    prof = None
    if profile:
        from diligentfx_tpu_torch.hydrogent.task_manager import FrameSettings
        prof = phase_profile(renderer.task_manager(),
                             cache.scene_primitives,
                             lambda: renderer.frame_info(state, view), 3,
                             profile, "radient", ranges=("dfx.gbuffer",),
                             settings_of=FrameSettings)
    probes = radient_probes(eng, renderer, sc, view, frames + 1)
    probes["c_api"] = radient_c_api_probe(eng, state)
    probes["ibl_cache"] = radient_ibl_cache_probe()
    probes["packing"] = radient_packing_probe(uv_sphere(0.3, 24, 32))
    eng.shutdown()
    return dict(frame_ms_median=float(np.median(whole)),
                update_ms_median=float(np.median(upd)),
                render_ms_median=float(np.median(ren)),
                frame_events_ms_median=float(np.median(ev)), frames=frames,
                launches=launches, triangles=scene.num_triangles,
                raster_stats=stats, dedup_hits=am.stats.dedup_hits,
                scene_seconds=sc["seconds"], cache=counters, probes=probes,
                profile=prof, k1_inputs=k1)


def small_radient_frames(device, frames=2):
    """The Radient atrium at 256x128 (the small IBL, the small raster
    lists) through the Radient API on the CPU path and on `device`:
    `frames` frames each, the carousel turned between them; (cpu colour,
    colour, the device's launches)."""
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.radient.engine import create_radient_engine
    from diligentfx_tpu_torch.radient.types import RadientStatus
    ci = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=32,
                               num_specular_env_samples=16)
    colors = []
    for dev in ("cpu", device):
        eng = create_radient_engine(device=dev)
        sc = radient_scene(eng)
        r = eng.create_renderer(task_manager_ci=bench_task_manager_ci(),
                                renderer_ci=ci,
                                raster_cfg=radient_raster_config(small=True))
        view = eng.create_view(SMALL_W, SMALL_H)
        writer = eng.create_scene_writer(sc["state"])
        if torch.device(dev).type == "cuda":
            r.task_manager()                 # its IBL precompute uncounted
            torch.cuda.synchronize()
        zero_launches()
        for i in range(frames):
            writer.set_transform(sc["parent"], carousel_matrix(i))
            radient_camera(view, i)
            st = (r.update(sc["state"]), r.render(sc["state"], view))
            check(st == (RadientStatus.OK, RadientStatus.OK),
                  f"256x128 radient frame ({dev}): {st}")
        _color_ok(view.last_frame, f"256x128 radient frame ({dev})",
                  SMALL_W, SMALL_H)
        colors.append(view.last_frame.cpu().numpy())
        eng.shutdown()
    return colors[0], colors[1], read_launches()


def phase_radient_reference():
    """Phase 29: two 256x128 frames of the Radient atrium on the GPU
    against the port's CPU path, above 50 dB; K1 1, K2 20, K3 1 a frame."""
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu, launches = small_radient_frames(DEVICE)
    p = psnr(cpu, gpu)
    print(f"256x128 radient frame, GPU vs the port's CPU path: PSNR {p:.2f} "
          f"dB, max abs diff {np.abs(cpu - gpu).max():.3g}; launches in 2 "
          f"frames {launches}", flush=True)
    check(p > 50.0, f"GPU radient frame disagrees with the CPU path: "
                    f"{p:.2f} dB")
    check(all(launches[k] == 2 * v for k, v in FRAME_LAUNCHES.items()),
          f"the 256x128 radient frames launched {launches}")
    return p


def radient_only(frames, profile):
    """Phases 28 and 29 alone: the Radient atrium's 1080p frames, its
    probes and its 256x128 frames against the CPU path."""
    t0 = time.perf_counter()
    frame = phase_radient_frame(radient_raster_config(), frames, "", profile)
    t1 = time.perf_counter()
    p = phase_radient_reference()
    return dict(radient_frame=frame, radient_psnr=p,
                phase_seconds=[t1 - t0, time.perf_counter() - t1])


# ---------------------------------------------------------------------------
# the 4K cfg5 frame (examples/benchmark_suite.py config_5_4k) through
# execute_split, and the row-banded frame of parallel/tiling.py
# ---------------------------------------------------------------------------

W4K, H4K = 3840, 2160
SPLIT_BANDS = 4                # benchmark_suite.py:268 gbuffer_bands
CFG5_COLUMNS = 24              # sponza_like_scene's default
# a cfg5 frame launches K1 once and no K3 (its SSR stays off the kernel
# route), K4, K5 or K6; its K2 count is the warm-up frame's, printed
SPLIT4K_FIXED = {"raster_tiles_fused": 1, "march_small_table": 0,
                 "gtao_fused": 0, "raster_tiles": 0, "warp_bilinear_multi": 0}
# execute_split against execute at 4K: the banded G-buffer shades the
# frame's rows pixel by pixel (cfg5 keeps fast_env_taps off), so equal
SPLIT_EQUAL_BOUND = 1e-5
BANDED_W, BANDED_H, BANDED_N = 1920, 1088, 4    # tests/test_multichip.py:145
# a banded frame: K1 once a band; K3 and K2 (its history) once, SSR on
# the gathered inputs with ssr_use_pallas; the other effects take no
# kernel route there
BANDED_LAUNCHES = {"raster_tiles_fused": BANDED_N, "warp_bilinear": 1,
                   "march_small_table": 1, "gtao_fused": 0,
                   "raster_tiles": 0, "warp_bilinear_multi": 0}


def cfg5_raster_config():
    """config 5's: lists of 1,024."""
    return suite().config_5_raster_config()


def cfg5_task_manager_ci():
    """config 5's effects: SSAO on the per-tap warp route, SSR off the
    kernel route, TAA with the warp history, bloom."""
    return suite().config_5_task_manager_ci()


def cfg5_info(w, h, device):
    """config 5's camera and sun: config 4's frame 0."""
    return suite().atrium_info(0, w, h, device)


def _clone(obj):
    """A deep copy of the tensors of a frame state."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_clone(x) for x in obj))
    return obj


def phase_split4k_raster(scene, cfg):
    """Phase 30: K1 at the 4K cfg5 G-buffer inputs (2176 x 3840 padded)
    against its plain version, with the raster statistics (cfg5's lists
    may drop pairs at 4K: its configuration, reported as it is)."""
    k1 = phase_raster(scene, cfg5_info(W4K, H4K, DEVICE), cfg,
                      label="4K cfg5", width=W4K, height=H4K)
    st = k1["raster_stats"]
    print(f"4K cfg5 raster: {scene.num_triangles} triangles; bin overflow "
          f"{st['bin_overflow']}, big-triangle overflow {st['big_overflow']},"
          f" longest list {st['max_bin_count']} of 1024", flush=True)
    return k1


def _frame_diffs(a, b):
    """Largest |a - b| of the colour and of each G-buffer field, and the
    mesh ids that differ."""
    diffs = {"color": float((a.color - b.color).abs().max())}
    for f in ("depth", "normal_view", "direct", "ambient_diffuse",
              "ambient_specular", "background", "motion"):
        diffs[f] = float((getattr(a.gbuffer, f)
                          - getattr(b.gbuffer, f)).abs().max())
    diffs["mesh_id_differs"] = int((a.gbuffer.mesh_id
                                    != b.gbuffer.mesh_id).sum())
    return diffs


def phase_split4k_frame(cfg, scene, frames, out_png, ibl_source):
    """Phase 31, the main path: the 4K cfg5 frame through
    HnTaskManager.execute_split(gbuffer_bands=4): one warm-up frame (its
    launches printed), `frames` timed frames held to them; then from one
    copied state one frame each of execute_split with 4 bands and with 1
    and of execute, their colour and G-buffer differences and each call's
    peak device memory."""
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    renderer = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg,
                           device=DEVICE, env_oct=ibl_source.env_oct,
                           ibl_maps=ibl_source.ibl_maps)
    tm = HnTaskManager(renderer, cfg5_task_manager_ci())
    info = cfg5_info(W4K, H4K, DEVICE)
    settings = bench_settings()        # benchmark_suite.py:263: SSR 24

    def split(state, bands=SPLIT_BANDS):
        return tm.execute_split(scene, info, state, width=W4K, height=H4K,
                                settings=settings, gbuffer_bands=bands)
    state = tm.initial_state(W4K, H4K)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = split(state)
    torch.cuda.synchronize()
    warm = read_launches()
    print(f"4K cfg5 warm-up frame: {time.perf_counter() - t0:.2f} s, "
          f"launches {warm}", flush=True)
    for name, n in SPLIT4K_FIXED.items():
        check(warm[name] == n, f"4K cfg5 warm-up: {name} launched "
                               f"{warm[name]} times, expected {n}")
    check(warm["warp_bilinear"] > 0, "4K cfg5 warm-up launched no K2")
    state = out.state
    zero_launches()
    host_ms, dev_ms = [], []
    for _ in range(frames):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        out = split(state)
        state = out.state
        ev1.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(ev0.elapsed_time(ev1))
    launches = read_launches()
    for name, n in warm.items():
        check(launches[name] == n * frames,
              f"4K cfg5: {name} launched {launches[name]} times in {frames} "
              f"frames, the warm-up frame {n}")
    _color_ok(out.color, "4K cfg5 frame", W4K, H4K)
    hit = float(out.gbuffer.hit.float().mean())
    check(0.2 < hit < 1.0, f"4K cfg5 hit fraction {hit}")
    print(f"4K cfg5 frame {W4K}x{H4K} (execute_split, {SPLIT_BANDS} bands):"
          f" median {np.median(host_ms):.3f} ms host clock, "
          f"{np.median(dev_ms):.3f} ms CUDA events, min {min(host_ms):.3f},"
          f" max {max(host_ms):.3f} ({frames} frames), hit {hit:.3f}, mean "
          f"color {float(out.color.mean()):.4f}; launches a frame "
          f"{ {k: v // frames for k, v in launches.items()} }", flush=True)
    if out_png:
        root, ext = os.path.splitext(out_png)
        _write_png(f"{root}_4k{ext or '.png'}", out.color)
    # the same frame three ways from one copied state
    calls = (("execute_split(4)", lambda s: split(s, SPLIT_BANDS)),
             ("execute_split(1)", lambda s: split(s, 1)),
             ("execute", lambda s: tm.execute(scene, info, s, width=W4K,
                                              height=H4K, settings=settings)))
    outs, peaks = {}, {}
    for name, fn in calls:
        st = _clone(state)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs[name] = fn(st)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        peaks[name] = dict(peak_mb=peak / 2 ** 20,
                           above_inputs_mb=(peak - base) / 2 ** 20)
        del st
    diffs = {name: _frame_diffs(outs[name], outs["execute"])
             for name in ("execute_split(4)", "execute_split(1)")}
    for name, d in diffs.items():
        print(f"4K {name} against execute: {d}; peak "
              f"{peaks[name]['peak_mb']:.1f} MB ({peaks[name]['above_inputs_mb']:.1f}"
              f" MB above what was allocated before the call)", flush=True)
        check(d["mesh_id_differs"] == 0 and
              max(v for k, v in d.items() if k != "mesh_id_differs")
              <= SPLIT_EQUAL_BOUND,
              f"4K {name} differs from execute beyond {SPLIT_EQUAL_BOUND}:"
              f" {d}")
    print(f"4K execute: peak {peaks['execute']['peak_mb']:.1f} MB "
          f"({peaks['execute']['above_inputs_mb']:.1f} MB above the inputs);"
          f" total on the card "
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 20:.0f}"
          f" MB", flush=True)
    return dict(frame_ms_median=float(np.median(host_ms)),
                frame_events_ms_median=float(np.median(dev_ms)),
                launches=launches, warmup_launches=warm, frames=frames,
                diffs=diffs, peaks=peaks, triangles=scene.num_triangles)


def banded_raster_config():
    """tests/test_multichip.py:19-20: 8 x 128 tiles (1088 rows split into
    four bands of 272), the big-triangle list at 64: at 16, the unbanded
    1920 x 1088 frame drops 15 of its 31 big triangles (the plane's) where
    no band drops any, and the comparisons with it would compare
    different scenes."""
    from diligentfx_tpu_torch.config import RasterizerConfig
    return RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=512,
                            max_tiles_per_tri=16, big_tri_capacity=64,
                            chunk=8)


def banded_scene(device):
    """tests/test_multichip.py:147-163: a red sphere, a blue BLEND sphere
    beside it (the banded OIT) and a 20 m plane."""
    from diligentfx_tpu_torch.attribs import PBRMaterialBasicAttribs
    from diligentfx_tpu_torch.gltf.primitives import plane, uv_sphere
    from diligentfx_tpu_torch.pbr.renderer import build_scene
    sphere = uv_sphere(0.8, 8, 10)
    gn = np.eye(4, dtype=np.float32)
    gn[3, 1] = -1.0
    tn = np.eye(4, dtype=np.float32)
    tn[3, 0] = 1.2
    return build_scene([
        (sphere, np.eye(4, dtype=np.float32),
         PBRMaterialBasicAttribs.create(base_color_factor=(0.8, 0.2, 0.2, 1),
                                        metallic_factor=0.4,
                                        roughness_factor=0.3)),
        (sphere, tn,
         PBRMaterialBasicAttribs.create(base_color_factor=(0.2, 0.5, 0.9, 0.5),
                                        alpha_mode=2, roughness_factor=0.2)),
        (plane(20.0), gn, PBRMaterialBasicAttribs.create(
            base_color_factor=(0.4, 0.4, 0.45, 1), roughness_factor=0.7)),
    ], device=device)


def banded_info(w, h, device):
    """tests/test_multichip.py:24-47,164-167: the camera at (0, 1.5, 5)
    looking at the origin, one directional light."""
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                              PBRRendererShaderParameters)
    from diligentfx_tpu_torch.pbr.renderer import RenderInfo
    eye = [0.0, 1.5, 5.0]
    cam = CameraAttribs.create(
        m3.look_at(eye, [0, 0, 0], device=device),
        m3.perspective(0.9, w / h, 0.1, 50.0, device=device), eye, 0.1, 50.0,
        w, h, device=device)
    return RenderInfo(camera=cam, lights=PBRLightAttribs.directional(
        [-0.4, -1.0, -0.3], [3, 3, 3], device=device),
        renderer_params=PBRRendererShaderParameters.create(device=device))


def banded_task_manager_ci(ssr_use_pallas=True):
    """tests/test_multichip.py:170-177's execute frame, SSR on the kernel
    route as the banded frame takes it on the card."""
    from diligentfx_tpu_torch.config import ToneMappingMode
    from diligentfx_tpu_torch.hydrogent.task_manager import \
        TaskManagerCreateInfo
    return TaskManagerCreateInfo(
        enable_ssao=True, ssao_half_resolution=True, ssao_num_slices=2,
        ssao_num_steps=3, enable_ssr=True, ssr_resolution_divisor=2,
        ssr_use_pallas=ssr_use_pallas, enable_taa=True, enable_bloom=True,
        enable_dof=False, oit_layer_count=4,
        tone_mapping_mode=ToneMappingMode.UNCHARTED2,
        convert_output_to_srgb=True)


def banded_kw(cfg, jitter_seq, ssr_use_pallas=True):
    """render_frame_banded's arguments of tests/test_multichip.py:186-193
    (SSAO 2 x 3, SSR divisor 2 with 12 steps, TAA with the jitter, bloom,
    Uncharted2, sRGB)."""
    from diligentfx_tpu_torch.config import ToneMappingMode
    return dict(cfg=cfg, use_ibl=True, enable_ssao=True, ssao_num_slices=2,
                ssao_num_steps=3, enable_ssr=True, ssr_divisor=2, ssr_steps=12,
                ssr_use_pallas=ssr_use_pallas, enable_taa=True,
                enable_bloom=True, oit_layer_count=4,
                tone_mapping_mode=ToneMappingMode.UNCHARTED2,
                convert_output_to_srgb=True, jitter_seq=jitter_seq)


def _card_mesh(n):
    import torch
    from diligentfx_tpu_torch.parallel.mesh import make_render_mesh
    return make_render_mesh(devices=[torch.device(DEVICE, 0)] * n, dp=1,
                            sp=n)


def forward_band_inputs(scene, info, cfg, y0, band_h, width=BANDED_W,
                        height=BANDED_H):
    """K4's inputs in render_forward_banded's band at row y0 of a width x
    height frame: the frame's setup at the band's viewport offset, binned
    over the band; (setup, compact, counts, rects, kernel keywords)."""
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.pbr.renderer import transform_vertices
    world_pos, _, _ = transform_vertices(scene, info.model_transform)
    clip = m3.transform_points(world_pos, info.camera.view_proj)
    window = dict(screen_size=(width, height), screen_offset=(0, y0))
    setup, valid, bbox, _, _ = rz._triangle_setup(
        clip, scene.indices, width, band_h, scene.tri_double_sided, True,
        1e-3, **window)
    cand, counts, _, _, _ = rz._bin_triangles(valid, bbox, width, band_h,
                                              cfg)
    rects = rz.candidate_rects(setup, width, band_h, (0, y0))
    kw = dict(th=cfg.tile_h, tw=cfg.tile_w, tiles_x=width // cfg.tile_w,
              chunk=cfg.chunk, screen_offset=(0, y0))
    return (setup, cand, counts, rects), kw


def k3_against_plain(coarse, origin, direction, args, thick, label):
    """K3 vs march_dda_plain on one input set (no hit mismatch, t exact),
    timed by CUDA events and device time, its bound as phase 5 counts it."""
    import torch
    from diligentfx_tpu_torch.ops.march import (march_dda_plain,
                                                march_small_table)
    a = march_small_table(*args, thick)
    torch.cuda.synchronize()
    b = march_dda_plain(*args, thick)
    flips = int((a[2] != b[2]).sum())
    err = max(float((a[0] - b[0]).abs().max()),
              float((a[1] - b[1]).abs().max()))
    check(flips == 0, f"K3 hits differ from the plain version {label}: "
                      f"{flips}")
    check(err == 0.0, f"K3 t error {err} {label}")

    def run():
        return march_small_table(*args, thick)
    ms = cuda_ms(run, 20, 2)
    dev_ms = kernel_device_ms(run, "march_kernel", 20)
    plain_ms = cuda_ms(lambda: march_dda_plain(*args, thick), 3, 1)
    crossed = _march_rows_crossed(coarse, origin, direction)
    px = origin.shape[0] * origin.shape[1]
    b_ms, b_by = bound_ms(4 * coarse.numel() + px * (24 + 9),
                          MARCH_OPS_PER_ROW * crossed)
    print(f"march {label}: table {tuple(coarse.shape)}, rays "
          f"{tuple(origin.shape)}, hit {float(b[2].float().mean()):.4f}, "
          f"hit mismatches {flips}, t max err {err:.3g}; {ms:.4f} ms events,"
          f" device {dev_ms:.4f}, plain {plain_ms:.2f}; bound {b_ms:.4f} "
          f"({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                shapes=f"table {tuple(coarse.shape)}, rays "
                       f"{tuple(origin.shape)}")


def phase_banded(frames, ibl_source):
    """Phase 32: the row-banded frame of parallel/tiling.py at 1920 x 1088
    over four bands on the one card (tests/test_multichip.py:125-199's
    configuration): K1 at each band's render_gbuffer_band_sp inputs
    against its plain version and against the same rows of the unbanded
    K1 output; K4 at each band of render_forward_banded against its plain
    version; render_forward_banded with four bands bit-equal to one (K4 4
    launches); K3 at the gathered SSR inputs; two frames of
    render_frame_banded with four bands against execute (4e-3) and
    against one band (2e-3); then `frames` timed banded frames with the
    counts zeroed just before and read just after (K1 4, K3 1 a frame)
    and `frames` timed execute frames."""
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import (FrameSettings,
                                                             HnTaskManager)
    from diligentfx_tpu_torch.parallel import tiling
    from diligentfx_tpu_torch.parallel.mesh import band_sharding
    from diligentfx_tpu_torch.pbr.deferred import render_gbuffer_band_sp
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    from diligentfx_tpu_torch.postfx.ssr import SSRSettings
    cfg = banded_raster_config()
    w, h, n = BANDED_W, BANDED_H, BANDED_N
    band_h = h // n
    scene = banded_scene(DEVICE)
    info = banded_info(w, h, DEVICE)
    renderer = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg,
                           device=DEVICE, env_oct=ibl_source.env_oct,
                           ibl_maps=ibl_source.ibl_maps)
    ibl, env = renderer.ibl_maps, renderer.env_oct
    # K1: the unbanded frame's inputs, then each band's window
    whole = []
    k1 = phase_raster(scene, info, cfg, label="banded frame, unbanded",
                      width=w, height=h, outputs=whole)
    st = k1["raster_stats"]
    check(st["bin_overflow"] == 0 and st["big_overflow"] == 0,
          f"the unbanded banded-frame raster overflows: {st}")
    k1_bands = []
    for b in range(n):
        y0 = b * band_h
        outs = []
        r = phase_raster(scene, info, cfg, label=f"banded frame, band {b}",
                         width=w, height=h, band=(y0, band_h), outputs=outs)
        (z, tid, out), (zw, tidw, outw) = outs[0], whole[0]
        rows = slice(y0, y0 + band_h)
        ids = int((tid != tidw[rows]).sum())
        hit = (tid >= 0) & (tid == tidw[rows])
        z_err = float((z - zw[rows]).abs()[hit].max()) if bool(hit.any()) \
            else 0.0
        ch_err = float((out - outw[:, rows]).abs()[:, hit].max()) \
            if bool(hit.any()) else 0.0
        print(f"banded frame, band {b} (screen_offset (0, {y0})) against "
              f"the unbanded rows: id mismatches {ids}, z max err "
              f"{z_err:.3g}, channel max err {ch_err:.3g}", flush=True)
        check(ids == 0, f"band {b}'s K1 ids differ from the unbanded rows")
        check(z_err <= 1e-6 and ch_err <= 1e-5 * max(
            1.0, float(outw.abs().max())),
            f"band {b}'s K1 differs from the unbanded rows: {z_err} "
            f"{ch_err}")
        k1_bands.append({key: r[key] for key in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "candidate_pixel_tests", "raster_stats")}
            | dict(screen_offset=[0, y0], rows_max_abs_err=max(z_err,
                                                                ch_err)))
    k1["band_inputs"] = k1_bands
    # K4 at the forward-banded inputs, and the forward frame
    k4_bands = []
    for b in range(n):
        args, kw = forward_band_inputs(scene, info, cfg, b * band_h, band_h)
        k4_bands.append(dict(k4_against_plain(
            args, kw, f"at forward band {b} (screen_offset (0, "
                      f"{b * band_h}))", may_be_empty=True),
            screen_offset=[0, b * band_h]))
    torch.cuda.synchronize()
    zero_launches()
    _, fwd4 = tiling.render_forward_banded(scene, info, ibl, env,
                                           _card_mesh(n), width=w, height=h,
                                           cfg=cfg)
    torch.cuda.synchronize()
    fwd_launches = read_launches()
    _, fwd1 = tiling.render_forward_banded(scene, info, ibl, env,
                                           _card_mesh(1), width=w, height=h,
                                           cfg=cfg)
    same = bool(torch.equal(fwd4, fwd1))
    print(f"render_forward_banded {n} bands against 1: bit-equal {same}; "
          f"launches {fwd_launches}", flush=True)
    check(same, "render_forward_banded: four bands differ from one")
    check(fwd_launches["raster_tiles"] == n and
          fwd_launches["raster_tiles_fused"] == 0,
          f"render_forward_banded launched {fwd_launches}")
    # K3 at the gathered SSR inputs of the bands' G-buffers (frame 0)
    gbs = [render_gbuffer_band_sp(scene, info, ibl, env, width=w,
                                  band_h=band_h, full_height=h,
                                  band_y0=b * band_h, cfg=cfg)
           for b in range(n)]
    k3 = k3_against_plain(*march_inputs(
        torch.cat([g.depth for g in gbs]),
        torch.cat([g.normal_view for g in gbs]),
        torch.cat([g.material_data[..., 1:2] for g in gbs]), info.camera, 0,
        SSRSettings(max_traversal_intersections=12)),
        label="at the banded frame's gathered inputs")
    del gbs
    # the banded frame against execute and against one band
    tm = HnTaskManager(renderer, banded_task_manager_ci())
    settings = FrameSettings(ssr=SSRSettings(max_traversal_intersections=12))
    kw = banded_kw(cfg, tm.jitter_seq)
    m4, m1 = _card_mesh(n), _card_mesh(1)
    s4 = tiling.initial_banded_state(w, h, m4)
    s1 = tiling.initial_banded_state(w, h, m1)
    est = tm.initial_state(w, h)
    errs = []
    for i in range(2):
        _, s4, c4 = tiling.render_frame_banded(scene, info, ibl, env, s4, m4,
                                               width=w, height=h, **kw)
        _, s1, c1 = tiling.render_frame_banded(scene, info, ibl, env, s1, m1,
                                               width=w, height=h, **kw)
        out = tm.execute(scene, info, est, width=w, height=h,
                         settings=settings)
        est = out.state
        _color_ok(c4, f"banded frame {i}", w, h)
        e_exec = float(((c4 - out.color).abs()
                        / (4e-3 + 4e-3 * out.color.abs())).max())
        e_one = float(((c4 - c1).abs() / (2e-3 + 2e-3 * c1.abs())).max())
        d_exec = float((c4 - out.color).abs().max())
        d_one = float((c4 - c1).abs().max())
        errs.append(dict(vs_execute_max_abs=d_exec, vs_one_band_max_abs=d_one))
        print(f"banded frame {i}: {n} bands against execute max abs diff "
              f"{d_exec:.3g} ({e_exec:.3f} of the 4e-3 bound), against one "
              f"band {d_one:.3g} ({e_one:.3f} of the 2e-3 bound)", flush=True)
        check(e_exec <= 1.0, f"banded frame {i} against execute: {d_exec}")
        check(e_one <= 1.0, f"banded frame {i}, 4 bands against 1: {d_one}")
    check([t.device for t in s4.taa_color] == band_sharding(m4),
          "the banded state is not on its bands' devices")

    def timed(fn):
        host, dev = [], []
        for _ in range(frames):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            fn()
            ev1.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(ev0.elapsed_time(ev1))
        return float(np.median(host)), float(np.median(dev))
    st = [s4]

    def banded_frame():
        _, st[0], _ = tiling.render_frame_banded(scene, info, ibl, env, st[0],
                                                 m4, width=w, height=h, **kw)
    zero_launches()
    banded_ms = timed(banded_frame)
    launches = read_launches()
    for name, per in BANDED_LAUNCHES.items():
        check(launches[name] == per * frames,
              f"banded frame: {name} launched {launches[name]} times in "
              f"{frames} frames, expected {per} a frame")
    est_box = [est]

    def execute_frame():
        est_box[0] = tm.execute(scene, info, est_box[0], width=w, height=h,
                                settings=settings).state
    execute_ms = timed(execute_frame)
    print(f"banded_frame_ms_median {banded_ms[0]:.3f} (CUDA events "
          f"{banded_ms[1]:.3f}), execute on the same scene {execute_ms[0]:.3f}"
          f" ({execute_ms[1]:.3f}) over {frames} frames at {w}x{h}, {n} bands "
          f"on one card; launches {launches}", flush=True)
    return dict(k1=k1, k4_bands=k4_bands, k3=k3, launches=launches,
                forward_launches=fwd_launches, frame_errors=errs,
                frame_ms_median=banded_ms[0],
                frame_events_ms_median=banded_ms[1],
                execute_ms_median=execute_ms[0],
                execute_events_ms_median=execute_ms[1], frames=frames)


def small_split_frames(device):
    """Two 256x128 cfg5 frames of the atrium with 4 columns through
    execute_split with 4 bands, on the CPU path and on `device`:
    (cpu colour, colour)."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ci = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=32,
                               num_specular_env_samples=16)
    cfg = cfg5_raster_config()
    ref = PBRRenderer(ci, raster_cfg=cfg, device="cpu")
    colors = []
    for dev in ("cpu", device):
        ren = (ref if dev == "cpu" else
               PBRRenderer(ci, raster_cfg=cfg, device=dev,
                           env_oct=ref.env_oct, ibl_maps=ref.ibl_maps.to(dev)))
        tm = HnTaskManager(ren, cfg5_task_manager_ci())
        scene = full_chain_scene(4, device=dev)
        info = cfg5_info(SMALL_W, SMALL_H, dev)
        state = tm.initial_state(SMALL_W, SMALL_H)
        for _ in range(2):
            out = tm.execute_split(scene, info, state, width=SMALL_W,
                                   height=SMALL_H, settings=bench_settings(),
                                   gbuffer_bands=SPLIT_BANDS)
            state = out.state
        colors.append(out.color.cpu().numpy())
    return colors[0], colors[1]


def small_banded_frames(device, n_bands=2):
    """Two 256x128 banded frames of phase 32's scene over `n_bands` bands,
    on the CPU path (a mesh of the CPU repeated) and on `device`:
    (cpu colour, colour)."""
    import torch
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.parallel import mesh as pmesh
    from diligentfx_tpu_torch.parallel import tiling
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    from diligentfx_tpu_torch.postfx.context import taa_jitter_sequence
    ci = PBRRendererCreateInfo(brdf_lut_dim=32, num_brdf_samples=16,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=32,
                               num_specular_env_samples=16)
    cfg = banded_raster_config()
    ref = PBRRenderer(ci, raster_cfg=cfg, device="cpu")
    colors = []
    for dev in ("cpu", device):
        ren = (ref if dev == "cpu" else
               PBRRenderer(ci, raster_cfg=cfg, device=dev,
                           env_oct=ref.env_oct, ibl_maps=ref.ibl_maps.to(dev)))
        d = torch.device("cpu") if dev == "cpu" else torch.device(dev, 0)
        mesh = pmesh.make_render_mesh(devices=[d] * n_bands, dp=1,
                                      sp=n_bands)
        scene = banded_scene(dev)
        info = banded_info(SMALL_W, SMALL_H, dev)
        state = tiling.initial_banded_state(SMALL_W, SMALL_H, mesh)
        kw = banded_kw(cfg, taa_jitter_sequence(16, dev))
        for _ in range(2):
            _, state, color = tiling.render_frame_banded(
                scene, info, ren.ibl_maps, ren.env_oct, state, mesh,
                width=SMALL_W, height=SMALL_H, **kw)
        colors.append(color.cpu().numpy())
    return colors[0], colors[1]


def phase_split_banded_reference():
    """Phase 33: the 256x128 execute_split (4 bands) and banded (2 bands)
    frames on the GPU against the port's CPU path, above 50 dB."""
    from diligentfx_tpu_torch.utils.image import psnr
    out = {}
    for name, fn in (("execute_split (4 bands)", small_split_frames),
                     ("render_frame_banded (2 bands)", small_banded_frames)):
        cpu, gpu = fn(DEVICE)
        p = psnr(cpu, gpu)
        print(f"256x128 {name}, GPU vs the port's CPU path: PSNR {p:.2f} dB,"
              f" max abs diff {np.abs(cpu - gpu).max():.3g}", flush=True)
        check(np.isfinite(gpu).all(), f"small {name} frame not finite")
        check(p > 50.0, f"GPU {name} frame disagrees with the CPU path: "
                        f"{p:.2f} dB")
        out[name] = p
    return out


def split4k_only(frames, out_png):
    """Phases 30 and 31 alone: K1 at the 4K cfg5 inputs and the 4K frame
    through execute_split."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    cfg = cfg5_raster_config()
    scene = full_chain_scene(CFG5_COLUMNS)
    t0 = time.perf_counter()
    k1 = phase_split4k_raster(scene, cfg)
    ibl = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg, device=DEVICE)
    frame = phase_split4k_frame(cfg, scene, frames, out_png, ibl)
    return dict(k1_4k_inputs=k1, split4k_frame=frame,
                seconds=time.perf_counter() - t0)


def banded_only(frames):
    """Phases 32 and 33 alone: the banded frame's kernels and frames, and
    the 256x128 frames against the CPU path."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    t0 = time.perf_counter()
    ibl = PBRRenderer(PBRRendererCreateInfo(),
                      raster_cfg=banded_raster_config(), device=DEVICE)
    banded = phase_banded(frames, ibl)
    t1 = time.perf_counter()
    p = phase_split_banded_reference()
    return dict(banded=banded, psnr=p,
                phase_seconds=[t1 - t0, time.perf_counter() - t1])


INV_W, INV_H, INV_VIEWS = 1920, 1088, 4        # four bands of 272 rows
INV_DP, INV_SP = 2, 4                          # __graft_entry__.py:117-119
INV_ORBIT = (7.5, 1.0, 0.5)    # radius, eye height (the bench camera's) and
#                                the largest angle, rad, of the views
INV_NOISE = 0.2                # the start colours' seeded noise, +-
INV_SEED = 15
# a step on dp 2 x sp 4: K4 once a band of each view; the backward and
# the update launch no kernel
INV_LAUNCHES = {**{k: 0 for k in FRAME_LAUNCHES},
                "raster_tiles": INV_VIEWS * INV_SP}
INV_MESH_BOUND = 1e-5          # 2 x 4 against 1 x 1: loss relative, and of
#                                the largest |gradient|
INV_CPU_BOUND = (1e-5, 1e-4)   # the 64x64 dry run, card against the CPU


def inverse_raster_config():
    """bench_raster_config with 16-row tiles (1088 rows: four bands of 17
    tile rows) and one sub-bin (K4 bins unsegmented); lists of 512: the
    longest of the four views' lists, whole or in a band, is 336 (printed
    by phase 34)."""
    from diligentfx_tpu_torch.config import RasterizerConfig
    return RasterizerConfig(tile_h=16, tile_w=128, bin_capacity=512,
                            max_tiles_per_tri=8, big_tri_capacity=64, chunk=8,
                            pair_compaction_cap=1 << 17)


def inverse_problem(device):
    """The step's scene (the bench scene, its lights), the viewport and the
    four views on the orbit around the spheres: (problem, cameras)."""
    from diligentfx_tpu_torch import entry
    from diligentfx_tpu_torch.pbr.renderer import default_env_oct
    radius, eye_y, angle = INV_ORBIT
    problem = entry.InverseProblem(
        scene=bench_scene(5, 9, 32, device),
        info=render_info(INV_W, INV_H, device), env_oct=default_env_oct(device),
        cfg=inverse_raster_config(), width=INV_W, height=INV_H)
    cams = entry.make_cams(
        np.linspace(-angle, angle, INV_VIEWS, dtype=np.float32), width=INV_W,
        height=INV_H, radius=radius, eye_y=eye_y, far=100.0, device=device)
    return problem, cams


def inverse_raster_stats(problem, cams):
    """Each view's setup and binning over the whole frame and over each
    band window: the longest tile list, the dropped pairs and big
    triangles."""
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.parallel.tiling import band_layout
    from diligentfx_tpu_torch.pbr.renderer import transform_vertices
    scene, cfg = problem.scene, problem.cfg
    world_pos, _, _ = transform_vertices(scene)
    out = []
    for i, cam in enumerate(cams):
        clip = m3.transform_points(world_pos, cam.view_proj)
        for y0, rows in [(0, INV_H)] + band_layout(INV_H, INV_SP, cfg):
            setup, valid, bbox, _, clip_ovf = rz._triangle_setup(
                clip, scene.indices, INV_W, rows, scene.tri_double_sided,
                True, 1e-3, screen_size=(INV_W, INV_H), screen_offset=(0, y0))
            _, _, most, ovf, big_ovf = rz._bin_triangles(valid, bbox, INV_W,
                                                         rows, cfg)
            out.append(dict(view=i, y0=y0, rows=rows, longest=int(most),
                            bin_overflow=int(ovf) + int(clip_ovf),
                            big_overflow=int(big_ovf)))
    return out


def _timed_ms(fn):
    """(result, host ms ending in a synchronize, CUDA events ms) of fn()."""
    import torch
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0.record()
    out = fn()
    ev1.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, ev0.elapsed_time(ev1)


def inverse_profile(fn, label, top=6):
    """torch.profiler over one call of fn: its wall ms (ending in a
    synchronize), the device's busy ms (the kernel rows' self device
    time), the launches and the `top` kernels by device time.  Taken
    apart for the forward and the backward: autograd runs the backward's
    CUDA work on a thread of its own, outside the caller's ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((_device_us(e, "self_device_time_total") / 1e3, e.count,
                    e.key) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and _device_us(e, "self_device_time_total") > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"profile inverse {label}: {wall:.3f} ms under the profiler, device"
          f" busy {busy:.3f} ms ({100 * busy / wall:.1f}%), {launches} kernel"
          f" launches", flush=True)
    for ms, n, key in rows[:top]:
        print(f"profile inverse {label} kernel {ms:.4f} ms x{n} {key[:90]}",
              flush=True)
    return out, dict(wall_ms=wall, device_busy_ms=busy, launches=launches,
                     top=[dict(ms=ms, launches=n, name=key[:90])
                          for ms, n, key in rows[:top]])


def phase_inverse(steps):
    """Phase 34: the inverse-rendering step of entry.py (the port of
    __graft_entry__.py's dry run) at full width: the bench scene at 1920 x
    1088, four views over dp 2 x sp 4 of the one card."""
    import torch
    from diligentfx_tpu_torch import entry
    from diligentfx_tpu_torch.parallel.mesh import make_render_mesh
    from diligentfx_tpu_torch.utils.image import psnr
    t_phase = time.perf_counter()
    card = torch.device(DEVICE, 0)
    problem, cams = inverse_problem(DEVICE)
    scene = problem.scene
    print(f"inverse step: the bench scene, {scene.num_triangles} triangles, "
          f"{scene.materials.base_color_factor.shape[0]} materials, "
          f"{INV_VIEWS} views at {INV_W}x{INV_H} over dp {INV_DP} x sp "
          f"{INV_SP} of one card", flush=True)
    stats = inverse_raster_stats(problem, cams)
    longest = max(s["longest"] for s in stats)
    print(f"inverse step raster: longest list {longest} of "
          f"{problem.cfg.bin_capacity}; whole frames "
          f"{[s['longest'] for s in stats if s['rows'] == INV_H]}, bands "
          f"{[s['longest'] for s in stats if s['rows'] != INV_H]}", flush=True)
    check(all(s["bin_overflow"] == 0 and s["big_overflow"] == 0
              for s in stats), f"the inverse step's raster drops: {stats}")
    # K4 at each band of view 0 against its plain version
    info0 = problem.info._replace(camera=cams[0])
    k4_bands = []
    band_h = INV_H // INV_SP
    for b in range(INV_SP):
        args, kw = forward_band_inputs(scene, info0, problem.cfg, b * band_h,
                                       band_h, INV_W, INV_H)
        k4_bands.append(dict(k4_against_plain(
            args, kw, f"at inverse band {b} (screen_offset (0, "
                      f"{b * band_h}))", may_be_empty=True),
            screen_offset=[0, b * band_h]))
    # the targets: the views at the scene's own colours
    base = scene.materials.base_color_factor
    with torch.no_grad():
        targets = torch.stack([entry.render_one(base, c, problem)
                               for c in cams])
    rng = np.random.default_rng(INV_SEED)
    noise = rng.uniform(-INV_NOISE, INV_NOISE, (base.shape[0], 3))
    params = base.clone()
    params[:, :3] = torch.clamp(params[:, :3] + torch.as_tensor(
        noise, dtype=torch.float32, device=DEVICE), 0.0, 1.0)
    mesh = make_render_mesh(dp=INV_DP, sp=INV_SP,
                            devices=[card] * (INV_DP * INV_SP))
    one = make_render_mesh(dp=1, sp=1, devices=[card])
    # 2 x 4 against 1 x 1 at the start, with each one's launches
    zero_launches()
    loss_m, grads_m = entry.loss_and_grad(params, cams, targets, mesh,
                                          problem)
    torch.cuda.synchronize()
    launches_m = read_launches()
    zero_launches()
    loss_1, grads_1 = entry.loss_and_grad(params, cams, targets, one, problem)
    torch.cuda.synchronize()
    launches_1 = read_launches()
    g_scale = float(grads_1.abs().max())
    loss_rel = abs(float(loss_m) - float(loss_1)) / float(loss_1)
    grad_rel = float((grads_m - grads_1).abs().max()) / g_scale
    print(f"inverse step, dp {INV_DP} x sp {INV_SP} against 1 x 1: loss "
          f"{float(loss_m):.9g} / {float(loss_1):.9g} (relative "
          f"{loss_rel:.3g}), gradients max diff {grad_rel:.3g} of the largest"
          f" |g| {g_scale:.6g}; K4 launches {launches_m['raster_tiles']} / "
          f"{launches_1['raster_tiles']}", flush=True)
    check(bool(torch.isfinite(loss_m)) and bool(torch.isfinite(grads_m).all())
          and bool(torch.isfinite(grads_1).all()),
          "the inverse step's loss or gradients are not finite")
    check(g_scale > 0.0, "the inverse step's gradients are all zero")
    check(loss_rel <= INV_MESH_BOUND and grad_rel <= INV_MESH_BOUND,
          f"the inverse step on dp {INV_DP} x sp {INV_SP} differs from 1 x "
          f"1: {loss_rel} {grad_rel}")
    check(launches_m == INV_LAUNCHES and launches_1 == {
        **INV_LAUNCHES, "raster_tiles": INV_VIEWS},
          f"inverse step launches {launches_m}, 1 x 1 {launches_1}")
    del grads_m, grads_1
    # one warm-up step, its peak memory; then the timed steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p, first = entry.train_step(params, cams, targets, mesh, problem)
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [float(first)]
    host, dev = [], []
    zero_launches()
    for _ in range(steps):
        (p, loss), h_ms, d_ms = _timed_ms(
            lambda: entry.train_step(p, cams, targets, mesh, problem))
        host.append(h_ms)
        dev.append(d_ms)
        losses.append(float(loss))
    launches = read_launches()
    check(all(launches[k] == n * steps for k, n in INV_LAUNCHES.items()),
          f"inverse steps: launches {launches} in {steps} steps, expected "
          f"{INV_LAUNCHES} a step")
    with torch.no_grad():
        last = float(entry.loss_fn(p, cams, targets, mesh, problem))
    losses.append(last)
    print(f"inverse step losses (warm-up, {steps} steps, after): "
          f"{[round(x, 9) for x in losses]}", flush=True)
    check(all(np.isfinite(losses)) and bool(torch.isfinite(p).all()),
          "the inverse steps went non-finite")
    check(last < losses[0], f"the loss did not fall: {losses}")
    # forward and backward apart, as train_step runs them
    fwd, bwd = [], []
    for _ in range(3):
        leaf = p.detach().requires_grad_(True)
        loss, f_host, f_dev = _timed_ms(
            lambda: entry.loss_fn(leaf, cams, targets, mesh, problem))
        zero_launches()
        _, b_host, b_dev = _timed_ms(lambda: torch.autograd.grad(loss, leaf))
        bwd_launches = read_launches()
        check(sum(bwd_launches.values()) == 0,
              f"the backward launched {bwd_launches}")
        fwd.append((f_host, f_dev))
        bwd.append((b_host, b_dev))
        del loss, leaf
    # where a step's time goes: the forward and the backward profiled
    leaf = p.detach().requires_grad_(True)
    loss, fwd_prof = inverse_profile(
        lambda: entry.loss_fn(leaf, cams, targets, mesh, problem), "forward")
    _, bwd_prof = inverse_profile(lambda: torch.autograd.grad(loss, leaf),
                                  "backward")
    del loss, leaf
    # the dry run's 64x64 step, on the card and on the CPU path
    t_dry = time.perf_counter()
    r_gpu = entry.dryrun(make_render_mesh(dp=2, sp=4, devices=[card] * 8))
    r_cpu = entry.dryrun(make_render_mesh(dp=2, sp=4, devices=["cpu"] * 8))
    d_scale = float(r_cpu.grads.abs().max())
    d_loss = abs(float(r_gpu.loss) - float(r_cpu.loss)) / float(r_cpu.loss)
    d_grad = float((r_gpu.grads.cpu() - r_cpu.grads).abs().max()) / d_scale
    print(f"dry run 64x64 step, card against the CPU path: loss "
          f"{float(r_gpu.loss):.9g} / {float(r_cpu.loss):.9g} (relative "
          f"{d_loss:.3g}), gradients max diff {d_grad:.3g} of {d_scale:.6g}",
          flush=True)
    check(d_loss <= INV_CPU_BOUND[0] and d_grad <= INV_CPU_BOUND[1],
          f"the dry run's step on the card differs from the CPU path: "
          f"{d_loss} {d_grad}")
    # entry()'s frame, on the card (the fused route) and on the CPU path
    fn, args = entry.entry()
    frame = fn(*args).cpu().numpy()
    fn_cpu, args_cpu = entry.entry(device="cpu")
    ref = fn_cpu(*args_cpu).numpy()
    entry_db = psnr(ref, frame)
    print(f"entry() frame {frame.shape}, card against the CPU path: PSNR "
          f"{entry_db:.2f} dB, max abs diff {np.abs(ref - frame).max():.3g}",
          flush=True)
    check(np.isfinite(frame).all() and entry_db > 50.0,
          f"entry()'s frame disagrees with the CPU path: {entry_db:.2f} dB")
    dry_s = time.perf_counter() - t_dry
    med = {name: float(np.median([x[i] for x in rows]))
           for name, rows, i in (("fwd_host", fwd, 0), ("fwd_dev", fwd, 1),
                                 ("bwd_host", bwd, 0), ("bwd_dev", bwd, 1))}
    step_ms, step_dev = float(np.median(host)), float(np.median(dev))
    print(f"inverse_step_ms_median {step_ms:.3f} (CUDA events {step_dev:.3f})"
          f" over {steps} steps; forward {med['fwd_host']:.3f} "
          f"({med['fwd_dev']:.3f}), backward {med['bwd_host']:.3f} "
          f"({med['bwd_dev']:.3f}); peak {peak_mb:.1f} MB a step; K4 "
          f"{launches['raster_tiles'] / steps:g}, K1 "
          f"{launches['raster_tiles_fused'] / steps:g} a step; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(k4_bands=k4_bands, raster_longest=longest,
                launches=launches, steps=steps, step_ms_median=step_ms,
                step_events_ms_median=step_dev,
                step_ms=host, step_events_ms=dev,
                forward_ms_median=med["fwd_host"],
                forward_events_ms_median=med["fwd_dev"],
                backward_ms_median=med["bwd_host"],
                backward_events_ms_median=med["bwd_dev"],
                peak_mb=peak_mb, losses=losses,
                profile=dict(forward=fwd_prof, backward=bwd_prof),
                mesh_loss_rel=loss_rel, mesh_grad_rel=grad_rel,
                dryrun_loss_rel=d_loss, dryrun_grad_rel=d_grad,
                entry_psnr=entry_db, dryrun_entry_seconds=dry_s,
                seconds=time.perf_counter() - t_phase)


def inverse_only(steps):
    """Phase 34 alone: the inverse-rendering step."""
    return dict(inverse=phase_inverse(steps))


# ---------------------------------------------------------------------------
# the rest of BASELINE.json: configurations 1-3 of the port's
# examples/benchmark_suite.py (phases 35-37)
# ---------------------------------------------------------------------------

CFG1_SIZE = 512                # render_mr_spheres.py at BASELINE.json's size
CFG2_TRIANGLES = 27362         # uv_sphere(1.2, 96, 144): 27,360, and the plane
CFG3_TRIANGLES = 165152        # sponza_like_scene(), 24 columns
NO_LAUNCHES = {"raster_tiles_fused": 0, "warp_bilinear": 0,
               "march_small_table": 0, "gtao_fused": 0, "raster_tiles": 0,
               "warp_bilinear_multi": 0}
# launches a frame: cfg1 the fused forward frame (K1); cfg2 the four
# cascades (K4) and the fused forward frame (K1); cfg3 execute's fused
# G-buffer (K1), SSR off the kernel route (K3 0) and K2 at the warm-up
# frame's count (disocclusion and SSAO taps), printed
CFG1_LAUNCHES = {**NO_LAUNCHES, "raster_tiles_fused": 1}
CFG2_LAUNCHES = {**NO_LAUNCHES, "raster_tiles_fused": 1, "raster_tiles": 4}
CFG3_FIXED = {k: v for k, v in CFG1_LAUNCHES.items() if k != "warp_bilinear"}
SMALL_IBL = dict(brdf_lut_dim=32, num_brdf_samples=16, irradiance_cube_dim=16,
                 prefiltered_env_map_dim=32, num_specular_env_samples=16)


def _stats_dict(st):
    return {f: int(v) for f, v in zip(st._fields, st)}


def _cpu(x):
    import torch
    return x.cpu() if isinstance(x, torch.Tensor) else x


def cpu_fused_stats(call):
    """The raster statistics of a recorded rz.prepare_fused call, its
    inputs copied to the CPU and set up and binned there (the CPU path)."""
    from diligentfx_tpu_torch.ops import raster as rz
    args, kwargs, _ = call
    k = rz.prepare_fused(*map(_cpu, args),
                         **{n: _cpu(v) for n, v in kwargs.items()})
    return _stats_dict(k.stats)


def cpu_raster_stats(call):
    """The raster statistics of a recorded rz.rasterize call (the two-pass
    raster of a cascade), its inputs copied to the CPU and set up and
    binned there (rz.rasterize's statistics without its tile raster)."""
    import torch
    from diligentfx_tpu_torch.ops import raster as rz
    (clip, indices), kw, _ = call
    w, h, cfg = kw["width"], kw["height"], kw["cfg"]
    ds = kw.get("double_sided")
    setup, valid, bbox, _, clip_ovf = rz._triangle_setup(
        clip.cpu(), indices.cpu(), w, h, None if ds is None else ds.cpu(),
        kw.get("front_ccw", True), kw.get("near_eps", 1e-3))
    _, _, max_count, overflow, big_overflow = rz._bin_triangles(
        valid, bbox, w, h, cfg)
    return _stats_dict(rz.RasterStats(
        max_bin_count=max_count, bin_overflow=overflow + clip_ovf,
        big_overflow=big_overflow, num_culled=(~valid).sum()))


def stats_against_cpu(device_stats, cpu_stats, label):
    """Hold the card's raster statistics to the CPU path's, field by
    field; print both and the (tile, triangle) pairs and big triangles
    dropped."""
    print(f"{label} raster statistics on the card {device_stats}, on the "
          f"CPU path {cpu_stats}; dropped pairs "
          f"{device_stats['bin_overflow']}, big triangles dropped "
          f"{device_stats['big_overflow']}", flush=True)
    check(device_stats == cpu_stats, f"{label}: the card's raster "
          f"statistics {device_stats} are not the CPU path's {cpu_stats}")


def timed_steps(bc, frames, label, expected, warm_launches=None):
    """`frames` timed bc.step(i) (host clock ending in a synchronise, CUDA
    events beside it), with the launch counts zeroed just before and read
    just after, each held to `expected` a frame, and any kernel not in it
    to `warm_launches` (the warm-up frame's).  Returns (host ms, events ms,
    launches)."""
    import torch
    zero_launches()
    host_ms, dev_ms = [], []
    color = None
    for i in range(frames):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        color = bc.step(i)
        ev1.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(ev0.elapsed_time(ev1))
    launches = read_launches()
    want = {**(warm_launches or {}), **expected}
    for name, n in want.items():
        check(launches[name] == n * frames,
              f"{label}: {name} launched {launches[name]} times in {frames} "
              f"frames, expected {n} a frame")
    _color_ok(color, f"{label} frame", bc.width, bc.height)
    print(f"{label} frame {bc.width}x{bc.height}: median "
          f"{np.median(host_ms):.3f} ms host clock, {np.median(dev_ms):.3f} "
          f"ms CUDA events, min {min(host_ms):.3f}, max {max(host_ms):.3f} "
          f"({frames} frames), mean color {float(color.mean()):.4f}; "
          f"launches a frame { {k: v // frames for k, v in launches.items()} }",
          flush=True)
    return host_ms, dev_ms, launches


def small_baseline_frames(build, device, **kw):
    """Two frames of a benchmark_suite configuration built small by
    `build(device, ibl_from=...)` on the CPU path and on `device`, on one
    small IBL: (cpu colour, colour)."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ref = PBRRenderer(PBRRendererCreateInfo(**SMALL_IBL), device="cpu")
    colors = []
    for dev in ("cpu", device):
        bc = build(dev, ibl_from=ref, **kw)
        for i in range(2):
            color = bc.step(i)
        colors.append(color.cpu().numpy())
    return colors[0], colors[1]


def small_baseline_against_cpu(build, label, **kw):
    """small_baseline_frames on the card against the CPU path, above 50
    dB; returns the PSNR."""
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu = small_baseline_frames(build, DEVICE, **kw)
    p = psnr(cpu, gpu)
    print(f"{label}, GPU vs the port's CPU path: PSNR {p:.2f} dB, max abs "
          f"diff {np.abs(cpu - gpu).max():.3g}", flush=True)
    check(np.isfinite(gpu).all(), f"small {label} not finite")
    check(p > 50.0, f"GPU {label} disagrees with the CPU path: {p:.2f} dB")
    return p


def _warm_up(bc, label, **targets):
    """bc.step(0) with the launch counts zeroed just before and read just
    after, its calls of `targets` recorded (frame_captures)."""
    import torch
    from diligentfx_tpu_torch.ops import raster as rz
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    _, calls = frame_captures(lambda: bc.step(0),
                              k1=(rz, "prepare_fused"), **targets)
    torch.cuda.synchronize()
    warm = read_launches()
    print(f"{label} warm-up frame: {time.perf_counter() - t0:.2f} s, "
          f"launches {warm}", flush=True)
    check(len(calls["k1"]) == warm["raster_tiles_fused"] == 1,
          f"{label}: the frame built {len(calls['k1'])} K1 input sets and "
          f"launched K1 {warm['raster_tiles_fused']} times, expected 1")
    return warm, calls


def _phase_result(bc, host_ms, dev_ms, launches, frames, t0, **more):
    return dict(frame_ms_median=float(np.median(host_ms)),
                frame_events_ms_median=float(np.median(dev_ms)),
                frame_ms_mean=float(np.mean(host_ms)), launches=launches,
                frames=frames, width=bc.width, height=bc.height,
                triangles=bc.scene.num_triangles, metric=bc.metric,
                seconds=time.perf_counter() - t0, **more)


def phase_cfg1(frames):
    """Phase 35: configuration 1, the mr_spheres grid (16 spheres of
    uv_sphere(0.42, 24, 32)) through PBRRenderer.render at 512 x 512 with
    its own small IBL: K1 (8 x 128 tiles, lists of 4,096, chunk 32) against
    its plain version at the frame's inputs, the raster statistics against
    the CPU path's, --frames timed frames (K1 1 a frame), a 128 x 128 copy
    against the CPU path."""
    t0 = time.perf_counter()
    bench = suite()
    bc = bench.config_1_mr_spheres(device=DEVICE, size=CFG1_SIZE)
    print(f"cfg1 mr_spheres: {bc.scene.num_triangles} triangles at "
          f"{CFG1_SIZE}x{CFG1_SIZE}, lists of {bc.cfg.bin_capacity}",
          flush=True)
    warm, calls = _warm_up(bc, "cfg1")
    check(warm == CFG1_LAUNCHES, f"cfg1 warm-up launches {warm}")
    k = calls["k1"][0][2]
    stats_against_cpu(_stats_dict(k.stats), cpu_fused_stats(calls["k1"][0]),
                      "cfg1")
    k1 = phase_raster(None, None, bc.cfg, label="cfg1", width=CFG1_SIZE,
                      height=CFG1_SIZE, inputs=k)
    del calls, k
    host_ms, dev_ms, launches = timed_steps(bc, frames, "cfg1", CFG1_LAUNCHES)
    p = small_baseline_against_cpu(bench.config_1_mr_spheres,
                                   "128x128 cfg1 frame", size=128)
    return _phase_result(bc, host_ms, dev_ms, launches, frames, t0, k1=k1,
                         small_psnr=p)


def phase_cfg2(frames, ibl_source):
    """Phase 36: configuration 2, a sphere of 27,360 triangles over a 40 m
    plane at 1920 x 1080: per frame four 2048^2 cascades (K4), EVSM2
    moments and their blur, PBRRenderer.render with the cascades (the
    fused forward, K1).  K4 bit for bit at each cascade's inputs and K1 at
    the frame's against their plain versions; each cascade's raster
    statistics against the CPU path's; the fused forward with EVSM2
    against its two-pass branch on the card; --frames timed frames (K4 4,
    K1 1 a frame); a 256 x 128 copy with 256^2 cascades against the CPU
    path."""
    import torch
    from diligentfx_tpu_torch.config import ShadowMode
    from diligentfx_tpu_torch.ops import raster as rz
    from diligentfx_tpu_torch.ops import raster_tiles as rt
    from diligentfx_tpu_torch.utils.image import psnr
    t0 = time.perf_counter()
    bench = suite()
    bc = bench.config_2_shadows(device=DEVICE, ibl_from=ibl_source)
    print(f"cfg2 shadows: {bc.scene.num_triangles} triangles at "
          f"{bc.width}x{bc.height}, {NUM_CASCADES} cascades of "
          f"{SHADOW_SIZE}^2", flush=True)
    check(bc.scene.num_triangles == CFG2_TRIANGLES, "cfg2's triangles")
    warm, calls = _warm_up(bc, "cfg2", k4=(rt, "_launch"),
                           cascades=(rz, "rasterize"))
    check(warm == CFG2_LAUNCHES, f"cfg2 warm-up launches {warm}")
    check(len(calls["k4"]) == len(calls["cascades"]) == NUM_CASCADES,
          f"cfg2: {len(calls['k4'])} K4 launches in the warm-up frame")
    stats = []
    for i, call in enumerate(calls["cascades"]):
        st = _stats_dict(call[2][1])
        stats_against_cpu(st, cpu_raster_stats(call), f"cfg2 cascade {i}")
        stats.append(st)
    k4_cascades = []
    for i, (args, kw, _) in enumerate(calls["k4"]):
        k4_cascades.append(dict(k4_against_plain(
            args, kw, f"at cfg2 cascade {i}"), cascade=i))
    k = calls["k1"][0][2]
    stats_against_cpu(_stats_dict(k.stats), cpu_fused_stats(calls["k1"][0]),
                      "cfg2 forward frame")
    k1 = phase_raster(None, None, bc.cfg, label="cfg2", width=bc.width,
                      height=bc.height, inputs=k)
    del calls, k
    # the fused forward frame with EVSM2 against its two-pass branch (K4)
    info = bc.last["info"]
    frames_by = {}
    for fuse in ("on", "off"):
        zero_launches()
        frames_by[fuse] = bc.renderer.render(
            bc.scene, info, width=bc.width, height=bc.height,
            shadow_mode=ShadowMode.EVSM2, fuse=fuse)
        torch.cuda.synchronize()
        got = read_launches()
        check(got == {**NO_LAUNCHES, "raster_tiles_fused": int(fuse == "on"),
                      "raster_tiles": int(fuse == "off")},
              f"cfg2 forward fuse={fuse} launched {got}")
    a, b = (frames_by[f].cpu().numpy() for f in ("on", "off"))
    branch_psnr = psnr(b, a)
    print(f"cfg2 forward frame, fused (K1) against two-pass (K4) on the "
          f"card: PSNR {branch_psnr:.2f} dB, max abs diff "
          f"{np.abs(a - b).max():.3g}", flush=True)
    check(branch_psnr > 50.0, f"cfg2's fused and two-pass branches differ: "
                              f"{branch_psnr:.2f} dB")
    maps = bc.last["shadow_maps"]
    cover = [round(float((m < 1.0).float().mean()), 4) for m in maps]
    print(f"cfg2 shadow maps: caster coverage by cascade {cover}", flush=True)
    check(bool(torch.isfinite(bc.last["shadow_moments"]).all()),
          "cfg2 moments not finite")
    del frames_by, info
    host_ms, dev_ms, launches = timed_steps(bc, frames, "cfg2", CFG2_LAUNCHES)
    p = small_baseline_against_cpu(bench.config_2_shadows,
                                   "256x128 cfg2 frame (256^2 cascades)",
                                   width=SMALL_W, height=SMALL_H,
                                   shadow_map_size=256)
    k4 = dict(max_abs_err=0.0, cascades=k4_cascades, cascade_stats=stats,
              **{key: sum(c[key] for c in k4_cascades)
                 for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                             "candidate_pixel_tests")},
              bound_by="/".join(sorted({c["bound_by"] for c in k4_cascades})))
    return _phase_result(bc, host_ms, dev_ms, launches, frames, t0, k1=k1,
                         k4=k4, branch_psnr=branch_psnr, small_psnr=p,
                         caster_coverage=cover)


def k2_launches_against_plain(launches, label):
    """K2 vs warp_bilinear_plain at each recorded launch (img, offsets,
    halo rows, halo columns) of a frame, exactly; the set timed (CUDA
    events and device time) beside its plain version and grid_sample on
    the same inputs, with its bound (phase 3's count over every pixel of
    each launch)."""
    import torch
    from diligentfx_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_plain
    shapes = {}
    for img, off, hr, hc in launches:
        key = f"{tuple(img.shape)} halo ({hr}, {hc})"
        shapes[key] = shapes.get(key, 0) + 1
        a = warp_bilinear(img, off, halo_r=hr, halo_c=hc)
        torch.cuda.synchronize()
        b = warp_bilinear_plain(img, off, halo_r=hr, halo_c=hc)
        err = float((a - b).abs().max())
        check(err == 0.0, f"K2 differs from its plain version {label} at "
                          f"{key}: {err}")
    libs = [_grid_sample_fn(img, off) for img, off, _, _ in launches]

    def k2_all():
        for img, off, hr, hc in launches:
            warp_bilinear(img, off, halo_r=hr, halo_c=hc)

    def plain_all():
        for img, off, hr, hc in launches:
            warp_bilinear_plain(img, off, halo_r=hr, halo_c=hc)

    def lib_all():
        for lib in libs:
            lib()
    n_bytes = n_ops = 0
    for img, off, _, _ in launches:
        px = off.shape[0] * off.shape[1]
        c = img.shape[2] if img.dim() == 3 else 1
        n_bytes += 4 * px * (2 * c + 2)
        n_ops += px * (20 + 9 * c)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    res = dict(max_abs_err=0.0, launches_checked=len(launches),
               shapes=shapes, ms=cuda_ms(k2_all, 20, 2),
               device_ms=kernel_device_ms(k2_all, K2_KERNELS, 10),
               plain_ms=cuda_ms(plain_all, 3, 1),
               library_ms=cuda_ms(lib_all, 20, 2),
               library_device_ms=kernel_device_ms(lib_all, "grid_sampler", 10),
               bound_ms=b_ms, bound_by=b_by)
    print(f"warp_bilinear {label}: {len(launches)} launches {shapes}, all "
          f"exact; {res['ms']:.4f} ms CUDA events, device "
          f"{res['device_ms']:.4f}, plain {res['plain_ms']:.3f}, grid_sample "
          f"{res['library_ms']:.4f} / device {res['library_device_ms']:.4f};"
          f" bound {b_ms:.4f} ms ({b_by})", flush=True)
    return res


def phase_cfg3(frames, ibl_source):
    """Phase 37: configuration 3, the 24-column atrium (165,152 triangles)
    through HnTaskManager.execute at 1920 x 1080 (32 x 128 tiles, lists of
    1,536, sub_bins 1; SSAO at half resolution on the per-tap warp route,
    SSR at half resolution off the kernel route, no TAA, no bloom).  The
    raster statistics (the pairs the lists drop) against the CPU path's at
    the frame's inputs; K1 against its plain version there and K2 at each
    of the frame's launches; --frames timed frames (K1 1, K3 0 and K2 the
    warm-up frame's count a frame); a 256 x 128 copy of the atrium with 4
    columns against the CPU path."""
    import torch
    from diligentfx_tpu_torch.ops import warp
    t0 = time.perf_counter()
    bench = suite()
    bc = bench.config_3_sponza(device=DEVICE, ibl_from=ibl_source)
    print(f"cfg3 atrium: {bc.scene.num_triangles} triangles at "
          f"{bc.width}x{bc.height}, lists of {bc.cfg.bin_capacity}",
          flush=True)
    check(bc.scene.num_triangles == CFG3_TRIANGLES, "cfg3's triangles")
    warm, calls = _warm_up(bc, "cfg3", k2=(warp, "_launch"))
    for name, n in CFG3_FIXED.items():
        check(warm[name] == n, f"cfg3 warm-up: {name} launched {warm[name]}"
                               f" times, expected {n}")
    check(warm["warp_bilinear"] == len(calls["k2"]) > 0,
          f"cfg3 warm-up: K2 {warm['warp_bilinear']} launches, "
          f"{len(calls['k2'])} recorded")
    k = calls["k1"][0][2]
    stats = _stats_dict(k.stats)
    stats_against_cpu(stats, cpu_fused_stats(calls["k1"][0]), "cfg3")
    k1 = phase_raster(None, None, bc.cfg, label="cfg3", width=bc.width,
                      height=bc.height, inputs=k)
    k2 = k2_launches_against_plain([args for args, _, _ in calls["k2"]],
                                   "at cfg3's launches")
    del calls, k
    out = bc.last["out"]
    ao = out.state.ssao.history
    check(bool(torch.isfinite(ao).all()) and float(ao.min()) >= 0.0
          and float(ao.max()) <= 1.0, "cfg3 SSAO history outside [0, 1]")
    check(bool(torch.isfinite(out.state.ssr.radiance).all()),
          "cfg3 SSR not finite")
    hit = float(out.gbuffer.hit.float().mean())
    check(0.2 < hit < 1.0, f"cfg3 hit fraction {hit}")
    del out
    host_ms, dev_ms, launches = timed_steps(
        bc, frames, "cfg3", CFG3_FIXED,
        warm_launches={"warp_bilinear": warm["warp_bilinear"]})
    p = small_baseline_against_cpu(bench.config_3_sponza,
                                   "256x128 cfg3 frame (4 columns)",
                                   width=SMALL_W, height=SMALL_H,
                                   n_columns=4)
    return _phase_result(bc, host_ms, dev_ms, launches, frames, t0, k1=k1,
                         k2=k2, raster_stats=stats, hit=hit, small_psnr=p)


def phase_baseline(frames, ibl_source):
    """Phases 35-37."""
    return dict(cfg1=phase_cfg1(frames), cfg2=phase_cfg2(frames, ibl_source),
                cfg3=phase_cfg3(frames, ibl_source))


def baseline_kernels(base):
    """The kernels line of `--only baseline`: K1 at the three frames'
    inputs (cfg1's as its own numbers), K2 at cfg3's launches and K4 at
    cfg2's cascades, each with its launches over the three timed runs."""
    k1 = dict(name="raster_tiles_fused", route="cuda",
              source="diligentfx_tpu_torch/csrc/raster_fused.cu",
              replaces="diligentfx_tpu/ops/raster_pallas.py:261",
              **{key: base["cfg1"]["k1"][key] for key in (
                  "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "device_ms")})
    merge_k1(k1, base["cfg2"]["k1"], "cfg2_inputs")
    merge_k1(k1, base["cfg3"]["k1"], "cfg3_inputs")
    k2 = dict(name="warp_bilinear", route="cuda",
              source="diligentfx_tpu_torch/csrc/warp.cu",
              replaces="diligentfx_tpu/ops/warp_pallas.py:34",
              **base["cfg3"]["k2"])
    k4 = dict(name="raster_tiles", route="cuda",
              source="diligentfx_tpu_torch/csrc/raster_tiles.cu",
              replaces="diligentfx_tpu/ops/raster_pallas.py:35",
              library_ms=None, **base["cfg2"]["k4"])
    for k in (k1, k2, k4):
        k["launches"] = sum(base[c]["launches"][k["name"]]
                            for c in ("cfg1", "cfg2", "cfg3"))
        add_baseline_launches(k, base)
    return [k1, k2, k4]


def add_baseline_launches(k, base):
    """The kernel's launches in each configuration's timed frames."""
    for c in ("cfg1", "cfg2", "cfg3"):
        k[f"{c}_frame_launches"] = base[c]["launches"][k["name"]]
        k[f"{c}_frames"] = base[c]["frames"]


def print_baseline(base, card):
    for c in ("cfg1", "cfg2", "cfg3"):
        r = base[c]
        print(f"{r['metric']}: {c}_frame_ms_median {r['frame_ms_median']:.3f}"
              f" (CUDA events {r['frame_events_ms_median']:.3f}, mean "
              f"{r['frame_ms_mean']:.3f}) over {r['frames']} frames at "
              f"{r['width']}x{r['height']}, {r['triangles']} triangles; small "
              f"copy vs the CPU path {r['small_psnr']:.2f} dB; phase "
              f"{r['seconds']:.1f} s on {card}", flush=True)


def baseline_only(frames):
    """Phases 35-37 alone, their IBL (cfg2's and cfg3's default
    create-info) precomputed once."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ibl = PBRRenderer(PBRRendererCreateInfo(), device=DEVICE)
    return phase_baseline(frames, ibl)


# goals of the tile rasters' redesign, device ms (torch.profiler kernel
# rows): K4 over the four cascades, K1 at each of its three inputs
RASTER_GOALS_MS = {"raster_tiles": 0.45, "bench": 0.15, "csm": 0.20,
                   "full-chain": 0.25}


def merge_k1(k1, k1_other, key):
    """K1's numbers at another input set, kept under `key` of its line."""
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_other["max_abs_err"])
    k1[key] = {name: k1_other[name] for name in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
        "candidate_pixel_tests", "candidate_pixel_tests_unculled",
        "bound_ms_unculled")}


def print_raster_goals(k1, k4):
    times = {"raster_tiles": k4["device_ms"], "bench": k1["device_ms"],
             "csm": k1["csm_inputs"]["device_ms"],
             "full-chain": k1["full_chain_inputs"]["device_ms"]}
    print("raster goals (device ms): " + "; ".join(
        f"{name} {times[name]:.4f} <= {goal} "
        f"{'held' if times[name] <= goal else 'missed'}"
        for name, goal in RASTER_GOALS_MS.items()), flush=True)


def raster_only():
    """Phases 2, 8 (K1 at the csm inputs, K4 on the four cascades) and 11
    (K1 at the full-chain inputs, the atrium alone): the tile rasters at
    every input the main path gives them, without the frames.  A checkout
    whose tile rasters take no candidate rectangles (before the culling
    kernels) runs them without, its tests inside rectangles not counted;
    the main path always passes them."""
    from diligentfx_tpu_torch.ops import raster as rz
    legacy = not hasattr(rz, "candidate_rects")
    if legacy:
        print("this checkout's tile rasters take no candidate rectangles",
              flush=True)
    cfg = bench_raster_config()
    k1 = phase_raster(bench_scene(5, 9, 32, DEVICE), render_info(W, H, DEVICE),
                      cfg, legacy=legacy)
    scene_csm, _ = csm_scene(5, 9, 32, DEVICE)
    merge_k1(k1, phase_raster(scene_csm, render_info(W, H, DEVICE, csm=True),
                              cfg, use_textures=True, label="csm",
                              legacy=legacy), "csm_inputs")
    k4 = phase_shadow_raster(cfg, scene_csm, legacy=legacy)
    merge_k1(k1, phase_raster(full_chain_scene(),
                              full_chain_info(0, W, H, DEVICE),
                              full_chain_raster_config(), label="full-chain",
                              legacy=legacy), "full_chain_inputs")
    print_raster_goals(k1, k4)
    return k1, k4


def csm_only(frames, profile):
    """Phase 9 alone (the csm frame, timed; profiled with `profile`): the
    shadow pass and the frame of two checkouts in one call."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    cfg = bench_raster_config()
    scene, atlas = csm_scene(5, 9, 32, DEVICE)
    ibl = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg, device=DEVICE)
    tm, scene, frame_info, _, ms, ev_ms = phase_csm_frame(
        cfg, scene, atlas, frames, "", ibl)
    if profile:
        phase_profile(tm, scene, frame_info, 3, profile, "csm")
    return dict(csm_frame_ms_median=ms, csm_frame_events_ms_median=ev_ms,
                frames=frames)


def march_gtao_only():
    """Phases 5 and 6 at the inputs of one bench frame (its G-buffer and
    SSAO state): K3 and K5 of two checkouts in one call."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.task_manager import HnTaskManager
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    cfg = bench_raster_config()
    tm = HnTaskManager(PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg,
                                   device=DEVICE), bench_task_manager_ci())
    info = render_info(W, H, DEVICE)
    out = tm.execute(bench_scene(5, 9, 32, DEVICE), info,
                     tm.initial_state(W, H), width=W, height=H,
                     settings=bench_settings())
    return phase_march(out.gbuffer, info), phase_gtao(out.gbuffer, info,
                                                      out.state)


def oit_only(frames, profile):
    """Phases 15 and 16 alone: K4 at the mask / blend frame's G-buffer
    inputs and the 1080p mask / blend frame, for A/B runs."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    cfg = full_chain_raster_config()
    rs = oit_render_scene(DEVICE)
    k4 = phase_gbuffer_k4(rs, cfg)
    ibl = PBRRenderer(PBRRendererCreateInfo(), raster_cfg=cfg, device=DEVICE)
    frame = phase_oit_frame(cfg, rs, frames, "", ibl, profile)
    return dict(k4_gbuffer_inputs=k4, mask_blend_frame=frame)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out-png", default="")
    ap.add_argument("--profile", default="",
                    help="also profile 3 frames (device time by stage and by "
                         "kernel); write the profiler's table to this path")
    ap.add_argument("--only", choices=("warp", "raster", "csm",
                                        "march_gtao", "oit", "lights",
                                        "ext_skin", "editor", "hydra",
                                        "radient", "split4k", "banded",
                                        "inverse", "baseline"),
                    help="warp: run only phases 1, 3 and 13 (K6 on random "
                         "taps within the halo); raster: only phases 1, 2, "
                         "8 (without the csm frame) and 11; csm: only "
                         "phases 1 and 9 (with --profile, profiled); "
                         "march_gtao: only phase 1, one bench frame and "
                         "phases 5 and 6; oit: only phases 1, 15 and 16 "
                         "(with --profile, the profiler's table to that "
                         "path); lights: only phases 1, 18 and 19 (with "
                         "--profile, likewise); ext_skin: only phases 1, 21 "
                         "and 22 (likewise); editor: only phases 1, 24 and "
                         "25 (likewise); hydra: only phases 1, 26 and 27 "
                         "(likewise); radient: only phases 1, 28 and 29 "
                         "(likewise); split4k: only phases 1, 30 and 31; "
                         "banded: only phases 1, 32 and 33; inverse: only "
                         "phases 1 and 34 (--frames steps); baseline: only "
                         "phases 1 and 35-37, ending in the ok line; and "
                         "print their JSON line")
    ap.add_argument("--async-child", metavar="BUILD_DIR", default="",
                    help="phase 26's AsyncFramePipeline run alone, its "
                         "kernels built into the empty BUILD_DIR (phase 26 "
                         "starts it in a child process)")
    ap.add_argument("--root", default=HERE,
                    help="import the port from this checkout (with --only, "
                         "to A/B two checkouts' kernels in one call)")
    args = ap.parse_args()
    global EARLIER_CHECKOUT_OK, ROOT
    EARLIER_CHECKOUT_OK = (args.only == "march_gtao" and
                           os.path.abspath(args.root) != HERE)
    ROOT = os.path.abspath(args.root)

    if not os.path.isdir(os.path.join(args.root, "diligentfx_tpu_torch")):
        fail(f"the diligentfx_tpu_torch package is not in {args.root}")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.async_child:
        return hydra_async_child(args.async_child)
    card = card_line()
    t_start = time.perf_counter()
    phase_build()
    if args.only == "warp":
        k2 = phase_warp()
        k6 = phase_warp_multi(*random_tap_fields())
        print(json.dumps({"root": args.root, "kernels": [k2, k6]}))
        print(card, flush=True)
        return 0
    if args.only == "raster":
        k1, k4 = raster_only()
        print(json.dumps({"root": args.root, "kernels": [k1, k4]}))
        print(card, flush=True)
        return 0
    if args.only == "march_gtao":
        k3, k5 = march_gtao_only()
        print(json.dumps({"root": args.root, "kernels": [k3, k5]}))
        print(card, flush=True)
        return 0
    if args.only == "csm":
        print(json.dumps({"root": args.root,
                          **csm_only(args.frames, args.profile)}))
        print(card, flush=True)
        return 0
    if args.only == "oit":
        print(json.dumps({"root": args.root,
                          **oit_only(args.frames, args.profile)}))
        print(card, flush=True)
        return 0
    if args.only == "lights":
        print(json.dumps({"root": args.root,
                          **lights_only(args.frames, args.profile)}))
        print(card, flush=True)
        return 0
    if args.only == "ext_skin":
        print(json.dumps({"root": args.root,
                          **ext_skin_only(args.frames, args.profile)},
                         default=str))
        print(card, flush=True)
        return 0
    if args.only == "editor":
        print(json.dumps({"root": args.root,
                          **editor_only(args.frames, args.profile)},
                         default=str))
        print(card, flush=True)
        return 0
    if args.only == "hydra":
        print(json.dumps({"root": args.root,
                          **hydra_only(args.frames, args.profile)},
                         default=str))
        print(card, flush=True)
        return 0
    if args.only == "radient":
        print(json.dumps({"root": args.root,
                          **radient_only(args.frames, args.profile)},
                         default=str))
        print(card, flush=True)
        return 0
    if args.only == "split4k":
        print(json.dumps({"root": args.root,
                          **split4k_only(args.frames, args.out_png)},
                         default=str))
        print(card, flush=True)
        return 0
    if args.only == "banded":
        print(json.dumps({"root": args.root, **banded_only(args.frames)},
                         default=str))
        print(card, flush=True)
        return 0
    if args.only == "inverse":
        print(json.dumps({"root": args.root, **inverse_only(args.frames)},
                         default=str))
        print(card, flush=True)
        return 0
    if args.only == "baseline":
        base = baseline_only(args.frames)
        print_baseline(base, card)
        print(f"phases 1 and 35-37: total run "
              f"{time.perf_counter() - t_start:.1f} s on {card}", flush=True)
        if DEVICE_MS_FROM_EVENTS:
            print(f"device_ms from CUDA events, the profiler showing no "
                  f"device time, for kernels named {DEVICE_MS_FROM_EVENTS}")
        print(json.dumps({"root": args.root,
                          "kernels": baseline_kernels(base)}, default=str))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    cfg = bench_raster_config()
    scene = bench_scene(5, 9, 32, DEVICE)
    print(f"bench scene: {scene.num_triangles} triangles, "
          f"{scene.num_vertices} vertices", flush=True)
    info = render_info(W, H, DEVICE)
    k1 = phase_raster(scene, info, cfg)
    k2 = phase_warp()
    tm, launches, frame_ms, frame_dev_ms, gb, state = phase_frame(
        scene, info, cfg, args.frames, args.out_png)
    k3 = phase_march(gb, info)
    k5 = phase_gtao(gb, info, state)
    if args.profile:
        phase_raster_inputs_host(scene, info, cfg, 3)
        phase_profile(tm, scene, lambda: info, 3, args.profile, "bench")
    phase_reference()
    del gb, state
    scene_csm, atlas = csm_scene(5, 9, 32, DEVICE)
    k1_csm = phase_raster(scene_csm, render_info(W, H, DEVICE, csm=True), cfg,
                          use_textures=True, label="csm")
    merge_k1(k1, k1_csm, "csm_inputs")
    k4 = phase_shadow_raster(cfg, scene_csm)
    csm_tm, csm_scene_, csm_info, csm_launches, csm_ms, csm_dev_ms = \
        phase_csm_frame(cfg, scene_csm, atlas, args.frames, args.out_png,
                        tm.renderer)
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        phase_profile(csm_tm, csm_scene_, csm_info, 3,
                      f"{root}_csm{ext or '.txt'}", "csm")
    phase_csm_reference()
    del csm_tm, csm_scene_, csm_info
    fc_cfg = full_chain_raster_config()
    scene_fc = full_chain_scene()
    print(f"full-chain scene: {scene_fc.num_triangles} triangles, "
          f"{scene_fc.num_vertices} vertices", flush=True)
    check(scene_fc.num_triangles == 112592, "the atrium scene's triangles")
    k1_fc = phase_raster(scene_fc, full_chain_info(0, W, H, DEVICE), fc_cfg,
                         label="full-chain")
    merge_k1(k1, k1_fc, "full_chain_inputs")
    print_raster_goals(k1, k4)
    (fc_tm, fc_info, fc_launches, fc_ms, fc_dev_ms, fc_gb, fc_state,
     fc_last) = phase_full_chain_frame(fc_cfg, scene_fc, args.frames,
                                       args.out_png, tm.renderer)
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        phase_profile(fc_tm, scene_fc, fc_info, 3,
                      f"{root}_full_chain{ext or '.txt'}", "full-chain")
    k6 = phase_warp_multi(*ssao_tap_fields(fc_gb, fc_last,
                                           fc_state.frame_index - 1))
    del fc_gb, fc_state, fc_tm
    phase_full_chain_reference()
    rs_oit = oit_render_scene(DEVICE)
    k4["gbuffer_inputs"] = phase_gbuffer_k4(rs_oit, fc_cfg)
    oit_frame = phase_oit_frame(
        fc_cfg, rs_oit, args.frames, args.out_png, tm.renderer,
        f"{os.path.splitext(args.profile)[0]}_mask_blend.txt"
        if args.profile else "")
    del rs_oit
    phase_oit_reference()
    rs_light = light_heap_render_scene(DEVICE)
    light_setup = light_shadow_setup(rs_light)
    k4["light_inputs"] = phase_light_k4(rs_light, light_setup)
    light_frame = phase_light_heap_frame(
        fc_cfg, rs_light, light_setup, args.frames, args.out_png,
        tm.renderer,
        f"{os.path.splitext(args.profile)[0]}_light_heap.txt"
        if args.profile else "")
    del rs_light, light_setup
    light_psnr = phase_light_heap_reference()
    x_cfg = ext_skin_raster_config()
    x_model, x_rs, x_player, x_meta = ext_skin_model(DEVICE)
    k1_x, k4["ext_skin_cascades"] = phase_ext_skin_kernels(
        x_cfg, x_model, x_rs, x_player)
    merge_k1(k1, k1_x, "ext_skin_inputs")
    ext_frame = phase_ext_skin_frame(
        x_cfg, x_model, x_rs, x_player, x_meta, args.frames, args.out_png,
        tm.renderer, f"{os.path.splitext(args.profile)[0]}_ext_skin.txt"
        if args.profile else "")
    t_editor = time.perf_counter()
    editor_frame = phase_editor_frame(
        x_cfg, x_model, x_rs, x_player, x_meta, args.frames, args.out_png,
        tm.renderer, f"{os.path.splitext(args.profile)[0]}_editor.txt"
        if args.profile else "")
    editor_s = [time.perf_counter() - t_editor]
    del x_model, x_rs, x_player
    ext_psnr = phase_ext_skin_reference()
    t_editor = time.perf_counter()
    editor_psnr = phase_editor_reference()
    editor_s.append(time.perf_counter() - t_editor)
    t_hydra = time.perf_counter()
    hydra_frame = phase_hydra_frame(
        hydra_raster_config(), args.frames, args.out_png, tm.renderer,
        f"{os.path.splitext(args.profile)[0]}_hydra.txt"
        if args.profile else "")
    merge_k1(k1, hydra_frame.pop("k1_inputs"), "hydra_inputs")
    k4["edges_inputs"] = hydra_frame.pop("k4_edges_inputs")
    hydra_s = [time.perf_counter() - t_hydra]
    hydra_psnr = phase_hydra_reference()
    hydra_s.append(time.perf_counter() - t_hydra - hydra_s[0])
    t_radient = time.perf_counter()
    radient_frame = phase_radient_frame(
        radient_raster_config(), args.frames, args.out_png,
        f"{os.path.splitext(args.profile)[0]}_radient.txt"
        if args.profile else "")
    merge_k1(k1, radient_frame.pop("k1_inputs"), "radient_inputs")
    radient_s = [time.perf_counter() - t_radient]
    radient_psnr = phase_radient_reference()
    radient_s.append(time.perf_counter() - t_radient - radient_s[0])
    t_split = time.perf_counter()
    cfg5 = cfg5_raster_config()
    scene_4k = full_chain_scene(CFG5_COLUMNS)
    print(f"4K cfg5 scene: {scene_4k.num_triangles} triangles", flush=True)
    merge_k1(k1, phase_split4k_raster(scene_4k, cfg5), "split4k_inputs")
    split_frame = phase_split4k_frame(cfg5, scene_4k, args.frames,
                                      args.out_png, tm.renderer)
    del scene_4k
    t_banded = time.perf_counter()
    banded = phase_banded(args.frames, tm.renderer)
    t_ref = time.perf_counter()
    split_banded_psnr = phase_split_banded_reference()
    split_s = [t_banded - t_split, t_ref - t_banded,
               time.perf_counter() - t_ref]
    inverse = phase_inverse(args.frames)
    base = phase_baseline(args.frames, tm.renderer)
    merge_k1(k1, base["cfg1"]["k1"], "cfg1_inputs")
    merge_k1(k1, base["cfg2"]["k1"], "cfg2_inputs")
    merge_k1(k1, base["cfg3"]["k1"], "cfg3_inputs")
    k2["cfg3_launch_set"] = base["cfg3"]["k2"]
    k4["cfg2_cascades"] = base["cfg2"]["k4"]
    k1["banded_inputs"] = {key: banded["k1"][key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
        "candidate_pixel_tests", "raster_stats")}
    k1["banded_inputs"]["bands"] = banded["k1"]["band_inputs"]
    k1["max_abs_err"] = max(k1["max_abs_err"], banded["k1"]["max_abs_err"],
                            *(b["max_abs_err"]
                              for b in banded["k1"]["band_inputs"]))
    k4["forward_banded_inputs"] = banded["k4_bands"]
    k4["forward_banded_launches"] = banded["forward_launches"]["raster_tiles"]
    k4["inverse_band_inputs"] = inverse["k4_bands"]
    k3["gathered_inputs"] = banded["k3"]
    for k in (k1, k2, k3):
        k["launches"] = launches[k["name"]]
        k["frames"] = args.frames
        k["launches_per_frame"] = launches[k["name"]] / args.frames
    for k in (k1, k2, k3, k5, k6):
        k["csm_frame_launches"] = csm_launches[k["name"]]
    for k in (k1, k2, k3, k4, k5, k6):
        k["full_chain_frame_launches"] = fc_launches[k["name"]]
        k["mask_blend_frame_launches"] = oit_frame["launches"][k["name"]]
        k["light_heap_frame_launches"] = light_frame["launches"][k["name"]]
        k["ext_skin_frame_launches"] = ext_frame["launches"][k["name"]]
        k["editor_frame_launches"] = editor_frame["launches"][k["name"]]
        k["hydra_frame_launches"] = hydra_frame["launches"][k["name"]]
        k["edges_frame_launches"] = hydra_frame["probes"]["edges_launches"][
            k["name"]]
        k["edges_frames"] = MODE_FRAMES
        k["radient_frame_launches"] = radient_frame["launches"][k["name"]]
        k["split4k_frame_launches"] = split_frame["launches"][k["name"]]
        k["split4k_frames"] = args.frames
        k["banded_frame_launches"] = banded["launches"][k["name"]]
        k["banded_frames"] = args.frames
        k["inverse_step_launches"] = inverse["launches"][k["name"]]
        k["inverse_steps"] = args.frames
        add_baseline_launches(k, base)
    k4["launches"] = csm_launches["raster_tiles"]
    k4["frames"] = args.frames
    k4["launches_per_frame"] = csm_launches["raster_tiles"] / args.frames
    k4["path"] = ("HnTaskManager.render_shadows (the --csm frame's shadow "
                  "pass: one launch per cascade); bench frame launches "
                  f"{launches['raster_tiles']}; the mask / blend frame's "
                  "two-pass G-buffer: one launch a frame "
                  "(mask_blend_frame_launches over the same frames); the "
                  "light / heap frame: the G-buffer and the 8 shadow-atlas "
                  "slices, 9 a frame (light_heap_frame_launches); the "
                  "ext_skin frame's cascades, 4 a frame "
                  "(ext_skin_frame_launches); the editor frame's cascades, "
                  "4 a frame (editor_frame_launches); the Hydra stage's "
                  "EDGES frame, one (edges_frame_launches, over "
                  "edges_frames frames); the Radient atrium frame none "
                  "(radient_frame_launches); render_forward_banded, one a "
                  "band (forward_banded_launches); the inverse-rendering "
                  "step, one a band of each view, 16 a step "
                  "(inverse_step_launches over inverse_steps steps); "
                  "BASELINE.json config 2's four cascades, 4 a frame "
                  "(cfg2_frame_launches over cfg2_frames frames)")
    k5["frame_launches"] = launches["gtao_fused"]
    k5["launches_per_frame"] = 0.0
    k6["frame_launches"] = launches["warp_bilinear_multi"]
    k6["launches_per_frame"] = 0.0
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{**{key: k[key] for key in order},
                **{key: v for key, v in k.items() if key not in order}}
               for k in (k1, k2, k3, k4, k5, k6)]
    print(f"frame_ms_median {frame_ms:.3f} (CUDA events {frame_dev_ms:.3f}) "
          f"over {args.frames} frames at {W}x{H}")
    print(f"csm_frame_ms_median {csm_ms:.3f} (CUDA events {csm_dev_ms:.3f}) "
          f"over {args.frames} frames at {W}x{H}")
    print(f"full_chain_frame_ms_median {fc_ms:.3f} (CUDA events "
          f"{fc_dev_ms:.3f}) over {args.frames} frames at {W}x{H}")
    oit_stages = oit_frame["profile"]["stages"]
    print(f"mask_blend_frame_ms_median {oit_frame['frame_ms_median']:.3f} "
          f"(CUDA events {oit_frame['frame_events_ms_median']:.3f}) over "
          f"{args.frames} frames at {W}x{H}; K-layer OIT stage alone "
          f"{oit_frame['oit_stage_host_ms']:.3f} ms host, "
          f"{oit_frame['oit_stage_events_ms']:.3f} ms CUDA events; profiled "
          f"stages {json.dumps(oit_stages)}; ranges "
          f"{json.dumps(oit_frame['profile']['ranges'])} on {card}; total "
          f"run {time.perf_counter() - t_start:.1f} s")
    light_ranges = light_frame["profile"]["ranges"]
    print(f"light_heap_frame_ms_median {light_frame['frame_ms_median']:.3f} "
          f"(CUDA events {light_frame['frame_events_ms_median']:.3f}) over "
          f"{args.frames} frames at {W}x{H}; profiled stages "
          f"{json.dumps(light_frame['profile']['stages'])}; ranges "
          f"{json.dumps(light_ranges)}; dfx.gbuffer device ms heap "
          f"{light_frame['gbuffer_device_ms_heap']:.3f}, atlas "
          f"{light_frame['gbuffer_device_ms_atlas']:.3f}; 256x128 vs the CPU "
          f"path {light_psnr:.2f} dB on {card}; total run "
          f"{time.perf_counter() - t_start:.1f} s")
    x_prof = ext_frame["profile"]
    print(f"ext_skin_frame_ms_median {ext_frame['frame_ms_median']:.3f} "
          f"(CUDA events {ext_frame['frame_events_ms_median']:.3f}) over "
          f"{args.frames} frames at {W}x{H}, {ext_frame['triangles']} "
          f"triangles; update_animation "
          f"{ext_frame['update_animation_host_ms']:.3f} ms host; profiled "
          f"stages {json.dumps(x_prof['stages'])}; device busy "
          f"{x_prof['device_busy_ms']:.3f} of "
          f"{x_prof['frame_ms_profiled']:.3f} ms, {x_prof['launches']} "
          f"launches a frame; 256x128 vs the CPU path {ext_psnr:.2f} dB on "
          f"{card}; total run {time.perf_counter() - t_start:.1f} s")
    e_prof = editor_frame["profile"]
    print(f"editor_frame_ms_median {editor_frame['frame_ms_median']:.3f} "
          f"(CUDA events {editor_frame['frame_events_ms_median']:.3f}) over "
          f"{args.frames} frames at {W}x{H}; profiled ({EDITOR_VIEW} view) "
          f"stages {json.dumps(e_prof['stages'])}; ranges "
          f"{json.dumps(e_prof['ranges'])}; device busy "
          f"{e_prof['device_busy_ms']:.3f} of "
          f"{e_prof['frame_ms_profiled']:.3f} ms, {e_prof['launches']} "
          f"launches a frame; debug-view sweep "
          f"{editor_frame['sweep_views']} views in "
          f"{editor_frame['sweep_seconds']:.3f} s; 256x128 vs the CPU path "
          f"{editor_psnr:.2f} dB; phases 24 and 25 {editor_s[0]:.1f} and "
          f"{editor_s[1]:.1f} s on {card}; total run "
          f"{time.perf_counter() - t_start:.1f} s")
    hp = hydra_frame["probes"]
    print(f"hydra_frame_ms_median {hydra_frame['frame_ms_median']:.3f} "
          f"(CUDA events {hydra_frame['frame_events_ms_median']:.3f}; the "
          f"task manager alone {hydra_frame['task_manager_ms_median']:.3f}) "
          f"over {args.frames} frames at {W}x{H}, "
          f"{hydra_frame['triangles']} triangles; populate -> Sync -> "
          f"CommitResources {hydra_frame['commit_ms']:.1f} ms; EDGES "
          f"{hp['edges_frame_ms']:.3f} ms, POINTS {hp['points_frame_ms']:.3f}"
          f" ms; AsyncFramePipeline OK after "
          f"{hydra_frame['async_pipeline']['seconds_to_ok']:.2f} s; 256x128 "
          f"vs the CPU path {hydra_psnr:.2f} dB; phases 26 and 27 "
          f"{hydra_s[0]:.1f} and {hydra_s[1]:.1f} s on {card}; total run "
          f"{time.perf_counter() - t_start:.1f} s")
    rp = radient_frame["probes"]
    print(f"radient_frame_ms_median {radient_frame['frame_ms_median']:.3f} "
          f"(update {radient_frame['update_ms_median']:.3f}, render "
          f"{radient_frame['render_ms_median']:.3f}; CUDA events "
          f"{radient_frame['frame_events_ms_median']:.3f}) over {args.frames} "
          f"frames at {W}x{H}, {radient_frame['triangles']} triangles; scene "
          f"built in {radient_frame['scene_seconds']:.2f} s; IBL cache cold "
          f"{rp['ibl_cache']['cold_ms']:.1f} ms, warm "
          f"{rp['ibl_cache']['warm_ms']:.1f} ms; 256x128 vs the CPU path "
          f"{radient_psnr:.2f} dB; phases 28 and 29 {radient_s[0]:.1f} and "
          f"{radient_s[1]:.1f} s on {card}; total run "
          f"{time.perf_counter() - t_start:.1f} s")
    print(f"split4k_frame_ms_median {split_frame['frame_ms_median']:.3f} "
          f"(CUDA events {split_frame['frame_events_ms_median']:.3f}) over "
          f"{args.frames} frames at {W4K}x{H4K}, execute_split with "
          f"{SPLIT_BANDS} bands, {split_frame['triangles']} triangles; peak "
          f"MB {json.dumps(split_frame['peaks'])}; banded_frame_ms_median "
          f"{banded['frame_ms_median']:.3f} (CUDA events "
          f"{banded['frame_events_ms_median']:.3f}), execute "
          f"{banded['execute_ms_median']:.3f} ({banded['execute_events_ms_median']:.3f})"
          f" at {BANDED_W}x{BANDED_H}, {BANDED_N} bands; 256x128 vs the CPU "
          f"path {json.dumps(split_banded_psnr)}; phases 30-31, 32 and 33 "
          f"{split_s[0]:.1f}, {split_s[1]:.1f} and {split_s[2]:.1f} s on "
          f"{card}; total run {time.perf_counter() - t_start:.1f} s")
    print(f"inverse_step_ms_median {inverse['step_ms_median']:.3f} (CUDA "
          f"events {inverse['step_events_ms_median']:.3f}) over {args.frames}"
          f" steps at {INV_W}x{INV_H}, {INV_VIEWS} views on dp {INV_DP} x sp "
          f"{INV_SP}; forward {inverse['forward_ms_median']:.3f}, backward "
          f"{inverse['backward_ms_median']:.3f}; peak "
          f"{inverse['peak_mb']:.1f} MB; phase 34 {inverse['seconds']:.1f} s "
          f"on {card}; total run {time.perf_counter() - t_start:.1f} s")
    print_baseline(base, card)
    print(f"total run {time.perf_counter() - t_start:.1f} s on {card}")
    if DEVICE_MS_FROM_EVENTS:
        print(f"device_ms from CUDA events, the profiler showing no device "
              f"time, for kernels named {DEVICE_MS_FROM_EVENTS}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
