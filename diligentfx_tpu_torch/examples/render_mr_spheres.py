"""The `mr_spheres` configuration (BASELINE.json configs[0]; the port of
examples/render_mr_spheres.py): a grid of spheres sweeping metallic x
roughness under IBL and one directional light, through the forward
renderer PBRRenderer.render (the fused raster K1 on CUDA, the two-pass
path on the CPU).  The procedural stand-in for the glTF MetalRoughSpheres
asset.

Usage: python -m diligentfx_tpu_torch.examples.render_mr_spheres --size 512 --out mr_spheres.png
       (--device cpu to render on the CPU; keep --size small there)
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                          PBRMaterialBasicAttribs,
                                          PBRRendererShaderParameters)
from diligentfx_tpu_torch.config import (PBRRendererCreateInfo,
                                         RasterizerConfig)
from diligentfx_tpu_torch.device import resolve_device
from diligentfx_tpu_torch.gltf.primitives import uv_sphere
from diligentfx_tpu_torch.pbr.renderer import (RenderInfo, ScenePrimitives,
                                               build_scene)

EYE = [0.0, 0.3, 6.0]                 # render_mr_spheres.py:58-60
SUN = [-0.5, -0.7, -0.5]


def build_mr_spheres_scene(rows: int = 4, cols: int = 4,
                           sphere_res: int = 24,
                           device=None) -> ScenePrimitives:
    """rows x cols spheres of radius 0.42 (`sphere_res` stacks, 8 more
    slices), metallic by row and roughness by column (:19-35)."""
    mesh = uv_sphere(0.42, stacks=sphere_res, slices=sphere_res + 8)
    entries = []
    for r in range(rows):
        for c in range(cols):
            metallic = r / max(rows - 1, 1)
            roughness = np.clip(c / max(cols - 1, 1), 0.03, 1.0)
            node = np.eye(4, dtype=np.float32)
            node[3, :3] = [c - (cols - 1) / 2, (rows - 1) / 2 - r, 0.0]
            mat = PBRMaterialBasicAttribs.create(
                base_color_factor=(0.8, 0.3, 0.25, 1.0),
                metallic_factor=metallic, roughness_factor=roughness)
            entries.append((mesh, node, mat))
    return build_scene(entries, device=resolve_device(device))


def mr_spheres_create_info(ibl_dim: int = 64) -> PBRRendererCreateInfo:
    """The renderer's small IBL (:52-55); `ibl_dim` the prefiltered env
    map's (the script's --ibl-dim)."""
    return PBRRendererCreateInfo(
        brdf_lut_dim=64, num_brdf_samples=64,
        irradiance_cube_dim=32, prefiltered_env_map_dim=ibl_dim,
        num_specular_env_samples=64)


def mr_spheres_raster_config() -> RasterizerConfig:
    """8 x 128 tiles, lists of 4,096, chunk 32 (:57-58)."""
    return RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=4096,
                            chunk=32)


def mr_spheres_info(w: int, h: int, device=None) -> RenderInfo:
    """The camera at (0, 0.3, 6) looking at the origin (fov 0.6) and the
    sun at 3 (:60-65)."""
    dev = resolve_device(device)
    cam = CameraAttribs.create(m3.look_at(EYE, [0.0, 0.0, 0.0], device=dev),
                               m3.perspective(0.6, w / h, 0.1, 100.0,
                                              device=dev),
                               EYE, 0.1, 100.0, w, h, device=dev)
    return RenderInfo(camera=cam,
                      lights=PBRLightAttribs.directional(
                          SUN, [3.0, 3.0, 3.0], device=dev),
                      renderer_params=PBRRendererShaderParameters.create(
                          device=dev))


def main(argv=None) -> int:
    from diligentfx_tpu_torch.config import DebugViewType
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    from diligentfx_tpu_torch.utils.image import write_png
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", type=str, default="mr_spheres.png")
    ap.add_argument("--ibl-dim", type=int, default=64)
    ap.add_argument("--debug-view", type=str, default="NONE")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    w = h = args.size
    scene = build_mr_spheres_scene(device=dev)
    t0 = time.perf_counter()
    renderer = PBRRenderer(mr_spheres_create_info(args.ibl_dim),
                           raster_cfg=mr_spheres_raster_config(), device=dev)
    sync()
    print(f"IBL precompute: {time.perf_counter() - t0:.1f}s")
    info = mr_spheres_info(w, h, dev)
    view = DebugViewType[args.debug_view]
    t0 = time.perf_counter()
    img = renderer.render(scene, info, width=w, height=h, debug_view=view)
    sync()
    print(f"first frame (incl. kernel build): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    img = renderer.render(scene, info, width=w, height=h, debug_view=view)
    sync()
    print(f"steady-state frame: {(time.perf_counter() - t0) * 1000:.1f} ms")
    arr = img.cpu().numpy()
    if not np.isfinite(arr).all():
        raise RuntimeError("NaN/Inf in output")
    write_png(args.out, arr)
    print(f"wrote {args.out}  ({w}x{h}, mean={arr.mean():.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
