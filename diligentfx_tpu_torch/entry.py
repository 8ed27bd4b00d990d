"""The port of __graft_entry__.py:1-206, its two entry points: the
forward frame of the small flagship scene, and the inverse-rendering step
of the multi-device dry run.

`entry` (:48-60) returns a forward frame and its arguments.  `dryrun`
(:98-176) takes one gradient step on the materials' base colours: a batch
of views, one a camera on an orbit, is split over the mesh's dp rows, each
view's framebuffer rows are banded over its row's sp devices
(parallel/tiling.py forward_bands: K4 at each band's window, then the
plain shading), and the loss is the mean squared error against the
targets.  The JAX package jits the step with GSPMD shardings; here one
process drives the grid, as in parallel/, and the parameters are copied
once to each distinct device (`.to`), so autograd's sum of the copies'
gradients at the leaf is the all-reduce.  The gradient flows through the
plain PyTorch shading only: K4's outputs (depth, ids, barycentrics) do not
depend on the colours.  The fused raster K1 carries no gradient and
`_render_frame` refuses it for a material that requires grad.  The
dry run's other half, the banded deferred frame, is
parallel/tiling.py render_frame_banded.

The entry points run on CUDA unless the caller passes device="cpu" (or a
mesh of CPU devices).
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.attribs import (CameraAttribs, PBRLightAttribs,
                                          PBRMaterialBasicAttribs,
                                          PBRRendererShaderParameters)
from diligentfx_tpu_torch.config import (DebugViewType, PBRRendererCreateInfo,
                                         RasterizerConfig, ToneMappingMode)
from diligentfx_tpu_torch.device import resolve_device
from diligentfx_tpu_torch.gltf.primitives import uv_sphere
from diligentfx_tpu_torch.parallel.mesh import (RenderMesh, band_sharding,
                                                make_render_mesh, replicated)
from diligentfx_tpu_torch.parallel.tiling import _replicate, forward_bands
from diligentfx_tpu_torch.pbr.renderer import (PBRRenderer, RenderInfo,
                                               ScenePrimitives, _render_frame,
                                               build_scene)

Tensor = torch.Tensor

LEARNING_RATE = 0.1       # __graft_entry__.py:152


def build_small(size: int = 128, rows: int = 2, cols: int = 2,
                sphere_res: int = 10, ibl: bool = True, device=None):
    """The flagship scene (:11-45): rows x cols spheres, metallic by row
    and roughness by column, one directional light, small IBL maps.
    Returns (renderer, scene, info, raster config, size)."""
    dev = resolve_device(device)
    mesh = uv_sphere(0.42, stacks=sphere_res, slices=sphere_res + 4)
    entries = []
    for r in range(rows):
        for c in range(cols):
            node = np.eye(4, dtype=np.float32)
            node[3, :3] = [c - (cols - 1) / 2, (rows - 1) / 2 - r, 0.0]
            entries.append((mesh, node, PBRMaterialBasicAttribs.create(
                base_color_factor=(0.8, 0.3, 0.25, 1.0),
                metallic_factor=r / max(rows - 1, 1),
                roughness_factor=max(c / max(cols - 1, 1), 0.05))))
    scene = build_scene(entries, device=dev)
    ci = PBRRendererCreateInfo(enable_ibl=ibl, brdf_lut_dim=16,
                               num_brdf_samples=8, irradiance_cube_dim=16,
                               prefiltered_env_map_dim=16,
                               num_specular_env_samples=8)
    cfg = RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=512, chunk=32,
                           big_tri_capacity=32)
    renderer = PBRRenderer(ci, raster_cfg=cfg, device=dev)
    eye = [0.0, 0.3, 6.0]
    cam = CameraAttribs.create(m3.look_at(eye, [0.0, 0.0, 0.0], device=dev),
                               m3.perspective(0.6, 1.0, 0.1, 100.0,
                                              device=dev),
                               eye, 0.1, 100.0, size, size, device=dev)
    info = RenderInfo(
        camera=cam,
        lights=PBRLightAttribs.directional([-0.5, -0.7, -0.5],
                                           [3.0, 3.0, 3.0], device=dev),
        renderer_params=PBRRendererShaderParameters.create(device=dev))
    return renderer, scene, info, cfg, size


def entry(device=None):
    """(fn, args): the forward frame of the flagship scene (:48-60), IBL
    and lights on, Uncharted2 tone map, sRGB; fn(*args) is the
    (128, 128, 3) frame."""
    renderer, scene, info, cfg, size = build_small(device=device)
    fn = functools.partial(
        _render_frame, width=size, height=size, cfg=cfg, use_ibl=True,
        use_lights=True, debug_view=DebugViewType.NONE,
        tone_mapping_mode=ToneMappingMode.UNCHARTED2,
        convert_output_to_srgb=True)
    return fn, (scene, info, renderer.ibl_maps, renderer.env_oct)


def make_cam(angle: float, width: int = 64, height: Optional[int] = None,
             radius: float = 4.0, eye_y: float = 0.5, far: float = 50.0,
             device=None) -> CameraAttribs:
    """A camera on the orbit of `radius` at height `eye_y`, looking at the
    origin with a vertical field of view of 0.7 rad (:129-134; the
    defaults are the dry run's)."""
    height = width if height is None else height
    a = np.float32(angle)
    eye = [float(np.float32(radius) * np.sin(a)), eye_y,
           float(np.float32(radius) * np.cos(a))]
    dev = resolve_device(device)
    return CameraAttribs.create(
        m3.look_at(eye, [0.0, 0.0, 0.0], device=dev),
        m3.perspective(0.7, width / height, 0.1, far, device=dev), eye,
        0.1, far, width, height, device=dev)


def make_cams(angles: Sequence[float], **kw) -> List[CameraAttribs]:
    """The batch of views (:136, the JAX package's vmapped make_cam): one
    camera an angle."""
    return [make_cam(float(a), **kw) for a in angles]


class InverseProblem(NamedTuple):
    """What the step renders besides the parameters (the JAX dry run's
    closure): the scene, whose materials' base_color_factor the parameters
    replace; the lights and shader parameters (the camera is each
    view's); the env map of the background; the raster config and the
    viewport.  The frame: no IBL, lights on, no tone map, no sRGB."""
    scene: ScenePrimitives
    info: RenderInfo
    env_oct: Tensor
    cfg: RasterizerConfig
    width: int
    height: int


def _with_params(scene: ScenePrimitives, params: Tensor) -> ScenePrimitives:
    return scene._replace(materials=scene.materials._replace(
        base_color_factor=params))


def _view_bands(problem: InverseProblem, scenes, cam: CameraAttribs,
                devices: Sequence[torch.device]) -> List[Tensor]:
    """One view's row bands over `devices`, from the scene copy on each."""
    replicas = {d: (scenes[d], _replicate(problem.info._replace(camera=cam),
                                          d), None, problem.env_oct.to(d))
                for d in dict.fromkeys(devices)}
    return forward_bands(replicas, devices, width=problem.width,
                         height=problem.height, cfg=problem.cfg,
                         use_ibl=False)


def render_one(params: Tensor, cam: CameraAttribs, problem: InverseProblem,
               devices: Optional[Sequence[torch.device]] = None) -> Tensor:
    """One view (:143-146) at the base colours `params`, its rows banded
    over `devices` (default: one band on the parameters' device); the
    (height, width, 3) image on the first of them."""
    devices = [params.device] if devices is None else list(devices)
    scene = _with_params(problem.scene, params)
    scenes = {d: _replicate(scene, d) for d in dict.fromkeys(devices)}
    bands = _view_bands(problem, scenes, cam, devices)
    return torch.cat([b.to(devices[0]) for b in bands])


def loss_fn(params: Tensor, cams: Sequence[CameraAttribs], targets: Tensor,
            mesh: RenderMesh, problem: InverseProblem) -> Tensor:
    """The mean of (image - target)^2 over (B, H, W, 3) (:148-150): the B
    views in contiguous blocks over the mesh's dp rows, each view's rows
    banded over its row's sp devices, the bands' sums of squares added on
    the mesh's first device.  `targets` (B, H, W, 3) may lie anywhere;
    each band reads its rows on its device."""
    rows = mesh.size // mesh.shape["sp"]
    if len(cams) % rows:
        raise ValueError(f"{len(cams)} views do not split over {rows} "
                         "dp rows")
    per_row = len(cams) // rows
    first = mesh.devices.flat[0]
    scene = _with_params(problem.scene, params)
    scenes = {d: _replicate(scene, d) for d in replicated(mesh)}
    total = torch.zeros((), dtype=torch.float32, device=first)
    for i, cam in enumerate(cams):
        devices = band_sharding(mesh, "sp", index=i // per_row)
        y0 = 0
        for dev, band in zip(devices, _view_bands(problem, scenes, cam,
                                                  devices)):
            target = targets[i, y0:y0 + band.shape[0]].to(dev)
            total = total + torch.sum((band - target) ** 2).to(first)
            y0 += band.shape[0]
    return total / float(len(cams) * problem.height * problem.width * 3)


def loss_and_grad(params: Tensor, cams: Sequence[CameraAttribs],
                  targets: Tensor, mesh: RenderMesh,
                  problem: InverseProblem):
    """(loss, d loss / d params) (jax.value_and_grad of loss_fn)."""
    leaf = params.detach().requires_grad_(True)
    loss = loss_fn(leaf, cams, targets, mesh, problem)
    grads, = torch.autograd.grad(loss, leaf)
    return loss.detach(), grads


def train_step(params: Tensor, cams: Sequence[CameraAttribs],
               targets: Tensor, mesh: RenderMesh, problem: InverseProblem):
    """One gradient step (:152-154): (params - 0.1 grads, loss)."""
    loss, grads = loss_and_grad(params, cams, targets, mesh, problem)
    return params.detach() - LEARNING_RATE * grads, loss


class DryrunResult(NamedTuple):
    loss: Tensor
    grads: Tensor
    new_params: Tensor


def dryrun_mesh(devices=None) -> RenderMesh:
    """The dry run's mesh (:126-127) over `devices` (default: every CUDA
    device): sp 4 where 4 divides their count n, else 2 where 2 does,
    else 1; dp n / sp.  A device may repeat (["cpu"] * n on the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun: no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * 4) for the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    sp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return make_render_mesh(dp=n // sp, sp=sp, devices=devices)


def dryrun(mesh: Optional[RenderMesh] = None, devices=None) -> DryrunResult:
    """The dry run's step (:98-176): the scene of build_small(size=64,
    sphere_res=6, ibl=False), one view a dp row at angles
    linspace(0, 1, dp), targets of 0.5, over `mesh` (default: dryrun_mesh
    over `devices`, every CUDA device unless given); raises where the loss
    or a gradient is not finite."""
    mesh = dryrun_mesh(devices) if mesh is None else mesh
    dev = mesh.devices.flat[0]
    renderer, scene, info, cfg, size = build_small(size=64, sphere_res=6,
                                                   ibl=False, device=dev)
    b = mesh.size // mesh.shape["sp"]
    problem = InverseProblem(scene, info, renderer.env_oct, cfg, size, size)
    cams = make_cams(np.linspace(0.0, 1.0, b, dtype=np.float32), width=size,
                     device=dev)
    params = scene.materials.base_color_factor
    targets = torch.full((b, size, size, 3), 0.5, device=dev)
    loss, grads = loss_and_grad(params, cams, targets, mesh, problem)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"dryrun: non-finite loss {float(loss)}")
    if not bool(torch.isfinite(grads).all()):
        raise RuntimeError("dryrun: non-finite gradients")
    print(f"dryrun OK: mesh={mesh.shape} loss={float(loss):.5f}")
    return DryrunResult(loss, grads, params - LEARNING_RATE * grads)

