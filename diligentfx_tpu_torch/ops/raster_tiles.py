"""Two-pass tile raster kernel: wrapper, launcher and plain version (the port
of diligentfx_tpu/ops/raster_pallas.py `raster_tiles_pallas`).

`raster_tiles` launches the hand-written CUDA kernel csrc/raster_tiles.cu
on CUDA tensors and runs `raster_tiles_plain` (the same function in
PyTorch, also the kernel's oracle) on CPU tensors.  The kernel tests each
candidate only inside its pixel rectangle (ops/raster.py
`candidate_rects`); the plain version ignores the rectangles.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from diligentfx_tpu_torch.ops import cuda_build
from diligentfx_tpu_torch.ops.raster_kernel import (_pixel_centres,
                                                    check_rects,
                                                    check_tile_shape,
                                                    raster_tiles_winners_plain)

Tensor = torch.Tensor


def raster_tiles_plain(setup: Tensor, candidates: Tensor, counts: Tensor,
                       rects: Tensor, *,
                       th: int, tw: int, tiles_x: int, depth_less: bool = True,
                       chunk: int = 8, screen_offset=(0, 0)
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the two-pass tile kernel: the z-loop of
    `raster_tiles_winners_plain` (candidates `chunk` at a time), then the
    winner's original triangle id (setup column 15) and its original-
    triangle barycentric planes (columns 9-14) at the pixel centre.  Same
    inputs and outputs as `raster_tiles`; `rects` is ignored (every
    candidate is tested on its whole tile: the unculled oracle of the
    kernel's culling)."""
    del rects
    sign = 1.0 if depth_less else -1.0
    zs, win = raster_tiles_winners_plain(
        setup, candidates, counts, th=th, tw=tw, tiles_x=tiles_x,
        depth_less=depth_less, chunk=chunk, screen_offset=screen_offset)
    px, py = _pixel_centres(candidates.shape[0], th, tw, tiles_x,
                            screen_offset, setup.device)
    s = setup[:, 9:][win]                                  # (tiles,th,tw,7)
    hit = zs < float("inf")
    zero = torch.zeros((), dtype=torch.float32, device=setup.device)
    b0 = torch.where(hit, s[..., 0] * px + s[..., 1] * py + s[..., 2], zero)
    b1 = torch.where(hit, s[..., 3] * px + s[..., 4] * py + s[..., 5], zero)
    tid = torch.where(hit, s[..., 6].to(torch.int32),
                      torch.full((), -1, dtype=torch.int32,
                                 device=setup.device))
    return sign * zs, tid, b0, b1


# dfx_raster_tiles(setup, rects, cand, cap, counts, z, id, b0, b1, num_tiles,
#                  tiles_x, th, tw, depth_less, off_x, off_y, stream)
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _launch(setup, candidates, counts, rects, *, th, tw, tiles_x, depth_less,
            screen_offset):
    dev = setup.device
    for t in (setup, candidates, counts, rects):
        if t.device != dev:
            raise ValueError("raster_tiles: inputs on different devices")
    if setup.dtype != torch.float32:
        raise TypeError("setup must be float32")
    if candidates.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("candidates and counts must be int32")
    if setup.dim() != 2 or setup.shape[1] != 16:
        raise ValueError(f"setup must be (P, 16), got {tuple(setup.shape)}")
    if candidates.dim() != 2:
        raise ValueError("candidates must be (tiles, cap)")
    num_tiles, cap = candidates.shape
    if counts.numel() != num_tiles:
        raise ValueError("counts must hold one entry per tile")
    if num_tiles % tiles_x:
        raise ValueError(f"{num_tiles} tiles do not fill rows of {tiles_x}")
    check_rects(rects, setup, "raster_tiles")
    check_tile_shape(th, tw)
    shape = (num_tiles, th, tw)
    z = torch.empty(shape, dtype=torch.float32, device=dev)
    tid = torch.empty(shape, dtype=torch.int32, device=dev)
    b0 = torch.empty(shape, dtype=torch.float32, device=dev)
    b1 = torch.empty(shape, dtype=torch.float32, device=dev)
    fn = cuda_build.bind("raster_tiles", "dfx_raster_tiles", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(setup.data_ptr(), rects.data_ptr(), candidates.data_ptr(),
                 cap, counts.data_ptr(), z.data_ptr(), tid.data_ptr(),
                 b0.data_ptr(), b1.data_ptr(), num_tiles, tiles_x, th, tw,
                 int(bool(depth_less)), int(screen_offset[0]),
                 int(screen_offset[1]), stream)
    cuda_build.check(err, "raster_tiles kernel launch")
    raster_tiles.launches += 1
    return z, tid, b0, b1


def raster_tiles(setup: Tensor, candidates: Tensor, counts: Tensor,
                 rects: Tensor, *,
                 th: int, tw: int, tiles_x: int, depth_less: bool = True,
                 chunk: int = 8, screen_offset=(0, 0)
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-tile z-loop of the two-pass raster.

    Args:
      setup: (P, 16) raster setup rows (raster._triangle_setup).
      candidates: (tiles, cap) int32 setup-row ids, compact (each tile's
        valid entries first, -1 after).
      counts: (tiles,) int32 valid candidates per tile; the loop stops at
        min(count, cap).
      rects: (P, 4) int32 conservative pixel rectangles of the setup rows
        (raster.candidate_rects); the kernel tests a candidate only inside
        its rectangle, the plain version ignores them.
    Any tile of a multiple of 8 rows by a multiple of 32 columns.
    Returns (z, id, b0, b1), each (tiles, th, tw): depth (the clear value
    +-inf on a miss), the original triangle id (-1), and the barycentrics
    of the original triangle's first two corners (0).

    A CUDA tensor goes to the kernel (or this raises); a CPU tensor runs
    the plain version.  `raster_tiles.launches` counts launches."""
    kw = dict(th=th, tw=tw, tiles_x=tiles_x, depth_less=depth_less,
              screen_offset=screen_offset)
    if setup.device.type == "cuda":
        return _launch(setup.contiguous(), candidates.contiguous(),
                       counts.reshape(-1).contiguous(), rects.contiguous(),
                       **kw)
    if setup.device.type != "cpu":
        raise ValueError(f"raster_tiles: unsupported device {setup.device}")
    return raster_tiles_plain(setup, candidates, counts, rects, chunk=chunk,
                              **kw)


raster_tiles.launches = 0
