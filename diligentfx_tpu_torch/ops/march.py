"""SSR row-DDA march against a small min-depth table (the port of
diligentfx_tpu/ops/march_pallas.py `march_small_table_pallas`).

The ray's v(t) is linear in t, so it crosses each table row in at most one
t-interval [tin, tout] with a closed form.  Each crossed row is split into
two sub-intervals; each sub-interval samples the row at its entry and exit
columns and tests the ray against the entry texel's depth plane, the exit
texel's, and the mixed entry->exit secant, inside a thickness window with
half a sub-interval of slack at the entry.  The first crossing over all
rows is the hit bracket (t_lo, t_hit) that the fine-buffer secant refines.

`march_small_table` launches the hand-written kernel csrc/march.cu on a
CUDA tensor and runs `march_dda_plain` (the port of `march_dda_reference`,
same operation order) on a CPU tensor.  Each 8 x 32 block of the kernel
counting-sorts its rays by the rows they walk (`march_row_span`), and each
lane marches one ray.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from diligentfx_tpu_torch.ops import cuda_build

Tensor = torch.Tensor

TILE_H = 8
TILE_W = 128
# shared memory a block of an H100 can have once the launcher opts in
SMEM_BYTES = 232448
# csrc/march.cu's block: 8 x 32 rays; the rays sorted by the rows they walk
# into 64 buckets (1,280 bytes of shared memory)
BLOCK_H = 8
BLOCK_W = 32
SORT_BUCKETS = 64
SORT_BYTES = 4 * (SORT_BUCKETS + BLOCK_H * BLOCK_W)


def march_table_pitch(rows: int, cols: int) -> int:
    """The row pitch at which csrc/march.cu stages a (rows, cols) table in
    shared memory, beside the sort and the rows + 1 row boundaries (padded
    to 4-float groups): an odd pitch (no bank conflicts between
    neighbouring rows) where that fits, else cols; 0 where the table does
    not fit at all, and the kernel reads it from global memory (its row
    boundaries divided where used).  The wrapper passes it to the
    launcher, which takes it as given."""
    head = SORT_BYTES + ((rows + 4) & ~3) * 4
    for pitch in (cols | 1, cols):
        if head + rows * pitch * 4 <= SMEM_BYTES:
            return pitch
    return 0


def march_warp_walks(walk: Tensor) -> Tensor:
    """The rows each lane of each warp walks, (warps, 32), for the (h, w)
    rows walked a ray (h % 8 == 0, w % 32 == 0), as csrc/march.cu maps rays
    to warps where it sorts: each 8 x 32 block's rays in descending order
    of min(walk, 63), warp w taking positions 32w..32w+31 (rays of one
    bucket in any order)."""
    h, w = walk.shape
    blocks = walk.reshape(h // BLOCK_H, BLOCK_H, w // BLOCK_W, BLOCK_W)
    blocks = blocks.permute(0, 2, 1, 3).reshape(-1, BLOCK_H * BLOCK_W)
    key = blocks.clamp(max=SORT_BUCKETS - 1)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices
    return torch.gather(blocks, 1, idx).reshape(-1, 32)


def _row_plain(row_vals: Tensor, t0: Tensor, t1: Tensor, has: Tensor,
               ou, du, oz, dz, thick, cols: int, t_lo_b: Tensor,
               t_hit_b: Tensor) -> Tuple[Tensor, Tensor]:
    """One sub-interval [t0, t1] against one table row, folded into the
    running first hit: entry-plane, exit-plane and mixed-secant tests."""
    u0 = ou + du * t0
    u1 = ou + du * t1
    x0 = torch.clamp(torch.floor(u0 * cols).long(), 0, cols - 1)
    x1 = torch.clamp(torch.floor(u1 * cols).long(), 0, cols - 1)
    d0 = row_vals[x0]
    d1 = row_vals[x1]
    z0 = oz + dz * t0
    z1 = oz + dz * t1
    slop = torch.abs(dz) * (t1 - t0)
    win = thick + slop
    inside = (u0 > 0.0) & (u0 < 1.0) & (u1 > 0.0) & (u1 < 1.0)
    ok = has & inside
    t_span = t1 - t0
    eps0 = 0.5 * slop      # row-boundary slack (march_pallas.py _dda_body)

    def fold(f0, f1, t_lo_b, t_hit_b):
        cross = ok & (f0 <= eps0) & (f1 > 0.0) & (f1 < win)
        denom = f1 - f0
        frac = torch.where(torch.abs(denom) > 1e-12, -f0 / denom, 1.0)
        t_star = t0 + torch.clamp(frac, 0.0, 1.0) * t_span
        upd = cross & (t_star < t_hit_b)
        return (torch.where(upd, t0, t_lo_b), torch.where(upd, t_star, t_hit_b))

    t_lo_b, t_hit_b = fold(z0 - d0, z1 - d0, t_lo_b, t_hit_b)
    t_lo_b, t_hit_b = fold(z0 - d1, z1 - d1, t_lo_b, t_hit_b)
    return fold(z0 - d0, z1 - d1, t_lo_b, t_hit_b)


def march_row_span(ov: Tensor, dv: Tensor, rows: int
                   ) -> Tuple[Tensor, Tensor]:
    """The rows [r_begin, r_end) that csrc/march.cu walks for rays of
    origin v `ov` and direction v `dv` (the kernel's formula, in float32):
    the rows of v in [ov, ov + dv] widened by one on each side, clamped to
    the table; a flat ray (|dv| <= 1e-7) walks its home row alone.  Every
    row where `march_row_interval` finds a crossing lies inside."""
    frows = float(rows)
    flat = torch.abs(dv) <= 1e-7
    home = torch.clamp(torch.floor(ov * frows).long(), 0, rows - 1)
    v_end = ov + dv
    lo = torch.clamp(torch.minimum(ov, v_end) * frows, -2.0, frows)
    hi = torch.clamp(torch.maximum(ov, v_end) * frows, -2.0, frows)
    r_begin = torch.clamp(torch.floor(lo).long() - 1, min=0)
    r_end = torch.clamp(torch.floor(hi).long() + 2, max=rows)
    return (torch.where(flat, home, r_begin),
            torch.where(flat, home + 1, r_end))


def march_ray_rows(ov: Tensor, dv: Tensor, rows: int
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """A ray's 1 / dv (dv of a flat ray taken as 1e-7), whether it is flat
    (|dv| <= 1e-7) and its home row, as `march_row_interval` takes them."""
    eps = 1e-7
    safe_dv = torch.where(torch.abs(dv) > eps, dv, eps)
    inv_dv = 1.0 / safe_dv
    flat = torch.abs(dv) <= eps
    home_row = torch.clamp(torch.floor(ov * rows).long(), 0, rows - 1)
    return inv_dv, flat, home_row


def march_row_interval(r: int, rows: int, ov: Tensor, inv_dv: Tensor,
                       flat: Tensor, home_row: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Row r's t-interval (tin, tout) and whether the ray crosses it
    (`has`): the clipped t's of v = r / rows and (r + 1) / rows, or all of
    [0, 1] in the home row of a flat ray (march_pallas.py `_dda_body`)."""
    # r / rows in float32 (equal to the reference's double quotient
    # rounded to float32 for every table the march takes)
    ra = float(np.float32(r) / np.float32(rows))
    rb = float((np.float32(r) + np.float32(1.0)) / np.float32(rows))
    ta = (ra - ov) * inv_dv
    tb = (rb - ov) * inv_dv
    tin = torch.clamp(torch.minimum(ta, tb), 0.0, 1.0)
    tout = torch.clamp(torch.maximum(ta, tb), 0.0, 1.0)
    has = (tout > tin) & ~flat
    in_home = flat & (home_row == r)
    tin = torch.where(in_home, 0.0, tin)
    tout = torch.where(in_home, 1.0, tout)
    return tin, tout, has | in_home


def march_dda_plain(coarse: Tensor, origin_uvz: Tensor, dir_uvz: Tensor,
                    thickness_ndc) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch row-DDA (march_pallas.py:230 `march_dda_reference`, in
    the same operation order): every table row, ascending.  coarse
    (rows, cols); origin/dir (..., 3) in (u, v, ndc z).  Returns (t_lo,
    t_hit, hit bool)."""
    rows, cols = coarse.shape
    ou, ov, oz = (origin_uvz[..., i] for i in range(3))
    du, dv, dz = (dir_uvz[..., i] for i in range(3))
    thick = torch.as_tensor(thickness_ndc, dtype=torch.float32,
                            device=coarse.device)
    inv_dv, flat, home_row = march_ray_rows(ov, dv, rows)
    t_lo_b = torch.full(ou.shape, 2.0, dtype=torch.float32, device=ou.device)
    t_hit_b = torch.full(ou.shape, 2.0, dtype=torch.float32,
                         device=ou.device)
    for r in range(rows):
        tin, tout, has = march_row_interval(r, rows, ov, inv_dv, flat,
                                            home_row)
        tm = 0.5 * (tin + tout)
        t_lo_b, t_hit_b = _row_plain(coarse[r], tin, tm, has, ou, du, oz, dz,
                                     thick, cols, t_lo_b, t_hit_b)
        t_lo_b, t_hit_b = _row_plain(coarse[r], tm, tout, has, ou, du, oz, dz,
                                     thick, cols, t_lo_b, t_hit_b)
    found = t_hit_b < 1.5
    return (torch.where(found, t_lo_b, 0.0), torch.where(found, t_hit_b, 1.0),
            found)


def _check_inputs(coarse: Tensor, origin_uvz: Tensor, dir_uvz: Tensor
                  ) -> Tuple[int, int, int, int]:
    if coarse.dim() != 2:
        raise ValueError(f"coarse table must be 2-D, got {tuple(coarse.shape)}")
    rows, cols = coarse.shape
    if cols > TILE_W:
        raise ValueError(f"coarse table has {cols} columns; the march takes "
                         f"at most {TILE_W}")
    if origin_uvz.dim() != 3 or origin_uvz.shape[-1] != 3 \
            or dir_uvz.shape != origin_uvz.shape:
        raise ValueError(f"origin/dir must be (h, w, 3), got "
                         f"{tuple(origin_uvz.shape)}, {tuple(dir_uvz.shape)}")
    h, w = origin_uvz.shape[:2]
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"march grid {h}x{w} is not a multiple of "
                         f"{TILE_H}x{TILE_W}; pad it")
    return rows, cols, h, w


# dfx_march_small_table(coarse, origin, dir, thickness, t_lo, t_hit, hit,
#                       rows, cols, h, w, pitch, stream)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _launch(coarse: Tensor, origin_uvz: Tensor, dir_uvz: Tensor,
            thickness_ndc) -> Tuple[Tensor, Tensor, Tensor]:
    rows, cols, h, w = _check_inputs(coarse, origin_uvz, dir_uvz)
    dev = coarse.device
    if any(t.dtype != torch.float32 for t in (coarse, origin_uvz, dir_uvz)):
        raise TypeError("march_small_table takes float32 tensors")
    if origin_uvz.device != dev or dir_uvz.device != dev:
        raise ValueError("coarse, origin and dir must be on the same device")
    if not (coarse.is_contiguous() and origin_uvz.is_contiguous()
            and dir_uvz.is_contiguous()):
        raise ValueError("march_small_table takes contiguous tensors")
    thick = torch.as_tensor(thickness_ndc, dtype=torch.float32,
                            device=dev).reshape(1).contiguous()
    fn = cuda_build.bind("march", "dfx_march_small_table", _ARGTYPES)
    t_lo = torch.empty((h, w), dtype=torch.float32, device=dev)
    t_hit = torch.empty((h, w), dtype=torch.float32, device=dev)
    hit = torch.empty((h, w), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(coarse.data_ptr(), origin_uvz.data_ptr(), dir_uvz.data_ptr(),
                 thick.data_ptr(), t_lo.data_ptr(), t_hit.data_ptr(),
                 hit.data_ptr(), rows, cols, h, w,
                 march_table_pitch(rows, cols), stream)
    cuda_build.check(err, "march kernel launch")
    march_small_table.launches += 1
    return t_lo, t_hit, hit


def march_small_table(coarse: Tensor, origin_uvz: Tensor, dir_uvz: Tensor,
                      thickness_ndc) -> Tuple[Tensor, Tensor, Tensor]:
    """Row-DDA SSR march: coarse (rows, cols <= 128) min-depth table of any
    height (the kernel stages it in shared memory where
    `march_table_pitch` says so, else reads it from global memory), origin/dir (h, w, 3) in (u,
    v, ndc z) with h % 8 == 0 and w % 128 == 0, thickness_ndc a scalar (a
    tensor stays on its device).  Returns (t_lo (h, w), t_hit (h, w), hit
    (h, w) bool).

    A CUDA tensor goes to the kernel (or this raises); a CPU tensor runs
    the plain version.  `march_small_table.launches` counts kernel
    launches."""
    if coarse.device.type == "cuda":
        return _launch(coarse, origin_uvz, dir_uvz, thickness_ndc)
    if coarse.device.type != "cpu":
        raise ValueError(f"march_small_table: unsupported device "
                         f"{coarse.device}")
    _check_inputs(coarse, origin_uvz, dir_uvz)
    return march_dda_plain(coarse, origin_uvz, dir_uvz, thickness_ndc)


march_small_table.launches = 0
