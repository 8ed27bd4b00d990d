"""Fused tile raster, plain PyTorch on every device (the port of
diligentfx_tpu/ops/raster_pallas.py `raster_tiles_fused_pallas`, as the
port's plain version computes it).  It takes each candidate's pixel
rectangle (ops/raster.py `candidate_rects`), which the port's kernel culls
with and this version ignores.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch


Tensor = torch.Tensor


def _segments(counts: Tensor, cap: int, th: int, sub: int, cap_sub: int,
              big_cap: int) -> List[Tuple[int, Tensor, int, int]]:
    """(start slot, per-tile count, first row, rows) of each candidate
    segment: sub-bin segments, then the big segment on the whole tile."""
    counts = counts.long()
    if sub > 0:
        rows = th // sub
        segs = [(j * cap_sub, torch.clamp(counts[:, j], max=cap_sub), j * rows,
                 rows) for j in range(sub)]
        segs.append((sub * cap_sub, torch.clamp(counts[:, sub], max=big_cap),
                     0, th))
        return segs
    return [(0, torch.clamp(counts.reshape(-1), max=cap), 0, th)]


def _pixel_centres(num_tiles: int, th: int, tw: int, tiles_x: int,
                   screen_offset, dev) -> Tuple[Tensor, Tensor]:
    """Pixel-centre x (tiles, 1, tw) and y (tiles, th, 1) of every tile."""
    tile = torch.arange(num_tiles, device=dev)
    x0 = ((tile % tiles_x) * tw + int(screen_offset[0])).to(torch.float32)
    y0 = ((tile // tiles_x) * th + int(screen_offset[1])).to(torch.float32)
    lx = torch.arange(tw, device=dev, dtype=torch.float32)
    ly = torch.arange(th, device=dev, dtype=torch.float32)
    px = (x0[:, None, None] + lx[None, None, :]) + 0.5
    py = (y0[:, None, None] + ly[None, :, None]) + 0.5
    return px, py


def raster_tiles_winners_plain(setup: Tensor, candidates: Tensor,
                               counts: Tensor, *, th: int, tw: int,
                               tiles_x: int, depth_less: bool = True,
                               chunk: int = 8, sub: int = 0, cap_sub: int = 0,
                               big_cap: int = 0, screen_offset=(0, 0)
                               ) -> Tuple[Tensor, Tensor]:
    """The plain version's z-loop alone, vectorized over tiles and pixels
    and looping over candidates `chunk` at a time (first minimum within a
    chunk, strict less across chunks = strict less in candidate order).

    Returns (sign * z, winner) in tile layout (tiles, th, tw): `winner` is
    the setup row of the winning candidate, slot 0's on a miss."""
    dev = setup.device
    num_tiles, cap = candidates.shape
    sign = 1.0 if depth_less else -1.0
    px, py = _pixel_centres(num_tiles, th, tw, tiles_x, screen_offset, dev)
    zs = torch.full((num_tiles, th, tw), float("inf"), device=dev)
    slot = torch.zeros((num_tiles, th, tw), dtype=torch.int64, device=dev)
    safe = torch.clamp(candidates.long(), min=0)
    step = max(int(chunk), 1)
    for start, count, r0, rows in _segments(counts, cap, th, sub, cap_sub,
                                            big_cap):
        n_max = int(count.max()) if count.numel() else 0
        pxs = px[:, None]                                      # (tiles,1,1,tw)
        pys = py[:, None, r0:r0 + rows]                        # (tiles,1,rows,1)
        for base in range(0, n_max, step):
            c = min(step, n_max - base)
            s = setup[safe[:, start + base:start + base + c]]   # (tiles, c, 16)
            live = (base + torch.arange(c, device=dev))[None, :] < count[:, None]

            def coef(j):
                return s[:, :, j, None, None]

            l0 = coef(0) * pxs + coef(1) * pys + coef(2)
            l1 = coef(3) * pxs + coef(4) * pys + coef(5)
            l2 = 1.0 - l0 - l1
            z = coef(6) * pxs + coef(7) * pys + coef(8)
            cover = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & live[:, :, None, None]
            zc = torch.where(cover, sign * z, torch.full_like(z, float("inf")))
            best, bk = torch.min(zc, dim=1)
            cur = zs[:, r0:r0 + rows]
            take = best < cur
            zs[:, r0:r0 + rows] = torch.where(take, best, cur)
            slot[:, r0:r0 + rows] = torch.where(take, start + base + bk,
                                                slot[:, r0:r0 + rows])
    win = torch.gather(safe, 1, slot.reshape(num_tiles, -1)).reshape(slot.shape)
    return zs, win


def raster_tiles_fused_plain(setup: Tensor, planes: Tensor, candidates: Tensor,
                             counts: Tensor, mat_table: Optional[Tensor],
                             rects: Tensor, *,
                             th: int, tw: int, tiles_x: int, n_ch: int,
                             n_const: int, deriv_channels: tuple = (),
                             depth_less: bool = True, chunk: int = 8,
                             sub: int = 0, cap_sub: int = 0, big_cap: int = 0,
                             screen_offset=(0, 0)
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the fused tile kernel: the z-loop of
    `raster_tiles_winners_plain`, then the epilogue.  Same inputs and
    outputs as `raster_tiles_fused`; `rects` is ignored (every candidate is
    tested on all of its segment's rows: the unculled oracle of the
    kernel's culling)."""
    del rects
    dev = setup.device
    num_tiles = candidates.shape[0]
    tiles_y = num_tiles // tiles_x
    sign = 1.0 if depth_less else -1.0
    zs, win = raster_tiles_winners_plain(
        setup, candidates, counts, th=th, tw=tw, tiles_x=tiles_x,
        depth_less=depth_less, chunk=chunk, sub=sub, cap_sub=cap_sub,
        big_cap=big_cap, screen_offset=screen_offset)
    px, py = _pixel_centres(num_tiles, th, tw, tiles_x, screen_offset, dev)

    # epilogue: the winner's plane row per pixel
    v = planes[win]                                            # (tiles,th,tw,P)
    pxe = px.expand(num_tiles, th, tw)
    pye = py.expand(num_tiles, th, tw)
    da, db, dc = v[..., 0], v[..., 1], v[..., 2]
    den = da * pxe + db * pye + dc
    rcp = 1.0 / torch.where(torch.abs(den) < 1e-20, torch.ones_like(den), den)
    ch_vals, derivs = [], []
    for ch in range(n_ch):
        a, b, cc = v[..., 3 + 3 * ch], v[..., 4 + 3 * ch], v[..., 5 + 3 * ch]
        val = (a * pxe + b * pye + cc) * rcp
        ch_vals.append(val)
        if ch in deriv_channels:
            derivs.append((a - val * da) * rcp)
            derivs.append((b - val * db) * rcp)
    c0 = 3 + 3 * n_ch
    consts = [v[..., c0 + k] for k in range(n_const)]
    hit = zs < float("inf")
    tid = torch.where(hit, consts[-1].to(torch.int32),
                      torch.full_like(win, -1, dtype=torch.int32))
    outs = ch_vals + derivs + consts[:-1]
    if mat_table is not None:
        mid = torch.clamp(consts[0].long(), 0, mat_table.shape[1] - 1)
        outs += list(mat_table[:, mid].unbind(0))

    def untile(x):
        return (x.reshape(tiles_y, tiles_x, th, tw).permute(0, 2, 1, 3)
                .reshape(tiles_y * th, tiles_x * tw))

    z_img = untile(sign * zs)
    id_img = untile(tid)
    out = torch.stack([untile(o) for o in outs]) if outs else \
        torch.empty((0, tiles_y * th, tiles_x * tw), device=dev)
    return z_img, id_img, out


# dfx_raster_fused(setup, rects, planes, n_planes, cand, cap, counts,
#                  counts_stride, mat, n_mrow, n_mat, z_out, id_out, ch_out,
#                  13 ints, stream)


def raster_tiles_fused(setup: Tensor, planes: Tensor, candidates: Tensor,
                       counts: Tensor, mat_table: Optional[Tensor],
                       rects: Tensor, *,
                       th: int, tw: int, tiles_x: int, n_ch: int,
                       n_const: int, deriv_channels: tuple = (),
                       depth_less: bool = True, chunk: int = 8,
                       sub: int = 0, cap_sub: int = 0, big_cap: int = 0,
                       screen_offset=(0, 0)) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused visibility raster + attribute interpolation + material fetch.

    Args:
      setup: (P, 16) raster plane rows (raster._triangle_setup).
      planes: (P, 3*(n_ch+1) + n_const) attribute planes; the last const is
        the original triangle id.
      candidates/counts: compact per-tile lists (tiles, cap) + (tiles,), or
        with sub > 0 the segmented layout (tiles, sub*cap_sub + big_cap) +
        (tiles, sub+1).
      mat_table: optional (n_mrow, M) transposed material table; const 0 is
        then the material id.
      rects: (P, 4) int32 conservative pixel rectangles of the setup rows
        (raster.candidate_rects); the kernel tests a candidate only inside
        its rectangle, the plain version ignores them.
    Any tile of a multiple of 8 rows by a multiple of 32 columns and any
    sub-bin count dividing the rows (`check_tile_shape`).
    Returns (z (H, W) f32, id (H, W) i32, out (OUT_CH, H, W) f32).

    Runs the plain version on any device."""
    kw = dict(th=th, tw=tw, tiles_x=tiles_x, n_ch=n_ch, n_const=n_const,
              deriv_channels=tuple(deriv_channels), depth_less=depth_less,
              sub=sub, cap_sub=cap_sub, big_cap=big_cap,
              screen_offset=screen_offset)
    return raster_tiles_fused_plain(setup, planes, candidates, counts,
                                    mat_table, rects, chunk=chunk, **kw)

