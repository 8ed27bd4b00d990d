"""Tile rasterizer -> visibility buffer (the port of
diligentfx_tpu/ops/raster.py), cut to the fused path.

  1. Triangle setup (vectorized over triangles): near-plane clipping with a
     compacted overflow region for second sub-triangles, screen mapping,
     backface/degenerate culling, barycentric and depth planes, and the
     attribute planes of the fused kernel.
  2. Binning (sort-middle): each small triangle expands to at most
     max_tiles_per_tri (bin, tri) pairs, which are compacted, sorted by a
     packed (bin << tri_bits | tri) key and cut into fixed-capacity
     per-bin candidate lists; big triangles go to per-tile lists (exact
     bbox overlap) or to one global list.
  3. The fused tile raster (ops/raster_kernel.py, K1's plain version):
     z-loop + interpolation + material fetch.

Candidate order within a bin is submission order, so winners (nearest,
first in submission order on ties) match the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from fxbench.reference.dfx.config import RasterizerConfig

Tensor = torch.Tensor

# The 16-float setup row per raster primitive (= near-clipped sub-triangle):
#  0-5  a,b,c planes of the sub-triangle's own l0, l1 (coverage test)
#  6-8  az,bz,cz depth plane
#  9-14 a,b,c planes of the ORIGINAL triangle's l0, l1
#  15   original triangle id (exact in f32 below 2^24)


class VisibilityBuffer(NamedTuple):
    """Per-pixel visibility.  The two-pass path also carries the original
    triangle's screen barycentrics; the fused path interpolates them away
    in its kernel and leaves `bary` None."""
    depth: Tensor               # (H, W) f32, NDC z; background = depth_clear
    tri_id: Tensor              # (H, W) int32, -1 = background
    bary: Optional[Tensor] = None   # (H, W, 2) l0, l1 of the original tri


class RasterStats(NamedTuple):
    max_bin_count: Tensor   # () — max triangles binned into one bin
    bin_overflow: Tensor    # () — pairs dropped by bin or pair capacity
    big_overflow: Tensor    # () — big triangles dropped
    num_culled: Tensor      # () — triangles culled at setup


def _clip_near_plane(corner_clip: Tensor, eps: float,
                     clip_cap: Optional[int] = None):
    """Near-plane (w = eps) clipping with a compacted expansion (JAX
    raster.py:78).  Each triangle yields up to two sub-triangles whose
    corners carry barycentrics in the original triangle; second
    sub-triangles go to a small overflow region of `clip_cap` rows, each
    to its own slot (distinct indices).

    Returns (verts (T+C, 3, 4), corner_bary (T+C, 3, 3), alive (T+C,),
    orig_id (T+C,) int64, clip_overflow ())."""
    c = corner_clip
    t = c.shape[0]
    dev = c.device
    w = c[..., 3]
    inside = w > eps
    ins_i = inside.to(torch.int32)
    n_in = ins_i.sum(-1)
    first_out = torch.argmin(ins_i, dim=-1)
    first_in = torch.argmax(ins_i, dim=-1)
    r = torch.where(n_in == 3, torch.zeros_like(first_in),
                    torch.where(n_in == 2, (first_out + 1) % 3, first_in))
    rot = torch.stack([r, (r + 1) % 3, (r + 2) % 3], dim=-1)
    cr = torch.gather(c, 1, rot[..., None].expand(t, 3, 4))
    br = torch.eye(3, dtype=torch.float32, device=dev)[rot]
    a, b, cc = cr[:, 0], cr[:, 1], cr[:, 2]
    ba, bb, bc = br[:, 0], br[:, 1], br[:, 2]

    def isect(p, q, bp, bq):
        dq = q[:, 3] - p[:, 3]
        tt = (eps - p[:, 3]) / torch.where(torch.abs(dq) < 1e-12,
                                           torch.full_like(dq, 1e-12), dq)
        tt = torch.clamp(tt, 0.0, 1.0)[:, None]
        return p + tt * (q - p), bp + tt * (bq - bp)

    i_ac, b_ac = isect(a, cc, ba, bc)
    i_bc, b_bc = isect(b, cc, bb, bc)
    i_ab, b_ab = isect(a, b, ba, bb)
    two = (n_in == 2)[:, None]
    one = (n_in == 1)[:, None]
    s1_v1 = torch.where(one, i_ab, b)
    s1_b1 = torch.where(one, b_ab, bb)
    s1_v2 = torch.where(two, i_bc, torch.where(one, i_ac, cc))
    s1_b2 = torch.where(two, b_bc, torch.where(one, b_ac, bc))
    slot1_v = torch.stack([a, s1_v1, s1_v2], dim=1)
    slot1_b = torch.stack([ba, s1_b1, s1_b2], dim=1)
    slot1_alive = n_in > 0
    slot2_v = torch.stack([a, i_bc, i_ac], dim=1)
    slot2_b = torch.stack([ba, b_bc, b_ac], dim=1)
    slot2_alive = n_in == 2

    cap = clip_cap if clip_cap is not None else min(max(64, t // 8), t)
    rank = torch.cumsum(slot2_alive.to(torch.int64), 0) - 1
    keep = slot2_alive & (rank < cap)
    src = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    src[rank[keep]] = torch.arange(t, device=dev)[keep]
    ok = src >= 0
    srcc = torch.clamp(src, min=0)
    verts = torch.cat([slot1_v, slot2_v[srcc]], dim=0)
    barys = torch.cat([slot1_b, slot2_b[srcc]], dim=0)
    alive = torch.cat([slot1_alive, ok], dim=0)
    orig = torch.cat([torch.arange(t, device=dev), srcc], dim=0)
    clip_ovf = torch.clamp(slot2_alive.sum() - cap, min=0)
    return verts, barys, alive, orig, clip_ovf


def _triangle_setup(clip: Tensor, indices: Tensor, width: int, height: int,
                    double_sided: Optional[Tensor], front_ccw: bool,
                    near_eps: float, attrs: Optional[Tensor] = None,
                    winv_vert: Optional[Tensor] = None,
                    tri_consts: Optional[Tensor] = None,
                    screen_size=None, screen_offset=(0, 0)):
    """Near-clip + raster setup [+ attribute planes] (JAX raster.py:190).

    With `attrs` (V, C) and `winv_vert` (V,), also the fused kernel's
    attribute planes: perspective-correct interpolation is N_c(x,y)/D(x,y)
    with N_c, D affine per triangle; planes are laid out [D(3), (A,B,C) per
    channel, tri_consts (K)] -> (P, 3*(C+1)+K), P = T + clip-overflow
    capacity.

    Returns (setup (P, 16), valid (P,), bbox (P, 4), orig_id (P,)[, planes],
    clip_ovf ())."""
    idx = indices.long()
    if attrs is not None:
        aw_v = attrs * winv_vert[:, None]
        vdata = torch.cat([clip, winv_vert[:, None], aw_v], dim=-1)
        vd = vdata[idx]                                     # (T, 3, 5+C)
        corner_clip = vd[..., :4]
        corner_attr = vd[..., 4:]
    else:
        corner_clip = clip[idx]
    verts, barys, alive, orig, clip_ovf = _clip_near_plane(corner_clip,
                                                           near_eps)
    t_in = idx.shape[0]
    orig2 = orig[t_in:]
    full_w, full_h = screen_size if screen_size is not None else (width, height)
    off_x, off_y = screen_offset

    w = verts[..., 3]
    winv = 1.0 / torch.clamp(w, min=near_eps * 0.5)
    sx = (verts[..., 0] * winv * 0.5 + 0.5) * full_w
    sy = (0.5 - verts[..., 1] * winv * 0.5) * full_h
    sz = verts[..., 2] * winv
    x0, y0 = sx[:, 0], sy[:, 0]
    x1, y1 = sx[:, 1], sy[:, 1]
    x2, y2 = sx[:, 2], sy[:, 2]

    # glTF CCW front faces have negative cross in y-down screen space
    d = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    front = (d < 0.0) if front_ccw else (d > 0.0)
    if double_sided is None:
        ds = torch.zeros_like(front)
    else:
        ds2 = double_sided.to(torch.bool).expand(t_in)
        ds = torch.cat([ds2, ds2[orig2]])
    nondegenerate = torch.abs(d) > 1e-12
    valid = alive & nondegenerate & (front | ds)
    dinv = torch.where(nondegenerate, 1.0 / d, torch.zeros_like(d))
    a0 = (y1 - y2) * dinv
    b0 = (x2 - x1) * dinv
    c0 = (x1 * y2 - x2 * y1) * dinv
    a1 = (y2 - y0) * dinv
    b1 = (x0 - x2) * dinv
    c1 = (x2 * y0 - x0 * y2) * dinv
    a2 = -(a0 + a1)
    b2 = -(b0 + b1)
    c2 = 1.0 - c0 - c1
    z0, z1, z2 = sz[:, 0], sz[:, 1], sz[:, 2]
    az = a0 * z0 + a1 * z1 + a2 * z2
    bz = b0 * z0 + b1 * z1 + b2 * z2
    cz = c0 * z0 + c1 * z1 + c2 * z2

    # original-triangle screen barycentrics at the sub-triangle corners:
    # lam_s[k, j] = bary[k, j] * w_orig_j / w_corner_k
    w_orig = corner_clip[:, :, 3]
    ow = torch.cat([w_orig, w_orig[orig2]], dim=0)
    lam_s = barys * ow[:, None, :] / torch.clamp(w[..., None], min=1e-12)

    def plane_from_values(v0, v1, v2):
        return (a0 * v0 + a1 * v1 + a2 * v2, b0 * v0 + b1 * v1 + b2 * v2,
                c0 * v0 + c1 * v1 + c2 * v2)

    ao0, bo0, co0 = plane_from_values(lam_s[:, 0, 0], lam_s[:, 1, 0],
                                      lam_s[:, 2, 0])
    ao1, bo1, co1 = plane_from_values(lam_s[:, 0, 1], lam_s[:, 1, 1],
                                      lam_s[:, 2, 1])
    setup = torch.stack([a0, b0, c0, a1, b1, c1, az, bz, cz,
                         ao0, bo0, co0, ao1, bo1, co1,
                         orig.to(torch.float32)], dim=-1)

    xmin = torch.minimum(torch.minimum(x0, x1), x2)
    xmax = torch.maximum(torch.maximum(x0, x1), x2)
    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    ymax = torch.maximum(torch.maximum(y0, y1), y2)
    fox, foy = float(off_x), float(off_y)
    on_screen = ((xmax >= fox) & (xmin < fox + width)
                 & (ymax >= foy) & (ymin < foy + height))
    valid = valid & on_screen
    bbox = torch.stack([xmin - fox, ymin - foy, xmax - fox, ymax - foy],
                       dim=-1)
    if attrs is None:
        return setup, valid, bbox, orig, clip_ovf

    # attribute planes: values of N_c (and D in column 0) at each corner
    corner2 = torch.cat([corner_attr, corner_attr[orig2]], dim=0)
    cv = (lam_s[:, :, 0, None] * corner2[:, None, 0, :]
          + lam_s[:, :, 1, None] * corner2[:, None, 1, :]
          + lam_s[:, :, 2, None] * corner2[:, None, 2, :])   # (P, 3, 1+C)
    pa = a0[:, None] * cv[:, 0] + a1[:, None] * cv[:, 1] + a2[:, None] * cv[:, 2]
    pb = b0[:, None] * cv[:, 0] + b1[:, None] * cv[:, 1] + b2[:, None] * cv[:, 2]
    pc = c0[:, None] * cv[:, 0] + c1[:, None] * cv[:, 1] + c2[:, None] * cv[:, 2]
    planes = torch.stack([pa, pb, pc], dim=-1).reshape(pa.shape[0], -1)
    if tri_consts is not None:
        tc = torch.cat([tri_consts, tri_consts[orig2]], dim=0)
        planes = torch.cat([planes, tc], dim=-1)
    return setup, valid, bbox, orig, planes, clip_ovf


# the fp32 unit roundoff, which bounds the rounding of the coverage test
_U32 = 2.0 ** -24


def candidate_rects(setup: Tensor, width: int, height: int,
                    screen_offset=(0, 0)) -> Tensor:
    """Each setup row's conservative pixel rectangle, (P, 4) int32: x0, y0,
    x1, y1, inclusive framebuffer pixels (pixel (x, y) has its centre at
    screen_offset + (x + 0.5, y + 0.5)).  Every framebuffer pixel whose
    centre the tile rasters' fp32 coverage test finds covered (l0, l1 and
    l2 = (1 - l0) - l1 all >= 0, each plane (a*px + b*py) + c evaluated
    without FMA) lies inside it, with a pixel to spare on each side.

    The rectangle comes from the rounded plane coefficients, not from the
    vertices' box: a sliver's fp32 planes can meet far from its vertices,
    and those planes are what the kernels test.  Over the framebuffer each
    plane evaluation is off by at most d_k (a few ulps of its largest term,
    and for l2 those of l0 and l1), so a pixel the test covers lies in the
    triangle L0 >= -d0, L1 >= -d1, L0 + L1 <= 1 + d2 of the exact planes.
    Its corners are solved in float64 in framebuffer pixels, and their box
    is widened by one pixel and 1e-6 of its extent (float64's own rounding)
    and clamped to [-1, width] x [-1, height], so that a rectangle off the
    framebuffer stays empty.  A row with singular or non-finite planes gets
    the whole framebuffer.

    The frames call this once a raster call and wait on the host for its
    launches, so it is written as about 30 small elementwise PyTorch
    operations over (P, 2, ...) tensors, with its constants copied in once
    (`_rect_constants`); a matrix product here would run as a float64
    GEMM of inner size 12, slower than the rest together."""
    k = _rect_constants(width, height, screen_offset)
    if setup.device.type == "cuda":      # no wait for the copy of 36 floats
        k = k.pin_memory().to(setup.device, non_blocking=True)
    coef, bias, mask = k[:12].view(2, 6), k[12:14], k[14:20].view(2, 3)
    sign = k[20:24].view(2, 2)
    p = setup[:, :6].to(torch.float64).view(-1, 2, 3)   # plane k: a, b, c
    # per plane: t_k (the plane at pixel (0, 0)'s centre plus its rounding
    # bound d_k) and its share of E
    y = (torch.cat([p, p.abs()], -1)[:, :, None, :] * coef).sum(-1) + bias
    e = y[..., 1].sum(-1)
    r = mask * e[:, None, None] - y[..., :1]          # (P, 2, 3) L - c'
    adj = p[..., :2].flip(1, 2).transpose(1, 2) * sign  # [[b1 -b0] [-a1 a0]]
    det = (p[:, 0, :2] * adj[..., 0]).sum(-1)
    xy = (adj[..., None] * r[:, None]).sum(2)          # det * corners' x, y
    lo, hi = torch.aminmax(xy.div_(det[:, None, None]), dim=-1)  # (P, 2)
    ext = hi - lo
    ok = torch.isfinite(ext).all(-1, keepdim=True)
    pad = ext.mul_(1e-6).add_(1.0)
    r = torch.cat([(lo - pad).floor_(), (hi + pad).ceil_()], 1)
    r = torch.where(ok, r.clamp_(k[24:28], k[28:32]), k[32:36])
    return r.to(torch.int32)


def _rect_constants(width: int, height: int, screen_offset) -> Tensor:
    """candidate_rects' 36 float64 constants: `coef` (2, 6) and `bias` (2)
    taking a plane's [a b c |a| |b| |c|] to [t_k, its share of E]; `mask`
    (2, 3), where plane k's corner value is raised by E; the adjugate's
    signs (2, 2); the clamp's low and high ends (4 each); the whole
    framebuffer's rectangle (4).

    With pixel (0, 0)'s centre (cx, cy), each plane at that centre is c_k +
    a_k cx + b_k cy, and its rounding bound is d_k = 4u m_k + 1e-37 (three
    roundings, and underflow), m_k = |a_k| xm + |b_k| ym + |c_k| over the
    framebuffer's |pixel centre| bounds; 1 + d2 = 1 + d0 + d1 + 3u (1 + 2
    (m0 + m1)) + 1e-37.  The corners' (L0, L1) are (-d0, -d1), (-d0, 1 + d2
    + d0) and (1 + d2 + d1, -d1), so L - c' = -t_k + E at plane 0's corner
    2 and plane 1's corner 1, with t_k = c_k + a_k cx + b_k cy + d_k and E
    = 1 + d2 + d0 + d1 = 1 + 3u + 5e-37 + 14u (m0 + m1)."""
    ox, oy = float(screen_offset[0]), float(screen_offset[1])
    xm = max(abs(ox), abs(ox + width))
    ym = max(abs(oy), abs(oy + height))
    u = _U32
    coef = [ox + 0.5, oy + 0.5, 1.0, 4 * u * xm, 4 * u * ym, 4 * u,
            0.0, 0.0, 0.0, 14 * u * xm, 14 * u * ym, 14 * u]
    bias = [1e-37, (1 + 3 * u + 5e-37) / 2]
    mask = [0.0, 0.0, 1.0, 0.0, 1.0, 0.0]
    sign = [1.0, -1.0, -1.0, 1.0]
    limits = [-1.0] * 4 + [float(width), float(height)] * 2
    whole = [0.0, 0.0, float(width - 1), float(height - 1)]
    return torch.tensor(coef + bias + mask + sign + limits + whole,
                        dtype=torch.float64)


def _tile_span(v: Tensor, size: int, n: int) -> Tensor:
    """clip(floor(v / size), 0, n - 1) as int64, clamped before the cast
    (XLA's float->int convert saturates and maps NaN to 0)."""
    return torch.clamp(torch.nan_to_num(torch.floor(v / size), nan=0.0),
                       0, n - 1).long()


def _pair_expansion(n_cover: Tensor, span_x: Tensor, x0: Tensor, y0: Tensor,
                    tiles_x: int, is_small: Tensor, k_max: int):
    """(bin, valid) of each triangle's k-th covered bin, k < k_max."""
    dev = n_cover.device
    k = torch.arange(k_max, device=dev)
    # k // span via the float reciprocal, as the JAX package does (exact
    # for k < K: (k + 0.5) / span never lands near an integer)
    inv_span = 1.0 / torch.clamp(span_x[:, None], min=1).to(torch.float32)
    ky = torch.floor((k[None, :].to(torch.float32) + 0.5) * inv_span).long()
    kx = k[None, :] - ky * torch.clamp(span_x[:, None], min=1)
    pair_bin = (y0[:, None] + ky) * tiles_x + (x0[:, None] + kx)
    pair_valid = is_small[:, None] & (k[None, :] < n_cover[:, None])
    return pair_bin, pair_valid


def _compact_sort_pairs(pair_bin: Tensor, pair_valid: Tensor, is_small: Tensor,
                        n_cover: Tensor, num_bins: int, cap: int):
    """Scatter the valid (bin, tri) pairs to distinct ordered slots of a
    `cap`-row buffer (exclusive-cumsum offsets; pairs past the cap drop),
    then sort the packed keys.  Returns (sorted_bin, sorted_tri,
    total_pairs)."""
    dev = pair_bin.device
    t, kk = pair_bin.shape
    tri_bits = max(int(t).bit_length(), 1)
    n_small = torch.where(is_small, n_cover, torch.zeros_like(n_cover))
    off = torch.cumsum(n_small, 0) - n_small
    pos = off[:, None] + torch.arange(kk, device=dev)[None, :]
    keep = pair_valid & (pos < cap)
    packed = (pair_bin << tri_bits) | torch.arange(t, device=dev)[:, None]
    buf = torch.full((cap,), num_bins << tri_bits, dtype=torch.int64,
                     device=dev)
    buf[pos[keep]] = packed[keep]
    srt = torch.sort(buf, stable=True).values
    return srt >> tri_bits, srt & ((1 << tri_bits) - 1), n_small.sum()


def _bin_triangles(valid: Tensor, bbox: Tensor, width: int, height: int,
                   cfg: RasterizerConfig):
    """Unsegmented binning (JAX raster.py:350), compact layout only: each
    tile's small candidates followed by the global big list.

    Returns (compact (tiles, bin_cap + big_cap), counts_total (tiles,),
    max_count, overflow, big_overflow)."""
    dev = valid.device
    tiles_x = width // cfg.tile_w
    tiles_y = height // cfg.tile_h
    num_tiles = tiles_x * tiles_y
    t = valid.shape[0]
    tx0 = _tile_span(bbox[:, 0], cfg.tile_w, tiles_x)
    ty0 = _tile_span(bbox[:, 1], cfg.tile_h, tiles_y)
    tx1 = _tile_span(bbox[:, 2], cfg.tile_w, tiles_x)
    ty1 = _tile_span(bbox[:, 3], cfg.tile_h, tiles_y)
    span_x = tx1 - tx0 + 1
    n_cover = span_x * (ty1 - ty0 + 1)
    is_small = valid & (n_cover <= cfg.max_tiles_per_tri)
    is_big = valid & (n_cover > cfg.max_tiles_per_tri)
    pair_tile, pair_valid = _pair_expansion(n_cover, span_x, tx0, ty0, tiles_x,
                                            is_small, cfg.max_tiles_per_tri)
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    tri_bits = max(int(t).bit_length(), 1)
    compaction = cfg.pair_compaction_cap > 0 and tile_bits + tri_bits <= 31
    if compaction:
        sorted_tile, sorted_tri, total_pairs = _compact_sort_pairs(
            pair_tile, pair_valid, is_small, n_cover, num_tiles,
            cfg.pair_compaction_cap)
    else:
        flat_tile = torch.where(pair_valid, pair_tile,
                                torch.full_like(pair_tile, num_tiles)).reshape(-1)
        flat_tri = torch.arange(t, device=dev)[:, None].expand(
            pair_tile.shape).reshape(-1)
        order = torch.sort(flat_tile, stable=True).indices
        sorted_tile, sorted_tri = flat_tile[order], flat_tri[order]
    counts = torch.bincount(sorted_tile, minlength=num_tiles + 1)[:num_tiles]
    starts = torch.cumsum(counts, 0) - counts
    j = torch.arange(cfg.bin_capacity, device=dev)
    in_bin = j[None, :] < torch.clamp(counts[:, None], max=cfg.bin_capacity)
    gather_idx = torch.clamp(starts[:, None] + j[None, :], 0,
                             sorted_tri.shape[0] - 1)
    cand_small = torch.where(in_bin, sorted_tri[gather_idx],
                             torch.full_like(gather_idx, -1))

    big_cap = cfg.big_tri_capacity
    big_rank = torch.cumsum(is_big.to(torch.int64), 0) - 1
    sel = is_big & (big_rank < big_cap)
    big_ids = torch.zeros(big_cap, dtype=torch.int64, device=dev)
    big_ids[big_rank[sel]] = torch.arange(t, device=dev)[sel]
    n_big = is_big.sum()
    big_valid = torch.arange(big_cap, device=dev) < n_big
    big_list = torch.where(big_valid, big_ids, torch.full_like(big_ids, -1))

    # big entries directly follow each tile's small candidates
    small_counts = torch.clamp(counts, max=cfg.bin_capacity)
    compact = torch.cat([cand_small, torch.full((num_tiles, big_cap), -1,
                                                dtype=torch.int64, device=dev)],
                        dim=1)
    cols = small_counts[:, None] + torch.arange(big_cap, device=dev)[None, :]
    compact.scatter_(1, cols, big_list[None, :].expand(num_tiles, big_cap))
    counts_total = small_counts + n_big

    overflow = torch.clamp(counts - cfg.bin_capacity, min=0).sum()
    if compaction:
        overflow = overflow + torch.clamp(total_pairs - cfg.pair_compaction_cap,
                                          min=0)
    big_overflow = torch.clamp(n_big - big_cap, min=0)
    return (compact.to(torch.int32), counts_total.to(torch.int32),
            counts.max(), overflow, big_overflow)


def _bin_triangles_sub(valid: Tensor, bbox: Tensor, width: int, height: int,
                       cfg: RasterizerConfig):
    """Sub-bin binning for the fused kernel (JAX raster.py:493): small
    triangles bin at (tile_h / sub_bins, tile_w) granularity; big triangles
    bin by exact bbox overlap per kernel tile.

    Returns (cand (tiles, sub*cap_sub + big_cap) int32, row-compact per
    segment with -1 padding; seg_counts (tiles, sub+1) int32; max_count;
    overflow; big_overflow)."""
    dev = valid.device
    sub = max(cfg.sub_bins, 1)
    bin_h = cfg.tile_h // sub
    cap_sub = cfg.bin_capacity // sub
    big_cap = cfg.big_tile_capacity or cfg.big_tri_capacity
    big_cap = -(-big_cap // cfg.chunk) * cfg.chunk
    tiles_x = width // cfg.tile_w
    tiles_y = height // cfg.tile_h
    num_tiles = tiles_x * tiles_y
    bins_y = tiles_y * sub
    num_bins = bins_y * tiles_x
    t = valid.shape[0]

    tx0 = _tile_span(bbox[:, 0], cfg.tile_w, tiles_x)
    by0 = _tile_span(bbox[:, 1], bin_h, bins_y)
    tx1 = _tile_span(bbox[:, 2], cfg.tile_w, tiles_x)
    by1 = _tile_span(bbox[:, 3], bin_h, bins_y)
    span_x = tx1 - tx0 + 1
    n_cover = span_x * (by1 - by0 + 1)
    is_small = valid & (n_cover <= cfg.max_tiles_per_tri)
    is_big = valid & (n_cover > cfg.max_tiles_per_tri)
    pair_bin, pair_valid = _pair_expansion(n_cover, span_x, tx0, by0, tiles_x,
                                           is_small, cfg.max_tiles_per_tri)
    bin_bits = max(int(num_bins + 1).bit_length(), 1)
    tri_bits = max(int(t).bit_length(), 1)
    assert bin_bits + tri_bits <= 31, (
        f"sub-binning needs bin+tri ids to pack into an int31 "
        f"({bin_bits}+{tri_bits}); lower sub_bins or split the raster")
    cap = cfg.pair_compaction_cap or t * cfg.max_tiles_per_tri
    sorted_bin, sorted_tri, total_pairs = _compact_sort_pairs(
        pair_bin, pair_valid, is_small, n_cover, num_bins, cap)
    counts = torch.bincount(sorted_bin, minlength=num_bins + 1)[:num_bins]
    starts = torch.cumsum(counts, 0) - counts
    # gather index built directly in kernel-tile layout: tile t's segment s
    # reads bin (ty*sub + s)*tiles_x + tx
    t_id = torch.arange(num_tiles, device=dev)[:, None]
    s_id = torch.arange(sub, device=dev)[None, :]
    bin_id = ((t_id // tiles_x) * sub + s_id) * tiles_x + (t_id % tiles_x)
    seg_counts = torch.clamp(counts[bin_id], max=cap_sub)
    starts_t = starts[bin_id]
    j_id = torch.arange(cap_sub, device=dev)[None, None, :]
    gather_idx = torch.clamp(starts_t[:, :, None] + j_id, 0,
                             sorted_tri.shape[0] - 1)
    cand_small = torch.where(j_id < seg_counts[:, :, None],
                             sorted_tri[gather_idx],
                             torch.full_like(gather_idx, -1)
                             ).reshape(num_tiles, sub * cap_sub)

    # big triangles: exact per-tile bbox overlap
    btc = cfg.big_tri_capacity
    big_rank = torch.cumsum(is_big.to(torch.int64), 0) - 1
    sel = is_big & (big_rank < btc)
    big_ids = torch.full((btc,), -1, dtype=torch.int64, device=dev)
    big_ids[big_rank[sel]] = torch.arange(t, device=dev)[sel]
    n_big = is_big.sum()
    big_valid = torch.arange(btc, device=dev) < n_big
    safe_big = torch.clamp(big_ids, min=0)
    btx0, bty0 = tx0[safe_big], by0[safe_big] // sub
    btx1, bty1 = tx1[safe_big], by1[safe_big] // sub
    tid2 = torch.arange(num_tiles, device=dev)
    ttx = (tid2 % tiles_x)[:, None]
    tty = (tid2 // tiles_x)[:, None]
    ov = (big_valid[None, :] & (ttx >= btx0[None, :]) & (ttx <= btx1[None, :])
          & (tty >= bty0[None, :]) & (tty <= bty1[None, :]))
    bpos = torch.cumsum(ov.to(torch.int64), dim=1) - 1
    cand_big = torch.full((num_tiles, big_cap + 1), -1, dtype=torch.int64,
                          device=dev)
    cols = torch.where(ov, torch.clamp(bpos, max=big_cap),
                       torch.full_like(bpos, big_cap))
    # every kept entry has its own column; only the dropped column big_cap
    # may receive several writes
    cand_big.scatter_(1, cols, big_ids[None, :].expand(num_tiles, btc))
    cand_big = cand_big[:, :big_cap]
    n_ov = ov.sum(dim=1)
    big_counts = torch.clamp(n_ov, max=big_cap)

    cand = torch.cat([cand_small, cand_big], dim=1)
    seg_counts = torch.cat([seg_counts, big_counts[:, None]], dim=1)
    overflow = (torch.clamp(counts - cap_sub, min=0).sum()
                + torch.clamp(total_pairs - cap, min=0))
    big_overflow = (torch.clamp(n_big - btc, min=0)
                    + torch.clamp(n_ov - big_cap, min=0).sum())
    return (cand.to(torch.int32), seg_counts.to(torch.int32), counts.max(),
            overflow, big_overflow)


class FusedKernelInputs(NamedTuple):
    """Everything the fused tile kernel takes (raster_tiles_fused's
    arguments), plus the raster statistics of the setup and binning."""
    setup: Tensor
    planes: Tensor
    candidates: Tensor
    counts: Tensor
    mat_table: Optional[Tensor]
    rects: Tensor
    kernel_kw: dict
    stats: RasterStats


def prepare_fused(clip: Tensor, indices: Tensor, attrs: Tensor, winv: Tensor,
                  tri_consts: Optional[Tensor], mat_table: Optional[Tensor], *,
                  width: int, height: int, cfg: RasterizerConfig, n_ch: int,
                  deriv_channels: tuple = (),
                  double_sided: Optional[Tensor] = None,
                  front_ccw: bool = True, depth_less: bool = True,
                  near_eps: float = 1e-3, screen_size=None,
                  screen_offset=(0, 0)) -> FusedKernelInputs:
    """Triangle setup + binning of rasterize_fused: the fused kernel's
    inputs.  Same arguments as rasterize_fused."""
    if width % cfg.tile_w or height % cfg.tile_h:
        raise ValueError(f"{width}x{height} not tile-aligned")
    setup, valid, bbox, orig, planes, clip_ovf = _triangle_setup(
        clip, indices, width, height, double_sided, front_ccw, near_eps,
        attrs, winv, tri_consts, screen_size=screen_size,
        screen_offset=screen_offset)
    # the original triangle id rides the planes table as one more const
    planes = torch.cat([planes, orig[:, None].to(torch.float32)], dim=-1)
    if cfg.sub_bins > 1 or cfg.big_tile_capacity > 0:
        cand, counts, max_count, overflow, big_overflow = _bin_triangles_sub(
            valid, bbox, width, height, cfg)
        sub = max(cfg.sub_bins, 1)
        cap_sub = cfg.bin_capacity // sub
        big_cap = cand.shape[1] - sub * cap_sub
    else:
        cand, counts, max_count, overflow, big_overflow = _bin_triangles(
            valid, bbox, width, height, cfg)
        sub = cap_sub = big_cap = 0
    n_const = (0 if tri_consts is None else tri_consts.shape[1]) + 1
    kernel_kw = dict(th=cfg.tile_h, tw=cfg.tile_w, tiles_x=width // cfg.tile_w,
                     n_ch=n_ch, n_const=n_const,
                     deriv_channels=tuple(deriv_channels),
                     depth_less=depth_less, chunk=cfg.chunk, sub=sub,
                     cap_sub=cap_sub, big_cap=big_cap,
                     screen_offset=screen_offset)
    stats = RasterStats(max_bin_count=max_count,
                        bin_overflow=overflow + clip_ovf,
                        big_overflow=big_overflow,
                        num_culled=(~valid).sum())
    rects = candidate_rects(setup, width, height, screen_offset)
    return FusedKernelInputs(setup, planes, cand, counts, mat_table, rects,
                             kernel_kw, stats)


# ---------------------------------------------------------------------------
# Attribute interpolation (the deferred half of the two-pass path)
# ---------------------------------------------------------------------------


def _weighted_corners(a: Tensor, pb: Tensor) -> Tensor:
    """sum_k a[..., k, :] * pb[..., k] over the three corners, in order."""
    return ((a[..., 0, :] * pb[..., 0:1] + a[..., 1, :] * pb[..., 1:2])
            + a[..., 2, :] * pb[..., 2:3])


def interpolate(vb: VisibilityBuffer, indices: Tensor, attr: Tensor,
                pbary: Tensor, background=0.0) -> Tensor:
    """Perspective-correct interpolation of a per-vertex attribute (V, C)
    with `perspective_bary`'s weights -> (H, W, C) (JAX raster.py:943)."""
    vidx = indices.long()[torch.clamp(vb.tri_id, min=0).long()]
    out = _weighted_corners(attr[vidx], pbary)
    return torch.where((vb.tri_id >= 0)[..., None], out,
                       torch.as_tensor(background, dtype=out.dtype,
                                       device=out.device))


def pad_viewport(width: int, height: int, cfg: RasterizerConfig
                 ) -> Tuple[int, int]:
    """Round a viewport up to the tile grid (render padded, crop after)."""
    return (-(-width // cfg.tile_w) * cfg.tile_w,
            -(-height // cfg.tile_h) * cfg.tile_h)
