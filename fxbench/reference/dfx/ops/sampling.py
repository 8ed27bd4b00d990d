"""Texture sampling (the port of diligentfx_tpu/ops/sampling.py, the parts
the first slice uses): clamp-wrapped point / bilinear taps, octahedral
environment mapping, SH-9 evaluation, the footprint-packed prefiltered
pyramid and the integer-factor bilinear upsample.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

Tensor = torch.Tensor

# texture wrap modes (the JAX package's sampling.py:22-24)
WRAP_REPEAT = 0
WRAP_MIRROR = 1
WRAP_CLAMP = 2


def _clamp_idx(i: Tensor, size) -> Tensor:
    return torch.clamp(i, 0, size - 1)


def point_sample(img: Tensor, uv: Tensor) -> Tensor:
    """Nearest sample, clamp wrap. img (H, W, C), uv (..., 2) in [0,1]."""
    h, w = img.shape[0], img.shape[1]
    x = _clamp_idx(torch.floor(uv[..., 0] * w).long(), w)
    y = _clamp_idx(torch.floor(uv[..., 1] * h).long(), h)
    return img[y, x]


def bilinear_sample(img: Tensor, uv: Tensor) -> Tensor:
    """Bilinear sample, clamp wrap. img (H, W, C), uv (..., 2) -> (..., C)."""
    h, w = img.shape[0], img.shape[1]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    x0w, x1w = _clamp_idx(x0, w), _clamp_idx(x0 + 1, w)
    y0w, y1w = _clamp_idx(y0, h), _clamp_idx(y0 + 1, h)
    c00 = img[y0w, x0w]
    c10 = img[y0w, x1w]
    c01 = img[y1w, x0w]
    c11 = img[y1w, x1w]
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def sample_mip_trilinear(mips: Sequence[Tensor], uv: Tensor,
                         lod: Tensor) -> Tensor:
    """Trilinear sample from an explicit mip chain: every level is sampled
    with a per-pixel weight (static sum over the short chain)."""
    n = len(mips)
    lod = torch.clamp(lod, 0.0, n - 1)
    lo = torch.floor(lod)
    frac = lod - lo
    out = None
    for i, mip in enumerate(mips):
        w_i = torch.where(lo == i, 1.0 - frac,
                          torch.where(lo == i - 1, frac, torch.zeros_like(frac)))
        if i == n - 1:
            w_i = torch.where(lo >= n - 1, torch.ones_like(w_i), w_i)
        term = bilinear_sample(mip, uv) * w_i[..., None]
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# Octahedral environment mapping
# ---------------------------------------------------------------------------


def dir_to_oct_uv(d: Tensor) -> Tensor:
    """Unit direction (..., 3) -> octahedral uv in [0,1]^2 (y-up world)."""
    n = d / torch.clamp(torch.sum(torch.abs(d), dim=-1, keepdim=True),
                        min=1e-12)
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    lower = y < 0.0
    uf = (1.0 - torch.abs(z)) * torch.sign(x + 1e-20)
    vf = (1.0 - torch.abs(x)) * torch.sign(z + 1e-20)
    u = torch.where(lower, uf, x)
    v = torch.where(lower, vf, z)
    return torch.stack([u, v], dim=-1) * 0.5 + 0.5


def oct_uv_to_dir(uv: Tensor) -> Tensor:
    """Octahedral uv in [0,1]^2 -> unit direction (..., 3)."""
    f = uv * 2.0 - 1.0
    u, v = f[..., 0], f[..., 1]
    y = 1.0 - torch.abs(u) - torch.abs(v)
    lower = y < 0.0
    uu = torch.where(lower, (1.0 - torch.abs(v)) * torch.sign(u + 1e-20), u)
    vv = torch.where(lower, (1.0 - torch.abs(u)) * torch.sign(v + 1e-20), v)
    d = torch.stack([uu, y, vv], dim=-1)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=1e-12)


def _oct_grid(res: int, device=None):
    t = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    v, u = torch.meshgrid(t, t, indexing="ij")
    return u, v


def oct_pixel_dirs(res: int, device=None) -> Tensor:
    """(res, res, 3) unit directions at octahedral texel centers."""
    u, v = _oct_grid(res, device)
    return oct_uv_to_dir(torch.stack([u, v], dim=-1))


def oct_solid_angles(res: int, device=None) -> Tensor:
    """(res, res) approximate solid angle per octahedral texel (sums to 4pi)."""
    u, v = _oct_grid(res, device)
    u = u * 2 - 1
    v = v * 2 - 1
    y = 1.0 - torch.abs(u) - torch.abs(v)
    lower = y < 0
    uu = torch.where(lower, (1.0 - torch.abs(v)) * torch.sign(u + 1e-20), u)
    vv = torch.where(lower, (1.0 - torch.abs(u)) * torch.sign(v + 1e-20), v)
    p = torch.stack([uu, y, vv], dim=-1)
    r = torch.linalg.vector_norm(p, dim=-1)
    w = 1.0 / torch.clamp(r, min=1e-9) ** 3
    w = w * ((2.0 / res) * (2.0 / res) * 2.0)
    return w * (4.0 * torch.pi / torch.sum(w))


def sample_env_oct(mips: Sequence[Tensor], direction: Tensor,
                   lod: Tensor) -> Tensor:
    """Sample an octahedral environment mip chain by direction (..., 3)."""
    return sample_mip_trilinear(mips, dir_to_oct_uv(direction), lod)


def sh9_basis(d: Tensor) -> Tensor:
    """(..., 3) dirs -> (..., 9) real spherical-harmonic basis values."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([
        torch.full_like(x, 0.282095),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
    ], dim=-1)


def sh9_eval(d: Tensor, sh_coeffs: Tensor) -> Tensor:
    """sum_k basis_k(d) * sh_coeffs[k] as unrolled multiply-adds (k in
    order, as the JAX package does).  d (..., 3), sh_coeffs (9, C)."""
    basis = sh9_basis(d)
    chans = []
    for c in range(sh_coeffs.shape[1]):
        acc = torch.zeros_like(basis[..., 0])
        for k in range(9):
            acc = acc + basis[..., k] * sh_coeffs[k, c]
        chans.append(acc)
    return torch.stack(chans, dim=-1)


def build_mip_chain(img: Tensor, num_levels: int) -> List[Tensor]:
    """2x2 box-filter mip chain."""
    mips = [img]
    cur = img
    for _ in range(num_levels - 1):
        h, w = cur.shape[0], cur.shape[1]
        if h < 2 or w < 2:
            break
        cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                      + cur[0::2, 1::2] + cur[1::2, 1::2])
        mips.append(cur)
    return mips


# ---------------------------------------------------------------------------
# Footprint-packed prefiltered pyramid
# ---------------------------------------------------------------------------


def build_packed_pyramid(mips: Sequence[Tensor]) -> Tensor:
    """Pack a square mip chain into a footprint table: one row per texel of
    levels 0..L-2 with its clamped fine 2x2 bilinear footprint (12 floats)
    and the 3x3 coarse window at level l+1 around the texel's coarse image
    (27 floats), plus one pad column -> (R, 40).  Levels may halve or
    repeat their size."""
    packs = []
    for lvl in range(max(len(mips) - 1, 1)):
        img = mips[lvl]
        coarse = mips[lvl + 1] if lvl + 1 < len(mips) else mips[lvl]
        n = img.shape[0]
        halving = coarse.shape[0] != n
        assert coarse.shape[0] == n or coarse.shape[0] * 2 == n, \
            f"mip step must be same-size or exact half, got {n}->{coarse.shape[0]}"

        def shift(a, dy, dx):
            ys = torch.clamp(torch.arange(a.shape[0], device=a.device) + dy,
                             0, a.shape[0] - 1)
            xs = torch.clamp(torch.arange(a.shape[1], device=a.device) + dx,
                             0, a.shape[1] - 1)
            return a[ys][:, xs]

        fine = [img, shift(img, 0, 1), shift(img, 1, 0), shift(img, 1, 1)]
        cw = []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                c = shift(coarse, dy, dx)
                if halving:
                    c = c.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
                cw.append(c[:n, :n])
        row = torch.cat(fine + cw, dim=-1)
        packs.append(row.reshape(n * n, 39))
    packed = torch.cat(packs, dim=0)
    return torch.nn.functional.pad(packed, (0, 1))


def _packed_level_bilinear(g: Tensor, base: int, tx: Tensor,
                           ty: Tensor) -> Tensor:
    c00 = g[..., base + 0:base + 3]
    c10 = g[..., base + 3:base + 6]
    c01 = g[..., base + 6:base + 9]
    c11 = g[..., base + 9:base + 12]
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def sample_pyramid_packed(packed: Tensor, sizes: Sequence[int], uv: Tensor,
                          lod: Tensor) -> Tensor:
    """Full trilinear sample of a clamp-wrapped square mip pyramid with one
    row gather per pixel from a build_packed_pyramid table (JAX
    sampling.py:285).  sizes: static per-level dims."""
    sizes = tuple(int(s) for s in sizes)
    num_levels = len(sizes)
    expect_rows = (sum(s * s for s in sizes[:-1]) if num_levels > 1
                   else sizes[0] ** 2)
    assert packed.shape[0] == expect_rows, (packed.shape, sizes)
    lod = torch.clamp(lod, 0.0, num_levels - 1.0)
    lvl = torch.clamp(torch.floor(lod), 0, max(num_levels - 2, 0))
    frac = torch.clamp(lod - lvl, 0.0, 1.0)[..., None]
    lvl = lvl.long()
    n = torch.full_like(lvl, sizes[0])
    off = torch.zeros_like(lvl)
    halv = torch.ones(lvl.shape, dtype=torch.bool, device=lvl.device)
    acc = 0
    for i in range(max(num_levels - 1, 1)):
        sel = lvl == i
        n = torch.where(sel, sizes[i], n)
        off = torch.where(sel, acc, off)
        nxt = sizes[min(i + 1, num_levels - 1)]
        halv = torch.where(sel, nxt != sizes[i], halv)
        acc += sizes[i] ** 2

    nf = n.to(torch.float32)
    fx = uv[..., 0] * nf - 0.5
    fy = uv[..., 1] * nf - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    x0 = x0f.long()
    y0 = y0f.long()
    zero = torch.zeros_like(fx)
    tx = torch.where(x0 < 0, zero, fx - x0f)[..., None]
    ty = torch.where(y0 < 0, zero, fy - y0f)[..., None]
    x0p = torch.minimum(torch.clamp(x0, min=0), n - 1)
    y0p = torch.minimum(torch.clamp(y0, min=0), n - 1)

    g = packed[off + y0p * n + x0p]
    fine = _packed_level_bilinear(g, 0, tx, ty)

    fxc = torch.where(halv, fx * 0.5 - 0.25, fx)
    fyc = torch.where(halv, fy * 0.5 - 0.25, fy)
    xc0f = torch.floor(fxc)
    yc0f = torch.floor(fyc)
    xc0 = xc0f.long()
    yc0 = yc0f.long()
    tcx = torch.where(xc0 < 0, zero, fxc - xc0f)[..., None]
    tcy = torch.where(yc0 < 0, zero, fyc - yc0f)[..., None]
    cx = torch.where(halv, x0p >> 1, x0p)
    cy = torch.where(halv, y0p >> 1, y0p)
    jx1 = (torch.clamp(xc0 - (cx - 1), 0, 2) == 1)[..., None]
    jy1 = (torch.clamp(yc0 - (cy - 1), 0, 2) == 1)[..., None]

    def ent(r, c):
        b = 12 + (r * 3 + c) * 3
        return g[..., b:b + 3]

    def pick(a, b):
        top = torch.where(jx1, ent(a, b + 1), ent(a, b))
        bot = torch.where(jx1, ent(a + 1, b + 1), ent(a + 1, b))
        return torch.where(jy1, bot, top)

    p00, p01, p10, p11 = pick(0, 0), pick(0, 1), pick(1, 0), pick(1, 1)
    ctop = p00 + (p01 - p00) * tcx
    cbot = p10 + (p11 - p10) * tcx
    coarse = ctop + (cbot - ctop) * tcy
    return fine + (coarse - fine) * frac


# ---------------------------------------------------------------------------
# Integer-factor bilinear upsample
# ---------------------------------------------------------------------------


def _upsample_axis(x: Tensor, f: int, axis: int) -> Tensor:
    """Interleave f bilinear phases along `axis` (output i samples input at
    (i + 0.5)/f - 0.5, edge-clamped)."""
    if f == 1:
        return x
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), last], dim=axis)
    prv = torch.cat([first, x.narrow(axis, 0, n - 1)], dim=axis)
    phases = []
    for p in range(f):
        t = (p + 0.5) / f - 0.5
        if t >= 0:
            phases.append(x * (1.0 - t) + nxt * t)
        else:
            phases.append(prv * (-t) + x * (1.0 + t))
    st = torch.stack(phases, dim=axis + 1)
    new_shape = list(x.shape)
    new_shape[axis] = n * f
    return st.reshape(new_shape)


def upsample_bilinear(x: Tensor, fy: int, fx: int) -> Tensor:
    """Integer-factor bilinear upsample of (H, W, C) (edge-clamped)."""
    return _upsample_axis(_upsample_axis(x, fy, 0), fx, 1)
