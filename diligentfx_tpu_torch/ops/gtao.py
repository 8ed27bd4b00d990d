"""Fused GTAO (the port of diligentfx_tpu/ops/gtao_pallas.py `gtao_pallas`):
the whole horizon-slice integral of postfx/ssao.compute_gtao's kernel route
in one kernel, csrc/gtao.cu.

Per pixel: the view-space position and view vector, the interleaved-
gradient noise (the formula of postfx/context.py), then for each slice the
projected normal and its angle, slices x 2 sides x steps horizon taps of
the depth and the cosine-weighted arc integral.  arccos is the Hastings
polynomial of the TPU kernel (max error about 7e-5 rad).

Taps follow the TPU kernel's window semantics exactly: the depth is edge-
padded to the 32 x 128 tile grid, each tile samples inside a window whose
origin is clamped into the image and rounded down to the tile grid, tap
offsets clamp to +-(halo - 1) px, and window coordinates clamp to the
window.  `gtao_fused` launches the kernel on a CUDA tensor and runs
`gtao_fused_plain`, the same function in PyTorch, on a CPU tensor.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from diligentfx_tpu_torch.ops import cuda_build
from diligentfx_tpu_torch.postfx.context import edge_pad

Tensor = torch.Tensor

TILE_H = 32
TILE_W = 128
PI = 3.141592653589793


def gtao_geometry(hp: int, wp: int) -> Tuple[int, int, int, int]:
    """(halo_r, halo_c, win_h, win_w) of a padded (hp, wp) image: the TPU
    entry's halo shrink and window widening (gtao_pallas.py:274-287).
    Raises where a halo collapses to 0 (hp == 32 or wp == 128): the TPU
    kernel would then clamp every tap onto its own tile."""
    halo_r = min(16, (hp - TILE_H) // 2 // 8 * 8)
    halo_c = min(64, (wp - TILE_W) // 2 // 64 * 64)
    if halo_r <= 0 or halo_c <= 0:
        raise ValueError(
            f"fused GTAO: a {hp}x{wp} padded image collapses the tap halo to "
            f"({max(halo_r, 0)}, {max(halo_c, 0)}); it needs at least "
            f"{TILE_H + 16} rows and {TILE_W + 128} columns")
    win_h = TILE_H + 2 * halo_r
    win_w = TILE_W + 2 * halo_c
    # the window origin is rounded down to the tile grid: widen by a tile
    # where the halo is not a tile multiple
    if halo_r % TILE_H != 0 and win_h + TILE_H <= hp:
        win_h += TILE_H
    win_h = min(win_h, hp)
    if halo_c % TILE_W != 0 and win_w + TILE_W <= wp:
        win_w += TILE_W
    win_w = min(win_w, wp)
    return halo_r, halo_c, win_h, win_w


def _acos(x: Tensor) -> Tensor:
    """Hastings arccos (gtao_pallas.py:54)."""
    ax = torch.abs(x)
    p = torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * (
        1.5707288 + ax * (-0.2121144 + ax * (0.0742610 - 0.0187293 * ax)))
    return torch.where(x >= 0.0, p, PI - p)


def _pad(x: Tensor) -> Tensor:
    """x (h, w, ...) edge-padded to the 32 x 128 tile grid."""
    h, w = x.shape[:2]
    return edge_pad(x, (-h) % TILE_H, (-w) % TILE_W).contiguous()


class _Pixels(NamedTuple):
    """What every tap of a pixel shares: the window's size and tap clamps,
    the pixel grid and window origins, the view-space position and view
    vector, the noise, the tap radius and the divisors."""
    win_h: int
    win_w: int
    cx: float
    cy: float
    ry: Tensor
    rx: Tensor
    py: Tensor
    px: Tensor
    xi: Tensor
    yi: Tensor
    pos: Tuple[Tensor, Tensor, Tensor]
    v: Tuple[Tensor, Tensor, Tensor]
    noise: Tensor
    radius_px: Tensor
    wl_t: Tensor
    fh_t: Tensor
    steps_t: Tensor


def _view_z(d, near, far):
    return near * far / torch.clamp(far - d * (far - near), min=1e-12)


def _pixels(dp: Tensor, scalars: Tensor, num_steps: int, fh: int,
            wl: int) -> _Pixels:
    """The per-pixel part of the fused GTAO on the padded depth dp."""
    hp, wp = dp.shape
    halo_r, halo_c, win_h, win_w = gtao_geometry(hp, wp)
    dev = dp.device
    (f_idx, radius, _, _, p00, p11, near,
     far) = scalars.to(torch.float32).unbind()

    yy = torch.arange(hp, device=dev)[:, None]
    xx = torch.arange(wp, device=dev)[None, :]
    y0 = (yy // TILE_H) * TILE_H
    x0 = (xx // TILE_W) * TILE_W
    ry = (torch.clamp(y0 - halo_r, 0, hp - win_h) // TILE_H) * TILE_H
    rx = (torch.clamp(x0 - halo_c, 0, wp - win_w) // TILE_W) * TILE_W
    py = yy.to(torch.float32).expand(hp, wp)
    px = xx.to(torch.float32).expand(hp, wp)
    xi = px + 0.5
    yi = py + 0.5
    # divisors as device tensors: PyTorch on CUDA multiplies by the
    # reciprocal of a Python-number divisor, the kernel divides
    def const(c):
        return torch.tensor(float(c), dtype=torch.float32, device=dev)
    wl_t, fh_t, steps_t = const(wl), const(fh), const(num_steps)

    view_z = _view_z(dp, near, far)
    x_ndc = xi / wl_t * 2.0 - 1.0
    y_ndc = 1.0 - yi / fh_t * 2.0
    pos_x = x_ndc * view_z / p00
    pos_y = y_ndc * view_z / p11
    pos_z = -view_z
    inv_len = 1.0 / torch.sqrt(torch.clamp(
        pos_x * pos_x + pos_y * pos_y + pos_z * pos_z, min=1e-12))
    v_x = -pos_x * inv_len
    v_y = -pos_y * inv_len
    v_z = -pos_z * inv_len

    fo = 5.588238 * (f_idx - 64.0 * torch.floor(f_idx / 64.0))
    m1 = 0.06711056 * (px + fo) + 0.00583715 * (py + fo)
    m1 = m1 - torch.floor(m1)
    noise = 52.9829189 * m1
    noise = noise - torch.floor(noise)

    radius_px = radius * p11 * (fh * 0.5) / torch.clamp(view_z, min=1e-4)
    radius_px = torch.clamp(radius_px, 2.0, float(max(fh, wl)) * 0.25)
    return _Pixels(win_h, win_w, float(max(halo_c - 1, 0)),
                   float(max(halo_r - 1, 0)), ry, rx, py, px, xi, yi,
                   (pos_x, pos_y, pos_z), (v_x, v_y, v_z), noise, radius_px,
                   wl_t, fh_t, steps_t)


def _slice_dir(g: _Pixels, s: int, num_slices: int):
    phi = (s + g.noise) * (PI / num_slices)
    return torch.cos(phi), torch.sin(phi)


def _tap_offset(g: _Pixels, cos_p: Tensor, sin_p: Tensor, sgn: float,
                step: int) -> Tuple[Tensor, Tensor]:
    tt = (step + 0.5 + 0.5 * g.noise) / g.steps_t
    tt = tt * tt
    off_x = torch.clamp(cos_p * (sgn * tt * g.radius_px), -g.cx, g.cx)
    off_y = torch.clamp(-sin_p * (sgn * tt * g.radius_px), -g.cy, g.cy)
    return off_x, off_y


class TapCoords(NamedTuple):
    """One bilinear tap of every pixel on the padded depth: rows r0, r1
    (r1 is read only where `has1`), columns c0, c1, weights fy, fx."""
    r0: Tensor
    r1: Tensor
    c0: Tensor
    c1: Tensor
    fy: Tensor
    fx: Tensor
    has1: Tensor


def gtao_tap_coords(g: _Pixels, off_x: Tensor, off_y: Tensor) -> TapCoords:
    """The texels and weights of the tap at offset (off_x, off_y): window
    coordinates clamped to the window, the x+1 / y+1 neighbours inside
    it (the TPU kernel's bounded bilinear tap)."""
    ryf, rxf = g.ry.to(torch.float32), g.rx.to(torch.float32)
    sy = torch.clamp(g.py - ryf + off_y, 0.0, g.win_h - 1.0)
    sx = torch.clamp(g.px - rxf + off_x, 0.0, g.win_w - 1.0)
    yf, xf = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - yf, sx - xf
    yi0, xi0 = yf.long(), xf.long()
    xi1 = torch.clamp(xi0 + 1, max=g.win_w - 1)
    has1 = yi0 + 1 < g.win_h
    r0 = g.ry + yi0
    r1 = g.ry + torch.clamp(yi0 + 1, max=g.win_h - 1)
    return TapCoords(r0, r1, g.rx + xi0, g.rx + xi1, fy, fx, has1)


def gtao_taps(depth: Tensor, scalars: Tensor, *, num_slices: int,
              num_steps: int, fh_log: int = 0, w_log: int = 0
              ) -> Iterator[TapCoords]:
    """The tap coordinates of every pixel of the padded grid, in the
    kernel's order (slice, side +1 then -1, step): what the fused GTAO
    reads of the depth."""
    h, w = depth.shape
    dp = _pad(depth)
    g = _pixels(dp, scalars, num_steps, fh_log or h, w_log or w)
    for s in range(num_slices):
        cos_p, sin_p = _slice_dir(g, s, num_slices)
        for sgn in (1.0, -1.0):
            for step in range(num_steps):
                yield gtao_tap_coords(g, *_tap_offset(g, cos_p, sin_p, sgn,
                                                      step))


def gtao_fused_plain(depth: Tensor, normal_vs: Tensor, scalars: Tensor, *,
                     num_slices: int, num_steps: int, fh_log: int = 0,
                     w_log: int = 0) -> Tensor:
    """Plain PyTorch version of the fused GTAO kernel (same operation order
    as gtao_pallas.py `_gtao_kernel`)."""
    h, w = depth.shape
    fh = fh_log or h
    wl = w_log or w
    dp, npad = _pad(depth), _pad(normal_vs)
    hp, wp = dp.shape
    dev = depth.device
    (_, _, falloff_from, falloff_range, p00, p11, near,
     far) = scalars.to(torch.float32).unbind()
    g = _pixels(dp, scalars, num_steps, fh, wl)
    pos_x, pos_y, pos_z = g.pos
    v_x, v_y, v_z = g.v
    n_x, n_y, n_z = npad.unbind(-1)

    def tap(off_x, off_y):
        t = gtao_tap_coords(g, off_x, off_y)
        ga, gb = dp[t.r0, t.c0], dp[t.r0, t.c1]
        hv0 = ga + (gb - ga) * t.fx
        ga, gb = dp[t.r1, t.c0], dp[t.r1, t.c1]
        hv1 = ga + (gb - ga) * t.fx
        a = hv0 * (1.0 - t.fy)
        return torch.where(t.has1, a + hv1 * t.fy, a)

    visibility = torch.zeros((hp, wp), dtype=torch.float32, device=dev)
    for s in range(num_slices):
        cos_p, sin_p = _slice_dir(g, s, num_slices)
        sdv = cos_p * v_x + sin_p * v_y                # slice_dir . v
        o_x = cos_p - v_x * sdv
        o_y = sin_p - v_y * sdv
        o_z = -v_z * sdv
        a_x = o_y * v_z - o_z * v_y
        a_y = o_z * v_x - o_x * v_z
        a_z = o_x * v_y - o_y * v_x
        a_il = 1.0 / torch.sqrt(torch.clamp(
            a_x * a_x + a_y * a_y + a_z * a_z, min=1e-12))
        a_x, a_y, a_z = a_x * a_il, a_y * a_il, a_z * a_il
        ndota = n_x * a_x + n_y * a_y + n_z * a_z
        np_x = n_x - a_x * ndota
        np_y = n_y - a_y * ndota
        np_z = n_z - a_z * ndota
        np_len = torch.sqrt(torch.clamp(
            np_x * np_x + np_y * np_y + np_z * np_z, min=1e-8))
        cos_norm = torch.clamp(
            (np_x * v_x + np_y * v_y + np_z * v_z) / np_len, -1.0, 1.0)
        sgn_n = torch.where(np_x * o_x + np_y * o_y + np_z * o_z >= 0.0,
                            1.0, -1.0)
        n_angle = _acos(cos_norm) * sgn_n

        best = [torch.full((hp, wp), -1.0, device=dev),
                torch.full((hp, wp), -1.0, device=dev)]
        for side, sgn in ((0, 1.0), (1, -1.0)):
            for step in range(num_steps):
                off_x, off_y = _tap_offset(g, cos_p, sin_p, sgn, step)
                d = tap(off_x, off_y)
                su = (g.xi + off_x) / g.wl_t
                sv = (g.yi + off_y) / g.fh_t
                zs = _view_z(d, near, far)
                dx = (su * 2.0 - 1.0) * zs / p00 - pos_x
                dy = (1.0 - sv * 2.0) * zs / p11 - pos_y
                dz = -zs - pos_z
                dist = torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz,
                                              min=1e-10))
                cos_h = (dx * v_x + dy * v_y + dz * v_z) / dist
                wgt = torch.clamp(1.0 - (dist - falloff_from)
                                  / torch.clamp(falloff_range, min=1e-5),
                                  0.0, 1.0)
                cos_h = cos_h * wgt - (1.0 - wgt)
                best[side] = torch.maximum(best[side], cos_h)

        # side 0 (+dir_px) is the +ortho half-plane: the positive horizon h1
        h0 = -_acos(torch.clamp(best[1], -1.0, 1.0))
        h1 = _acos(torch.clamp(best[0], -1.0, 1.0))
        h0 = n_angle + torch.clamp(h0 - n_angle, min=-PI / 2)
        h1 = n_angle + torch.clamp(h1 - n_angle, max=PI / 2)
        sin_n = sgn_n * torch.sqrt(torch.clamp(1.0 - cos_norm * cos_norm,
                                               min=0.0))
        arc = (0.25 * (-torch.cos(2.0 * h0 - n_angle) + cos_norm
                       + 2.0 * h0 * sin_n)
               + 0.25 * (-torch.cos(2.0 * h1 - n_angle) + cos_norm
                         + 2.0 * h1 * sin_n))
        visibility = visibility + np_len * arc
    return torch.clamp(visibility / torch.tensor(
        float(num_slices), dtype=torch.float32, device=dev), 0.0, 1.0)[:h, :w]


# dfx_gtao_fused(depth, normal, scalars, out, hp, wp, h, w, halo_r, halo_c,
#                win_h, win_w, num_slices, num_steps, fh, wl, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def _launch(depth: Tensor, normal_vs: Tensor, scalars: Tensor,
            num_slices: int, num_steps: int, fh: int, wl: int) -> Tensor:
    h, w = depth.shape
    dev = depth.device
    if any(t.dtype != torch.float32 for t in (depth, normal_vs, scalars)):
        raise TypeError("gtao_fused takes float32 tensors")
    if normal_vs.device != dev or scalars.device != dev:
        raise ValueError("depth, normal_vs and scalars must be on the same "
                         "device")
    ph, pw = (-h) % TILE_H, (-w) % TILE_W
    # the depth edge-padded to the tile grid (taps read the padding), in
    # one replicate-pad launch; the normals are read only at kept pixels
    dp = (F.pad(depth[None], (0, pw, 0, ph), mode="replicate")[0]
          if ph or pw else depth.contiguous())
    hp, wp = dp.shape
    halo_r, halo_c, win_h, win_w = gtao_geometry(hp, wp)
    nv = normal_vs.contiguous()
    sc = scalars.contiguous()
    fn = cuda_build.bind("gtao", "dfx_gtao_fused", _ARGTYPES)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dp.data_ptr(), nv.data_ptr(), sc.data_ptr(), out.data_ptr(),
                 hp, wp, h, w, halo_r, halo_c, win_h, win_w, num_slices,
                 num_steps, fh, wl, stream)
    cuda_build.check(err, "gtao kernel launch")
    gtao_fused.launches += 1
    return out


def gtao_fused(depth: Tensor, normal_vs: Tensor, scalars: Tensor, *,
               num_slices: int, num_steps: int, fh_log: int = 0,
               w_log: int = 0) -> Tensor:
    """Fused GTAO: depth (H, W) NDC, normal_vs (H, W, 3) view space,
    scalars (8,) float32 [frame_index, radius, falloff_from, falloff_range,
    p00, p11, near, far] -> (H, W) ambient visibility in [0, 1].

    A CUDA tensor goes to the kernel (or this raises); a CPU tensor runs
    the plain version.  `gtao_fused.launches` counts kernel launches."""
    if tuple(normal_vs.shape) != tuple(depth.shape) + (3,) \
            or tuple(scalars.shape) != (8,):
        raise ValueError(f"gtao_fused: depth {tuple(depth.shape)}, normal "
                         f"{tuple(normal_vs.shape)}, scalars "
                         f"{tuple(scalars.shape)}")
    if depth.device.type == "cuda":
        h, w = depth.shape
        return _launch(depth, normal_vs, scalars, num_slices, num_steps,
                       fh_log or h, w_log or w)
    if depth.device.type != "cpu":
        raise ValueError(f"gtao_fused: unsupported device {depth.device}")
    return gtao_fused_plain(depth, normal_vs, scalars, num_slices=num_slices,
                            num_steps=num_steps, fh_log=fh_log, w_log=w_log)


gtao_fused.launches = 0
