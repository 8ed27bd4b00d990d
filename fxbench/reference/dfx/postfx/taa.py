"""Temporal anti-aliasing (the port of diligentfx_tpu/postfx/taa.py):
variance-clipped history accumulation in YCoCg with Gaussian neighbourhood
moments, history reprojected through the bounded warp kernel (PALLAS_WARP)
or Catmull-Rom / bilinear taps, and a sample-count blend ramp.

State = the accumulated color + per-pixel sample count.  With a
context.BandCtx the same accumulation runs on one row band of a frame
(parallel/tiling.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from fxbench.reference.dfx.ops.sampling import bilinear_sample
from fxbench.reference.dfx.postfx.context import BandCtx, PostFXResources

Tensor = torch.Tensor


class TAAFeatureFlags:
    NONE = 0
    GAUSSIAN_WEIGHTING = 1 << 0
    BICUBIC_FILTER = 1 << 1
    YCOCG_COLOR_SPACE = 1 << 2
    # history reprojection through the bounded warp kernel (ops/warp.py);
    # motion clamped to the kernel halo of +-7 rows / +-63 columns
    PALLAS_WARP = 1 << 3


class TAASettings(NamedTuple):
    """TemporalAntiAliasingAttribs analogue."""
    temporal_stability_factor: float = 0.9375
    variance_gamma: float = 1.0
    skip_rejection: bool = False


class TAAState(NamedTuple):
    color: Tensor         # (H, W, 3)
    sample_count: Tensor  # (H, W)


def rgb_to_ycocg(c: Tensor) -> Tensor:
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([0.25 * r + 0.5 * g + 0.25 * b,
                        0.5 * r - 0.5 * b,
                        -0.25 * r + 0.5 * g - 0.25 * b], dim=-1)


def ycocg_to_rgb(c: Tensor) -> Tensor:
    y, co, cg = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([y + co - cg, y + cg, y - co - cg], dim=-1)


_GAUSS = ((1.0, 2.0, 1.0), (2.0, 4.0, 2.0), (1.0, 2.0, 1.0))


def _neighborhood_moments(color: Tensor, gaussian: bool = True,
                          src: Optional[Tensor] = None):
    """3x3 mean / standard deviation via wrap-around shifts.  `src`: color
    on one wrap-exchanged halo row a side (a band, JAX taa.py:59), whose
    rolled rows [1, 1 + h) equal the whole frame's windows."""
    h = color.shape[0]
    m1 = torch.zeros_like(color)
    m2 = torch.zeros_like(color)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if src is None:
                c = torch.roll(color, (-dy, -dx), dims=(0, 1))
            else:
                c = torch.roll(src, (-dy, -dx), dims=(0, 1))[1:1 + h]
            ww = (_GAUSS[dy + 1][dx + 1] / 16.0) if gaussian else 1.0 / 9.0
            m1 = m1 + c * ww
            m2 = m2 + c * c * ww
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    return m1, torch.sqrt(var)


def _sample_history_catmull_rom(history: Tensor, uv: Tensor) -> Tensor:
    """9-tap optimized Catmull-Rom (BICUBIC_FILTER path)."""
    h, w = history.shape[:2]
    size = torch.tensor([w, h], dtype=torch.float32, device=history.device)
    pos = uv * size
    center = torch.floor(pos - 0.5) + 0.5
    f = pos - center
    f2 = f * f
    f3 = f2 * f
    w0 = -0.5 * f3 + f2 - 0.5 * f
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
    w3 = 0.5 * f3 - 0.5 * f2
    w12 = w1 + w2
    offset12 = w2 / torch.where(torch.abs(w12) < 1e-6, torch.ones_like(w12),
                                w12)

    def tap(px, wgt):
        return bilinear_sample(history, px / size) * wgt[..., None]

    tl, t12, br = center - 1.0, center + offset12, center + 2.0
    xs = ((tl[..., 0], w0[..., 0]), (t12[..., 0], w12[..., 0]),
          (br[..., 0], w3[..., 0]))
    ys = ((tl[..., 1], w0[..., 1]), (t12[..., 1], w12[..., 1]),
          (br[..., 1], w3[..., 1]))
    acc = None
    for yy, wy in ys:
        for xx, wx in xs:
            t = tap(torch.stack([xx, yy], -1), wx * wy)
            acc = t if acc is None else acc + t
    wsum = ((w0[..., 0] + w12[..., 0] + w3[..., 0])
            * (w0[..., 1] + w12[..., 1] + w3[..., 1]))[..., None]
    return acc / torch.clamp(wsum, min=1e-6)


def taa_accumulate(color: Tensor, state: Optional[TAAState],
                   resources: PostFXResources,
                   settings: TAASettings = TAASettings(),
                   feature_flags: int = (TAAFeatureFlags.BICUBIC_FILTER
                                         | TAAFeatureFlags.YCOCG_COLOR_SPACE
                                         | TAAFeatureFlags.GAUSSIAN_WEIGHTING),
                   disocclusion: Optional[Tensor] = None,
                   band: Optional[BandCtx] = None
                   ) -> Tuple[Tensor, TAAState]:
    """One temporal accumulation step (JAX taa.py:128).  Returns
    (antialiased, new_state).

    band: run on a row band.  The history warp reads halo-extended rows
    with the vertical motion clamped to halo - 3 px (room for the
    Catmull-Rom's +-2 footprint); the moment window reads a wrap halo.
    The same accumulation runs either way."""
    h, w = color.shape[:2]
    dev = color.device
    if state is None:
        return color, TAAState(color=color,
                               sample_count=torch.ones((h, w), device=dev))
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    x = xs[None, :].expand(h, w)
    m = resources.closest_motion
    if band is None:
        y = ((ys + 0.5) / h)[:, None].expand(h, w)
        prev_uv = torch.stack([x, y], dim=-1) - m
        hist_src = torch.cat([state.color, state.sample_count[..., None]],
                             dim=-1)
        samp_uv = prev_uv
        off_px = -m * torch.tensor([w, h], dtype=torch.float32, device=dev)
    else:
        halo, fh, y0 = band.halo, band.full_h, float(band.y0)
        yg = (ys + y0 + 0.5)[:, None].expand(h, w)
        my = torch.clamp(m[..., 1] * fh, -(halo - 3.0), halo - 3.0)
        prev_uv = torch.stack([x - m[..., 0], (yg - my) / fh], dim=-1)
        # each part extended alone: the same rows as one extend of both
        hist_src = torch.cat([
            band.extend(state.color, halo, wrap=False),
            band.extend(state.sample_count, halo, wrap=False)[..., None]],
            dim=-1)
        # band-local uv into the extended rows; the integer row shift
        # (y0 - halo) keeps every filter's fractional weights
        samp_uv = torch.stack([prev_uv[..., 0],
                               (yg - my - y0 + halo) / (h + 2.0 * halo)],
                              dim=-1)
        off_px = torch.stack([-m[..., 0] * w, -my], dim=-1)

    if feature_flags & TAAFeatureFlags.PALLAS_WARP:
        from fxbench.reference.dfx.ops.warp import warp_bilinear
        if band is not None:
            off_px = torch.nn.functional.pad(off_px, (0, 0, 0, 0, band.halo,
                                                      band.halo))
        warped = warp_bilinear(hist_src.contiguous(), off_px.contiguous(),
                               halo_r=8, halo_c=64)
        if band is not None:
            warped = warped[band.halo:band.halo + h]
        hist, hist_count = warped[..., :3], warped[..., 3]
    elif feature_flags & TAAFeatureFlags.BICUBIC_FILTER:
        hist = _sample_history_catmull_rom(hist_src[..., :3], samp_uv)
        hist_count = bilinear_sample(hist_src[..., 3:4], samp_uv)[..., 0]
    else:
        hist = bilinear_sample(hist_src[..., :3], samp_uv)
        hist_count = bilinear_sample(hist_src[..., 3:4], samp_uv)[..., 0]

    in_bounds = ((prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
                 & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0))
    if disocclusion is not None:
        in_bounds = in_bounds & ~disocclusion

    use_ycocg = bool(feature_flags & TAAFeatureFlags.YCOCG_COLOR_SPACE)
    to_cs = rgb_to_ycocg if use_ycocg else (lambda c: c)
    cur_cs = to_cs(color)
    hist_cs = to_cs(torch.clamp(hist, min=0.0)) if use_ycocg else hist
    # the colour is extended, then converted: per pixel, the same values as
    # the converted colour extended
    mean, std = _neighborhood_moments(
        cur_cs, gaussian=bool(feature_flags
                              & TAAFeatureFlags.GAUSSIAN_WEIGHTING),
        src=None if band is None else to_cs(band.extend(color, 1,
                                                        wrap=True)))
    if not settings.skip_rejection:
        gamma = settings.variance_gamma
        hist_cs = torch.minimum(torch.maximum(hist_cs, mean - gamma * std),
                                mean + gamma * std)
    count = torch.where(in_bounds, hist_count + 1.0, torch.ones_like(hist_count))
    alpha = torch.clamp(1.0 / count,
                        min=1.0 - settings.temporal_stability_factor)
    alpha = torch.where(in_bounds, alpha, torch.ones_like(alpha))[..., None]
    out_cs = hist_cs + (cur_cs - hist_cs) * alpha
    out = ycocg_to_rgb(out_cs) if use_ycocg else out_cs
    out = torch.clamp(out, min=0.0)
    return out, TAAState(color=out, sample_count=torch.clamp(count, max=64.0))
