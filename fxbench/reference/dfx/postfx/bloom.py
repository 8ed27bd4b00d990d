"""Bloom (the port of diligentfx_tpu/postfx/bloom.py): soft-knee prefilter
with Karis luma weighting, 13-tap (5x5) stride-2 downsample chain starting
at half resolution, tent-filtered progressive upsample, intensity combine.

The downsample and tent filters are depthwise convolutions.  They run with
cuDNN's TF32 off (torch.backends.cudnn.flags(allow_tf32=False)): cuDNN
takes TF32 for float32 convolutions by default, which keeps only about
three decimal digits.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class BloomSettings(NamedTuple):
    """BloomAttribs analogue."""
    intensity: float = 0.05
    threshold: float = 1.0
    soft_threshold: float = 0.5   # knee fraction


_DOWN = ((0.03125, 0.0625, 0.0625, 0.0625, 0.03125),
         (0.0625, 0.125, 0.0, 0.125, 0.0625),
         (0.0625, 0.0, 0.125, 0.0, 0.0625),
         (0.0625, 0.125, 0.0, 0.125, 0.0625),
         (0.03125, 0.0625, 0.0625, 0.0625, 0.03125))
_TENT = ((1.0, 2.0, 1.0), (2.0, 4.0, 2.0), (1.0, 2.0, 1.0))


def _kernel(rows, device) -> Tensor:
    k = torch.tensor(rows, dtype=torch.float32, device=device)
    return k / torch.sum(k)


def _depthwise_conv(img: Tensor, kernel: Tensor, stride: int = 1) -> Tensor:
    """(H, W, C) depthwise 2D conv with edge padding, exact fp32."""
    c = img.shape[-1]
    kh, kw = kernel.shape
    x = img.permute(2, 0, 1)[None]
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
    k = kernel[None, None].expand(c, 1, kh, kw).contiguous()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(x, k, stride=stride, groups=c)
    return y[0].permute(1, 2, 0)


def _resize_bilinear(img: Tensor, h: int, w: int) -> Tensor:
    """Half-pixel-center bilinear upsample with edge clamp (the semantics of
    jax.image.resize 'bilinear' when enlarging)."""
    x = img.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    return y[0].permute(1, 2, 0)


def prefilter(color: Tensor, s: BloomSettings, karis: bool = True) -> Tensor:
    """Soft-knee threshold + Karis average."""
    thr = torch.tensor(s.threshold, dtype=torch.float32, device=color.device)
    knee = torch.clamp(thr * s.soft_threshold, min=1e-5)
    br = torch.amax(color, dim=-1, keepdim=True)
    soft = torch.minimum(torch.clamp(br - thr + knee, min=0.0), 2.0 * knee)
    soft = soft * soft / (4.0 * knee)
    contrib = torch.maximum(soft, br - thr) / torch.clamp(br, min=1e-5)
    out = color * contrib
    if karis:
        luma_w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=torch.float32,
                              device=color.device)
        luma = torch.sum(out * luma_w, dim=-1, keepdim=True)
        out = out / (1.0 + luma)
    return out


def downsample(img: Tensor) -> Tensor:
    return _depthwise_conv(img, _kernel(_DOWN, img.device), stride=2)


def upsample_add(low: Tensor, high: Tensor, radius: float = 1.0) -> Tensor:
    """Tent-filtered 2x upsample of `low` added to `high`."""
    up = _resize_bilinear(low, high.shape[0], high.shape[1])
    up = _depthwise_conv(up, _kernel(_TENT, low.device))
    return high + up * radius


def apply_bloom(color: Tensor, settings: BloomSettings = BloomSettings(),
                num_mips: int = 6) -> Tensor:
    """Full bloom chain; the pyramid's finest level is half the frame
    resolution (Bloom.cpp:97-99), combined back with one bilinear tap."""
    base = downsample(prefilter(color, settings, karis=True))
    chain: List[Tensor] = [base]
    cur = base
    for _ in range(num_mips - 2):
        if min(cur.shape[0], cur.shape[1]) < 8:
            break
        cur = downsample(cur)
        chain.append(cur)
    acc = chain[-1]
    for lvl in range(len(chain) - 2, -1, -1):
        acc = upsample_add(acc, chain[lvl])
    full = _resize_bilinear(acc, color.shape[0], color.shape[1])
    return color + (full - color) * settings.intensity
