"""Tone mapping (the port of diligentfx_tpu/postfx/tonemap.py, all 12
modes of ToneMapping.fxh) and the auto-exposure measurement.  Colors are
(..., 3) linear HDR; the mode is a static Python value.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from fxbench.reference.dfx.config import ToneMappingMode
from fxbench.reference.dfx.math3d import srgb_to_linear

Tensor = torch.Tensor

RGB_TO_LUMINANCE = (0.212671, 0.715160, 0.072169)


class ToneMappingAttribs(NamedTuple):
    """ToneMappingStructures.fxh ToneMappingAttribs."""
    middle_gray: float = 0.18
    white_point: float = 3.0
    luminance_saturation: float = 1.0
    agx_saturation: float = 1.4
    agx_offset: float = 0.0
    agx_slope: float = 1.0
    agx_power: float = 1.35


def _f32(x, device) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _lum(color: Tensor) -> Tensor:
    return torch.sum(color * _f32(RGB_TO_LUMINANCE, color.device), dim=-1,
                     keepdim=True)


def _uncharted2_curve(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def _mat3_rows(m, color: Tensor) -> Tensor:
    """(3, 3) row-major matrix applied to (..., 3) color (m @ c)."""
    m = _f32(m, color.device)
    return torch.stack([color[..., 0] * m[i, 0] + color[..., 1] * m[i, 1]
                        + color[..., 2] * m[i, 2] for i in range(3)], dim=-1)


_AGX_M = ((0.842479062253094, 0.0784335999999992, 0.0792237451477643),
          (0.0423282422610123, 0.878468636469772, 0.0791661274605434),
          (0.0423756549057051, 0.0784336, 0.879142973793104))
_AGX_MINV = ((1.19687900512017, -0.0980208811401368, -0.0990297440797205),
             (-0.0528968517574562, 1.15190312990417, -0.0989611768448433),
             (-0.0529716355144438, -0.0980434501171241, 1.15107367264116))


def _agx_contrast(x):
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4
            - 6.868 * x2 * x + 0.4298 * x2 + 0.1191 * x - 0.00232)


def _agx(color):
    min_ev, max_ev = -12.47393, 4.026069
    c = _mat3_rows(_AGX_M, color)
    c = torch.clamp(torch.log2(torch.clamp(c, min=1e-10)), min_ev, max_ev)
    return _agx_contrast((c - min_ev) / (max_ev - min_ev))


def _agx_eotf(color):
    return srgb_to_linear(_mat3_rows(_AGX_MINV, color))


def _agx_punchy(color, saturation, offset, slope, power):
    lum = _lum(color)
    c = torch.pow(torch.clamp(color * slope + offset, min=0.0), power)
    return lum + saturation * (c - lum)


def _pbr_neutral(color, ave_log_lum):
    color = color * (0.3 / ave_log_lum)
    start_compression = 0.8 - 0.04
    desaturation = 0.15
    x = torch.amin(color, dim=-1, keepdim=True)
    offset = torch.where(x < 0.08, x - 6.25 * x * x, torch.full_like(x, 0.04))
    color = color - offset
    peak = torch.amax(color, dim=-1, keepdim=True)
    d = 1.0 - start_compression
    new_peak = 1.0 - d * d / (peak + d - start_compression)
    scaled = color * new_peak / torch.clamp(peak, min=1e-9)
    g = 1.0 - 1.0 / (desaturation * (peak - new_peak) + 1.0)
    compressed = scaled + (new_peak - scaled) * g
    return torch.where(peak >= start_compression, compressed, color)


def _commerce(color, ave_log_lum):
    color = color * (0.3 / ave_log_lum)
    start_compression = 0.8
    desaturation = 0.5
    d = 1.0 - start_compression
    peak = torch.amax(color, dim=-1, keepdim=True)
    new_peak = 1.0 - d * d / (peak + d - start_compression)
    inv_peak = 1.0 / torch.clamp(peak, min=1e-9)
    extra = torch.sum(color * (1.0 - start_compression * inv_peak), dim=-1,
                      keepdim=True)
    scaled = color * new_peak * inv_peak
    g = 1.0 - 3.0 / (desaturation * extra + 3.0)
    compressed = scaled + (1.0 - scaled) * g
    return torch.where(peak >= start_compression, compressed, color)


def tone_map(color: Tensor, mode: ToneMappingMode,
             attribs: ToneMappingAttribs = ToneMappingAttribs(),
             ave_log_lum=0.3) -> Tensor:
    """ToneMapping.fxh:101-198."""
    dev = color.device
    ave_log_lum = torch.clamp(_f32(ave_log_lum, dev), min=1e-6)
    lum_scale = _f32(attribs.middle_gray, dev) / ave_log_lum
    color = torch.clamp(color, min=0.0)
    initial_lum = torch.clamp(_lum(color), min=1e-10)
    scaled_lum = initial_lum * lum_scale
    scaled_color = color * lum_scale
    wp = _f32(attribs.white_point, dev)

    def recolor(tone_lum):
        return tone_lum * torch.pow(color / initial_lum,
                                    attribs.luminance_saturation)

    if mode == ToneMappingMode.NONE:
        return color
    if mode == ToneMappingMode.EXP:
        return recolor(1.0 - torch.exp(-scaled_lum))
    if mode == ToneMappingMode.REINHARD:
        return recolor(scaled_lum / (1.0 + scaled_lum))
    if mode == ToneMappingMode.REINHARD_MOD:
        return recolor(scaled_lum * (1.0 + scaled_lum / (wp * wp))
                       / (1.0 + scaled_lum))
    if mode == ToneMappingMode.UNCHARTED2:
        curr = _uncharted2_curve(2.0 * scaled_color)
        white_scale = 1.0 / _uncharted2_curve(wp.expand(3))
        return curr * white_scale
    if mode == ToneMappingMode.FILMIC_ALU:
        x = torch.clamp(scaled_color - 0.004, min=0.0)
        t = (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
        return torch.pow(t, 2.2)
    if mode == ToneMappingMode.LOGARITHMIC:
        return recolor(torch.log10(1.0 + scaled_lum) / torch.log10(1.0 + wp))
    if mode == ToneMappingMode.ADAPTIVE_LOG:
        bias = 0.85
        t = (1.0 / torch.log10(1.0 + wp) * torch.log(1.0 + scaled_lum)
             / torch.log(2.0 + 8.0 * torch.pow(scaled_lum / wp,
                                               math.log(bias) / math.log(0.5))))
        return recolor(t)
    if mode == ToneMappingMode.AGX:
        return _agx_eotf(_agx(scaled_color))
    if mode == ToneMappingMode.AGX_CUSTOM:
        c = _agx_punchy(_agx(scaled_color), attribs.agx_saturation,
                        attribs.agx_offset, attribs.agx_slope,
                        attribs.agx_power)
        return _agx_eotf(c)
    if mode == ToneMappingMode.PBR_NEUTRAL:
        return _pbr_neutral(color, ave_log_lum)
    if mode == ToneMappingMode.COMMERCE:
        return _commerce(color, ave_log_lum)
    raise ValueError(f"unknown tone mapping mode {mode}")

