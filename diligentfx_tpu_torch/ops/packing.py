"""Packed vertex formats (the port of the JAX package's ops/packing.py) —
the analogue of PBR_Renderer's vertex packing (PackVertexNormal /
PackVertexPos64, PBR_Renderer.hpp:1064-1086; VertexProcessing.fxh unpack
helpers).

Normals pack to one 32-bit word via octahedral snorm16x2 (the reference's
PackVertexNormal wire format); positions quantize against an explicit AABB
into 21:21:22 bits across two words (the reference's 64-bit packed
position); UVs pack pairwise into one word as float16x2.

torch.uint32 supports few operations on either device, so the bit work
runs in int64 and a packed word is returned as an int32 tensor holding the
same 32 bits as the JAX package's uint32 (``.view(np.uint32)`` of its
numpy array reads them back).  The unpack functions take int32 or int64
words.  Every function is bit-equal to its JAX counterpart on the CPU and
gives the same bits on the card, but for the payload of a NaN that a word
of unpack_uv encodes (the card's half-to-float conversion may change it).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

Tensor = torch.Tensor

_M16 = 0xFFFF


def _word(v: Tensor) -> Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same bits."""
    return (v - ((v >> 31) & 1) * (1 << 32)).to(torch.int32)


def _div(x: Tensor, c: float) -> Tensor:
    """x / c, correctly rounded on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal instead, which rounds
    differently, so the divisor goes in as a tensor on x's device."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _bits(p: Tensor) -> Tensor:
    """32-bit words (int32 or int64) -> int64 values in [0, 2^32)."""
    return p.to(torch.int64) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Octahedral snorm16x2 normals (PackVertexNormal analogue)
# ---------------------------------------------------------------------------


def _oct_wrap(v: Tensor) -> Tensor:
    return (1.0 - torch.abs(v.flip(-1))) * torch.where(v >= 0.0, 1.0, -1.0)


def _sum3(v: Tensor) -> Tensor:
    """v[..., 0] + v[..., 1] + v[..., 2], in that order, keeping the dim."""
    return (v[..., 0:1] + v[..., 1:2]) + v[..., 2:3]


def _norm3(v: Tensor) -> Tensor:
    """The length of (..., 3) vectors as jnp.linalg.norm computes it on the
    CPU: sqrt(fma(z, z, fma(y, y, x * x))) in float32.  Each fused step is
    taken in float64 (a float32 square is exact there) and rounded once to
    float32.  The square root too is taken in float64 and rounded (PyTorch's
    float32 sqrt on the CPU is not correctly rounded)."""
    d = v.double()
    acc = (d[..., 0:1] * d[..., 0:1]).float()
    for k in (1, 2):
        acc = (d[..., k:k + 1] * d[..., k:k + 1] + acc.double()).float()
    return torch.sqrt(acc.double()).float()


def pack_normal(n: Tensor) -> Tensor:
    """(..., 3) unit vectors -> (...,) words (oct snorm16 x, y in lo, hi)."""
    n = n / torch.clamp(_sum3(torch.abs(n)), min=1e-12)
    xy = torch.where(n[..., 2:3] >= 0.0, n[..., :2], _oct_wrap(n[..., :2]))
    q = torch.round(torch.clamp(xy, -1.0, 1.0) * 32767.0).to(torch.int64)
    u = q & _M16
    return _word(u[..., 0] | (u[..., 1] << 16))


def unpack_normal(p: Tensor) -> Tensor:
    """(...,) words -> (..., 3) unit vectors."""
    b = _bits(p)
    lo = b & _M16
    hi = (b >> 16) & _M16
    # sign-extend snorm16
    lo = torch.where(lo >= 0x8000, lo - 0x10000, lo)
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi)
    xy = _div(torch.stack([lo, hi], dim=-1).to(torch.float32), 32767.0)
    z = 1.0 - torch.abs(xy[..., 0]) - torch.abs(xy[..., 1])
    xy = torch.where(z[..., None] < 0.0, _oct_wrap(xy), xy)
    v = torch.cat([xy, z[..., None]], dim=-1)
    return v / torch.clamp(_norm3(v), min=1e-12)


# ---------------------------------------------------------------------------
# 64-bit quantized positions (PackVertexPos64 analogue: 21:21:22 bits)
# ---------------------------------------------------------------------------


class PackedPositions(NamedTuple):
    lo: Tensor        # (V,) words: x[21] | y_lo[11]
    hi: Tensor        # (V,) words: y_hi[10] | z[22]
    aabb_min: Tensor  # (3,)
    aabb_scale: Tensor  # (3,) (max - min), 0-safe


_BX, _BY, _BZ = 21, 21, 22


def pack_positions(pos: Tensor,
                   aabb: Tuple[Tensor, Tensor] = None) -> PackedPositions:
    """(V, 3) f32 -> two words per vertex, quantized against the AABB."""
    if aabb is None:
        mn = torch.amin(pos, dim=0)
        mx = torch.amax(pos, dim=0)
    else:
        mn, mx = (torch.as_tensor(a, dtype=torch.float32, device=pos.device)
                  for a in aabb)
    scale = torch.clamp(mx - mn, min=1e-12)
    t = torch.clamp((pos - mn) / scale, 0.0, 1.0)

    def quant(x, bits):
        return torch.round(x * float((1 << bits) - 1)).to(torch.int64)
    qx = quant(t[..., 0], _BX)
    qy = quant(t[..., 1], _BY)
    qz = quant(t[..., 2], _BZ)
    lo = qx | ((qy & 0x7FF) << _BX)           # 21 + 11 = 32
    hi = (qy >> 11) | (qz << (_BY - 11))      # 10 + 22 = 32
    return PackedPositions(lo=_word(lo), hi=_word(hi), aabb_min=mn,
                           aabb_scale=scale)


def unpack_positions(p: PackedPositions) -> Tensor:
    lo, hi = _bits(p.lo), _bits(p.hi)
    qx = lo & ((1 << _BX) - 1)
    qy = ((lo >> _BX) & 0x7FF) | ((hi & 0x3FF) << 11)
    qz = hi >> (_BY - 11)
    t = torch.stack([_div(q.to(torch.float32), float((1 << bits) - 1))
                     for q, bits in ((qx, _BX), (qy, _BY), (qz, _BZ))],
                    dim=-1)
    return t * p.aabb_scale + p.aabb_min


# ---------------------------------------------------------------------------
# float16x2 UVs
# ---------------------------------------------------------------------------


def pack_uv(uv: Tensor) -> Tensor:
    """(..., 2) f32 -> (...,) words (f16 u | f16 v << 16)."""
    bits = uv.half().view(torch.int16).to(torch.int64) & _M16
    return _word(bits[..., 0] | (bits[..., 1] << 16))


def unpack_uv(p: Tensor) -> Tensor:
    b = _bits(p)
    halves = torch.stack([b & _M16, (b >> 16) & _M16], dim=-1)
    halves = torch.where(halves >= 0x8000, halves - 0x10000, halves)
    return halves.to(torch.int16).view(torch.float16).to(torch.float32)
