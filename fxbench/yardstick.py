"""The benchmark's own arithmetic, frozen with it: the card's peaks, the
statistics of the end-to-end metrics, the union of device intervals, and
the work of a frame's K1 and K2 counted from the frame's own sizes (never
from a kernel's argument layout, so that a change of layout or kernel
reads the same work).
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM, the published dense peaks at 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

F32 = 4
# K1 (the G-buffer raster with interpolation and material fetch) writes,
# for every pixel: depth, triangle id, the six interpolated attributes
# (world normal, previous clip x, y, w), the node id and the 18 material
# values a pixel's shading reads (base colour 4, emissive 3, metallic,
# roughness, normal scale, occlusion, workflow, clear coat 2, specular 3,
# alpha cutoff)
K1_ATTRIBUTES = 6
K1_MATERIAL_VALUES = 18
K1_CHANNELS_OUT = 1 + 1 + K1_ATTRIBUTES + 1 + K1_MATERIAL_VALUES
# K1 reads, for every visible triangle, its three vertices' clip position
# and attributes and the triangle's material and node ids
K1_BYTES_PER_TRIANGLE = (3 * (4 + K1_ATTRIBUTES) + 2) * F32
# a pixel's least arithmetic: three edge / depth planes (4 flops each), the
# perspective denominator (5) and each attribute's plane and divide (5)
K1_FLOPS_PER_PIXEL = 3 * 4 + 5 + 5 * K1_ATTRIBUTES
# a bilinear tap: the weights (8 flops a pixel) and four taps blended (7
# flops a channel)
K2_FLOPS_PER_PIXEL = 8
K2_FLOPS_PER_CHANNEL = 7


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between closest ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def union_length(intervals: Iterable[Tuple[float, float]],
                 lo: float, hi: float) -> float:
    """The length of [lo, hi] that the union of the intervals covers."""
    total, end = 0.0, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if hi > end:
        out.append((end, hi))
    return out


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take for the work: the larger of the
    bytes at peak bandwidth and the operations at the fp32 peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS)


def visible_triangles(positions: np.ndarray, indices: np.ndarray,
                      view_proj: np.ndarray) -> int:
    """Triangles of world `positions` (V, 3) that face the camera of the
    row-vector `view_proj` and are not wholly outside one clip plane."""
    p = np.concatenate([positions, np.ones((len(positions), 1))], axis=1)
    clip = (p @ view_proj.astype(np.float64))[indices]          # (T, 3, 4)
    x, y, z, w = (clip[..., k] for k in range(4))
    outside = ((x < -w).all(1) | (x > w).all(1) | (y < -w).all(1)
               | (y > w).all(1) | (z < 0).all(1) | (z > w).all(1))
    front = np.ones(len(indices), bool)
    ahead = (w > 1e-9).all(1)
    nx, ny = x[ahead] / w[ahead], y[ahead] / w[ahead]
    area = ((nx[:, 1] - nx[:, 0]) * (ny[:, 2] - ny[:, 0])
            - (nx[:, 2] - nx[:, 0]) * (ny[:, 1] - ny[:, 0]))
    front[ahead] = area > 0
    return int((~outside & front).sum())


def k1_work(width: int, height: int, visible: int, n_materials: int
            ) -> Tuple[float, float]:
    """(bytes, flops) of one frame's G-buffer raster."""
    px = width * height
    nbytes = (px * K1_CHANNELS_OUT * F32 + visible * K1_BYTES_PER_TRIANGLE
              + n_materials * K1_MATERIAL_VALUES * F32)
    return float(nbytes), float(px * K1_FLOPS_PER_PIXEL)


def k2_warps(cfg: dict) -> List[Tuple[int, int, int]]:
    """The (rows, columns, channels) of each bounded warp a frame of the
    configuration makes: the history disocclusion's depth tap, SSAO's taps
    and its history (AO and convolved depth), and TAA's history (colour
    and sample count).  SSR's history takes the warp only on its kernel
    route, which no configuration here takes."""
    tm = cfg["task_manager"]
    h, w = cfg["height"], cfg["width"]
    taa_warp = tm.get("enable_taa", True) and "PALLAS_WARP" in tm.get(
        "taa_feature_flags", [])
    ssao_warp = tm.get("enable_ssao", True) and tm.get("ssao_use_pallas",
                                                       False)
    out = []
    if ssao_warp or taa_warp:
        out.append((h, w, 1))
    if ssao_warp:
        sh, sw = ((h // 2, w // 2) if tm.get("ssao_half_resolution", True)
                  else (h, w))
        taps = 2 * tm.get("ssao_num_slices", 3) * tm.get("ssao_num_steps", 6)
        out += [(sh, sw, 1)] * taps + [(sh, sw, 2)]
    if taa_warp:
        out.append((h, w, 4))
    return out


def k2_work(cfg: dict) -> Tuple[float, float]:
    """(bytes, flops) of one frame's bounded warps: each reads its image
    and its offset field once and writes its image once."""
    nbytes = flops = 0.0
    for h, w, c in k2_warps(cfg):
        nbytes += h * w * (2 * c + 2) * F32
        flops += h * w * (K2_FLOPS_PER_PIXEL + K2_FLOPS_PER_CHANNEL * c)
    return nbytes, flops
