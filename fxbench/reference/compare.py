"""Holding a frame of the timed path against the reference's frame.

Each compared number is the worst over the compared frames:

- `color_rms`: the root mean square of the sRGB output's difference over
  every pixel and channel (the output lies in [0, 1]);
- `depth_rms`: the root mean square of the G-buffer depth's difference
  over the pixels both sides hit;
- `id_mismatch`: the share of pixels whose node id differs (the raster's
  visibility);
- `history_rms`: over each history the frame hands on (TAA colour and
  sample count, SSR radiance, SSAO history and depth), the root mean
  square of the difference over that of the reference's values, the
  largest.

The limits are the configuration's (`limits` in its file), set from the
readings of sound runs and of the precision control (PERF.md).
"""
from __future__ import annotations

from typing import Dict

import torch

from fxbench.reference.frame import STATE_KEYS

NUMBERS = ("color_rms", "depth_rms", "id_mismatch", "history_rms")


def _rms(x: torch.Tensor) -> float:
    x = x.double()
    return float(torch.sqrt(torch.mean(x * x))) if x.numel() else 0.0


def frame_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """`prog` and `ref`: dicts of "color", "depth", "node_id" and "state"
    (the plain state dict the frame hands on), on one device."""
    dev = ref["color"].device
    pc = prog["color"].to(dev, torch.float32)
    out = {"color_rms": _rms(pc - ref["color"])}
    pid, rid = prog["node_id"].to(dev), ref["node_id"]
    out["id_mismatch"] = float((pid != rid).double().mean())
    both = (pid >= 0) & (rid >= 0)
    out["depth_rms"] = _rms((prog["depth"].to(dev) - ref["depth"])[both])
    worst = 0.0
    for k in STATE_KEYS:
        if k in ref["state"]:
            r = ref["state"][k].double()
            d = prog["state"][k].to(dev).double() - r
            scale = max(_rms(r), 1e-30)
            worst = max(worst, _rms(d) / scale)
    out["history_rms"] = worst
    return out


def worst(readings) -> Dict[str, float]:
    """The largest reading of each number over a list of frame readings;
    NaN where any frame reads NaN."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in readings]
        out[k] = (float("nan") if any(v != v for v in vals)
                  else max(vals, default=float("nan")))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is finite and within its limit."""
    return all(numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in NUMBERS)
