"""Selection outline by jump flood (the port of diligentfx_tpu/components/
selection.py; Hydrogent's HnProcessSelectionTask and the selection terms
of HnPostProcess.psh): ceil(log2(max(H, W))) jump-flood passes carry each
pixel's closest selected pixel, from which a distance band draws the
outline; unselected pixels are desaturated.

Every coordinate is an integer held in float32, so the flood is exact and
`torch.roll` shifts as `jnp.roll` does: the result equals the JAX
package's bit for bit.
"""
from __future__ import annotations

import math

import torch

from diligentfx_tpu_torch import math3d as m3

Tensor = torch.Tensor

NONE = 1e9        # the location of "no selected pixel yet"


def _pixel_grid(h: int, w: int, device):
    yg, xg = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return xg, yg


def closest_selected_location(selected: Tensor) -> Tensor:
    """Jump flood (JAX selection.py:17): selected (H, W) bool -> (H, W, 2)
    float32 pixel coordinates (x, y) of the closest selected pixel found,
    1e9 where none.  Candidates are tried in (dy, dx) order and a later one
    replaces the best only when strictly nearer; locations rolled in across
    the frame's edge (>= 1e8) are rejected."""
    h, w = selected.shape
    xg, yg = _pixel_grid(h, w, selected.device)
    loc = torch.where(selected[..., None], torch.stack([xg, yg], dim=-1),
                      torch.full((h, w, 2), NONE, device=selected.device))

    def dist2(l):
        ex, ey = l[..., 0] - xg, l[..., 1] - yg
        return ex * ex + ey * ey

    inf = torch.tensor(float("inf"), device=selected.device)
    steps = int(math.ceil(math.log2(max(h, w))))
    for i in range(steps):
        step = 1 << (steps - 1 - i)
        best = loc
        best_d = dist2(loc)
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dx == 0 and dy == 0:
                    continue
                cand = torch.roll(loc, shifts=(dy, dx), dims=(0, 1))
                ok = (cand[..., 0] < 1e8) & (cand[..., 1] < 1e8)
                d = torch.where(ok, dist2(cand), inf)
                take = d < best_d
                best = torch.where(take[..., None], cand, best)
                best_d = torch.minimum(d, best_d)
        loc = best
    return loc


def selection_outline(color: Tensor, selected: Tensor, *,
                      outline_width: float = 3.0,
                      outline_color=(1.0, 0.6, 0.1)) -> Tensor:
    """The distance-band outline around the selection (JAX selection.py:55):
    unselected pixels whose closest selected pixel lies more than 0.5 and
    at most `outline_width` px away take `outline_color` (a (3,) tensor or
    a triple)."""
    h, w = selected.shape
    loc = closest_selected_location(selected)
    xg, yg = _pixel_grid(h, w, selected.device)
    ex, ey = loc[..., 0] - xg, loc[..., 1] - yg
    d = torch.sqrt(ex * ex + ey * ey)
    band = (d > 0.5) & (d <= outline_width) & ~selected
    oc = torch.as_tensor(outline_color, dtype=torch.float32,
                         device=color.device)
    alpha = band.to(torch.float32)[..., None]
    return color + (oc - color) * alpha


def desaturate_unselected(color: Tensor, selected: Tensor,
                          desaturation: float = 0.7) -> Tensor:
    """Unselected pixels move `desaturation` of the way to their luminance
    (HnPostProcess.psh's non-selection term; JAX selection.py:71)."""
    gray = m3.luminance(color).expand(color.shape)
    des = color + (gray - color) * desaturation
    return torch.where(selected[..., None], color, des)
