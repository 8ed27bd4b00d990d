"""A grid of devices with named axes, and the band halo exchange (the port
of diligentfx_tpu/parallel/mesh.py).

The JAX package shards the framebuffer's row bands over a mesh axis "sp"
(and independent frames over "dp") and runs one band function under
shard_map, with ppermute halos and all_gathers.  The port has no SPMD
tracer: one process drives the grid, and a band-sharded tensor is a list
of per-band tensors, each on its band's device (parallel/tiling.py loops
over the bands stage by stage).  A device may appear more than once, so
four bands can share one card, or the CPU (the counterpart of XLA's
virtual host devices).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


class RenderMesh:
    """A grid of torch devices with named axes (jax.sharding.Mesh's
    role): `devices` an object array shaped by the axes, `shape` the axis
    sizes by name."""

    def __init__(self, devices, axis_names: Tuple[str, ...] = ("dp", "sp")):
        grid = np.asarray(devices, dtype=object)
        arr = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            arr[idx] = torch.device(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-axis device grid needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"RenderMesh({self.shape}, {self.devices.tolist()})"


def make_render_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
                     sp: Optional[int] = None, devices=None) -> RenderMesh:
    """A ('dp', 'sp') mesh.  Defaults: every CUDA device (the first
    n_devices), sp = min(4, n), dp = n // sp.  Without CUDA, `devices`
    must be given; a device may repeat in it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_render_mesh: no CUDA device; pass "
                               "devices= (e.g. ['cpu'] * 4) for the CPU")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i)
                   for i in range(count)][:n_devices or count]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None or sp is None:
        sp = sp or min(4, n)
        dp = dp or n // sp
    if dp * sp != n:
        raise ValueError(f"dp {dp} x sp {sp} != {n} devices")
    return RenderMesh(np.asarray(devices, dtype=object).reshape(dp, sp),
                      ("dp", "sp"))


def band_sharding(mesh: RenderMesh, axis_name: str = "sp", index: int = 0
                  ) -> List[torch.device]:
    """The devices of the bands along `axis_name`, in band order: the
    leading (height) dimension of an image is split over them.  `index`
    picks the row of the grid along its other axes (row-major over them:
    on a ('dp', 'sp') mesh, the dp row whose frames these bands render).
    A frame the JAX package replicates over the other axes runs on the
    first row."""
    axis = mesh.axis_names.index(axis_name)
    others = [a for a in range(mesh.devices.ndim) if a != axis]
    coords = iter(np.unravel_index(
        index, [mesh.devices.shape[a] for a in others]))
    return list(mesh.devices[tuple(slice(None) if a == axis
                                   else int(next(coords))
                                   for a in range(mesh.devices.ndim))])


def replicated(mesh: RenderMesh) -> List[torch.device]:
    """The mesh's distinct devices, in order of first appearance: a
    replicated tensor is one copy on each."""
    out: List[torch.device] = []
    for d in mesh.devices.flat:
        if d not in out:
            out.append(d)
    return out


def halo_extend(bands: Sequence[Tensor], b: int, halo: int,
                wrap: bool = False) -> Tensor:
    """Band b padded to (h + 2 halo, ...) with the neighbouring bands'
    rows, on band b's device.  wrap=False: the image's edge bands get zero
    rows (ppermute's missing-source semantics); wrap=True: a ring, band 0's
    top halo is the last band's bottom rows (torch.roll's global wrap)."""
    n = len(bands)
    x = bands[b]
    zeros = x.new_zeros((halo,) + tuple(x.shape[1:]))
    above = (bands[b - 1][-halo:].to(x.device) if b > 0 or wrap else zeros)
    below = (bands[(b + 1) % n][:halo].to(x.device) if b < n - 1 or wrap
             else zeros)
    return torch.cat([above, x, below], dim=0)


def band_halo_exchange(bands: Sequence[Tensor], halo: int,
                       wrap: bool = False) -> List[Tensor]:
    """Exchange `halo` rows between neighbouring bands (JAX mesh.py:48):
    each band padded to (h + 2 halo, ...); see halo_extend."""
    return [halo_extend(bands, b, halo, wrap) for b in range(len(bands))]
