"""Persistent precompute cache (the port of the JAX package's
utils/cache.py) — the analogue of IRenderStateCache disk persistence: the
expensive startup artifacts are the IBL precompute products (the BRDF and
Charlie LUTs, the irradiance map and its SH-9, the prefiltered mip chain,
the LUT's Chebyshev fit), which PBRRenderer(ibl_cache_dir=...) keeps in one
.npz file per environment map and precompute size.

The file's arrays carry the JAX package's names for the fields both
packages' IBLMaps have; the footprint-packed pyramid is rebuilt from the
mips on load, as the JAX package rebuilds it.
"""
from __future__ import annotations

import os
import zipfile
from typing import Optional

import numpy as np
import torch

from diligentfx_tpu_torch.device import resolve_device
from diligentfx_tpu_torch.native.binding import content_hash
from diligentfx_tpu_torch.ops.sampling import build_packed_pyramid
from diligentfx_tpu_torch.pbr.shading import IBLMaps

# what a missing, truncated or foreign file raises in np.load and in the
# lookups of its arrays; anything else propagates
_READ_ERRORS = (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile)

_FIELDS = ("irradiance", "preintegrated_ggx", "preintegrated_charlie",
           "sheen_albedo_scaling", "irradiance_sh", "env_brdf_coeffs")


def save_ibl_maps(path: str, maps: IBLMaps) -> None:
    arrays = {f: getattr(maps, f).cpu().numpy() for f in _FIELDS}
    arrays["n_mips"] = np.asarray(len(maps.prefiltered))
    for i, m in enumerate(maps.prefiltered):
        arrays[f"pref_{i}"] = m.cpu().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_ibl_maps(path: str, device=None) -> Optional[IBLMaps]:
    """The maps saved at `path`, on `device` (CUDA unless the caller asks
    for the CPU); None (a miss) when the file is missing or is not such a
    file."""
    dev = resolve_device(device)
    if not os.path.exists(path):
        return None

    def t(a):
        return torch.tensor(a, device=dev)
    try:
        with np.load(path) as z:
            n = int(z["n_mips"])
            pref = tuple(t(z[f"pref_{i}"]) for i in range(n))
            fields = {f: t(z[f]) for f in _FIELDS}
    except _READ_ERRORS:
        return None
    return IBLMaps(prefiltered=pref, pref_packed=build_packed_pyramid(pref),
                   **fields)


def ibl_cache_key(env_oct, ci) -> str:
    """Content hash of the env map + precompute dims (the native hash)."""
    env = (env_oct.cpu().numpy() if isinstance(env_oct, torch.Tensor)
           else np.asarray(env_oct))
    h = content_hash(env,
                     np.asarray([ci.brdf_lut_dim, ci.num_brdf_samples,
                                 ci.irradiance_cube_dim,
                                 ci.prefiltered_env_map_dim,
                                 ci.num_specular_env_samples], np.int64))
    return h.hex()
