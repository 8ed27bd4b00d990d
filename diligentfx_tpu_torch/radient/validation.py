"""Asset create/load-info validation (the port of the JAX package's
radient/validation.py) — the analogue of
Radient/src/Assets/RadientAssetValidation.cpp: every public create/load entry
validates its inputs up front and reports a precise error instead of failing
deep inside the pipeline.  Functions return an error string (None = valid),
matching the reference's LogValidationError + bool contract.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def validate_mesh_inputs(positions, indices, normals=None, uvs=None,
                         tangents=None, joints=None, weights=None
                         ) -> Optional[str]:
    """ValidateMeshCreateInfo (RadientAssetValidation.cpp:52-113)."""
    positions = np.asarray(positions)
    if positions.size == 0:
        return "positions must not be empty"
    if positions.ndim != 2 or positions.shape[1] != 3:
        return f"positions must be (V, 3), got {positions.shape}"
    v = positions.shape[0]
    indices = np.asarray(indices)
    if indices.size == 0:
        return "indices must not be empty"
    if indices.ndim == 2 and indices.shape[1] != 3:
        return f"indices must be (T, 3) or flat, got {indices.shape}"
    if indices.size % 3 != 0:
        return f"index count {indices.size} is not a multiple of 3"
    if not np.issubdtype(indices.dtype, np.integer):
        return f"indices must be integer-typed, got {indices.dtype}"
    imax = int(indices.max())
    imin = int(indices.min())
    if imin < 0 or imax >= v:
        return (f"index range [{imin}, {imax}] exceeds the vertex count {v}")
    for name, arr, width in (("normals", normals, 3), ("uvs", uvs, 2),
                             ("tangents", tangents, 4)):
        if arr is None:
            continue
        arr = np.asarray(arr)
        if arr.shape[0] != v or arr.ndim != 2 or arr.shape[1] != width:
            return (f"{name} must be ({v}, {width}), got {arr.shape}")
    # bone indices and weights go together (RadientAssetValidation.cpp:66-72)
    if (joints is None) != (weights is None):
        return "joints and weights must both be specified or both be None"
    if joints is not None:
        joints = np.asarray(joints)
        weights = np.asarray(weights)
        if joints.shape != (v, 4) or weights.shape != (v, 4):
            return (f"joints/weights must be ({v}, 4), got "
                    f"{joints.shape}/{weights.shape}")
    return None


def validate_texture_load(source) -> Optional[str]:
    """ValidateTextureLoadInfo (RadientAssetValidation.cpp:129+): exactly one
    source, sane payload shape."""
    if source is None:
        return "texture source must not be None"
    if isinstance(source, str):
        if not source:
            return "texture URI must not be empty"
        return None
    arr = np.asarray(source)
    if arr.ndim not in (2, 3):
        return f"texture payload must be (H, W[, C]), got {arr.shape}"
    if arr.ndim == 3 and arr.shape[2] not in (1, 2, 3, 4):
        return f"texture channel count must be 1..4, got {arr.shape[2]}"
    if arr.shape[0] == 0 or arr.shape[1] == 0:
        return f"texture extent must be non-zero, got {arr.shape}"
    return None


def validate_scene_load(uri, fmt: str = "auto") -> Optional[str]:
    """ValidateSceneLoadInfo (RadientAssetValidation.cpp:115-127)."""
    if not uri:
        return "scene URI must not be null or empty"
    if fmt not in ("auto", "gltf", "glb"):
        return f"scene format '{fmt}' is invalid (auto|gltf|glb)"
    return None
