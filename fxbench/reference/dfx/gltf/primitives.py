"""Procedural mesh primitives (the port's own copy of the JAX package's
gltf/primitives.py: uv_sphere, plane and cube, the meshes of the bench
scene and of the full-chain frame's atrium, and merge and transform_mesh).

Pure numpy on host — meshes are built once and uploaded as tensors.

Conventions: y-up, right-handed, CCW front faces (glTF), UV origin top-left.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MeshData(NamedTuple):
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray    # (V, 3) f32
    uvs: np.ndarray        # (V, 2) f32
    indices: np.ndarray    # (T, 3) i32
    tangents: np.ndarray   # (V, 4) f32 (xyz = tangent, w = handedness)

