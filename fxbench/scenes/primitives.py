"""Procedural mesh primitives of the benchmark's scenes: a frozen copy of
the port's gltf/primitives.py `uv_sphere`, `plane` and `cube` (with
`compute_tangents` and `enforce_outward_winding`), so that a change to the
port's primitives cannot change the workload.

Pure numpy; y-up, right-handed, CCW front faces, UV origin top-left.
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


def _with_tangents(pos, nrm, uv, idx) -> MeshData:
    tan = compute_tangents(pos, nrm, uv, idx)
    return MeshData(pos.astype(np.float32), nrm.astype(np.float32),
                    uv.astype(np.float32), idx.astype(np.int32), tan)


def compute_tangents(pos, nrm, uv, idx) -> np.ndarray:
    """MikkTSpace-style average tangents (simplified, per-vertex averaged)."""
    v = pos.shape[0]
    tan = np.zeros((v, 3), np.float64)
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    u0, u1, u2 = uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    d1, d2 = u1 - u0, u2 - u0
    r = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    r = np.where(np.abs(r) < 1e-12, 1.0, r)
    t = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) / r[:, None]
    for k in range(3):
        np.add.at(tan, idx[:, k], t)
    # Gram-Schmidt against normal
    tan = tan - nrm * np.sum(tan * nrm, axis=-1, keepdims=True)
    n = np.linalg.norm(tan, axis=-1, keepdims=True)
    fallback = np.tile(np.array([1.0, 0.0, 0.0]), (v, 1))
    tan = np.where(n > 1e-8, tan / np.maximum(n, 1e-12), fallback)
    return np.concatenate([tan, np.ones((v, 1))], axis=-1).astype(np.float32)


def uv_sphere(radius: float = 1.0, stacks: int = 32, slices: int = 48) -> MeshData:
    phi = np.linspace(0.0, np.pi, stacks + 1)
    theta = np.linspace(0.0, 2 * np.pi, slices + 1)
    ph, th = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(ph) * np.cos(th)
    y = np.cos(ph)
    z = -np.sin(ph) * np.sin(th)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3) * radius
    nrm = pos / max(radius, 1e-12)
    u = th / (2 * np.pi)
    v = ph / np.pi
    uv = np.stack([u, v], axis=-1).reshape(-1, 2)

    tris = []
    for i in range(stacks):
        for j in range(slices):
            a = i * (slices + 1) + j
            b = a + slices + 1
            if i > 0:
                tris.append([a, b, a + 1])
            if i < stacks - 1:
                tris.append([a + 1, b, b + 1])
    idx = np.asarray(tris, np.int32)
    idx = enforce_outward_winding(pos, idx)
    return _with_tangents(pos, nrm, uv, idx)


def enforce_outward_winding(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Flip triangles whose geometric normal points toward the origin —
    guarantees CCW-from-outside (glTF front-face) winding for closed
    origin-centered primitives."""
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    cen = (p0 + p1 + p2) / 3.0
    flip = np.sum(fn * cen, axis=-1) < 0
    out = idx.copy()
    out[flip] = out[flip][:, [0, 2, 1]]
    return out


def plane(size: float = 1.0, segments: int = 1) -> MeshData:
    """XZ ground plane, +Y normal, centered at origin."""
    g = np.linspace(-0.5, 0.5, segments + 1) * size
    xs, zs = np.meshgrid(g, g, indexing="xy")
    pos = np.stack([xs, np.zeros_like(xs), zs], axis=-1).reshape(-1, 3)
    nrm = np.tile(np.array([0.0, 1.0, 0.0]), (pos.shape[0], 1))
    uv = np.stack([(xs / size + 0.5), (zs / size + 0.5)], axis=-1).reshape(-1, 2)
    tris = []
    n = segments + 1
    for i in range(segments):
        for j in range(segments):
            a = i * n + j
            # +Y up, CCW from above
            tris.append([a, a + n, a + 1])
            tris.append([a + 1, a + n, a + n + 1])
    idx = np.asarray(tris, np.int32)
    return _with_tangents(pos, nrm, uv, idx)


def cube(size: float = 1.0) -> MeshData:
    s = size * 0.5
    # 6 faces x 4 verts, CCW from outside
    faces = [
        # +X
        ([s, -s, -s], [s, s, -s], [s, s, s], [s, -s, s], [1, 0, 0]),
        # -X
        ([-s, -s, s], [-s, s, s], [-s, s, -s], [-s, -s, -s], [-1, 0, 0]),
        # +Y
        ([-s, s, -s], [-s, s, s], [s, s, s], [s, s, -s], [0, 1, 0]),
        # -Y
        ([-s, -s, s], [-s, -s, -s], [s, -s, -s], [s, -s, s], [0, -1, 0]),
        # +Z
        ([-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s], [0, 0, 1]),
        # -Z
        ([s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s], [0, 0, -1]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for f, (a, b, c, d, n) in enumerate(faces):
        base = f * 4
        pos += [a, b, c, d]
        nrm += [n] * 4
        uv += [[0, 1], [1, 1], [1, 0], [0, 0]]
        idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return _with_tangents(np.asarray(pos, np.float64), np.asarray(nrm, np.float64),
                          np.asarray(uv, np.float64), np.asarray(idx, np.int32))
