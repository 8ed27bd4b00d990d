"""3D math (the port of diligentfx_tpu/math3d.py).

Conventions (as in the JAX package):
  * Row-vector matrices: a point ``p`` is transformed as ``p @ M``; matrix
    concatenation reads left-to-right.
  * Right-handed world space; cameras look down **-Z**.
  * Clip space: x, y in [-1, 1], z in [0, 1] (D3D-style depth).

Geometry products stay exact fp32 — the counterpart of the JAX package's
``precision=HIGHEST``: every 4-wide contraction here is written as explicit
elementwise multiply-adds, so no matmul (and no TF32 path) is involved.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _f32(x, device=None) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def vec_mat4(p4: Tensor, m: Tensor) -> Tensor:
    """(..., 4) row vectors @ (4, 4) matrix, exact fp32 (k = 0..3 in order)."""
    return (p4[..., 0:1] * m[0] + p4[..., 1:2] * m[1]
            + p4[..., 2:3] * m[2] + p4[..., 3:4] * m[3])


def vec_mat3(v: Tensor, m: Tensor) -> Tensor:
    """(..., 3) row vectors @ the upper 3x3 of ``m``, exact fp32."""
    return (v[..., 0:1] * m[0, :3] + v[..., 1:2] * m[1, :3]
            + v[..., 2:3] * m[2, :3])


def mul44(a: Tensor, b: Tensor) -> Tensor:
    """4x4 matrix concat at full fp32 precision."""
    return vec_mat4(a, b)


def scale(s, device=None) -> Tensor:
    """Row-vector scale matrix (a scalar or three factors)."""
    s = torch.broadcast_to(_f32(s, device), (3,))
    return torch.diag(torch.cat([s, torch.ones(1, dtype=torch.float32,
                                                device=s.device)]))


def look_at(eye, target, up=(0.0, 1.0, 0.0), device=None) -> Tensor:
    """View matrix (world -> view), row-vector. Camera looks down -Z."""
    eye = _f32(eye, device)
    target = _f32(target, device)
    up = _f32(up, device)
    fwd = target - eye
    fwd = fwd / torch.linalg.vector_norm(fwd)
    if bool(torch.abs(torch.dot(fwd, up)) > 0.999):
        # degenerate up (parallel to fwd): fall back to +Z (or +X)
        up = _f32([1.0, 0.0, 0.0] if bool(torch.abs(fwd[2]) > 0.9)
                  else [0.0, 0.0, 1.0], device)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right)
    cup = torch.linalg.cross(right, fwd)
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[:3, :3] = torch.stack([right, cup, -fwd], dim=1)
    m[3, :3] = -torch.stack([torch.dot(eye, right), torch.dot(eye, cup),
                             torch.dot(eye, -fwd)])
    return m


def perspective(fov_y: float, aspect: float, near: float, far: float,
                reversed_z: bool = False, device=None) -> Tensor:
    """Row-vector perspective projection, right-handed view (-Z forward) ->
    D3D clip space with z in [0, 1] and w = view distance."""
    f = 1.0 / math.tan(fov_y * 0.5)
    if reversed_z:
        a = near / (near - far)
        b = -far * near / (near - far)
    else:
        a = far / (far - near)
        b = -near * far / (far - near)
    return _f32([[f / aspect, 0.0, 0.0, 0.0],
                 [0.0, f, 0.0, 0.0],
                 [0.0, 0.0, -a, -1.0],
                 [0.0, 0.0, b, 0.0]], device)


def inverse(m: Tensor) -> Tensor:
    """4x4 inverse.  inv_ex skips the singularity check, which on CUDA would
    synchronise the host with the device."""
    return torch.linalg.inv_ex(m)[0]


# ---------------------------------------------------------------------------
# Vector helpers (trailing dim 3)
# ---------------------------------------------------------------------------


def normalize(v: Tensor, eps: float = 1e-20) -> Tensor:
    return v * torch.rsqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True),
                                       min=eps))


def dot(a: Tensor, b: Tensor, keepdim: bool = True) -> Tensor:
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def length(v: Tensor, keepdim: bool = True) -> Tensor:
    return torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=keepdim),
                                  min=0.0))


def cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def reflect(i: Tensor, n: Tensor) -> Tensor:
    """HLSL reflect: i - 2*dot(i,n)*n."""
    return i - 2.0 * dot(i, n) * n


def saturate(x: Tensor) -> Tensor:
    return torch.clamp(x, 0.0, 1.0)


def transform_points(points: Tensor, m: Tensor) -> Tensor:
    """(..., 3) points @ 4x4 row-vector matrix -> (..., 4) homogeneous."""
    return (points[..., 0:1] * m[0] + points[..., 1:2] * m[1]
            + points[..., 2:3] * m[2] + m[3])


def transform_directions(dirs: Tensor, m: Tensor) -> Tensor:
    """(..., 3) directions through the upper 3x3 of a row-vector matrix."""
    return vec_mat3(dirs, m)


# ---------------------------------------------------------------------------
# Color
# ---------------------------------------------------------------------------


def srgb_to_linear(c: Tensor) -> Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: Tensor) -> Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(torch.clamp(c, min=1e-8), 1.0 / 2.4)
                       - 0.055)

