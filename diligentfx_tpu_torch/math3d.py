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


def identity44(dtype=torch.float32, device=None) -> Tensor:
    return torch.eye(4, dtype=dtype, device=device)


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


def translation(t, device=None) -> Tensor:
    """Row-vector translation matrix: p @ T adds ``t``."""
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[3, :3] = _f32(t, device)
    return m


def scale(s, device=None) -> Tensor:
    """Row-vector scale matrix (a scalar or three factors)."""
    s = torch.broadcast_to(_f32(s, device), (3,))
    return torch.diag(torch.cat([s, torch.ones(1, dtype=torch.float32,
                                                device=s.device)]))


def _cos_sin(angle, device=None):
    """cos and sin of the float32 `angle`, in float32 rounded from float64:
    the same bits on every device.  (The JAX package's float32 cos and sin,
    XLA's on the CPU, are within one ulp of these.)"""
    a = _f32(angle, device).double()
    return torch.cos(a).float(), torch.sin(a).float()


def _rotation(i: int, j: int, angle, device=None) -> Tensor:
    """The rotation of the (i, j) plane: m[i, i] = m[j, j] = cos,
    m[i, j] = sin, m[j, i] = -sin."""
    c, s = _cos_sin(angle, device)
    m = torch.eye(4, dtype=torch.float32, device=c.device)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, s, -s, c
    return m


def rotation_x(angle, device=None) -> Tensor:
    return _rotation(1, 2, angle, device)


def rotation_y(angle, device=None) -> Tensor:
    return _rotation(2, 0, angle, device)


def rotation_z(angle, device=None) -> Tensor:
    return _rotation(0, 1, angle, device)


def quat_to_matrix(q, device=None) -> Tensor:
    """Unit quaternion (x, y, z, w) -> 4x4 row-vector rotation matrix (the
    rows are the images of the basis vectors)."""
    x, y, z, w = _f32(q, device)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + z * w),
                     2 * (x * z - y * w), zero]),
        torch.stack([2 * (x * y - z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z + x * w), zero]),
        torch.stack([2 * (x * z + y * w), 2 * (y * z - x * w),
                     1 - 2 * (x * x + y * y), zero]),
        torch.stack([zero, zero, zero, one]),
    ])


def compose_trs(translation_v, rotation_q, scale_v, device=None) -> Tensor:
    """glTF node TRS -> row-vector world matrix (scale, then rotate, then
    translate)."""
    return mul44(mul44(scale(scale_v, device),
                       quat_to_matrix(rotation_q, device)),
                 translation(translation_v, device))


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


def orthographic(width: float, height: float, near: float, far: float,
                 reversed_z: bool = False, device=None) -> Tensor:
    """Row-vector orthographic projection (right-handed, -Z forward,
    z in [0, 1])."""
    if reversed_z:
        a = 1.0 / (near - far)
        b = -far / (near - far)
    else:
        a = -1.0 / (far - near)
        b = -near / (far - near)
    return _f32([[2.0 / width, 0.0, 0.0, 0.0],
                 [0.0, 2.0 / height, 0.0, 0.0],
                 [0.0, 0.0, a, 0.0],
                 [0.0, 0.0, b, 1.0]], device)


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


def lerp(a, b, t):
    return a + (b - a) * t


def transform_points(points: Tensor, m: Tensor) -> Tensor:
    """(..., 3) points @ 4x4 row-vector matrix -> (..., 4) homogeneous."""
    return (points[..., 0:1] * m[0] + points[..., 1:2] * m[1]
            + points[..., 2:3] * m[2] + m[3])


def transform_directions(dirs: Tensor, m: Tensor) -> Tensor:
    """(..., 3) directions through the upper 3x3 of a row-vector matrix."""
    return vec_mat3(dirs, m)


def project_to_ndc(clip: Tensor, eps: float = 1e-9) -> Tensor:
    """Homogeneous clip (..., 4) -> NDC (..., 3) by perspective divide."""
    w = clip[..., 3:4]
    safe_w = torch.where(torch.abs(w) < eps,
                         torch.where(w < 0, -eps, eps).to(w.dtype), w)
    return clip[..., :3] / safe_w


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


def luminance(rgb: Tensor) -> Tensor:
    """Rec.709 luminance."""
    w = torch.tensor([0.212671, 0.715160, 0.072169], dtype=rgb.dtype,
                     device=rgb.device)
    return torch.sum(rgb * w, dim=-1, keepdim=True)
