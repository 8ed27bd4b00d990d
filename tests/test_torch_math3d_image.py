"""The math3d helpers of the Radient slice (identity44, scale,
rotation_x/y/z, quat_to_matrix, compose_trs, orthographic, lerp,
project_to_ndc) and utils/image.py decode_png in the port against the JAX
package's, on the CPU, from seeded inputs.

Tolerances: every helper bit-equal, but for the rotations' cos and sin
entries.  The port takes cos and sin of the float32 angle in float64 and
rounds them (the same bits on every device); XLA's float32 cos and sin on
the CPU are within one ulp of those and differ from them on a few percent
of angles, so those entries are held to one ulp and every other entry of
a rotation bit for bit.  decode_png: the same uint8 image, exactly, for
every filter type and channel count the decoder reads.
"""
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.utils import image as jimage
from diligentfx_tpu_torch import math3d as tm3
from diligentfx_tpu_torch.utils import image as timage
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _eq(port, jax_value):
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_value))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_constructors_bit_equal():
    _eq(tm3.identity44(), jm3.identity44())
    for s in (2.0, 0.25, (1.0, -2.5, 3.0), np.float32(7.0)):
        _eq(tm3.scale(s), jm3.scale(s))
    for args in ((3.0, 2.0, 0.1, 50.0), (1920.0, 1080.0, 0.05, 1e4),
                 (0.7, 1.3, 2.0, 3.0)):
        for rz in (False, True):
            _eq(tm3.orthographic(*args, reversed_z=rz),
                jm3.orthographic(*args, reversed_z=rz))


ANGLES = np.concatenate([
    np.random.default_rng(0).uniform(-7.0, 7.0, 300),
    [0.0, -0.0, np.pi / 2, np.pi, -np.pi, 2 * np.pi, 1e-8, 100.0]]
).astype(np.float32)


@pytest.mark.parametrize("axis", "xyz")
def test_rotations(axis):
    """Bit for bit off the cos / sin entries; those within one ulp (and
    bit-equal where XLA's float32 cos and sin round correctly)."""
    cs = {"x": [(1, 1), (1, 2), (2, 1), (2, 2)],
          "y": [(0, 0), (0, 2), (2, 0), (2, 2)],
          "z": [(0, 0), (0, 1), (1, 0), (1, 1)]}[axis]
    mask = np.zeros((4, 4), bool)
    mask[tuple(np.array(cs).T)] = True
    exact = 0
    for a in ANGLES:
        got = getattr(tm3, f"rotation_{axis}")(float(a)).numpy()
        want = np.asarray(getattr(jm3, f"rotation_{axis}")(float(a)))
        np.testing.assert_array_equal(got[~mask], want[~mask])
        assert _ulps(got[mask], want[mask]).max() <= 1, a
        exact += bool((got == want).all())
        # the port's own entries: cos and sin of the float32 angle, rounded
        c, s = np.cos(np.float64(a)), np.sin(np.float64(a))
        ref = np.float32([c, -s, s, c] if axis == "y" else [c, s, -s, c])
        np.testing.assert_array_equal(got[mask], ref)
    assert exact >= 0.9 * len(ANGLES)
    # a tensor angle on the device gives the same matrix
    np.testing.assert_array_equal(
        getattr(tm3, f"rotation_{axis}")(torch.tensor(ANGLES[3])).numpy(),
        getattr(tm3, f"rotation_{axis}")(float(ANGLES[3])).numpy())


def _quats(n=200):
    q = np.random.default_rng(1).normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([q, np.eye(4, dtype=np.float32),
                           [[0.0, 0.0, 0.0, -1.0]]]).astype(np.float32)


def test_quat_to_matrix_and_compose_trs_bit_equal():
    rng = np.random.default_rng(2)
    for q in _quats():
        _eq(tm3.quat_to_matrix(q), jm3.quat_to_matrix(q))
        t = rng.uniform(-10, 10, 3).astype(np.float32)
        s = rng.uniform(0.1, 3, 3).astype(np.float32)
        _eq(tm3.compose_trs(t, q, s), jm3.compose_trs(t, q, s))
    _eq(tm3.compose_trs([1, 2, 3], [0, 0, 0, 1], 2.0),
        jm3.compose_trs([1, 2, 3], [0, 0, 0, 1], 2.0))


def test_lerp_and_project_to_ndc_bit_equal():
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    t = rng.uniform(-0.5, 1.5, (64, 1)).astype(np.float32)
    _eq(tm3.lerp(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(t)),
        jm3.lerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
    _eq(tm3.lerp(torch.from_numpy(a), torch.from_numpy(b), 0.3),
        jm3.lerp(jnp.asarray(a), jnp.asarray(b), 0.3))
    clip = rng.normal(size=(4096, 4)).astype(np.float32) * 5
    clip[::7, 3] = 0.0
    clip[1::7, 3] = -0.0
    clip[2::7, 3] = 1e-10
    clip[3::7, 3] = -1e-10
    clip[4::7, 3] = 1e-9
    for eps in (1e-9, 1e-3):
        _eq(tm3.project_to_ndc(torch.from_numpy(clip), eps),
            jm3.project_to_ndc(jnp.asarray(clip), eps))


def _png(img, filters):
    """An 8-bit PNG of img (H, W, C), row r filtered with filters[r % 5]
    (0 none, 1 sub, 2 up, 3 average, 4 paeth), in two IDAT chunks."""
    h, w, c = img.shape
    bpp, raw, prev = c, bytearray(), np.zeros(w * c, np.int64)
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int64)
        ft = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(line)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([ft]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = line
    z = zlib.compress(bytes(raw))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    ctype = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", z[:len(z) // 2]) + chunk(b"IDAT", z[len(z) // 2:])
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_decode_png_bit_equal(c, tmp_path):
    img = np.random.default_rng(c).integers(0, 256, (23, 17, c)).astype(
        np.uint8)
    for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
        data = _png(img, filters)
        got = timage.decode_png(data)
        np.testing.assert_array_equal(got, jimage.decode_png(data))
        np.testing.assert_array_equal(got, img)
    path = tmp_path / "img.png"
    timage.write_png(str(path), img if c != 1 else img[..., 0])
    data = path.read_bytes()
    np.testing.assert_array_equal(timage.decode_png(data),
                                  jimage.decode_png(data))
    np.testing.assert_array_equal(timage.read_png(str(path)),
                                  timage.decode_png(data))


def test_decode_png_refuses_other_data():
    with pytest.raises(ValueError, match="not a PNG"):
        timage.decode_png(b"GIF89a....")
    img = _png(np.zeros((2, 2, 3), np.uint8), (0,))
    sixteen = img[:24] + struct.pack(">BB", 16, 2) + img[26:]
    with pytest.raises(ValueError, match="8-bit"):
        timage.decode_png(sixteen)
