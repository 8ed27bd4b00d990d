"""The port's packed vertex formats (diligentfx_tpu_torch/ops/packing.py)
against the JAX package's (ops/packing.py, run eagerly on the CPU), on
seeded inputs and on the edge values: every packed word, unpacked vector,
position and UV bit-equal (the port's int32 words read as uint32 are the
JAX package's uint32 words).  The round trips keep the JAX package's own
tests' tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu.ops import packing as jpk
from diligentfx_tpu_torch.ops import packing as tpk
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _units(n, seed=0):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _normals():
    """Seeded unit and non-unit vectors, the axes, the octant diagonals,
    zeros of both signs, the zero vector, and vectors whose packed
    component lands on a half (x * 32767 = k + 0.5) near the +-32767
    edges."""
    r = np.random.default_rng(1)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    diag = np.array(np.meshgrid([-1, 1], [-1, 1], [-1, 1])).reshape(3, -1).T
    signed0 = np.array([[0.0, 0.0, -0.0], [-0.0, 1.0, -0.0],
                        [1.0, -0.0, 0.0]], np.float32)
    k = np.arange(32760, 32767, dtype=np.float64)
    half = ((k + 0.5) / 32767).astype(np.float32)
    edge = np.stack([half, np.zeros_like(half), 1.0 - half], -1)
    edge = np.concatenate([edge, -edge, edge[:, [2, 0, 1]],
                           edge[:, [1, 2, 0]] * [1, 1, -1]])
    return np.concatenate([
        _units(20000), r.normal(size=(2000, 3)).astype(np.float32) * 7.0,
        axes, diag.astype(np.float32), signed0, np.zeros((1, 3), np.float32),
        edge.astype(np.float32)])


def _words(p):
    return p.numpy().view(np.uint32)


def test_pack_normal_bit_equal():
    n = _normals()
    got = tpk.pack_normal(torch.from_numpy(n))
    assert got.dtype == torch.int32 and got.shape == (n.shape[0],)
    np.testing.assert_array_equal(_words(got),
                                  np.asarray(jpk.pack_normal(jnp.asarray(n))))


def test_unpack_normal_bit_equal():
    """Every snorm16 pair: the packed normals and 200,000 seeded words
    (the -32768 code and the wrapped lower hemisphere included)."""
    n = _normals()
    words = np.concatenate([
        np.array(jpk.pack_normal(jnp.asarray(n))),
        np.random.default_rng(2).integers(0, 1 << 32, 200000,
                                          dtype=np.uint64).astype(np.uint32),
        np.array([0, 0x80008000, 0x7FFF7FFF, 0x80017FFF, 0xFFFFFFFF],
                 np.uint32)])
    want = np.asarray(jpk.unpack_normal(jnp.asarray(words)))
    got = tpk.unpack_normal(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the int64 spelling of the same words unpacks alike
    np.testing.assert_array_equal(
        tpk.unpack_normal(torch.from_numpy(words.astype(np.int64))).numpy(),
        want)


def test_normal_roundtrip():
    """The JAX package's own accuracy check, on the port."""
    n = _units(4096)
    back = tpk.unpack_normal(tpk.pack_normal(torch.from_numpy(n))).numpy()
    assert np.sum(back * n, axis=-1).min() > 0.99999


def _positions():
    r = np.random.default_rng(3)
    pos = r.uniform(-50.0, 90.0, size=(8192, 3)).astype(np.float32)
    flat = pos.copy()
    flat[:, 1] = 2.5                       # a degenerate (zero-extent) axis
    return pos, flat


@pytest.mark.parametrize("case", ["auto", "flat", "aabb", "outside"])
def test_positions_bit_equal(case):
    pos, flat = _positions()
    aabb = None
    if case == "flat":
        pos = flat
    elif case in ("aabb", "outside"):
        aabb = (np.array([-60.0, -40.0, -50.0], np.float32),
                np.array([80.0, 100.0, 60.0], np.float32))
        if case == "outside":              # clamped to the box
            pos = pos * 1.5
    jp = jpk.pack_positions(jnp.asarray(pos), aabb=None if aabb is None
                            else tuple(jnp.asarray(a) for a in aabb))
    tp = tpk.pack_positions(torch.from_numpy(pos), aabb=aabb)
    np.testing.assert_array_equal(_words(tp.lo), np.asarray(jp.lo))
    np.testing.assert_array_equal(_words(tp.hi), np.asarray(jp.hi))
    np.testing.assert_array_equal(tp.aabb_min.numpy(),
                                  np.asarray(jp.aabb_min))
    np.testing.assert_array_equal(tp.aabb_scale.numpy(),
                                  np.asarray(jp.aabb_scale))
    np.testing.assert_array_equal(tpk.unpack_positions(tp).numpy(),
                                  np.asarray(jpk.unpack_positions(jp)))
    if case == "auto":
        # 21-bit quantization: the JAX package's bound
        np.testing.assert_allclose(tpk.unpack_positions(tp).numpy(), pos,
                                   atol=140.0 / (1 << 21))
        # the box's corners take the extreme codes 0 and 2^21 - 1 / 2^22 - 1
        lo, hi = _words(tp.lo), _words(tp.hi)
        assert (lo & 0x1FFFFF).max() == (1 << 21) - 1
        assert (hi >> 10).max() == (1 << 22) - 1 and (hi >> 10).min() == 0


def test_round_half_even_at_the_edges():
    """torch.round and jnp.round agree on halves at the snorm16 and 21-bit
    edges (half to even)."""
    v = np.concatenate([np.arange(32760, 32768) + 0.5,
                        np.arange((1 << 21) - 8, 1 << 21) + 0.5,
                        -(np.arange(32760, 32768) + 0.5)]).astype(np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(v)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(v))))


def _uvs():
    r = np.random.default_rng(4)
    f16 = np.arange(0, 1 << 16, dtype=np.uint32).astype(np.uint16)
    halves = f16.view(np.float16).astype(np.float32)
    halves = halves[np.isfinite(halves)]
    mids = ((halves[:-1].astype(np.float64) + halves[1:]) / 2)
    special = np.array([0.0, -0.0, 65504.0, 65520.0, 7e4, -7e4, 1e-8, 6e-8,
                        -6e-8, 2.0 ** -24, np.inf, -np.inf], np.float32)
    vals = np.concatenate([r.uniform(-4.0, 4.0, 8192).astype(np.float32),
                           halves, mids.astype(np.float32), special])
    vals = np.concatenate([vals, np.zeros(len(vals) % 2, np.float32)])
    return vals.reshape(-1, 2)


def test_uv_bit_equal():
    uv = _uvs()
    words = np.array(jpk.pack_uv(jnp.asarray(uv)))
    got = tpk.pack_uv(torch.from_numpy(uv))
    np.testing.assert_array_equal(_words(got), words)
    rnd = np.random.default_rng(5).integers(0, 1 << 32, 100000,
                                            dtype=np.uint64).astype(np.uint32)
    for w in (words, rnd):
        want = np.asarray(jpk.unpack_uv(jnp.asarray(w)))
        back = tpk.unpack_uv(torch.from_numpy(w.view(np.int32))).numpy()
        np.testing.assert_array_equal(back.view(np.uint32),
                                      want.view(np.uint32))


def test_uv_roundtrip():
    uv = np.random.default_rng(2).uniform(-4.0, 4.0, (4096, 2)).astype(
        np.float32)
    back = tpk.unpack_uv(tpk.pack_uv(torch.from_numpy(uv))).numpy()
    np.testing.assert_allclose(back, uv, rtol=1e-3, atol=2e-3)
