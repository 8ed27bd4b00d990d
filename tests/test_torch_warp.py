"""Parity of the port's bounded bilinear warp (diligentfx_tpu_torch.ops.warp)
with the JAX package's Pallas warp (interpreted, as
tests/test_warp_pallas.py runs it) on the CPU.

Both sides take the same arithmetic steps (offset clamp, window-origin
round-down, clamp into the window, one horizontal lerp per tap row, rows
weighted 1 - fy and fy), so the tolerance is 1e-6 on values in [0, 1).
"""
import functools

import numpy as np
import pytest
import torch

from diligentfx_tpu.ops.warp_pallas import warp_bilinear_pallas
from diligentfx_tpu_torch.ops import warp as tw
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _case(h, w, c, reach, seed):
    """Image in [0, 1) and offsets uniform in +-reach px (dx, dy)."""
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, c) if c else (h, w)).astype(np.float32)
    off = ((rng.random((h, w, 2)) * 2 - 1)
           * np.array(reach, np.float32)).astype(np.float32)
    return img, off


# (h, w, channels (0 = a 2-D image), halo, offset reach (x, y))
CASES = {
    # the disocclusion tap's shape class: one channel, halo (16, 64),
    # offsets well beyond the halo (clamped to +-63 / +-15)
    "1ch_halo16_clamped": (48, 384, 0, (16, 64), (150.0, 40.0)),
    # multi-channel, halo (8, 64): the TAA history's class (its 4-channel
    # shape runs in tests/test_torch_postfx.py through taa_accumulate)
    "2ch_halo8": (24, 256, 2, (8, 64), (70.0, 9.0)),
    # 128 wide: the horizontal halo shrinks to 0, x offsets are ignored;
    # 16 rows: the vertical halo shrinks to 0 too
    "w128_shrink": (16, 128, 3, (16, 64), (20.0, 20.0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_warp_plain_matches_pallas(name):
    h, w, c, halo, reach = CASES[name]
    img, off = _case(h, w, c, reach, seed=len(name))
    ref = np.asarray(warp_bilinear_pallas(img, off, halo_r=halo[0],
                                          halo_c=halo[1]))
    got = tw.warp_bilinear(torch.from_numpy(img), torch.from_numpy(off),
                           halo_r=halo[0], halo_c=halo[1])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert tw.warp_bilinear.launches == 0        # the CPU runs no kernel


def test_warp_geometry():
    """Halo shrink and window widening (warp_pallas.py:117-135)."""
    assert tw.warp_geometry(1080, 1920, 16, 64) == (16, 64, 40, 384, 63.0,
                                                   15.0)
    assert tw.warp_geometry(1080, 1920, 8, 64) == (8, 64, 24, 384, 63.0, 7.0)
    assert tw.warp_geometry(16, 128, 16, 64) == (0, 0, 8, 128, 0.0, 0.0)
    assert tw.warp_geometry(64, 256, 16, 64) == (16, 64, 40, 256, 63.0,
                                                 15.0)
    with pytest.raises(ValueError):
        tw.warp_geometry(1080, 1000, 16, 64)
    with pytest.raises(ValueError):
        tw.warp_geometry(1080, 1920, 12, 64)


def test_warp_zero_offset_is_identity():
    img, _ = _case(24, 256, 2, (0.0, 0.0), seed=7)
    out = tw.warp_bilinear(torch.from_numpy(img), torch.zeros((24, 256, 2)))
    np.testing.assert_array_equal(out.numpy(), img)


def test_warp_wrapper_checks():
    img = torch.zeros((8, 128))
    with pytest.raises(ValueError):
        tw.warp_bilinear(img.to("meta"), torch.zeros((8, 128, 2)))
