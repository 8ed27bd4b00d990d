"""Parity of the port's multi-tap warp (diligentfx_tpu_torch.ops.warp
`warp_bilinear_multi`, K6) with the JAX package's Pallas kernel
`warp_bilinear_multi_pallas` (interpreted, as tests/test_warp_pallas.py
runs it) on the CPU, where the wrapper runs its plain version.

The plain version is K single-tap warps, so it equals K calls of
`warp_bilinear_plain` exactly.  Against the interpreted kernel the
tolerance is tests/test_torch_warp.py's 1e-6 on values in [0, 1): both
take the same steps (offset clamp, window origin rounded down to the tile
grid, clamp into the window, one horizontal lerp a tap row, rows weighted
1 - fy and fy), and XLA may contract a lerp into a fused multiply-add.
"""
import functools

import numpy as np
import pytest
import torch

from diligentfx_tpu.ops.warp_pallas import warp_bilinear_multi_pallas
from diligentfx_tpu_torch.ops import warp as tw
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _case(h, w, k, reach, seed):
    """Image in [0, 1) and K offset fields uniform in +-reach px."""
    rng = np.random.default_rng(seed)
    img = rng.random((h, w)).astype(np.float32)
    off = ((rng.random((k, h, w, 2)) * 2 - 1)
           * np.array(reach, np.float32)).astype(np.float32)
    return img, off


# (h, w, K, halo, offset reach (x, y))
CASES = {
    # tests/test_warp_pallas.py:70's shape: 5 taps within the halo
    "k5_halo16": (32, 256, 5, (16, 64), (20.0, 20.0)),
    # halo (8, 64): the vertical clamp at +-7
    "k3_halo8": (32, 256, 3, (8, 64), (30.0, 12.0)),
    # offsets well beyond the halo (clamped to +-63 / +-15), the window one
    # tile column wider (halo 64 is not a multiple of 128)
    "k4_beyond_halo": (48, 384, 4, (16, 64), (150.0, 40.0)),
    # 128 wide and 16 rows: both halos shrink to 0, offsets are ignored
    "k2_w128_shrink": (16, 128, 2, (16, 64), (20.0, 20.0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_warp_multi_matches_pallas(name):
    h, w, k, halo, reach = CASES[name]
    img, off = _case(h, w, k, reach, seed=len(name))
    ref = np.asarray(warp_bilinear_multi_pallas(img, off, halo_r=halo[0],
                                                halo_c=halo[1]))
    got = tw.warp_bilinear_multi(torch.from_numpy(img), torch.from_numpy(off),
                                 halo_r=halo[0], halo_c=halo[1])
    assert got.shape == ref.shape == (k, h, w)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert tw.warp_bilinear_multi.launches == 0   # the CPU runs no kernel


@pytest.mark.parametrize("name", list(CASES))
def test_warp_multi_plain_is_k_single_warps(name):
    """Each tap equals the single-tap warp of its offsets, bit for bit."""
    h, w, k, halo, reach = CASES[name]
    img, off = _case(h, w, k, reach, seed=len(name) + 1)
    img_t, off_t = torch.from_numpy(img), torch.from_numpy(off)
    multi = tw.warp_bilinear_multi_plain(img_t, off_t, halo_r=halo[0],
                                         halo_c=halo[1])
    for i in range(k):
        single = tw.warp_bilinear_plain(img_t, off_t[i], halo_r=halo[0],
                                        halo_c=halo[1])
        assert torch.equal(multi[i], single), i


def test_warp_multi_one_tap_and_no_taps():
    img, off = _case(24, 256, 1, (70.0, 9.0), seed=9)
    img_t = torch.from_numpy(img)
    one = tw.warp_bilinear_multi(img_t, torch.from_numpy(off))
    assert torch.equal(one[0], tw.warp_bilinear(img_t,
                                                torch.from_numpy(off[0])))
    none = tw.warp_bilinear_multi(img_t, torch.zeros((0, 24, 256, 2)))
    assert none.shape == (0, 24, 256)


def test_warp_multi_wrapper_checks():
    with pytest.raises(ValueError):              # a multi-channel image
        tw.warp_bilinear_multi(torch.zeros((8, 128, 2)),
                               torch.zeros((1, 8, 128, 2)))
    with pytest.raises(ValueError):              # not a CPU or CUDA tensor
        tw.warp_bilinear_multi(torch.zeros((8, 128)).to("meta"),
                               torch.zeros((1, 8, 128, 2)))
