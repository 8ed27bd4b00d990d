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


def _plain_windows(h, w, halo_r, halo_c):
    """Each tile's window origin (ry, rx) as warp_bilinear_plain computes
    it, and the window's size."""
    halo_r, halo_c, win_h, win_w, _, _ = tw.warp_geometry(h, w, halo_r,
                                                          halo_c)
    y0 = torch.arange(0, h, tw.TILE_H)
    x0 = torch.arange(0, w, tw.TILE_W)
    ry = (torch.clamp(y0 - halo_r, 0, h - win_h) // tw.TILE_H) * tw.TILE_H
    rx = (torch.clamp(x0 - halo_c, 0, w - win_w) // tw.TILE_W) * tw.TILE_W
    return ry.tolist(), rx.tolist(), win_h, win_w


# heights in use (the SSAO taps' 544, 1080, the 256x128 frames' padded
# halves) and odd tile-row counts (17, 9, 3)
WINDOW_HEIGHTS = [544, 1080, 64, 128, 136, 72, 24, 16]


@pytest.mark.parametrize("halo_r", [8, 16])
@pytest.mark.parametrize("h", WINDOW_HEIGHTS)
def test_windows_fit_the_bulk_copy(h, halo_r):
    """What K6's fill relies on: each tile's window lies inside the image
    and holds the tile, and each of its rows is a whole number of 16-byte
    chunks starting 16-byte aligned in a contiguous (h, w) f32 image (one
    cp.async.bulk a row)."""
    w = 1024
    rys, rxs, win_h, win_w = _plain_windows(h, w, halo_r, 64)
    assert (4 * win_w) % 16 == 0 and (4 * w) % 16 == 0
    for t, ry in enumerate(rys):
        assert ry % tw.TILE_H == 0 and 0 <= ry and ry + win_h <= h
        assert ry <= t * tw.TILE_H and t * tw.TILE_H + tw.TILE_H <= ry + win_h
    for t, rx in enumerate(rxs):
        assert (4 * rx) % 16 == 0 and 0 <= rx and rx + win_w <= w
        assert rx <= t * tw.TILE_W and t * tw.TILE_W + tw.TILE_W <= rx + win_w


# (h, w, halo): the SSAO-tap shape at both halos, 1080p, the card tests'
# shapes, odd tile-row counts and a wide halo
MULTI_CASES = [(544, 1024, (16, 64)), (544, 1024, (8, 64)),
               (1080, 1920, (16, 64)), (256, 1024, (32, 128)),
               (64, 128, (16, 64)), (136, 256, (16, 64)),
               (1096, 1024, (16, 64)), (24, 256, (8, 64))]


@pytest.mark.parametrize("k", [1, 3, 16, 17])
@pytest.mark.parametrize("case", MULTI_CASES)
def test_multi_params_equal_geometry(case, k):
    """K6's cached launch struct holds the shape, warp_geometry's values
    and the window's shared memory with its barrier, under the limit."""
    h, w, (halo_r, halo_c) = case
    p, addr = tw._multi_params(h, w, k, halo_r, halo_c)
    geo = tw.warp_geometry(h, w, halo_r, halo_c)
    assert (p.h, p.w, p.k) == (h, w, k)
    assert (p.halo_r, p.halo_c, p.win_h, p.win_w) == geo[:4]
    assert (p.cx, p.cy) == geo[4:]
    assert p.smem == 4 * p.win_h * p.win_w + 8
    assert p.smem <= tw.MAX_WINDOW_BYTES
    assert tw._multi_params(h, w, k, halo_r, halo_c)[1] == addr


def test_multi_params_at_the_ssao_taps():
    """At the 16 SSAO taps' 544 x 1024 a block's window is 40 x 384
    (61,448 B with its barrier), so the fill reads the image 15 times;
    a window over a block's shared memory raises."""
    p = tw._multi_params(544, 1024, 16, 16, 64)[0]
    assert (p.win_h, p.win_w, p.smem) == (40, 384, 61448)
    tiles = (544 // tw.TILE_H) * (1024 // tw.TILE_W)
    assert tiles * p.win_h * p.win_w / (544 * 1024) == 15
    with pytest.raises(ValueError):               # 136 x 1152: 626 KB
        tw._multi_params(1080, 1920, 1, 64, 512)


def test_warp_multi_launch_path_passes_params(monkeypatch):
    """K6's kernel path, Python half, with the launcher replaced."""
    calls = []

    def fake(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(tw, "_launcher", lambda name, symbol: fake)
    monkeypatch.setattr(tw, "_current_stream", lambda device: 99)
    monkeypatch.setattr(tw.warp_bilinear_multi, "launches", 0)
    img, off = _case(32, 256, 3, (5.0, 5.0), seed=4)
    img_t, off_t = torch.from_numpy(img), torch.from_numpy(off)
    out = tw._launch_multi(img_t, off_t, 16, 64)
    assert out.shape == (3, 32, 256)
    (pi, po, pq, params, device, stream), = calls
    assert (pi, po, pq) == (img_t.data_ptr(), off_t.data_ptr(),
                            out.data_ptr())
    p, addr = tw._multi_params(32, 256, 3, 16, 64)
    assert params == addr and (device, stream) == (img_t.get_device(), 99)
    assert p.k == 3
    assert tw.warp_bilinear_multi.launches == 1
    assert tw._launch_multi(img_t, off_t[:0], 16, 64).shape == (0, 32, 256)
    assert len(calls) == 1                        # K = 0 launches nothing


@pytest.mark.parametrize("off_shift", [0, 1])
@pytest.mark.parametrize("img_shift", [0, 1, 2, 3])
def test_warp_multi_alignment(monkeypatch, img_shift, off_shift):
    """K6 takes an image 16-byte aligned (its rows are bulk-copied) and
    offsets 8-byte aligned (float2 loads); views shifted by whole floats
    off that are refused before any launch."""
    calls = []
    monkeypatch.setattr(tw, "_launcher",
                        lambda name, symbol: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(tw, "_current_stream", lambda device: 0)
    monkeypatch.setattr(tw.warp_bilinear_multi, "launches", 0)
    n, m = 16 * 128, 2 * 16 * 128 * 2
    img = torch.zeros(n + 4)[img_shift:img_shift + n].view(16, 128)
    off = torch.zeros(m + 4)[off_shift:off_shift + m].view(2, 16, 128, 2)
    assert img.data_ptr() % 16 == 4 * img_shift % 16
    if img_shift == 0 and off_shift == 0:
        assert tw._launch_multi(img, off, 8, 64).shape == (2, 16, 128)
        assert len(calls) == 1
    else:
        with pytest.raises(ValueError):
            tw._launch_multi(img, off, 8, 64)
        assert not calls
