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


# the frames' K2 shapes (chip_smoke.py WARP_SHAPES: disocclusion, SSAO
# taps and history, SSR and TAA histories, the half-resolution DoF taps),
# five channels at 1080p and the halo-shrink cases: (h, w, channels, halo)
LAUNCH_SHAPES = [(1080, 1920, 1, (16, 64)), (544, 1024, 1, (16, 64)),
                 (1080, 1920, 2, (8, 64)), (544, 1024, 4, (16, 64)),
                 (1080, 1920, 4, (8, 64)), (544, 1024, 5, (16, 64)),
                 (1080, 1920, 5, (16, 64)),
                 (16, 128, 3, (16, 64)), (64, 128, 4, (16, 64)),
                 (24, 256, 2, (16, 64))]


@pytest.mark.parametrize("shape", LAUNCH_SHAPES)
def test_warp_launch_params_equal_geometry(shape):
    """The cached launch struct holds the shape and warp_geometry's values,
    and a second call returns the same struct."""
    h, w, c, (halo_r, halo_c) = shape
    params, addr = tw._warp_params(h, w, c, halo_r, halo_c)
    got = tuple(getattr(params, f) for f, _ in params._fields_)
    geo = tw.warp_geometry(h, w, halo_r, halo_c)
    assert got[:3] == (h, w, c)
    assert got[3:7] == geo[:4]
    assert got[7:] == pytest.approx(geo[4:], abs=0)
    assert tw._warp_params(h, w, c, halo_r, halo_c)[1] == addr


def test_warp_launch_path_passes_params(monkeypatch):
    """The kernel path's Python half, with the launcher replaced: the data
    pointers, the cached struct's address, the device index and the stream
    go to the launcher; a nonzero error raises; an image or offsets
    misaligned for their vector loads are refused before any launch."""
    calls = []
    code = [0]

    def fake(*args):
        calls.append(args)
        return code[0]
    monkeypatch.setattr(tw, "_launcher", lambda name, symbol: fake)
    monkeypatch.setattr(tw, "_current_stream", lambda device: 1234)
    monkeypatch.setattr(tw.warp_bilinear, "launches", 0)
    img, off = _case(16, 256, 2, (5.0, 5.0), seed=3)
    img_t, off_t = torch.from_numpy(img), torch.from_numpy(off)
    out = tw._launch(img_t, off_t, 8, 64)
    assert out.shape == img_t.shape and out.dtype == torch.float32
    (pi, po, pq, params, device, stream), = calls
    assert (pi, po, pq) == (img_t.data_ptr(), off_t.data_ptr(),
                            out.data_ptr())
    assert params == tw._warp_params(16, 256, 2, 8, 64)[1]
    assert (device, stream) == (img_t.get_device(), 1234)
    assert tw.warp_bilinear.launches == 1
    code[0] = 700
    with pytest.raises(RuntimeError):
        tw._launch(img_t, off_t, 8, 64)
    assert tw.warp_bilinear.launches == 1
    misaligned = torch.zeros(16 * 256 * 2 + 1)[1:].view(16, 256, 2)
    with pytest.raises(ValueError):                 # float2 texels
        tw._launch(misaligned, off_t, 8, 64)
    misaligned = torch.zeros(16 * 256 * 2 + 1)[1:].view(16, 256, 2)
    with pytest.raises(ValueError):                 # float2 offsets
        tw._launch(img_t, misaligned, 8, 64)
    with pytest.raises(TypeError):
        tw._launch(img_t.double(), off_t, 8, 64)
    with pytest.raises(ValueError):
        tw._launch(img_t, off_t[:8], 8, 64)
    assert len(calls) == 2


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 6])
def test_warp_alignment_follows_the_channel_class(monkeypatch, c, shift):
    """K2 needs the image aligned to its texel loads only: 16 bytes at C =
    4 (float4), 8 at C = 2 (float2), 4 otherwise (floats).  A contiguous
    view shifted by `shift` floats launches where that holds and is refused
    before any launch where it does not."""
    calls = []
    monkeypatch.setattr(tw, "_launcher",
                        lambda name, symbol: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(tw, "_current_stream", lambda device: 0)
    monkeypatch.setattr(tw.warp_bilinear, "launches", 0)
    n = 8 * 128 * c
    img = torch.zeros(n + 4)[shift:shift + n].view(8, 128, c)
    if c == 1:
        img = img[..., 0]
    off = torch.zeros((8, 128, 2))
    assert img.is_contiguous() and img.data_ptr() % 16 == 4 * shift
    need = {2: 8, 4: 16}.get(c, 4)
    if 4 * shift % need == 0:
        assert tw._launch(img, off, 8, 64).shape == img.shape
        assert len(calls) == 1 and calls[0][0] == img.data_ptr()
    else:
        with pytest.raises(ValueError):
            tw._launch(img, off, 8, 64)
        assert not calls
