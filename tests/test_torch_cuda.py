"""The port's CUDA kernels on the card: each kernel (K1 fused raster, K2
warp, K3 march, K4 two-pass raster, K5 fused GTAO, K6 multi-tap warp)
against its plain PyTorch version, the wrappers' checks and launch counts,
and small bench, csm, full-chain, editor and Hydra-stage frames on the GPU
against the port's CPU path.

These tests need an NVIDIA GPU (sm_90a) and nvcc; elsewhere they skip.  Run
them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py sets up JAX for the JAX package's tests,
and the port needs no JAX.)
"""
import numpy as np
import pytest
import torch

from diligentfx_tpu_torch.config import RasterizerConfig
from diligentfx_tpu_torch.ops import gtao as tg
from diligentfx_tpu_torch.ops import march as tm
from diligentfx_tpu_torch.ops import raster as tr
from diligentfx_tpu_torch.ops import raster_kernel as trk
from diligentfx_tpu_torch.ops import raster_tiles as trt
from diligentfx_tpu_torch.ops import warp as tw

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the port's CUDA kernels)")
    return torch.device("cuda")


def _triangles(n, seed, device):
    g = np.random.default_rng(seed)
    v = 3 * n
    clip = np.concatenate([g.uniform(-1.2, 1.2, (v, 2)),
                           g.uniform(0.1, 0.9, (v, 1)),
                           np.ones((v, 1))], -1).astype(np.float32)
    clip[: 3 * (n // 20)] *= np.float32(4.0)          # a few big triangles
    w = g.uniform(1.0, 3.0, (v, 1)).astype(np.float32)
    clip = clip * w
    idx = np.arange(v, dtype=np.int32).reshape(n, 3)
    attrs = g.standard_normal((v, 4)).astype(np.float32)
    consts = np.stack([g.integers(0, 5, n), g.integers(0, 9, n)],
                      -1).astype(np.float32)
    mt = g.standard_normal((6, 5)).astype(np.float32)
    return [torch.from_numpy(a).to(device)
            for a in (clip, idx, attrs, 1.0 / clip[:, 3], consts, mt)]


def _small_triangles(n, seed, device):
    """`_triangles`' layout with scene-like sizes: triangles of about 0.1
    NDC units around random centres, every twentieth eight times larger."""
    g = np.random.default_rng(seed)
    centre = np.repeat(g.uniform(-1.1, 1.1, (n, 2)), 3, axis=0)
    spread = np.where((np.arange(3 * n) // 3 % 20 == 0)[:, None], 0.4, 0.05)
    xy = centre + g.standard_normal((3 * n, 2)) * spread
    w = np.repeat(g.uniform(1.0, 3.0, (n, 1)), 3, axis=0)
    clip = (np.concatenate([xy, g.uniform(0.1, 0.9, (3 * n, 1)),
                            np.ones((3 * n, 1))], -1) * w).astype(np.float32)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    attrs = g.standard_normal((3 * n, 4)).astype(np.float32)
    consts = np.stack([g.integers(0, 5, n), g.integers(0, 9, n)],
                      -1).astype(np.float32)
    mt = g.standard_normal((6, 5)).astype(np.float32)
    return [torch.from_numpy(a).to(device)
            for a in (clip, idx, attrs, 1.0 / clip[:, 3], consts, mt)]


@pytest.mark.parametrize("sub_bins", [1, 4])
def test_raster_kernel_matches_plain(cuda, sub_bins):
    clip, idx, attrs, winv, consts, mt = _triangles(600, sub_bins, cuda)
    cfg = RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=512,
                           max_tiles_per_tri=8, big_tri_capacity=64, chunk=8,
                           pair_compaction_cap=1 << 14, sub_bins=sub_bins,
                           big_tile_capacity=16 if sub_bins > 1 else 0)
    k = tr.prepare_fused(clip, idx, attrs, winv, consts, mt, width=384,
                         height=256, cfg=cfg, n_ch=4, deriv_channels=(2,),
                         double_sided=torch.ones(600, dtype=torch.bool,
                                                 device=cuda))
    args = (k.setup, k.planes, k.candidates, k.counts, k.mat_table, k.rects)
    before = trk.raster_tiles_fused.launches
    z, tid, out = trk.raster_tiles_fused(*args, **k.kernel_kw)
    torch.cuda.synchronize()
    assert trk.raster_tiles_fused.launches == before + 1
    zp, tidp, outp = trk.raster_tiles_fused_plain(*args, **k.kernel_kw)
    assert torch.equal(tid, tidp)
    hit = tid >= 0
    assert 0.2 < float(hit.float().mean()) < 1.0
    assert torch.equal(z[hit], zp[hit])
    torch.testing.assert_close(out[:, hit], outp[:, hit], rtol=1e-5,
                               atol=1e-5)


def test_raster_kernel_unsegmented_at_cap_1536(cuda):
    """K1's unsegmented route (sub_bins 1) at the full-chain frame's bin
    capacity 1536 (examples/benchmark_suite.py:198), with tiles holding
    hundreds of candidates."""
    clip, idx, attrs, winv, consts, mt = _triangles(4000, 7, cuda)
    cfg = RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=1536,
                           max_tiles_per_tri=16, big_tri_capacity=64, chunk=8)
    k = tr.prepare_fused(clip, idx, attrs, winv, consts, mt, width=384,
                         height=256, cfg=cfg, n_ch=4, deriv_channels=(),
                         double_sided=torch.ones(4000, dtype=torch.bool,
                                                 device=cuda))
    assert k.kernel_kw["sub"] == 0 and k.candidates.shape[1] >= 1536
    assert int(k.counts.max()) > 512
    args = (k.setup, k.planes, k.candidates, k.counts, k.mat_table, k.rects)
    z, tid, out = trk.raster_tiles_fused(*args, **k.kernel_kw)
    torch.cuda.synchronize()
    zp, tidp, outp = trk.raster_tiles_fused_plain(*args, **k.kernel_kw)
    assert torch.equal(tid, tidp)
    hit = tid >= 0
    assert torch.equal(z[hit], zp[hit])
    torch.testing.assert_close(out[:, hit], outp[:, hit], rtol=1e-5,
                               atol=1e-5)


def test_raster_wrapper_rejects_bad_inputs(cuda):
    setup = torch.zeros((4, 16), device=cuda)
    planes = torch.zeros((4, 10), device=cuda)
    cand = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    counts = torch.zeros((2,), dtype=torch.int32, device=cuda)
    rects = tr.candidate_rects(setup, 256, 8)
    kw = dict(th=8, tw=128, tiles_x=2, n_ch=2, n_const=1)
    with pytest.raises(TypeError):
        trk.raster_tiles_fused(setup.double(), planes, cand, counts, None,
                               rects, **kw)
    with pytest.raises(ValueError):
        trk.raster_tiles_fused(setup, planes.cpu(), cand, counts, None,
                               rects, **kw)
    with pytest.raises(ValueError):
        trk.raster_tiles_fused(setup, planes[:, :7], cand, counts, None,
                               rects, **kw)
    with pytest.raises(ValueError):                  # 2 tiles, rows of 3
        trk.raster_tiles_fused(setup, planes, cand, counts, None, rects,
                               **dict(kw, tiles_x=3))
    with pytest.raises(TypeError):
        trk.raster_tiles_fused(setup, planes, cand, counts, None,
                               rects.long(), **kw)
    with pytest.raises(ValueError):                  # one rectangle short
        trk.raster_tiles_fused(setup, planes, cand, counts, None,
                               rects[:3].contiguous(), **kw)
    with pytest.raises(ValueError, match="shared memory"):
        trk.raster_tiles_fused(setup, planes, cand, counts,
                               torch.zeros((20, 3000), device=cuda), rects,
                               **kw)
    z, tid, out = trk.raster_tiles_fused(setup, planes, cand, counts, None,
                                         rects, **kw)
    assert bool(torch.isinf(z).all()) and bool((tid == -1).all())


def _viewport(clip, idx, w, h, off, cuda, near=False):
    """Setup rows of (clip, idx) seen through a w x h viewport at `off` of
    a screen twice its height; with `near`, every tenth triangle's first
    corner goes behind the camera, so that the near plane clips it."""
    if near:
        clip = clip.clone()
        clip[0::30, 3] = -clip[0::30, 3].abs() - 0.2
    ds = torch.ones(idx.shape[0], dtype=torch.bool, device=cuda)
    return clip, ds, dict(screen_size=(w, 2 * h), screen_offset=off)


@pytest.mark.parametrize("case", [(8, 128, 1, True, False),
                                  (24, 128, 1, False, False),
                                  (24, 128, 3, True, False),
                                  (64, 128, 8, False, False),
                                  (64, 128, 1, True, False),
                                  (16, 256, 1, False, False),
                                  (16, 256, 2, True, False),
                                  (32, 128, 4, True, True),
                                  (32, 128, 1, False, True)])
def test_raster_kernel_tile_shapes(cuda, case):
    """K1 vs its plain version at every tile shape the JAX config takes
    (8, 24, 64 rows of 128 columns, 16 of 256), unsegmented and in sub-bins
    of 8 rows, standard and reversed depth, under a viewport offset, on
    scene-sized triangles (the culling skips most pairs); the last two
    cases with triangles across the near plane."""
    th, tw_, sub, depth_less, near = case
    w, h, off = 512 if tw_ == 256 else 384, 192, (0, 96)
    clip, idx, attrs, winv, consts, mt = _small_triangles(3000, th + sub,
                                                          cuda)
    clip, ds, vp = _viewport(clip, idx, w, h, off, cuda, near)
    cfg = RasterizerConfig(tile_h=th, tile_w=tw_, bin_capacity=96 * sub,
                           max_tiles_per_tri=8, big_tri_capacity=64, chunk=8,
                           pair_compaction_cap=1 << 15, sub_bins=sub,
                           big_tile_capacity=16)
    k = tr.prepare_fused(clip, idx, attrs, winv, consts, mt, width=w,
                         height=h, cfg=cfg, n_ch=4, deriv_channels=(1,),
                         double_sided=ds, depth_less=depth_less, **vp)
    assert k.kernel_kw["sub"] == (sub if sub > 1 else 1)
    args = (k.setup, k.planes, k.candidates, k.counts, k.mat_table, k.rects)
    z, tid, out = trk.raster_tiles_fused(*args, **k.kernel_kw)
    torch.cuda.synchronize()
    zp, tidp, outp = trk.raster_tiles_fused_plain(*args, **k.kernel_kw)
    assert torch.equal(tid, tidp)
    hit = tid >= 0
    assert 0.2 < float(hit.float().mean()) < 1.0
    assert torch.equal(z[hit], zp[hit])
    torch.testing.assert_close(out[:, hit], outp[:, hit], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", [(1080, 1920, 1, (16, 64)),
                                  (1080, 1920, 4, (8, 64)),
                                  (64, 128, 3, (16, 64)),
                                  (40, 384, 2, (8, 64)),
                                  # five channels at 1080p, the SSAO taps,
                                  # the SSAO history (C = 5, 1, 2)
                                  (1080, 1920, 5, (16, 64)),
                                  (544, 1024, 1, (16, 64)),
                                  (1080, 1920, 2, (8, 64)),
                                  # widths 128 and 256 at every channel
                                  # class; 16 x 128 shrinks both halos
                                  (16, 128, 1, (16, 64)),
                                  (16, 128, 4, (8, 64)),
                                  (48, 256, 3, (8, 64)),
                                  (24, 128, 2, (16, 64)),
                                  # 72 rows: the last tile rows' window is
                                  # clamped at the bottom; C = 6 takes the
                                  # kernel's loop over channels
                                  (72, 256, 5, (16, 64)),
                                  (72, 1920, 6, (8, 64)),
                                  # the DoF taps' half-resolution image
                                  (544, 1024, 5, (16, 64))])
def test_warp_kernel_matches_plain(cuda, case):
    """K2 equals its plain version bit for bit at each channel class (C =
    1, 2, 4 as vectors, 3 and 5 a thread an element, any other C), offsets
    up to three halos."""
    h, w, c, halo = case
    g = torch.Generator(device=cuda)
    g.manual_seed(h + c)
    img = torch.rand((h, w, c), generator=g, device=cuda)
    if c == 1:
        img = img[..., 0].contiguous()
    off = (torch.rand((h, w, 2), generator=g, device=cuda) * 2 - 1) * \
        torch.tensor([3.0 * halo[1], 3.0 * halo[0]], device=cuda)
    before = tw.warp_bilinear.launches
    a = tw.warp_bilinear(img, off, halo_r=halo[0], halo_c=halo[1])
    torch.cuda.synchronize()
    assert tw.warp_bilinear.launches == before + 1
    b = tw.warp_bilinear_plain(img, off, halo_r=halo[0], halo_c=halo[1])
    assert a.shape == img.shape and torch.equal(a, b)


def test_warp_wrapper_rejects_bad_inputs(cuda):
    img = torch.zeros((8, 128), device=cuda)
    with pytest.raises(TypeError):
        tw.warp_bilinear(img.double(), torch.zeros((8, 128, 2), device=cuda))
    with pytest.raises(ValueError):
        tw.warp_bilinear(img, torch.zeros((8, 64, 2), device=cuda))
    with pytest.raises(ValueError):
        tw.warp_bilinear(torch.zeros((8, 100), device=cuda),
                         torch.zeros((8, 100, 2), device=cuda))
    with pytest.raises(ValueError):              # offsets on the CPU
        tw.warp_bilinear(img, torch.zeros((8, 128, 2)))
    with pytest.raises(ValueError):              # not contiguous
        tw.warp_bilinear(torch.zeros((128, 8), device=cuda).t(),
                         torch.zeros((8, 128, 2), device=cuda))
    with pytest.raises(ValueError):              # float4 texels, 4-aligned
        tw.warp_bilinear(torch.zeros(8 * 128 * 4 + 1, device=cuda)[1:]
                         .view(8, 128, 4), torch.zeros((8, 128, 2), device=cuda))
    with pytest.raises(ValueError):              # float2 offsets, 4-aligned
        tw.warp_bilinear(img, torch.zeros(8 * 128 * 2 + 1, device=cuda)[1:]
                         .view(8, 128, 2))


@pytest.mark.parametrize("c", [1, 3, 5])
def test_warp_kernel_on_a_4_byte_aligned_view(cuda, c):
    """The channel classes that load floats take an image view 4 bytes
    past a 16-byte boundary (a row slice of an odd-width image) and stay
    exact."""
    g = torch.Generator(device=cuda)
    g.manual_seed(c)
    n = 64 * 256 * c
    img = torch.rand(n + 1, generator=g, device=cuda)[1:].view(64, 256, c)
    if c == 1:
        img = img[..., 0]
    assert img.is_contiguous() and img.data_ptr() % 16 == 4
    off = (torch.rand((64, 256, 2), generator=g, device=cuda) * 2 - 1) * 40
    a = tw.warp_bilinear(img, off)
    assert torch.equal(a, tw.warp_bilinear_plain(img, off))


@pytest.mark.parametrize("shape", [(16384, 16384, 8), (32768, 65536, 1)])
def test_warp_kernel_past_2_31_elements(cuda, shape):
    """An image of 2^31 elements (the element kernel at C = 8; 2^31 pixels
    of one float) takes K2's 64-bit indices: its first and last rows equal
    the plain version of a 64-row crop there (whose windows, away from the
    crop's inner edge, are the full image's)."""
    h, w, c = shape
    g = torch.Generator(device=cuda)
    g.manual_seed(c)
    img = torch.rand(shape, generator=g, device=cuda)
    if c == 1:
        img = img[..., 0]
    off = torch.empty((h, w, 2), device=cuda).uniform_(-1, 1, generator=g)
    off *= torch.tensor([192.0, 48.0], device=cuda)
    a = tw.warp_bilinear(img, off)
    torch.cuda.synchronize()
    # halo (16, 64): a 40-row window, so crop rows 16.. of the bottom crop
    # and 0..47 of the top one see the full image's windows
    top = tw.warp_bilinear_plain(img[:64], off[:64])
    bottom = tw.warp_bilinear_plain(img[h - 64:], off[h - 64:])
    assert torch.equal(a[:48], top[:48])
    assert torch.equal(a[h - 48:], bottom[16:])
    del img, off, a
    torch.cuda.empty_cache()


def test_warp_kernels_on_a_second_card(cuda):
    """A tensor on device 1 launches there; the current device stays."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    dev = torch.device("cuda", 1)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    img = torch.rand((64, 256, 4), generator=g, device=dev)
    off = (torch.rand((64, 256, 2), generator=g, device=dev) * 2 - 1) * 40
    current = torch.cuda.current_device()
    a = tw.warp_bilinear(img, off)
    m = tw.warp_bilinear_multi(img[..., 0].contiguous(), off[None])
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == current
    assert a.device == dev and torch.equal(a, tw.warp_bilinear_plain(img, off))
    assert torch.equal(m[0], tw.warp_bilinear_plain(img[..., 0], off))


def _multi_case(cuda, h, w, k, halo, seed):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    img = torch.rand((h, w), generator=g, device=cuda)
    off = ((torch.rand((k, h, w, 2), generator=g, device=cuda) * 2 - 1)
           * torch.tensor([3.0 * halo[1], 3.0 * halo[0]], device=cuda))
    return img, off


def _assert_multi_exact(a, img, off, halo):
    """K6's taps equal the plain version and K launches of K2 exactly."""
    kw = dict(halo_r=halo[0], halo_c=halo[1])
    assert torch.equal(a, tw.warp_bilinear_multi_plain(img, off, **kw))
    for i in range(off.shape[0]):
        assert torch.equal(a[i], tw.warp_bilinear(img, off[i].contiguous(),
                                                  **kw))


@pytest.mark.parametrize("case", [(544, 1024, 16, (16, 64)),
                                  (544, 1024, 16, (8, 64)),
                                  (256, 1024, 3, (32, 128)),
                                  (64, 128, 4, (16, 64)),
                                  (1080, 1920, 1, (16, 64)),
                                  # K not a multiple of the tap chunk
                                  (544, 1024, 17, (8, 64)),
                                  (1080, 1920, 17, (16, 64)),
                                  (136, 256, 3, (16, 64))])
def test_warp_multi_kernel_matches_plain(cuda, case):
    """K6 vs its plain version and K launches of K2, exactly: the SSAO-tap
    shape (a 40 x 384 window, 61,448 B of shared memory with its barrier),
    halo (8, 64), a 72 x 384 window (110,600 B), a 128-wide image (halos
    shrink to 0), K = 1, 3, 16 and 17; every image's first and last
    windows are clamped at its top and bottom; offsets up to 3 halos."""
    h, w, k, halo = case
    img, off = _multi_case(cuda, h, w, k, halo, h + k)
    before = tw.warp_bilinear_multi.launches
    a = tw.warp_bilinear_multi(img, off, halo_r=halo[0], halo_c=halo[1])
    torch.cuda.synchronize()
    assert tw.warp_bilinear_multi.launches == before + 1
    _assert_multi_exact(a, img, off, halo)


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("halo", [(8, 64), (16, 64)])
def test_warp_multi_odd_tile_rows_match_plain(cuda, halo, k):
    """17 tile rows (a 136-row image): the windows of the first and last
    tile rows clamped at the top and bottom, exact at every halo and at K
    below, at and above the tap chunk of 2."""
    img, off = _multi_case(cuda, 136, 256, k, halo, 17 * k)
    a = tw.warp_bilinear_multi(img, off, halo_r=halo[0], halo_c=halo[1])
    torch.cuda.synchronize()
    _assert_multi_exact(a, img, off, halo)


def test_warp_multi_wrapper_rejects_bad_inputs(cuda):
    img = torch.zeros((8, 128), device=cuda)
    off = torch.zeros((2, 8, 128, 2), device=cuda)
    with pytest.raises(TypeError):
        tw.warp_bilinear_multi(img.double(), off)
    with pytest.raises(ValueError):
        tw.warp_bilinear_multi(img, off[:, :, :64])
    with pytest.raises(ValueError):
        tw.warp_bilinear_multi(img[..., None], off)
    with pytest.raises(ValueError):
        tw.warp_bilinear_multi(img, off.cpu())
    with pytest.raises(ValueError):              # not contiguous
        tw.warp_bilinear_multi(img, off.transpose(0, 1).contiguous()
                               .transpose(0, 1))
    with pytest.raises(ValueError):              # a 136 x 1152 window: 626 KB
        tw.warp_bilinear_multi(torch.zeros((1080, 1920), device=cuda),
                               torch.zeros((1, 1080, 1920, 2), device=cuda),
                               halo_r=64, halo_c=512)
    assert tw.warp_bilinear_multi(img, off[:0]).shape == (0, 8, 128)


@pytest.mark.parametrize("case", [(67, 120, 544, 1024, 0.05),
                                  (16, 32, 64, 128, 0.0),
                                  (24, 100, 64, 256, 0.4),
                                  (128, 128, 64, 256, 0.05),
                                  (454, 128, 64, 256, 0.05),
                                  (600, 128, 64, 256, 0.05),
                                  (447, 128, 64, 256, 0.05),
                                  (67, 119, 64, 256, 0.2),
                                  (1, 128, 8, 128, 0.5)])
def test_march_kernel_matches_plain(cuda, case):
    """K3 vs march_dda_plain: the same hits and t (the bench frame's table
    size, a small table, 40% nearly horizontal rays, a 1024x1024 frame's
    128-row table, 454- and 600-row tables, which the kernel reads from
    global memory; the tallest table shared memory holds, 447 rows at pitch
    128, an odd column count, and a one-row table).  Both kernel variants
    and both shared pitches (ops/march.py `march_table_pitch`) run."""
    import chip_smoke as cs
    rows, cols, h, w, flat = case
    g = torch.Generator(device=cuda)
    g.manual_seed(rows)
    coarse, o, d = cs._flat_rays(g, h, w, rows, cols, flat_share=flat)
    thick = torch.tensor(0.03, device=cuda)
    before = tm.march_small_table.launches
    got = tm.march_small_table(coarse, o, d, thick)
    torch.cuda.synchronize()
    assert tm.march_small_table.launches == before + 1
    want = tm.march_dda_plain(coarse, o, d, thick)
    assert torch.equal(got[2], want[2])
    assert 0.05 < float(want[2].float().mean()) < 0.95
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)


def test_march_on_a_square_frame(cuda):
    """K3 at a 1024x1024 frame: compute_ssr(use_pallas=True) at divisor 2
    marches the 128 x 128 mip 2 of the 512^2 depth (65,536 bytes, beyond
    48 KB) through the kernel; the kernel equals march_dda_plain on the
    frame's own rays."""
    import chip_smoke as cs
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.deferred import render_gbuffer
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    from diligentfx_tpu_torch.postfx import ssr
    n = 1024
    ren = PBRRenderer(PBRRendererCreateInfo(
        brdf_lut_dim=8, num_brdf_samples=4, irradiance_cube_dim=8,
        prefiltered_env_map_dim=8, num_specular_env_samples=4),
        raster_cfg=cs.bench_raster_config(), device=cuda)
    info = cs.render_info(n, n, cuda)
    gb = render_gbuffer(cs.bench_scene(2, 2, 12, cuda), info, ren.ibl_maps,
                        ren.env_oct, width=n, height=n, cfg=ren.raster_cfg,
                        fast_env=True)
    st = cs.bench_settings().ssr
    depth_r = gb.depth[::2, ::2]
    *_, origin, direction = ssr._ray_setup(
        depth_r, gb.normal_view[::2, ::2], gb.material_data[::2, ::2, 1:2],
        info.camera, 1, st)
    coarse = ssr._coarse_table(ssr.build_min_depth_pyramid(depth_r, 4), 2,
                               True)
    assert tuple(coarse.shape) == (128, 128)
    args = ssr._kernel_march_args(coarse, origin, direction)
    thick = ssr._thickness_ndc(st, info.camera)
    got = tm.march_small_table(*args, thick)
    torch.cuda.synchronize()
    want = tm.march_dda_plain(*args, thick)
    assert torch.equal(got[2], want[2]) and bool(want[2].any())
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
    lit = gb.direct + gb.ambient_diffuse + gb.ambient_specular
    before = tm.march_small_table.launches
    out, _ = ssr.compute_ssr(lit, gb.depth, gb.normal_view,
                             gb.material_data[..., 1:2], info.camera, 1, st,
                             half_resolution=True, resolution_divisor=2,
                             use_pallas=True)
    torch.cuda.synchronize()
    assert tm.march_small_table.launches == before + 1
    assert out.shape == (n, n, 4) and bool(torch.isfinite(out).all())


def test_march_wrapper_rejects_bad_inputs(cuda):
    o = torch.zeros((8, 128, 3), device=cuda)
    # a 100-row table (51,200 bytes) runs: the kernel opts in to more than
    # 48 KB of shared memory
    t_lo, t_hit, hit = tm.march_small_table(
        torch.zeros((100, 128), device=cuda), o, o, 0.1)
    assert not bool(hit.any()) and bool((t_hit == 1.0).all())
    with pytest.raises(TypeError):
        tm.march_small_table(torch.zeros((8, 64), device=cuda).double(), o,
                             o, 0.1)
    with pytest.raises(ValueError):
        tm.march_small_table(torch.zeros((8, 64), device=cuda), o.cpu(), o,
                             0.1)


@pytest.mark.parametrize("shape", [(540, 960), (64, 256), (100, 700)])
def test_gtao_kernel_matches_plain(cuda, shape):
    """K5 vs gtao_fused_plain within 1e-5: the bench frame's half-resolution
    grid (padded to 544 x 1024), the smallest open-halo grid, and a grid
    whose window widens and whose origin rounds down."""
    h, w = shape
    g = torch.Generator(device=cuda)
    g.manual_seed(h)
    yy = torch.arange(h, device=cuda, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=cuda, dtype=torch.float32)[None, :]
    depth = (0.55 + 0.25 * torch.sin(yy * 0.11) * torch.cos(xx * 0.05)
             + 0.05 * torch.rand((h, w), generator=g, device=cuda))
    n = torch.stack([0.15 * torch.sin(xx * 0.07).expand(h, w),
                     0.15 * torch.cos(yy * 0.09).expand(h, w),
                     torch.ones((h, w), device=cuda)], -1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    sc = torch.tensor([3.0, 1.0, 0.385, 0.615, 0.8, 1.4, 0.1, 100.0],
                      device=cuda)
    before = tg.gtao_fused.launches
    got = tg.gtao_fused(depth, n.contiguous(), sc, num_slices=2, num_steps=4)
    torch.cuda.synchronize()
    assert tg.gtao_fused.launches == before + 1
    want = tg.gtao_fused_plain(depth, n.contiguous(), sc, num_slices=2,
                               num_steps=4)
    assert got.shape == (h, w)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 256), (540, 960)])
def test_gtao_kernel_on_an_unaligned_depth(cuda, shape):
    """A depth that needs no padding and starts 4 bytes into its storage,
    which the wrapper passes to the kernel as it is: K5 equals
    gtao_fused_plain within 1e-5 (64 x 256: the halo shrinks to 16 rows and
    the window covers the whole image)."""
    h, w = shape
    g = torch.Generator(device=cuda)
    g.manual_seed(w)
    store = 0.3 + 0.6 * torch.rand(h * w + 1, generator=g, device=cuda)
    depth = store[1:].view(h, w)
    assert depth.data_ptr() % 16 != 0 and depth.is_contiguous()
    n = torch.nn.functional.normalize(
        torch.rand((h, w, 3), generator=g, device=cuda) - 0.5, dim=-1)
    n[..., 2] = n[..., 2].abs() + 0.1
    sc = torch.tensor([7.0, 1.0, 0.385, 0.615, 0.8, 1.4, 0.1, 100.0],
                      device=cuda)
    got = tg.gtao_fused(depth, n, sc, num_slices=2, num_steps=4)
    torch.cuda.synchronize()
    want = tg.gtao_fused_plain(depth, n, sc, num_slices=2, num_steps=4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_gtao_wrapper_rejects_bad_inputs(cuda):
    sc = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="collapses"):
        tg.gtao_fused(torch.zeros((32, 256), device=cuda),
                      torch.zeros((32, 256, 3), device=cuda), sc,
                      num_slices=2, num_steps=4)
    with pytest.raises(TypeError):
        tg.gtao_fused(torch.zeros((64, 256), device=cuda).double(),
                      torch.zeros((64, 256, 3), device=cuda), sc,
                      num_slices=2, num_steps=4)


@pytest.mark.parametrize("config", ["slice", "bench"])
def test_small_frame_matches_cpu_path(cuda, config):
    """Two 256x128 frames on the GPU vs the port's CPU path (plain
    versions): 50 dB.  "bench" is the full bench feature set (K1, K2, K3);
    "slice" the first slice's frame (K1, K2; SSAO and SSR off, so the
    composite applies no AO and blends no reflection)."""
    import chip_smoke as cs
    from diligentfx_tpu_torch.utils.image import psnr
    task_ci = (cs.bench_task_manager_ci() if config == "bench"
               else cs.slice_task_manager_ci())
    cpu, gpu = cs.small_frames(task_ci, cuda)
    assert np.isfinite(gpu).all()
    assert psnr(cpu, gpu) > 50.0


@pytest.mark.parametrize("case", [(32, 1, True), (8, 4, False),
                                  (16, 1, True),
                                  (24, 2, False, 128, False, True),
                                  (64, 3, True, 128, False, True),
                                  (16, 5, False, 256, False, True),
                                  (32, 6, True, 128, True, True),
                                  (24, 7, False, 128, True, False)])
def test_raster_tiles_kernel_matches_plain(cuda, case):
    """K4 vs raster_tiles_plain: ids exact, z / b0 / b1 equal; 8, 16, 24,
    32 and 64 rows of 128 columns and 16 of 256, a tile list capped below
    the big-triangle count (tiles at the cap), reversed depth, a viewport
    offset, large and scene-sized triangles; two cases with triangles
    across the near plane."""
    th, seed, depth_less, tw_, near, small = \
        case + (128, False, False)[len(case) - 3:]
    clip, idx, *_ = (_small_triangles(3000, seed, cuda) if small
                     else _triangles(800, seed, cuda))
    cfg = RasterizerConfig(tile_h=th, tile_w=tw_, bin_capacity=96,
                           max_tiles_per_tri=8, big_tri_capacity=32, chunk=8)
    w, h, off = 512 if tw_ == 256 else 384, 192 if th in (24, 64) else 256, \
        (0, 64)
    clip, ds, vp = _viewport(clip, idx, w, h, off, cuda, near)
    setup, valid, bbox, _, _ = tr._triangle_setup(clip, idx, w, h, ds, True,
                                                  1e-3, **vp)
    cand, counts, *_ = tr._bin_triangles(valid, bbox, w, h, cfg)
    assert int(counts.max()) > cand.shape[1] or th != 32 or small  # the cap
    rects = tr.candidate_rects(setup, w, h, off)
    kw = dict(th=th, tw=tw_, tiles_x=w // tw_, depth_less=depth_less,
              screen_offset=off)
    before = trt.raster_tiles.launches
    a = trt.raster_tiles(setup, cand, counts, rects, **kw)
    torch.cuda.synchronize()
    assert trt.raster_tiles.launches == before + 1
    b = trt.raster_tiles_plain(setup, cand, counts, rects, **kw)
    assert torch.equal(a[1], b[1])
    hit = b[1] >= 0
    assert float(hit.float().mean()) > 0.2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_raster_tiles_rejects_bad_inputs(cuda):
    setup = torch.zeros((4, 16), device=cuda)
    cand = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    counts = torch.zeros((2,), dtype=torch.int32, device=cuda)
    rects = tr.candidate_rects(setup, 256, 24)
    kw = dict(th=8, tw=128, tiles_x=2)
    with pytest.raises(TypeError):
        trt.raster_tiles(setup.double(), cand, counts, rects, **kw)
    with pytest.raises(TypeError):
        trt.raster_tiles(setup, cand.long(), counts, rects, **kw)
    with pytest.raises(ValueError):
        trt.raster_tiles(setup, cand.cpu(), counts, rects, **kw)
    with pytest.raises(ValueError):
        trt.raster_tiles(setup[:, :9], cand, counts, rects, **kw)
    with pytest.raises(ValueError):                  # 2 tiles, rows of 3
        trt.raster_tiles(setup, cand, counts, rects, **dict(kw, tiles_x=3))
    with pytest.raises(ValueError):                  # rows not a multiple of 8
        trt.raster_tiles(setup, cand, counts, rects, **dict(kw, th=12))
    with pytest.raises(ValueError):                  # a misaligned view
        trt.raster_tiles(setup.flatten()[1:49].reshape(3, 16), cand, counts,
                         rects[:3].contiguous(), **kw)
    # 24 rows a tile runs (any multiple of 8)
    z, tid, b0, b1 = trt.raster_tiles(setup, cand, counts, rects,
                                      **dict(kw, th=24))
    assert z.shape == (2, 24, 128) and bool(torch.isinf(z).all())
    z, tid, b0, b1 = trt.raster_tiles(setup, cand, counts, rects, **kw)
    assert bool(torch.isinf(z).all()) and bool((tid == -1).all())


def test_small_csm_frame_matches_cpu_path(cuda):
    """Two 256x128 csm frames (textures, 2-cascade EVSM2 shadows) on the
    GPU vs the port's CPU path: 50 dB."""
    import chip_smoke as cs
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu = cs.small_csm_frames(cuda)
    assert np.isfinite(gpu).all()
    assert psnr(cpu, gpu) > 50.0


@pytest.mark.parametrize("fuse", ["off", "on"])
def test_forward_csm_frame_matches_cpu_path(cuda, fuse):
    """PBRRenderer.render of the csm_256 scene on the two-pass (K4) and
    fused (K1) branches vs the CPU path: 50 dB."""
    import chip_smoke as cs
    from diligentfx_tpu_torch.utils.image import psnr
    cpu = cs.forward_csm_frame("cpu", "auto")
    gpu = cs.forward_csm_frame(cuda, fuse)
    assert np.isfinite(gpu).all()
    assert psnr(cpu, gpu) > 50.0


def test_small_full_chain_frame_matches_cpu_path(cuda):
    """Two 256x128 full-chain frames (DoF on the warp route, epipolar
    scattering, auto exposure; the camera moving) on the GPU vs the port's
    CPU path: 50 dB."""
    import chip_smoke as cs
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu = cs.small_full_chain_frames(cuda)
    assert np.isfinite(gpu).all()
    assert psnr(cpu, gpu) > 50.0


@pytest.mark.parametrize("face", ["point +X", "point -Y", "spot", "sun"])
def test_raster_tiles_at_light_slices(cuda, face):
    """K4 vs raster_tiles_plain at the light / heap atrium's shadow-atlas
    slices (4 columns, 512^2 slices: the point light's cube faces, with
    heavy near-clipping, the spot and the sun): every output equal, no
    slice overflowing its lists."""
    import chip_smoke as cs
    rs = cs.light_heap_render_scene(cuda, n_columns=4)
    setup = cs.light_shadow_setup(rs, slice_size=512)
    slices = {label: (args, kw, st) for label, args, kw, st in
              cs.light_slice_inputs(rs, setup,
                                    cs.light_slice_raster_config())}
    args, kw, st = slices[face]
    assert st["bin_overflow"] == st["big_overflow"] == 0
    assert st["clip_overflow"] == 0 and st["valid"] > 0
    a = trt.raster_tiles(*args, **kw)
    torch.cuda.synchronize()
    b = trt.raster_tiles_plain(*args, **kw)
    assert bool((b[1] >= 0).any())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("lod", [0.0, 1.3, 9.0])
def test_sample_heap_matches_cpu(cuda, lod):
    """sample_heap on the card against the CPU on odd-sized textures, uv
    outside [0, 1] in every wrap mode, lods at and past the chain: equal
    within 1e-6 (the same fp32 operations; the card may fuse none)."""
    from diligentfx_tpu_torch.ops import texture as tt
    g = np.random.default_rng(8)
    builder = tt.TextureHeapBuilder()
    for shape in ((600, 1000, 4), (37, 5, 3), (256, 256, 4)):
        builder.add((g.random(shape) * 255).astype(np.uint8))
    heaps = [builder.build(device=d) for d in ("cpu", cuda)]
    for f in ("texels", "mip_base", "mip_size"):
        assert torch.equal(getattr(heaps[0], f),
                           getattr(heaps[1], f).cpu())
    uv = torch.from_numpy(g.uniform(-2.5, 3.5, (300, 200, 2)).astype(
        np.float32))
    tex = torch.from_numpy(g.integers(0, 3, (300, 200)).astype(np.int32))
    wrap = torch.from_numpy(g.integers(0, 3, (300, 200, 2)).astype(
        np.int32))
    lods = torch.full((300, 200), lod)
    out = [tt.sample_heap(h, tex.to(d), uv.to(d), lods.to(d),
                          wrap_u=wrap[..., 0].to(d), wrap_v=wrap[..., 1].to(d))
           for h, d in zip(heaps, ("cpu", cuda))]
    assert torch.allclose(out[1].cpu(), out[0], rtol=0, atol=1e-6)


def _showroom(device, **kw):
    """chip_smoke.py's ext_skin showroom without the atrium, at a small
    size, animated to t = 0.4 s (previous 0.3 s): (RenderScene, meta)."""
    import chip_smoke as cs
    from diligentfx_tpu_torch.gltf.model import update_animation
    model, rs, player, meta = cs.ext_skin_model(device, atrium=False,
                                                normal_size=64, **kw)
    return update_animation(rs, model, player, 0.4, 0.3), meta


def test_skin_blend_matches_cpu(cuda):
    """transform_vertices of the skinned showroom (two figures of 32
    joints, the unskinned spheres) on the card against the CPU, current and
    previous frame: world positions bit for bit (the blend is fp32
    multiply-adds, one operation a kernel: no FMA, no TF32), normals and
    tangents within 1e-6 (the card's rsqrt)."""
    from diligentfx_tpu_torch.pbr.renderer import transform_vertices
    scenes = [_showroom(d, n_figures=2, sphere=(12, 24), tube=(8, 2))[0]
              for d in ("cpu", cuda)]
    for previous in (False, True):
        a, b = (transform_vertices(rs.scene, previous=previous)
                for rs in scenes)
        assert torch.equal(a[0], b[0].cpu())
        for x, y in zip(a[1:], b[1:]):
            torch.testing.assert_close(y.cpu(), x, rtol=0, atol=1e-6)
    sc = scenes[1].scene
    assert bool((sc.weights.sum(-1) > 0).any())
    assert bool((sc.joints == -1).any())


def test_charlie_lut_and_iridescence_match_cpu(cuda):
    """precompute_charlie_lut (64^2, 256 samples) and iridescence_fresnel
    (random IORs, base F0, 0-1200 nm films, all angles) on the card
    against the CPU: within 1e-5 (the card's pow, exp, cos and sqrt differ
    from the CPU's in the last bits; the LUT sums 256 of them)."""
    from diligentfx_tpu_torch.pbr import brdf, ibl
    lut = [ibl.precompute_charlie_lut(64, 256, device=d)
           for d in ("cpu", cuda)]
    torch.testing.assert_close(lut[1].cpu(), lut[0], rtol=0, atol=1e-5)
    g = np.random.default_rng(3)
    args = [g.uniform(1.0, 2.5, (4096, 1)), g.uniform(0.02, 1.0, (4096, 3)),
            g.uniform(0.0, 1200.0, (4096, 1)), g.uniform(0.0, 1.0,
                                                         (4096, 1))]
    args = [torch.from_numpy(a.astype(np.float32)) for a in args]
    cpu = brdf.iridescence_fresnel(1.0, *args)
    gpu = brdf.iridescence_fresnel(1.0, *(a.to(cuda) for a in args))
    assert float(cpu.max() - cpu.min()) > 0.5
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-5, atol=1e-5)


def test_raster_kernel_at_skinned_dense_scene(cuda):
    """K1 against its plain version at the textured G-buffer inputs of the
    skinned showroom (two figures of 12,288 triangles, six spheres of
    2,208) at 512 x 256: depth, ids and every channel bit for bit."""
    import chip_smoke as cs
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.attribs import (CameraAttribs,
                                              PBRLightAttribs,
                                              PBRRendererShaderParameters)
    from diligentfx_tpu_torch.pbr.deferred import fused_raster_inputs
    from diligentfx_tpu_torch.pbr.renderer import RenderInfo
    rs, _ = _showroom(cuda, n_figures=2, sphere=(24, 48))
    w, h = 512, 256
    eye = [0.0, 2.5, 14.0]
    info = RenderInfo(
        camera=CameraAttribs.create(
            m3.look_at(eye, [0.0, 1.0, 0.0], device=cuda),
            m3.perspective(0.8, w / h, 0.1, 50.0, device=cuda), eye, 0.1,
            50.0, w, h, device=cuda),
        lights=PBRLightAttribs.directional(cs.FULL_CHAIN_SUN, [4, 4, 4],
                                           device=cuda),
        renderer_params=PBRRendererShaderParameters.create(device=cuda))
    # up to 3,056 candidates in one 8 x 128 sub-bin
    cfg = RasterizerConfig(tile_h=32, tile_w=128, bin_capacity=16384,
                           max_tiles_per_tri=16, big_tri_capacity=256,
                           chunk=8, pair_compaction_cap=1 << 18, sub_bins=4,
                           big_tile_capacity=64)
    k = fused_raster_inputs(rs.scene, info, pad_w=w, pad_h=h, cfg=cfg,
                            use_textures=True)
    assert int(k.stats.bin_overflow) == int(k.stats.big_overflow) == 0
    args = (k.setup, k.planes, k.candidates, k.counts, k.mat_table, k.rects)
    z, tid, out = trk.raster_tiles_fused(*args, **k.kernel_kw)
    torch.cuda.synchronize()
    zp, tidp, outp = trk.raster_tiles_fused_plain(*args, **k.kernel_kw)
    assert torch.equal(tid, tidp)
    hit = tid >= 0
    assert 0.02 < float(hit.float().mean()) < 0.9
    assert torch.equal(z[hit], zp[hit])
    assert torch.equal(out[:, hit], outp[:, hit])


def test_small_editor_frame_matches_cpu_path(cuda):
    """chip_smoke.py's 256 x 128 editor frames (phase 25: the showroom
    without the atrium, the five editor switches, the IRIDESCENCE view,
    the first frame on the fused K1 route, the second on the two-pass K4
    route) on the card against the CPU path: above 50 dB, K1 1 and K4 9
    launches."""
    import chip_smoke as cs
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu, launches = cs.small_editor_frames(cuda)
    assert np.isfinite(gpu).all()
    assert psnr(cpu, gpu) > 50.0
    assert launches["raster_tiles_fused"] == 1
    assert launches["raster_tiles"] == 9


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_debug_payload_matches_cpu(cuda, fuse):
    """render_gbuffer(emit_debug=True) of the skinned showroom (every
    extension, the normal map, the clear coat) on the card, on the fused
    K1 route and the two-pass K4 route, against the CPU: the same hit
    pixels and each of the 21 payload entries within 1e-4 + 1e-4 relative
    on all but 0.1% of its values (the card's transcendentals; the clear
    coat's alpha-0.01 highlight)."""
    import chip_smoke as cs
    from diligentfx_tpu_torch import math3d as m3
    from diligentfx_tpu_torch.attribs import (CameraAttribs,
                                              PBRLightAttribs,
                                              PBRRendererShaderParameters)
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.deferred import render_gbuffer
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer, RenderInfo
    w, h = 256, 128
    cfg = cs.ext_skin_raster_config()
    ci = PBRRendererCreateInfo(brdf_lut_dim=16, num_brdf_samples=8,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=16,
                               num_specular_env_samples=8)
    ref = PBRRenderer(ci, raster_cfg=cfg, device="cpu")
    gbs = []
    for d in ("cpu", cuda):
        rs, _ = _showroom(d, n_figures=2, sphere=(12, 24), tube=(8, 2))
        eye = [0.0, 1.5, 7.0]
        info = RenderInfo(
            camera=CameraAttribs.create(
                m3.look_at(eye, [0.0, 1.0, 0.0], device=d),
                m3.perspective(0.8, w / h, 0.1, 50.0, device=d), eye, 0.1,
                50.0, w, h, device=d),
            lights=PBRLightAttribs.directional(cs.FULL_CHAIN_SUN, [4, 4, 4],
                                               device=d),
            renderer_params=PBRRendererShaderParameters.create(device=d))
        gbs.append(render_gbuffer(
            rs.scene, info, ref.ibl_maps.to(d), ref.env_oct.to(d), width=w,
            height=h, cfg=cfg, atlas=rs.atlas, use_textures=True,
            enable_clearcoat=True, emit_debug=True, fuse=fuse))
    cpu, gpu = gbs
    hit = cpu.hit
    assert torch.equal(gpu.hit.cpu(), hit) and 0.05 < float(
        hit.float().mean()) < 0.9
    assert sorted(gpu.debug) == sorted(cpu.debug) and len(cpu.debug) == 21
    for key, want in cpu.debug.items():
        got = gpu.debug[key].cpu()[hit]
        want = want[hit]
        assert bool(torch.isfinite(got).all()), key
        bad = (got - want).abs() > 1e-4 + 1e-4 * want.abs()
        assert float(bad.float().mean()) <= 1e-3, (key, float(
            (got - want).abs().max()))


@pytest.mark.parametrize("seed,sigma", [(0, 0.02), (1, 0.3), (2, 1.5)])
def test_vector_field_matches_sequential_on_card(cuda, seed, sigma):
    """components/renderers.py render_vector_field on CUDA tensors against
    render_vector_field_plain on the same tensors: bit for bit (the same
    elementwise kernels on the same values), at 1080 x 1920 with segments
    that overlap and leave the frame."""
    from diligentfx_tpu_torch.components import renderers as cr
    g = np.random.default_rng(seed)
    field = torch.from_numpy(g.normal(0, sigma, (1080, 1920, 2)).astype(
        np.float32))
    color = torch.from_numpy(g.random((1080, 1920, 3)).astype(np.float32))
    got = cr.render_vector_field(color.to(cuda), field.to(cuda))
    plain = cr.render_vector_field_plain(color.to(cuda), field.to(cuda))
    assert torch.equal(got, plain)
    assert bool((got != color.to(cuda)).any())


def test_small_hydra_frame_matches_cpu_path(cuda):
    """chip_smoke.py's 256 x 128 Hydra stage (phase 27: the atrium and the
    Kitchen props through the pxr adapter and the render delegate) on the
    card against the CPU path: above 50 dB, K1 1, K2 20, K3 1 and K4 0
    launches a frame."""
    import chip_smoke as cs
    from diligentfx_tpu_torch.utils.image import psnr
    cpu, gpu, launches = cs.small_hydra_frames(cuda)
    assert np.isfinite(gpu).all() and gpu.min() >= 0.0 and gpu.max() <= 1.0
    assert psnr(cpu, gpu) > 50.0
    assert launches == {k: 2 * v for k, v in cs.FRAME_LAUNCHES.items()}


def test_hydra_edges_frame_matches_cpu(cuda):
    """The delegate's EDGES frame of the Hydra stage at 256 x 128 on the
    card (K4, once) against the CPU path (K4's plain version): at most
    0.1% of the pixels differ (knife edges of the barycentric test)."""
    import chip_smoke as cs
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.render_delegate import HnGeometryMode
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ci = PBRRendererCreateInfo(brdf_lut_dim=16, num_brdf_samples=8,
                               irradiance_cube_dim=16,
                               prefiltered_env_map_dim=16,
                               num_specular_env_samples=8)
    cfg = cs.hydra_raster_config(small=True)
    stage = cs.hydra_stage(tex_size=16)
    colors = []
    for dev in ("cpu", cuda):
        ren = PBRRenderer(ci, raster_cfg=cfg, device=dev)
        rd, _, task, _ = cs.hydra_delegate(stage, ren, dev, 256, 128)
        rd.inner.render_param.geometry_mode = HnGeometryMode.EDGES
        trt.raster_tiles.launches = 0
        colors.append(task.Execute().color.cpu().numpy())
        assert trt.raster_tiles.launches == (1 if dev == cuda else 0)
    diff = np.abs(colors[0] - colors[1]).max(-1) > 0
    assert diff.mean() <= 1e-3, diff.sum()
    assert (colors[1] != colors[1][0, 0]).any()


def test_hydra_entry_points_default_to_the_card(cuda):
    """The delegate, its pool and registry, and the renderer it builds run
    on the card unless the caller asks for the CPU."""
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.hydrogent.geometry_pool import HnGeometryPool
    from diligentfx_tpu_torch.hydrogent.render_delegate import \
        HnRenderDelegate
    from diligentfx_tpu_torch.hydrogent.texture_registry import \
        HnTextureRegistry
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    d = HnRenderDelegate()
    assert d.device.type == "cuda"
    assert d.geometry_pool.device.type == "cuda"
    assert d.texture_registry.device.type == "cuda"
    m = d.create_rprim("mesh", "/tri")
    m.set_points([[-1, -1, 0], [1, -1, 0], [0, 1, 0]])
    m.set_triangles([[0, 1, 2]])
    d.create_sprim("camera", "/cam").set_params(eye=(0, 0, 4),
                                                target=(0, 0, 0))
    out = d.execute(128, 128)
    assert out.color.is_cuda and d._scene.positions.is_cuda
    assert d._renderer.device.type == "cuda"
    assert d.read_rprim_id(64, 64) == 0
    assert HnRenderDelegate(device="cpu").device.type == "cpu"
    assert HnGeometryPool().device.type == "cuda"
    assert HnTextureRegistry().device.type == "cuda"
    small = PBRRendererCreateInfo(brdf_lut_dim=16, num_brdf_samples=8,
                                  irradiance_cube_dim=16,
                                  prefiltered_env_map_dim=16,
                                  num_specular_env_samples=8)
    with pytest.raises(ValueError, match="renderer is on"):
        HnRenderDelegate(renderer=PBRRenderer(small, device="cpu"))
