"""The tile rasters' culling inputs on the CPU: `candidate_rects` (each
candidate's conservative pixel rectangle, which K1 and K4 cull with) holds
every pixel the plain versions' coverage test finds covered; the tile-shape
check that both wrappers apply; K3's choice between its shared-memory and
global-memory table variants.

Conservativeness is exact: over the whole framebuffer, every (candidate,
pixel) pair that the coverage test of `raster_tiles_winners_plain` (the
same fp32 operations in the same order) finds covered lies inside the
candidate's rectangle, with no exception.
"""
import numpy as np
import pytest
import torch

from diligentfx_tpu_torch.ops import march as tm
from diligentfx_tpu_torch.ops import raster as tr
from diligentfx_tpu_torch.ops import raster_kernel as trk
from diligentfx_tpu_torch.ops import raster_tiles as trt
from tests.test_torch_raster import _synthetic
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _covered_outside(setup, valid, rects, w, h, off):
    """(pairs covered outside their rectangle, covered pairs) over the w x h
    framebuffer, the coverage test as raster_tiles_winners_plain runs it."""
    px = (torch.arange(w, dtype=torch.float32) + float(off[0])) + 0.5
    py = (torch.arange(h, dtype=torch.float32) + float(off[1])) + 0.5
    xs = torch.arange(w)[None, None, :]
    ys = torch.arange(h)[None, :, None]
    outside = covered = 0
    for rows in torch.nonzero(valid).flatten().split(128):
        s = setup[rows]

        def coef(j):
            return s[:, j, None, None]

        x, y = px[None, None, :], py[None, :, None]
        l0 = coef(0) * x + coef(1) * y + coef(2)
        l1 = coef(3) * x + coef(4) * y + coef(5)
        l2 = 1.0 - l0 - l1
        cover = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        r = rects[rows].long()[:, :, None, None]
        inside = ((xs >= r[:, 0]) & (xs <= r[:, 2])
                  & (ys >= r[:, 1]) & (ys <= r[:, 3]))
        outside += int((cover & ~inside).sum())
        covered += int(cover.sum())
    return outside, covered


def _area(r, w, h):
    """Framebuffer pixels inside the (n, 4) inclusive rectangles, summed."""
    r = r.long()
    cols = (r[:, 2].clamp(max=w - 1) - r[:, 0].clamp(min=0) + 1).clamp(min=0)
    rows = (r[:, 3].clamp(max=h - 1) - r[:, 1].clamp(min=0) + 1).clamp(min=0)
    return float((cols * rows).sum())


def _slivers(n, seed):
    """Triangles 0.05-3 NDC units long and 1e-7-1e-2 wide, at random depths
    and w: their fp32 planes meet far from their vertices."""
    g = np.random.default_rng(seed)
    a = g.uniform(-1.5, 1.5, (n, 2))
    d = g.standard_normal((n, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    length = g.uniform(0.05, 3.0, (n, 1))
    width = 10 ** g.uniform(-7, -2, (n, 1))
    normal = np.stack([-d[:, 1], d[:, 0]], 1)
    c = a + d * length * g.uniform(-0.5, 1.5, (n, 1)) + normal * width
    xy = np.stack([a, a + d * length, c], 1).reshape(-1, 2)
    v = xy.shape[0]
    clip = np.concatenate([xy, g.uniform(0.1, 0.9, (v, 1)), np.ones((v, 1))],
                          -1) * g.uniform(0.5, 3.0, (v, 1))
    return (torch.from_numpy(clip.astype(np.float32)),
            torch.from_numpy(np.arange(v, dtype=np.int32).reshape(n, 3)))


def _bench_scene_clip():
    """The bench.py --smoke scene (4 spheres and the ground plane, which
    crosses the near plane) at 256x128, the port's vertex stage."""
    import chip_smoke as cs
    from diligentfx_tpu_torch.pbr import deferred as td
    scene = cs.bench_scene(2, 2, 12, "cpu")
    info = cs.render_info(256, 128, "cpu")
    clip, _, _, _ = td._vertex_inputs(scene, info, False)
    return clip, scene.indices, scene.tri_double_sided


@pytest.mark.parametrize("case", ["synthetic_offset", "near_clipped",
                                  "slivers", "bench_256x128"])
def test_candidate_rects_conservative(case):
    """No covered (candidate, pixel) pair lies outside the candidate's
    rectangle: random and huge triangles under a viewport offset, triangles
    across the near plane, slivers, and the bench scene; each rectangle is
    inside [-1, width] x [-1, height]."""
    w, h, off, size, ds = 256, 128, (0, 0), None, None
    if case in ("synthetic_offset", "near_clipped"):
        clip, idx, *_ = _synthetic(seed=5 if case == "synthetic_offset"
                                   else 11)
        clip, idx = torch.from_numpy(clip), torch.from_numpy(idx)
        if case == "synthetic_offset":
            h, off, size = 64, (0, 32), (256, 128)
        else:                       # every triangle's first corner behind
            clip[0::3, 3] = -clip[0::3, 3].abs() - 0.5
    elif case == "slivers":
        clip, idx = _slivers(1500, 1)
    else:
        clip, idx, ds = _bench_scene_clip()
    if ds is None:
        ds = torch.ones(idx.shape[0], dtype=torch.bool)
    setup, valid, bbox, *_ = tr._triangle_setup(
        clip, idx, w, h, ds, True, 1e-3, screen_size=size, screen_offset=off)
    rects = tr.candidate_rects(setup, w, h, off)
    assert rects.dtype == torch.int32 and rects.shape == (setup.shape[0], 4)
    assert int(rects.min()) >= -1 and int(rects[:, 0::2].max()) <= w \
        and int(rects[:, 1::2].max()) <= h
    outside, covered = _covered_outside(setup, valid, rects, w, h, off)
    assert covered > 1000
    assert outside == 0
    # the rectangles cull about as tightly as the vertices' boxes widened
    # by the same pixel (measured 1.00002-1.025); slivers, whose fp32
    # planes reach past their vertices, 2.2
    box = torch.stack([torch.floor(bbox[:, 0] - 1.5),
                       torch.floor(bbox[:, 1] - 1.5),
                       torch.ceil(bbox[:, 2] + 0.5),
                       torch.ceil(bbox[:, 3] + 0.5)], -1)
    ratio = _area(rects[valid], w, h) / _area(box[valid], w, h)
    assert ratio < (3.0 if case == "slivers" else 1.05)


def test_candidate_rects_degenerate_rows():
    """Singular or non-finite planes get the whole framebuffer; a triangle
    off the framebuffer gets an empty rectangle."""
    setup = torch.zeros((3, 16))
    setup[1, :6] = torch.tensor([float("nan"), 1.0, 0.0, 0.0, 1.0, 0.0])
    # l0 = (x - 1000) / 10, l1 = (y - 10) / 10: the triangle (1000, 10),
    # (1010, 10), (1000, 20) is right of a 256-wide framebuffer
    setup[2, :6] = torch.tensor([0.1, 0.0, -100.0, 0.0, 0.1, -1.0])
    r = tr.candidate_rects(setup, 256, 64).tolist()
    assert r[0] == r[1] == [0, 0, 255, 63]
    assert r[2][0] > r[2][2] or r[2][0] >= 256


@pytest.mark.parametrize("shape", [(8, 128, 0), (24, 128, 0), (64, 128, 8),
                                   (16, 256, 0), (32, 128, 4), (40, 384, 5),
                                   (128, 512, 16)])
def test_tile_shape_check_accepts(shape):
    """K1 and K4 take every tile shape the JAX config takes (a multiple of
    8 rows by a multiple of 128 columns, sub-bins of multiples of 8 rows),
    with the bench's material table."""
    th, tw, sub = shape
    smem = trk.check_tile_shape(th, tw, sub, n_mrow=20, n_mat=46)
    assert smem <= trk.SMEM_BYTES
    assert trk.check_tile_shape(th, tw) <= trk.SMEM_BYTES


def test_tile_shape_check_refuses_only_beyond_shared_memory():
    """Among the JAX config's shapes the check refuses only a material
    table that overflows a block's shared memory, and says so; shapes the
    JAX config refuses are refused too."""
    for th in range(8, 257, 8):
        for tw in (128, 256, 512, 1024):
            for sub in [0] + [s for s in range(2, th + 1)
                              if th % s == 0 and (th // s) % 8 == 0]:
                trk.check_tile_shape(th, tw, sub, n_mrow=20, n_mat=46)
    with pytest.raises(ValueError, match="shared memory"):
        trk.check_tile_shape(32, 128, 4, n_mrow=20, n_mat=3000)
    for th, tw, sub in ((12, 128, 0), (8, 100, 0), (32, 128, 3)):
        with pytest.raises(ValueError):
            trk.check_tile_shape(th, tw, sub)


def test_plain_versions_ignore_rects():
    """The plain versions are the unculled oracle: any rectangles give the
    same outputs."""
    clip, idx, attrs, winv, consts, mt = (torch.from_numpy(a)
                                          for a in _synthetic(seed=3))
    cfg = tr.RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=64,
                              max_tiles_per_tri=8, big_tri_capacity=64,
                              chunk=8)
    k = tr.prepare_fused(clip, idx, attrs, winv, consts, mt.T.contiguous(),
                         width=256, height=64, cfg=cfg, n_ch=5,
                         double_sided=torch.ones(idx.shape[0],
                                                 dtype=torch.bool))
    empty = torch.full_like(k.rects, -1)
    args = (k.setup, k.planes, k.candidates, k.counts, k.mat_table)
    a = trk.raster_tiles_fused_plain(*args, k.rects, **k.kernel_kw)
    b = trk.raster_tiles_fused_plain(*args, empty, **k.kernel_kw)
    assert (a[1] >= 0).float().mean() > 0.1
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    kw = dict(th=8, tw=128, tiles_x=2)
    a = trt.raster_tiles_plain(k.setup, k.candidates, k.counts.reshape(-1),
                               k.rects, **kw)
    b = trt.raster_tiles_plain(k.setup, k.candidates, k.counts.reshape(-1),
                               empty, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_march_table_route():
    """K3 stages a table in shared memory beside its ray sort (1,280 bytes)
    and row boundaries, 232,448 bytes in all (447 rows of 128 columns: the
    1024x1024 frame's 128-row mip 2 fits), and reads a taller one, such as
    454 or 600 x 128, from global memory; the wrapper takes any height."""
    assert tm.march_table_pitch(67, 120) and tm.march_table_pitch(128, 128)
    assert tm.march_table_pitch(447, 128) and not tm.march_table_pitch(448,
                                                                       128)
    assert not tm.march_table_pitch(454, 128)
    assert not tm.march_table_pitch(600, 128)
    o = torch.zeros((8, 128, 3))
    assert tm._check_inputs(torch.zeros((600, 128)), o, o) == (600, 128, 8,
                                                               128)
