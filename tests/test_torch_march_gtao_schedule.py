"""The schedules of K3 (SSR march) and K5 (fused GTAO) on the CPU: what
each CUDA kernel reads is worked out in Python, and these tests hold it to
the plain versions' own arithmetic.

* K3 walks, for each ray, only the rows `march_row_span` gives (the
  kernel's loop bounds); each 8 x 32 block counting-sorts its rays by that
  walk, and each lane marches one ray.  Every row in which `march_dda_plain` finds a crossing (its `has`) must
  lie inside the span, or the kernel would miss a hit.
* K5 reads each tap's four texels from the padded depth at window
  coordinates.  Every texel that the plain version's taps read
  (`gtao_taps`, the same coordinates as `gtao_fused_plain`) must lie inside
  its pixel's tile window, and the window inside the padded depth.
"""
import numpy as np
import pytest
import torch

from diligentfx_tpu_torch.ops import gtao as tg
from diligentfx_tpu_torch.ops import march as tm
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _march_rays(n, seed, rows):
    """(ov, dv) of n rays of each kind: random, flat (dv = 0 and |dv| <=
    1e-7), vertical and steep, origins off the screen, ends exactly at
    v = 0 and v = 1 (origins on a 1/64 grid, so ov + dv is exact), and ends
    and origins within a few ulps of a row boundary r / rows, where the
    rounding of r / rows and of the ray's t decides the edge rows."""
    g = np.random.default_rng(seed)
    k = g.integers(0, rows + 1, (2, n)) / rows
    ulps = g.integers(-4, 5, (2, n)) * np.spacing(k.astype(np.float32) + 1)
    near = (k + ulps).astype(np.float32)
    ov = [g.uniform(0.0, 1.0, n), g.uniform(0.0, 1.0, n),
          g.uniform(0.0, 1.0, n), g.uniform(0.0, 1.0, n),
          np.concatenate([g.uniform(-0.8, -1e-3, n // 2),
                          g.uniform(1.0 + 1e-3, 1.8, n - n // 2)]),
          g.integers(1, 64, n) / 64.0, g.integers(1, 64, n) / 64.0]
    dv = [g.uniform(-0.6, 0.6, n),
          np.where(g.random(n) < 0.5, 0.0, g.uniform(-1e-7, 1e-7, n)),
          g.choice([-1.0, 1.0], n) * g.uniform(0.9, 2.0, n),
          g.choice([-1.0, 1.0], n) * g.uniform(1e-7, 1e-4, n),
          g.uniform(-1.5, 1.5, n)]
    dv += [-ov[5], 1.0 - ov[6]]
    ov += [g.uniform(-0.2, 1.2, n).astype(np.float32), near[1]]
    dv += [near[0] - ov[-2], g.uniform(-0.5, 0.5, n)]
    return (torch.from_numpy(np.concatenate(ov).astype(np.float32)),
            torch.from_numpy(np.concatenate(dv).astype(np.float32)))


@pytest.mark.parametrize("rows", [67, 128, 600])
def test_march_row_span_holds_every_crossed_row(rows):
    n = 10000
    ov, dv = _march_rays(n, seed=rows, rows=rows)
    ends = ov[5 * n:7 * n] + dv[5 * n:7 * n]
    assert float(ends[:n].abs().max()) == 0.0 and float(ends[n:].min()) == 1.0
    r_begin, r_end = tm.march_row_span(ov, dv, rows)
    assert bool((r_begin >= 0).all()) and bool((r_end <= rows).all())
    inv_dv, flat, home = tm.march_ray_rows(ov, dv, rows)
    crossed = 0
    for r in range(rows):
        _, _, has = tm.march_row_interval(r, rows, ov, inv_dv, flat, home)
        outside = has & ((r < r_begin) | (r >= r_end))
        assert not bool(outside.any()), (r, torch.nonzero(outside)[:5])
        crossed += int(has.sum())
    walked = int((r_end - r_begin).clamp(min=0).sum())
    # the span adds at most its two widening rows to the crossed ones
    assert crossed <= walked <= crossed + 3 * ov.numel()
    assert bool((r_end - r_begin == 1)[flat].all())


def test_march_routes():
    """The table's pitch in shared memory, which the wrapper passes to
    csrc/march.cu's launcher: the frame's 67 x 120 table and a 128-row one
    at an odd pitch, 445 to 447 rows at pitch 128 (the sort and the row
    boundaries beside them), and from 448 rows on global memory (0)."""
    assert tm.march_table_pitch(67, 120) == 121
    assert tm.march_table_pitch(67, 119) == 119
    assert tm.march_table_pitch(128, 128) == 129
    assert tm.march_table_pitch(444, 128) == 129
    assert tm.march_table_pitch(445, 128) == 128
    assert tm.march_table_pitch(447, 128) == 128
    for rows in (448, 454, 455, 600, 100000):
        assert tm.march_table_pitch(rows, 128) == 0
    for rows, cols in ((1, 1), (67, 120), (300, 77), (447, 128)):
        pitch = tm.march_table_pitch(rows, cols)
        smem = tm.SORT_BYTES + 4 * (((rows + 4) & ~3) + rows * pitch)
        assert pitch >= cols and smem <= tm.SMEM_BYTES


def test_march_warp_walks_sort_each_block():
    """The kernel's warps where it sorts: each 8 x 32 block's rays in
    descending order of their (bucketed) walk, 32 a warp; no ray lost."""
    g = torch.Generator().manual_seed(1)
    walk = torch.randint(0, 90, (16, 64), generator=g)
    warps = tm.march_warp_walks(walk)
    assert warps.shape == (16 * 64 // 32, 32)
    assert int(warps.sum()) == int(walk.sum())
    key = warps.clamp(max=tm.SORT_BUCKETS - 1).reshape(-1, 256)
    assert bool((key[:, 1:] <= key[:, :-1]).all())
    blocks = walk.reshape(2, 8, 2, 32).permute(0, 2, 1, 3).reshape(4, 256)
    assert torch.equal(torch.sort(warps.reshape(4, 256), -1).values,
                       torch.sort(blocks, -1).values)


def _gtao_inputs(h, w, seed):
    """A random depth and scalars that put the tap radius at its clamp
    (a large world radius close to the camera): the taps reach the halo."""
    g = np.random.default_rng(seed)
    depth = torch.from_numpy(g.uniform(0.05, 0.4, (h, w)).astype(np.float32))
    sc = torch.tensor([5.0, 50.0, 0.385, 0.615, 0.8, 1.4, 0.1, 100.0])
    return depth, sc


@pytest.mark.parametrize("shape", [(540, 960), (64, 256), (100, 700)])
def test_gtao_taps_lie_inside_their_tile_window(shape):
    h, w = shape
    depth, sc = _gtao_inputs(h, w, seed=h + w)
    hp, wp = -(-h // tg.TILE_H) * tg.TILE_H, -(-w // tg.TILE_W) * tg.TILE_W
    halo_r, halo_c, win_h, win_w = tg.gtao_geometry(hp, wp)
    # each pixel's tile window, as csrc/gtao.cu rounds its origin down
    ty = torch.arange(hp)[:, None] // tg.TILE_H * tg.TILE_H
    tx = torch.arange(wp)[None, :] // tg.TILE_W * tg.TILE_W
    ry = (ty - halo_r).clamp(0, hp - win_h) // tg.TILE_H * tg.TILE_H
    rx = (tx - halo_c).clamp(0, wp - win_w) // tg.TILE_W * tg.TILE_W
    assert bool((ry + win_h <= hp).all()) and bool((rx + win_w <= wp).all())
    at_clamp = 0
    for t in tg.gtao_taps(depth, sc, num_slices=2, num_steps=4):
        assert t.r0.shape == (hp, wp)
        for r, c, live in ((t.r0, t.c0, None), (t.r0, t.c1, None),
                           (t.r1, t.c0, t.has1), (t.r1, t.c1, t.has1)):
            out = (r < ry) | (r >= ry + win_h) | (c < rx) | (c >= rx + win_w)
            if live is not None:
                out &= live
            assert not bool(out[:h, :w].any()), torch.nonzero(out)[:5]
        yy = torch.arange(h)[:, None]
        at_clamp += int(((t.r0[:h, :w] - yy).abs() >= halo_r - 2).sum())
    assert at_clamp > 0            # some taps reach the vertical clamp
