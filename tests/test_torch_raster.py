"""Parity of the port's rasterizer (diligentfx_tpu_torch.ops.raster, the
fused kernel's ops/raster_kernel.py and the two-pass kernel's
ops/raster_tiles.py) with the JAX package on the CPU.

The JAX side runs its Pallas kernel in interpret mode (as
tests/test_raster_fused.py does) and its triangle setup and binning eagerly,
op by op: under jit, XLA on the CPU contracts a*x + b*y + c into an FMA,
which moves plane coefficients by an ulp and can flip coverage on exact
edges.  Eager JAX rounds every operation like the port, so the tolerances
below are tight:
  * setup rows, validity, bboxes, original ids, candidates and counts:
    exact;
  * attribute planes: 1e-5 (the JAX package evaluates the corner values
    with an einsum, the port with explicit multiply-adds);
  * tri id exact on every pixel (bin_overflow is 0 on these scenes), depth
    within 1e-6, channels on hit pixels within 1e-5 * max(1, |value|);
  * the two-pass path (rasterize, interpolate_all): ids exact, depth and
    barycentrics within 1e-6 against the JAX steps run op by op; K4's
    plain version against the interpreted Pallas kernel, whose XLA
    compilation contracts the barycentric planes into FMAs: within an ulp
    of the plane's largest term (see test_raster_tiles_plain_vs_pallas).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import CameraAttribs
from diligentfx_tpu.config import RasterizerConfig as JCfg
from diligentfx_tpu.ops import raster as jr
from diligentfx_tpu.ops import raster_pallas as jrp
from diligentfx_tpu.pbr.deferred import _material_table, _vertex_inputs
from diligentfx_tpu.pbr.renderer import RenderInfo
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.ops import raster as tr
from diligentfx_tpu_torch.ops import raster_kernel as trk
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 256, 128
# the JAX package's test config (tests/test_raster_fused.py:25: 8x128
# tiles, unsegmented, chunk 8; capacities raised so this scene does not
# overflow) and the exact bench raster config (bench.py:138-141: 32x128
# tiles, 4 sub-bins)
CONFIGS = {
    "test_8x128": dict(tile_h=8, tile_w=128, bin_capacity=256,
                       max_tiles_per_tri=8, big_tri_capacity=64, chunk=8),
    "bench_32x128_sub4": dict(tile_h=32, tile_w=128, bin_capacity=1024,
                              max_tiles_per_tri=8, big_tri_capacity=64,
                              chunk=8, pair_compaction_cap=1 << 17,
                              sub_bins=4, big_tile_capacity=16),
}


def _t(x):
    return torch.as_tensor(np.array(x))


def _interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def inputs():
    """The bench.py --smoke scene (4 spheres + ground plane, which crosses
    the near plane) seen by the bench camera at 256x128."""
    scene = bench.build_bench_scene(2, 2, 12)
    eye = [0.0, 1.0, 7.5]
    cam = CameraAttribs.create(jm3.look_at(eye, [0.0, 0.0, 0.0]),
                               jm3.perspective(0.7, W / H, 0.1, 100.0), eye,
                               0.1, 100.0, W, H)
    info = RenderInfo(camera=cam, lights=None, renderer_params=None)
    clip, winv, packed, n_ch = _vertex_inputs(scene, info, False,
                                              include_pos=False)
    tri_node = scene.vertex_node[scene.indices[:, 0]]
    consts = jnp.stack([scene.tri_material.astype(jnp.float32),
                        tri_node.astype(jnp.float32)], -1)
    mt = _material_table(scene.materials).T
    return dict(clip=clip, idx=scene.indices, packed=packed, winv=winv,
                consts=consts, mt=mt, ds=scene.tri_double_sided, n_ch=n_ch)


@pytest.fixture(scope="module")
def jax_setup(inputs):
    with jax.disable_jit():
        return jr._triangle_setup(
            inputs["clip"], inputs["idx"], W, H, inputs["ds"], True, 1e-3,
            attrs=inputs["packed"], winv_vert=inputs["winv"],
            tri_consts=inputs["consts"])


def _port_args(inputs):
    return (_t(inputs["clip"]), _t(inputs["idx"]), _t(inputs["packed"]),
            _t(inputs["winv"]), _t(inputs["consts"]), _t(inputs["mt"]))


def test_clip_to_screen_and_pad_viewport(inputs):
    a = jr.clip_to_screen(inputs["clip"], W, H)
    b = tr.clip_to_screen(_t(inputs["clip"]), W, H)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for name, kw in CONFIGS.items():
        for wh in ((1920, 1080), (250, 100), (128, 8)):
            assert tr.pad_viewport(*wh, cv.raster_config_from_jax(JCfg(**kw))) \
                == jr.pad_viewport(*wh, JCfg(**kw)), (name, wh)


def test_near_clip_exact(inputs):
    """Near-plane clipping with the compacted second-sub-triangle region:
    the ground plane crosses the near plane, so both one- and two-inside
    cases and the overflow scatter run."""
    corner = inputs["clip"][inputs["idx"]]
    with jax.disable_jit():
        a = jr._clip_near_plane(inputs["clip"], inputs["idx"], 1e-3,
                                corner_clip=corner)
    b = tr._clip_near_plane(_t(corner), 1e-3)
    assert np.asarray(a[2])[corner.shape[0]:].any()   # second sub-triangles
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_triangle_setup_exact(inputs, jax_setup):
    setup, valid, bbox, orig, planes, clip_ovf = tr._triangle_setup(
        _t(inputs["clip"]), _t(inputs["idx"]), W, H, _t(inputs["ds"]), True,
        1e-3, _t(inputs["packed"]), _t(inputs["winv"]), _t(inputs["consts"]))
    js, jv, jb, jo, jp, jc = (np.asarray(x) for x in jax_setup)
    np.testing.assert_array_equal(setup.numpy(), js)
    np.testing.assert_array_equal(valid.numpy(), jv)
    np.testing.assert_array_equal(bbox.numpy(), jb)
    np.testing.assert_array_equal(orig.numpy(), jo)
    assert int(clip_ovf) == int(jc) == 0
    np.testing.assert_allclose(planes.numpy(), jp, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_binning_exact(inputs, jax_setup, name):
    """_bin_triangles / _bin_triangles_sub: candidate lists (stable
    submission order within a bin), per-segment counts and overflow
    stats."""
    jcfg = JCfg(**CONFIGS[name])
    tcfg = cv.raster_config_from_jax(jcfg)
    valid, bbox = jax_setup[1], jax_setup[2]
    # integer and floor arithmetic only: jit rounds it like eager
    fn = jr._bin_triangles_sub if jcfg.sub_bins > 1 else jr._bin_triangles
    ja = jax.jit(fn, static_argnums=(2, 3, 4))(valid, bbox, W, H, jcfg)
    if jcfg.sub_bins <= 1:
        ja = ja[1:]
    if jcfg.sub_bins > 1:
        ta = tr._bin_triangles_sub(_t(valid), _t(bbox), W, H, tcfg)
    else:
        ta = tr._bin_triangles(_t(valid), _t(bbox), W, H, tcfg)
    for x, y in zip(ja, ta):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert int(ta[3]) == 0 and int(ta[4]) == 0      # no bin/big overflow


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rasterize_fused_matches_jax(inputs, name, monkeypatch):
    """Port rasterize_fused (plain kernel on the CPU) vs JAX rasterize_fused
    (eager setup + binning, Pallas kernel interpreted)."""
    jcfg = JCfg(**CONFIGS[name])
    _interpret(monkeypatch)
    vb, out, st = jr.rasterize_fused.__wrapped__(
        inputs["clip"], inputs["idx"], inputs["packed"], inputs["winv"],
        inputs["consts"], inputs["mt"], width=W, height=H, cfg=jcfg,
        n_ch=inputs["n_ch"], double_sided=inputs["ds"])
    tvb, tout, tst = tr.rasterize_fused(
        *_port_args(inputs), width=W, height=H,
        cfg=cv.raster_config_from_jax(jcfg), n_ch=inputs["n_ch"],
        double_sided=_t(inputs["ds"]))
    assert [int(x) for x in st] == [int(x) for x in tst]
    assert int(tst.bin_overflow) == 0
    ja, ta = np.asarray(vb.tri_id), tvb.tri_id.numpy()
    np.testing.assert_array_equal(ta, ja)
    hit = ja >= 0
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(tvb.depth.numpy()[hit], np.asarray(vb.depth)[hit],
                               rtol=0, atol=1e-6)
    assert np.isinf(tvb.depth.numpy()[~hit]).all()
    jo, to = np.asarray(out), tout.numpy()
    assert to.shape == jo.shape == (6 + 2 + 20, H, W)
    np.testing.assert_allclose(to[:, hit], jo[:, hit], rtol=1e-5, atol=1e-5)


def _synthetic(n=150, seed=3):
    """Random triangles, a few straddling the near plane and a few huge
    ones (the big-triangle lists)."""
    rng = np.random.default_rng(seed)
    v = n * 3
    pos = rng.uniform(-2, 2, (v, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(-4, -1.5, v)
    pos[:6, 2] = rng.uniform(-1, 1, 6)
    idx = np.arange(v, dtype=np.int32).reshape(n, 3)
    attrs = rng.standard_normal((v, 5)).astype(np.float32)
    proj = np.asarray(jm3.perspective(0.8, 1.0, 0.1, 50.0))
    clip = np.concatenate([pos, np.ones((v, 1), np.float32)], -1) @ proj
    clip[:9, :2] *= 12
    clip = clip.astype(np.float32)
    winv = np.where(np.abs(clip[:, 3]) > 1e-12, 1 / clip[:, 3], 0)
    consts = np.stack([rng.integers(0, 4, n), rng.integers(0, 7, n)],
                      -1).astype(np.float32)
    mt = rng.standard_normal((16, 4)).astype(np.float32)
    return clip, idx, attrs, winv.astype(np.float32), consts, mt


def test_fused_kernel_plain_vs_pallas_options(monkeypatch):
    """The kernel's options the main path does not use: derivative
    channels, reversed depth (depth_less=False), a viewport offset and an
    unsegmented candidate list — port plain version vs the Pallas kernel
    interpreted, on identical inputs."""
    clip, idx, attrs, winv, consts, mt = _synthetic()
    n = idx.shape[0]
    ds = np.ones(n, bool)
    jcfg = JCfg(tile_h=8, tile_w=128, bin_capacity=64, max_tiles_per_tri=8,
                big_tri_capacity=64, chunk=8)
    ws, hs, off = 256, 64, (0, 32)

    @jax.jit
    def setup_and_bins(clip, attrs, winv, consts):
        # both kernels get these same arrays, so jit rounding is harmless
        setup, valid, bbox, orig, planes, _ = jr._triangle_setup(
            clip, idx, ws, hs, ds, True, 1e-3, screen_size=(ws, 2 * hs),
            screen_offset=off, attrs=attrs, winv_vert=winv,
            tri_consts=consts)
        planes = jnp.concatenate([planes, orig[:, None].astype(jnp.float32)],
                                 -1)
        _, cand, counts, *_ = jr._bin_triangles(valid, bbox, ws, hs, jcfg)
        return setup, planes, cand, counts

    setup, planes, cand, counts = setup_and_bins(clip, attrs, winv, consts)
    kw = dict(th=8, tw=128, tiles_x=2, n_ch=5, n_const=3,
              deriv_channels=(1, 3), depth_less=False, chunk=8,
              screen_offset=off)
    _interpret(monkeypatch)
    jz, jid, jout = jrp.raster_tiles_fused_pallas(setup, planes, cand, counts,
                                                  mt.T, **kw)
    rects = tr.candidate_rects(_t(setup), ws, hs, off)
    tz, tid, tout = trk.raster_tiles_fused(_t(setup), _t(planes), _t(cand),
                                           _t(counts), _t(mt.T), rects, **kw)
    ja = np.asarray(jid)
    np.testing.assert_array_equal(tid.numpy(), ja)
    hit = ja >= 0
    assert hit.mean() > 0.1
    np.testing.assert_allclose(tz.numpy()[hit], np.asarray(jz)[hit], atol=1e-6)
    assert tout.shape == jout.shape == (5 + 4 + 2 + 4, hs, ws)
    np.testing.assert_allclose(tout.numpy()[:, hit], np.asarray(jout)[:, hit],
                               rtol=1e-5, atol=1e-5)
    assert trk.raster_tiles_fused.launches == 0    # the CPU runs no kernel


def test_fused_kernel_wrapper_checks():
    """The wrapper rejects inputs the kernel does not take."""
    setup = torch.zeros((4, 16))
    planes = torch.zeros((4, 3 * 3 + 1))
    cand = torch.zeros((2, 8), dtype=torch.int32)
    counts = torch.zeros((2,), dtype=torch.int32)
    rects = tr.candidate_rects(setup, 256, 8)
    with pytest.raises(ValueError):
        trk.raster_tiles_fused(setup.to("meta"), planes, cand, counts, None,
                               rects, th=8, tw=128, tiles_x=2, n_ch=2,
                               n_const=1)
    z, tid, out = trk.raster_tiles_fused(setup, planes, cand, counts, None,
                                         rects, th=8, tw=128, tiles_x=2,
                                         n_ch=2, n_const=1)
    assert z.shape == (8, 256) and bool(torch.isinf(z).all())
    assert bool((tid == -1).all()) and out.shape == (2, 8, 256)


# ---------------------------------------------------------------------------
# the two-pass path: rasterize -> K4 (raster_tiles) -> interpolate_all
# ---------------------------------------------------------------------------

TWO_PASS_CFG = JCfg(tile_h=8, tile_w=128, bin_capacity=256,
                    max_tiles_per_tri=8, big_tri_capacity=64, chunk=8)


def _jax_two_pass(clip, idx, ds, w, h, cfg, depth_less=True):
    """JAX rasterize(backend="xla") step by step: setup op by op, the
    integer binning jitted (exact), the XLA tile scan op by op with 64
    candidates a step (the winner does not depend on the grouping).  Under
    jit, XLA would contract the plane evaluations into FMAs."""
    import dataclasses
    with jax.disable_jit():
        setup, valid, bbox, _, clip_ovf = jr._triangle_setup(
            clip, idx, w, h, ds, True, 1e-3)
    cand, _, _, max_count, ovf, big_ovf = jax.jit(
        jr._bin_triangles, static_argnums=(2, 3, 4))(valid, bbox, w, h, cfg)
    with jax.disable_jit():
        z, tid, b0, b1 = jr._raster_tiles(
            setup, cand, w, h, dataclasses.replace(cfg, chunk=64),
            float("inf") if depth_less else float("-inf"), depth_less)
    stats = [int(max_count), int(ovf + clip_ovf), int(big_ovf),
             int((~valid).sum())]
    return (np.asarray(z), np.asarray(tid),
            np.stack([np.asarray(b0), np.asarray(b1)], -1), stats)


def _two_pass_case(inputs, case):
    """The bench --smoke scene (near-clipped); for "big_triangles" the
    corners of its first 40 triangles spread 8x in x and y, both faces
    drawn, so that many triangles cover more than max_tiles_per_tri tiles
    and go through the big-triangle list (same shapes, so the op-by-op JAX
    steps compile once for both cases)."""
    clip = np.array(inputs["clip"])
    idx = np.asarray(inputs["idx"])
    ds = np.asarray(inputs["ds"])
    if case == "big_triangles":
        clip[np.unique(idx[:40]), :2] *= 8.0
        ds = np.ones_like(ds)
    return clip, idx, ds, W, H


@pytest.mark.parametrize("case", ["sphere", "big_triangles"])
def test_rasterize_two_pass_matches_jax(inputs, case):
    """The port's rasterize (K4's plain version on the CPU) against the JAX
    package's two-pass path: ids exact, depth and barycentrics within
    1e-6 (measured: equal), stats equal."""
    from diligentfx_tpu_torch.ops.raster_tiles import raster_tiles
    clip, idx, ds, w, h = _two_pass_case(inputs, case)
    jz, jid, jb, jst = _jax_two_pass(jnp.asarray(clip), jnp.asarray(idx),
                                     jnp.asarray(ds), w, h, TWO_PASS_CFG)
    if case == "big_triangles":
        assert jst[1] == 0          # no pair dropped
        setup, valid, bbox, *_ = tr._triangle_setup(
            _t(clip), _t(idx), w, h, _t(ds), True, 1e-3)
        span = ((bbox[:, 2] - bbox[:, 0]) // 128 + 1) * (
            (bbox[:, 3] - bbox[:, 1]) // 8 + 1)
        assert int((valid & (span > 8)).sum()) >= 10   # big triangles
    vb, st = tr.rasterize(_t(clip), _t(idx), width=w, height=h,
                          cfg=cv.raster_config_from_jax(TWO_PASS_CFG),
                          double_sided=_t(ds))
    assert raster_tiles.launches == 0
    assert [int(x) for x in st] == jst
    np.testing.assert_array_equal(vb.tri_id.numpy(), jid)
    hit = jid >= 0
    assert hit.mean() > 0.1
    np.testing.assert_allclose(vb.depth.numpy()[hit], jz[hit], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(vb.bary.numpy()[hit], jb[hit], rtol=0,
                               atol=1e-6)
    assert np.isinf(vb.depth.numpy()[~hit]).all()
    assert (vb.bary.numpy()[~hit] == 0).all()


def test_interpolate_matches_jax(inputs):
    """interpolate_all, perspective_bary and interpolate on the two-pass
    visibility of the --smoke scene, against the JAX functions run op by
    op on the same visibility buffer: within 1e-6 (the three-corner sums
    may be taken in another order)."""
    clip, idx, ds = (np.asarray(inputs[k]) for k in ("clip", "idx", "ds"))
    vb, _ = tr.rasterize(_t(clip), _t(idx), width=W, height=H,
                         cfg=cv.raster_config_from_jax(TWO_PASS_CFG),
                         double_sided=_t(ds))
    jvb = jr.VisibilityBuffer(depth=jnp.asarray(vb.depth.numpy()),
                              tri_id=jnp.asarray(vb.tri_id.numpy()),
                              bary=jnp.asarray(vb.bary.numpy()))
    packed, winv = inputs["packed"], inputs["winv"]
    with jax.disable_jit():
        ja = jr.interpolate_all(jvb, inputs["idx"], packed, winv)
        jpb = jr.perspective_bary(jvb, inputs["idx"], winv)
        ji = jr.interpolate(jvb, inputs["idx"], packed[:, :3], jpb,
                            background=0.5)
    ta = tr.interpolate_all(vb, _t(idx), _t(packed), _t(winv))
    tpb = tr.perspective_bary(vb, _t(idx), _t(winv))
    ti = tr.interpolate(vb, _t(idx), _t(packed)[:, :3], tpb, background=0.5)
    assert ta.shape == (H, W, inputs["n_ch"])
    for x, y in ((ja, ta), (jpb, tpb), (ji, ti)):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("depth_less", [True, False])
def test_raster_tiles_plain_vs_pallas(monkeypatch, depth_less):
    """raster_tiles_plain against the interpreted raster_tiles_pallas (K4's
    TPU kernel) on identical inputs: random and huge triangles, a viewport
    offset, standard and reversed depth."""
    from diligentfx_tpu_torch.ops.raster_tiles import raster_tiles
    clip, idx, *_ = _synthetic(seed=5)
    ds = np.ones(idx.shape[0], bool)
    ws, hs, off = 256, 64, (0, 32)

    @jax.jit
    def setup_and_bins(clip):
        setup, valid, bbox, _, _ = jr._triangle_setup(
            clip, idx, ws, hs, ds, True, 1e-3, screen_size=(ws, 2 * hs),
            screen_offset=off)
        _, cand, counts, *_ = jr._bin_triangles(valid, bbox, ws, hs,
                                                TWO_PASS_CFG)
        return setup, cand, counts

    setup, cand, counts = setup_and_bins(clip)
    kw = dict(th=8, tw=128, tiles_x=2, depth_less=depth_less,
              screen_offset=off)
    _interpret(monkeypatch)
    ja = [np.asarray(x) for x in jrp.raster_tiles_pallas(setup, cand, counts,
                                                         **kw)]
    rects = tr.candidate_rects(_t(setup), ws, hs, off)
    ta = [x.numpy() for x in raster_tiles(_t(setup), _t(cand), _t(counts),
                                          rects, **kw)]
    np.testing.assert_array_equal(ta[1], ja[1])
    hit = ja[1] >= 0
    assert hit.mean() > 0.1
    np.testing.assert_allclose(ta[0][hit], ja[0][hit], rtol=0, atol=1e-6)
    # barycentrics: XLA compiles the interpreted kernel and contracts the
    # plane evaluation a*px + b*py + c into FMAs, which the port does not;
    # the two differ by at most an ulp of the plane's largest term (large
    # on the huge triangles, where the terms cancel)
    _, win = trk.raster_tiles_winners_plain(
        _t(setup), _t(cand), _t(counts), th=8, tw=128, tiles_x=2,
        depth_less=depth_less, screen_offset=off)
    px, py = trk._pixel_centres(cand.shape[0], 8, 128, 2, off, "cpu")
    rows = np.asarray(setup)[win.numpy()]
    pxy = np.broadcast_to(px.numpy(), win.shape), np.broadcast_to(
        py.numpy(), win.shape)
    for k, c0 in ((2, 9), (3, 12)):
        term = np.maximum.reduce([np.abs(rows[..., c0] * pxy[0]),
                                  np.abs(rows[..., c0 + 1] * pxy[1]),
                                  np.abs(rows[..., c0 + 2])])
        bound = 1e-6 + 2.0 * term * 2.0 ** -23
        err = np.abs(ta[k] - ja[k])
        assert (err[hit] <= bound[hit]).all(), float((err / bound)[hit].max())
        assert (err[hit] <= 1e-6).mean() > 0.99
    clear = np.inf if depth_less else -np.inf
    assert (ta[0][~hit] == clear).all() and (ta[2][~hit] == 0).all()


def test_raster_tiles_wrapper_checks():
    """Empty tiles keep the clear values; a device the port has no kernel
    for raises."""
    from diligentfx_tpu_torch.ops.raster_tiles import raster_tiles
    setup = torch.zeros((4, 16))
    cand = torch.full((2, 8), -1, dtype=torch.int32)
    counts = torch.zeros((2,), dtype=torch.int32)
    rects = tr.candidate_rects(setup, 256, 8)
    for depth_less, clear in ((True, np.inf), (False, -np.inf)):
        z, tid, b0, b1 = raster_tiles(setup, cand, counts, rects, th=8,
                                      tw=128, tiles_x=2,
                                      depth_less=depth_less)
        assert z.shape == tid.shape == b0.shape == (2, 8, 128)
        assert bool((z == clear).all()) and bool((tid == -1).all())
        assert bool((b0 == 0).all()) and bool((b1 == 0).all())
    with pytest.raises(ValueError):
        raster_tiles(setup.to("meta"), cand, counts, rects, th=8, tw=128,
                     tiles_x=2)
