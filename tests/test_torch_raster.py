"""Parity of the port's fused rasterizer (diligentfx_tpu_torch.ops.raster and
ops/raster_kernel.py) with the JAX package on the CPU.

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
    within 1e-6, channels on hit pixels within 1e-5 * max(1, |value|).
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
    tz, tid, tout = trk.raster_tiles_fused(_t(setup), _t(planes), _t(cand),
                                           _t(counts), _t(mt.T), **kw)
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
    with pytest.raises(ValueError):
        trk.raster_tiles_fused(setup.to("meta"), planes, cand, counts, None,
                               th=8, tw=128, tiles_x=2, n_ch=2, n_const=1)
    z, tid, out = trk.raster_tiles_fused(setup, planes, cand, counts, None,
                                         th=8, tw=128, tiles_x=2, n_ch=2,
                                         n_const=1)
    assert z.shape == (8, 256) and bool(torch.isinf(z).all())
    assert bool((tid == -1).all()) and out.shape == (2, 8, 256)
