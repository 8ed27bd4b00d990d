"""The row-band forms of the post effects in the port (postfx/context.py,
ssao.py, taa.py with a BandCtx, row0 / full_h, max_tap_px) against the
JAX package's, and against the port's whole-frame results.

A 64 x 256 frame is cut into four bands of 16 rows with a halo of 8.
Both packages get the same band context: its `extend` returns the halo'd
rows of the whole image (the ring with wrap, the frame's edge rows
repeated without), which is what the bands' halo exchange delivers
(parallel/tiling.py; tests/test_torch_parallel.py holds that exchange).
The JAX side finds the whole image of each array it extends by value,
the port's side is the port's own registry of band lists
(tiling._Halos).  The JAX side runs eagerly, its Pallas warps
interpreted.

Tolerances: those of tests/test_torch_postfx.py and
tests/test_torch_ssao.py (GTAO_TOL with the port's ulp sensitivity)
against the JAX package.  Against the whole frame: bit-equal where the
band form computes the same values on the same rows (global-row noise,
positions, reprojection, the closest-motion dilation, the convolved depth
and the TAA moments on wrap halos, JAX tiling.py:210-224); the history
taps on halo rows land on the same texels through another rounding of
their coordinate, so those results are held within 1e-5 (and the
disocclusion within 0.5% of its pixels).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import CameraAttribs
from diligentfx_tpu.postfx import context as jctx
from diligentfx_tpu.postfx import ssao as jssao
from diligentfx_tpu.postfx import taa as jtaa
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.parallel.tiling import _Halos
from diligentfx_tpu_torch.postfx import context as tctx
from diligentfx_tpu_torch.postfx import ssao as tssao
from diligentfx_tpu_torch.postfx import taa as ttaa
from tests.test_torch_ssao import _scene, assert_gtao_close, ulp_sensitivity
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W = 64, 256
N, HALO = 4, 8
BH = H // N
FRAME = 3
SLICES, STEPS = 2, 4


def _t(x):
    return torch.as_tensor(np.array(x))


def _rows(b):
    return slice(b * BH, (b + 1) * BH)


def _split(x):
    return [_t(np.asarray(x)[_rows(b)]) for b in range(N)]


def _halo_rows(b, hl, wrap):
    rows = np.arange(b * BH - hl, (b + 1) * BH + hl)
    return rows % H if wrap else np.clip(rows, 0, H - 1)


def jax_band(b, fulls):
    """The JAX BandCtx of band b: `extend` finds the whole image among
    `fulls` whose band rows equal x, and returns its halo'd rows."""
    fulls = [np.asarray(f) for f in fulls]

    def extend(x, hl, wrap=False):
        xs = np.asarray(x)
        for f in fulls:
            if f.shape[1:] == xs.shape[1:] and np.array_equal(f[_rows(b)], xs):
                return jnp.asarray(f[_halo_rows(b, hl, wrap)])
        raise AssertionError("extend of an array that is no band of a "
                             "registered image")
    return jctx.BandCtx(extend=extend, y0=b * BH, full_h=H, halo=HALO)


def port_bands(*band_lists):
    """The port's band contexts over the registered band lists."""
    halos = _Halos()
    halos.add(*band_lists)
    return [halos.ctx(b, BH, H, HALO) for b in range(N)]


@pytest.fixture(scope="module")
def data():
    depth, normal, cam = _scene(H, W, seed=4)
    rng = np.random.default_rng(9)
    eye2 = [0.05, 1.03, 7.45]
    prev = CameraAttribs.create(jm3.look_at(eye2, [0.0, 0.0, 0.0]),
                                jm3.perspective(0.7, W / H, 0.1, 100.0),
                                eye2, 0.1, 100.0, W, H)
    return dict(
        depth=depth, normal=normal, cam=cam, tcam=cv.camera_from_jax(cam),
        prev_vp=np.asarray(prev.view_proj),
        prev_depth=(depth + rng.normal(0, 2e-4, (H, W))).astype(np.float32),
        motion=rng.normal(0, 0.01, (H, W, 2)).astype(np.float32),
        ao=rng.uniform(0.3, 1.0, (H, W)).astype(np.float32),
        ao_hist=rng.uniform(0.3, 1.0, (H, W)).astype(np.float32),
        cd_hist=(depth + rng.normal(0, 1e-3, (H, W))).astype(np.float32),
        color=(rng.random((H, W, 3)) * 3.0).astype(np.float32),
        hist=(rng.random((H, W, 3)) * 3.0).astype(np.float32),
        count=rng.integers(2, 20, (H, W)).astype(np.float32))


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("b", range(N))
def test_context_band_forms(data, b):
    """Noise, reconstructed and view-space positions, the reprojected
    depth and the closest-motion dilation of band b: the whole frame's
    rows, and the JAX package's band forms."""
    cam, tcam, y0 = data["cam"], data["tcam"], b * BH
    d, rows = data["depth"], _rows(b)
    db = d[rows]
    for f in (0, 7, 70):
        t = tctx.interleaved_gradient_noise(BH, W, f, row0=y0)
        assert torch.equal(t, tctx.interleaved_gradient_noise(H, W, f)[rows])
        np.testing.assert_allclose(
            t.numpy(), np.asarray(jctx.interleaved_gradient_noise(
                BH, W, f, row0=y0)), atol=2e-5)
    pos = tctx.reconstruct_world_pos(_t(db), tcam, row0=y0, full_h=H)
    assert torch.equal(pos, tctx.reconstruct_world_pos(_t(d), tcam)[rows])
    np.testing.assert_allclose(pos.numpy(), np.asarray(
        jctx.reconstruct_world_pos(jnp.asarray(db), cam, row0=y0, full_h=H)),
        rtol=1e-5, atol=1e-4)
    vp = tssao.view_space_position(_t(db), tcam, row0=y0, full_h=H)
    assert torch.equal(vp, tssao.view_space_position(_t(d), tcam)[rows])
    np.testing.assert_allclose(vp.numpy(), np.asarray(
        jssao.view_space_position(jnp.asarray(db), cam, row0=y0, full_h=H)),
        rtol=1e-5, atol=1e-5)
    rd = tctx.reprojected_depth(_t(db), tcam, _t(data["prev_vp"]), row0=y0,
                                full_h=H)
    assert torch.equal(rd, tctx.reprojected_depth(_t(d), tcam,
                                                  _t(data["prev_vp"]))[rows])
    # the JAX package's two matrix products sum their four terms in
    # another order: 2e-5 (one value of the 4,096 reached 1.06e-5)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jctx.reprojected_depth(
        jnp.asarray(db), cam, data["prev_vp"], row0=y0, full_h=H)),
        rtol=0, atol=2e-5)
    # closest motion on a one-row wrap halo (render_frame_banded's context)
    depth_b, motion_b = _split(d), _split(data["motion"])
    c = port_bands(depth_b, motion_b)[b]
    closest = tctx.dilate_closest_motion(
        c.extend(depth_b[b], 1, wrap=True),
        c.extend(motion_b[b], 1, wrap=True))[1:1 + BH]
    full = tctx.dilate_closest_motion(_t(d), _t(data["motion"]))
    assert torch.equal(closest, full[rows])


@pytest.mark.parametrize("b", range(N))
def test_disocclusion_band(data, b):
    """disocclusion_mask(band=): the previous depth tapped on edge-clamped
    halo rows, against the JAX band form and the whole frame."""
    args = (data["depth"], data["prev_depth"], data["motion"])
    prev_b = _split(data["prev_depth"])
    got = tctx.disocclusion_mask(
        *(_t(x[_rows(b)]) for x in args[:1]), prev_b[b],
        _t(data["motion"][_rows(b)]), data["tcam"], _t(data["prev_vp"]),
        band=port_bands(prev_b)[b]).numpy()
    want = np.asarray(jctx.disocclusion_mask(
        *(jnp.asarray(x[_rows(b)]) for x in args), data["cam"],
        data["prev_vp"], band=jax_band(b, [data["prev_depth"]])))
    whole = tctx.disocclusion_mask(*map(_t, args), data["tcam"],
                                   _t(data["prev_vp"])).numpy()[_rows(b)]
    assert 0.01 < want.mean() < 0.99
    assert (got != want).mean() < 1e-3        # comparisons at the threshold
    assert (got != whole).mean() < 5e-3


# the horizon taps' row clamp: a bilinear tap at +-7.x rows reads rows up
# to 8 away, inside the halo (and inside the warp kernel's window, whose
# row halo shrinks to 8 on a band of 16 + 2 x 8 rows)
MAX_TAP = (63.0, HALO - 1.0)


def _band_gtao(data, b, use_pallas, port=True):
    """compute_gtao of band b on its edge-clamped halo rows (row0 the
    first halo row, taps clamped to the halo, mip 0), the band's rows."""
    rows = _halo_rows(b, HALO, wrap=False)
    kw = dict(num_slices=SLICES, num_steps=STEPS, use_pallas=use_pallas,
              row0=b * BH - HALO, full_h=H, max_tap_px=MAX_TAP,
              use_mips=False)
    d, n = data["depth"][rows], data["normal"][rows]
    if port:
        def fn(dd, nn):
            return tssao.compute_gtao(_t(dd), _t(nn), data["tcam"], FRAME,
                                      **kw).numpy()[HALO:HALO + BH]
        return fn, d, n
    return np.asarray(jssao.compute_gtao(
        jnp.asarray(d), jnp.asarray(n), data["cam"], FRAME,
        **kw))[HALO:HALO + BH]


@pytest.mark.parametrize("route", ["per_tap", "kernel_route"])
def test_gtao_band_form(data, interpret, route):
    """compute_gtao with row0 / full_h / max_tap_px / use_mips=False on
    each band's halo rows: the JAX band form within GTAO_TOL, and the
    whole frame under the same clamps within GTAO_TOL (over the four
    bands together)."""
    use_pallas = route == "kernel_route"
    whole = tssao.compute_gtao(
        _t(data["depth"]), _t(data["normal"]), data["tcam"], FRAME,
        num_slices=SLICES, num_steps=STEPS, use_pallas=use_pallas,
        max_tap_px=MAX_TAP, use_mips=False).numpy()
    got, want, sens = [], [], []
    for b in range(N):
        fn, d, n = _band_gtao(data, b, use_pallas)
        got.append(fn(d, n))
        sens.append(ulp_sensitivity(fn, d, n))
        want.append(_band_gtao(data, b, use_pallas, port=False))
    got, sens = np.concatenate(got), np.concatenate(sens)
    assert_gtao_close(got, np.concatenate(want), sens)
    assert_gtao_close(got, whole, sens)


def test_gtao_fused_refuses_max_tap_px(data):
    """K5 takes the whole frame: max_tap_px (like row0,
    tests/test_torch_ssao.py) refuses the fused route."""
    with pytest.raises(ValueError, match="row0 or max_tap_px"):
        tssao.compute_gtao(_t(data["depth"]), _t(data["normal"]),
                           data["tcam"], FRAME, use_pallas=True, fused=True,
                           max_tap_px=(8.0, 8.0))


def test_convolved_depth_band(data):
    """The 3x3 mean on a wrap halo equals the whole frame's rows, in both
    packages."""
    d = data["depth"]
    bands = _split(d)
    ctxs = port_bands(bands)
    whole = tssao.convolved_depth(_t(d))
    jwhole = np.asarray(jssao.convolved_depth(jnp.asarray(d)))
    for b in range(N):
        got = tssao.convolved_depth(bands[b], band=ctxs[b])
        want = np.asarray(jssao.convolved_depth(jnp.asarray(d[_rows(b)]),
                                                band=jax_band(b, [d])))
        assert torch.equal(got, whole[_rows(b)])
        np.testing.assert_array_equal(want, jwhole[_rows(b)])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("route", ["bilinear", "kernel_route"])
def test_ssao_temporal_band(data, interpret, route):
    """ssao_temporal(band=): the history (AO and convolved depth) warped on
    halo rows, the variance clamp on a wrap halo."""
    use_pallas = route == "kernel_route"
    names = ("ao", "ao_hist", "cd_hist", "depth", "motion")
    lists = {k: _split(data[k]) for k in names}
    ctxs = port_bands(lists["ao"], lists["ao_hist"], lists["cd_hist"],
                      lists["depth"])
    dis = data["prev_depth"] > data["depth"] + 3e-4
    conv = tssao.convolved_depth(_t(data["depth"]))
    whole, whole_st = tssao.ssao_temporal(
        _t(data["ao"]), conv, tssao.SSAOState(_t(data["ao_hist"]),
                                              _t(data["cd_hist"])),
        _t(data["motion"]), use_pallas=use_pallas, disocclusion=_t(dis))
    fulls = [data["ao"], np.stack([data["ao_hist"], data["cd_hist"]], -1),
             data["depth"]]
    for b in range(N):
        rows = _rows(b)
        cd = tssao.convolved_depth(lists["depth"][b], band=ctxs[b])
        got, st = tssao.ssao_temporal(
            lists["ao"][b], cd, tssao.SSAOState(lists["ao_hist"][b],
                                                lists["cd_hist"][b]),
            lists["motion"][b], use_pallas=use_pallas,
            disocclusion=_t(dis[rows]), band=ctxs[b])
        jb = jax_band(b, fulls)
        jcd = jssao.convolved_depth(jnp.asarray(data["depth"][rows]), band=jb)
        want, jst = jssao.ssao_temporal(
            jnp.asarray(data["ao"][rows]), jcd,
            jssao.SSAOState(jnp.asarray(data["ao_hist"][rows]),
                            jnp.asarray(data["cd_hist"][rows])),
            jnp.asarray(data["motion"][rows]), use_pallas=use_pallas,
            disocclusion=jnp.asarray(dis[rows]), band=jb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(st.depth_history, cd)
        np.testing.assert_allclose(got.numpy(), whole.numpy()[rows],
                                   rtol=0, atol=1e-5)


FLAGS = {"warp_ycocg_gauss": (jtaa.TAAFeatureFlags.YCOCG_COLOR_SPACE
                              | jtaa.TAAFeatureFlags.GAUSSIAN_WEIGHTING
                              | jtaa.TAAFeatureFlags.PALLAS_WARP),
         "bicubic": (jtaa.TAAFeatureFlags.BICUBIC_FILTER
                     | jtaa.TAAFeatureFlags.YCOCG_COLOR_SPACE),
         "bilinear_rgb": jtaa.TAAFeatureFlags.NONE}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_taa_band(data, interpret, flags):
    """taa_accumulate(band=): the history warp on halo rows (motion
    clamped to halo - 3 px), the moments on a wrap halo."""
    ff = FLAGS[flags]
    cam, tcam = data["cam"], data["tcam"]
    dis = data["prev_depth"] > data["depth"] + 3e-4
    tres = tctx.prepare_postfx_resources(
        _t(data["depth"]), tcam, tcam, _t(data["prev_depth"]), FRAME,
        object_motion=_t(data["motion"]))
    whole, whole_st = ttaa.taa_accumulate(
        _t(data["color"]), ttaa.TAAState(_t(data["hist"]), _t(data["count"])),
        tres, feature_flags=ff, disocclusion=_t(dis))
    lists = {k: _split(data[k]) for k in ("color", "hist", "count")}
    ctxs = port_bands(lists["color"], lists["hist"], lists["count"])
    cs = (jtaa.rgb_to_ycocg if ff & jtaa.TAAFeatureFlags.YCOCG_COLOR_SPACE
          else np.asarray)
    fulls = [np.asarray(cs(jnp.asarray(data["color"]))),
             np.concatenate([data["hist"], data["count"][..., None]], -1)]
    closest = tres.closest_motion.numpy()
    for b in range(N):
        rows = _rows(b)

        def res(t, cm):
            x = (lambda a: _t(a[rows])) if t else (lambda a: jnp.asarray(
                a[rows]))
            mod = tctx if t else jctx
            return mod.PostFXResources(
                camera=tcam if t else cam, prev_camera=tcam if t else cam,
                depth=x(data["depth"]), prev_depth=x(data["prev_depth"]),
                motion=x(data["motion"]), closest_motion=x(cm),
                frame_index=FRAME)
        got, st = ttaa.taa_accumulate(
            lists["color"][b], ttaa.TAAState(lists["hist"][b],
                                             lists["count"][b]),
            res(True, closest), feature_flags=ff,
            disocclusion=_t(dis[rows]), band=ctxs[b])
        want, jst = jtaa.taa_accumulate(
            jnp.asarray(data["color"][rows]),
            jtaa.TAAState(jnp.asarray(data["hist"][rows]),
                          jnp.asarray(data["count"][rows])),
            res(False, closest), feature_flags=ff,
            disocclusion=jnp.asarray(dis[rows]), band=jax_band(b, fulls))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(st.sample_count.numpy(),
                                   np.asarray(jst.sample_count), atol=1e-5)
        np.testing.assert_allclose(got.numpy(), whole.numpy()[rows], rtol=0,
                                   atol=1e-5)
        # the moments alone: bit-equal to the whole frame's rows
        cur = ttaa.rgb_to_ycocg(lists["color"][b])
        ext = ttaa.rgb_to_ycocg(ctxs[b].extend(lists["color"][b], 1,
                                               wrap=True))
        m_band = ttaa._neighborhood_moments(cur, src=ext)
        m_whole = ttaa._neighborhood_moments(ttaa.rgb_to_ycocg(
            _t(data["color"])))
        for a, w in zip(m_band, m_whole):
            assert torch.equal(a, w[rows])
