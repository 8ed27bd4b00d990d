"""Parity of the port's SSAO (diligentfx_tpu_torch.postfx.ssao) and fused
GTAO (ops/gtao.py) with the JAX package on the CPU.

The inputs are the analytic depth/normal field of tests/test_gtao_pallas.py,
made with numpy from a seed.  The GTAO grid is 64 x 256, so the bounded
warp's (16, 64) halo and the fused kernel's (16, 64) halo stay open.  The
JAX side runs eagerly, its Pallas kernels interpreted.

Tolerances, and why they are not bit-exact.  The two packages round
differently: XLA contracts multiply-adds into FMAs inside jitted jnp
functions and interpreted Pallas kernels, PyTorch rounds every operation.
GTAO turns most such ulps into less than 1e-6 of AO, but not everywhere:
near an arccos argument of +-1 (a horizon cosine pulled to -1 by the
distance falloff, a normal facing the view) its slope grows as
1 / sqrt(1 - x^2).  `ulp_sensitivity` measures that on the port itself: how
far its output moves when the depth or the normals move by one ulp.  A
pixel where that exceeds 1e-6 is ill-conditioned: no float32
implementation can promise 1e-5 there.  GTAO_TOL, checked by
`assert_gtao_close`:
  * on the well-conditioned pixels (at least 60% of them), at least 99.9%
    within 1e-5 (measured 99.96-99.98%);
  * on all pixels, at least 99.5% within 1e-5 (99% after apply_ssao's blur
    and 2x upsample, which spread each such pixel over its neighbours) and
    all within 5e-4;
  * the witness for the cause: at least 75% of the pixels beyond 1e-5 are
    ill-conditioned (measured 80-96%).
The fused TPU kernel interpreted on the CPU adds one more: XLA contracts
the interleaved-gradient noise's `0.06711056 x + 0.00583715 y` into an FMA
in some fusions and not in others, and the fractional part of 52.98 times
it turns one ulp of the sum (up to 2e-6) into 1e-4 of noise.
`ign_fma_sensitive` finds, in numpy, the pixels whose noise the
contraction changes (about a quarter).  Against the interpreted kernel:
  * on the noise-stable pixels the 99th percentile is within 1e-5
    (measured 1.6e-6 at 2 slices x 1 step, 3.2e-6 at 1 x 4), and the
    noise-stable, well-conditioned ones are at least 99.9% within 1e-5
    (measured 99.99% and 99.95%);
  * at least 95% of the pixels beyond 1e-5 are noise-sensitive or
    ill-conditioned (measured 2,418 of 2,419 and 2,863 of 2,868);
  * everywhere the bounds the JAX package holds its fused kernel to
    against its per-tap route at 2 slices (tests/test_gtao_pallas.py:
    median 1e-6, 99th percentile 1e-3, max 6e-3).  With one slice the AO
    is that slice's arc, not the mean of two, so a changed noise moves it
    up to twice as far: the max bound doubles (measured 8.5e-3).
The card holds the CUDA kernel to gtao_fused_plain within 1e-5
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import CameraAttribs
from diligentfx_tpu.ops.gtao_pallas import gtao_pallas
from diligentfx_tpu.postfx import ssao as jssao
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.ops import gtao as tg
from diligentfx_tpu_torch.ops.warp import warp_bilinear
from diligentfx_tpu_torch.postfx import ssao as tssao
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W = 64, 256
SLICES, STEPS = 2, 4          # the bench configuration
FRAME = 3
ROUTES = {"per_tap_mips": False, "kernel_route": True}


def _scene(h, w, seed=0):
    """Depth, view-space normals (numpy) and the JAX camera, as
    tests/test_gtao_pallas.py builds them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (0.55 + 0.25 * np.sin(yy * 0.11) * np.cos(xx * 0.05)
             + 0.05 * rng.random((h, w), dtype=np.float32))
    depth = np.clip(depth, 0.05, 0.98).astype(np.float32)
    n = np.stack([0.15 * np.sin(xx * 0.07), 0.15 * np.cos(yy * 0.09),
                  np.ones_like(xx)], axis=-1)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    cam = CameraAttribs.create(jm3.look_at([0.0, 1.0, 7.5], [0.0, 0.0, 0.0]),
                               jm3.perspective(0.7, w / h, 0.1, 100.0),
                               [0.0, 1.0, 7.5], 0.1, 100.0, w, h)
    return depth, n, cam


def ulp_sensitivity(fn, depth, normal, trials=2):
    """Per output value, the largest change of fn(depth, normal) when the
    depth or the normals move by one ulp (each element up or down at
    random, `trials` draws each)."""
    base = fn(depth, normal)
    sens = np.zeros(base.shape, np.float32)
    for k in range(trials):
        rng = np.random.default_rng(100 + k)
        for i, x in enumerate((depth, normal)):
            moved = np.nextafter(x, np.where(rng.random(x.shape) < 0.5,
                                             -np.inf, np.inf).astype(x.dtype))
            args = (moved, normal) if i == 0 else (depth, moved)
            sens = np.maximum(sens, np.abs(fn(*args) - base))
    return sens


def ill_conditioned(sens):
    return sens > 1e-6


def assert_gtao_close(got, want, sens, share=0.995):
    """GTAO_TOL of the module docstring."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    ill = ill_conditioned(sens)
    bad = d > 1e-5
    assert np.isfinite(got).all()
    assert (~ill).mean() >= 0.6, float((~ill).mean())
    assert (~bad[~ill]).mean() >= 0.999, (int(bad[~ill].sum()),
                                          int((~ill).sum()))
    assert (~bad).mean() >= share, (int(bad.sum()), d.size)
    assert d.max() <= 5e-4, float(d.max())
    assert (bad & ill).sum() >= 0.75 * bad.sum(), (int((bad & ill).sum()),
                                                   int(bad.sum()))


def ign_fma_sensitive(h, w, frame):
    """Pixels whose interleaved-gradient noise (postfx/context.py) changes
    when XLA contracts 0.06711056 x + 0.00583715 y into an FMA, either way
    round.  float32 products are exact in float64, so rounding the float64
    sum once gives the FMA."""
    f = np.float32(frame)
    fo = np.float32(5.588238) * (f - np.float32(64.0)
                                 * np.floor(f / np.float32(64.0)))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a, b = np.float32(0.06711056), np.float32(0.00583715)
    ax, by = a * (xx + fo), b * (yy + fo)
    sums = [ax + by,
            (np.float64(a) * (xx + fo) + by).astype(np.float32),
            (np.float64(b) * (yy + fo) + ax).astype(np.float32)]

    def noise(m):
        m = m - np.floor(m)
        n = np.float32(52.9829189) * m
        return n - np.floor(n)
    n0, n1, n2 = (noise(m) for m in sums)
    return (n0 != n1) | (n0 != n2)


@pytest.fixture(scope="module")
def interpret():
    from jax.experimental import pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


@pytest.fixture(scope="module")
def gtao_case(interpret):
    """JAX compute_gtao on both routes, computed once."""
    depth, normal, cam = _scene(H, W)
    out = {name: np.asarray(jssao.compute_gtao(
        jnp.asarray(depth), jnp.asarray(normal), cam, jnp.int32(FRAME),
        jssao.SSAOSettings(), SLICES, STEPS, use_pallas=route))
        for name, route in ROUTES.items()}
    return depth, normal, cam, out


@pytest.mark.parametrize("route", list(ROUTES))
def test_compute_gtao_matches_jax(gtao_case, route):
    depth, normal, cam, jout = gtao_case
    tcam = cv.camera_from_jax(cam)

    def port(d, n):
        return tssao.compute_gtao(torch.from_numpy(d), torch.from_numpy(n),
                                  tcam, FRAME, tssao.SSAOSettings(), SLICES,
                                  STEPS, use_pallas=ROUTES[route]).numpy()
    before = warp_bilinear.launches
    got = port(depth, normal)
    assert warp_bilinear.launches == before       # the CPU runs no kernel
    assert got.shape == (H, W)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert_gtao_close(got, jout[route], ulp_sensitivity(port, depth, normal))


@pytest.mark.parametrize("route", list(ROUTES))
def test_apply_ssao_with_history_matches_jax(interpret, route):
    """apply_ssao at half resolution (GTAO on 64 x 256) with a history,
    motion and a disocclusion mask: AO and the new state."""
    depth, normal, cam = _scene(2 * H, 2 * W, seed=1)
    rng = np.random.default_rng(2)
    hist = rng.uniform(0.3, 1.0, depth.shape).astype(np.float32)
    hist_d = (depth + rng.normal(0, 0.01, depth.shape)).astype(np.float32)
    motion = rng.uniform(-0.004, 0.004, depth.shape + (2,)).astype(np.float32)
    motion[:4] = 0.02                  # some history taps off screen
    disocc = rng.random(depth.shape) < 0.05
    ao_j, st_j = jssao.apply_ssao(
        jnp.asarray(depth), jnp.asarray(normal), cam, jnp.int32(FRAME),
        jssao.SSAOSettings(),
        state=jssao.SSAOState(jnp.asarray(hist), jnp.asarray(hist_d)),
        motion=jnp.asarray(motion), half_resolution=True,
        num_slices=SLICES, num_steps=STEPS, use_pallas=ROUTES[route],
        disocclusion=jnp.asarray(disocc))
    t = torch.from_numpy
    tcam = cv.camera_from_jax(cam)

    def port(d, n):
        return tssao.apply_ssao(
            t(d), t(n), tcam, FRAME, tssao.SSAOSettings(),
            state=tssao.SSAOState(t(hist), t(hist_d)), motion=t(motion),
            half_resolution=True, num_slices=SLICES, num_steps=STEPS,
            use_pallas=ROUTES[route], disocclusion=t(disocc))

    ao_t, st_t = port(depth, normal)
    assert ao_t.shape == depth.shape
    def ao_and_history(d, n):
        ao, st = port(d, n)
        return np.stack([ao.numpy(), st.history.numpy()])
    sens = ulp_sensitivity(ao_and_history, depth, normal)
    assert_gtao_close(ao_t.numpy(), np.asarray(ao_j), sens[0], share=0.99)
    assert_gtao_close(st_t.history.numpy(), np.asarray(st_j.history),
                      sens[1], share=0.99)
    np.testing.assert_allclose(st_t.depth_history.numpy(),
                               np.asarray(st_j.depth_history), rtol=0,
                               atol=1e-6)


def test_ssao_first_frame_takes_current_ao():
    """With no history the temporal pass returns the AO and a state made
    of it (JAX ssao.py:378)."""
    ao = torch.rand((8, 16), generator=torch.Generator().manual_seed(0))
    cd = torch.rand((8, 16))
    out, st = tssao.ssao_temporal(ao, cd, None, None)
    assert out is ao and st.history is ao and st.depth_history is cd


def _fused_plain_vs_interpret(slices, steps):
    """K5's plain version against the TPU kernel interpreted; tolerance and
    witnesses in the module docstring."""
    depth, normal, cam = _scene(H, W, seed=3)
    sc = tssao.gtao_scalars(cv.camera_from_jax(cam), FRAME,
                            tssao.SSAOSettings())
    want = np.asarray(gtao_pallas(jnp.asarray(depth), jnp.asarray(normal),
                                  jnp.asarray(sc.numpy()), num_slices=slices,
                                  num_steps=steps, fh_log=H, w_log=W))

    def port(d, n):
        return tg.gtao_fused_plain(torch.from_numpy(d), torch.from_numpy(n),
                                   sc, num_slices=slices,
                                   num_steps=steps).numpy()
    got = port(depth, normal)
    assert got.shape == want.shape == (H, W)
    d = np.abs(got - want)
    bad = d > 1e-5
    stable = ~ign_fma_sensitive(H, W, FRAME)
    well = stable & ~ill_conditioned(ulp_sensitivity(port, depth, normal))
    assert stable.mean() > 0.7 and well.mean() > 0.5
    assert np.percentile(d[stable], 99) <= 1e-5, \
        float(np.percentile(d[stable], 99))
    assert (~bad[well]).mean() >= 0.999, (int(bad[well].sum()),
                                          int(well.sum()))
    assert (bad & ~well).sum() >= 0.95 * bad.sum(), (int((bad & ~well).sum()),
                                                     int(bad.sum()))
    assert np.median(d) < 1e-6, float(np.median(d))
    assert np.percentile(d, 99) < 1e-3, float(np.percentile(d, 99))
    assert d.max() < 6e-3 * 2 / slices, float(d.max())


def test_gtao_fused_plain_matches_pallas_interpret(interpret):
    """2 slices x 1 step: the slice loop (an interpreted kernel compiles in
    about 5 s a tap, so neither case runs all 16 of the bench's)."""
    _fused_plain_vs_interpret(2, 1)


def test_gtao_fused_plain_step_loop_matches_pallas_interpret(interpret):
    """1 slice x 4 steps: the bench's step loop, tt for every step."""
    _fused_plain_vs_interpret(1, 4)


@pytest.mark.parametrize("shape", [(H, W), (100, 700)])
def test_gtao_fused_matches_per_tap_route(shape):
    """compute_gtao(fused=True) against the per-tap kernel route, both in
    the port: the same mip-0 taps and clamps.  They differ by the Hastings
    arccos (7e-5 rad) and, near tile edges, by the fused kernel's 32-row
    window against the warp's 8-row one (the JAX package's bounds,
    tests/test_gtao_pallas.py:41).  100 x 700 pads to 128 x 768: the
    window widens by a tile and its origin rounds down."""
    h, w = shape
    depth, normal, cam = _scene(h, w, seed=4)
    args = (torch.from_numpy(depth), torch.from_numpy(normal),
            cv.camera_from_jax(cam), FRAME, tssao.SSAOSettings(), SLICES,
            STEPS)
    before = tg.gtao_fused.launches
    fused = tssao.compute_gtao(*args, use_pallas=True, fused=True).numpy()
    assert tg.gtao_fused.launches == before
    ref = tssao.compute_gtao(*args, use_pallas=True).numpy()
    assert fused.shape == (h, w) and np.isfinite(fused).all()
    d = np.abs(fused - ref)[2:-2, 2:-2]
    assert np.percentile(d, 99) < 1e-3, float(np.percentile(d, 99))
    assert d.max() < 6e-3, float(d.max())
    assert np.median(d) < 1e-5, float(np.median(d))


def test_gtao_fused_wrapper_runs_plain_on_cpu():
    depth, normal, cam = _scene(H, W, seed=5)
    sc = tssao.gtao_scalars(cv.camera_from_jax(cam), 0, tssao.SSAOSettings())
    kw = dict(num_slices=SLICES, num_steps=STEPS)
    a = tg.gtao_fused(torch.from_numpy(depth), torch.from_numpy(normal), sc,
                      **kw)
    b = tg.gtao_fused_plain(torch.from_numpy(depth), torch.from_numpy(normal),
                            sc, **kw)
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(32, 256), (64, 128), (20, 100)])
def test_gtao_fused_raises_where_the_halo_collapses(shape):
    """At 32 padded rows or 128 padded columns the TPU kernel's halo
    shrinks to 0 and every tap clamps onto its own tile; the port raises."""
    h, w = shape
    depth = torch.full((h, w), 0.5)
    normal = torch.zeros((h, w, 3))
    normal[..., 2] = 1.0
    with pytest.raises(ValueError, match="collapses"):
        tg.gtao_fused(depth, normal, torch.ones(8), num_slices=2,
                      num_steps=4)


def test_fused_needs_the_kernel_route_and_bands_raise():
    """fused=True selects K5, an option of the kernel route; the row-band
    arguments are ported (tests/test_torch_postfx_bands.py), and the fused
    kernel takes the whole frame only."""
    depth, normal, cam = _scene(H, W)
    args = (torch.from_numpy(depth), torch.from_numpy(normal),
            cv.camera_from_jax(cam), 0)
    with pytest.raises(ValueError, match="use_pallas"):
        tssao.compute_gtao(*args, fused=True)
    with pytest.raises(ValueError, match="row0 or max_tap_px"):
        tssao.compute_gtao(*args, use_pallas=True, fused=True, row0=8)
