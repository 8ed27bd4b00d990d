"""Parity of the port's post chain (diligentfx_tpu_torch.postfx: context,
TAA, bloom, tone map) with the JAX package on the CPU, module by module on
small random inputs made with numpy.

The warp-kernel callers (disocclusion_mask with use_pallas, TAA with
PALLAS_WARP) run the JAX package's Pallas warp interpreted.  Tolerances:
1e-5 where both sides take the same elementwise steps, 1e-4 through bloom's
convolutions (the JAX package's lax.conv and the port's conv2d sum the taps
in another order) and through the tone-map curves' pow/exp/log.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import CameraAttribs
from diligentfx_tpu.config import ToneMappingMode
from diligentfx_tpu.postfx import bloom as jbloom
from diligentfx_tpu.postfx import context as jctx
from diligentfx_tpu.postfx import taa as jtaa
from diligentfx_tpu.postfx import tonemap as jtm
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.postfx import bloom as tbloom
from diligentfx_tpu_torch.postfx import context as tctx
from diligentfx_tpu_torch.postfx import taa as ttaa
from diligentfx_tpu_torch.postfx import tonemap as ttm
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W = 32, 256


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    eye = [0.3, 1.0, 6.0]
    cam = CameraAttribs.create(jm3.look_at(eye, [0.0, 0.0, 0.0]),
                               jm3.perspective(0.8, W / H, 0.1, 50.0), eye,
                               0.1, 50.0, W, H)
    eye2 = [0.4, 1.05, 6.1]
    prev = CameraAttribs.create(jm3.look_at(eye2, [0.0, 0.0, 0.0]),
                                jm3.perspective(0.8, W / H, 0.1, 50.0), eye2,
                                0.1, 50.0, W, H)
    depth = rng.uniform(0.95, 0.999, (H, W)).astype(np.float32)
    depth[:, :40] = 1.0
    return dict(
        cam=cam, prev=prev, depth=depth,
        prev_depth=(depth + rng.normal(0, 2e-4, (H, W))).astype(np.float32),
        motion=(rng.normal(0, 0.01, (H, W, 2))).astype(np.float32),
        color=(rng.random((H, W, 3)) * 3.0).astype(np.float32),
        hist=(rng.random((H, W, 3)) * 3.0).astype(np.float32),
        count=rng.integers(1, 20, (H, W)).astype(np.float32))


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def test_noise_and_jitter_match_jax():
    for f in (0, 7, 70):
        np.testing.assert_allclose(
            tctx.interleaved_gradient_noise(H, W, f).numpy(),
            np.asarray(jctx.interleaved_gradient_noise(H, W, f)), atol=2e-5)
        np.testing.assert_allclose(
            tctx.r2_noise_pair(H, W, f).numpy(),
            np.asarray(jctx.r2_noise_pair(H, W, f)), atol=2e-5)
    seq = tctx.taa_jitter_sequence(16)
    np.testing.assert_array_equal(seq.numpy(),
                                  np.asarray(jctx.taa_jitter_sequence(16)))
    j = jctx.jitter_to_ndc(np.asarray(seq[3]), W, H)
    np.testing.assert_array_equal(tctx.jitter_to_ndc(seq[3], W, H).numpy(),
                                  np.asarray(j))
    proj = jm3.perspective(0.8, W / H, 0.1, 50.0)
    np.testing.assert_array_equal(
        tctx.apply_jitter_to_proj(_t(proj), _t(j)).numpy(),
        np.asarray(jctx.apply_jitter_to_proj(proj, j)))


def test_depth_products_match_jax(data):
    cam, tcam = data["cam"], cv.camera_from_jax(data["cam"])
    d = data["depth"]
    np.testing.assert_allclose(
        tctx.reconstruct_world_pos(_t(d), tcam).numpy(),
        np.asarray(jctx.reconstruct_world_pos(jnp.asarray(d), cam)),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        tctx.depth_to_camera_z(_t(d), tcam).numpy(),
        np.asarray(jctx.depth_to_camera_z(jnp.asarray(d), cam)), rtol=1e-5)
    np.testing.assert_allclose(
        tctx.reprojected_depth(_t(d), tcam,
                               cv.tensor(data["prev"].view_proj)).numpy(),
        np.asarray(jctx.reprojected_depth(jnp.asarray(d), cam,
                                          data["prev"].view_proj)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tctx.dilate_closest_motion(_t(d), _t(data["motion"])).numpy(),
        np.asarray(jctx.dilate_closest_motion(jnp.asarray(d),
                                              jnp.asarray(data["motion"]))))


def test_disocclusion_mask_matches_jax(data, interpret):
    """The first warp-kernel caller (JAX context.py:302)."""
    args = (data["depth"], data["prev_depth"], data["motion"])
    a = jctx.disocclusion_mask(*map(jnp.asarray, args), data["cam"],
                               data["prev"].view_proj, use_pallas=True)
    b = tctx.disocclusion_mask(*map(_t, args), cv.camera_from_jax(data["cam"]),
                               cv.tensor(data["prev"].view_proj),
                               use_pallas=True)
    a = np.asarray(a)
    assert 0.01 < a.mean() < 0.99
    assert (b.numpy() != a).mean() < 1e-3      # comparisons at the threshold


@pytest.mark.parametrize("flags", ["warp_ycocg_gauss", "bicubic"])
def test_taa_accumulate_matches_jax(data, interpret, flags):
    """taa_accumulate (JAX taa.py:128): the PALLAS_WARP branch of the main
    path, and the default Catmull-Rom branch."""
    f = jtaa.TAAFeatureFlags
    ff = ({"warp_ycocg_gauss": f.YCOCG_COLOR_SPACE | f.GAUSSIAN_WEIGHTING
           | f.PALLAS_WARP,
           "bicubic": f.BICUBIC_FILTER | f.YCOCG_COLOR_SPACE}[flags])
    cam = data["cam"]
    dis = data["depth"] > 0.998
    jres = jctx.prepare_postfx_resources(
        jnp.asarray(data["depth"]), cam, cam, jnp.asarray(data["prev_depth"]),
        3, object_motion=jnp.asarray(data["motion"]))
    jout, jst = jtaa.taa_accumulate(
        jnp.asarray(data["color"]),
        jtaa.TAAState(jnp.asarray(data["hist"]), jnp.asarray(data["count"])),
        jres, feature_flags=ff, disocclusion=jnp.asarray(dis))
    tcam = cv.camera_from_jax(cam)
    tres = tctx.prepare_postfx_resources(
        _t(data["depth"]), tcam, tcam, _t(data["prev_depth"]), 3,
        object_motion=_t(data["motion"]))
    tout, tst = ttaa.taa_accumulate(
        _t(data["color"]), ttaa.TAAState(_t(data["hist"]), _t(data["count"])),
        tres, feature_flags=ff, disocclusion=_t(dis))
    np.testing.assert_allclose(tres.closest_motion.numpy(),
                               np.asarray(jres.closest_motion))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tst.sample_count.numpy(),
                               np.asarray(jst.sample_count), atol=1e-5)


def test_bloom_matches_jax(data):
    c = data["color"]
    a = np.asarray(jbloom.apply_bloom(jnp.asarray(c)))
    b = tbloom.apply_bloom(_t(c)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", list(ToneMappingMode)[1:],
                         ids=lambda m: m.name)
def test_tone_map_matches_jax(data, mode):
    c = data["color"][:8, :64]
    a = np.asarray(jtm.tone_map(jnp.asarray(c), mode, ave_log_lum=0.3))
    b = ttm.tone_map(_t(c), mode, ave_log_lum=torch.tensor(0.3)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=mode.name)
