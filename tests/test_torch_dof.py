"""Parity of the port's depth of field (diligentfx_tpu_torch.postfx.dof) with
the JAX package's postfx/dof.py on the CPU, at 64 x 512 (the bokeh runs
at 32 x 256, where the warp's halos are (8, 64)).

The JAX functions run eagerly, op by op, as apply_dof is not jitted; the
kernel route's warp is the interpreted Pallas kernel.  Eager XLA rounds
every operation as the port does, so most fields agree to the last bit;
the tolerances cover the few places where the two libraries' own
routines differ by an ulp: exp in the CoC blur's Gaussian weights, and
the bilinear and warp lerps summed over 24 taps (1e-5 of the fields'
magnitude, which is about 2).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import CameraAttribs
from diligentfx_tpu.hydrogent.task_manager import FrameSettings
from diligentfx_tpu.postfx import dof as jdof
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.ops.warp import warp_bilinear
from diligentfx_tpu_torch.postfx import dof as tdof
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W = 64, 512
NEAR, FAR = 0.1, 100.0
ROUTES = {"bilinear": False, "warp": True}
# a wider aperture, a longer lens and a 2 px bokeh: at 64 rows the default
# settings give a CoC under 0.3 px; these reach the +-1 clamp on both
# fields and leave most pixels between
JSET = jdof.DoFSettings(focus_distance=jnp.float32(4.0),
                        f_stop=jnp.float32(2.8),
                        focal_length=jnp.float32(0.1),
                        max_coc_px=jnp.float32(2.0),
                        temporal_stability_factor=jnp.float32(0.85))
PSET = cv.frame_settings_from_jax(FrameSettings(dof=JSET)).dof


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def inputs():
    """HDR colour, a depth field of blocks from 0.8 to 40 m around the 5 m
    focus (near and far CoC both present), motion in uv units, a CoC
    history, and the camera for both packages."""
    rng = np.random.default_rng(11)
    color = (rng.random((H, W, 3)) * 2.0).astype(np.float32)
    z = np.exp(rng.uniform(np.log(0.8), np.log(40.0), (H // 8, W // 16)))
    z = np.kron(z, np.ones((8, 16))) * (1.0 + 0.05 * rng.random((H, W)))
    depth = ((FAR - NEAR * FAR / z) / (FAR - NEAR)).astype(np.float32)
    motion = ((rng.random((H, W, 2)) * 2 - 1) * 0.01).astype(np.float32)
    hist = (rng.random((H, W)) * 2 - 1).astype(np.float32)
    eye = [0.0, 1.0, 6.0]
    cam = CameraAttribs.create(jm3.look_at(eye, [0.0, 1.0, 0.0]),
                               jm3.perspective(0.8, W / H, NEAR, FAR), eye,
                               NEAR, FAR, W, H)
    return color, depth, motion, hist, cam, cv.camera_from_jax(cam)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_circle_of_confusion(inputs):
    _, depth, _, _, cam, tcam = inputs
    ref = np.asarray(jdof.circle_of_confusion(depth, cam, JSET))
    got = tdof.circle_of_confusion(_t(depth), tcam, PSET)
    assert (ref == -1.0).any() and (ref == 1.0).any()   # both fields
    assert ((ref > -0.9) & (ref < 0.9)).mean() > 0.2
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_dilate_and_blur_coc(inputs):
    _, depth, _, _, cam, _ = inputs
    coc = np.asarray(jdof.circle_of_confusion(depth, cam, JSET))
    dil = np.asarray(jdof.dilate_near_coc(coc, radius=3))
    got = tdof.dilate_near_coc(_t(coc), radius=3)
    np.testing.assert_array_equal(got.numpy(), dil)     # max and roll
    np.testing.assert_allclose(tdof.blur_coc_xy(_t(dil)).numpy(),
                               np.asarray(jdof.blur_coc_xy(dil)), rtol=0,
                               atol=1e-6)


def test_disk_kernel():
    np.testing.assert_array_equal(tdof._disk_kernel(24),
                                  np.asarray(jdof._disk_kernel(24)))


@pytest.mark.parametrize("route", list(ROUTES))
def test_bokeh_blur_separated(inputs, route):
    color, depth, _, _, cam, _ = inputs
    h2, w2 = H // 2, W // 2
    c2 = color[::2, ::2]
    coc2 = np.asarray(jdof.circle_of_confusion(depth, cam, JSET))[::2, ::2]
    near2 = np.asarray(jdof.blur_coc_xy(jdof.dilate_near_coc(coc2, 3)))
    ref = jdof.bokeh_blur_separated(c2, coc2, near2, JSET,
                                    use_pallas=ROUTES[route])
    before = warp_bilinear.launches
    got = tdof.bokeh_blur_separated(_t(c2), _t(coc2), _t(near2), PSET,
                                    use_pallas=ROUTES[route])
    assert warp_bilinear.launches == before         # the CPU runs no kernel
    for a, b in zip(ref, got):
        assert b.shape == (h2, w2, 3)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-5)


def test_bokeh_fill_and_tent(inputs):
    color, depth, _, _, cam, _ = inputs
    rad = np.abs(np.asarray(jdof.circle_of_confusion(depth, cam,
                                                     JSET))) * 2.0
    ref = np.asarray(jdof.tent_3x3(jdof.bokeh_fill(color, rad, JSET)))
    got = tdof.tent_3x3(tdof.bokeh_fill(_t(color), _t(rad), PSET))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
def test_apply_dof_matches_jax(inputs, route, temporal):
    color, depth, motion, hist, cam, tcam = inputs
    ref_out, ref_state = jdof.apply_dof(
        color, depth, cam, JSET, state=jdof.DoFState(coc_history=hist),
        motion=motion, use_temporal=temporal, use_pallas=ROUTES[route])
    out, state = tdof.apply_dof(
        _t(color), _t(depth), tcam, PSET,
        state=tdof.DoFState(coc_history=_t(hist)), motion=_t(motion),
        use_temporal=temporal, use_pallas=ROUTES[route])
    assert out.shape == (H, W, 3)
    np.testing.assert_allclose(state.coc_history.numpy(),
                               np.asarray(ref_state.coc_history), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0,
                               atol=2e-5)
    # the DoF changes the image where the CoC is large
    assert np.abs(out.numpy() - color).mean() > 0.1
    if not temporal:
        # the default settings (the frame's) convert and blur less
        out_d, _ = tdof.apply_dof(_t(color), _t(depth), tcam,
                                  use_pallas=ROUTES[route])
        ref_d, _ = jdof.apply_dof(color, depth, cam,
                                  use_pallas=ROUTES[route])
        np.testing.assert_allclose(out_d.numpy(), np.asarray(ref_d), rtol=0,
                                   atol=2e-5)
