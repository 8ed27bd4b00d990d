"""Parity of the port's epipolar light scattering and auto exposure
(diligentfx_tpu_torch.postfx.epipolar, postfx.tonemap) with the JAX
package on the CPU, at tests/test_epipolar.py's small settings: 64 x 64
pixels, 64 slices x 32 samples x 16 steps.

The JAX side is jitted, so XLA contracts multiply-adds into fused ones and
evaluates exp, log and pow with its own polynomials, where the port rounds
each operation and calls PyTorch's.  The stated tolerances follow from
that:
  * the LUTs: altitudes come from sqrt(r0^2 + t^2 + 2 r0 t c) at the Earth's
    radius, where one float32 ulp of r0^2 is 4.2e6 m^2, or 0.33 m of
    altitude; the Mie density exp(-h / 1200 m) then moves by 3e-4, so the
    tables are held to 1e-3 relative;
  * a scattered frame (inscatter, transmittance, colour): 1e-4 of the
    field's largest value (measured: at most 1.8e-5, with and without
    shadows), the rounding of the exponentials carried through 16 march
    steps and the unwarp; the epipolar grid to 1e-5 (uv units).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import CameraAttribs
from diligentfx_tpu.components.shadow_map_manager import distribute_cascades
from diligentfx_tpu.postfx import epipolar as jepi
from diligentfx_tpu.postfx.tonemap import average_log_luminance as j_avg_lum
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.postfx import epipolar as tepi
from diligentfx_tpu_torch.postfx.tonemap import average_log_luminance
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W = 64, 64
NEAR, FAR = 0.5, 2000.0
SMALL = dict(num_epipolar_slices=64, max_samples_in_slice=32,
             num_ray_march_steps=16)
SUN_AHEAD = [0.0, -0.3, -1.0]          # on screen, low over the horizon
SUN_SIDE = [1.0, -0.4, -0.2]           # off screen to the right
SUN_BEHIND = [0.2, -0.5, 1.0]          # behind the camera


def _camera():
    eye = [0.0, 2.0, 0.0]
    return CameraAttribs.create(jm3.look_at(eye, [0.0, 2.0, -10.0]),
                                jm3.perspective(1.2, W / H, NEAR, FAR), eye,
                                NEAR, FAR, W, H)


@pytest.fixture(scope="module")
def luts():
    """Both packages' LUTs at the task manager's sizes: (JAX optical
    depth, JAX multiple scattering, port optical depth, port multiple
    scattering)."""
    od = jepi.precompute_optical_depth_lut()
    ms = jepi.precompute_multiple_scattering_lut(od)
    tod = tepi.precompute_optical_depth_lut(device="cpu")
    return od, ms, tod, tepi.precompute_multiple_scattering_lut(tod)


@pytest.fixture(scope="module")
def scene():
    """A depth buffer with sky on top, ground receding to 300 m below and
    blocks of columns in front (depth breaks), an HDR colour, two 64^2
    cascades fitted to the camera with blocks of casters (three in four
    near the light, the rest empty), for both packages."""
    rng = np.random.default_rng(5)
    y = (np.arange(H) + 0.5)[:, None] / H
    z = np.where(y < 0.45, np.inf, 2.0 / np.maximum(y - 0.45, 1e-3))
    z = np.broadcast_to(z, (H, W)).copy()
    cols = rng.uniform(3.0, 40.0, W // 8)
    for i, zc in enumerate(cols):
        if i % 2:
            z[8:, i * 8:i * 8 + 5] = np.minimum(z[8:, i * 8:i * 8 + 5], zc)
    depth = np.where(np.isinf(z), 1.0,
                     (FAR - NEAR * FAR / np.minimum(z, 1e9)) / (FAR - NEAR))
    depth = depth.astype(np.float32)
    color = (rng.random((H, W, 3)) * 1.5).astype(np.float32)
    cam = _camera()
    att = distribute_cascades(cam.view, jm3.inverse(cam.view),
                              float(cam.proj[0, 0]), float(cam.proj[1, 1]),
                              NEAR, 200.0, SUN_AHEAD, num_cascades=2,
                              shadow_map_size=64)
    maps = np.kron(rng.choice([0.02, 1.0], (2, 8, 8), p=[0.75, 0.25]),
                   np.ones((1, 8, 8))).astype(np.float32)
    return dict(depth=depth, color=color, cam=cam, att=att, maps=maps,
                tcam=cv.camera_from_jax(cam),
                tatt=cv.shadow_attribs_from_jax(att),
                tmaps=torch.from_numpy(maps))


def _rel_close(got, ref, rtol, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, (name, err, scale)


def test_optical_depth_lut(luts):
    od, _, tod, _ = luts
    assert tod.shape == (64, 128, 2)
    np.testing.assert_allclose(tod.numpy(), np.asarray(od), rtol=1e-3,
                               atol=0)


def test_multiple_scattering_lut(luts):
    od, ms, _, _ = luts
    got = tepi.precompute_multiple_scattering_lut(torch.from_numpy(
        np.array(od)))
    assert got.shape == (32, 32, 3)
    # with the sun below the horizon the transfer underflows to 1e-34 and
    # less; those entries are held to 1e-6 of the table's largest
    ref = np.asarray(ms)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3,
                               atol=1e-6 * ref.max())


def test_phase_functions():
    c = np.linspace(-1.0, 1.0, 101, dtype=np.float32)
    np.testing.assert_allclose(tepi.phase_rayleigh(torch.from_numpy(c)),
                               np.asarray(jepi.phase_rayleigh(c)), rtol=1e-6)
    np.testing.assert_allclose(
        tepi.phase_mie(torch.from_numpy(c), 0.76),
        np.asarray(jepi.phase_mie(c, jnp.float32(0.76))), rtol=1e-5)


def _light_uv(cam, sun):
    """The sun's uv as _apply_impl projects it (through a negative w for a
    sun behind the camera: the antisolar point)."""
    sun = np.asarray(jm3.normalize(jnp.asarray(sun, jnp.float32)))
    clip = np.asarray(jm3.transform_points(cam.position - sun * 1e4,
                                           cam.view_proj))
    ndc = clip[:2] / clip[3]
    return np.array([ndc[0] * 0.5 + 0.5, 0.5 - ndc[1] * 0.5], np.float32)


@pytest.mark.parametrize("sun", ["ahead", "side", "behind"])
def test_epipolar_grid(sun):
    cam = _camera()
    uv = _light_uv(cam, {"ahead": SUN_AHEAD, "side": SUN_SIDE,
                         "behind": SUN_BEHIND}[sun])
    on_screen = bool(((uv >= 0) & (uv <= 1)).all())
    assert on_screen == (sun != "side")
    grid, ends = jepi._epipolar_grid(jnp.asarray(uv), 64, 32)
    tgrid, tends = tepi._epipolar_grid(torch.from_numpy(uv), 64, 32)
    np.testing.assert_allclose(tgrid.numpy(), np.asarray(grid), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tends.numpy(), np.asarray(ends), rtol=0,
                               atol=1e-5)
    assert (tgrid.numpy() >= -1e-5).all() and (tgrid.numpy() <= 1 + 1e-5).all()


# name: (settings overrides, sun, shadowed, multiple scattering)
CASES = {
    "plain": ({}, SUN_AHEAD, False, True),
    "no_ms_lut": ({}, SUN_AHEAD, False, False),
    "behind_camera": ({}, SUN_BEHIND, False, True),
    "pcf": ({}, SUN_AHEAD, True, True),
    # 96 base cells: each slice's farthest ray covers exactly
    # minmax_tree_res / num_ray_march_steps cells a step, and where that is
    # a power of two (64 / 16 = 4) the tree level of that ray is decided by
    # an ulp (ceil(log2(4 +- ulp))); 96 / 16 = 6 is not
    "minmax_tree": ({"use_minmax_tree": True, "minmax_tree_res": 96},
                    SUN_AHEAD, True, True),
    "refinement": ({"refinement_factor": 4}, SUN_AHEAD, True, True),
    "single_sctr_lut": ({"single_sctr_lut": True}, SUN_AHEAD, True, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_apply_light_scattering_matches_jax(luts, scene, name):
    over, sun, shadowed, use_ms = CASES[name]
    od, ms, _, _ = luts
    js = jepi.EpipolarSettings(**SMALL, **over)
    ts = cv.epipolar_settings_from_jax(js)
    assert ts == tepi.EpipolarSettings(**SMALL, **over)._replace(
        **{f: float(np.float32(getattr(tepi.EpipolarSettings(), f)))
           for f in ("mie_g", "sun_intensity", "scene_scale",
                     "base_altitude", "sun_angular_radius")})
    ref = jepi.apply_light_scattering(
        scene["color"], scene["depth"], scene["cam"], sun, od, js,
        shadow_data=(scene["att"], scene["maps"]) if shadowed else None,
        ms_lut=ms if use_ms else None)
    got = tepi.apply_light_scattering(
        torch.from_numpy(scene["color"]), torch.from_numpy(scene["depth"]),
        scene["tcam"], sun, torch.from_numpy(np.array(od)), ts,
        shadow_data=(scene["tatt"], scene["tmaps"]) if shadowed else None,
        ms_lut=torch.from_numpy(np.array(ms)) if use_ms else None)
    for field in ("inscatter", "transmittance", "color"):
        _rel_close(getattr(got, field), getattr(ref, field), 1e-4,
                   f"{name}: {field}")
    assert np.asarray(ref.inscatter).max() > 0.0


def test_shadows_darken_the_inscatter(luts, scene):
    """The shadowed march carries less single-scattered light than the lit
    one (the cascades end at 200 m; farther segments stay lit)."""
    _, _, tod, _ = luts
    s = tepi.EpipolarSettings(**SMALL)
    args = (torch.from_numpy(scene["color"]), torch.from_numpy(scene["depth"]),
            scene["tcam"], SUN_AHEAD, tod, s)
    lit = tepi.apply_light_scattering(*args)
    shd = tepi.apply_light_scattering(
        *args, shadow_data=(scene["tatt"], scene["tmaps"]))
    assert float(shd.inscatter.mean()) < 0.95 * float(lit.inscatter.mean())


@pytest.mark.parametrize("budget", ["spare_slots", "overflow"])
def test_refinement_drops_like_jax(luts, scene, budget):
    """The refinement buffer's scatters: with a large budget most slots stay
    empty and their writes drop; with a small one (refinement_budget_div
    64: 128 slots) more samples straddle a depth break than the budget
    holds, and those past it keep their interpolated value."""
    od, ms, _, _ = luts
    depth = scene["depth"].copy()
    if budget == "overflow":   # a depth break at every column
        depth[8:, 1::2] = np.minimum(depth[8:, 1::2], 0.8)
    js = jepi.EpipolarSettings(**SMALL, refinement_factor=4,
                               refinement_budget_div=(
                                   2 if budget == "spare_slots" else 64))
    ref = jepi.apply_light_scattering(scene["color"], depth, scene["cam"],
                                      SUN_AHEAD, od, js, ms_lut=ms)
    got = tepi.apply_light_scattering(
        torch.from_numpy(scene["color"]), torch.from_numpy(depth),
        scene["tcam"], SUN_AHEAD, torch.from_numpy(np.array(od)),
        cv.epipolar_settings_from_jax(js), ms_lut=torch.from_numpy(
            np.array(ms)))
    _rel_close(got.inscatter, ref.inscatter, 1e-4, budget)
    _rel_close(got.color, ref.color, 1e-4, budget)


def test_average_log_luminance_and_adaptation():
    rng = np.random.default_rng(2)
    color = (rng.random((48, 64, 3)) ** 3 * 4.0).astype(np.float32)
    ref = float(j_avg_lum(color))
    got = average_log_luminance(torch.from_numpy(color))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)
    # the task manager's adaptation: prev + (measured - prev) * rate
    prev, rate = np.float32(0.3), 0.05
    j = float(jnp.float32(prev) + (jnp.float32(ref) - jnp.float32(prev))
              * rate)
    t = torch.tensor(prev) + (torch.tensor(ref) - torch.tensor(prev)) * rate
    assert float(t) == j
