"""Parity of the port's SSR (diligentfx_tpu_torch.postfx.ssr) and row-DDA
march (ops/march.py) with the JAX package on the CPU.

The march is held exactly: `march_dda_plain` takes the operation order of
the JAX package's `march_dda_reference` (run eagerly), so hits agree
everywhere and t within 1e-6, on random rays and on nearly horizontal
("flat") rays, whose home-row case is the risky one.

compute_ssr runs on a G-buffer the port renders on the CPU (the bench
scene at 512 x 256, so the march grid at divisor 2 is 128 x 256 and the
history warp's (16, 64) halo stays open).  Both packages take that same
G-buffer.  The JAX side runs eagerly; on its kernel route the march runs
through `march_dda_reference` (the JAX package's own oracle of the march
kernel) and the history warp through the interpreted Pallas kernel.  The
reflection rays come from sin, cos and sqrt, whose last bits differ between
XLA and PyTorch on the CPU, so a ray that grazes a depth plane can flip its
hit.  SSR_TOL: radiance and confidence within 1e-4 on at least 99.9% of the
pixels; the hit flips are counted and bounded at 0.1% of the pixels.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu.ops import march_pallas as jmarch
from diligentfx_tpu.postfx import ssr as jssr
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.ops import march as tm
from diligentfx_tpu_torch.postfx import ssr as tssr
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROUTES = {"fixed_step": False, "kernel_route": True}
GW, GH = 512, 256             # G-buffer; the march grid is 128 x 256


def _rays(h, w, rows, cols, seed, flat_share=0.0):
    """A min-depth table and rays (numpy): origins in front of the table,
    directions that go behind it; `flat_share` of the rays nearly
    horizontal (|dv| <= 1e-7, half of them exactly 0)."""
    g = np.random.default_rng(seed)
    coarse = g.uniform(0.35, 0.95, (rows, cols)).astype(np.float32)
    o = np.stack([g.uniform(0.02, 0.98, (h, w)), g.uniform(0.02, 0.98, (h, w)),
                  g.uniform(0.05, 0.6, (h, w))], -1).astype(np.float32)
    d = np.stack([g.uniform(-0.6, 0.6, (h, w)), g.uniform(-0.6, 0.6, (h, w)),
                  g.uniform(-0.1, 0.8, (h, w))], -1).astype(np.float32)
    flat = g.random((h, w)) < flat_share
    d[..., 1] = np.where(flat, np.where(g.random((h, w)) < 0.5, 0.0,
                                        g.uniform(-1e-7, 1e-7, (h, w))),
                         d[..., 1]).astype(np.float32)
    return coarse, o, d, np.float32(0.03)


@pytest.mark.parametrize("case", ["random", "flat_rays", "frame_table"])
def test_march_dda_plain_matches_reference(case):
    """march_dda_plain against march_dda_reference: the same hits, t within
    1e-6.  "frame_table" marches a 67 x 120 table, the bench frame's mip 3
    at 1080p / divisor 2."""
    rows, cols, flat = {"random": (24, 100, 0.0), "flat_rays": (24, 100, 0.4),
                        "frame_table": (67, 120, 0.05)}[case]
    coarse, o, d, thick = _rays(16, 128, rows, cols, seed=rows + cols,
                                flat_share=flat)
    t_lo_j, t_hit_j, hit_j = (np.asarray(x) for x in jmarch.march_dda_reference(
        jnp.asarray(coarse), jnp.asarray(o), jnp.asarray(d), thick))
    t_lo, t_hit, hit = (x.numpy() for x in tm.march_dda_plain(
        torch.from_numpy(coarse), torch.from_numpy(o), torch.from_numpy(d),
        float(thick)))
    assert 0.05 < hit_j.mean() < 0.95, hit_j.mean()
    assert int((hit != hit_j).sum()) == 0
    np.testing.assert_allclose(t_lo, t_lo_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_hit, t_hit_j, rtol=0, atol=1e-6)


def test_march_wrapper_runs_plain_on_cpu_and_checks_shapes():
    coarse, o, d, thick = _rays(8, 128, 16, 64, seed=5, flat_share=0.1)
    args = [torch.from_numpy(x) for x in (coarse, o, d)]
    before = tm.march_small_table.launches
    got = tm.march_small_table(*args, float(thick))
    want = tm.march_dda_plain(*args, float(thick))
    assert tm.march_small_table.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[2].dtype == torch.bool
    with pytest.raises(ValueError, match="columns"):
        tm.march_small_table(torch.zeros((8, 129)), args[1], args[2], 0.1)
    with pytest.raises(ValueError, match="multiple"):
        tm.march_small_table(args[0], args[1][:7], args[2][:7], 0.1)


@pytest.fixture(scope="module")
def gbuffer():
    """The port's G-buffer of the bench scene (2 x 2 spheres and the
    ground) at 512 x 256 on the CPU, as numpy, plus the JAX camera."""
    import chip_smoke as cs
    from diligentfx_tpu import math3d as jm3
    from diligentfx_tpu.attribs import CameraAttribs
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.pbr.deferred import render_gbuffer
    from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
    ren = PBRRenderer(PBRRendererCreateInfo(
        brdf_lut_dim=8, num_brdf_samples=4, irradiance_cube_dim=8,
        prefiltered_env_map_dim=8, num_specular_env_samples=4),
        raster_cfg=cs.bench_raster_config(), device="cpu")
    info = cs.render_info(GW, GH, "cpu")
    gb = render_gbuffer(cs.bench_scene(2, 2, 12, "cpu"), info, ren.ibl_maps,
                        ren.env_oct, width=GW, height=GH,
                        cfg=ren.raster_cfg, fast_env=True)
    lit = torch.where(gb.hit[..., None],
                      gb.direct + gb.ambient_diffuse + gb.ambient_specular,
                      gb.background)
    eye = [0.0, 1.0, 7.5]
    cam = CameraAttribs.create(jm3.look_at(eye, [0.0, 0.0, 0.0]),
                               jm3.perspective(0.7, GW / GH, 0.1, 100.0),
                               eye, 0.1, 100.0, GW, GH)
    return dict(color=lit.numpy(), depth=gb.depth.numpy(),
                normal=gb.normal_view.numpy(),
                rough=gb.material_data[..., 1:2].numpy().copy(), cam=cam)


@pytest.fixture(scope="module")
def ssr_inputs(gbuffer):
    g = np.random.default_rng(7)
    h, w = tssr.ssr_state_shape(GH, GW, 2)
    hist = g.uniform(0.0, 1.0, (h, w, 4)).astype(np.float32)
    motion = g.uniform(-0.003, 0.003, (GH, GW, 2)).astype(np.float32)
    motion[:, :6, 0] = 0.05               # history taps off the left edge
    disocc = g.random((GH, GW)) < 0.03
    return dict(gbuffer, hist=hist, motion=motion, disocc=disocc)


def _jax_ssr(inp, route, frame_index=1):
    kw = dict(settings=jssr.SSRSettings(max_traversal_intersections=24),
              state=jssr.SSRState(jnp.asarray(inp["hist"])),
              motion=jnp.asarray(inp["motion"]), half_resolution=True,
              resolution_divisor=2,
              disocclusion=jnp.asarray(inp["disocc"]), use_pallas=route)
    args = (jnp.asarray(inp["color"]), jnp.asarray(inp["depth"]),
            jnp.asarray(inp["normal"]), jnp.asarray(inp["rough"]),
            inp["cam"], jnp.int32(frame_index))
    from jax.experimental import pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        # the march kernel's own oracle, run eagerly (see the docstring)
        mp.setattr(jmarch, "march_small_table_pallas",
                   lambda coarse, o, d, thick, **_: jmarch.march_dda_reference(
                       coarse, o, d, thick))
        rad, st = jssr.compute_ssr(*args, **kw)
    return np.asarray(rad), np.asarray(st.radiance)


def _port_ssr(inp, route, frame_index=1):
    t = torch.from_numpy
    return tssr.compute_ssr(
        t(inp["color"]), t(inp["depth"]), t(inp["normal"]), t(inp["rough"]),
        cv.camera_from_jax(inp["cam"]), frame_index,
        tssr.SSRSettings(max_traversal_intersections=24),
        state=tssr.SSRState(t(inp["hist"])), motion=t(inp["motion"]),
        half_resolution=True, resolution_divisor=2,
        disocclusion=t(inp["disocc"]), use_pallas=route)


@pytest.mark.parametrize("route", list(ROUTES))
def test_compute_ssr_matches_jax(ssr_inputs, route):
    """compute_ssr with history, motion and disocclusion: the upsampled
    radiance + confidence and the new history; SSR_TOL."""
    rad_j, hist_j = _jax_ssr(ssr_inputs, ROUTES[route])
    rad_t, st = _port_ssr(ssr_inputs, ROUTES[route])
    rad_t, hist_t = rad_t.numpy(), st.radiance.numpy()
    assert rad_t.shape == (GH, GW, 4) and hist_t.shape == hist_j.shape
    assert np.isfinite(rad_t).all()
    flips = int(((rad_t[..., 3] > 0) != (rad_j[..., 3] > 0)).sum())
    assert flips <= 1e-3 * rad_t[..., 3].size, flips
    assert (rad_j[..., 3] > 0).mean() > 0.02       # reflections exist
    for a, b in ((rad_t, rad_j), (hist_t, hist_j)):
        close = np.abs(a - b) <= 1e-4
        assert close.mean() >= 0.999, (route, int((~close).sum()))


@pytest.mark.parametrize("route", list(ROUTES))
def test_march_matches_jax(ssr_inputs, route):
    """_march alone on the frame's rays: the kernel route marches mip 2
    (32 x 64) of the 128 x 256 grid; the fixed-step route the fine depth."""
    inp = ssr_inputs
    depth = inp["depth"][::2, ::2]
    g = np.random.default_rng(11)
    h, w = depth.shape
    o = np.stack([g.uniform(0.02, 0.98, (h, w)), g.uniform(0.02, 0.98, (h, w)),
                  depth - 0.01], -1).astype(np.float32)
    d = np.stack([g.uniform(-0.5, 0.5, (h, w)), g.uniform(-0.9, 0.1, (h, w)),
                  g.uniform(-0.05, 0.1, (h, w))], -1).astype(np.float32)
    thick = np.float32(0.15 / 99.9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmarch, "march_small_table_pallas",
                   lambda coarse, o, d, thick, **_: jmarch.march_dda_reference(
                       coarse, o, d, thick))
        uvz_j, hit_j = (np.asarray(x) for x in jssr._march(
            jssr.build_min_depth_pyramid(jnp.asarray(depth), 4),
            jnp.asarray(o), jnp.asarray(d), 24, thick,
            use_pallas=ROUTES[route]))
    uvz_t, hit_t = (x.numpy() for x in tssr._march(
        tssr.build_min_depth_pyramid(torch.from_numpy(depth), 4),
        torch.from_numpy(o), torch.from_numpy(d), 24, float(thick),
        use_pallas=ROUTES[route]))
    assert 0.02 < hit_j.mean() < 0.98, hit_j.mean()
    assert int((hit_t != hit_j).sum()) == 0
    np.testing.assert_allclose(uvz_t, uvz_j, rtol=0, atol=1e-5)


def test_ssr_state_shape_and_profiling_knobs():
    assert tssr.ssr_state_shape(1080, 1920, 2) == (540, 960)
    assert tssr.ssr_state_shape(1080, 1920, 0, True) == (540, 960)
    assert tssr.ssr_state_shape(1081, 1921, 4) == (271, 481)
    z = torch.zeros((16, 128))
    n = torch.zeros((16, 128, 3))
    cam = cv.camera_from_jax(jax.tree.map(np.asarray, _camera()))
    with pytest.raises(NotImplementedError, match="stage_cut"):
        tssr.compute_ssr(n, z, n, z[..., None], cam, 0, stage_cut="march")
    with pytest.raises(NotImplementedError, match="march_sweep"):
        tssr.compute_ssr(n, z, n, z[..., None], cam, 0, march_sweep="static")


def _camera():
    from diligentfx_tpu import math3d as jm3
    from diligentfx_tpu.attribs import CameraAttribs
    return CameraAttribs.create(jm3.look_at([0.0, 1.0, 7.5], [0, 0, 0]),
                                jm3.perspective(0.7, 2.0, 0.1, 100.0),
                                [0.0, 1.0, 7.5], 0.1, 100.0, 128, 16)
