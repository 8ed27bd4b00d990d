"""Parity of the port's editor components (diligentfx_tpu_torch/components/
{selection,depth_range,renderers}.py and postfx/tonemap.py
reverse_exp_tone_map) with the JAX package on the CPU, one case each of
tests/test_components.py plus random inputs made with numpy from a seed.
The JAX functions run eagerly.

Tolerances:
  * the jump flood and the outline: exact (integer coordinates in float32,
    the same candidate order and strict comparison);
  * the depth range: 1e-6 relative; reverse_exp_tone_map and the
    desaturation: 1e-6 absolute + 1e-6 relative;
  * the env map, bound box and vector field: 1e-5 on colour; the
    coordinate grid 1e-4 (its anti-aliased lines divide the hit point's
    world coordinates by one pixel's footprint there, so a last-bit
    difference of the camera ray, |p| * 1.2e-7, moves a line's ramp by
    about 7e-6 per ulp at every distance; measured 3.0e-5).  All four but
    for pixels where a threshold test flips between the two sides
    (dist2 < 1, mod(arc / period, 1) < 0.75, z <= depth + 1e-3,
    gz <= depth, the axis colour's > 0.5): those are allowed only where
    the tested value, recomputed in float64, lies within 1e-5 relative of
    its threshold; each test prints how many there were.  The two sides
    project points differently in the last bit (the JAX package's
    HIGHEST-precision matmul, the port's fp32 multiply-adds);
  * render_vector_field against render_vector_field_plain (the sequential
    form of the JAX package's scan): bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import CameraAttribs
from diligentfx_tpu.components import depth_range as jdr
from diligentfx_tpu.components import renderers as jren
from diligentfx_tpu.components import selection as jsel
from diligentfx_tpu.ops.sampling import oct_pixel_dirs
from diligentfx_tpu.postfx import tonemap as jtone
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.components import depth_range as tdr
from diligentfx_tpu_torch.components import renderers as tren
from diligentfx_tpu_torch.components import selection as tsel
from diligentfx_tpu_torch.postfx import tonemap as ttone
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W = 64, 128
NEAR = 1e-5            # relative distance of a tested value to its threshold


def make_camera(eye=(0, 2, 6)):
    view = jm3.look_at(list(eye), [0, 0, 0])
    proj = jm3.perspective(1.0, W / H, 0.5, 50.0)
    return CameraAttribs.create(view, proj, list(eye), 0.5, 50.0, W, H)


def _near(value, threshold):
    return np.abs(value - threshold) <= NEAR * abs(threshold)


def _assert_close_but_flips(got, want, flippable, label, atol=1e-5):
    """Colour within `atol` but on pixels where a threshold test may flip
    (`flippable`, (H, W) bool); returns the count of such pixels that
    differ, printed with the largest difference elsewhere."""
    diff = np.abs(got - want).max(-1)
    bad = diff > atol
    flipped = int(bad.sum())
    print(f"{label}: {flipped} pixels flipped a threshold test, the others "
          f"within {diff[~bad].max():.3g}")
    assert not (bad & ~flippable).any(), (
        label, np.argwhere(bad & ~flippable)[:5])
    return flipped


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def _masks():
    block = np.zeros((H, W), bool)
    block[30:34, 60:64] = True
    rng = np.random.default_rng(3)
    sparse = rng.random((H, W)) < 0.004
    blobs = np.zeros((H, W), bool)
    blobs[5:9, 3:40] = True
    blobs[50:64, 100:128] = True        # touches the frame's corner
    return {"block": block, "sparse": sparse, "blobs": blobs,
            "none": np.zeros((H, W), bool)}


@pytest.mark.parametrize("name", ["block", "sparse", "blobs", "none"])
def test_jump_flood_and_outline_exact(name):
    """closest_selected_location and selection_outline equal the JAX
    package's bit for bit, and the JAX test's checks hold on the port."""
    sel = _masks()[name]
    want = np.asarray(jsel.closest_selected_location(jnp.asarray(sel)))
    got = tsel.closest_selected_location(torch.from_numpy(sel)).numpy()
    np.testing.assert_array_equal(got, want)
    color = np.random.default_rng(1).random((H, W, 3)).astype(np.float32)
    want = np.asarray(jsel.selection_outline(jnp.asarray(color),
                                             jnp.asarray(sel),
                                             outline_width=2.0))
    got = tsel.selection_outline(torch.from_numpy(color),
                                 torch.from_numpy(sel),
                                 outline_width=2.0).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "block":
        np.testing.assert_array_equal(
            tsel.closest_selected_location(torch.from_numpy(sel))[31, 61],
            [61.0, 31.0])
        assert got[30, 58, 0] == 1.0 and (got[31, 61] == color[31, 61]).all()
    if name == "none":
        assert (got == color).all()


def test_desaturate_and_outline_colour_match_jax():
    """desaturate_unselected and reverse_exp_tone_map (the outline colour's
    pre-compensation, at several exposures and past the 0.99 clamp)."""
    rng = np.random.default_rng(2)
    color = (rng.random((H, W, 3)) * 2.0).astype(np.float32)
    sel = _masks()["blobs"]
    want = np.asarray(jsel.desaturate_unselected(jnp.asarray(color),
                                                 jnp.asarray(sel), 0.5))
    got = tsel.desaturate_unselected(torch.from_numpy(color),
                                     torch.from_numpy(sel), 0.5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert (got[sel] == color[sel]).all()
    c = np.array([0.95, 0.6, 0.1, 0.999, 0.0], np.float32)
    for lum in (0.05, 0.3, 2.0):
        want = np.asarray(jtone.reverse_exp_tone_map(jnp.asarray(c),
                                                     ave_log_lum=lum))
        got = ttone.reverse_exp_tone_map(torch.from_numpy(c),
                                         ave_log_lum=torch.tensor(lum))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# depth range
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reversed_z", [False, True])
@pytest.mark.parametrize("case", ["two_blocks", "empty", "random"])
def test_depth_range_matches_jax(case, reversed_z):
    """compute_depth_range within 1e-6 relative, field by field."""
    bg = 0.0 if reversed_z else 1.0
    depth = np.full((H, W), bg, np.float32)
    if case == "two_blocks":
        depth[10:20, 10:20] = 0.3
        depth[30:40, 30:40] = 0.8
    elif case == "random":
        rng = np.random.default_rng(4)
        depth = np.where(rng.random((H, W)) < 0.6,
                         rng.uniform(0.9, 0.999, (H, W)), bg
                         ).astype(np.float32)
    cam = make_camera()
    want = jdr.compute_depth_range(jnp.asarray(depth), cam,
                                   background_depth=bg, reversed_z=reversed_z)
    got = tdr.compute_depth_range(torch.from_numpy(depth),
                                  cv.camera_from_jax(cam),
                                  background_depth=bg, reversed_z=reversed_z)
    for f in tdr.DepthRange._fields:
        g, w = float(getattr(got, f)), float(getattr(want, f))
        assert np.isfinite(g), f
        assert g == pytest.approx(w, rel=1e-6), f
    if case == "two_blocks" and not reversed_z:
        assert float(got.scene_near_depth) == pytest.approx(0.3)
        assert float(got.scene_near_z) < float(got.scene_far_z)


# ---------------------------------------------------------------------------
# env map, bound box, grid, vector field
# ---------------------------------------------------------------------------


def test_env_map_matches_jax():
    """render_env_map of the JAX test's two-tone sky, plain, tone mapped
    with sRGB, and at a blurrier mip of a two-level chain."""
    d = oct_pixel_dirs(32)
    env = np.asarray(jnp.where(d[..., 1:2] > 0, 2.0, 0.1)
                     * jnp.ones((1, 1, 3)))
    env2 = env.reshape(16, 2, 16, 2, 3).mean((1, 3))
    cam = make_camera()
    from diligentfx_tpu.config import ToneMappingMode as JTM
    from diligentfx_tpu_torch.config import ToneMappingMode as TTM
    for kw_j, kw_t, mips in (
            ({}, {}, 1),
            (dict(tone_mapping_mode=JTM.UNCHARTED2, convert_to_srgb=True),
             dict(tone_mapping_mode=TTM.UNCHARTED2, convert_to_srgb=True), 1),
            (dict(mip_level=0.6, scale=1.5), dict(mip_level=0.6, scale=1.5),
             2)):
        jm = [jnp.asarray(env), jnp.asarray(env2)][:mips]
        tm = [torch.from_numpy(env), torch.from_numpy(env2)][:mips]
        want = np.asarray(jren.render_env_map(jm, cam, W, H, **kw_j))
        got = tren.render_env_map(tm, cv.camera_from_jax(cam), W, H,
                                  **kw_t).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[:8].mean() > got[-8:].mean() * 2 or mips == 2


def _screen_corners(cam, box_min, box_max, transform=None):
    """The box corners' screen x, y, NDC z, float64 (render_bound_box's
    projection)."""
    mn, mx = np.asarray(box_min, np.float64), np.asarray(box_max, np.float64)
    c = np.array([[mx[0] if i & 1 else mn[0], mx[1] if i & 2 else mn[1],
                   mx[2] if i & 4 else mn[2], 1.0] for i in range(8)])
    if transform is not None:
        c = c @ np.asarray(transform, np.float64)
        c = np.concatenate([c[:, :3], np.ones((8, 1))], 1)
    clip = c @ np.asarray(cam.view_proj, np.float64)
    ndc = clip[:, :3] / np.maximum(clip[:, 3:4], 1e-6)
    return ((ndc[:, 0] * 0.5 + 0.5) * W, (0.5 - ndc[:, 1] * 0.5) * H,
            ndc[:, 2])


def _bound_box_flippable(cam, box_min, box_max, depth, transform=None):
    sx, sy, sz = _screen_corners(cam, box_min, box_max, transform)
    yg, xg = np.mgrid[0:H, 0:W] + 0.5
    out = np.zeros((H, W), bool)
    for a, b in tren.BOX_EDGES:
        dx, dy = sx[b] - sx[a], sy[b] - sy[a]
        len2 = max(dx * dx + dy * dy, 1e-6)
        t = np.clip(((xg - sx[a]) * dx + (yg - sy[a]) * dy) / len2, 0, 1)
        d2 = (xg - sx[a] - t * dx) ** 2 + (yg - sy[a] - t * dy) ** 2
        frac = np.mod(t * np.sqrt(len2) / 16.0, 1.0)
        z = sz[a] + t * (sz[b] - sz[a])
        out |= (_near(d2, 1.0) | _near(frac, 0.75) | _near(frac, 1.0)
                | (frac <= NEAR) | _near(z, depth + 1e-3))
    return out


@pytest.mark.parametrize("case", ["open", "occluded", "transformed",
                                  "scene_depth"])
def test_bound_box_matches_jax(case):
    """render_bound_box over a black frame: the JAX test's box in front of
    a far depth buffer and behind a near one, a rotated and moved box, and
    a box against a random depth buffer (its edges part hidden)."""
    cam = make_camera()
    rng = np.random.default_rng(6)
    color = np.zeros((H, W, 3), np.float32)
    depth = np.ones((H, W), np.float32)
    box = ([-1, -1, -1], [1, 1, 1])
    transform = None
    if case == "occluded":
        depth[:] = 0.0
    elif case == "transformed":
        a = 0.6
        transform = np.array([[np.cos(a), 0, -np.sin(a), 0], [0, 1, 0, 0],
                              [np.sin(a), 0, np.cos(a), 0],
                              [0.3, 0.4, -0.5, 1]], np.float32)
        color = rng.random((H, W, 3)).astype(np.float32)
    elif case == "scene_depth":
        depth = rng.uniform(0.97, 1.0, (H, W)).astype(np.float32)
    want = np.asarray(jren.render_bound_box(
        jnp.asarray(color), jnp.asarray(depth), cam, *box,
        transform=None if transform is None else jnp.asarray(transform)))
    got = tren.render_bound_box(
        torch.from_numpy(color), torch.from_numpy(depth),
        cv.camera_from_jax(cam), *box,
        transform=None if transform is None else torch.from_numpy(transform)
    ).numpy()
    _assert_close_but_flips(got, want, _bound_box_flippable(
        cam, *box, depth, transform), f"bound box ({case})")
    if case == "open":
        assert got.max() > 0.5 and (got.sum(-1) > 0).sum() < H * W * 0.2
    if case == "occluded":
        assert got.max() == 0.0


def _grid_flippable(cam, depth):
    """gz <= depth and the axis colour's axis_x / axis_z > 0.5, float64."""
    vp = np.asarray(cam.view_proj, np.float64)
    inv = np.linalg.inv(vp)
    yg, xg = np.mgrid[0:H, 0:W] + 0.5
    ndc = np.stack([xg / W * 2 - 1, 1 - yg / H * 2, np.full_like(xg, 0.5),
                    np.ones_like(xg)], -1)
    world = ndc @ inv
    eye = np.asarray(cam.position, np.float64)
    ray = world[..., :3] / world[..., 3:] - eye
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    ry = np.where(np.abs(ray[..., 1]) < 1e-6, 1e-6, ray[..., 1])
    t = -eye[1] / ry
    p = eye + ray * t[..., None]
    foot = np.maximum(t * 2.0 / (H * abs(float(cam.proj[1, 1]))), 1e-6)
    clip = np.concatenate([p, np.ones_like(p[..., :1])], -1) @ vp
    gz = clip[..., 2] / np.maximum(clip[..., 3], 1e-6)
    axis = [np.clip(1 - np.abs(c) / foot, 0, 1) for c in (p[..., 2],
                                                        p[..., 0])]
    return (_near(gz, depth) | _near(axis[0], 0.5) | _near(axis[1], 0.5))


@pytest.mark.parametrize("eye", [(0, 2, 6), (3, 1, -5)])
def test_coordinate_grid_matches_jax(eye):
    """render_coordinate_grid over a frame of random colour and depth; the
    grid shows below the horizon only."""
    cam = make_camera(eye)
    rng = np.random.default_rng(8)
    color = rng.random((H, W, 3)).astype(np.float32) * 0.2
    depth = np.where(rng.random((H, W)) < 0.3, rng.uniform(0.9, 1.0, (H, W)),
                     1.0).astype(np.float32)
    want = np.asarray(jren.render_coordinate_grid(jnp.asarray(color),
                                                  jnp.asarray(depth), cam))
    got = tren.render_coordinate_grid(torch.from_numpy(color),
                                      torch.from_numpy(depth),
                                      cv.camera_from_jax(cam)).numpy()
    assert np.isfinite(got).all()
    _assert_close_but_flips(got, want, _grid_flippable(cam, depth),
                            f"coordinate grid (eye {eye})", atol=1e-4)
    changed = np.abs(got - color).max(-1) > 1e-3
    assert changed[-16:].sum() > changed[:16].sum() and changed.any()


def _field_flippable(field, attribs):
    """d2 < 1 of any segment, float64."""
    segs = tren.vector_field_segments(torch.from_numpy(field), H, W,
                                      attribs).double().numpy()
    yg, xg = np.mgrid[0:H, 0:W] + 0.5
    out = np.zeros((H, W), bool)
    for ax, ay, bx, by in segs:
        dx, dy = bx - ax, by - ay
        len2 = max(dx * dx + dy * dy, 1e-6)
        t = np.clip(((xg - ax) * dx + (yg - ay) * dy) / len2, 0, 1)
        out |= _near((xg - ax - t * dx) ** 2 + (yg - ay - t * dy) ** 2, 1.0)
    return out


@pytest.mark.parametrize("case", ["uniform", "random"])
def test_vector_field_matches_jax(case):
    """render_vector_field against the JAX package's scan: the JAX test's
    uniform field on an 8 x 8 grid, and a random field on the default 32
    (here 8, at least 8 px apart) with segments that overlap and leave the
    frame."""
    if case == "uniform":
        field = np.full((H, W, 2), 0.02, np.float32)
        attribs = (jren.VectorFieldAttribs(grid_size=8),
                   tren.VectorFieldAttribs(grid_size=8))
    else:
        field = np.random.default_rng(9).normal(0, 0.08, (H, W, 2)).astype(
            np.float32)
        attribs = (jren.VectorFieldAttribs(), tren.VectorFieldAttribs())
    color = np.random.default_rng(10).random((H, W, 3)).astype(np.float32)
    want = np.asarray(jren.render_vector_field(jnp.asarray(color),
                                               jnp.asarray(field),
                                               attribs[0]))
    got = tren.render_vector_field(torch.from_numpy(color),
                                   torch.from_numpy(field),
                                   attribs[1]).numpy()
    _assert_close_but_flips(got, want, _field_flippable(field, attribs[1]),
                            f"vector field ({case})")
    drawn = np.abs(got - color).max(-1) > 0
    assert drawn.sum() > 8 * 8


@pytest.mark.parametrize("seed,shape,sigma,grid", [
    (0, (64, 128), 0.02, 32), (1, (67, 131), 0.2, 32),
    (2, (128, 96), 0.6, 16), (3, (40, 40), 0.05, 32),
    (4, (100, 60), 1.5, 8), (5, (64, 128), 0.0, 32)])
def test_vector_field_equals_sequential(seed, shape, sigma, grid):
    """The vectorised render_vector_field equals render_vector_field_plain
    bit for bit on random fields: segments that overlap, cross each other
    and leave the frame (sigma up to 1.5 frame widths), zero-length
    segments, odd frame sizes."""
    rng = np.random.default_rng(seed)
    h, w = shape
    field = torch.from_numpy(rng.normal(0, sigma, (h, w, 2)).astype(
        np.float32))
    color = torch.from_numpy(rng.random((h, w, 3)).astype(np.float32))
    attribs = tren.VectorFieldAttribs(grid_size=grid)
    plain = tren.render_vector_field_plain(color, field, attribs)
    got = tren.render_vector_field(color, field, attribs)
    assert torch.equal(got, plain)
    assert bool((got != color).any())
    segs = tren.vector_field_segments(field, h, w, attribs)
    if sigma > 0.5:
        outside = ((segs[:, 2] < 0) | (segs[:, 2] >= w) | (segs[:, 3] < 0)
                   | (segs[:, 3] >= h))
        assert bool(outside.any())


def test_coordinate_grid_horizon_is_finite():
    """Rays just above the horizon (t below -4435 m): the JAX package's
    fade overflows there and its grid turns those pixels NaN; the port
    keeps their colour, and equals the JAX grid on every other pixel."""
    eye = (0.0, 2.0, 6.0)
    # pitched so that row 31's rays climb by about 2e-4: t = -2 / 2e-4
    target = [0.0, 2.0 - 6.0 * (np.tan(0.5) / 64 - 2e-4), 0.0]
    cam = CameraAttribs.create(jm3.look_at(list(eye), target),
                               jm3.perspective(1.0, W / H, 0.5, 50.0),
                               list(eye), 0.5, 50.0, W, H)
    color = np.full((H, W, 3), 0.25, np.float32)
    depth = np.ones((H, W), np.float32)
    want = np.asarray(jren.render_coordinate_grid(jnp.asarray(color),
                                                  jnp.asarray(depth), cam))
    got = tren.render_coordinate_grid(torch.from_numpy(color),
                                      torch.from_numpy(depth),
                                      cv.camera_from_jax(cam)).numpy()
    nan = np.isnan(want).any(-1)
    print(f"grid at the horizon: {nan.sum()} JAX pixels NaN")
    assert nan.any() and np.isfinite(got).all()
    assert (got[nan] == color[nan]).all()
    _assert_close_but_flips(got[~nan][None], want[~nan][None],
                            _grid_flippable(cam, depth)[~nan][None],
                            "coordinate grid at the horizon", atol=1e-4)
