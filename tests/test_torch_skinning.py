"""Parity of the port's skinning and glTF animation with the JAX package on
the CPU: the host animation (diligentfx_tpu_torch/gltf/animation.py
_sample, AnimationPlayer.evaluate, compute_skin_matrices), the skinned
scene (gltf/model.py build_render_scene, update_animation; convert.py
scene_from_jax), the skinned vertex stage (pbr/renderer.py
transform_vertices) and one HnTaskManager.execute frame of a small
skinned, extension-material glTF; plus tests/test_skinning_animation.py's
checks run on the port.

The glTF is chip_smoke.py's ext_skin showroom at a small size (the six
showroom spheres at 6 x 8, one figure of 32 joints on tubes of 4 segments
and a ring a bone: 736 triangles, no atrium), written with chip_smoke.py's
write_glb into tmp_path, so the CPU tests read the file the card's frame
renders at full size.

Tolerances:
  * _sample, evaluate, compute_skin_matrices and every array of
    build_render_scene and update_animation (joints, weights, the
    identity and uploaded joint matrices): bit-equal (numpy on both sides);
  * transform_vertices of the skinned scene: 2e-6 absolute (the JAX
    package blends the joint matrices through an einsum, the port with
    fp32 multiply-adds in the order w0 M[j0] + ... + w3 M[j3]; measured
    4.8e-7);
  * the execute frame: above 90 dB against the JAX frame (measured 104.9
    dB; the JAX frame is jitted, and its raster's FMAs move edge pixels).
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from diligentfx_tpu.gltf import animation as janim
from diligentfx_tpu.gltf import loader as jloader
from diligentfx_tpu.gltf import model as jmodel
from diligentfx_tpu.pbr import renderer as jr
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.gltf import animation as tanim
from diligentfx_tpu_torch.gltf import loader as tloader
from diligentfx_tpu_torch.gltf import model as tmodel
from diligentfx_tpu_torch.pbr import renderer as tr
from tests.test_torch_gltf import assert_scene_equal
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(atrium=False, n_figures=1, sphere=(6, 8), tube=(4, 1),
             normal_size=32)


@pytest.fixture(scope="module")
def showroom(tmp_path_factory):
    """The small showroom .glb loaded by both packages: (path, JAX model,
    port model, the builder's node and material indices)."""
    path, meta = cs.ext_skin_glb(
        str(tmp_path_factory.mktemp("showroom") / "showroom.glb"), **SMALL)
    return path, jloader.load_gltf(path), tloader.load_gltf(path), meta


# ---------------------------------------------------------------------------
# the host animation
# ---------------------------------------------------------------------------


def _channels(seed=0):
    """(path, interpolation, times, values) of the three interpolations:
    STEP, LINEAR (translation, and rotation with slerp: a negative dot
    and a near-parallel pair among the keys) and CUBICSPLINE (translation,
    and rotation, renormalised)."""
    rng = np.random.default_rng(seed)
    t = np.array([0.0, 0.4, 0.5, 1.3, 2.0], np.float32)

    def quats(n):
        q = rng.normal(size=(n, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=1, keepdims=True)
    rot = quats(5)
    rot[2] = -rot[1]                       # opposite hemisphere: negated
    rot[3] = rot[2] + 1e-4                 # near-parallel: lerp branch
    rot[3] /= np.linalg.norm(rot[3])
    return [("translation", "STEP", t, rng.normal(size=(5, 3))),
            ("scale", "STEP", t, rng.uniform(0.5, 2.0, (5, 3))),
            ("translation", "LINEAR", t, rng.normal(size=(5, 3))),
            ("rotation", "LINEAR", t, rot),
            ("translation", "CUBICSPLINE", t, rng.normal(size=(5, 3, 3))),
            ("rotation", "CUBICSPLINE", t,
             np.stack([quats(5), quats(5), quats(5)], 1))]


TIMES = (-0.5, 0.0, 0.2, 0.4, 0.45, 0.5, 0.9, 1.3, 1.99, 2.0, 3.7)


@pytest.mark.parametrize("interp", ["STEP", "LINEAR", "CUBICSPLINE"])
def test_sample_matches_jax(interp):
    """_sample of each channel of `interp` at times before, on, between
    and after the keys: bit-equal."""
    for path, kind, times, values in _channels():
        if kind != interp:
            continue
        values = np.asarray(values, np.float32)
        jc = janim.AnimationChannel(0, path, times, values, kind)
        tc = tanim.AnimationChannel(0, path, times, values, kind)
        for t in TIMES:
            np.testing.assert_array_equal(tanim._sample(tc, t),
                                          janim._sample(jc, t),
                                          err_msg=f"{path} {kind} {t}")


def test_player_and_skin_matrices_match_jax(showroom):
    """AnimationPlayer.evaluate (the recursive world pass, a looped time
    past the 2 s animation, a negative one) and compute_skin_matrices of
    the showroom's skin: bit-equal, and the animation moves the joints."""
    _, jm, tm, _ = showroom
    jp = janim.AnimationPlayer(jm, jm.animations)
    tp = tanim.AnimationPlayer(tm, tm.animations)
    kinds = {c.interpolation for c in tm.animations[0].channels}
    assert kinds == {"STEP", "LINEAR", "CUBICSPLINE"}
    for t in (0.0, 0.37, 1.9, 2.5, 5.1, -0.3):
        jw, tw = jp.evaluate(t), tp.evaluate(t)
        assert len(jw) == len(tw) == len(tm.nodes)
        for a, b in zip(jw, tw):
            np.testing.assert_array_equal(b, a)
        for s in range(len(tm.skins)):
            np.testing.assert_array_equal(
                tanim.compute_skin_matrices(tm, s, tw),
                janim.compute_skin_matrices(jm, s, jw))
    a = tanim.compute_skin_matrices(tm, 0, tp.evaluate(0.0))
    b = tanim.compute_skin_matrices(tm, 0, tp.evaluate(0.5))
    assert np.abs(a - b).max() > 0.05


# ---------------------------------------------------------------------------
# the skinned scene
# ---------------------------------------------------------------------------


def _scenes(showroom):
    """The showroom's RenderScene from both packages (the texture heap)."""
    _, jm, tm, _ = showroom
    return (jmodel.build_render_scene(jm, texture_binding_mode="array"),
            tmodel.build_render_scene(tm, texture_binding_mode="array",
                                      device="cpu"))


def test_build_render_scene_and_update_animation_match_jax(showroom):
    """build_render_scene of the skinned, extension-material showroom (the
    five stacked extension attribs, joints offset per skin and -1 on the
    spheres' vertices, weights normalised, identity joint matrices) and
    update_animation with and without a previous time: every array
    bit-equal to the JAX package's."""
    _, jm, tm, meta = showroom
    ref, got = _scenes(showroom)
    assert_scene_equal(ref, got)
    sc = got.scene
    fig = sc.vertex_node == got.mesh_node_ids.index(meta["figure_nodes"][0])
    assert bool((sc.joints[~fig] == -1).all())
    assert bool((sc.weights[~fig] == 0).all())
    assert int(sc.joints[fig].max()) == cs.EXT_JOINTS - 1
    assert sc.joint_matrices.shape == (cs.EXT_JOINTS, 4, 4)
    jp = janim.AnimationPlayer(jm, jm.animations)
    tp = tanim.AnimationPlayer(tm, tm.animations)
    for t, prev_t in ((0.3, None), (0.3, 0.25), (2.4, 2.3)):
        ref = jmodel.update_animation(ref, jm, jp, t, prev_t)
        got = tmodel.update_animation(got, tm, tp, t, prev_t)
        assert_scene_equal(ref, got)


def test_scene_from_jax_round_trip(showroom):
    """scene_from_jax of the JAX skinned scene equals the port's own
    build_render_scene, the extension attribs and skin arrays included."""
    ref, got = _scenes(showroom)
    conv = cv.scene_from_jax(ref.scene)
    for f in type(conv)._fields:
        a, b = getattr(conv, f), getattr(got.scene, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        if f.startswith("materials"):
            for g in type(a)._fields:
                assert torch.equal(getattr(a, g), getattr(b, g)), (f, g)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("model", [False, True])
def test_transform_vertices_skinned_matches_jax(showroom, model):
    """transform_vertices of the animated showroom, current and previous
    frame (with and without a model transform, which the skinned vertices
    ignore as in the JAX package): the skinned figure and the unskinned
    spheres within 2e-6 of the JAX vertex stage; the figure moved between
    the two frames and the spheres did not."""
    _, jm, tm, meta = showroom
    ref, got = _scenes(showroom)
    ref = jmodel.update_animation(ref, jm, janim.AnimationPlayer(
        jm, jm.animations), 0.6, 0.5)
    got = tmodel.update_animation(got, tm, tanim.AnimationPlayer(
        tm, tm.animations), 0.6, 0.5)
    m = None
    if model:
        m = np.eye(4, dtype=np.float32)
        m[3, :3] = [0.3, -0.2, 0.1]
    out = {}
    for previous in (False, True):
        want = jr.transform_vertices(
            ref.scene, jnp.asarray(m) if model else None, previous=previous)
        have = tr.transform_vertices(
            got.scene, torch.from_numpy(m) if model else None,
            previous=previous)
        for w, h in zip(want, have):
            np.testing.assert_allclose(h.numpy(), np.asarray(w), atol=2e-6,
                                       rtol=0)
        out[previous] = have[0]
    fig = got.scene.vertex_node == got.mesh_node_ids.index(
        meta["figure_nodes"][0])
    moved = (out[False] - out[True]).abs().amax(-1)
    assert float(moved[fig].max()) > 0.01
    assert float(moved[~fig].max()) == 0.0


def test_execute_skinned_extension_frame_matches_jax(showroom):
    """One HnTaskManager.execute frame of the animated showroom at 256 x
    128 (every sphere and the figure in view) with the clear coat on
    (PBRRendererCreateInfo.enable_clear_coat) and the texture heap,
    against the JAX frame: above 90 dB (measured 104.9 dB), and the figure's
    animation and the extensions change the image.  The port takes the
    two-pass route here, as the JAX package does on the CPU: the fused
    route groups K1's derivative channels differently for the texture LOD
    (ROADMAP.md §3), which moves the normal-mapped spheres."""
    from diligentfx_tpu import math3d as jm3
    from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                        PBRRendererShaderParameters)
    from diligentfx_tpu.hydrogent.task_manager import (HnTaskManager,
                                                       TaskManagerCreateInfo)
    from diligentfx_tpu_torch.hydrogent import task_manager as ttm
    from diligentfx_tpu_torch.utils.image import psnr
    from tests.test_torch_material_ext import jax_and_port_renderers
    _, jm, tm, meta = showroom
    ref, got = _scenes(showroom)
    ref = jmodel.update_animation(ref, jm, janim.AnimationPlayer(
        jm, jm.animations), 0.1, 1.0 / 12)
    got = tmodel.update_animation(got, tm, tanim.AnimationPlayer(
        tm, tm.animations), 0.1, 1.0 / 12)
    w, h = 256, 128
    eye = [0.0, 2.5, 14.0]
    info = jr.RenderInfo(
        camera=CameraAttribs.create(jm3.look_at(eye, [0.0, 1.0, 0.0]),
                                    jm3.perspective(0.8, w / h, 0.1, 50.0),
                                    eye, 0.1, 50.0, w, h),
        lights=PBRLightAttribs.directional(cs.FULL_CHAIN_SUN, [4, 4, 4]),
        renderer_params=PBRRendererShaderParameters.create())
    ci = TaskManagerCreateInfo(enable_ssao=False, enable_ssr=False,
                               enable_taa=False, enable_bloom=False)
    ren, port = jax_and_port_renderers(clear_coat=True)
    jtm = HnTaskManager(ren, ci, atlas=ref.atlas)
    want = np.asarray(jtm.execute(ref.scene, info, jtm.initial_state(w, h),
                                  width=w, height=h).color)
    ptm = ttm.HnTaskManager(port, cv.task_manager_ci_from_jax(ci),
                            atlas=cv.heap_from_jax(ref.atlas))
    pinfo = cv.render_info_from_jax(info)

    def frame(scene):
        return ptm.execute(scene, pinfo, ptm.initial_state(w, h), width=w,
                           height=h, fuse="off").color.numpy()
    color = frame(got.scene)
    assert color.shape == (h, w, 3) and np.isfinite(color).all()
    p = psnr(want, color)
    assert p > 90.0, p
    bare = got.scene
    for kind, mat in zip(cs.EXT_KINDS, meta["sphere_materials"]):
        bare = cs._without(bare, kind, mat)
    assert np.abs(frame(bare) - color).max() > 0.05
    later = tmodel.update_animation(got, tm, tanim.AnimationPlayer(
        tm, tm.animations), 0.6, 0.5)
    assert np.abs(frame(later.scene) - color).max() > 0.05


# ---------------------------------------------------------------------------
# tests/test_skinning_animation.py on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def strip():
    """tests/test_skinning_animation.py's two-bone strip (its glTF
    document, parsed by the port's loader)."""
    import tests.test_skinning_animation as tsa
    with mock.patch.object(tsa, "parse_gltf", lambda doc: doc):
        doc = tsa.make_skinned_gltf()
    return tloader.parse_gltf(doc)


def test_port_skinned_model_loads_and_binds(strip):
    assert len(strip.skins) == 1 and len(strip.animations) == 1
    rs = tmodel.build_render_scene(strip, device="cpu")
    assert rs.scene.joints is not None
    assert rs.scene.joint_matrices.shape == (2, 4, 4)


def test_port_animation_player_rotates_joint(strip):
    player = tanim.AnimationPlayer(strip, strip.animations)
    w0, w1 = player.evaluate(0.0), player.evaluate(1.0)
    np.testing.assert_allclose(w0[2][3, :3], [0, 1, 0], atol=1e-5)
    p1 = np.array([1.0, 0.0, 0.0, 1.0], np.float32) @ w1[2]
    np.testing.assert_allclose(p1[:3], [0, 2, 0], atol=1e-4)


def test_port_skinned_vertices_follow_animation(strip):
    rs = tmodel.build_render_scene(strip, device="cpu")
    player = tanim.AnimationPlayer(strip, strip.animations)
    wp0, _, _ = tr.transform_vertices(tmodel.update_animation(
        rs, strip, player, 0.0).scene)
    np.testing.assert_allclose(wp0.numpy(), strip.meshes[0][0].positions,
                               atol=1e-4)
    rs1 = tmodel.update_animation(rs, strip, player, 1.0, prev_t=0.0)
    wp1, _, _ = tr.transform_vertices(rs1.scene)
    np.testing.assert_allclose(wp1.numpy()[4], [-1.0, 0.5, 0.0], atol=1e-3)
    wp_prev, _, _ = tr.transform_vertices(rs1.scene, previous=True)
    assert float((wp1 - wp_prev).abs().max()) > 0.3
