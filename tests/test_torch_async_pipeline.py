"""AsyncFramePipeline in the port (diligentfx_tpu_torch/hydrogent/
async_compile.py) on the CPU: frames are FALLBACK (the fallback pipeline
plus the loading overlay) until the background thread has rendered the
full pipeline's first frame; the first OK frame starts from a fresh state
whatever state the caller passes; an error of the background frame is
raised on the caller's thread.  The background frame is held at a gate so
that the order is deterministic.  The fallback configuration and the
loading overlay equal the JAX package's (the overlay within 1e-6: its
sine)."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu.hydrogent import async_compile as jac
from diligentfx_tpu.hydrogent.task_manager import \
    TaskManagerCreateInfo as JCI
from diligentfx_tpu.postfx.tonemap import loading_animation as j_loading
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.hydrogent import async_compile as tac
from diligentfx_tpu_torch.hydrogent.render_delegate import HnRenderDelegate
from diligentfx_tpu_torch.hydrogent.task_manager import (
    HnTaskManager, TaskManagerCreateInfo)
from diligentfx_tpu_torch.postfx.tonemap import loading_animation
from tests.torch_hydra_ref import small_port_renderer
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = H = 64
CI = TaskManagerCreateInfo(enable_ssr=True, enable_ssao=True,
                           enable_taa=True, enable_bloom=True)


@pytest.fixture(scope="module")
def stage():
    """A one-sphere stage through the port's delegate: (renderer, scene,
    info)."""
    from diligentfx_tpu_torch.gltf.primitives import uv_sphere
    ren = small_port_renderer()
    d = HnRenderDelegate(renderer=ren, device="cpu")
    s = uv_sphere(1.0, stacks=10, slices=14)
    m = d.create_rprim("mesh", "/sphere")
    m.set_points(s.positions)
    m.set_primvar("normals", s.normals)
    m.set_triangles(s.indices)
    d.create_sprim("camera", "/cam").set_params(eye=(0, 0, 3),
                                                target=(0, 0, 0), fov_y=0.8)
    return ren, d.commit_resources(), d.frame_info(W, H)


def _gated(pipe):
    """Hold the pipeline's background frame until the returned event is
    set; returns (gate, thread ids that ran the full pipeline)."""
    gate, threads = threading.Event(), []
    full = pipe.full.execute

    def held(*a, **kw):
        threads.append(threading.get_ident())
        assert gate.wait(120)
        return full(*a, **kw)
    pipe.full.execute = held
    return gate, threads


def test_fallback_ci_matches_jax():
    jci = JCI(enable_dof=True, enable_light_scattering=True)
    want = cv.task_manager_ci_from_jax(jac._fallback_ci(jci))
    got = tac._fallback_ci(cv.task_manager_ci_from_jax(jci))
    assert got == want
    assert [e.name for e in tac.ExecuteResult] == [
        e.name for e in jac.ExecuteResult]


def test_loading_animation_matches_jax():
    c = np.random.default_rng(0).random((40, 72, 3)).astype(np.float32)
    f = np.random.default_rng(1).random((40, 72, 1)).astype(np.float32)
    for factor in (0.15, f):
        a = np.asarray(j_loading(jnp.asarray(c), jnp.asarray(factor),
                                 jnp.float32(7) / 30.0))
        b = loading_animation(torch.from_numpy(c), torch.as_tensor(factor),
                              7 / 30.0).numpy()
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


def test_fallback_then_ok_with_fresh_state(stage):
    ren, scene, info = stage
    pipe = tac.AsyncFramePipeline(ren, CI, width=W, height=H)
    gate, threads = _gated(pipe)
    results, out = [], None
    for _ in range(3):
        out, res = pipe.execute(scene, info, out.state if out else None)
        results.append(res)
    assert results == [tac.ExecuteResult.FALLBACK] * 3
    assert not pipe.full_ready
    assert threads and threads[0] != threading.get_ident()
    # a fallback frame is the fallback pipeline's frame with the overlay
    fb = HnTaskManager(ren, tac._fallback_ci(CI))
    state = fb.initial_state(W, H)
    for _ in range(3):
        ref = fb.execute(scene, info, state, width=W, height=H)
        state = ref.state
    assert out.state.frame_index == 3
    np.testing.assert_array_equal(
        out.color.numpy(), loading_animation(ref.color, 0.15, 3 / 30.0)
        .numpy())
    gate.set()
    assert pipe._ready.wait(120) and pipe.full_ready
    # the first OK frame starts from a fresh state, whatever it is given
    ok, res = pipe.execute(scene, info, out.state)
    assert res == tac.ExecuteResult.OK
    full = HnTaskManager(ren, CI)
    ref = full.execute(scene, info, full.initial_state(W, H), width=W,
                       height=H)
    assert ok.state.frame_index == 1
    np.testing.assert_array_equal(ok.color.numpy(), ref.color.numpy())
    # then the temporal state carries forward
    ok2, res2 = pipe.execute(scene, info, ok.state)
    assert res2 == tac.ExecuteResult.OK
    assert ok2.state.frame_index == 2
    ref2 = full.execute(scene, info, ref.state, width=W, height=H)
    np.testing.assert_array_equal(ok2.color.numpy(), ref2.color.numpy())
    assert np.isfinite(ok2.color.numpy()).all()


def test_no_overlay_and_no_state(stage):
    ren, scene, info = stage
    pipe = tac.AsyncFramePipeline(ren, CI, width=W, height=H,
                                  loading_overlay=False)
    gate, _ = _gated(pipe)
    out, res = pipe.execute(scene, info)
    assert res == tac.ExecuteResult.FALLBACK
    fb = HnTaskManager(ren, tac._fallback_ci(CI))
    ref = fb.execute(scene, info, fb.initial_state(W, H), width=W, height=H)
    np.testing.assert_array_equal(out.color.numpy(), ref.color.numpy())
    gate.set()
    assert pipe._ready.wait(120)
    out, res = pipe.execute(scene, info)
    assert res == tac.ExecuteResult.OK


def test_background_error_raised_on_callers_thread(stage):
    ren, scene, info = stage
    pipe = tac.AsyncFramePipeline(ren, CI, width=W, height=H)
    boom = RuntimeError("the full pipeline failed")
    where = []

    def fail(*a, **kw):
        where.append(threading.get_ident())
        raise boom
    pipe.full.execute = fail
    out, res = pipe.execute(scene, info)       # may still be a fallback
    pipe._ready.wait(120)
    with pytest.raises(RuntimeError) as err:
        pipe.execute(scene, info, out.state)
    assert err.value is boom
    assert where and where[0] != threading.get_ident()
    assert not pipe.full_ready
