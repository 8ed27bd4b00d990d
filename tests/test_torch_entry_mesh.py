"""The port's dry run picks its mesh by the dry run's own rule
(__graft_entry__.py:126-127: sp 4 where 4 divides the device count n,
else 2 where 2 does, else 1; dp n / sp), on meshes of the CPU repeated.

The rule is read from __graft_entry__.py's own line and evaluated for
each n; `entry.dryrun(devices=["cpu"] * n)` must print that mesh and run.
On 3 and 6 devices (dp 3: three views) its loss is held against the JAX
dry run's step, built from its lines (as tests/test_torch_inverse.py
does) with three views, jitted once: within 1e-5 relative (measured
3.3e-7).  The gradient flows through the port's plain shading.
"""
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as graft
from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import CameraAttribs
from diligentfx_tpu.config import DebugViewType, ToneMappingMode
from diligentfx_tpu.pbr.renderer import _render_frame
from diligentfx_tpu_torch import entry
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRAFT = pathlib.Path(graft.__file__)
SIZE = 64
COUNTS = (1, 2, 3, 4, 5, 6, 8)


def _jax_rule(n):
    """(dp, sp) by __graft_entry__.py's own `sp = ...` line of
    dryrun_multichip, evaluated with n_devices = n."""
    src = GRAFT.read_text()
    body = src[src.index("def dryrun_multichip"):]
    line = re.search(r"^\s*sp = (.+)$", body, re.M).group(1)
    assert "n_devices" in line, line
    sp = eval(line, {}, {"n_devices": n})
    assert "dp=n_devices // sp" in body
    return n // sp, sp


@pytest.mark.parametrize("n", COUNTS)
def test_dryrun_mesh_is_the_dry_runs(n):
    dp, sp = _jax_rule(n)
    mesh = entry.dryrun_mesh(["cpu"] * n)
    assert mesh.shape == {"dp": dp, "sp": sp}
    assert mesh.size == n


@pytest.fixture(scope="module")
def jax_three_views():
    """The JAX dry run's loss with dp = 3 views (:129-151), unsharded."""
    renderer, scene, info, cfg, size = graft._build_small(
        size=SIZE, sphere_res=6, ibl=False)

    def make_cam(angle):
        eye = jnp.stack([4.0 * jnp.sin(angle), jnp.float32(0.5),
                         4.0 * jnp.cos(angle)])
        return CameraAttribs.create(jm3.look_at(eye, [0.0, 0.0, 0.0]),
                                    jm3.perspective(0.7, 1.0, 0.1, 50.0),
                                    eye, 0.1, 50.0, size, size)

    render = functools.partial(
        _render_frame, width=size, height=size, cfg=cfg, use_ibl=False,
        use_lights=True, debug_view=DebugViewType.NONE,
        tone_mapping_mode=ToneMappingMode.NONE, convert_output_to_srgb=False)

    def render_one(base_color, cam):
        s = scene._replace(materials=scene.materials.replace(
            base_color_factor=base_color))
        return render(s, info._replace(camera=cam), renderer.ibl_maps,
                      renderer.env_oct)

    def loss_fn(params, cams, targets):
        imgs = jax.vmap(render_one, in_axes=(None, 0))(params, cams)
        return jnp.mean((imgs - targets) ** 2)

    cams = jax.vmap(make_cam)(jnp.linspace(0.0, 1.0, 3))
    targets = jnp.zeros((3, size, size, 3), jnp.float32) + 0.5
    return float(jax.jit(loss_fn)(scene.materials.base_color_factor, cams,
                                  targets))


@pytest.mark.parametrize("n", COUNTS)
def test_dryrun_runs_on_the_dry_runs_mesh(n, capsys, request):
    dp, sp = _jax_rule(n)
    res = entry.dryrun(devices=["cpu"] * n)
    assert f"mesh={ {'dp': dp, 'sp': sp} }" in capsys.readouterr().out
    assert res.grads.shape == res.new_params.shape
    assert np.isfinite(float(res.loss))
    if n in (3, 6):
        ref = request.getfixturevalue("jax_three_views")
        assert abs(float(res.loss) - ref) <= 1e-5 * abs(ref), (res.loss, ref)


def test_dryrun_without_cuda_or_devices_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="devices="):
        entry.dryrun()
