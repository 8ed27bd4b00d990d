"""The inverse-rendering step and the entry frame of the port
(diligentfx_tpu_torch/entry.py) against __graft_entry__.py on the CPU.

The JAX step is dryrun_multichip's (__graft_entry__.py:129-172), built here
from its own lines: the dry run's scene (`_build_small(size=64,
sphere_res=6, ibl=False)`), two views from `make_cam`, targets of 0.5, the
gradient of the mean squared error with respect to the materials' base
colours.  It runs jitted twice: unsharded under jax.value_and_grad, and as
the dry run jits its train_step, with the views over dp and the image rows
over sp of an 8-device mesh (tests/conftest.py's virtual CPU devices).
The port renders each view's row bands through the two-pass raster (K4's
plain version here) and the plain shading, one process driving a mesh of
the CPU repeated.

Bounds: the loss within 1e-5 relative; gradients and updated parameters
within 1e-4 of the largest |gradient| (the jitted JAX frame contracts
multiply-adds; its eager and jitted forms differ by 1.2e-7 in the small
entries of material 2, so no entry-by-entry relative bound), every value
finite.  Between mesh shapes the port sums the same terms in another
order: 1e-6 relative on the loss, 1e-6 of the largest |gradient|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as graft
from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import CameraAttribs as JaxCamera
from diligentfx_tpu.config import DebugViewType, ToneMappingMode
from diligentfx_tpu.parallel.mesh import make_render_mesh as jax_mesh
from diligentfx_tpu.pbr.renderer import _render_frame as jax_render_frame
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch import entry as pe
from diligentfx_tpu_torch.attribs import CameraAttribs as PortCamera
from diligentfx_tpu_torch.config import DebugViewType as PortDV
from diligentfx_tpu_torch.config import RasterizerConfig as PortCfg
from diligentfx_tpu_torch.config import ToneMappingMode as PortTM
from diligentfx_tpu_torch.parallel import tiling
from diligentfx_tpu_torch.parallel.mesh import make_render_mesh
from diligentfx_tpu_torch.pbr.renderer import _render_frame
from diligentfx_tpu_torch.utils.image import psnr
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZE, B = 64, 2


def _jax_make_cam(angle):
    """__graft_entry__.py:129-134."""
    eye = jnp.stack([4.0 * jnp.sin(angle), jnp.float32(0.5),
                     4.0 * jnp.cos(angle)])
    view = jm3.look_at(eye, [0.0, 0.0, 0.0])
    proj = jm3.perspective(0.7, 1.0, 0.1, 50.0)
    return JaxCamera.create(view, proj, eye, 0.1, 50.0, SIZE, SIZE)


@pytest.fixture(scope="module")
def jx():
    """The JAX dry run's step, unsharded and sharded (:136-172)."""
    renderer, scene, info, cfg, size = graft._build_small(
        size=SIZE, sphere_res=6, ibl=False)
    cams = jax.vmap(_jax_make_cam)(jnp.linspace(0.0, 1.0, B))
    render = functools.partial(
        jax_render_frame, width=size, height=size, cfg=cfg, use_ibl=False,
        use_lights=True, debug_view=DebugViewType.NONE,
        tone_mapping_mode=ToneMappingMode.NONE, convert_output_to_srgb=False)

    def render_one(base_color, cam):
        s = scene._replace(materials=scene.materials.replace(
            base_color_factor=base_color))
        return render(s, info._replace(camera=cam), renderer.ibl_maps,
                      renderer.env_oct)

    def loss_fn(params, cams_, targets):
        imgs = jax.vmap(render_one, in_axes=(None, 0))(params, cams_)
        return jnp.mean((imgs - targets) ** 2)

    def train_step(params, cams_, targets):
        loss, grads = jax.value_and_grad(loss_fn)(params, cams_, targets)
        return params - 0.1 * grads, loss

    params = scene.materials.base_color_factor
    targets = jnp.zeros((B, size, size, 3), jnp.float32) + 0.5
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, cams, targets)

    mesh = jax_mesh(8, dp=2, sp=4, devices=jax.devices()[:8])
    img_sharding = NamedSharding(mesh, P("dp", "sp"))
    repl = NamedSharding(mesh, P())
    cam_sharding = jax.tree.map(lambda _: NamedSharding(mesh, P("dp")), cams)
    step = jax.jit(train_step, in_shardings=(repl, cam_sharding, img_sharding),
                   out_shardings=(repl, repl))
    s_params, s_loss = step(jax.device_put(params, repl),
                            jax.device_put(cams, cam_sharding),
                            jax.device_put(targets, img_sharding))
    return dict(renderer=renderer, scene=scene, info=info, cfg=cfg,
                cams=cams, params=np.asarray(params), loss=float(loss),
                grads=np.asarray(grads), sharded_loss=float(s_loss),
                sharded_params=np.asarray(s_params))


@pytest.fixture(scope="module")
def port(jx):
    """The port's problem on the same scene, views and targets."""
    problem = pe.InverseProblem(
        scene=cv.scene_from_jax(jx["scene"]),
        info=cv.render_info_from_jax(jx["info"]),
        env_oct=cv.tensor(jx["renderer"].env_oct),
        cfg=cv.raster_config_from_jax(jx["cfg"]), width=SIZE, height=SIZE)
    return dict(problem=problem, cams=cv.cameras_from_jax(jx["cams"]),
                params=problem.scene.materials.base_color_factor,
                targets=torch.full((B, SIZE, SIZE, 3), 0.5))


def _cpu_mesh(dp, sp):
    return make_render_mesh(dp=dp, sp=sp, devices=["cpu"] * (dp * sp))


def _assert_step_close(loss, grads, ref_loss, ref_grads):
    scale = float(np.abs(ref_grads).max())
    assert np.isfinite(loss) and np.isfinite(grads).all()
    assert scale > 1e-3
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)
    np.testing.assert_allclose(grads, ref_grads, rtol=0, atol=1e-4 * scale)


def test_loss_and_grads_match_jax_value_and_grad(jx, port):
    """The port on a 1 x 1 mesh against jax.jit(jax.value_and_grad)."""
    loss, grads = pe.loss_and_grad(port["params"], port["cams"],
                                   port["targets"], _cpu_mesh(1, 1),
                                   port["problem"])
    _assert_step_close(float(loss), grads.numpy(), jx["loss"], jx["grads"])
    new, loss2 = pe.train_step(port["params"], port["cams"], port["targets"],
                               _cpu_mesh(1, 1), port["problem"])
    assert float(loss2) == float(loss)
    np.testing.assert_allclose(
        new.numpy(), jx["params"] - 0.1 * jx["grads"], rtol=0,
        atol=1e-4 * float(np.abs(jx["grads"]).max()))
    assert not new.requires_grad


def test_sharded_step_matches_jax_train_step(jx, port):
    """The port on dp 2 x sp 4 (the CPU 8 times) against the dry run's
    train_step jitted with its shardings on 8 devices."""
    new, loss = pe.train_step(port["params"], port["cams"], port["targets"],
                              _cpu_mesh(2, 4), port["problem"])
    scale = float(np.abs(jx["grads"]).max())
    assert np.isfinite(new.numpy()).all()
    assert abs(float(loss) - jx["sharded_loss"]) <= 1e-5 * jx["sharded_loss"]
    np.testing.assert_allclose(new.numpy(), jx["sharded_params"], rtol=0,
                               atol=1e-4 * scale)


@pytest.fixture(scope="module")
def one_by_one(port):
    return pe.loss_and_grad(port["params"], port["cams"], port["targets"],
                            _cpu_mesh(1, 1), port["problem"])


@pytest.mark.parametrize("dp,sp", [(1, 1), (2, 1), (1, 4), (2, 4)])
def test_mesh_shapes_agree(port, one_by_one, dp, sp):
    loss, grads = pe.loss_and_grad(port["params"], port["cams"],
                                   port["targets"], _cpu_mesh(dp, sp),
                                   port["problem"])
    ref_loss, ref_grads = one_by_one
    assert torch.isfinite(grads).all()
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * float(ref_loss)
    np.testing.assert_allclose(grads.numpy(), ref_grads.numpy(), rtol=0,
                               atol=1e-6 * float(ref_grads.abs().max()))


@pytest.mark.parametrize("width,height,bands", [
    (64, 64, 4), (64, 64, 8), (100, 60, 3)])
def test_banded_forward_pads_any_viewport(port, width, height, bands):
    """render_forward_banded (and render_one) at viewports that are no
    multiple of the 8 x 128 tile, against _render_frame's two-pass branch
    (which pads and crops); 60 rows pad to 8 tile rows in bands of 3, 3
    and 2."""
    prob = port["problem"]
    info = prob.info._replace(camera=pe.make_cam(0.3, width, height,
                                                 device="cpu"))
    ref = _render_frame(prob.scene, info, None, prob.env_oct, width=width,
                        height=height, cfg=prob.cfg, use_ibl=False,
                        use_lights=True, debug_view=PortDV.NONE,
                        tone_mapping_mode=PortTM.NONE,
                        convert_output_to_srgb=False, fuse="off")
    mesh = _cpu_mesh(1, bands)
    parts, img = tiling.render_forward_banded(
        prob.scene, info, None, prob.env_oct, mesh, width=width,
        height=height, cfg=prob.cfg, use_ibl=False)
    assert img.shape == ref.shape == (height, width, 3)
    assert len(parts) == bands and sum(p.shape[0] for p in parts) == height
    assert torch.isfinite(img).all()
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    one = pe.render_one(prob.scene.materials.base_color_factor, info.camera,
                        prob._replace(width=width, height=height),
                        devices=mesh.devices[0])
    np.testing.assert_allclose(one.numpy(), ref.numpy(), rtol=0, atol=1e-6)


def test_band_layout():
    cfg = PortCfg(tile_h=8, tile_w=128)
    assert tiling.band_layout(64, 4, cfg) == [(0, 16), (16, 16), (32, 16),
                                               (48, 16)]
    assert tiling.band_layout(60, 3, cfg) == [(0, 24), (24, 24), (48, 16)]
    assert tiling.band_layout(1088, 1, cfg) == [(0, 1088)]
    with pytest.raises(ValueError, match="fewer than"):
        tiling.band_layout(16, 3, cfg)


def test_fused_route_refuses_material_grad(port):
    """K1 fetches the material table in the kernel, without a gradient:
    _render_frame raises where the fused route meets a material that
    requires grad, on every device, and the two-pass route carries it."""
    prob = port["problem"]
    params = prob.scene.materials.base_color_factor.clone().requires_grad_()
    scene = pe._with_params(prob.scene, params)
    info = prob.info._replace(camera=port["cams"][0])
    kw = dict(width=SIZE, height=SIZE, cfg=prob.cfg, use_ibl=False,
              use_lights=True, debug_view=PortDV.NONE,
              tone_mapping_mode=PortTM.NONE, convert_output_to_srgb=False)
    with pytest.raises(ValueError, match='fuse="off"'):
        _render_frame(scene, info, None, prob.env_oct, fuse="on", **kw)
    with torch.no_grad():
        fused = _render_frame(scene, info, None, prob.env_oct, fuse="on",
                              **kw)
    img = _render_frame(scene, info, None, prob.env_oct, fuse="off", **kw)
    img.sum().backward()
    assert params.grad is not None and float(params.grad.abs().max()) > 0
    assert torch.isfinite(fused).all()


def test_entry_matches_jax_entry():
    """entry() on the CPU against the JAX entry() frame (128 x 128, IBL
    maps of the dry run's sizes, each package its own), jitted, at
    tests/test_torch_frame.py's 50 dB."""
    fn, args = graft.entry()
    ref = np.asarray(jax.jit(fn)(*args))
    pfn, pargs = pe.entry(device="cpu")
    out = pfn(*pargs)
    assert out.shape == ref.shape == (128, 128, 3)
    assert torch.isfinite(out).all()
    assert psnr(ref, out.numpy()) > 50.0, psnr(ref, out.numpy())


def test_cameras_from_jax_round_trip(jx):
    cams = cv.cameras_from_jax(jx["cams"])
    assert len(cams) == B
    for f in PortCamera._fields:
        np.testing.assert_array_equal(
            torch.stack([getattr(c, f) for c in cams]).numpy(),
            np.asarray(getattr(jx["cams"], f)))
    # the port's own make_cam: the same cameras to float32 rounding
    mine = pe.make_cams(np.linspace(0.0, 1.0, B, dtype=np.float32),
                        width=SIZE, device="cpu")
    for a, b in zip(mine, cams):
        for f in ("view_proj", "view_proj_inv", "position"):
            np.testing.assert_allclose(getattr(a, f).numpy(),
                                       getattr(b, f).numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_dryrun_on_a_cpu_mesh(jx, monkeypatch, capsys):
    """dryrun on dp 2 x sp 4 of the CPU: the sharded JAX step's loss and
    parameters; without CUDA and without devices= it raises."""
    r = pe.dryrun(_cpu_mesh(2, 4))
    assert "dryrun OK" in capsys.readouterr().out
    assert abs(float(r.loss) - jx["sharded_loss"]) <= 1e-5 * jx["sharded_loss"]
    np.testing.assert_allclose(
        r.new_params.numpy(), jx["sharded_params"], rtol=0,
        atol=1e-4 * float(np.abs(jx["grads"]).max()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.dryrun()
