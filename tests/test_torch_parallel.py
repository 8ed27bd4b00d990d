"""The port's row-banded rendering (diligentfx_tpu_torch/parallel) on the
CPU: the mesh, the halo exchange, the banded forward frame and the banded
deferred frame, against themselves over band counts and against the JAX
package's parallel/ on its 8 virtual CPU devices (tests/conftest.py).

The port runs every band on the CPU here (a mesh of one device repeated,
the counterpart of XLA's virtual host devices).  The JAX frames run the
JAX package's band function over the band axis of its 4- or 8-device
mesh under `jax.vmap` (`vmap_shard_map`) instead of shard_map: the same
function with the same named-axis collectives (ppermute's partial
permutations give zeros where no band sends, as under shard_map),
evaluated op by op.  Compiled as one shard_map program, the banded
deferred frame takes about ten minutes to compile on one core; this way
about a minute and a half.  The JAX raster stays a compiled program, so
the comparisons carry the ulp-level differences of XLA's contracted
multiply-adds: the forward frame within 1e-3 on 99.5% of the pixels, the
deferred frame above 50 dB (the JAX G-buffer takes the two-pass raster on
the CPU, the port's the fused route).  Between band counts the port is
bit-equal where the JAX package's own tests say its bands are
(tests/test_multichip.py:51-69) and within 2e-3 where they say so
(:122).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRMaterialBasicAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.config import RasterizerConfig, ToneMappingMode
from diligentfx_tpu.gltf.primitives import plane, uv_sphere
from diligentfx_tpu.parallel import mesh as jmesh
from diligentfx_tpu.parallel import tiling as jtiling
from diligentfx_tpu.pbr.renderer import RenderInfo, build_scene
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.config import ToneMappingMode as PortTM
from diligentfx_tpu_torch.parallel import mesh as tmesh
from diligentfx_tpu_torch.parallel import tiling as ttiling
from diligentfx_tpu_torch.utils.image import psnr
from tests.test_torch_material_ext import jax_and_port_renderers
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=512,
                       max_tiles_per_tri=16, big_tri_capacity=16, chunk=8)
PCFG = cv.raster_config_from_jax(CFG)
FRAMES = 2


def _scene():
    """tests/test_multichip.py's spheres over a plane, the blue sphere
    BLEND (the banded OIT).  The plane is cut into 8 x 8 segments: whole,
    it crosses the near plane, whose clip turns a last-bit difference of
    the two packages' clip coordinates into visible depth differences
    (tests/test_torch_editor_frame.py)."""
    sphere = uv_sphere(0.8, 10, 14)
    gn = np.eye(4, dtype=np.float32)
    gn[3, 1] = -1.0
    tn = np.eye(4, dtype=np.float32)
    tn[3, 0] = 1.2
    return build_scene([
        (sphere, np.eye(4, dtype=np.float32),
         PBRMaterialBasicAttribs.create(base_color_factor=(0.8, 0.2, 0.2, 1),
                                        metallic_factor=0.4,
                                        roughness_factor=0.3)),
        (sphere, tn,
         PBRMaterialBasicAttribs.create(base_color_factor=(0.2, 0.5, 0.9, 0.5),
                                        alpha_mode=2, roughness_factor=0.2)),
        (plane(20.0, segments=8), gn, PBRMaterialBasicAttribs.create(
            base_color_factor=(0.4, 0.4, 0.45, 1), roughness_factor=0.7)),
    ])


def _info(w, h):
    eye = [0.0, 1.5, 5.0]
    cam = CameraAttribs.create(jm3.look_at(eye, [0, 0, 0]),
                               jm3.perspective(0.9, w / h, 0.1, 50.0), eye,
                               0.1, 50.0, w, h)
    return RenderInfo(camera=cam,
                      lights=PBRLightAttribs.directional([-0.4, -1.0, -0.3],
                                                         [3, 3, 3]),
                      renderer_params=PBRRendererShaderParameters.create())


@pytest.fixture(scope="module")
def setup():
    ren, port = jax_and_port_renderers()
    scene = _scene()
    return dict(ren=ren, port=port, scene=scene,
                pscene=cv.scene_from_jax(scene))


def vmap_shard_map(f, mesh, in_specs, out_specs, check_rep=False,
                   axis="sp"):
    """shard_map of `f` over the mesh axis `axis` as a jax.vmap with that
    axis name: band-sharded inputs (PartitionSpec over `axis`) split into
    a leading band axis, replicated ones (PartitionSpec()) shared; band-
    sharded outputs concatenated, replicated ones taken from band 0."""
    n = mesh.shape[axis]

    def is_spec(s):
        return s is None or isinstance(s, PartitionSpec)

    def sharded(spec):
        return spec is not None and len(spec) > 0

    def split(spec, x):
        return jax.tree.map(lambda a: a.reshape(
            (n, a.shape[0] // n) + a.shape[1:]), x) if sharded(spec) else x

    def merge(spec, x):
        if spec is None:
            return x
        if not sharded(spec):
            return jax.tree.map(lambda a: a[0], x)
        return jax.tree.map(lambda a: a.reshape(
            (a.shape[0] * a.shape[1],) + a.shape[2:]), x)

    def g(*args):
        in_axes = jax.tree.map(lambda s: 0 if sharded(s) else None,
                               tuple(in_specs), is_leaf=is_spec)
        args = jax.tree.map(split, tuple(in_specs), args, is_leaf=is_spec)
        out = jax.vmap(f, in_axes=in_axes, axis_name=axis,
                       axis_size=n)(*args)
        return jax.tree.map(merge, out_specs, out, is_leaf=is_spec)
    return g


@contextlib.contextmanager
def jax_bands_by_vmap():
    """The JAX package's parallel/tiling.py with vmap_shard_map for
    shard_map, and ppermute taking shard_map's partial permutations
    (destinations without a source receive zeros; vmap's batching rule
    takes only whole permutations)."""
    ppermute = jax.lax.ppermute

    def partial_ppermute(x, axis_name, perm):
        n = jax.lax.axis_size(axis_name)
        perm = list(perm)
        dsts = sorted({d for _, d in perm})
        rest = zip(sorted(set(range(n)) - {s for s, _ in perm}),
                   sorted(set(range(n)) - set(dsts)))
        y = ppermute(x, axis_name, perm + list(rest))
        got = jnp.isin(jax.lax.axis_index(axis_name), jnp.array(dsts))
        return jnp.where(got, y, jnp.zeros_like(y))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtiling, "shard_map", vmap_shard_map)
        mp.setattr(jax.lax, "ppermute", partial_ppermute)
        yield


def _cpu_mesh(n):
    return tmesh.make_render_mesh(devices=["cpu"] * n, dp=1, sp=n)


def test_make_render_mesh(monkeypatch):
    m = tmesh.make_render_mesh(devices=["cpu"] * 8)
    assert m.shape == {"dp": 2, "sp": 4} and m.axis_names == ("dp", "sp")
    assert m.size == 8 and m.devices.shape == (2, 4)
    m = tmesh.make_render_mesh(devices=["cpu"] * 8, dp=1, sp=8)
    assert m.shape == {"dp": 1, "sp": 8}
    assert tmesh.band_sharding(m) == [torch.device("cpu")] * 8
    assert tmesh.replicated(m) == [torch.device("cpu")]
    assert tmesh.make_render_mesh(devices=["cpu"] * 3).shape == {"dp": 1,
                                                                 "sp": 3}
    with pytest.raises(ValueError):
        tmesh.make_render_mesh(devices=["cpu"] * 6, dp=4, sp=2)
    # the JAX mesh's layout
    jm = jmesh.make_render_mesh(8)
    assert cv.mesh_from_jax(jm).shape == dict(jm.shape)
    one = cv.mesh_from_jax(Mesh(np.asarray(jax.devices()[:4]), ("sp",)))
    assert one.shape == {"sp": 4} and len(tmesh.band_sharding(one)) == 4
    # the default devices are the CUDA devices; without CUDA it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_render_mesh()


def test_halo_exchange_bands():
    """tests/test_multichip.py:72-90's expectations, with and without the
    ring, and the edge-clamped form of the banded frame; the JAX
    package's exchange run under vmap_shard_map gives the same rows."""
    img = np.arange(64 * 16, dtype=np.float32).reshape(64, 16)
    bands = list(torch.from_numpy(img).split(8))
    out = tmesh.band_halo_exchange(bands, halo=2)
    assert all(o.shape == (12, 16) for o in out)
    np.testing.assert_array_equal(out[1][:2].numpy(), img[6:8])
    np.testing.assert_array_equal(out[1][2:10].numpy(), img[8:16])
    np.testing.assert_array_equal(out[1][10:].numpy(), img[16:18])
    np.testing.assert_array_equal(out[0][:2].numpy(), 0.0)
    np.testing.assert_array_equal(out[7][10:].numpy(), 0.0)
    ring = tmesh.band_halo_exchange(bands, halo=2, wrap=True)
    for b in range(8):
        rows = np.arange(8 * b - 2, 8 * b + 10) % 64
        np.testing.assert_array_equal(ring[b].numpy(), img[rows])
    for b in range(8):
        rows = np.clip(np.arange(8 * b - 3, 8 * b + 11), 0, 63)
        np.testing.assert_array_equal(
            ttiling._edge_clamped_halo(bands, b, 3).numpy(), img[rows])
    for wrap in (False, True):
        with jax_bands_by_vmap():
            jout = vmap_shard_map(
                lambda x: jmesh.band_halo_exchange(x, 2, wrap=wrap),
                jmesh.make_render_mesh(8, dp=1, sp=8),
                (PartitionSpec("sp", None),),
                PartitionSpec("sp", None))(jnp.asarray(img))
        np.testing.assert_array_equal(
            np.asarray(jout), torch.cat(tmesh.band_halo_exchange(
                bands, 2, wrap=wrap)).numpy())
    # one band: the ring is itself, the clamp its own edge rows
    one = [torch.from_numpy(img)]
    np.testing.assert_array_equal(
        tmesh.band_halo_exchange(one, 2, wrap=True)[0].numpy(),
        img[np.arange(-2, 66) % 64])
    np.testing.assert_array_equal(
        ttiling._edge_clamped_halo(one, 0, 2).numpy(),
        img[np.clip(np.arange(-2, 66), 0, 63)])


def test_forward_banded_bit_equal_and_matches_jax(setup):
    """render_forward_banded at 128 x 128: 8 bands bit-equal to 1 (the
    two-pass raster at each band's integer viewport offset), and the JAX
    package's 8-device frame."""
    g = setup
    W = H = 128
    info = _info(W, H)
    pinfo = cv.render_info_from_jax(info)
    args = (g["pscene"], pinfo, g["port"].ibl_maps, g["port"].env_oct)
    bands8, a = ttiling.render_forward_banded(*args, _cpu_mesh(8), width=W,
                                              height=H, cfg=PCFG)
    _, b = ttiling.render_forward_banded(*args, _cpu_mesh(1), width=W,
                                         height=H, cfg=PCFG)
    assert a.shape == (H, W, 3) and len(bands8) == 8
    assert all(x.shape == (16, W, 3) and x.device.type == "cpu"
               for x in bands8)
    assert torch.isfinite(a).all()
    assert torch.equal(a, b)
    with jax_bands_by_vmap():
        j = np.asarray(jtiling.render_forward_banded(
            g["scene"], info, g["ren"].ibl_maps, g["ren"].env_oct,
            jmesh.make_render_mesh(8, dp=1, sp=8), width=W, height=H,
            cfg=CFG))
    close = np.abs(a.numpy() - j) <= 1e-3 + 1e-3 * np.abs(j)
    assert close.mean() >= 0.995, close.mean()
    peak = float(np.abs(j).max())
    assert psnr(j / peak, a.numpy() / peak) > 50.0


KW = dict(use_ibl=True, enable_ssao=True, enable_ssr=True, enable_taa=True,
          enable_bloom=True, ssr_divisor=2, ssr_steps=12, halo=8)


@pytest.fixture(scope="module")
def frames(setup):
    """FRAMES banded deferred frames at 256 x 128: the port with 4 bands
    and with 1, the JAX package on a 4-device mesh."""
    g = setup
    W, H = 256, 128
    info = _info(W, H)
    pinfo = cv.render_info_from_jax(info)
    m4, m1 = _cpu_mesh(4), _cpu_mesh(1)
    jm4 = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("sp",))
    s4 = ttiling.initial_banded_state(W, H, m4)
    s1 = ttiling.initial_banded_state(W, H, m1)
    js = jtiling.initial_banded_state(W, H, jm4)
    out = []
    for _ in range(FRAMES):
        pargs = (g["pscene"], pinfo, g["port"].ibl_maps, g["port"].env_oct)
        b4, s4, c4 = ttiling.render_frame_banded(
            *pargs, s4, m4, width=W, height=H, cfg=PCFG,
            tone_mapping_mode=PortTM.UNCHARTED2, **KW)
        _, s1, c1 = ttiling.render_frame_banded(
            *pargs, s1, m1, width=W, height=H, cfg=PCFG,
            tone_mapping_mode=PortTM.UNCHARTED2, **KW)
        with jax_bands_by_vmap():
            jc, js = jtiling.render_frame_banded(
                g["scene"], info, g["ren"].ibl_maps, g["ren"].env_oct, js,
                jm4, width=W, height=H, cfg=CFG,
                tone_mapping_mode=ToneMappingMode.UNCHARTED2, **KW)
        out.append(dict(bands=b4, c4=c4.numpy(), c1=c1.numpy(),
                        jc=np.asarray(jc), s4=s4, s1=s1, js=js))
    return out, m4


@pytest.mark.parametrize("frame", range(FRAMES))
def test_frame_banded_bands_match_one(frames, frame):
    """Four bands against one within 2e-3 (JAX test_multichip.py:122): the
    SSAO temporal stage and TAA tap their history on halo rows."""
    r = frames[0][frame]
    assert r["c4"].shape == (128, 256, 3) and np.isfinite(r["c4"]).all()
    np.testing.assert_allclose(r["c4"], r["c1"], atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_frame_banded_matches_jax(frames, frame):
    r = frames[0][frame]
    p = psnr(np.clip(r["jc"], 0, 1), np.clip(r["c4"], 0, 1))
    assert p > 50.0, p


def test_banded_state(frames):
    """The state after two frames: every band tensor on its band's device,
    the replicated ones on each distinct device, and the JAX package's
    state (the previous depth to GB_TOL's depth tolerance, the histories
    above 50 dB)."""
    out, m4 = frames
    s4, js = out[-1]["s4"], out[-1]["js"]
    devices = tmesh.band_sharding(m4)
    assert s4.frame_index == int(js.frame_index) == FRAMES
    for name in ("taa_color", "taa_count", "ssao_history",
                 "ssao_depth_history", "prev_depth"):
        bands = getattr(s4, name)
        assert len(bands) == 4, name
        assert [t.device for t in bands] == devices, name
        assert all(t.shape[:2] == (32, 256) for t in bands), name
    for name in ("prev_view_proj", "ssr_radiance"):
        assert [t.device for t in getattr(s4, name)] == tmesh.replicated(m4)
    assert s4.dof_coc is None and all(t.device == devices[0]
                                      for t in out[-1]["bands"])
    whole = {k: torch.cat(getattr(s4, k)).numpy() for k in (
        "taa_color", "ssao_history", "prev_depth")}
    jd = np.asarray(js.prev_depth)
    assert (np.abs(whole["prev_depth"] - jd) <= 5e-4).mean() >= 0.995
    assert psnr(np.clip(np.asarray(js.taa_color), 0, 1),
                np.clip(whole["taa_color"], 0, 1)) > 50.0
    assert psnr(np.asarray(js.ssao_history), whole["ssao_history"]) > 50.0
    np.testing.assert_allclose(s4.prev_view_proj[0].numpy(),
                               np.asarray(js.prev_view_proj), rtol=1e-6,
                               atol=1e-6)
    # converted into the port, the JAX state has the same layout
    conv = cv.banded_state_from_jax(js, m4)
    assert [t.shape for t in conv.taa_color] == [t.shape
                                                 for t in s4.taa_color]
    assert conv.frame_index == s4.frame_index


def test_banded_frame_checks_bands(setup):
    g = setup
    pinfo = cv.render_info_from_jax(_info(256, 120))
    with pytest.raises(ValueError, match="bands"):
        ttiling.render_frame_banded(
            g["pscene"], pinfo, g["port"].ibl_maps, g["port"].env_oct,
            ttiling.initial_banded_state(256, 120, _cpu_mesh(4)),
            _cpu_mesh(4), width=256, height=120, cfg=PCFG)
