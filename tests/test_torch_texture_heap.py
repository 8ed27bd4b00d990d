"""Parity of the port's texture heap (the dynamic texture-array binding
mode of diligentfx_tpu_torch/ops/texture.py, build_render_scene's "array"
mode) with the JAX package on the CPU.

Tolerances: the builder's arrays are numpy on both sides and compared for
equality (texels, mip bases and sizes, after the uint8 conversion, the
grey / RGB promotion, the downscale above max_size and the odd edges'
padding); samples within 1e-6 (texel values lie in [0, 1]; the JAX
functions run eagerly, op by op, so the bound leaves room for the last bit
of a bilinear weight); texture_base_size exactly; the alpha-mask resolve
through the heap equal to the eager JAX resolve; the textured G-buffer
through the heap within tests/test_torch_alpha_mask.py's bounds against
the JAX package's _shade_band run eagerly on the port's visibility
(base colour and material 1e-5, where only the mip weights' last bits
differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu.gltf import loader as jloader
from diligentfx_tpu.gltf import model as jmodel
from diligentfx_tpu.ops import texture as jt
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.gltf import loader as tloader
from diligentfx_tpu_torch.gltf import model as tmodel
from diligentfx_tpu_torch.ops import texture as tt
from tests.test_torch_gltf import (assert_scene_equal, grid_quad,
                                   mixed_scene, placed, write_gltf)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

MAX_SIZE = 64


def _images(seed=0):
    """Odd and non-square sizes (odd edges at several mips), grey, RGB,
    RGBA, uint8, a 1 x 1 and a 2 x 3 (the chain stops at 1 x 1 early), and
    two above MAX_SIZE (the nearest-neighbour downscale)."""
    rng = np.random.default_rng(seed)
    return [rng.random((25, 13, 3), dtype=np.float32),
            rng.random((16, 16, 4), dtype=np.float32),
            (rng.random((12, 30)) * 255).astype(np.uint8),
            (rng.random((40, 50, 4)) * 255).astype(np.uint8),
            rng.random((1, 1, 1), dtype=np.float32),
            rng.random((2, 3, 3), dtype=np.float32),
            rng.random((100, 70, 3), dtype=np.float32),
            rng.random((9, 131, 4), dtype=np.float32)]


@pytest.fixture(scope="module")
def heaps():
    jb, tb = jt.TextureHeapBuilder(MAX_SIZE), tt.TextureHeapBuilder(MAX_SIZE)
    for img in _images():
        assert jb.add(img) == tb.add(img)
    return jb.build(num_mips=6), tb.build(num_mips=6, device="cpu")


def _assert_heap_equal(j, t):
    assert t.num_mips == j.num_mips and t.max_levels == j.max_levels
    for f in ("texels", "mip_base", "mip_size"):
        a = np.asarray(getattr(j, f))
        b = getattr(t, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("num_mips", [6, 3])
def test_heap_builder_matches_jax(heaps, num_mips):
    """Every array bit-equal to the JAX builder's; the downscale and the
    repeated last mips as the JAX package makes them; the converter
    carries the JAX heap over unchanged."""
    if num_mips == 6:
        j, t = heaps
    else:
        jb, tb = jt.TextureHeapBuilder(MAX_SIZE), tt.TextureHeapBuilder(
            MAX_SIZE)
        for img in _images(1):
            jb.add(img)
            tb.add(img)
        j, t = jb.build(num_mips=3), tb.build(num_mips=3, device="cpu")
    _assert_heap_equal(j, t)
    sizes = t.mip_size.numpy()
    assert tuple(sizes[6, 0]) == (44, 64) and tuple(sizes[7, 0]) == (64, 4)
    assert tuple(sizes[0, 1]) == (7, 13) and tuple(sizes[0, 2]) == (4, 7)
    if num_mips == 6:
        assert (sizes[4] == 1).all()                 # 1 x 1 repeated
        assert tuple(sizes[5, 2]) == (1, 1) and \
            t.mip_base[5, 2] == t.mip_base[5, 5]
    _assert_heap_equal(j, cv.heap_from_jax(j))
    empty = tt.TextureHeapBuilder().build(device="cpu")
    _assert_heap_equal(jt.TextureHeapBuilder().build(), empty)


def _inputs(n_tex, shape=(36, 40), seed=2):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2.5, 3.5, shape + (2,)).astype(np.float32)
    tex = rng.integers(0, n_tex, shape).astype(np.int32)
    return uv, tex


@pytest.mark.parametrize("wrap", [0, 1, 2])
@pytest.mark.parametrize("lod", [0.0, 1.3, 9.0])
def test_sample_heap_matches_jax(heaps, lod, wrap):
    """sample_heap at lod 0, 1.3 and past the last mip, in each wrap mode
    (REPEAT, MIRROR, CLAMP) on uv in [-2.5, 3.5], every texture: within
    1e-6 of the JAX function."""
    j, t = heaps
    uv, tex = _inputs(len(_images()))
    lods = np.full(tex.shape, lod, np.float32)
    wr = np.full(tex.shape, wrap, np.int32)
    a = jt.sample_heap(j, jnp.asarray(tex), jnp.asarray(uv),
                       jnp.asarray(lods), wrap_u=jnp.asarray(wr),
                       wrap_v=jnp.asarray(wr))
    b = tt.sample_heap(t, torch.from_numpy(tex), torch.from_numpy(uv),
                       torch.from_numpy(lods), wrap_u=torch.from_numpy(wr),
                       wrap_v=torch.from_numpy(wr))
    assert b.shape == tex.shape + (4,)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_sample_material_texture_heap_matches_jax(heaps):
    """The binding-mode dispatch with per-pixel wraps and lods (also below
    0), a KHR_texture_transform, no wrap given (REPEAT), and the LOD
    metric texture_base_size (the native mip-0 size, f32) exactly."""
    j, t = heaps
    uv, tex = _inputs(len(_images()), seed=3)
    rng = np.random.default_rng(4)
    lod = rng.uniform(-1.0, 7.0, tex.shape).astype(np.float32)
    wu = rng.integers(0, 3, tex.shape).astype(np.int32)
    wv = rng.integers(0, 3, tex.shape).astype(np.int32)
    xf = rng.uniform(-2, 2, tex.shape + (6,)).astype(np.float32)
    juv = jt.apply_uv_transform(jnp.asarray(uv), jnp.asarray(xf[..., :4]),
                                jnp.asarray(xf[..., 4:]))
    tuv = tt.apply_uv_transform(torch.from_numpy(uv),
                                torch.from_numpy(xf[..., :4]),
                                torch.from_numpy(xf[..., 4:]))
    for x, y in zip(jt.texture_base_size(j, jnp.asarray(tex)),
                    tt.texture_base_size(t, torch.from_numpy(tex))):
        assert y.dtype == torch.float32
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    for kw_j, kw_t in (
            (dict(wrap_u=jnp.asarray(wu), wrap_v=jnp.asarray(wv)),
             dict(wrap_u=torch.from_numpy(wu), wrap_v=torch.from_numpy(wv))),
            ({}, {})):
        a = jt.sample_material_texture(j, jnp.asarray(tex), juv,
                                       jnp.asarray(lod), **kw_j)
        b = tt.sample_material_texture(t, torch.from_numpy(tex), tuv,
                                       torch.from_numpy(lod), **kw_t)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


def test_heap_keeps_native_texels():
    """A texel of a texture larger than the atlas layer: exact through the
    heap at lod 0, averaged away by the atlas (tests/test_texture.py)."""
    img = np.zeros((128, 128, 3), np.float32)
    img[5, 9] = 1.0
    hb = tt.TextureHeapBuilder()
    tid = hb.add(img)
    heap = hb.build(num_mips=1, device="cpu")
    ab = tt.AtlasBuilder(size=32)
    ab.add(img)
    atlas = ab.build(num_mips=1, device="cpu")
    uv = torch.tensor([[(9 + 0.5) / 128, (5 + 0.5) / 128]])
    t = torch.tensor([tid])
    assert float(tt.sample_heap(heap, t, uv, torch.zeros(1))[0, 0]) == 1.0
    assert float(tt.sample_atlas(atlas, t, uv, torch.zeros(1))[0, 0]) < 0.5


def _textured_gltf(path):
    """Three textured quads: a 100 x 60 texture (odd mip edges: 25 x 15 ->
    13 x 8), a 5 x 3 RGB one (the chain ends early) and a 96 x 96 one
    above a 64 atlas layer, with REPEAT, MIRROR and CLAMP samplers."""
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (60, 100, 4), dtype=np.uint8),
            rng.integers(0, 256, (3, 5, 4), dtype=np.uint8),
            rng.integers(0, 256, (96, 96, 4), dtype=np.uint8)]
    for img in imgs:
        img[..., 3] = 255
    prims = [dict(placed(grid_quad(2, 2, 1.0, 1.0), [i * 1.2, 0.0, -2.0]),
                  material=i) for i in range(3)]
    materials = [{"pbrMetallicRoughness": {"baseColorTexture": {
        "index": i}, "metallicFactor": 0.0, "roughnessFactor": 0.5}}
        for i in range(3)]
    return write_gltf(path, prims, materials, images=imgs,
                      samplers=[{"wrapS": 10497, "wrapT": 10497},
                                {"wrapS": 33648, "wrapT": 33071},
                                {"wrapS": 33071, "wrapT": 33648}],
                      textures=[{"source": i, "sampler": i}
                                for i in range(3)])


@pytest.mark.parametrize("scene", ["textured", "mixed"])
def test_build_render_scene_array_matches_jax(tmp_path, scene):
    """build_render_scene(texture_binding_mode="array"): every scene array
    and light equal to the JAX package's, and the heap's arrays bit-equal
    (native sizes above the atlas layer kept)."""
    path = (_textured_gltf(str(tmp_path / "t.glb")) if scene == "textured"
            else mixed_scene(str(tmp_path / "m.glb")))
    ref = jmodel.build_render_scene(jloader.load_gltf(path),
                                    texture_binding_mode="array")
    got = tmodel.build_render_scene(tloader.load_gltf(path), atlas_size=64,
                                    texture_binding_mode="array",
                                    device="cpu")
    assert isinstance(got.atlas, tt.TextureHeap)
    assert_scene_equal(ref, got)
    if scene == "textured":
        assert got.atlas.mip_size[2, 0].tolist() == [96, 96]
        assert got.atlas.mip_size[0, 2].tolist() == [25, 15]


@pytest.fixture(scope="module")
def mask_scene(tmp_path_factory):
    """The mixed glTF scene (a lattice screen of MASK, textured) with its
    textures in a heap."""
    path = mixed_scene(str(tmp_path_factory.mktemp("heap") / "m.glb"))
    return jmodel.build_render_scene(jloader.load_gltf(path),
                                     texture_binding_mode="array")


def test_resolve_alpha_mask_heap_matches_jax(mask_scene):
    """The lattice's texture alpha through the heap (lod 0, the texture
    transform, the mirror / clamp sampler) against the cutoff: equal to
    the eager JAX resolve, fragments both kept and cut out."""
    from tests.test_torch_oit import _resolve_both
    _, got, n_op, tally = _resolve_both(mask_scene.scene, mask_scene.atlas,
                                        True, [0.2, 0.1, 1.0],
                                        [0.2, 0.0, -2.5])
    assert bool((got.tri_id >= n_op).any())
    assert int(tally["passed"]) > 0 and int(tally["discarded"]) > 0


def test_heap_gbuffer_matches_jax(mask_scene):
    """The textured two-pass G-buffer of the mask scene through the heap:
    the port's render_gbuffer ("auto": two-pass for the mask tail; no IBL)
    against the JAX package's _shade_band run eagerly on the port's
    visibility, clip and 1/w: G-buffer fields within
    tests/test_torch_alpha_mask.py's bounds, base colour, material and
    world position within 1e-5."""
    from diligentfx_tpu import math3d as jm3
    from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                        PBRRendererShaderParameters)
    from diligentfx_tpu.ops import raster as jr
    from diligentfx_tpu.pbr import deferred as jd
    from diligentfx_tpu.pbr.renderer import RenderInfo
    from diligentfx_tpu_torch.pbr import deferred as td
    from diligentfx_tpu_torch.pbr.renderer import default_env_oct
    from tests.test_torch_alpha_mask import GB_TOL, H, PCFG, W
    rs = mask_scene
    eye = [0.2, 0.1, 1.0]
    info = RenderInfo(
        camera=CameraAttribs.create(
            jm3.look_at(eye, [0.2, 0.0, -2.5]),
            jm3.perspective(0.9, W / H, 0.1, 20.0), eye, 0.1, 20.0, W, H),
        lights=PBRLightAttribs.concat([
            PBRLightAttribs.directional([-0.3, -1.0, -0.5], [3, 3, 3]),
            PBRLightAttribs.point([0.5, 1.0, -1.0], [4, 3, 2], range=10.0)]),
        renderer_params=PBRRendererShaderParameters.create())
    # no IBL (the textures are under test): the port's default sky, whose
    # half-resolution taps give the background on both sides
    env_oct = default_env_oct(device="cpu")
    pscene, pinfo = cv.scene_from_jax(rs.scene), cv.render_info_from_jax(info)
    heap = cv.heap_from_jax(rs.atlas)
    pgb = td.render_gbuffer(pscene, pinfo, None, env_oct, width=W, height=H,
                            cfg=PCFG, use_ibl=False, atlas=heap,
                            use_textures=True, fast_env=True)
    vb, clip, winv, _ = td._two_pass_raster(pscene, pinfo, pad_w=W, pad_h=H,
                                            cfg=PCFG, atlas=heap,
                                            use_textures=True)
    jvb = jr.VisibilityBuffer(depth=jnp.asarray(vb.depth.numpy()),
                              tri_id=jnp.asarray(vb.tri_id.numpy()),
                              bary=jnp.asarray(vb.bary.numpy()))
    with jax.disable_jit():
        jgb = jd._shade_band(
            rs.scene, info, None, jnp.asarray(env_oct.numpy()), jvb,
            jnp.asarray(clip.numpy()), jnp.asarray(winv.numpy()),
            jnp.int32(0), band_h=H, pad_w=W, pad_h=H, use_ibl=False,
            use_lights=True, shadow_mode=None, pcf_kernel_size=3,
            atlas=rs.atlas, use_textures=True, enable_clearcoat=False,
            fast_env=True, light_shadow_kinds=())
    hit = np.asarray(jgb.hit)
    np.testing.assert_array_equal(pgb.mesh_id.numpy(),
                                  np.asarray(jgb.mesh_id))
    lattice = rs.mesh_node_ids.index(1)
    assert (pgb.mesh_id.numpy() == lattice).mean() > 0.02
    assert 0.3 < hit.mean() < 1.0
    tol = dict(GB_TOL, base_color=(1e-5, 0.0), material_data=(1e-5, 0.0),
               world_pos=(1e-5, 0.0))
    for name, (atol, rtol) in tol.items():
        x = np.asarray(getattr(jgb, name))[hit]
        y = getattr(pgb, name).numpy()[hit]
        np.testing.assert_allclose(y, x, atol=atol, rtol=rtol, err_msg=name)
