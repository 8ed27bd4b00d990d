"""Parity of the port's texture atlas (diligentfx_tpu_torch.ops.texture) with
the JAX package's ops/texture.py on the CPU.

The JAX functions run eagerly (they are not jitted), op by op, so both
sides round every operation alike: the atlas build is compared exactly,
the samples within 1e-6 (texel values lie in [0, 1]; the bound leaves room
for the last bit of a bilinear weight)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu.ops import texture as jt
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.ops import texture as tt
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _images(seed=0):
    """Images that exercise the shelf packer: a new shelf, a new layer, a
    downscaled oversize image, grey, RGB, RGBA and uint8 inputs."""
    rng = np.random.default_rng(seed)
    return [rng.random((20, 24, 3), dtype=np.float32),
            rng.random((16, 16, 4), dtype=np.float32),
            (rng.random((12, 30)) * 255).astype(np.uint8),
            rng.random((40, 40, 3), dtype=np.float32),
            rng.random((70, 50, 3), dtype=np.float32),
            rng.random((8, 8, 1), dtype=np.float32)]


@pytest.fixture(scope="module")
def atlases():
    jb, tb = jt.AtlasBuilder(size=64), tt.AtlasBuilder(size=64)
    for img in _images():
        assert jb.add(img) == tb.add(img)
    return jb.build(num_mips=5), tb.build(num_mips=5, device="cpu")


def test_atlas_builder_matches_jax(atlases):
    ja, ta = atlases
    assert ta.num_layers == ja.num_layers >= 2 and ta.size == ja.size == 64
    assert len(ta.mips) == len(ja.mips) == 5
    for a, b in zip(ja.mips, ta.mips):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(ta.scale_bias.numpy(),
                                  np.asarray(ja.scale_bias))
    np.testing.assert_array_equal(ta.layer.numpy(), np.asarray(ja.layer))
    # the converter carries the JAX atlas over unchanged
    ca = cv.atlas_from_jax(ja)
    for a, b in zip(ca.mips, ta.mips):
        assert torch.equal(a, b)


def _sample_inputs(n_tex, seed=1, shape=(48, 40)):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2.5, 3.5, shape + (2,)).astype(np.float32)
    lod = rng.uniform(-1.0, 6.5, shape).astype(np.float32)
    tex = rng.integers(0, n_tex, shape).astype(np.int32)
    wu = rng.integers(0, 3, shape).astype(np.int32)
    wv = rng.integers(0, 3, shape).astype(np.int32)
    return uv, lod, tex, wu, wv


def test_sample_atlas_matches_jax(atlases):
    """Random uv (every wrap mode, per pixel), lod below, inside and above
    the mip range, random textures."""
    ja, ta = atlases
    uv, lod, tex, wu, wv = _sample_inputs(len(_images()))
    a = jt.sample_atlas(ja, jnp.asarray(tex), jnp.asarray(uv),
                        jnp.asarray(lod), wrap_u=jnp.asarray(wu),
                        wrap_v=jnp.asarray(wv))
    b = tt.sample_atlas(ta, torch.from_numpy(tex), torch.from_numpy(uv),
                        torch.from_numpy(lod), wrap_u=torch.from_numpy(wu),
                        wrap_v=torch.from_numpy(wv))
    assert b.shape == (48, 40, 4)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    # no wrap given: REPEAT, as in the JAX package
    a = jt.sample_atlas(ja, jnp.asarray(tex), jnp.asarray(uv),
                        jnp.asarray(lod))
    b = tt.sample_atlas(ta, torch.from_numpy(tex), torch.from_numpy(uv),
                        torch.from_numpy(lod))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_sample_material_texture_matches_jax(atlases):
    """The binding-mode dispatch with a KHR_texture_transform and the LOD
    metric (texture_base_size) as the deferred shading uses them."""
    ja, ta = atlases
    uv, lod, tex, wu, wv = _sample_inputs(len(_images()), seed=2)
    rng = np.random.default_rng(3)
    xf = rng.uniform(-2, 2, uv.shape[:-1] + (6,)).astype(np.float32)
    juv = jt.apply_uv_transform(jnp.asarray(uv), jnp.asarray(xf[..., :4]),
                                jnp.asarray(xf[..., 4:]))
    tuv = tt.apply_uv_transform(torch.from_numpy(uv),
                                torch.from_numpy(xf[..., :4]),
                                torch.from_numpy(xf[..., 4:]))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    for x, y in zip(jt.texture_base_size(ja, jnp.asarray(tex)),
                    tt.texture_base_size(ta, torch.from_numpy(tex))):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    a = jt.sample_material_texture(ja, jnp.asarray(tex), juv,
                                   jnp.asarray(lod), wrap_u=jnp.asarray(wu),
                                   wrap_v=jnp.asarray(wv))
    b = tt.sample_material_texture(ta, torch.from_numpy(tex), tuv,
                                   torch.from_numpy(lod),
                                   wrap_u=torch.from_numpy(wu),
                                   wrap_v=torch.from_numpy(wv))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_white_atlas_and_heap_raises():
    """The white default atlas equals the JAX package's and samples 1; a
    TextureHeap goes through the binding-mode dispatch to sample_heap,
    equal to the JAX package's dispatch within 1e-6."""
    w = tt.white_atlas(device="cpu")
    j = jt.white_atlas()
    for a, b in zip(j.mips, w.mips):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    val = tt.sample_atlas(w, torch.zeros(3, dtype=torch.int32),
                          torch.rand(3, 2), torch.zeros(3))
    assert torch.equal(val, torch.ones(3, 4))
    imgs = _images()
    jb, tb = jt.TextureHeapBuilder(), tt.TextureHeapBuilder()
    for img in imgs:
        jb.add(img)
        tb.add(img)
    jh, th = jb.build(num_mips=4), tb.build(num_mips=4, device="cpu")
    assert isinstance(th, tt.TextureHeap)
    uv, lod, tex, wu, wv = _sample_inputs(len(imgs), seed=5)
    a = jt.sample_material_texture(jh, jnp.asarray(tex), jnp.asarray(uv),
                                   jnp.asarray(lod), wrap_u=jnp.asarray(wu),
                                   wrap_v=jnp.asarray(wv))
    b = tt.sample_material_texture(th, torch.from_numpy(tex),
                                   torch.from_numpy(uv), torch.from_numpy(lod),
                                   wrap_u=torch.from_numpy(wu),
                                   wrap_v=torch.from_numpy(wv))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
