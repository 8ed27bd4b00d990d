"""Parity of the port's IBL precompute, sampling and BRDF helpers
(diligentfx_tpu_torch.pbr.ibl, ops/sampling.py, pbr/brdf.py) with the JAX
package on the CPU, at the bench.py --smoke IBL dimensions.

Tolerances: the precompute sums the same samples in the same order, but
XLA fuses (and contracts) the jitted loops, so each map agrees to 1e-4
relative or 2e-5 absolute (the split-sum LUT to 5e-4, see LUT_FIELDS); the
per-pixel helpers agree to 1e-6 (1e-5 through the transcendental ones).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu.ops import sampling as js
from diligentfx_tpu.pbr import brdf as jbrdf
from diligentfx_tpu.pbr.ibl import precompute_ibl_maps as jax_precompute
from diligentfx_tpu.pbr.renderer import PBRRenderer as JaxRenderer
from diligentfx_tpu_torch.ops import sampling as ts
from diligentfx_tpu_torch.pbr import brdf as tbrdf
from diligentfx_tpu_torch.pbr.ibl import precompute_ibl_maps
from diligentfx_tpu_torch.pbr.renderer import default_env_oct
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# bench.py --smoke (bench.py:117-120)
SMOKE = dict(brdf_lut_dim=32, num_brdf_samples=16, irradiance_dim=16,
             prefiltered_dim=32, num_spec_samples=16)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def env():
    return np.asarray(default_env_oct("cpu"))


@pytest.fixture(scope="module")
def maps(env):
    return (jax_precompute(jnp.asarray(env), **SMOKE),
            precompute_ibl_maps(torch.from_numpy(env), **SMOKE))


def test_default_sky_matches_jax(env):
    from diligentfx_tpu.config import PBRRendererCreateInfo
    ren = JaxRenderer(PBRRendererCreateInfo(enable_ibl=False))
    np.testing.assert_allclose(env, np.asarray(ren.env_oct), rtol=0, atol=1e-6)


# the split-sum LUT (and its Chebyshev fit) goes through sin, cos and sqrt
# of GGX samples: XLA's jitted versions of those move the JAX package's own
# LUT by up to 2e-4 against its eager evaluation, which the port matches to
# 1e-6 (test_brdf_lut_matches_eager_jax)
LUT_FIELDS = ("preintegrated_ggx", "env_brdf_coeffs")


@pytest.mark.parametrize("field", ["irradiance", "preintegrated_ggx",
                                   "irradiance_sh", "env_brdf_coeffs",
                                   "pref_packed"])
def test_ibl_maps_match_jax(maps, field):
    jm, tm = maps
    a, b = np.asarray(getattr(jm, field)), getattr(tm, field).numpy()
    assert a.shape == b.shape
    atol = 5e-4 if field in LUT_FIELDS else 2e-5
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=atol, err_msg=field)


def test_brdf_lut_matches_eager_jax():
    import jax
    from diligentfx_tpu.pbr.ibl import precompute_brdf_lut
    from diligentfx_tpu_torch.pbr.ibl import precompute_brdf_lut as port_lut
    with jax.disable_jit():
        a = np.asarray(precompute_brdf_lut.__wrapped__(16, 8))
    np.testing.assert_allclose(port_lut(16, 8).numpy(), a, rtol=0, atol=1e-6)


def test_prefiltered_chain_matches_jax(maps):
    jm, tm = maps
    assert len(jm.prefiltered) == len(tm.prefiltered) == 7
    for lvl, (a, b) in enumerate(zip(jm.prefiltered, tm.prefiltered)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=2e-5, err_msg=f"mip {lvl}")


def test_sample_pyramid_packed_matches_jax(maps):
    """The shading path's one-gather trilinear pyramid sample (JAX
    sampling.py:285) at random directions and lods."""
    jm, tm = maps
    rng = np.random.default_rng(0)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    uv = np.asarray(js.dir_to_oct_uv(jnp.asarray(d)))
    np.testing.assert_allclose(ts.dir_to_oct_uv(torch.from_numpy(d)).numpy(),
                               uv, atol=1e-6)
    lod = rng.uniform(0, 6, 64).astype(np.float32)
    sizes = [m.shape[0] for m in jm.prefiltered]
    a = js.sample_pyramid_packed(jm.pref_packed, sizes, jnp.asarray(uv),
                                 jnp.asarray(lod))
    b = ts.sample_pyramid_packed(tm.pref_packed, sizes, _t(uv), _t(lod))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_sampling_helpers_match_jax():
    rng = np.random.default_rng(1)
    img = rng.random((12, 20, 3)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (7, 9, 2)).astype(np.float32)
    for name in ("bilinear_sample", "point_sample"):
        a = getattr(js, name)(jnp.asarray(img), jnp.asarray(uv))
        b = getattr(ts, name)(torch.from_numpy(img), torch.from_numpy(uv))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   err_msg=name)
    a = js.upsample_bilinear(jnp.asarray(img), 2, 2)
    b = ts.upsample_bilinear(torch.from_numpy(img), 2, 2)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(ts.oct_pixel_dirs(8).numpy(),
                               np.asarray(js.oct_pixel_dirs(8)), atol=1e-6)
    np.testing.assert_allclose(ts.oct_solid_angles(8).numpy(),
                               np.asarray(js.oct_solid_angles(8)), rtol=1e-5)
    d = rng.standard_normal((10, 3)).astype(np.float32)
    sh = rng.standard_normal((9, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ts.sh9_eval(torch.from_numpy(d), torch.from_numpy(sh)).numpy(),
        np.asarray(js.sh9_eval(jnp.asarray(d), jnp.asarray(sh))),
        rtol=1e-5, atol=1e-6)
    mips_a = js.build_mip_chain(jnp.asarray(img[:8, :8]), 3)
    mips_b = ts.build_mip_chain(torch.from_numpy(img[:8, :8]), 3)
    for a, b in zip(mips_a, mips_b):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_brdf_helpers_match_jax(maps):
    jm, tm = maps
    rng = np.random.default_rng(2)
    ndotv = rng.uniform(0, 1, (50, 1)).astype(np.float32)
    rough = rng.uniform(0, 1, (50, 1)).astype(np.float32)
    a = jbrdf.env_brdf_fitted(jnp.asarray(ndotv), jnp.asarray(rough),
                              jm.env_brdf_coeffs)
    b = tbrdf.env_brdf_fitted(torch.from_numpy(ndotv), torch.from_numpy(rough),
                              tm.env_brdf_coeffs)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)
    n = rng.standard_normal((50, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    h = rng.standard_normal((50, 3)).astype(np.float32)
    h /= np.linalg.norm(h, axis=-1, keepdims=True)
    ndoth = np.abs(np.sum(n * h, -1)).astype(np.float32)
    alpha = (rough[:, 0] ** 2).astype(np.float32)
    np.testing.assert_allclose(
        tbrdf.ndf_ggx(torch.from_numpy(ndoth), torch.from_numpy(alpha)).numpy(),
        np.asarray(jbrdf.ndf_ggx(jnp.asarray(ndoth), jnp.asarray(alpha))),
        rtol=1e-5)
    np.testing.assert_allclose(
        tbrdf.smith_ggx_visibility_correlated(
            torch.from_numpy(ndoth), torch.from_numpy(ndotv[:, 0]),
            torch.from_numpy(alpha)).numpy(),
        np.asarray(jbrdf.smith_ggx_visibility_correlated(
            jnp.asarray(ndoth), jnp.asarray(ndotv[:, 0]), jnp.asarray(alpha))),
        rtol=1e-5)
