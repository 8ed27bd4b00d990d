"""The port's IBL cache (diligentfx_tpu_torch/utils/cache.py and
PBRRenderer(ibl_cache_dir=...)) against the JAX package's utils/cache.py,
on the CPU.

  * the port's round trip is exact: a cold renderer precomputes and saves
    the maps, a warm one loads them bit for bit (every field, the rebuilt
    footprint-packed pyramid included);
  * a file written by the JAX package's save_ibl_maps loads in the port
    into maps equal, exactly, to convert.py's conversion of the JAX maps;
  * the cache keys of the two packages are equal (both hash with the
    native content hash; the JAX binding is asserted available);
  * a missing, truncated, foreign or incomplete file is a miss; any other
    error propagates.

The maps are the port's precompute at small sizes (the JAX package's
jitted precompute would take most of a minute on one core); the JAX maps
are those arrays with the JAX package's flattened pyramid.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu.native import binding as jnb
from diligentfx_tpu.ops.sampling import (build_packed_pyramid,
                                         flatten_mip_pyramid)
from diligentfx_tpu.pbr import shading as jsh
from diligentfx_tpu.utils import cache as jcache
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.config import PBRRendererCreateInfo
from diligentfx_tpu_torch.pbr.renderer import PBRRenderer
from diligentfx_tpu_torch.utils import cache as tcache
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CI = PBRRendererCreateInfo(brdf_lut_dim=16, num_brdf_samples=8,
                           irradiance_cube_dim=16, prefiltered_env_map_dim=16,
                           num_specular_env_samples=8)


def _env(seed=0):
    return np.random.default_rng(seed).uniform(
        0.0, 2.0, (32, 32, 3)).astype(np.float32)


def assert_same_maps(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, tuple):
            assert len(x) == len(y), f
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u.numpy(), v.numpy(), f)
        else:
            assert x.device.type == "cpu"
            np.testing.assert_array_equal(x.numpy(), y.numpy(), f)


@pytest.fixture(scope="module")
def port_maps():
    return PBRRenderer(CI, env_oct=torch.from_numpy(_env()),
                       device="cpu").ibl_maps


def _jax_maps(m):
    pref = tuple(jnp.asarray(x.numpy()) for x in m.prefiltered)
    flat, offsets, sizes = flatten_mip_pyramid(pref)
    return jsh.IBLMaps(
        irradiance=jnp.asarray(m.irradiance.numpy()), prefiltered=pref,
        preintegrated_ggx=jnp.asarray(m.preintegrated_ggx.numpy()),
        preintegrated_charlie=jnp.asarray(m.preintegrated_charlie.numpy()),
        sheen_albedo_scaling=jnp.asarray(m.sheen_albedo_scaling.numpy()),
        irradiance_sh=jnp.asarray(m.irradiance_sh.numpy()),
        pref_flat=flat, pref_offsets=offsets, pref_sizes=sizes,
        env_brdf_coeffs=jnp.asarray(m.env_brdf_coeffs.numpy()),
        pref_packed=build_packed_pyramid(pref))


def test_renderer_cold_then_warm_is_exact(tmp_path):
    env = torch.from_numpy(_env(1))
    cold = PBRRenderer(CI, env_oct=env, device="cpu",
                       ibl_cache_dir=str(tmp_path))
    key = tcache.ibl_cache_key(env, CI)
    assert os.listdir(tmp_path) == [f"ibl_{key}.npz"]
    warm = PBRRenderer(CI, env_oct=env, device="cpu",
                       ibl_cache_dir=str(tmp_path))
    assert_same_maps(cold.ibl_maps, warm.ibl_maps)
    # another precompute size, another file
    PBRRenderer(dataclasses.replace(CI, brdf_lut_dim=8), env_oct=env,
                device="cpu", ibl_cache_dir=str(tmp_path))
    assert len(os.listdir(tmp_path)) == 2
    # maps given by the caller win over the cache
    given = PBRRenderer(CI, env_oct=env, device="cpu",
                        ibl_maps=cold.ibl_maps, ibl_cache_dir=str(tmp_path))
    assert given.ibl_maps is cold.ibl_maps


def test_save_load_round_trip(tmp_path, port_maps):
    path = str(tmp_path / "sub" / "maps.npz")
    tcache.save_ibl_maps(path, port_maps)
    assert_same_maps(tcache.load_ibl_maps(path, device="cpu"), port_maps)


def test_jax_file_loads_in_the_port(tmp_path, port_maps):
    jmaps = _jax_maps(port_maps)
    path = str(tmp_path / "jax.npz")
    jcache.save_ibl_maps(path, jmaps)
    assert_same_maps(tcache.load_ibl_maps(path, device="cpu"),
                     cv.ibl_maps_from_jax(jmaps, "cpu"))


def test_cache_keys_match_jax():
    assert jnb.available()
    for seed in range(3):
        env = _env(seed)
        for ci in (CI, PBRRendererCreateInfo()):
            want = jcache.ibl_cache_key(jnp.asarray(env), ci)
            assert tcache.ibl_cache_key(env, ci) == want
            assert tcache.ibl_cache_key(torch.from_numpy(env), ci) == want
    assert (tcache.ibl_cache_key(_env(0), CI)
            != tcache.ibl_cache_key(_env(0), dataclasses.replace(
                CI, num_specular_env_samples=9)))


def test_unreadable_files_are_misses(tmp_path, port_maps):
    assert tcache.load_ibl_maps(str(tmp_path / "absent.npz"), "cpu") is None
    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"not a zip file at all")
    assert tcache.load_ibl_maps(str(garbage), "cpu") is None
    good = tmp_path / "good.npz"
    tcache.save_ibl_maps(str(good), port_maps)
    cut = tmp_path / "cut.npz"
    cut.write_bytes(good.read_bytes()[:200])
    assert tcache.load_ibl_maps(str(cut), "cpu") is None
    partial = tmp_path / "partial.npz"
    np.savez(partial, n_mips=np.asarray(2), pref_0=np.zeros((4, 4, 3)))
    assert tcache.load_ibl_maps(str(partial), "cpu") is None
    (tmp_path / "dir.npz").mkdir()
    assert tcache.load_ibl_maps(str(tmp_path / "dir.npz"), "cpu") is None


def test_other_errors_propagate(tmp_path, port_maps, monkeypatch):
    path = str(tmp_path / "maps.npz")
    tcache.save_ibl_maps(path, port_maps)

    def no_memory(*a, **k):
        raise MemoryError("no memory")
    monkeypatch.setattr(tcache.np, "load", no_memory)
    with pytest.raises(MemoryError):
        tcache.load_ibl_maps(path, "cpu")
