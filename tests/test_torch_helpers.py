"""The JAX package's small helpers that its callers and tests reach, ported
beside the modules that hold them: gltf/primitives.py merge and
transform_mesh (host numpy, bit-equal), postfx/ssao.py
view_space_normal_from_depth and attribs.py gather_material, each against
the JAX function on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diligentfx_tpu import attribs as jat
from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.gltf import primitives as jprim
from diligentfx_tpu.postfx.ssao import \
    view_space_normal_from_depth as jax_normal_from_depth
from diligentfx_tpu_torch import attribs as pat
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.gltf import primitives as pprim
from diligentfx_tpu_torch.postfx.ssao import view_space_normal_from_depth
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _assert_mesh_equal(a, b):
    for name, x, y in zip(pprim.MeshData._fields, a, b):
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=name)
        assert x.dtype == np.asarray(y).dtype, name


def test_merge_equals_jax():
    parts = [(pprim.uv_sphere(0.5, 6, 10), jprim.uv_sphere(0.5, 6, 10)),
             (pprim.plane(2.0, segments=3), jprim.plane(2.0, segments=3)),
             (pprim.cube(1.5), jprim.cube(1.5))]
    merged = pprim.merge([p for p, _ in parts])
    _assert_mesh_equal(merged, jprim.merge([j for _, j in parts]))
    assert merged.indices.max() == merged.positions.shape[0] - 1


@pytest.mark.parametrize("kind", ["rotate_scale_shift", "mirror"])
def test_transform_mesh_equals_jax(kind):
    m = np.eye(4, dtype=np.float32)
    if kind == "rotate_scale_shift":
        c, s = np.cos(0.7), np.sin(0.7)
        m[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]]) \
            @ np.diag([2.0, 0.5, 1.0])
        m[3, :3] = [1.0, -2.0, 0.5]
    else:
        m[0, 0] = -1.0
    mesh = pprim.uv_sphere(0.42, 8, 12)
    jmesh = jprim.uv_sphere(0.42, 8, 12)
    _assert_mesh_equal(pprim.transform_mesh(mesh, m),
                       jprim.transform_mesh(jmesh, m))


def test_view_space_normal_from_depth_matches_jax():
    h, w = 24, 40
    eye = [0.0, 0.5, 4.0]
    cam = jat.CameraAttribs.create(jm3.look_at(eye, [0, 0, 0]),
                                   jm3.perspective(0.8, w / h, 0.1, 50.0),
                                   eye, 0.1, 50.0, w, h)
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    depth = (0.96 + 0.0004 * xx + 0.0006 * yy
             + 0.002 * rng.random((h, w))).astype(np.float32)
    ref = np.asarray(jax_normal_from_depth(jnp.asarray(depth), cam))
    out = view_space_normal_from_depth(torch.from_numpy(depth),
                                       cv.camera_from_jax(cam)).numpy()
    assert out.shape == (h, w, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_gather_material_matches_jax():
    kw = [dict(metallic_factor=float(i), roughness_factor=0.1 * i,
               base_color_factor=(0.1 * i, 0.2, 0.3, 1.0)) for i in range(4)]
    jone = jat.gather_material(jat.stack_materials(
        [jat.PBRMaterialBasicAttribs.create(**k) for k in kw]), jnp.int32(2))
    one = pat.gather_material(pat.stack_materials(
        [pat.PBRMaterialBasicAttribs.create(**k) for k in kw]), 2)
    assert isinstance(one, pat.PBRMaterialBasicAttribs)
    for f in pat.PBRMaterialBasicAttribs._fields:
        np.testing.assert_array_equal(getattr(one, f).numpy(),
                                      np.asarray(getattr(jone, f)),
                                      err_msg=f)
