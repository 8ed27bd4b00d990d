"""The port's pxr adapter (diligentfx_tpu_torch/hydrogent/usd_adapter.py)
through the fake pxr of tests/torch_pxr_shim.py: the cases of
tests/test_usd_adapter.py and the three Kitchen-corpus cases of
tests/test_usd_kitchen_corpus.py, on the CPU.  The JAX adapter is bound to
the same shim and Syncs the same scene delegate; every committed scene of
the port is held against the JAX adapter's, field by field and exactly.
The frames render on the port only (96 x 96 and 128 x 128)."""
import types

import numpy as np
import pytest

from diligentfx_tpu.hydrogent import usd_adapter as jua
from diligentfx_tpu.hydrogent.task_manager import TaskManagerCreateInfo
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.hydrogent import usd_adapter as tua
from tests import torch_pxr_shim as shim
from tests.torch_hydra_ref import assert_same_scene, small_port_renderer
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CI = TaskManagerCreateInfo(enable_ssao=False, enable_ssr=False,
                           enable_taa=False, enable_bloom=False)
BITS = shim._ChangeTracker


def make_delegates():
    """The port's adapter (on the CPU, the small renderer) and the JAX
    adapter (committing only), both bound to the shim."""
    tc = tua.build_adapter(shim.make_fake_pxr())
    jc = jua.build_adapter(shim.make_fake_pxr())
    trd = tc["RenderDelegate"](renderer=small_port_renderer(),
                               task_manager_ci=cv.task_manager_ci_from_jax(CI),
                               device="cpu")
    return tc, trd, jc, jc["RenderDelegate"]()


def assert_same_commit(trd, jrd):
    assert_same_scene(trd.inner._scene, jrd.inner._scene)


def test_supported_prim_types_match_jax():
    tc, trd, jc, jrd = make_delegates()
    assert trd.GetSupportedRprimTypes() == jrd.GetSupportedRprimTypes()
    assert trd.GetSupportedSprimTypes() == jrd.GetSupportedSprimTypes()
    assert trd.GetSupportedBprimTypes() == ["renderBuffer"]
    assert {"material", "camera", "distantLight"} <= set(
        trd.GetSupportedSprimTypes())
    assert trd.CreateRprim("volume", "/x") is None
    assert trd.CreateSprim("unknownType", "/x") is None
    assert sorted(tc) == sorted(jc)
    assert trd.GetResourceRegistry() is trd.inner.texture_registry


def _quad_stage():
    sd = shim.FakeSceneDelegate()
    sd.data["/World/quad"] = {
        "topology": shim.FakeMeshTopology([4], [0, 1, 2, 3]),
        "points": [[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]],
        "st": [[0, 0], [1, 0], [1, 1], [0, 1]],
        "materialId": "/World/mat",
    }
    sd.data["/World/mat"] = {"material": {
        "surface": {"diffuseColor": (0.9, 0.2, 0.1), "roughness": 0.4}}}
    cam_xf = np.eye(4, dtype=np.float32)
    cam_xf[3, :3] = (0.0, 0.0, 4.0)
    sd.data["/World/cam"] = {"transform": cam_xf,
                             "clippingRange": (0.1, 50.0), "fov": 60.0}
    sd.data["/World/sun"] = {"color": (1.0, 1.0, 1.0), "intensity": 3.0,
                             "transform": np.eye(4, dtype=np.float32)}
    sd.data["/World/aov"] = {"aov": "mesh_id"}
    return sd


def test_full_hydra_flow_renders_and_picks():
    tc, trd, jc, jrd = make_delegates()
    sd = _quad_stage()
    for rd in (trd, jrd):
        prims = (rd.CreateRprim("mesh", "/World/quad"),
                 rd.CreateSprim("material", "/World/mat"),
                 rd.CreateSprim("camera", "/World/cam"),
                 rd.CreateSprim("distantLight", "/World/sun"),
                 rd.CreateBprim("renderBuffer", "/World/aov"))
        for prim in prims:
            prim.Sync(sd, rd.GetRenderParam(), BITS.AllDirty)
        rd.CommitResources(None)
    assert_same_commit(trd, jrd)
    cam_t, cam_j = trd.inner.cameras["/World/cam"], jrd.inner.cameras[
        "/World/cam"]
    assert vars(cam_t).keys() == vars(cam_j).keys()
    for k in ("eye", "target", "fov_y", "near_z", "far_z"):
        assert getattr(cam_t, k) == getattr(cam_j, k)
    task = tc["RenderTask"](trd.inner, width=96, height=96,
                            camera_id="/World/cam")
    out = task.Execute()
    img = out.color.numpy()
    assert img.shape == (96, 96, 3) and np.isfinite(img).all()
    center = img[40:56, 40:56]
    assert center[..., 0].mean() > center[..., 2].mean()
    buf = trd._prims["/World/aov"]
    assert buf.Read()[48, 48] >= 0
    mesh = trd._prims["/World/quad"]
    trd.DestroyRprim(mesh)
    jrd.DestroyRprim(jrd._prims["/World/quad"])
    task.Execute()
    assert int((trd.inner.last_output.gbuffer.mesh_id >= 0).sum()) == 0
    jrd.CommitResources(None)
    assert_same_commit(trd, jrd)


def test_dirty_bits_gate_sync_work():
    tc, trd, jc, jrd = make_delegates()
    sd = shim.FakeSceneDelegate()
    sd.data["/m"] = {"topology": shim.FakeMeshTopology([3], [0, 1, 2]),
                     "points": [[0, 0, 0], [1, 0, 0], [0, 1, 0]]}
    meshes = [rd.CreateRprim("mesh", "/m") for rd in (trd, jrd)]
    for m in meshes:
        m.Sync(sd, None, BITS.AllDirty)
    p0 = trd.inner.meshes["/m"].points.copy()
    sd.data["/m"]["points"] = [[9, 9, 9], [9, 9, 9], [9, 9, 9]]
    xf = np.eye(4, dtype=np.float32)
    xf[3, 0] = 2.0
    sd.data["/m"]["transform"] = xf
    for m in meshes:
        m.Sync(sd, None, BITS.DirtyTransform)
    inner = trd.inner.meshes["/m"]
    assert np.allclose(inner.points, p0)
    assert inner.transform[3, 0] == 2.0
    for rd in (trd, jrd):
        rd.CommitResources(None)
    assert_same_commit(trd, jrd)


@pytest.mark.parametrize("light_type", ["distantLight", "sphereLight",
                                        "diskLight", "domeLight"])
def test_light_sync_matches_jax(light_type):
    tc, trd, jc, jrd = make_delegates()
    sd = shim.FakeSceneDelegate()
    xf = shim.look_transform((1.0, 2.0, 3.0), (0.0, 0.0, 0.0))
    env = np.full((4, 4, 3), 0.5, np.float32)
    sd.data["/l"] = {"transform": xf, "intensity": 2.0, "range": 12.0,
                     "color": (1.0, 0.5, 0.25), "shaping:cone:angle": 30.0,
                     "shadow:enable": True, "texture:file": env}
    lights = []
    for rd in (trd, jrd):
        rd.CreateSprim(light_type, "/l").Sync(sd, None, None)
        lights.append(rd.inner.lights["/l"])
    t, j = lights
    for k in ("type", "intensity", "range", "cone_angles", "cast_shadows"):
        assert getattr(t, k) == getattr(j, k), k
    np.testing.assert_array_equal(t.color, j.color)
    np.testing.assert_array_equal(t.direction, j.direction)
    np.testing.assert_array_equal(t.position, j.position)
    assert (t.dome_env is None) == (j.dome_env is None)
    if light_type == "distantLight":
        want = -np.array([1.0, 2.0, 3.0]) / np.sqrt(14.0)
        assert np.allclose(t.direction, want, atol=1e-6)


def test_light_transform_to_direction():
    tc, trd, jc, jrd = make_delegates()
    sd = shim.FakeSceneDelegate()
    sd.data["/sun"] = {"transform": np.eye(4, dtype=np.float32),
                       "intensity": 2.0}
    trd.CreateSprim("distantLight", "/sun").Sync(sd, None, None)
    light = trd.inner.lights["/sun"]
    assert np.allclose(light.direction, (0, 0, -1))
    assert light.intensity == 2.0


def test_material_network_map_conversion_matches_jax():
    tex = np.ones((4, 4, 4), np.float32)
    net = types.SimpleNamespace(
        nodes=[shim.node("/m/surf", "UsdPreviewSurface", {"roughness": 0.3}),
               shim.node("/m/tex", "UsdUVTexture",
                         {"file": tex, "wrapS": "clamp", "wrapT": "repeat"}),
               shim.node("/m/st", "UsdPrimvarReader_float2",
                         {"varname": "st"})],
        relationships=[shim.rel("/m/tex", "rgb", "/m/surf", "diffuseColor"),
                       shim.rel("/m/st", "result", "/m/tex", "st")])
    nm = types.SimpleNamespace(map={"surface": net})
    d = tua.material_network_from_hd(nm)
    assert d == jua.material_network_from_hd(nm)
    assert d["terminal"] == "/m/surf"
    assert ("/m/surf", "diffuseColor", "/m/tex", "rgb") in d["connections"]
    assert tua.material_network_from_hd({"surface": {}}) == {"surface": {}}
    assert tua.material_network_from_hd(object()) == {}
    from diligentfx_tpu_torch.hydrogent.material_network import \
        HnMaterialNetwork
    from diligentfx_tpu_torch.ops.sampling import WRAP_CLAMP, WRAP_REPEAT
    parsed = HnMaterialNetwork(d)
    desc = parsed.texture_for_slot(0)
    assert parsed.roughness == 0.3
    assert desc.wrap_u == WRAP_CLAMP and desc.wrap_v == WRAP_REPEAT


def test_fallback_prims_and_parallel_sync_flag():
    tc, trd, jc, jrd = make_delegates()
    assert trd.CreateFallbackSprim("material") is not None
    assert trd.CreateFallbackBprim("renderBuffer") is not None
    assert trd.IsParallelSyncEnabled("mesh") is True
    assert trd.CreateInstancer() is None
    assert trd.GetRenderParam() is trd.inner.render_param


def test_bind_usd_needs_pxr():
    try:
        import pxr  # noqa: F401
        pytest.skip("OpenUSD is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError):
        tua.bind_usd()
    from diligentfx_tpu_torch.hydrogent.render_delegate import bind_usd
    with pytest.raises(ImportError):
        bind_usd()


# ---------------------------------------------------------------------------
# the Kitchen-shaped corpus
# ---------------------------------------------------------------------------


@pytest.fixture
def kitchen():
    tc, trd, jc, jrd = make_delegates()
    sd = shim.FakeSceneDelegate()
    meshes, mats, lights, cam_id = shim.kitchen_corpus(sd)
    prims = [shim.populate(rd, sd, meshes, mats, lights, cam_id)
             for rd in (trd, jrd)]
    return tc, trd, jrd, sd, meshes, mats, cam_id, prims


def test_kitchen_corpus_full_flow(kitchen):
    tc, trd, jrd, sd, meshes, mats, cam_id, prims = kitchen
    assert_same_commit(trd, jrd)
    task = tc["RenderTask"](trd.inner, width=128, height=128,
                            camera_id=cam_id)
    img = task.Execute().color.numpy()
    assert img.shape == (128, 128, 3) and np.isfinite(img).all()
    assert img.std() > 0.01
    ids = trd.inner.last_output.gbuffer.mesh_id.numpy()
    assert len(set(np.unique(ids).tolist()) - {-1}) >= 8


def test_kitchen_corpus_incremental_invalidation(kitchen):
    """A clean re-sync keeps the image, a transform-only edit moves a prop
    (no geometry uploaded), a material edit propagates; each commit equals
    the JAX adapter's."""
    tc, trd, jrd, sd, meshes, mats, cam_id, prims = kitchen
    task = tc["RenderTask"](trd.inner, width=128, height=128,
                            camera_id=cam_id)
    img0 = task.Execute().color.numpy()
    for p in prims[0]:
        p.Sync(sd, trd.GetRenderParam(), 0)
    trd.CommitResources(None)
    np.testing.assert_array_equal(task.Execute().color.numpy(), img0)

    pid = meshes[0]
    xf = np.array(sd.data[pid]["transform"])
    xf[3, 0] += 10.0
    sd.data[pid]["transform"] = xf
    for rd_prims in prims:
        rd_prims[0].Sync(sd, None, BITS.DirtyTransform)
    img2 = task.Execute().color.numpy()
    assert np.abs(img2 - img0).max() > 1e-3
    assert trd.inner.geometry_pool.last_commit_upload_bytes == 0
    jrd.CommitResources(None)
    assert_same_commit(trd, jrd)

    m0 = mats[8]
    sd.data[m0] = {"material": shim.preview_surface_network(
        m0, diffuse=(0.95, 0.02, 0.02), rough=0.9, metallic=0.0)}
    for rd, rd_prims in zip((trd, jrd), prims):
        rd_prims[len(meshes) + 8].Sync(sd, None, BITS.AllDirty)
        rd.CommitResources(None)
    assert_same_commit(trd, jrd)
    img3 = task.Execute().color.numpy()
    assert np.abs(img3 - img2).max() > 1e-3


def test_kitchen_corpus_subset_materials(kitchen):
    tc, trd, jrd, sd, meshes, mats, cam_id, prims = kitchen
    subset_props = [m for i, m in enumerate(meshes) if i % 4 == 3]
    inner = trd.inner.meshes[subset_props[0]]
    assert len(inner.geom_subsets) == 2
    assert len({mid for mid, _ in inner.geom_subsets}) == 2
    scene = trd.inner._scene
    node = sorted(trd.inner.meshes).index(subset_props[0])
    tri_node = scene.vertex_node[scene.indices[:, 0].long()]
    assert len(set(scene.tri_material[tri_node == node].tolist())) >= 2
    np.testing.assert_array_equal(scene.tri_material.numpy(),
                                  np.asarray(jrd.inner._scene.tri_material))
