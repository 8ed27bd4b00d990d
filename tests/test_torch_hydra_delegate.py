"""The port's Hydra render delegate (diligentfx_tpu_torch/hydrogent/
render_delegate.py) against the JAX package's, on the CPU.

The same numpy prims, made from seeds, are posted to both delegates: the
Kitchen-shaped stage of tests/torch_pxr_shim.py (24 props of quads,
triangles, pentagons and geom subsets; 12 UsdPreviewSurface networks, 8
textured, with normal maps and UsdTransform2d), a triangle mesh with
authored normals, a prop posted twice (one pool entry), a mesh with no
material, a distant, a point and a spot light, and a camera.  Tolerances:

  * the committed ScenePrimitives (every field), the atlas, the pool and
    the memory stats: exact;
  * the SOLID frame at 128 x 64 (the smallest task-manager config: SSAO,
    SSR, TAA and bloom off; the JAX renderer takes the port's IBL maps):
    colour above 50 dB (measured 88.8 dB), mesh ids exact;
  * EDGES against `render_geometry_mode.__wrapped__` (the JAX function
    run eagerly, its raster's inner programs jitted): at most 8 of the
    8,192 pixels differ (measured 3), each a knife-edge pixel whose
    barycentric distance lies within 1e-3 of the 0.06 edge test or on a
    triangle boundary; POINTS exact.
"""
import threading
import time

import numpy as np
import pytest
import torch

from diligentfx_tpu import math3d as jm3
from diligentfx_tpu.attribs import (CameraAttribs, PBRLightAttribs,
                                    PBRRendererShaderParameters)
from diligentfx_tpu.hydrogent import render_delegate as jrd
from diligentfx_tpu.hydrogent.task_manager import TaskManagerCreateInfo
from diligentfx_tpu.pbr.renderer import RenderInfo
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.hydrogent import render_delegate as trd
from diligentfx_tpu_torch.hydrogent.geometry_pool import HnGeometryPool
from diligentfx_tpu_torch.hydrogent.usd_adapter import \
    material_network_from_hd
from diligentfx_tpu_torch.ops import raster as tr
from diligentfx_tpu_torch.utils.image import psnr
from tests import torch_pxr_shim as shim
from tests.test_torch_material_ext import jax_and_port_renderers
from tests.torch_hydra_ref import assert_same_scene, small_port_renderer
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 128, 64
CI = TaskManagerCreateInfo(enable_ssao=False, enable_ssr=False,
                           enable_taa=False, enable_bloom=False)
EYE, TARGET, FOV = (0.3, 0.4, 6.0), (0.0, 0.0, 0.0), 0.9
MOVED = ("/Kitchen/Geom/prop000", "/Kitchen/Geom/prop007",
         "/stage/tri")


def post_stage(d):
    """The stage's prims, posted through the delegate protocol."""
    sd = shim.FakeSceneDelegate()
    mats = shim.kitchen_materials(sd)
    meshes = shim.kitchen_props(sd, mats)
    for mid in mats:
        d.create_sprim("material", mid).set_network(
            material_network_from_hd(sd.data[mid]["material"]))
    for pid in meshes:
        data = sd.data[pid]
        topo = data["topology"]
        m = d.create_rprim("mesh", pid)
        m.set_topology(topo.GetFaceVertexCounts(),
                       topo.GetFaceVertexIndices())
        if topo.GetGeomSubsets():
            m.set_geom_subsets([(s.materialId, s.indices)
                                for s in topo.GetGeomSubsets()])
        m.set_points(data["points"])
        m.set_primvar("st", data["st"])
        m.set_transform(data["transform"])
        m.set_material(data["materialId"])
    rng = np.random.default_rng(21)
    tri = d.create_rprim("mesh", "/stage/tri")
    tri.set_points([[-3.2, 1.2, 0.5], [-1.9, 1.1, 0.6], [-2.6, 2.3, 0.4]])
    tri.set_triangles([[0, 1, 2]])
    tri.set_primvar("normals", rng.normal(size=(3, 3)) * 0.1 + [0, 0, 1])
    tri.set_material(mats[9])
    src = d.meshes[meshes[5]]
    copy = d.create_rprim("mesh", "/stage/copy")     # prop005's content
    copy.set_topology(*_faces(sd, meshes[5]))
    copy.set_points(src.points)
    copy.set_primvar("st", src.uvs)
    xf = np.eye(4, dtype=np.float32)
    xf[3, :3] = (2.9, -2.2, 0.3)
    copy.set_transform(xf)
    copy.set_material(mats[6])
    bare = d.create_rprim("mesh", "/stage/bare")     # no material
    bare.set_points([[2.2, 1.0, 0.8], [3.4, 1.0, 0.8], [3.4, 2.0, 0.8],
                     [2.2, 2.0, 0.8]])
    bare.set_topology([4], [0, 1, 2, 3])
    d.create_sprim("camera", "/stage/cam").set_params(
        eye=EYE, target=TARGET, fov_y=FOV, near_z=0.1, far_z=50.0)
    d.create_sprim("light", "/stage/sun").set_params(
        type="distant", direction=(-0.3, -0.5, -1.0), intensity=3.0)
    d.create_sprim("light", "/stage/bulb").set_params(
        type="point", position=(1.0, 2.0, 2.0), color=(1.0, 0.8, 0.6),
        intensity=8.0, range=20.0)
    d.create_sprim("light", "/stage/spot").set_params(
        type="spot", position=(-1.0, 1.0, 3.0), direction=(0.2, -0.2, -1.0),
        cone_angles=(0.1, 0.5), intensity=6.0)
    return meshes


def _faces(sd, pid):
    topo = sd.data[pid]["topology"]
    return topo.GetFaceVertexCounts(), topo.GetFaceVertexIndices()


@pytest.fixture(scope="module")
def run():
    """Both delegates on the stage: the commit, a SOLID frame, then a
    transform-only edit of three prims and the next two frames (the JAX
    frames share one compile)."""
    ren, port = jax_and_port_renderers()
    pd = trd.HnRenderDelegate(
        trd.HnRenderDelegateCreateInfo(atlas_size=256), renderer=port,
        task_manager_ci=cv.task_manager_ci_from_jax(CI), device="cpu")
    jd = jrd.HnRenderDelegate(jrd.HnRenderDelegateCreateInfo(atlas_size=256),
                              renderer=ren, task_manager_ci=CI)
    res = {"pd": pd, "jd": jd, "ren": ren, "port": port}
    for d in (pd, jd):
        post_stage(d)
    res["commit"] = (pd.commit_resources(), jd.commit_resources())
    res["frame1"] = (pd.execute(W, H), jd.execute(W, H))
    res["picks"] = [(x, y, pd.read_rprim_id(x, y), jd.read_rprim_id(x, y))
                    for y in range(0, H, 5) for x in range(0, W, 7)]
    res["scene1"] = pd._scene
    for d in (pd, jd):
        for k, pid in enumerate(MOVED):
            xf = np.array(d.meshes[pid].transform)
            xf[3, :3] += (0.15 * (k + 1), -0.1, 0.0)
            d.meshes[pid].set_transform(xf)
    res["frame2"] = (pd.execute(W, H), jd.execute(W, H))
    res["scene2"] = (pd._scene, jd._scene)
    res["frame3"] = pd.execute(W, H)
    return res


def test_committed_scene_matches_jax(run):
    ts, js = run["commit"]
    assert_same_scene(ts, js)
    assert ts.tex_ids is not None
    # the subsets relabel faces: some prop spans several material slots
    tri_node = ts.vertex_node[ts.indices[:, 0].long()]
    spans = [len(set(ts.tri_material[tri_node == n].tolist()))
             for n in range(ts.node_matrices.shape[0])]
    assert max(spans) >= 2


def test_committed_atlas_and_pool_match_jax(run):
    pd, jd = run["pd"], run["jd"]
    a, b = pd._atlas, jd._atlas
    for x, y in zip(a.mips, b.mips):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(a.scale_bias.numpy(),
                                  np.asarray(b.scale_bias))
    p, j = pd.geometry_pool, jd.geometry_pool
    assert p.stats() == j.stats()
    assert {k: p.range_of(k) for k in p._entries} == {
        k: j.range_of(k) for k in j._entries}
    # /stage/copy shares prop005's entry
    assert pd._mesh_geo["/stage/copy"] == pd._mesh_geo[
        "/Kitchen/Geom/prop005"]
    assert p.stats()["instances"] == p.stats()["entries"] + 1
    assert vars(pd.get_memory_stats()) == vars(jd.get_memory_stats())


def test_empty_stage_matches_jax():
    ds = (trd.HnRenderDelegate(device="cpu"), jrd.HnRenderDelegate())
    for d in ds:
        d.create_sprim("camera", "/cam")
        m = d.create_rprim("mesh", "/no_points")     # never gets points
        m.set_triangles([[0, 1, 2]])
    ts, js = (d.commit_resources() for d in ds)
    assert_same_scene(ts, js)
    assert ts.num_triangles == 1 and ts.tex_ids is None


def test_solid_frame_matches_jax(run):
    pout, jout = run["frame1"]
    a, b = np.asarray(jout.color), pout.color.numpy()
    assert b.shape == (H, W, 3)
    assert np.isfinite(b).all() and b.min() >= 0.0 and b.max() <= 1.0
    assert psnr(a, b) > 50.0, psnr(a, b)
    np.testing.assert_array_equal(pout.gbuffer.mesh_id.numpy(),
                                  np.asarray(jout.gbuffer.mesh_id))
    seen = set(np.unique(pout.gbuffer.mesh_id.numpy()).tolist())
    assert len(seen - {-1}) >= 20


def test_picking_matches_jax(run):
    picks = run["picks"]
    assert all(p == j for _, _, p, j in picks)
    assert len({p for _, _, p, _ in picks}) >= 10
    pd = run["pd"]
    buf = pd.create_bprim("renderBuffer", "/aov", aov="mesh_id")
    np.testing.assert_array_equal(buf.read().numpy(),
                                  pd.last_output.gbuffer.mesh_id.numpy())
    assert pd.create_bprim("renderBuffer", "/c").read() is \
        pd.last_output.color


def test_transform_only_commit_matches_jax(run):
    """A transform edit commits only the node matrices: no geometry is
    re-gathered or uploaded, the matrices equal JAX's, and after the frame
    the previous matrices fold into the current ones."""
    ts, js = run["scene2"]
    s1 = run["scene1"]
    assert ts.positions is s1.positions and ts.indices is s1.indices
    assert run["pd"].geometry_pool.last_commit_upload_bytes == 0
    assert_same_scene(ts, js)
    assert ts.prev_node_matrices is ts.node_matrices      # folded
    moved = [run["pd"]._mesh_slots[p] for p in MOVED]
    changed = (ts.node_matrices != s1.node_matrices).any(-1).any(-1)
    assert sorted(torch.nonzero(changed).flatten().tolist()) == sorted(moved)
    pout, jout = run["frame2"]
    assert psnr(np.asarray(jout.color), pout.color.numpy()) > 50.0


def test_moved_prims_carry_motion_then_none(run):
    """The frame after the edit: motion on the moved prims' pixels, none
    on still pixels; the next frame: no motion anywhere."""
    g2 = run["frame2"][0].gbuffer
    ids = g2.mesh_id
    moved = torch.zeros_like(ids, dtype=torch.bool)
    for p in MOVED:
        moved |= ids == run["pd"]._mesh_slots[p]
    speed = torch.linalg.vector_norm(g2.motion, dim=-1)
    assert moved.sum() > 20
    assert float(speed[moved].median()) > 1e-3
    still = (ids >= 0) & ~moved
    assert float(speed[still].max()) < 1e-5
    g3 = run["frame3"].gbuffer
    assert float(torch.linalg.vector_norm(g3.motion, dim=-1).max()) < 1e-5


def _jax_info(w, h):
    cam = CameraAttribs.create(jm3.look_at(list(EYE), list(TARGET)),
                               jm3.perspective(FOV, w / h, 0.1, 50.0),
                               list(EYE), 0.1, 50.0, w, h)
    return RenderInfo(camera=cam,
                      lights=PBRLightAttribs.directional((0, -1, 0),
                                                         (3, 3, 3)),
                      renderer_params=PBRRendererShaderParameters.create())


def test_geometry_modes_match_jax(run):
    pd, jd = run["pd"], run["jd"]
    ts, js = run["scene2"]
    tinfo, jinfo = pd.frame_info(W, H), _jax_info(W, H)
    np.testing.assert_array_equal(tinfo.camera.view_proj.numpy(),
                                  np.asarray(jinfo.camera.view_proj))
    cfg = run["port"].raster_cfg
    out = {}
    for mode in (trd.HnGeometryMode.EDGES, trd.HnGeometryMode.POINTS):
        a = np.asarray(jrd.render_geometry_mode.__wrapped__(
            js, jinfo, width=W, height=H, cfg=run["ren"].raster_cfg,
            mode=mode))
        b = trd.render_geometry_mode(ts, tinfo, width=W, height=H, cfg=cfg,
                                     mode=mode).numpy()
        assert b.shape == (H, W, 3) and np.isfinite(b).all()
        out[mode] = (a, b)
    a, b = out[trd.HnGeometryMode.POINTS]
    np.testing.assert_array_equal(a, b)
    a, b = out[trd.HnGeometryMode.EDGES]
    diff = np.abs(a - b).max(-1) > 0
    assert diff.sum() <= 8, diff.sum()
    # each differing pixel is a knife edge of the port's own raster
    pad_w, pad_h = tr.pad_viewport(W, H, cfg)
    wp, _, _ = trd.transform_vertices(ts)
    vb, _ = tr.rasterize(trd.m3.transform_points(wp, tinfo.camera.view_proj),
                         ts.indices, width=pad_w, height=pad_h, cfg=cfg,
                         double_sided=ts.tri_double_sided)
    l0, l1 = vb.bary[:H, :W, 0].numpy(), vb.bary[:H, :W, 1].numpy()
    d = np.minimum(np.minimum(l0, l1), 1.0 - l0 - l1)
    tid = vb.tri_id[:H, :W].numpy()
    boundary = np.zeros_like(diff)
    boundary[1:] |= tid[1:] != tid[:-1]
    boundary[:-1] |= tid[1:] != tid[:-1]
    boundary[:, 1:] |= tid[:, 1:] != tid[:, :-1]
    boundary[:, :-1] |= tid[:, 1:] != tid[:, :-1]
    assert (np.abs(d[diff] - 0.06) < 1e-3).sum() + boundary[diff].sum() \
        >= diff.sum()
    assert b.std() > 1e-3 and not np.allclose(*(x[1] for x in out.values()))


def test_delegate_geometry_modes_through_execute(run):
    pd = run["pd"]
    outs = {}
    for mode in (trd.HnGeometryMode.EDGES, trd.HnGeometryMode.POINTS):
        pd.render_param.geometry_mode = mode
        outs[mode] = pd.execute(W, H)
    pd.render_param.geometry_mode = trd.HnGeometryMode.SOLID
    ts = pd._scene
    for mode, out in outs.items():
        assert out.gbuffer is None
        np.testing.assert_array_equal(
            out.color.numpy(),
            trd.render_geometry_mode(ts, pd.frame_info(W, H), width=W,
                                     height=H, cfg=run["port"].raster_cfg,
                                     mode=mode).numpy())


def _tri_delegate():
    d = trd.HnRenderDelegate(renderer=small_port_renderer(), device="cpu",
                             task_manager_ci=cv.task_manager_ci_from_jax(CI))
    d.create_sprim("camera", "/cam").set_params(eye=(0, 0, 6),
                                                target=(0, 0, 0))
    return d


def test_visibility_and_destroy():
    d = _tri_delegate()
    for name, x0 in (("/left", -3.0), ("/right", 0.5)):
        m = d.create_rprim("mesh", name)
        m.set_points([[x0, -1, 0], [x0 + 2.5, -1, 0], [x0 + 1.25, 2, 0]])
        m.set_triangles([[0, 1, 2]])
    d.execute(128, 128)
    ids = d.last_output.gbuffer.mesh_id.numpy()
    assert (ids == 0).any() and (ids == 1).any()
    d.meshes["/right"].set_visibility(False)
    d.execute(128, 128)
    assert not (d.last_output.gbuffer.mesh_id.numpy() == 1).any()
    d.destroy_prim("/left")                 # no manual _scene_dirty
    d.execute(128, 128)
    assert (d.last_output.gbuffer.mesh_id.numpy() == -1).all()
    assert d.get_memory_stats().num_meshes == 1
    assert d.geometry_pool.stats()["entries"] == 1   # /right keeps its entry
    d.destroy_prim("/right")
    out = d.execute(128, 128)                # the empty stage still renders
    assert np.isfinite(out.color.numpy()).all()
    assert d.geometry_pool.stats()["entries"] == 0
    assert d.read_rprim_id(64, 64) == -1


class _StubTaskManager:
    """Stands in for the JAX delegate's task manager: the budget test
    compares what the delegates commit, so no JAX frame is compiled."""
    atlas = None

    def initial_state(self, width, height):
        return None

    def execute(self, scene, info, state, width, height):
        return _StubFrame()


class _StubFrame:
    color = gbuffer = state = None


def test_geometry_budget_pending_renders_later():
    """A geometry budget of one entry a commit leaves the rest PENDING:
    each frame renders what is resident, and later frames bring the rest
    in.  The port's per-frame sequence of (scene nodes, resident entries,
    pending entries) and its committed scenes equal the JAX delegate's on
    the same stage and budget (the JAX task manager stubbed; the port
    renders).  A frame commits three entries first (the scene's commit,
    the per-frame pump, the rebuild's commit), then two a frame."""
    ci = dict(geometry_load_budget_bytes=1, atlas_size=256)
    d = trd.HnRenderDelegate(
        trd.HnRenderDelegateCreateInfo(**ci),
        renderer=small_port_renderer(), device="cpu",
        task_manager_ci=cv.task_manager_ci_from_jax(CI))
    jd = jrd.HnRenderDelegate(jrd.HnRenderDelegateCreateInfo(**ci))
    jd._tm = _StubTaskManager()
    for x in (d, jd):
        post_stage(x)
    n = len(d.meshes)
    entries = n - 1                          # /stage/copy shares one

    def step(x):
        pool = x.geometry_pool
        return (int(x._scene.node_matrices.shape[0]),
                sum(pool.is_resident(k) for k in x._mesh_geo.values()),
                pool.num_pending)

    seen, jseen = [], []
    while True:
        d.execute(W, H)
        jd.execute(W, H)
        seen.append(step(d))
        jseen.append(step(jd))
        assert_same_scene(d._scene, jd._scene)
        assert np.isfinite(d.last_output.color.numpy()).all()
        if not (d.geometry_pool.num_pending or jd.geometry_pool.num_pending):
            break
        assert len(seen) < n
    assert seen == jseen
    # props 0-2 after the first frame, then two entries a frame (prop005's
    # entry brings /stage/copy with it)
    assert seen[:3] == [(3, 3, entries - 3), (5, 5, entries - 5),
                        (8, 8, entries - 7)]
    assert seen[-1] == (n, n, 0)


def test_parallel_prim_sync_deterministic_and_threaded(monkeypatch):
    """allow_parallel_sync fans the per-mesh host prep across a thread
    pool; the registration stays serial in prim order, so the committed
    scene and the pool layout are bit-identical to the serial path, and the
    prep is seen on more than one thread."""
    def build(parallel):
        d = trd.HnRenderDelegate(trd.HnRenderDelegateCreateInfo(
            allow_parallel_sync=parallel), device="cpu")
        rng = np.random.default_rng(7)
        for i in range(10):
            m = d.create_rprim("mesh", f"/m{i}")
            n = 12 + (i % 3) * 4
            pts = rng.random((n, 3), np.float32)
            idx = np.stack([np.zeros(n - 2), np.arange(1, n - 1),
                            np.arange(2, n)], -1).astype(np.int32)
            if i == 9:        # duplicate of mesh 8: dedup in prim order
                prev = d.meshes["/m8"]
                m.set_triangles(prev.indices)
                m.set_points(prev.points)
            else:
                m.set_triangles(idx)
                m.set_points(pts)
        d.commit_resources()
        return d
    ser, par = build(False), build(True)
    for f in ("positions", "normals", "tangents", "indices", "vertex_node"):
        assert torch.equal(getattr(ser._scene, f), getattr(par._scene, f))
    assert ({k: e.v_off for k, e in ser.geometry_pool._entries.items()}
            == {k: e.v_off for k, e in par.geometry_pool._entries.items()})
    assert ser.geometry_pool.stats()["entries"] == 9
    seen = set()
    orig = HnGeometryPool.prepare_content

    def spy(points, normals, uvs, indices):
        seen.add(threading.get_ident())
        time.sleep(0.02)           # hold the slot so both workers engage
        return orig(points, normals, uvs, indices)
    monkeypatch.setattr(HnGeometryPool, "prepare_content", staticmethod(spy))
    build(True)
    assert len(seen) > 1, "parallel sync never left the calling thread"


def test_delegate_needs_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trd.HnRenderDelegate()
    with pytest.raises(ValueError, match="renderer is on"):
        trd.HnRenderDelegate(renderer=small_port_renderer(),
                             device=torch.device("meta"))
