"""The port's Radient scene, assets, resolver and validation
(diligentfx_tpu_torch/radient/) against the JAX package's, on the CPU.

The operation sequences of tests/test_radient.py and
tests/test_radient_resolver.py run through both packages, each step's
result recorded: statuses, revisions, change lists, world matrices,
effective visibility, asset handles and load states, the asset managers'
stats, the drawable caches' counters, the validation messages and the
exceptions (type, status and text).  The two records must be equal,
exactly.  The port's engine runs on the CPU (device="cpu"); the JAX one
on its CPU backend.
"""
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

import diligentfx_tpu.attribs as jattribs
import diligentfx_tpu.radient.asset_manager as jam
import diligentfx_tpu.radient.engine as jeng
import diligentfx_tpu.radient.resolver as jres
import diligentfx_tpu.radient.scene_state as jss
import diligentfx_tpu.radient.types as jty
import diligentfx_tpu.radient.validation as jval
import diligentfx_tpu_torch.attribs as tattribs
import diligentfx_tpu_torch.radient.asset_manager as tam
import diligentfx_tpu_torch.radient.engine as teng
import diligentfx_tpu_torch.radient.resolver as tres
import diligentfx_tpu_torch.radient.scene_state as tss
import diligentfx_tpu_torch.radient.types as tty
import diligentfx_tpu_torch.radient.validation as tval
from diligentfx_tpu_torch.utils.image import write_png
from tests.test_gltf import make_quad_gltf
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(eng, am, res, ss, ty, val, attribs, device):
    kw = {} if device is None else {"device": device}
    return types.SimpleNamespace(
        eng=eng, am=am, res=res, ss=ss, ty=ty, val=val, attribs=attribs,
        engine=lambda ci=None: eng.create_radient_engine(
            ci or eng.RadientEngineCreateInfo(), **kw),
        manager=lambda **a: am.AssetManager(**a, **kw))


JAX = _pkg(jeng, jam, jres, jss, jty, jval, jattribs, None)
PORT = _pkg(teng, tam, tres, tss, tty, tval, tattribs, "cpu")


def tri_mesh(offset=0.0):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32) + offset
    idx = np.array([[0, 1, 2]], np.int32)
    return pos, idx


def _norm(v):
    """A value the two packages' records compare by: enums by class name,
    member name and value; arrays by dtype, shape and bytes; containers
    element by element."""
    if isinstance(v, np.ndarray):
        return (str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if hasattr(v, "name") and hasattr(v, "value"):
        return (type(v).__name__, v.name, int(v.value))
    return v


class Log(list):
    """A record of one run: values (_norm) and the exceptions raised (type
    name, status name, text)."""

    def add(self, *vals):
        self.extend(_norm(v) for v in vals)

    def raises(self, fn, *args, **kw):
        try:
            fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 — the record holds it
            st = getattr(e, "status", None)
            self.append((type(e).__name__, None if st is None else st.name,
                         str(e)))
            return
        self.append("no exception")


def both(run, *args):
    """run(pkg, log, *args) through both packages; the records equal."""
    logs = []
    for pkg in (JAX, PORT):
        log = Log()
        run(pkg, log, *args)
        logs.append(log)
    assert len(logs[0]) == len(logs[1])
    for i, (a, b) in enumerate(zip(*logs)):
        assert a == b, (i, a, b)
    return logs[1]


def stats(am):
    return tuple(sorted(vars(am.stats).items()))


# --- scene state / ECS -------------------------------------------------------


def _entity_lifecycle(pkg, log):
    s = pkg.ss.SceneState()
    log.add(s.revision)
    e = s.create_entity()
    log.add(e, s.is_alive(e), s.revision, s.entity_count)
    s.destroy_entity(e)
    log.add(s.is_alive(e), s.revision, s.entity_count)
    log.raises(s.set_visible, e, False)
    log.raises(s.world_transform, e)


def _hierarchy(pkg, log):
    s = pkg.ss.SceneState()
    parent, child = s.create_entity(), s.create_entity()
    s.set_parent(child, parent)
    t = np.eye(4, dtype=np.float32)
    t[3, :3] = [1, 2, 3]
    s.set_transform(parent, t)
    t2 = np.eye(4, dtype=np.float32)
    t2[3, :3] = [10, 0, 0]
    s.set_transform(child, t2)
    log.add(s.world_transform(child), s.world_transform(parent))
    s.set_visible(parent, False)
    log.add(s.effective_visible(child), s.visibility[child])
    log.raises(s.set_parent, parent, child)
    grand = s.create_entity()
    s.set_parent(grand, child)
    rng = np.random.default_rng(4)
    for e in (parent, child, grand):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rng.normal(size=(3, 3))
        m[3, :3] = rng.uniform(-3, 3, 3)
        s.set_transform(e, m)
    for e in (parent, child, grand):
        log.add(s.world_transform(e), s.effective_visible(e))
    s.set_visible(parent, True)
    s.destroy_entity(child)          # the grandchild becomes a root
    log.add(s.parents[grand], s.world_transform(grand),
            s.effective_visible(grand), s.revision)
    log.add(s.get_changes(0)[0], s.get_changes(0)[1])


def _change_log(pkg, log):
    s = pkg.ss.SceneState()
    e = s.create_entity()
    base = s.revision
    s.set_visible(e, False)
    s.set_visible(e, True)
    log.add(*s.get_changes(base))
    log.add(*s.get_changes(s.revision))
    for _ in range(5000):
        s.set_visible(e, True)
    log.add(s.get_changes(base)[0], s.revision)
    log.add(*s.get_changes(s.revision + 10))
    st, ch = s.get_changes(s.revision - pkg.ss._MAX_LOG)
    log.add(st, len(ch), ch[0], ch[-1])
    log.add(s.get_changes(s.revision - pkg.ss._MAX_LOG - 1)[0])


def _change_log_matrix(pkg, log):
    """test_change_log_window_and_invalidation_matrix's sequence."""
    st = pkg.ss.SceneState()
    base0 = st.revision
    parent, child = st.create_entity(), st.create_entity()
    st.set_parent(child, parent)
    t = np.eye(4, dtype=np.float32)
    t[3, 0] = 2.0
    st.set_transform(parent, t)
    log.add(*st.get_changes(base0))
    log.add(*st.get_changes(st.revision))
    log.add(*st.get_changes(st.revision + 5))
    log.add(st.world_transform(child))
    t2 = np.eye(4, dtype=np.float32)
    t2[3, 0] = 5.0
    st.set_transform(parent, t2)
    log.add(st.world_transform(child))
    st.set_visible(parent, False)
    log.add(st.effective_visible(child))
    st.set_visible(parent, True)
    log.add(st.effective_visible(child))
    base = st.revision
    st.destroy_entity(child)
    log.add(*st.get_changes(base))
    log.add(st.is_alive(child))
    base = st.revision
    e = st.create_entity()
    for i in range(pkg.ss._MAX_LOG + 8):
        ti = np.eye(4, dtype=np.float32)
        ti[3, 1] = float(i)
        st.set_transform(e, ti)
    log.add(st.get_changes(base)[0], st.revision, st.world_transform(e))
    light = pkg.ss.LightComponent(type="spot", intensity=3.0)
    st.set_light(e, light)
    st.set_camera(e, pkg.ss.CameraComponent(fov_y=0.5))
    st.set_display_color(e, (0.1, 0.2, 0.3, 1.0))
    st.set_material(e, 7)
    st.set_mesh(e, 3, 7)
    log.add(st.get_changes(st.revision - 5)[1],
            [(x, m.mesh_asset, m.material_asset)
             for x, m, _ in st.renderable_meshes()],
            [(x, lc.type, lc.intensity) for x, lc, _ in st.active_lights()])


@pytest.mark.parametrize("run", [_entity_lifecycle, _hierarchy, _change_log,
                                 _change_log_matrix],
                         ids=lambda f: f.__name__.strip("_"))
def test_scene_state_matches_jax(run):
    both(run)


# --- asset manager -----------------------------------------------------------


def _mesh_dedup(pkg, log):
    eng = pkg.engine()
    am = eng.asset_manager
    pos, idx = tri_mesh()
    h1 = am.create_mesh(pos, idx)
    h2 = am.create_mesh(pos.copy(), idx.copy())
    h3 = am.create_mesh(*tri_mesh(offset=1.0))
    log.add(h1, h2, h3, am.stats.dedup_hits)
    log.add(am.wait_for_asset_load(h1), am.wait_for_asset_load(h3))
    log.add(am.update_gpu_resources(), am.get_status(h1), am.get_status(h3))
    log.add(stats(am))
    log.raises(am.get_status, 99)
    m = am.meshes[h1]
    log.add(*(np.asarray(m.device[k]) for k in ("positions", "normals",
                                                 "uvs", "tangents",
                                                 "indices")))
    eng.shutdown()


def _texture_release_and_failure(pkg, log):
    eng = pkg.engine()
    am = eng.asset_manager
    released = []
    h = am.load_texture(np.zeros((4, 4, 3), np.uint8),
                        release_callback=lambda: released.append(1))
    log.add(h, am.wait_for_asset_load(h), released)
    h2 = am.load_texture("/nonexistent/file.png")
    log.add(h2, am.wait_for_asset_load(h2), am.textures[h2].error)
    log.add(am.update_gpu_resources(), am.get_atlas() is not None,
            am.textures[h].atlas_id, stats(am))
    eng.shutdown()


def _stop(pkg, log):
    eng = pkg.engine()
    am = eng.asset_manager
    log.add(am.create_mesh(*tri_mesh()))
    am.stop()
    log.raises(am.create_mesh, *tri_mesh(offset=2.0))
    log.raises(am.load_texture, np.zeros((2, 2, 3), np.uint8))


def _remote(pkg, log):
    """The REMOTE backend without an endpoint: the same error and status
    (the port's text names no JAX coordinator, test_remote_error_text)."""
    with pytest.raises(pkg.ty.RadientError) as ei:
        pkg.engine(pkg.eng.RadientEngineCreateInfo(
            backend_type=pkg.ty.RadientBackendType.REMOTE))
    log.add(ei.value.status)
    eng = pkg.engine(pkg.eng.RadientEngineCreateInfo(
        backend_type=pkg.ty.RadientBackendType.REMOTE,
        remote_endpoint="host:1234"))
    log.add(eng.ci.remote_endpoint)
    eng.shutdown()


def _headless_flow(pkg, log):
    eng = pkg.engine(pkg.eng.RadientEngineCreateInfo(headless=True))
    scene, state = eng.create_scene()
    writer = eng.create_scene_writer(state)
    am = eng.asset_manager
    mh = am.create_mesh(*tri_mesh())
    mat = am.create_material(pkg.attribs.PBRMaterialBasicAttribs.create())
    e = writer.create_entity()
    writer.set_mesh(e, mh, mat)
    renderer = eng.create_renderer()
    view = eng.create_view(64, 64)
    am.wait_for_asset_load(mh)
    log.add(renderer.update(state), renderer.render(state, view),
            view.last_frame is None, scene.revision, scene.entity_count(),
            scene.is_visible(e), scene.world_transform(e))
    log.add(*scene.get_changes(0))
    eng.shutdown()


def _incremental_sync(pkg, log):
    eng = pkg.engine(pkg.eng.RadientEngineCreateInfo(headless=True))
    _, state = eng.create_scene()
    writer = eng.create_scene_writer(state)
    am = eng.asset_manager
    mh = am.create_mesh(*tri_mesh())
    mat = am.create_material(pkg.attribs.PBRMaterialBasicAttribs.create())
    e = writer.create_entity()
    writer.set_mesh(e, mh, mat)
    am.wait_for_asset_load(mh)
    am.update_gpu_resources()
    cache = eng.create_renderer()._cache_for(state)
    log.add(cache.sync_scene(), cache.full_rebuilds, cache.incremental_syncs)
    t = np.eye(4, dtype=np.float32)
    t[3, 0] = 5.0
    writer.set_transform(e, t)
    log.add(cache.sync_scene(), cache.full_rebuilds, cache.incremental_syncs)
    sp = cache.scene_primitives
    log.add(np.asarray(sp.node_matrices), np.asarray(sp.prev_node_matrices))
    log.add(cache.sync_scene(), cache.incremental_syncs,
            np.asarray(cache.scene_primitives.prev_node_matrices))
    e2 = writer.create_entity()
    writer.set_mesh(e2, mh, mat)
    log.add(cache.sync_scene(), cache.full_rebuilds,
            np.asarray(cache.scene_primitives.indices),
            np.asarray(cache.scene_primitives.vertex_node))
    writer.set_mesh(e2, 999, mat)
    log.add(cache.sync_scene())
    eng.shutdown()


def _pending_and_no_gpu_data(pkg, log):
    eng = pkg.engine(pkg.eng.RadientEngineCreateInfo(headless=True,
                                                     num_loading_threads=1))
    _, state = eng.create_scene()
    writer = eng.create_scene_writer(state)
    am = eng.asset_manager
    gate, entered = threading.Event(), threading.Event()

    def blocker():
        entered.set()
        assert gate.wait(timeout=30.0)
    am._pool.submit(blocker)
    assert entered.wait(timeout=10.0)
    mh = am.create_mesh(*tri_mesh())
    mat = am.create_material(pkg.attribs.PBRMaterialBasicAttribs.create())
    e = writer.create_entity()
    writer.set_mesh(e, mh, mat)
    renderer = eng.create_renderer()
    cache = renderer._cache_for(state)
    log.add(am.get_status(mh), cache.sync_scene(), am.stats.pending_uploads)
    log.add(am.create_mesh(*tri_mesh()), am.stats.dedup_hits)
    gate.set()
    log.add(am.wait_for_asset_load(mh, timeout=30.0), cache.sync_scene())
    log.add(renderer.update(state), am.get_status(mh), stats(am))
    eng.shutdown()


def _texture_spy(pkg, log):
    am = pkg.manager(num_threads=1)
    calls = []
    img = np.random.default_rng(3).random((8, 8, 4)).astype(np.float32)
    h = am.load_texture(img, release_callback=lambda: calls.append(1))
    am.wait_for_asset_load(h, timeout=30.0)
    log.add(am.update_gpu_resources(), am.textures[h].status, sum(calls))
    h2 = am.load_texture(img.copy(),
                         release_callback=lambda: calls.append(10))
    log.add(h2 == h, am.update_gpu_resources(), sum(calls), stats(am))
    am.stop()


@pytest.mark.parametrize("run", [_mesh_dedup, _texture_release_and_failure,
                                 _stop, _remote, _headless_flow,
                                 _incremental_sync, _pending_and_no_gpu_data,
                                 _texture_spy],
                         ids=lambda f: f.__name__.strip("_"))
def test_asset_manager_and_cache_match_jax(run):
    both(run)


def test_port_commits_tensors_on_its_device():
    eng = PORT.engine()
    am = eng.asset_manager
    h = am.create_mesh(*tri_mesh())
    am.wait_for_asset_load(h)
    am.update_gpu_resources()
    d = am.meshes[h].device
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in d.values())
    assert d["indices"].dtype == torch.int32
    # the committed tensors are copies of the host payload
    am.meshes[h].positions[0, 0] = 42.0
    assert float(d["positions"][0, 0]) == 0.0
    assert eng.device == am.device == am._tex_registry.device
    eng.shutdown()


def test_remote_error_text():
    with pytest.raises(tty.RadientError) as ei:
        PORT.engine(teng.RadientEngineCreateInfo(
            backend_type=tty.RadientBackendType.REMOTE))
    assert str(ei.value) == ("INVALID_ARGUMENT: REMOTE backend requires an "
                             "endpoint (the remote host's address)")


# --- resolver and validation ---------------------------------------------------

QUAD_P = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
QUAD_I = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
MESH_CASES = [
    dict(positions=np.zeros((0, 3), np.float32), indices=QUAD_I),
    dict(positions=np.zeros((4, 2), np.float32), indices=QUAD_I),
    dict(positions=QUAD_P, indices=np.array([], np.int32)),
    dict(positions=QUAD_P, indices=np.array([0, 1], np.int32)),
    dict(positions=QUAD_P, indices=QUAD_I.reshape(3, 2)),
    dict(positions=QUAD_P, indices=QUAD_I.astype(np.float32)),
    dict(positions=QUAD_P, indices=QUAD_I + 3),
    dict(positions=QUAD_P, indices=QUAD_I - 1),
    dict(positions=QUAD_P, indices=QUAD_I,
         normals=np.zeros((3, 3), np.float32)),
    dict(positions=QUAD_P, indices=QUAD_I, uvs=np.zeros((4, 3), np.float32)),
    dict(positions=QUAD_P, indices=QUAD_I,
         tangents=np.zeros((4, 3), np.float32)),
    dict(positions=QUAD_P, indices=QUAD_I, joints=np.zeros((4, 4), np.int32)),
    dict(positions=QUAD_P, indices=QUAD_I, joints=np.zeros((4, 3), np.int32),
         weights=np.zeros((4, 4), np.float32)),
    dict(positions=QUAD_P, indices=QUAD_I,
         normals=np.zeros((4, 3), np.float32),
         uvs=np.zeros((4, 2), np.float32), joints=np.zeros((4, 4), np.int32),
         weights=np.zeros((4, 4), np.float32)),
]


@pytest.mark.parametrize("i", range(len(MESH_CASES)))
def test_validate_mesh_inputs_matches_jax(i):
    kw = MESH_CASES[i]
    assert (tval.validate_mesh_inputs(**kw)
            == jval.validate_mesh_inputs(**kw))
    if i < len(MESH_CASES) - 1:
        assert tval.validate_mesh_inputs(**kw) is not None


def test_validate_texture_and_scene_load_match_jax():
    for src in (None, "", "a.png", np.zeros((4, 4, 5)), np.zeros((0, 4, 3)),
                np.zeros((4, 0)), np.zeros(4), np.zeros((4, 4, 3))):
        assert (tval.validate_texture_load(src)
                == jval.validate_texture_load(src))
    for uri, fmt in (("", "auto"), (None, "auto"), ("s.gltf", "fbx"),
                     ("s.gltf", "auto"), ("s.glb", "glb")):
        assert (tval.validate_scene_load(uri, fmt)
                == jval.validate_scene_load(uri, fmt))


def _resolvers(pkg, log, tmp):
    sub = os.path.join(tmp, "textures")
    os.makedirs(sub, exist_ok=True)
    with open(os.path.join(sub, "a.bin"), "wb") as f:
        f.write(b"hello")
    with open(os.path.join(tmp, "x.bin"), "wb") as f:
        f.write(b"fs")
    r = pkg.res.FilesystemAssetResolver(roots=[tmp, sub])
    for uri in ("a.bin", "textures/a.bin", "file://" + os.path.join(sub,
                                                                     "a.bin"),
                "missing.bin", "mem://a.bin", "http://h/a.bin"):
        log.add(r.can_resolve(uri), tuple(r.resolve(uri) or ()))
    chain = pkg.res.AssetResolverChain(
        [pkg.res.FilesystemAssetResolver([tmp])])
    log.add(tuple(chain.resolve("x.bin")))
    chain.push_front(pkg.res.MemoryAssetResolver({"x.bin": b"mem"}))
    for uri in ("x.bin", "mem://x.bin", "mem://nope"):
        log.add(tuple(chain.resolve(uri) or ()))


def test_resolvers_match_jax(tmp_path):
    both(_resolvers, str(tmp_path))


def _texture_uris(pkg, log, tmp):
    png = os.path.join(tmp, "t.png")
    write_png(png, np.full((4, 4, 3), 0.5, np.float32))
    am = pkg.manager(num_threads=1, resolver_chain=pkg.res.AssetResolverChain(
        [pkg.res.FilesystemAssetResolver([tmp])]))
    h1 = am.load_texture("t.png")
    h2 = am.load_texture(png)
    h3 = am.load_texture("file://" + png)
    log.add(h1, h2, h3, am.stats.dedup_hits, am.wait_for_asset_load(h1))
    log.add(am.textures[h1].image)
    hm = am.load_texture("missing.png")
    log.add(hm, am.wait_for_asset_load(hm), am.textures[hm].error)
    log.raises(am.load_texture, "")
    log.raises(am.load_texture, np.zeros((4, 4, 5)))
    log.raises(am.create_mesh, QUAD_P, QUAD_I + 9)
    log.raises(am.create_mesh, np.zeros((0, 3), np.float32), QUAD_I)
    log.add(am.update_gpu_resources(), stats(am))
    am.stop()


def test_texture_uris_match_jax(tmp_path):
    both(_texture_uris, str(tmp_path))


def _import_gltf(pkg, log, doc):
    eng = pkg.engine()
    am = eng.asset_manager
    am.resolver.push_front(pkg.res.MemoryAssetResolver({"quad.gltf": doc}))
    scene, state = eng.create_scene()
    imp = eng.create_scene_importer(state)
    log.add(imp.import_gltf("mem://quad.gltf"), scene.entity_count(),
            scene.revision)
    log.add(imp.import_gltf("mem://absent.gltf"), imp.import_gltf(""),
            imp.import_gltf("mem://quad.gltf"), am.stats.dedup_hits)
    log.add(*scene.get_changes(0))
    for e, mc, world in state.renderable_meshes():
        mat = am.materials[mc.material_asset]
        log.add(e, mc.mesh_asset, mc.material_asset, world,
                mat.double_sided,
                *(np.asarray(getattr(mat.attribs, f))
                  for f in tattribs.PBRMaterialBasicAttribs._fields))
    eng.shutdown()


def test_import_gltf_through_memory_resolver_matches_jax(tmp_path):
    path = make_quad_gltf(str(tmp_path), with_texture=False)
    with open(path, "rb") as f:
        both(_import_gltf, f.read())


# --- the port's own contract ---------------------------------------------------


def test_engine_raises_without_cuda_unless_cpu(monkeypatch):
    """create_radient_engine runs on the card unless the caller asks for
    the CPU; without CUDA it raises (no CPU detour)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teng.create_radient_engine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tam.AssetManager()
    eng = teng.create_radient_engine(device="cpu")
    assert eng.device.type == "cpu"
    eng.shutdown()


def test_radient_imports_without_jax():
    """diligentfx_tpu_torch.radient with jax blocked in sys.modules: no
    module of it reaches for JAX or the JAX package."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'diligentfx_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import diligentfx_tpu_torch.radient\n"
            "import diligentfx_tpu_torch.radient.c_api\n"
            "import diligentfx_tpu_torch.radient.render_pipeline\n"
            "import diligentfx_tpu_torch.utils.cache\n"
            "import diligentfx_tpu_torch.ops.packing\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
