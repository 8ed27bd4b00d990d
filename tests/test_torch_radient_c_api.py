"""Radient's public C API in the port (native/src/radient_c.cpp, compiled
into the port's native library with dfx_native.cpp; radient/c_api.py)
against the JAX package's (its own g++ build of the same source), on the
CPU.

The operation sequences of tests/test_radient_c_api.py run through both
wrappers: handles (relative to their engine's), dedup flags, reference
counts, load states, mesh info and payloads, revisions, change lists,
world matrices and renderables are equal, exactly.  The plain-C program of
tests/test_c_usage.py is compiled with gcc against the port's library and
runs the engine -> asset -> scene -> renderables flow (skipped where gcc is
absent, as that file is).  A native build that fails (a fake g++ that
rejects every source) raises in the C API, the asset manager's dedup hash
and the IBL cache key alike: nothing falls back.
"""
import os
import shutil
import stat
import subprocess
import textwrap

import numpy as np
import pytest

from diligentfx_tpu.radient import c_api as jc
from diligentfx_tpu_torch.native import build as nbuild
from diligentfx_tpu_torch.radient import c_api as tc
from tests.test_c_usage import C_SRC
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX wrapper on its native library (without it the JAX package
    falls back to another implementation)."""
    assert jc.available()


def _tri():
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([[0, 1, 2]], np.int32)
    return pos, idx


def _mesh_lifecycle(c, log):
    e = c.NativeEngine()
    rel = lambda h: h - e.handle                       # noqa: E731
    pos, idx = _tri()
    m1 = e.create_mesh(pos, idx)
    log += [rel(m1.handle), m1.deduped, int(m1.load_status)]
    m2 = e.create_mesh(pos.copy(), idx.copy())
    log += [rel(m2.handle), m2.deduped, e.refcount(m1.handle)]
    rng = np.random.default_rng(2)
    m3 = e.create_mesh(rng.random((5, 3)), [[0, 1, 2], [2, 3, 4]],
                       normals=rng.random((5, 3)), uvs=rng.random((5, 2)))
    log += [rel(m3.handle), m3.deduped, e.update_gpu_resources(),
            int(m1.load_status), int(m3.load_status),
            e.update_gpu_resources()]
    log += [m1.info(), m3.info()]
    # m1 has no normals or UVs: mesh_read leaves those buffers unwritten
    p1, _, _, i1 = m1.read()
    log += [a.tobytes() for a in (p1, i1) + m3.read()]
    e.retain(m3.handle)
    log += [e.refcount(m3.handle)]
    m2.release()
    log += [e.refcount(m1.handle)]
    m1.release()
    log += [e.refcount(m1.handle)]
    with pytest.raises(c.RadientError) as ei:
        e.create_mesh(pos, np.zeros((0, 3), np.int32))
    log += [ei.value.status.name, str(ei.value)]
    with pytest.raises(c.RadientError) as ei:
        e.release_handle(10 ** 9)
    log += [ei.value.status.name]
    e.release()


def _scene_hierarchy(c, log):
    e = c.NativeEngine()
    s = e.create_scene()
    rng = np.random.default_rng(5)
    root = s.create_node()
    child = s.create_node(parent=root)
    grand = s.create_node(parent=child)
    for n in (root, child, grand):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rng.normal(size=(3, 3))
        m[3, :3] = rng.uniform(-3, 3, 3)
        s.set_transform(n, m)
    log += [s.world_matrices().tobytes(), s.node_count, s.revision]
    with pytest.raises(c.RadientError) as ei:
        s.create_node(parent=99)
    log += [ei.value.status.name]
    s.release()
    e.release()


def _change_log_and_renderables(c, log):
    e = c.NativeEngine()
    s = e.create_scene()
    rel = lambda h: h - e.handle                       # noqa: E731
    pos, idx = _tri()
    mesh = e.create_mesh(pos, idx)
    mat = e.create_material([1, 0, 0, 1])
    base = s.revision
    a, b = s.create_node(), s.create_node()
    s.set_mesh(a, mesh, mat)
    s.set_mesh(b, mesh, mat)
    s.set_visible(b, False)
    log += [s.changes_since(base)]
    nodes, meshes, mats = s.renderables()
    log += [nodes.tolist(), [rel(h) for h in meshes], [rel(h) for h in mats]]
    cn = s.create_node(parent=b)
    s.set_mesh(cn, mesh, mat)
    log += [s.renderables()[0].tolist()]
    s.set_visible(b, True)
    log += [s.renderables()[0].tolist()]
    s.destroy_node(a)
    log += [s.renderables()[0].tolist(), s.changes_since(base),
            s.changes_since(s.revision)]
    for _ in range(5000):
        s.set_visible(cn, True)
    log += [s.changes_since(0), len(s.changes_since(s.revision - 10)),
            s.revision]
    s.release()
    e.release()


@pytest.mark.parametrize("run", [_mesh_lifecycle, _scene_hierarchy,
                                 _change_log_and_renderables],
                         ids=lambda f: f.__name__.strip("_"))
def test_c_api_matches_jax(run):
    logs = []
    for c in (jc, tc):
        log = []
        run(c, log)
        logs.append(log)
    assert logs[0] == logs[1]


def test_c_api_reports_and_builds_one_library():
    assert tc.available()
    lib = tc._load()
    assert lib is nbuild.load()
    assert lib.dfx_content_hash and lib.dfx_rt_engine_create
    # the library is named by both sources' hash
    assert nbuild.RADIENT_SRC.name == "radient_c.cpp"
    assert nbuild.RADIENT_SRC.parent == nbuild.SRC.parent


@pytest.mark.skipif(shutil.which("gcc") is None, reason="no C toolchain")
def test_c_program_drives_the_ports_library(tmp_path):
    lib = nbuild.build()
    src = tmp_path / "use_api.c"
    src.write_text(textwrap.dedent(C_SRC))
    exe = tmp_path / "use_api"
    subprocess.run(["gcc", "-std=c99", str(src), str(lib),
                    f"-Wl,-rpath,{os.path.dirname(lib)}", "-o", str(exe)],
                   check=True)
    r = subprocess.run([str(exe)], capture_output=True, text=True)
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr)
    assert "c-api-ok" in r.stdout


@pytest.fixture
def failing_gxx(tmp_path, monkeypatch):
    """A g++ on the PATH that reports its version and rejects every
    source; the native library's build directory empty."""
    bin_ = tmp_path / "bin"
    bin_.mkdir()
    gxx = bin_ / "g++"
    gxx.write_text("#!/bin/sh\n"
                   "if [ \"$1\" = -dumpfullversion ]; then echo 0.0; exit 0; fi\n"
                   "echo 'fake g++: error: this compiler builds nothing'\n"
                   "exit 1\n")
    gxx.chmod(gxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(nbuild, "_loaded", {})
    return tmp_path / "native"


def test_failed_build_raises_everywhere(failing_gxx):
    from diligentfx_tpu_torch.config import PBRRendererCreateInfo
    from diligentfx_tpu_torch.radient.engine import create_radient_engine
    from diligentfx_tpu_torch.utils.cache import ibl_cache_key
    with pytest.raises(RuntimeError, match="fake g\\+\\+: error"):
        tc.NativeEngine()
    assert not tc.available()
    eng = create_radient_engine(device="cpu")
    pos, idx = _tri()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        eng.asset_manager.create_mesh(pos, idx)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        eng.asset_manager.load_texture(np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ibl_cache_key(np.zeros((4, 4, 3), np.float32),
                      PBRRendererCreateInfo())
    assert eng.asset_manager.stats.meshes == 0
    eng.shutdown()
    assert not list(failing_gxx.glob("*.so"))
