"""The port's native host runtime under AddressSanitizer (the port of
tests/test_native_asan.py): native/build.py builds dfx_native.cpp and
radient_c.cpp with -fsanitize=address into a library of its own, and a
child process with libasan preloaded (it must come before libc, so the
pytest process cannot take it) selects it with `use_library` and runs the
JAX test's surface through the port's binding, content hashes of every
tail length 0-31, pool churn and the fan triangulation, each held against
its plain Python version exactly, then a Radient C API round trip through
radient/c_api.py.  Any ASan report aborts the child and fails the test;
so does a result that differs from the plain versions."""
import os
import subprocess
import sys

import pytest

from diligentfx_tpu_torch.native import build as nbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, %(repo)r)
from diligentfx_tpu_torch.native import build
build.use_library(%(lib)r)
from diligentfx_tpu_torch.native import binding as nb
from diligentfx_tpu_torch.radient import c_api as c

# content hash: every tail length 0..31 (the JAX test's overflow class)
for n in range(0, 32):
    a = np.arange(max(n, 1), dtype=np.uint8)[:n]
    assert nb.content_hash(a) == nb.content_hash_plain(a), n
# pool alloc / free / coalesce churn, step by step against the plain pool
p, q = nb.GeometryPool(1 << 16), nb.GeometryPoolPlain(1 << 16)
offs = [p.alloc(100) for _ in range(50)]
assert offs == [q.alloc(100) for _ in range(50)]
for o in offs[::2]:
    p.free(o)
    q.free(o)
assert [p.alloc(64) for _ in range(25)] == [q.alloc(64) for _ in range(25)]
assert p.stats() == q.stats()
# triangulation of mixed polygons
counts = np.array([3, 4, 5, 6], np.int32)
idx = np.arange(counts.sum(), dtype=np.int32)
np.testing.assert_array_equal(nb.triangulate_faces(counts, idx),
                              nb.triangulate_faces_plain(counts, idx))

# a Radient C API round trip: meshes (one deduplicated), a material, a
# scene hierarchy, its change log, world matrices and renderables
e = c.NativeEngine()
pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
tri = np.array([[0, 1, 2]], np.int32)
m1 = e.create_mesh(pos, tri)
m2 = e.create_mesh(pos.copy(), tri.copy())
assert m2.deduped and not m1.deduped
rng = np.random.default_rng(2)
m3 = e.create_mesh(rng.random((5, 3)), [[0, 1, 2], [2, 3, 4]],
                   normals=rng.random((5, 3)), uvs=rng.random((5, 2)))
e.update_gpu_resources()
m3.read()
mat = e.create_material([1, 0, 0, 1])
s = e.create_scene()
root = s.create_node()
child = s.create_node(parent=root)
local = np.eye(4, dtype=np.float32)
local[3, :3] = [1, 2, 3]
s.set_transform(root, local)
s.set_transform(child, local)
s.set_mesh(child, m3, mat)
s.set_mesh(root, m1, mat)
s.set_visible(root, False)
assert len(s.changes_since(0)) > 0
world = s.world_matrices()
np.testing.assert_array_equal(world[child][3, :3], [2, 4, 6])
nodes, meshes, mats = s.renderables()
assert nodes.tolist() == [], nodes
s.set_visible(root, True)
assert sorted(s.renderables()[0].tolist()) == [root, child]
s.destroy_node(child)
for _ in range(2000):
    s.set_visible(root, True)
m2.release()
m1.release()
s.release()
e.release()
print("ASAN-CLEAN")
"""


def _asan_runtime():
    """libasan.so as g++ names it, or None where it has none."""
    try:
        out = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True,
                             check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None
    return out if os.path.sep in out and os.path.exists(out) else None


def test_asan_build_has_its_own_name():
    plain, asan = nbuild.library_path(), nbuild.library_path(asan=True)
    assert plain != asan and asan.parent == nbuild.BUILD_DIR
    assert asan.name.startswith("libdfx_native_asan_")
    assert plain.name.startswith("libdfx_native_")
    assert not plain.name.startswith("libdfx_native_asan")


def test_use_library_refuses_a_second_library(tmp_path, monkeypatch):
    # the choice is process state: put it back for the tests after this
    monkeypatch.setattr(nbuild, "_chosen", nbuild._chosen)
    lib = nbuild.load()                      # the default build, loaded
    other = tmp_path / "libother.so"
    other.write_bytes(b"")
    with pytest.raises(RuntimeError, match="loaded already"):
        nbuild.use_library(other)
    with pytest.raises(RuntimeError, match="no library"):
        nbuild.use_library(tmp_path / "missing.so")
    nbuild.use_library(lib._name)            # the loaded one: a no-op
    assert nbuild.load() is lib


def test_native_surface_under_asan():
    runtime = _asan_runtime()
    if runtime is None:
        pytest.skip("g++ names no libasan.so (g++ 12 ships one)")
    lib = nbuild.build(asan=True)
    assert lib == nbuild.library_path(asan=True) and lib.exists()
    env = dict(os.environ, LD_PRELOAD=runtime,
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1")
    r = subprocess.run(
        [sys.executable, "-c", CHILD % {"repo": REPO, "lib": str(lib)}],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"ASan failure:\n{r.stdout}\n{r.stderr}"
    assert "ASAN-CLEAN" in r.stdout
    assert "AddressSanitizer" not in r.stderr, r.stderr
