"""The port's native host runtime (diligentfx_tpu_torch/native) against the
JAX package's binding (diligentfx_tpu/native/binding.py, on its own g++
build) and against the port's plain Python versions: the content hash byte
for byte (tail bytes included), the pool suballocator's offsets and stats
step by step, the fan triangulation exactly.  All comparisons are exact.
A build that fails raises; nothing falls back."""
import numpy as np
import pytest

from diligentfx_tpu.native import binding as jnb
from diligentfx_tpu_torch.native import binding as nb
from diligentfx_tpu_torch.native import build as nbuild


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX binding on its native library (its Python fallback hashes
    with blake2b, another function)."""
    assert jnb.available()


def test_native_builds_into_build_dir():
    lib = nb._lib()
    path = nbuild.library_path()
    assert path.exists() and path.parent == nbuild.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert lib is nbuild.load()
    # the library is named by its source's hash: another source, another name
    assert nbuild.SRC.name == "dfx_native.cpp"
    assert path.name.startswith("libdfx_native_") and len(path.stem) == 26


def _arrays():
    rng = np.random.default_rng(3)
    cases = [np.arange(n, dtype=np.uint8) for n in range(0, 40)]
    cases += [rng.random((7, 3)).astype(np.float32),
              rng.random(1000).astype(np.float64),
              rng.integers(0, 1 << 30, (33, 3)).astype(np.int32),
              np.zeros((0, 3), np.float32)]
    return cases


@pytest.mark.parametrize("i", range(len(_arrays())))
def test_content_hash_matches_jax_and_plain(i):
    a = _arrays()[i]
    h = nb.content_hash(a)
    assert len(h) == 16
    assert h == jnb.content_hash(a) == nb.content_hash_plain(a)


def test_content_hash_chains_arrays_like_jax():
    rng = np.random.default_rng(5)
    arrays = (rng.random((12, 3)).astype(np.float32),
              np.arange(17, dtype=np.int16))
    assert (nb.content_hash(*arrays) == jnb.content_hash(*arrays)
            == nb.content_hash_plain(*arrays))
    assert nb.content_hash() == jnb.content_hash() == bytes(16)


def test_content_hash_stability_and_sensitivity():
    a = np.arange(1000, dtype=np.float32)
    h1 = nb.content_hash(a)
    assert h1 == nb.content_hash(a.copy())
    b = a.copy()
    b[500] += 1e-3
    assert nb.content_hash(b) != h1
    assert nb.content_hash(a.reshape(10, 100)) != h1
    assert nb.content_hash(a.astype(np.float64)) != h1


@pytest.mark.parametrize("n", range(1, 16))
def test_content_hash_tail_bytes_enter_hash(n):
    a = np.arange(n, dtype=np.uint8)
    b = a.copy()
    b[n - 1] ^= 0xFF                     # flip the LAST byte
    for fn in (nb.content_hash, nb.content_hash_plain):
        assert fn(a) != fn(b)
    assert nb.content_hash(b) == jnb.content_hash(b)


POOLS = {"native": nb.GeometryPool, "plain": nb.GeometryPoolPlain}


@pytest.mark.parametrize("kind", sorted(POOLS))
def test_pool_alloc_free_coalesce_matches_jax(kind):
    """tests/test_native.py's sequence, offset by offset and stat by stat
    against the JAX binding's pool."""
    p, j = POOLS[kind](1024), jnb.GeometryPool(1024)

    def both(op, *args, **kw):
        got, want = getattr(p, op)(*args, **kw), getattr(j, op)(*args, **kw)
        assert got == want, (op, args, got, want)
        assert p.stats() == j.stats()
        return got
    a = both("alloc", 100, alignment=16)
    b = both("alloc", 200, alignment=16)
    c = both("alloc", 300, alignment=16)
    assert a == 0 and b % 16 == 0 and c % 16 == 0
    both("free", b)
    assert p.stats()[1:3] == (400, 600)
    d = both("alloc", 200, alignment=16)
    assert d == b
    for off in (a, c, d):
        both("free", off)
    assert p.stats()[1] == 0 and p.stats()[3] == 1
    assert both("alloc", 2048) == -1
    with pytest.raises(KeyError):
        POOLS[kind](64).free(32)


@pytest.mark.parametrize("kind", sorted(POOLS))
def test_pool_random_sequence_matches_jax(kind):
    """400 random allocations (sizes 1..300, alignments 1..64) and frees
    on a 16,384-element pool: the same offsets and stats as the JAX
    binding at every step."""
    rng = np.random.default_rng(9)
    p, j = POOLS[kind](1 << 14), jnb.GeometryPool(1 << 14)
    live = []
    for _ in range(400):
        if live and rng.random() < 0.4:
            off = live.pop(int(rng.integers(len(live))))
            p.free(off)
            j.free(off)
        else:
            size = int(rng.integers(1, 300))
            align = int(rng.choice([1, 4, 16, 64]))
            got, want = p.alloc(size, align), j.alloc(size, align)
            assert got == want
            if got >= 0:
                live.append(got)
        assert p.stats() == j.stats()


def _polygons(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 9, 200).astype(np.int32)   # 1, 2: no triangle
    indices = rng.integers(0, 500, int(counts.sum())).astype(np.int32)
    return counts, indices


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_faces_matches_plain_and_jax(seed):
    counts, indices = _polygons(seed)
    tris = nb.triangulate_faces(counts, indices)
    assert tris.dtype == np.int32
    assert tris.shape == (int(np.maximum(counts - 2, 0).sum()), 3)
    np.testing.assert_array_equal(tris,
                                  nb.triangulate_faces_plain(counts, indices))
    np.testing.assert_array_equal(tris, jnb.triangulate_faces(counts,
                                                              indices))


def test_triangulate_faces_quad_pentagon_triangle():
    counts = np.array([4, 5, 3], np.int32)
    indices = np.arange(12, dtype=np.int32)
    for fn in (nb.triangulate_faces, nb.triangulate_faces_plain):
        tris = fn(counts, indices)
        np.testing.assert_array_equal(
            tris, [[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7], [4, 7, 8],
                   [9, 10, 11]])
    assert nb.triangulate_faces(np.zeros(0, np.int32),
                                np.zeros(0, np.int32)).shape == (0, 3)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile: load raises with g++'s message, and
    the binding's entry points raise with it (no Python fallback)."""
    bad = tmp_path / "dfx_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nbuild, "SRC", bad)
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(nbuild, "_loaded", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        nbuild.load()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        nb.content_hash(np.arange(3))
    with pytest.raises(RuntimeError):
        nb.GeometryPool(16)
    assert not list((tmp_path / "native").glob("*.so"))
