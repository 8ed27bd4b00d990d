"""The port's geometry pool and texture registry (diligentfx_tpu_torch/
hydrogent/{geometry_pool,texture_registry}.py) against the JAX package's,
on the CPU: the cases of tests/test_geometry_pool.py and the registry case
of tests/test_render_delegate.py run on both packages with the same numpy
meshes and images.  Content keys, offsets, ranges, residency, upload bytes,
stats and the capacity-padded device streams equal JAX's exactly; so do the
registry's ids, pending counts, versions and atlas arrays."""
import numpy as np
import pytest
import torch

from diligentfx_tpu.hydrogent.geometry_pool import HnGeometryPool as JPool
from diligentfx_tpu.hydrogent.texture_registry import \
    HnTextureRegistry as JRegistry
from diligentfx_tpu_torch.hydrogent.geometry_pool import HnGeometryPool
from diligentfx_tpu_torch.hydrogent.texture_registry import \
    HnTextureRegistry
from tests.test_geometry_pool import tri_mesh
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def pools(**kw):
    return HnGeometryPool(device="cpu", **kw), JPool(**kw)


def assert_same_pool(p, j):
    """Entries, ranges, residency, pending order, stats and the
    allocators' stats; after a commit, the device streams."""
    assert sorted(p._entries) == sorted(j._entries)
    for k in p._entries:
        assert p.range_of(k) == j.range_of(k)
        assert p.is_resident(k) == j.is_resident(k)
        assert p._entries[k].refcount == j._entries[k].refcount
    assert p._dirty == j._dirty
    assert p.stats() == j.stats()
    assert p._valloc.stats() == j._valloc.stats()
    assert p._talloc.stats() == j._talloc.stats()
    assert p.last_commit_upload_bytes == j.last_commit_upload_bytes
    assert p.total_upload_bytes == j.total_upload_bytes
    assert p.storage_version == j.storage_version


def assert_same_streams(pdev, jdev):
    assert sorted(pdev) == sorted(jdev)
    for name in pdev:
        assert pdev[name].device.type == "cpu"
        np.testing.assert_array_equal(pdev[name].numpy(),
                                      np.asarray(jdev[name]))


def test_identical_content_shares_one_entry():
    p, j = pools()
    pts, idx = tri_mesh(0)
    keys = [(pool.acquire(pts, None, None, idx),
             pool.acquire(pts.copy(), None, None, idx.copy()))
            for pool in (p, j)]
    assert keys[0] == keys[1] and keys[0][0] == keys[0][1]
    assert_same_pool(p, j)
    assert p.stats()["entries"] == 1 and p.stats()["instances"] == 2
    for pool in (p, j):
        pool.release(keys[0][0])
    assert_same_pool(p, j)
    assert p.stats()["entries"] == 1
    for pool in (p, j):
        pool.release(keys[0][0])
    assert p.stats()["entries"] == 0
    assert_same_pool(p, j)


def test_incremental_commit_uploads_only_dirty_mesh():
    p, j = pools()
    keys = []
    for s in range(8):
        pts, idx = tri_mesh(s)
        keys.append([pool.acquire(pts, None, None, idx) for pool in (p, j)])
    assert_same_streams(p.commit(), j.commit())
    assert_same_pool(p, j)
    assert p.last_commit_upload_bytes > 0 and p.num_pending == 0
    pts, idx = tri_mesh(99)
    for pool in (p, j):
        pool.release(keys[3][0])
        pool.acquire(pts, None, None, idx)
    assert_same_streams(p.commit(), j.commit())
    assert_same_pool(p, j)
    assert p.last_commit_upload_bytes == pts.shape[0] * 48 + idx.shape[0] * 12


def test_load_budget_defers_entries_pending():
    pts, idx = tri_mesh(1, nv=64, nt=32)
    p, j = pools(load_budget_bytes=pts.shape[0] * 48 + idx.shape[0] * 12)
    for s in range(3):
        pts_s, idx_s = tri_mesh(s, nv=64, nt=32)
        for pool in (p, j):
            pool.acquire(pts_s, None, None, idx_s)
    for step in range(3):
        assert_same_streams(p.commit(), j.commit())
        assert_same_pool(p, j)
        assert p.num_pending == 2 - step
    assert all(p.is_resident(k) for k in p._entries)


def test_growth_replays_and_content_survives():
    p, j = pools(vertex_capacity=16, index_capacity=8)
    pts1, idx1 = tri_mesh(1, nv=12, nt=6)
    for pool in (p, j):
        pool.acquire(pts1, None, None, idx1)
    assert_same_streams(p.commit(), j.commit())
    # this acquire overflows the 16-vertex capacity → grow + replay
    pts2, idx2 = tri_mesh(2, nv=20, nt=10)
    for pool in (p, j):
        pool.acquire(pts2, None, None, idx2)
    assert_same_pool(p, j)
    pdev = p.commit()
    assert_same_streams(pdev, j.commit())
    assert_same_pool(p, j)
    for k, (pts, idx) in zip(p._entries, ((pts1, idx1), (pts2, idx2))):
        v_off, v_len, t_off, t_len = p.range_of(k)
        np.testing.assert_array_equal(
            pdev["positions"][v_off:v_off + v_len].numpy(), pts)
        np.testing.assert_array_equal(
            pdev["indices"][t_off:t_off + t_len].numpy(), idx + v_off)


def test_repeated_growth_does_not_leak_nongrown_allocator():
    p, j = pools(vertex_capacity=8, index_capacity=1 << 14)
    for i in range(6):       # each acquire overflows → repeated vertex grows
        pts, idx = tri_mesh(i + 10, nv=16 << i, nt=4)
        for pool in (p, j):
            pool.acquire(pts, None, None, idx)
    assert_same_streams(p.commit(), j.commit())
    assert_same_pool(p, j)
    assert p._talloc.stats()[1] == 6 * 4
    spans = sorted(p.range_of(k)[2:] for k in p._entries)
    for (o1, l1), (o2, _) in zip(spans, spans[1:]):
        assert o1 + l1 <= o2


def test_given_normals_and_uvs_are_pooled_as_given():
    rng = np.random.default_rng(4)
    pts, idx = tri_mesh(5, nv=30, nt=20)
    nrm = rng.normal(size=(30, 3)).astype(np.float32)
    uv = rng.random((30, 2)).astype(np.float32)
    p, j = pools()
    for pool in (p, j):
        pool.acquire(pts, nrm, uv, idx)
        pool.acquire(pts, None, uv, idx)       # another entry: no normals
    assert_same_streams(p.commit(), j.commit())
    assert_same_pool(p, j)


def test_delegate_dedup_and_o1_edit():
    """Two identical meshes share pool storage; editing one mesh in an
    N-mesh scene uploads O(1 mesh), on both delegates."""
    from diligentfx_tpu.hydrogent.render_delegate import \
        HnRenderDelegate as JDelegate
    from diligentfx_tpu_torch.hydrogent.render_delegate import \
        HnRenderDelegate
    pts, idx = tri_mesh(0, nv=24, nt=12)
    ds = (HnRenderDelegate(device="cpu"), JDelegate())
    for d in ds:
        for i in range(4):
            m = d.create_rprim("mesh", f"/m{i}")
            m.set_triangles(idx)
            m.set_points(pts if i < 2 else tri_mesh(i, nv=24)[0])
        d.commit_resources()
    assert_same_pool(ds[0].geometry_pool, ds[1].geometry_pool)
    st = ds[0].geometry_pool.stats()
    assert st["instances"] == 4 and st["entries"] == 3
    assert ds[0]._scene.positions.shape[0] == 4 * 24
    for d in ds:
        d.meshes["/m3"].set_points(tri_mesh(7, nv=24)[0])
        d.commit_resources()
    assert_same_pool(ds[0].geometry_pool, ds[1].geometry_pool)
    assert ds[0].geometry_pool.last_commit_upload_bytes == 24 * 48 + 12 * 12
    np.testing.assert_array_equal(ds[0]._scene.positions.numpy(),
                                  np.asarray(ds[1]._scene.positions))
    assert (vars(ds[0].get_memory_stats())
            == vars(ds[1].get_memory_stats()))


def _same_atlas(a, b):
    assert len(a.mips) == len(b.mips)
    for x, y in zip(a.mips, b.mips):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(a.scale_bias.numpy(),
                                  np.asarray(b.scale_bias))
    np.testing.assert_array_equal(a.layer.numpy(), np.asarray(b.layer))


def test_texture_registry_async_dedup_and_budget():
    """Async loads, content-hash dedup and the budgeted commit with its
    placeholder-then-resident refinement (HnTextureRegistry.hpp:141-176),
    step by step on both registries."""
    img = (np.random.default_rng(1).random((16, 16, 3)) * 255).astype(
        np.uint8)
    regs = (HnTextureRegistry(atlas_dim=64, upload_budget_bytes=1 << 30,
                              device="cpu"),
            JRegistry(atlas_dim=64, upload_budget_bytes=1 << 30))
    ids = []
    for reg in regs:
        a = reg.allocate(img)
        b = reg.allocate(img.copy())            # identical content → same id
        c = reg.allocate(lambda: np.ones((8, 8, 3), np.float32) * 0.5)
        reg.wait_idle()
        ids.append((a, b, c))
    assert ids[0] == ids[1] and ids[0][0] == ids[0][1] != ids[0][2]
    _same_atlas(regs[0].commit(), regs[1].commit())
    v1 = regs[0].storage_version
    for reg in regs:
        assert reg.num_textures == 2 and reg.num_pending == 0
        reg.commit()                            # no change: no rebuild
    assert regs[0].storage_version == regs[1].storage_version == v1
    assert regs[0].resident_bytes == regs[1].resident_bytes
    assert regs[0].data_version == regs[1].data_version

    big = np.random.default_rng(2).random((32, 32, 3)).astype(np.float32)
    small = (HnTextureRegistry(atlas_dim=64, upload_budget_bytes=100,
                               device="cpu"),
             JRegistry(atlas_dim=64, upload_budget_bytes=100))
    for reg in small:
        reg.allocate(big)
        reg.wait_idle()
    _same_atlas(small[0].commit(), small[1].commit())
    assert small[0].num_pending == small[1].num_pending == 1
    _same_atlas(small[0].commit(upload_budget_bytes=1 << 20),
                small[1].commit(upload_budget_bytes=1 << 20))
    assert small[0].num_pending == small[1].num_pending == 0
    assert small[0].storage_version == small[1].storage_version
    for reg in regs + small:
        reg.stop()


def test_texture_registry_keys_are_the_jax_hashes():
    """allocate() dedups by the native content hash, the JAX registry's
    key byte for byte."""
    img = np.random.default_rng(3).random((8, 8, 4)).astype(np.float32)
    reg, jreg = (HnTextureRegistry(device="cpu"), JRegistry())
    reg.allocate(img)
    jreg.allocate(img)
    assert list(reg._by_hash) == list(jreg._by_hash)
    assert reg.allocate(img.copy(), key=list(reg._by_hash)[0]) == 0
    reg.stop()
    jreg.stop()


def test_pool_and_registry_need_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HnGeometryPool()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HnTextureRegistry()
