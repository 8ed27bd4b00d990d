import numpy as np
import pytest

from fxbench.scenes import atrium


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 12345, 2**40 + 7])
def test_atrium_triangles(seed):
    entries = atrium.build(seed)
    assert sum(m.indices.shape[0] for m, _, _ in entries) == 165152


def test_seed_changes_only_the_clutter():
    a, b = atrium.build(1), atrium.build(2)
    fixed = 24 * 2 + 1
    for (ma, na, ca), (mb, nb, cb) in zip(a[:fixed], b[:fixed]):
        assert np.array_equal(na, nb) and ca == cb
    assert any(not np.array_equal(na, nb)
               for (_, na, _), (_, nb, _) in zip(a[fixed:], b[fixed:]))


def test_seed_0_is_the_suites_scene():
    from diligentfx_tpu_torch.examples.benchmark_suite import \
        sponza_like_entries
    ours, suite = atrium.build(0), sponza_like_entries()
    assert len(ours) == len(suite)
    for (m, node, mat), (ms, nodes, mats) in zip(ours, suite):
        for f in ("positions", "normals", "uvs", "indices", "tangents"):
            assert np.array_equal(getattr(m, f), getattr(ms, f)), f
        assert np.array_equal(node, nodes)
        bc = np.asarray(mats.base_color_factor.cpu(), np.float32)
        assert np.array_equal(np.asarray(mat["base_color_factor"],
                                         np.float32), bc)
        for k in ("metallic_factor", "roughness_factor"):
            want = float(getattr(mats, k).cpu())
            assert np.float32(mat.get(k, 1.0)) == np.float32(want), k
