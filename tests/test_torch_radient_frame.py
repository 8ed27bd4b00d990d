"""The Radient slice as a whole on the CPU: the port's engine
(diligentfx_tpu_torch/radient/, device="cpu") against the JAX package's.

Both engines are given one seeded scene through the API: a .glb in a
MemoryAssetResolver imported from mem:// (a floor, three boxes of one
mesh, two spheres of equal payloads, a spot and a point light, written by
chip_smoke.py's radient_glb), a numpy texture through load_texture, and a
carousel of six spheres (one asset) parented to one entity.  Both render
at 128 x 64 with small PBRRendererCreateInfo IBL sizes and the smallest
task-manager config (SSAO, SSR, TAA and bloom off); the JAX renderer takes
the port's IBL maps.  Four frames: the first, a transform-only edit (the
carousel turns), no edit, and a visibility toggle (the carousel hidden).

Tolerances: the committed ScenePrimitives of every frame, every field,
exact; the drawable caches' rebuild and sync counts and the statuses
exact; the colour of every frame above 50 dB.  The frame after the edit
shows the reference's stale motion (ROADMAP.md §3): a sync with no change
keeps the edit's previous matrices, in both packages alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diligentfx_tpu import attribs as jattribs
from diligentfx_tpu.config import PBRRendererCreateInfo, RasterizerConfig
from diligentfx_tpu.hydrogent import task_manager as jtm
from diligentfx_tpu.pbr import shading as jsh
from diligentfx_tpu.pbr.renderer import PBRRenderer
from diligentfx_tpu.radient import engine as jeng
from diligentfx_tpu.radient import resolver as jres
from diligentfx_tpu_torch import attribs as tattribs
from diligentfx_tpu_torch import convert as cv
from diligentfx_tpu_torch.config import PBRRendererCreateInfo as PortCI
from diligentfx_tpu_torch.gltf.primitives import cube, plane, uv_sphere
from diligentfx_tpu_torch.radient import engine as teng
from diligentfx_tpu_torch.radient import resolver as tres
from diligentfx_tpu_torch.utils.image import psnr
from tests.torch_hydra_ref import assert_same_scene
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 128, 64
TM_CI = jtm.TaskManagerCreateInfo(enable_ssao=False, enable_ssr=False,
                                  enable_taa=False, enable_bloom=False)
IBL = dict(brdf_lut_dim=16, num_brdf_samples=8, irradiance_cube_dim=16,
           prefiltered_env_map_dim=16, num_specular_env_samples=8)
CFG = RasterizerConfig(tile_h=8, tile_w=128, bin_capacity=512,
                       max_tiles_per_tri=16, big_tri_capacity=16, chunk=8)
CAROUSEL = 6
EYE, TARGET = (0.5, 2.5, 7.0), (0.0, 0.8, 0.0)


def scene_glb():
    """The imported part: a floor, three boxes (one MeshData), two spheres
    (distinct MeshData, equal payloads), a spot and a point light."""
    rng = np.random.default_rng(11)

    def mat():
        return tattribs.PBRMaterialBasicAttribs.create(
            base_color_factor=tuple(rng.uniform(0.2, 0.9, 3)) + (1.0,),
            metallic_factor=float(rng.uniform(0, 1)),
            roughness_factor=float(rng.uniform(0.2, 0.9)))

    def at(x, y, z, s=1.0):
        m = np.diag([s, s, s, 1.0]).astype(np.float32)
        m[3, :3] = (x, y, z)
        return m
    box = cube(0.8)
    entries = [(plane(12.0, segments=4), at(0, 0, 0), mat())]
    entries += [(box, at(x, 0.4, -1.0), mat()) for x in (-2.0, 0.0, 2.0)]
    entries += [(uv_sphere(0.45, 8, 12), at(x, 0.45, 1.2), mat())
                for x in (-1.2, 1.2)]
    return chip_smoke.radient_glb(entries, chip_smoke.spot_point_lights())


def carousel_matrix(i):
    m = chip_smoke.carousel_matrix(i * 4)
    m[3, 1] = 1.9
    return m


def build(res_mod, attribs, eng, glb):
    """The scene through `eng`'s API (either package's modules)."""
    am = eng.asset_manager
    am.resolver.push_front(res_mod.MemoryAssetResolver({"scene.glb": glb}))
    scene, state = eng.create_scene()
    status = eng.create_scene_importer(state).import_gltf("mem://scene.glb")
    tex = am.load_texture(np.random.default_rng(2).random(
        (16, 16, 4)).astype(np.float32))
    w = eng.create_scene_writer(state)
    parent = w.create_entity()
    w.set_transform(parent, carousel_matrix(0))
    s = uv_sphere(0.3, 8, 12)
    for k in range(CAROUSEL):
        a = 2 * np.pi * k / CAROUSEL
        mesh = am.create_mesh(s.positions, s.indices, s.normals, s.uvs,
                              s.tangents)
        mat = am.create_material(attribs.PBRMaterialBasicAttribs.create(
            base_color_factor=(0.5 + 0.4 * np.cos(a), 0.5, 0.5 - 0.4 *
                               np.cos(a), 1.0), roughness_factor=0.3),
            texture_handles={"base_color": tex})
        e = w.create_entity()
        w.set_mesh(e, mesh, mat)
        local = np.eye(4, dtype=np.float32)
        local[3, :3] = (1.6 * np.cos(a), 0.0, 1.6 * np.sin(a))
        w.set_transform(e, local)
        w.set_parent(e, parent)
    chip_smoke.radient_wait(am)
    return state, w, parent, status


def frames(eng, renderer, state, w, parent):
    """Four frames: first, transform-only edit, no edit, visibility
    toggle; each (statuses, counters, scene primitives, colour)."""
    cache = renderer._cache_for(state)
    view = eng.create_view(W, H)
    view.set_camera(EYE, TARGET, fov_y=0.9, near_z=0.1, far_z=50.0)
    out = []
    for i, edit in enumerate(("first", "turn", "none", "hide")):
        if edit == "turn":
            w.set_transform(parent, carousel_matrix(1))
        elif edit == "hide":
            w.set_visible(parent, False)
        st = (renderer.update(state), renderer.render(state, view))
        out.append(dict(status=[int(x) for x in st],
                        counters=(cache.full_rebuilds,
                                  cache.incremental_syncs),
                        scene=cache.scene_primitives,
                        color=np.array(view.last_frame)))
    return out


@pytest.fixture(scope="module")
def run():
    glb = scene_glb()
    port = teng.create_radient_engine(device="cpu")
    jax_ = jeng.create_radient_engine()
    pst = build(tres, tattribs, port, glb)
    jst = build(jres, jattribs, jax_, glb)
    pr = port.create_renderer(
        task_manager_ci=cv.task_manager_ci_from_jax(TM_CI),
        renderer_ci=PortCI(**IBL), raster_cfg=cv.raster_config_from_jax(
            CFG))
    jr = jax_.create_renderer(task_manager_ci=TM_CI,
                              renderer_ci=PBRRendererCreateInfo(**IBL),
                              raster_cfg=CFG)
    jr._tm = jtm.HnTaskManager(jax_renderer(pr.task_manager().renderer),
                               TM_CI)
    res = dict(port=frames(port, pr, *pst[:3]),
               jax=frames(jax_, jr, *jst[:3]),
               status=(pst[3], jst[3]),
               stats=(vars(port.asset_manager.stats),
                      vars(jax_.asset_manager.stats)),
               atlas=(port.asset_manager.get_atlas(),
                      jax_.asset_manager.get_atlas()),
               renderer=pr)
    port.shutdown()
    jax_.shutdown()
    return res


def jax_renderer(port):
    """A JAX PBRRenderer on the port renderer's env map and IBL maps."""
    ren = PBRRenderer(PBRRendererCreateInfo(**IBL, enable_ibl=False),
                      raster_cfg=CFG, env_oct=jnp.asarray(port.env_oct))
    ren.ci = PBRRendererCreateInfo(**IBL)
    m = port.ibl_maps
    ren.ibl_maps = jsh.IBLMaps(
        irradiance=jnp.asarray(m.irradiance),
        prefiltered=tuple(jnp.asarray(x) for x in m.prefiltered),
        preintegrated_ggx=jnp.asarray(m.preintegrated_ggx),
        preintegrated_charlie=jnp.asarray(m.preintegrated_charlie),
        sheen_albedo_scaling=jnp.asarray(m.sheen_albedo_scaling),
        irradiance_sh=jnp.asarray(m.irradiance_sh),
        env_brdf_coeffs=jnp.asarray(m.env_brdf_coeffs),
        pref_packed=jnp.asarray(m.pref_packed))
    return ren


def test_scene_and_assets_match_jax(run):
    assert [int(s) for s in run["status"]] == [0, 0]
    p, j = run["stats"]
    assert p == j
    # boxes 2, spheres 1, the carousel CAROUSEL - 1
    assert p["dedup_hits"] == 3 + CAROUSEL - 1
    pa, ja = run["atlas"]
    for x, y in zip(pa.mips, ja.mips):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # the atlas holds the texture; nothing binds it to the frame
    assert run["renderer"].task_manager().atlas is None


@pytest.mark.parametrize("i", range(4), ids=["first", "turn", "none",
                                             "hide"])
def test_frame_matches_jax(run, i):
    p, j = run["port"][i], run["jax"][i]
    assert p["status"] == j["status"] == [0, 0]
    assert p["counters"] == j["counters"]
    assert_same_scene(p["scene"], j["scene"])
    c = p["color"]
    assert c.shape == (H, W, 3) and np.isfinite(c).all()
    assert psnr(j["color"], c) > 50.0, psnr(j["color"], c)


def test_rebuilds_syncs_and_stale_motion(run):
    f = run["port"]
    # first: a full rebuild; turn: one incremental sync; none: nothing;
    # hide: a full rebuild
    assert [x["counters"] for x in f] == [(1, 0), (1, 1), (1, 1), (2, 1)]
    turned, still = f[1]["scene"], f[2]["scene"]
    moved = (turned.node_matrices != turned.prev_node_matrices).any(-1).any(
        -1)
    assert int(moved.sum()) == CAROUSEL
    # the reference's hazard: the frame with no edit keeps the turn's
    # previous matrices (the carousel still carries that motion)
    assert still is turned
    assert torch.equal(still.prev_node_matrices,
                       f[0]["scene"].node_matrices)
    # hidden: the carousel's triangles are gone
    hidden = f[3]["scene"]
    assert (f[2]["scene"].num_triangles - hidden.num_triangles
            == CAROUSEL * uv_sphere(0.3, 8, 12).indices.shape[0])
    assert not np.array_equal(f[3]["color"], f[2]["color"])
