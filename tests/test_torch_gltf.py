"""The port's glTF loader and scene builder against the JAX package's, on
the CPU (diligentfx_tpu_torch/gltf/{loader,model}.py).

The documents are written at run time by `write_gltf` (also used by the
other K-layer test files): a ground quad, a lattice screen of
ALPHA_MODE_MASK (a base-colour texture whose alpha is 0 or 1, through
KHR_texture_transform and a mirror / clamp sampler), three ALPHA_MODE_BLEND
panes of two materials, a textured opaque quad, KHR_lights_punctual
lights (directional, point, spot) and a translation animation, as a .gltf
with an external buffer and PNG files and as a .glb with everything
embedded.

Tolerance: none.  The loader is numpy code on both sides and the scene
builder copies its arrays, so every field, array, material attribute,
atlas texel and light is compared for equality.
"""
import dataclasses
import json
import os
import struct

import numpy as np
import pytest
import torch

from diligentfx_tpu.gltf import loader as jloader
from diligentfx_tpu.gltf import model as jmodel
from diligentfx_tpu_torch.gltf import loader as tloader
from diligentfx_tpu_torch.gltf import model as tmodel
from diligentfx_tpu_torch.utils.image import write_png
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# a small glTF writer
# ---------------------------------------------------------------------------


def grid_quad(nx, ny, sx, sy):
    """An nx x ny grid of quads over [-sx/2, sx/2] x [-sy/2, sy/2] in the
    XY plane, facing +Z: (positions, normals, uvs, indices (T, 3))."""
    xs = np.linspace(-sx / 2, sx / 2, nx + 1, dtype=np.float32)
    ys = np.linspace(-sy / 2, sy / 2, ny + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    pos = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    nrm = np.tile(np.array([0, 0, 1], np.float32), (pos.shape[0], 1))
    u, v = np.meshgrid(np.linspace(0, 1, nx + 1), np.linspace(1, 0, ny + 1))
    uv = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)
    i = np.arange(ny)[:, None] * (nx + 1) + np.arange(nx)[None, :]
    i = i.reshape(-1)
    a, b, c, d = i, i + 1, i + nx + 2, i + nx + 1
    idx = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)])
    return pos, nrm, uv, idx.astype(np.uint32)


def lattice_rgba(size=64, holes=4, rgb=(0.3, 0.6, 0.2)):
    """A square lattice of holes: alpha 0 inside them, 1 on the bars."""
    y, x = np.mgrid[0:size, 0:size]
    cell = size // holes
    bar = max(cell // 4, 1)
    solid = ((x % cell) < bar) | ((y % cell) < bar)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = (np.asarray(rgb) * 255).astype(np.uint8)
    img[..., 3] = np.where(solid, 255, 0)
    return img


def write_gltf(path, prims, materials, images=(), nodes=None, lights=(),
               animations=None, samplers=None, textures=None):
    """Write `prims` (dicts of positions, normals, uvs, indices (T, 3),
    material), one mesh and node each (or `nodes`), with `materials` (glTF
    material dicts), `images` (uint8 RGBA arrays, PNG), `lights`
    (KHR_lights_punctual dicts, each on a node of its own) and optional
    animations (dicts of node, path, times, values) to a .gltf (external
    buffer and PNG files beside it) or a .glb (everything embedded),
    chosen by the path's extension.  Returns the path."""
    glb = path.endswith(".glb")
    base = os.path.dirname(path)
    blob = bytearray()
    views, accessors = [], []

    def add_view(data: bytes):
        while len(blob) % 4:
            blob.append(0)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(data)})
        blob.extend(data)
        return len(views) - 1

    def add_accessor(arr, ctype, atype):
        v = add_view(np.ascontiguousarray(arr).tobytes())
        accessors.append({"bufferView": v, "componentType": ctype,
                          "count": int(arr.shape[0]), "type": atype})
        return len(accessors) - 1

    meshes = []
    for p in prims:
        attrs = {"POSITION": add_accessor(p["positions"], 5126, "VEC3"),
                 "NORMAL": add_accessor(p["normals"], 5126, "VEC3"),
                 "TEXCOORD_0": add_accessor(p["uvs"], 5126, "VEC2")}
        ind = add_accessor(np.asarray(p["indices"], np.uint32).reshape(-1),
                           5125, "SCALAR")
        meshes.append({"primitives": [{"attributes": attrs, "indices": ind,
                                       "material": p["material"]}]})
    if nodes is None:
        nodes = [{"mesh": i, "name": f"prim{i}"} for i in range(len(prims))]
    nodes = [dict(n) for n in nodes]
    for li in range(len(lights)):
        nodes.append({"name": f"light{li}", "rotation": [-0.3, 0.2, 0.0,
                                                         0.93],
                      "translation": [0.0, 3.0, 2.0],
                      "extensions": {"KHR_lights_punctual": {"light": li}}})
    doc = {"asset": {"version": "2.0"}, "scene": 0,
           "scenes": [{"nodes": list(range(len(nodes)))}],
           "nodes": nodes, "meshes": meshes, "materials": list(materials)}
    if lights:
        doc["extensions"] = {"KHR_lights_punctual": {"lights": list(lights)}}
    img_docs = []
    for i, img in enumerate(images):
        name = f"{os.path.splitext(os.path.basename(path))[0]}_tex{i}.png"
        png = os.path.join(base, name)
        write_png(png, img)
        if glb:
            with open(png, "rb") as f:
                data = f.read()
            os.unlink(png)
            img_docs.append({"bufferView": add_view(data),
                             "mimeType": "image/png"})
        else:
            img_docs.append({"uri": name})
    if img_docs:
        doc["images"] = img_docs
        doc["samplers"] = samplers or [{"wrapS": 10497, "wrapT": 10497}]
        doc["textures"] = textures or [{"source": i, "sampler": 0}
                                       for i in range(len(img_docs))]
    if animations:
        anims = []
        for a in animations:
            t = add_accessor(np.asarray(a["times"], np.float32)[:, None],
                             5126, "SCALAR")
            v = add_accessor(np.asarray(a["values"], np.float32), 5126,
                             "VEC3")
            anims.append({"samplers": [{"input": t, "output": v}],
                          "channels": [{"sampler": 0, "target": {
                              "node": a["node"], "path": a["path"]}}]})
        doc["animations"] = anims
    doc["accessors"] = accessors
    doc["bufferViews"] = views
    if glb:
        doc["buffers"] = [{"byteLength": len(blob)}]
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        bin_ = bytes(blob) + b"\0" * (-len(blob) % 4)
        body = (struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(bin_), 0x004E4942) + bin_)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
    else:
        bname = os.path.splitext(os.path.basename(path))[0] + ".bin"
        with open(os.path.join(base, bname), "wb") as f:
            f.write(bytes(blob))
        doc["buffers"] = [{"byteLength": len(blob), "uri": bname}]
        with open(path, "w") as f:
            json.dump(doc, f)
    return path


def placed(prim, translate, rot_x=0.0):
    """prim's positions and normals rotated about x by rot_x, then moved."""
    c, s = np.cos(rot_x), np.sin(rot_x)
    r = np.array([[1, 0, 0], [0, c, s], [0, -s, c]], np.float32)
    pos, nrm, uv, idx = prim
    return dict(positions=(pos @ r + np.asarray(translate, np.float32)
                           ).astype(np.float32),
                normals=(nrm @ r).astype(np.float32), uvs=uv, indices=idx)


def mixed_scene(path):
    """The mixed test scene (module docstring): materials 0 ground, 1 the
    lattice (MASK, texture 0), 2 and 3 glass (BLEND, three panes), 4 a
    textured opaque quad (texture 1)."""
    ground = placed(grid_quad(4, 4, 8.0, 8.0), [0, -1.0, -3.0], -np.pi / 2)
    screen = placed(grid_quad(5, 4, 3.0, 2.0), [0.3, 0.0, -2.5])
    pane_a = placed(grid_quad(3, 2, 2.5, 1.6), [-0.2, 0.1, -1.8])
    pane_b = placed(grid_quad(3, 2, 2.5, 1.6), [0.1, -0.1, -1.5])
    pane_c = placed(grid_quad(3, 2, 2.5, 1.6), [0.0, 0.0, -2.1])
    tex_quad = placed(grid_quad(2, 2, 1.5, 1.5), [-1.2, 0.2, -3.5])
    prims = [dict(ground, material=0), dict(screen, material=1),
             dict(pane_a, material=2), dict(tex_quad, material=4),
             dict(pane_b, material=3), dict(pane_c, material=2)]
    materials = [
        {"name": "ground", "pbrMetallicRoughness": {
            "baseColorFactor": [0.5, 0.45, 0.4, 1.0], "metallicFactor": 0.0,
            "roughnessFactor": 0.7}},
        {"name": "lattice", "alphaMode": "MASK", "alphaCutoff": 0.5,
         "doubleSided": True, "pbrMetallicRoughness": {
             "baseColorFactor": [1.0, 1.0, 1.0, 1.0], "metallicFactor": 0.0,
             "roughnessFactor": 0.8,
             "baseColorTexture": {"index": 0, "extensions": {
                 "KHR_texture_transform": {"scale": [2.0, 2.0],
                                           "offset": [0.25, 0.0]}}}}},
        {"name": "glass_a", "alphaMode": "BLEND", "doubleSided": True,
         "pbrMetallicRoughness": {"baseColorFactor": [0.6, 0.8, 1.0, 0.4],
                                  "metallicFactor": 0.0,
                                  "roughnessFactor": 0.1}},
        {"name": "glass_b", "alphaMode": "BLEND", "doubleSided": True,
         "pbrMetallicRoughness": {"baseColorFactor": [1.0, 0.7, 0.5, 0.5],
                                  "metallicFactor": 0.0,
                                  "roughnessFactor": 0.2}},
        {"name": "tiles", "emissiveFactor": [0.1, 0.05, 0.0],
         "extensions": {"KHR_materials_emissive_strength": {
             "emissiveStrength": 2.0}},
         "pbrMetallicRoughness": {"baseColorTexture": {"index": 1},
                                  "metallicFactor": 0.2,
                                  "roughnessFactor": 0.5}},
    ]
    rng = np.random.default_rng(3)
    tiles = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    tiles[..., 3] = 255
    lights = [{"type": "directional", "color": [1.0, 0.95, 0.9],
               "intensity": 3.0},
              {"type": "point", "color": [1.0, 0.8, 0.6], "intensity": 8.0,
               "range": 20.0},
              {"type": "spot", "color": [0.6, 0.8, 1.0], "intensity": 5.0,
               "spot": {"innerConeAngle": 0.2, "outerConeAngle": 0.6}}]
    anim = [{"node": 2, "path": "translation", "times": [0.0, 1.0],
             "values": [[0, 0, 0], [0.1, 0.0, 0.0]]}]
    return write_gltf(path, prims, materials,
                      images=[lattice_rgba(), tiles], lights=lights,
                      animations=anim,
                      samplers=[{"wrapS": 33648, "wrapT": 33071},
                                {"wrapS": 10497, "wrapT": 10497}],
                      textures=[{"source": 0, "sampler": 0},
                                {"source": 1, "sampler": 1}])


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def assert_same(a, b, where="model"):
    """Equal, field by field, through dataclasses, lists, tuples and dicts;
    arrays by value and dtype."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("ext", [".gltf", ".glb"])
def test_load_gltf_matches_jax(tmp_path, ext):
    """load_gltf of the mixed scene: every field of the model (meshes,
    materials, images, samplers, nodes with their world matrices, lights,
    animations, scene nodes) equals the JAX loader's."""
    path = mixed_scene(str(tmp_path / f"mixed{ext}"))
    ref = jloader.load_gltf(path)
    got = tloader.load_gltf(path)
    assert len(got.meshes) == 6 and len(got.animations) == 1
    assert got.images[0] is not None and got.images[0].shape == (64, 64, 4)
    assert_same(ref, got)


def test_load_gltf_bytes_matches_jax(tmp_path):
    """load_gltf_bytes (the in-memory path) of the .glb and of the quad of
    tests/test_gltf.py, whose buffer is a data URI."""
    from tests.test_gltf import make_quad_gltf
    for path in (mixed_scene(str(tmp_path / "m.glb")),
                 make_quad_gltf(str(tmp_path), alpha_mode="MASK")):
        with open(path, "rb") as f:
            data = f.read()
        assert_same(jloader.load_gltf_bytes(data, str(tmp_path)),
                    tloader.load_gltf_bytes(data, str(tmp_path)))


def assert_scene_equal(ref, got):
    """Every array of a JAX RenderScene equals the port's: the scene's
    fields (None where the JAX one is None), its materials and material
    extensions field by field, the atlas
    (mips, scale_bias, layer) or the texture heap (texels, mip_base,
    mip_size), the lights and the node slots."""
    rs, gs = ref.scene, got.scene
    for f in type(gs)._fields:
        a, b = getattr(rs, f), getattr(gs, f)
        assert (a is None) == (b is None), f
        if f.startswith("materials"):
            for g in (type(b)._fields if b is not None else ()):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, g)), getattr(b, g).numpy(),
                    err_msg=f"{f}.{g}")
            continue
        if a is not None:
            a = np.array(a)
            assert b.dtype == torch.from_numpy(a).dtype, f
            np.testing.assert_array_equal(a, b.numpy(), err_msg=f)
    assert type(ref.atlas).__name__ == type(got.atlas).__name__
    if type(got.atlas).__name__ == "TextureHeap":
        assert ref.atlas.num_mips == got.atlas.num_mips
        for f in ("texels", "mip_base", "mip_size"):
            a, b = np.array(getattr(ref.atlas, f)), getattr(got.atlas, f)
            assert b.dtype == torch.from_numpy(a).dtype, f
            np.testing.assert_array_equal(a, b.numpy(), err_msg=f)
    else:
        assert len(ref.atlas.mips) == len(got.atlas.mips)
        for a, b in zip(ref.atlas.mips, got.atlas.mips):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(ref.atlas.scale_bias),
                                      got.atlas.scale_bias.numpy())
        np.testing.assert_array_equal(np.asarray(ref.atlas.layer),
                                      got.atlas.layer.numpy())
    assert (ref.lights is None) == (got.lights is None)
    if ref.lights is not None:
        for f in type(got.lights)._fields:
            np.testing.assert_array_equal(np.asarray(getattr(ref.lights, f)),
                                          getattr(got.lights, f).numpy(),
                                          err_msg=f)
    assert ref.mesh_node_ids == got.mesh_node_ids


@pytest.mark.parametrize("ext", [".gltf", ".glb"])
def test_build_render_scene_matches_jax(tmp_path, ext):
    """build_render_scene of the mixed scene: the MASK triangles at the
    tail of `indices` in the same (stable) order, the BLEND primitives in
    blend_indices / blend_tri_material, the texture bindings, the atlas
    pixels and the lights all equal the JAX package's."""
    path = mixed_scene(str(tmp_path / f"mixed{ext}"))
    ref = jmodel.build_render_scene(jloader.load_gltf(path))
    got = tmodel.build_render_scene(tloader.load_gltf(path), device="cpu")
    assert_scene_equal(ref, got)
    s = got.scene
    n_mask = s.mask_indices.shape[0]
    assert n_mask == 40 and s.blend_indices.shape[0] == 36
    assert torch.equal(s.indices[-n_mask:], s.mask_indices)
    assert (s.tri_material[-n_mask:] == 1).all()
    assert (s.tri_material[:-n_mask] != 1).all()
    assert set(s.blend_tri_material.tolist()) == {2, 3}


def test_build_render_scene_all_blend(tmp_path):
    """A scene of blend geometry alone keeps one degenerate opaque
    triangle, as the JAX package does; a scene without textures gets the
    white atlas."""
    from tests.test_gltf import make_quad_gltf
    path = make_quad_gltf(str(tmp_path), with_texture=False,
                          alpha_mode="BLEND")
    ref = jmodel.build_render_scene(jloader.load_gltf(path))
    got = tmodel.build_render_scene(tloader.load_gltf(path), device="cpu")
    assert_scene_equal(ref, got)
    assert got.scene.indices.shape[0] == 1
    assert got.scene.blend_indices.shape[0] == 2


def test_unported_options_raise(tmp_path):
    """The texture heap ("array" mode) builds the JAX package's scene and
    heap (an unknown mode raises ValueError); a material with every
    extension and a skinned quad (a node with a skin, its primitive without
    joints: -1 joints, zero weights, one identity joint matrix) build the
    JAX package's scenes, and update_animation of the skinned quad equals
    the JAX package's, with and without a previous time."""
    from diligentfx_tpu.gltf.animation import AnimationPlayer as JPlayer
    from diligentfx_tpu_torch.gltf.animation import AnimationPlayer
    from tests.test_gltf import make_quad_gltf
    path = mixed_scene(str(tmp_path / "mixed.gltf"))
    model = tloader.load_gltf(path)
    assert_scene_equal(
        jmodel.build_render_scene(jloader.load_gltf(path),
                                  texture_binding_mode="array"),
        tmodel.build_render_scene(model, texture_binding_mode="array",
                                  device="cpu"))
    with pytest.raises(ValueError, match="texture_binding_mode"):
        tmodel.build_render_scene(model, texture_binding_mode="bindless",
                                  device="cpu")
    jmodel_ = jloader.load_gltf(path)
    for m in (model, jmodel_):
        mat = m.materials[0]
        mat.sheen_color, mat.sheen_roughness = (0.5, 0.4, 0.3), 0.6
        mat.anisotropy_strength, mat.anisotropy_rotation = 0.7, 0.4
        mat.iridescence_factor, mat.iridescence_ior = 1.0, 1.4
        mat.transmission_factor = 0.9
        mat.volume_thickness = 0.5
        mat.volume_attenuation_color = (0.9, 0.5, 0.2)
    got = tmodel.build_render_scene(model, device="cpu")
    assert_scene_equal(jmodel.build_render_scene(jmodel_), got)
    assert got.scene.materials_volume.attenuation_color.shape == (
        len(model.materials), 3)
    qpath = make_quad_gltf(str(tmp_path))
    model, jm_ = tloader.load_gltf(qpath), jloader.load_gltf(qpath)
    model.nodes[0].skin = jm_.nodes[0].skin = 0
    got = tmodel.build_render_scene(model, device="cpu")
    ref = jmodel.build_render_scene(jm_)
    assert_scene_equal(ref, got)
    assert got.scene.joints.tolist() == [[-1] * 4] * 4
    assert got.scene.joint_matrices.shape == (1, 4, 4)
    player, jplayer = AnimationPlayer(model, []), JPlayer(jm_, [])
    for prev_t in (None, 0.5):
        assert_scene_equal(
            jmodel.update_animation(ref, jm_, jplayer, 1.0, prev_t),
            tmodel.update_animation(got, model, player, 1.0, prev_t))
