"""glTF model -> render-ready scene bundle (the port of
diligentfx_tpu/gltf/model.py).

`build_render_scene` flattens the default scene's node hierarchy into one
ScenePrimitives plus the material textures (a texture atlas, or a texture
heap at native sizes) and the scene's lights, as the JAX package does:
ALPHA_MODE_MASK triangles go to the tail of the index buffer
(`mask_indices`) and resolve through the K-layer alpha test
(pbr/oit.py resolve_alpha_mask); ALPHA_MODE_BLEND primitives split into
`blend_indices` / `blend_tri_material` and render through K-layer OIT.
JPEG images decode through Pillow when it is installed, else a neutral gray.

The material extensions (sheen, anisotropy, iridescence, transmission,
volume) stack into the scene's extension attribs, each only when a
material uses it; skinned meshes flatten into per-vertex joints (offset per
skin into one joint-matrix array) and normalised weights.
`update_animation` evaluates the animation at a time and uploads the node
and joint matrices, the previous ones kept for motion vectors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from diligentfx_tpu_torch.attribs import (PBRLightAttribs,
                                          PBRMaterialAnisotropyAttribs,
                                          PBRMaterialBasicAttribs,
                                          PBRMaterialIridescenceAttribs,
                                          PBRMaterialSheenAttribs,
                                          PBRMaterialTransmissionAttribs,
                                          PBRMaterialVolumeAttribs,
                                          stack_materials)
from diligentfx_tpu_torch.device import resolve_device
from diligentfx_tpu_torch.gltf.loader import GLTFModel, GLTFTextureRef
from diligentfx_tpu_torch.gltf.primitives import compute_tangents
from diligentfx_tpu_torch.ops.texture import (AtlasBuilder,
                                              TextureHeapBuilder, white_atlas)

# texture slot order in ScenePrimitives.tex_ids
SLOT_BASE_COLOR = 0
SLOT_NORMAL = 1
SLOT_PHYS_DESC = 2
SLOT_EMISSIVE = 3
SLOT_OCCLUSION = 4
NUM_SLOTS = 5

class RenderScene(NamedTuple):
    scene: object               # pbr.renderer.ScenePrimitives
    atlas: object               # TextureAtlas or TextureHeap
    lights: Optional[PBRLightAttribs]
    mesh_node_ids: tuple = ()   # model node index per scene node slot


def update_animation(rs: RenderScene, model: GLTFModel, player, t: float,
                     prev_t: Optional[float] = None) -> RenderScene:
    """Advance the animation (JAX model.py:39): evaluate the node worlds
    and the skins' joint matrices at time t on the host and upload them to
    the scene's device.  The previous matrices are the scene's current
    ones, or, with `prev_t`, the ones evaluated at prev_t (motion vectors;
    HnSkinningComputation's double buffering).  The upload is in the range
    dfx.skinning."""
    from diligentfx_tpu_torch.gltf.animation import compute_skin_matrices
    scene = rs.scene
    dev = scene.node_matrices.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def joint_mats(worlds):
        return np.concatenate([compute_skin_matrices(model, s, worlds)
                               for s in range(len(model.skins))])

    worlds = player.evaluate(t)
    skinned = bool(model.skins) and scene.joint_matrices is not None
    with torch.profiler.record_function("dfx.skinning"):
        node_m = up(np.stack([worlds[ni].astype(np.float32)
                              for ni in rs.mesh_node_ids]))
        prev_node_m = scene.node_matrices
        jm = prev_jm = None
        if skinned:
            jm = up(joint_mats(worlds))
            prev_jm = scene.joint_matrices
        if prev_t is not None:
            prev_worlds = player.evaluate(prev_t)
            prev_node_m = up(np.stack([prev_worlds[ni].astype(np.float32)
                                       for ni in rs.mesh_node_ids]))
            if skinned:
                prev_jm = up(joint_mats(prev_worlds))
    scene = scene._replace(
        node_matrices=node_m, prev_node_matrices=prev_node_m,
        joint_matrices=jm if jm is not None else scene.joint_matrices,
        prev_joint_matrices=(prev_jm if prev_jm is not None
                             else scene.prev_joint_matrices))
    return rs._replace(scene=scene)


def _extension_attribs(mats, device) -> dict:
    """The stacked extension attribs (JAX model.py:146-170), each only when
    a material uses its extension: ScenePrimitives field -> attribs on
    `device`."""
    out = {}
    if any(np.any(np.asarray(m.sheen_color) > 0) for m in mats):
        out["materials_sheen"] = stack_materials([
            PBRMaterialSheenAttribs.create(m.sheen_color, m.sheen_roughness)
            for m in mats], device)
    if any(m.anisotropy_strength != 0 for m in mats):
        out["materials_anisotropy"] = stack_materials([
            PBRMaterialAnisotropyAttribs.create(m.anisotropy_strength,
                                                m.anisotropy_rotation)
            for m in mats], device)
    if any(m.iridescence_factor != 0 for m in mats):
        out["materials_iridescence"] = stack_materials([
            PBRMaterialIridescenceAttribs.create(
                m.iridescence_factor, m.iridescence_ior,
                m.iridescence_thickness_min, m.iridescence_thickness_max)
            for m in mats], device)
    if any(m.transmission_factor != 0 for m in mats):
        out["materials_transmission"] = stack_materials([
            PBRMaterialTransmissionAttribs.create(m.transmission_factor)
            for m in mats], device)
    if any(m.volume_thickness != 0 for m in mats):
        out["materials_volume"] = stack_materials([
            PBRMaterialVolumeAttribs.create(
                m.volume_attenuation_color, m.volume_thickness,
                min(m.volume_attenuation_distance, 1e9)) for m in mats], device)
    return out


def build_render_scene(model: GLTFModel, atlas_size: int = 1024,
                       extra_lights: Optional[PBRLightAttribs] = None,
                       texture_binding_mode: str = "atlas",
                       device=None) -> RenderScene:
    """Flatten the default scene's node hierarchy into one ScenePrimitives +
    the material textures + the scene's lights, on `device` (CUDA unless
    the caller asks for the CPU).  JAX model.py:74.

    texture_binding_mode "atlas" packs every texture into layers of
    `atlas_size` (a larger one is scaled down); "array" keeps each at its
    native size in a texture heap (ops/texture.py TextureHeap)."""
    from diligentfx_tpu_torch.pbr.renderer import ScenePrimitives

    if texture_binding_mode not in ("atlas", "array"):
        raise ValueError(f"texture_binding_mode must be atlas or array, got "
                         f"{texture_binding_mode!r}")
    dev = resolve_device(device)
    builder = (TextureHeapBuilder() if texture_binding_mode == "array"
               else AtlasBuilder(size=atlas_size))
    image_to_tex = {}

    def atlas_id(ref: Optional[GLTFTextureRef], srgb: bool) -> int:
        if ref is None or ref.image < 0:
            return -1
        key = ref.image
        if key not in image_to_tex:
            img = model.images[ref.image]
            if img is None:
                img = np.full((4, 4, 4), 0.5, np.float32)  # JPEG stub
            image_to_tex[key] = builder.add(img)
        return image_to_tex[key]

    mats = model.materials or []
    basic = []
    tex_ids = np.full((max(len(mats), 1), NUM_SLOTS), -1, np.int32)
    tex_xform = np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32),
                        (max(len(mats), 1), NUM_SLOTS, 1))
    tex_wraps = np.zeros((max(len(mats), 1), NUM_SLOTS, 2), np.int32)
    alpha_map = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}
    for mi, m in enumerate(mats):
        basic.append(PBRMaterialBasicAttribs.create(
            base_color_factor=m.base_color_factor,
            emissive_factor=tuple(np.asarray(m.emissive_factor)
                                  * m.emissive_strength),
            normal_scale=m.normal_scale,
            workflow=2 if m.unlit else 0,
            alpha_mode=alpha_map.get(m.alpha_mode, 0),
            alpha_mask_cutoff=m.alpha_cutoff,
            metallic_factor=m.metallic_factor,
            roughness_factor=m.roughness_factor,
            occlusion_factor=m.occlusion_strength,
            clearcoat_factor=m.clearcoat_factor,
            clearcoat_roughness_factor=m.clearcoat_roughness,
        ))
        for slot, (ref, srgb) in enumerate([
                (m.base_color_texture, True),
                (m.normal_texture, False),
                (m.metallic_roughness_texture, False),
                (m.emissive_texture, True),
                (m.occlusion_texture, False)]):
            tid = atlas_id(ref, srgb)
            tex_ids[mi, slot] = tid
            if ref is not None:
                tex_xform[mi, slot, :4] = ref.uv_scale_rotation
                tex_xform[mi, slot, 4:] = ref.uv_offset
                if 0 <= ref.sampler < len(model.sampler_wraps):
                    tex_wraps[mi, slot] = model.sampler_wraps[ref.sampler]
    if not basic:
        basic.append(PBRMaterialBasicAttribs.create())

    atlas = (builder.build(device=dev) if builder.images
             else white_atlas(device=dev))

    # flatten scene nodes with meshes (BLEND geometry splits into the OIT set)
    pos, nrm, uv, tan = [], [], [], []
    idx, vnode, tmat, tds = [], [], [], []
    bidx, btmat = [], []
    node_mats = []
    joints_l, weights_l = [], []
    any_skin = any(model.nodes[ni].skin >= 0 and model.nodes[ni].mesh >= 0
                   for ni in model.default_scene_nodes)
    # each skin's offset into the concatenated joint-matrix array
    skin_offsets = []
    off = 0
    for sk in model.skins:
        skin_offsets.append(off)
        off += len(sk["joints"])
    total_joints = max(off, 1)
    mesh_node_ids = []
    v_off = 0
    node_slot = 0
    for ni in model.default_scene_nodes:
        node = model.nodes[ni]
        if node.mesh < 0:
            continue
        for prim in model.meshes[node.mesh]:
            v = prim.positions.shape[0]
            p = prim.positions
            n = prim.normals
            if n is None:
                # flat-ish fallback: area-weighted vertex normals
                n = np.zeros_like(p)
                t0, t1, t2 = (prim.indices[:, k] for k in range(3))
                fn = np.cross(p[t1] - p[t0], p[t2] - p[t0])
                for k in (t0, t1, t2):
                    np.add.at(n, k, fn)
                ln = np.linalg.norm(n, axis=-1, keepdims=True)
                n = n / np.maximum(ln, 1e-12)
            u = (prim.uv0 if prim.uv0 is not None
                 else np.zeros((v, 2), np.float32))
            t = prim.tangents
            if t is None:
                t = compute_tangents(p, n, u, prim.indices)
            pos.append(p)
            nrm.append(n.astype(np.float32))
            uv.append(u.astype(np.float32))
            tan.append(t.astype(np.float32))
            vnode.append(np.full(v, node_slot, np.int32))
            if any_skin:
                if (node.skin >= 0 and prim.joints is not None
                        and prim.weights is not None):
                    joints_l.append(prim.joints.astype(np.int32)
                                    + skin_offsets[node.skin])
                    w4 = prim.weights.astype(np.float32)
                    wsum = np.maximum(w4.sum(-1, keepdims=True), 1e-9)
                    weights_l.append(w4 / wsum)
                else:
                    joints_l.append(np.full((v, 4), -1, np.int32))
                    weights_l.append(np.zeros((v, 4), np.float32))
            mat_i = prim.material if prim.material >= 0 else 0
            nt = prim.indices.shape[0]
            is_blend = (mat_i < len(mats)
                        and mats[mat_i].alpha_mode == "BLEND")
            if is_blend:
                bidx.append(prim.indices + v_off)
                btmat.append(np.full(nt, mat_i, np.int32))
            else:
                idx.append(prim.indices + v_off)
                tmat.append(np.full(nt, mat_i, np.int32))
                ds = mats[mat_i].double_sided if mat_i < len(mats) else False
                tds.append(np.full(nt, ds, bool))
            v_off += v
        node_mats.append(node.world.astype(np.float32))
        mesh_node_ids.append(ni)
        node_slot += 1

    if not pos:
        raise ValueError("glTF scene contains no triangle geometry")
    if not idx:
        # all-transparent scene: keep a degenerate opaque triangle so the
        # main pass has nonzero shapes
        idx.append(np.zeros((1, 3), np.int32))
        tmat.append(np.zeros(1, np.int32))
        tds.append(np.zeros(1, bool))

    def t_(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    node_m = t_(np.stack(node_mats))
    idx_np = np.concatenate(idx)
    tmat_np = np.concatenate(tmat)
    tds_np = np.concatenate(tds)
    # ALPHA_MODE_MASK tris to the tail (ScenePrimitives.mask_indices invariant)
    mat_is_mask = np.array([m.alpha_mode == "MASK" for m in mats], bool)
    is_mask = (mat_is_mask[np.clip(tmat_np, 0, max(len(mats) - 1, 0))]
               if len(mats) else np.zeros(tmat_np.shape[0], bool))
    mask_idx = None
    if is_mask.any():
        order = np.argsort(is_mask, kind="stable")
        idx_np, tmat_np, tds_np = idx_np[order], tmat_np[order], tds_np[order]
        mask_idx = t_(idx_np[-int(is_mask.sum()):], torch.int32)
    scene = ScenePrimitives(
        positions=t_(np.concatenate(pos), torch.float32),
        normals=t_(np.concatenate(nrm), torch.float32),
        uvs=t_(np.concatenate(uv), torch.float32),
        tangents=t_(np.concatenate(tan), torch.float32),
        indices=t_(idx_np, torch.int32),
        vertex_node=t_(np.concatenate(vnode), torch.int32),
        tri_material=t_(tmat_np, torch.int32),
        tri_double_sided=t_(tds_np, torch.bool),
        mask_indices=mask_idx,
        node_matrices=node_m,
        prev_node_matrices=node_m,
        materials=stack_materials(basic, dev),
        tex_ids=t_(tex_ids, torch.int32),
        tex_uv_transform=t_(tex_xform, torch.float32),
        tex_wraps=t_(tex_wraps, torch.int32),
        blend_indices=(t_(np.concatenate(bidx), torch.int32) if bidx
                       else None),
        blend_tri_material=(t_(np.concatenate(btmat), torch.int32) if btmat
                            else None),
        **_extension_attribs(mats, dev),
    )
    if joints_l:
        eye = np.tile(np.eye(4, dtype=np.float32)[None], (total_joints, 1, 1))
        scene = scene._replace(
            joints=t_(np.concatenate(joints_l), torch.int32),
            weights=t_(np.concatenate(weights_l), torch.float32),
            joint_matrices=t_(eye), prev_joint_matrices=t_(eye))

    # lights from the node hierarchy
    lights = []
    for ni in model.default_scene_nodes:
        node = model.nodes[ni]
        if node.light < 0 or node.light >= len(model.lights):
            continue
        lt = model.lights[node.light]
        w = node.world
        lpos = w[3, :3]
        ldir = -w[2, :3]  # glTF lights point down local -Z
        ldir = ldir / max(np.linalg.norm(ldir), 1e-9)
        intensity = tuple(np.asarray(lt.color) * lt.intensity)
        rng = lt.range if lt.range > 0 else 100.0
        if lt.type == "directional":
            lights.append(PBRLightAttribs.directional(ldir, intensity,
                                                      device=dev))
        elif lt.type == "point":
            lights.append(PBRLightAttribs.point(lpos, intensity, range=rng,
                                                device=dev))
        else:
            lights.append(PBRLightAttribs.spot(
                lpos, ldir, intensity, lt.inner_cone_angle,
                lt.outer_cone_angle, range=rng, device=dev))
    if extra_lights is not None:
        lights.append(extra_lights)
    all_lights = PBRLightAttribs.concat(lights) if lights else None
    return RenderScene(scene=scene, atlas=atlas, lights=all_lights,
                       mesh_node_ids=tuple(mesh_node_ids))
