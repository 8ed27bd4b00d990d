"""glTF 2.0 loader — host-side, dependency-free (the port's own copy of
diligentfx_tpu/gltf/loader.py; numpy only).

The analogue of the DiligentTools GLTF loader consumed by GLTF_PBR_Renderer
(GLTF_PBR_Renderer.cpp:497 `GLTF::Model`) and of Radient's
RadientGLTFLoader/Converter (Radient/src/Import, SURVEY.md §2.5).

Supports: .glb and .gltf (external or base64 data-URI buffers), all accessor
component types (+ sparse), TRIANGLES primitives (+ STRIP/FAN conversion),
PBR metallic-roughness materials with normal/occlusion/emissive maps, alpha
modes, double-sided, KHR_texture_transform, and the material extension set of
the reference (clearcoat, sheen, anisotropy, iridescence, transmission,
volume, ior, specular, emissive_strength, unlit), node TRS hierarchies,
cameras, KHR_lights_punctual, skins (data only), PNG images (8-bit).
"""
from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


@dataclass
class GLTFPrimitive:
    positions: np.ndarray                 # (V, 3) f32
    normals: Optional[np.ndarray]         # (V, 3)
    uv0: Optional[np.ndarray]             # (V, 2)
    uv1: Optional[np.ndarray]
    tangents: Optional[np.ndarray]        # (V, 4)
    colors: Optional[np.ndarray]          # (V, 4)
    joints: Optional[np.ndarray]          # (V, 4) int
    weights: Optional[np.ndarray]         # (V, 4) f32
    indices: np.ndarray                   # (T, 3) int32
    material: int = -1


@dataclass
class GLTFTextureRef:
    image: int = -1
    sampler: int = -1
    texcoord: int = 0
    # KHR_texture_transform
    uv_scale_rotation: Tuple[float, float, float, float] = (1, 0, 0, 1)
    uv_offset: Tuple[float, float] = (0.0, 0.0)


@dataclass
class GLTFMaterial:
    """Factors + texture refs, mirroring GLTF::Material as consumed by
    GLTF_PBR_Renderer (base + the extension attribs of PBR_Structures.fxh)."""
    name: str = ""
    base_color_factor: Tuple[float, ...] = (1, 1, 1, 1)
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    emissive_factor: Tuple[float, ...] = (0, 0, 0)
    emissive_strength: float = 1.0
    normal_scale: float = 1.0
    occlusion_strength: float = 1.0
    alpha_mode: str = "OPAQUE"
    alpha_cutoff: float = 0.5
    double_sided: bool = False
    unlit: bool = False
    ior: float = 1.5
    base_color_texture: Optional[GLTFTextureRef] = None
    metallic_roughness_texture: Optional[GLTFTextureRef] = None
    normal_texture: Optional[GLTFTextureRef] = None
    occlusion_texture: Optional[GLTFTextureRef] = None
    emissive_texture: Optional[GLTFTextureRef] = None
    # extensions
    clearcoat_factor: float = 0.0
    clearcoat_roughness: float = 0.0
    sheen_color: Tuple[float, ...] = (0, 0, 0)
    sheen_roughness: float = 0.0
    anisotropy_strength: float = 0.0
    anisotropy_rotation: float = 0.0
    iridescence_factor: float = 0.0
    iridescence_ior: float = 1.3
    iridescence_thickness_min: float = 100.0
    iridescence_thickness_max: float = 400.0
    transmission_factor: float = 0.0
    volume_thickness: float = 0.0
    volume_attenuation_distance: float = float("inf")
    volume_attenuation_color: Tuple[float, ...] = (1, 1, 1)
    specular_factor: float = 1.0
    specular_color: Tuple[float, ...] = (1, 1, 1)


@dataclass
class GLTFNode:
    name: str
    mesh: int = -1
    skin: int = -1
    camera: int = -1
    light: int = -1
    parent: int = -1
    local: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    world: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))


@dataclass
class GLTFLight:
    type: str = "directional"
    color: Tuple[float, ...] = (1, 1, 1)
    intensity: float = 1.0
    range: float = 0.0
    inner_cone_angle: float = 0.0
    outer_cone_angle: float = 0.7853981634


@dataclass
class GLTFModel:
    meshes: List[List[GLTFPrimitive]] = field(default_factory=list)
    materials: List[GLTFMaterial] = field(default_factory=list)
    images: List[Optional[np.ndarray]] = field(default_factory=list)
    sampler_wraps: List[Tuple[int, int]] = field(default_factory=list)
    nodes: List[GLTFNode] = field(default_factory=list)
    lights: List[GLTFLight] = field(default_factory=list)
    skins: List[Dict[str, Any]] = field(default_factory=list)
    animations: List[Any] = field(default_factory=list)
    default_scene_nodes: List[int] = field(default_factory=list)


def _trs_matrix(node: dict) -> np.ndarray:
    """Row-vector local matrix from node TRS or matrix (glTF column-major)."""
    if "matrix" in node:
        m = np.asarray(node["matrix"], np.float32).reshape(4, 4)
        # glTF stores column-major column-vector; our convention is
        # row-vector — the memory layout transposes to exactly what we need.
        return m
    t = node.get("translation", [0, 0, 0])
    r = node.get("rotation", [0, 0, 0, 1])
    s = node.get("scale", [1, 1, 1])
    x, y, z, w = r
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w), 0],
        [2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w), 0],
        [2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y), 0],
        [0, 0, 0, 1]], np.float32)
    sm = np.diag([s[0], s[1], s[2], 1.0]).astype(np.float32)
    tm = np.eye(4, dtype=np.float32)
    tm[3, :3] = t
    return sm @ rot @ tm


class _Reader:
    def __init__(self, doc: dict, buffers: List[bytes], base_dir: str):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    def buffer_view(self, idx: int) -> Tuple[bytes, int]:
        bv = self.doc["bufferViews"][idx]
        data = self.buffers[bv["buffer"]]
        off = bv.get("byteOffset", 0)
        return data[off:off + bv["byteLength"]], bv.get("byteStride", 0)

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.doc["accessors"][idx]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        if "bufferView" in acc:
            raw, stride = self.buffer_view(acc["bufferView"])
            off = acc.get("byteOffset", 0)
            itemsize = np.dtype(dtype).itemsize * ncomp
            if stride and stride != itemsize:
                out = np.zeros((count, ncomp), dtype)
                for i in range(count):
                    s = off + i * stride
                    out[i] = np.frombuffer(raw[s:s + itemsize], dtype)
                arr = out
            else:
                arr = np.frombuffer(raw[off:off + count * itemsize], dtype).reshape(
                    count, ncomp).copy()
        else:
            arr = np.zeros((count, ncomp), dtype)
        # sparse overrides
        sp = acc.get("sparse")
        if sp:
            n = sp["count"]
            idx_acc = sp["indices"]
            iv, _ = self.buffer_view(idx_acc["bufferView"])
            it = _COMPONENT_DTYPES[idx_acc["componentType"]]
            ioff = idx_acc.get("byteOffset", 0)
            sidx = np.frombuffer(iv[ioff:ioff + n * np.dtype(it).itemsize], it)
            vv, _ = self.buffer_view(sp["values"]["bufferView"])
            voff = sp["values"].get("byteOffset", 0)
            vals = np.frombuffer(
                vv[voff:voff + n * np.dtype(dtype).itemsize * ncomp], dtype
            ).reshape(n, ncomp)
            arr[sidx] = vals
        if acc.get("normalized") and arr.dtype != np.float32:
            info = np.iinfo(arr.dtype)
            arr = arr.astype(np.float32) / max(abs(info.min), info.max)
        return arr


def _decode_image(blob: bytes, uri: str = "") -> Optional[np.ndarray]:
    if blob[:8] == b"\x89PNG\r\n\x1a\n":
        import io
        import tempfile
        from diligentfx_tpu_torch.utils.image import read_png
        # read_png works from a path; use an in-memory round trip
        with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as f:
            f.write(blob)
            path = f.name
        try:
            return read_png(path)
        finally:
            os.unlink(path)
    # JPEG (and anything else PIL knows): decode via Pillow when present;
    # otherwise the caller substitutes a neutral stub
    try:
        import io

        from PIL import Image
        with Image.open(io.BytesIO(blob)) as im:
            im = im.convert("RGBA")
            return np.asarray(im, np.uint8).astype(np.float32) / 255.0
    except Exception:
        return None


def _tex_ref(doc: dict, info: Optional[dict]) -> Optional[GLTFTextureRef]:
    if not info:
        return None
    tex = doc.get("textures", [])[info["index"]]
    ref = GLTFTextureRef(image=tex.get("source", -1),
                         sampler=tex.get("sampler", -1),
                         texcoord=info.get("texCoord", 0))
    ext = info.get("extensions", {}).get("KHR_texture_transform")
    if ext:
        import math
        sx, sy = ext.get("scale", [1, 1])
        rot = ext.get("rotation", 0.0)
        ox, oy = ext.get("offset", [0, 0])
        c, s = math.cos(rot), math.sin(rot)
        ref.uv_scale_rotation = (sx * c, -sx * s, sy * s, sy * c)
        ref.uv_offset = (ox, oy)
        if "texCoord" in ext:
            ref.texcoord = ext["texCoord"]
    return ref


def _parse_material(doc: dict, m: dict) -> GLTFMaterial:
    out = GLTFMaterial(name=m.get("name", ""))
    pbr = m.get("pbrMetallicRoughness", {})
    out.base_color_factor = tuple(pbr.get("baseColorFactor", [1, 1, 1, 1]))
    out.metallic_factor = pbr.get("metallicFactor", 1.0)
    out.roughness_factor = pbr.get("roughnessFactor", 1.0)
    out.base_color_texture = _tex_ref(doc, pbr.get("baseColorTexture"))
    out.metallic_roughness_texture = _tex_ref(doc, pbr.get("metallicRoughnessTexture"))
    out.emissive_factor = tuple(m.get("emissiveFactor", [0, 0, 0]))
    nt = m.get("normalTexture")
    out.normal_texture = _tex_ref(doc, nt)
    if nt:
        out.normal_scale = nt.get("scale", 1.0)
    ot = m.get("occlusionTexture")
    out.occlusion_texture = _tex_ref(doc, ot)
    if ot:
        out.occlusion_strength = ot.get("strength", 1.0)
    out.emissive_texture = _tex_ref(doc, m.get("emissiveTexture"))
    out.alpha_mode = m.get("alphaMode", "OPAQUE")
    out.alpha_cutoff = m.get("alphaCutoff", 0.5)
    out.double_sided = m.get("doubleSided", False)

    ext = m.get("extensions", {})
    if "KHR_materials_unlit" in ext:
        out.unlit = True
    if "KHR_materials_ior" in ext:
        out.ior = ext["KHR_materials_ior"].get("ior", 1.5)
    cc = ext.get("KHR_materials_clearcoat")
    if cc:
        out.clearcoat_factor = cc.get("clearcoatFactor", 0.0)
        out.clearcoat_roughness = cc.get("clearcoatRoughnessFactor", 0.0)
    shn = ext.get("KHR_materials_sheen")
    if shn:
        out.sheen_color = tuple(shn.get("sheenColorFactor", [0, 0, 0]))
        out.sheen_roughness = shn.get("sheenRoughnessFactor", 0.0)
    an = ext.get("KHR_materials_anisotropy")
    if an:
        out.anisotropy_strength = an.get("anisotropyStrength", 0.0)
        out.anisotropy_rotation = an.get("anisotropyRotation", 0.0)
    ir = ext.get("KHR_materials_iridescence")
    if ir:
        out.iridescence_factor = ir.get("iridescenceFactor", 0.0)
        out.iridescence_ior = ir.get("iridescenceIor", 1.3)
        out.iridescence_thickness_min = ir.get("iridescenceThicknessMinimum", 100.0)
        out.iridescence_thickness_max = ir.get("iridescenceThicknessMaximum", 400.0)
    tr = ext.get("KHR_materials_transmission")
    if tr:
        out.transmission_factor = tr.get("transmissionFactor", 0.0)
    vol = ext.get("KHR_materials_volume")
    if vol:
        out.volume_thickness = vol.get("thicknessFactor", 0.0)
        out.volume_attenuation_distance = vol.get("attenuationDistance", float("inf"))
        out.volume_attenuation_color = tuple(vol.get("attenuationColor", [1, 1, 1]))
    sp = ext.get("KHR_materials_specular")
    if sp:
        out.specular_factor = sp.get("specularFactor", 1.0)
        out.specular_color = tuple(sp.get("specularColorFactor", [1, 1, 1]))
    es = ext.get("KHR_materials_emissive_strength")
    if es:
        out.emissive_strength = es.get("emissiveStrength", 1.0)
    return out


def load_gltf(path: str) -> GLTFModel:
    """Load a .gltf or .glb file."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        return load_gltf_bytes(f.read(), base_dir)


def load_gltf_bytes(data: bytes, base_dir: str = ".") -> GLTFModel:
    """Load a .gltf/.glb document from memory (the resolver-chain path:
    assets arrive as (bytes, canonical location), radient/resolver.py).
    External buffer/image URIs resolve relative to `base_dir`."""
    if data[:4] == b"glTF":
        magic, version, length = struct.unpack("<III", data[:12])
        doc = None
        bin_chunk = b""
        pos = 12
        while pos < length:
            clen, ctype = struct.unpack("<II", data[pos:pos + 8])
            chunk = data[pos + 8:pos + 8 + clen]
            pos += 8 + clen
            if ctype == 0x4E4F534A:       # JSON
                doc = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:     # BIN
                bin_chunk = chunk
        assert doc is not None, "GLB missing JSON chunk"
        embedded = bin_chunk
    else:
        doc = json.loads(data.decode("utf-8"))
        embedded = b""
    return parse_gltf(doc, base_dir, embedded)


def parse_gltf(doc: dict, base_dir: str = ".", embedded_bin: bytes = b"") -> GLTFModel:
    # --- buffers ---
    buffers: List[bytes] = []
    for b in doc.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            buffers.append(embedded_bin)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as bf:
                buffers.append(bf.read())
    rd = _Reader(doc, buffers, base_dir)
    model = GLTFModel()

    # --- images ---
    for img in doc.get("images", []):
        uri = img.get("uri")
        if uri and not uri.startswith("data:"):
            p = os.path.join(base_dir, uri)
            try:
                with open(p, "rb") as imf:
                    model.images.append(_decode_image(imf.read(), uri))
            except OSError:
                model.images.append(None)
        elif uri:
            model.images.append(_decode_image(
                base64.b64decode(uri.split(",", 1)[1]), uri))
        elif "bufferView" in img:
            raw, _ = rd.buffer_view(img["bufferView"])
            model.images.append(_decode_image(bytes(raw)))
        else:
            model.images.append(None)

    # --- samplers (wrap modes: 10497 repeat, 33648 mirror, 33071 clamp) ---
    wrap_map = {10497: 0, 33648: 1, 33071: 2}
    for s in doc.get("samplers", []):
        model.sampler_wraps.append((wrap_map.get(s.get("wrapS", 10497), 0),
                                    wrap_map.get(s.get("wrapT", 10497), 0)))

    # --- materials ---
    for m in doc.get("materials", []):
        model.materials.append(_parse_material(doc, m))

    # --- meshes ---
    for mesh in doc.get("meshes", []):
        prims = []
        for p in mesh.get("primitives", []):
            mode = p.get("mode", 4)
            attrs = p["attributes"]
            pos = rd.accessor(attrs["POSITION"]).astype(np.float32)
            v = pos.shape[0]

            def get(name, comps):
                if name in attrs:
                    a = rd.accessor(attrs[name]).astype(np.float32)
                    return a[:, :comps] if a.shape[1] >= comps else None
                return None

            if "indices" in p:
                idx = rd.accessor(p["indices"]).astype(np.int64).reshape(-1)
            else:
                idx = np.arange(v, dtype=np.int64)
            if mode == 4:
                tris = idx.reshape(-1, 3)
            elif mode == 5:  # TRIANGLE_STRIP
                tris = np.stack([idx[:-2], idx[1:-1], idx[2:]], axis=-1)
                flip = np.arange(tris.shape[0]) % 2 == 1
                tris[flip] = tris[flip][:, [0, 2, 1]]
            elif mode == 6:  # TRIANGLE_FAN
                tris = np.stack([np.zeros(len(idx) - 2, np.int64),
                                 idx[1:-1], idx[2:]], axis=-1)
            else:
                continue  # points/lines not rasterized here

            joints = None
            if "JOINTS_0" in attrs:
                joints = rd.accessor(attrs["JOINTS_0"]).astype(np.int32)
            colors = get("COLOR_0", 4)
            if colors is None and "COLOR_0" in attrs:
                c3 = rd.accessor(attrs["COLOR_0"]).astype(np.float32)
                if c3.shape[1] == 3:
                    colors = np.concatenate([c3, np.ones((v, 1), np.float32)], -1)
            prims.append(GLTFPrimitive(
                positions=pos,
                normals=get("NORMAL", 3),
                uv0=get("TEXCOORD_0", 2),
                uv1=get("TEXCOORD_1", 2),
                tangents=get("TANGENT", 4),
                colors=colors,
                joints=joints,
                weights=get("WEIGHTS_0", 4),
                indices=tris.astype(np.int32),
                material=p.get("material", -1),
            ))
        model.meshes.append(prims)

    # --- lights (KHR_lights_punctual) ---
    for l in (doc.get("extensions", {})
              .get("KHR_lights_punctual", {}).get("lights", [])):
        spot = l.get("spot", {})
        model.lights.append(GLTFLight(
            type=l.get("type", "directional"),
            color=tuple(l.get("color", [1, 1, 1])),
            intensity=l.get("intensity", 1.0),
            range=l.get("range", 0.0),
            inner_cone_angle=spot.get("innerConeAngle", 0.0),
            outer_cone_angle=spot.get("outerConeAngle", 0.7853981634)))

    # --- animations ---
    from diligentfx_tpu_torch.gltf.animation import parse_animations
    model.animations = parse_animations(doc, rd)

    # --- skins ---
    for s in doc.get("skins", []):
        ibm = (rd.accessor(s["inverseBindMatrices"]).reshape(-1, 4, 4)
               if "inverseBindMatrices" in s else None)
        model.skins.append({"joints": s.get("joints", []),
                            "inverse_bind_matrices": ibm,
                            "skeleton": s.get("skeleton", -1)})

    # --- nodes + hierarchy ---
    raw_nodes = doc.get("nodes", [])
    for i, n in enumerate(raw_nodes):
        light = n.get("extensions", {}).get("KHR_lights_punctual", {}).get("light", -1)
        model.nodes.append(GLTFNode(
            name=n.get("name", f"node{i}"), mesh=n.get("mesh", -1),
            skin=n.get("skin", -1), camera=n.get("camera", -1), light=light,
            local=_trs_matrix(n)))
    for i, n in enumerate(raw_nodes):
        for c in n.get("children", []):
            model.nodes[c].parent = i

    # world transforms (row-vector: child_world = child_local @ parent_world)
    def world_of(i, memo):
        if i in memo:
            return memo[i]
        node = model.nodes[i]
        if node.parent < 0:
            w = node.local
        else:
            w = node.local @ world_of(node.parent, memo)
        memo[i] = w
        return w

    memo: Dict[int, np.ndarray] = {}
    for i in range(len(model.nodes)):
        model.nodes[i].world = world_of(i, memo)

    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [])
    if scenes:
        roots = scenes[scene_idx].get("nodes", [])
        # collect the whole subtree
        seen = []
        stack = list(roots)
        while stack:
            i = stack.pop()
            seen.append(i)
            stack.extend(c for c, nd in enumerate(model.nodes) if nd.parent == i)
        model.default_scene_nodes = seen
    else:
        model.default_scene_nodes = list(range(len(model.nodes)))
    return model
