"""USD material-network parsing (a copy of the JAX package's
hydrogent/material_network.py, which is numpy only) — the analogue of
Hydrogent's
HnMaterialNetwork (interface/HnMaterialNetwork.hpp:46-192): a genuine
node-graph parse of UsdPreviewSurface + UsdUVTexture + UsdPrimvarReader +
UsdTransform2d into a parameter list, texture descriptors (with sampler
state: wrap modes, UV transform, primvar name, swizzle, scale/bias) and a
material tag (default / masked / translucent / additive).

Network input shape (the HdMaterialNetworkMap analogue as plain Python —
the pxr adapter in usd_adapter.py converts real Hydra networks to this):

    {
      "nodes": {
        "/mat/surf": {"type": "UsdPreviewSurface",
                       "params": {"diffuseColor": (r, g, b), ...}},
        "/mat/tex":  {"type": "UsdUVTexture",
                       "params": {"file": ndarray-or-loader,
                                  "wrapS": "repeat", "wrapT": "clamp",
                                  "scale": (4,), "bias": (4,),
                                  "fallback": (4,)}},
        "/mat/st":   {"type": "UsdPrimvarReader_float2",
                       "params": {"varname": "st"}},
        "/mat/xf":   {"type": "UsdTransform2d",
                       "params": {"scale": (2,), "rotation": deg,
                                  "translation": (2,)}},
      },
      # (dst_node, dst_input) ← (src_node, src_output)
      "connections": [("/mat/surf", "diffuseColor", "/mat/tex", "rgb"),
                       ("/mat/tex", "st", "/mat/xf", "result"),
                       ("/mat/xf", "in", "/mat/st", "result")],
      "terminal": "/mat/surf",
    }

The legacy flat form {"surface": {...}, "textures": {param: payload}} is
still accepted (it becomes fallback params + default-sampler textures).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from diligentfx_tpu_torch.ops.sampling import (WRAP_CLAMP, WRAP_MIRROR,
                                               WRAP_REPEAT)

Payload = Union[np.ndarray, Callable[[], np.ndarray]]

# UsdUVTexture wrap tokens → sampler codes (ops/texture._wrap_uv).
# 'black' has no sampler equivalent in the atlas (borders would bleed
# between atlas entries) — it clamps, like the reference's fallback for
# unsupported address modes.
_WRAP_TOKENS = {"repeat": WRAP_REPEAT, "mirror": WRAP_MIRROR,
                "clamp": WRAP_CLAMP, "black": WRAP_CLAMP,
                "useMetadata": WRAP_REPEAT}

# UsdPreviewSurface texture-connectable inputs → PBR texture slots
# (PBR_Textures.fxh ordering: 0 base color, 1 normal, 2 physical
# descriptor (G=roughness, B=metallic), 3 emissive, 4 occlusion)
_SLOT_OF_INPUT = {"diffuseColor": 0, "baseColor": 0,
                  "normal": 1,
                  "metallic": 2, "roughness": 2, "metallicRoughness": 2,
                  "emissiveColor": 3,
                  "occlusion": 4}

# default channel a UsdPreviewSurface input reads from its texture
_DEFAULT_SWIZZLE = {"diffuseColor": "rgb", "baseColor": "rgb",
                    "normal": "rgb", "emissiveColor": "rgb",
                    "metallic": "b", "roughness": "g",
                    "metallicRoughness": "gb", "occlusion": "r",
                    "opacity": "a"}


class ParamType:
    """HnMaterialParameter::ParamType (HnMaterialNetwork.hpp:46-76)."""
    UNKNOWN = 0
    FALLBACK = 1
    TEXTURE = 2
    PRIMVAR_REDIRECT = 3
    ADDITIONAL_PRIMVAR = 4
    TRANSFORM2D = 5


class Transform2d:
    """UsdTransform2d: out = rotate(scale * in, rotation°CCW) + translation."""
    __slots__ = ("scale", "rotation", "translation")

    def __init__(self, scale=(1.0, 1.0), rotation=0.0, translation=(0.0, 0.0)):
        self.scale = (float(scale[0]), float(scale[1]))
        self.rotation = float(rotation)
        self.translation = (float(translation[0]), float(translation[1]))

    def as_scale_rot_bias(self) -> Tuple[float, ...]:
        """6 floats (m00, m01, m10, m11, bu, bv) for the row-vector
        `uv @ M + bias` of ops/texture.apply_uv_transform — matching
        PBRMaterialTextureAttribs.UVScaleAndRotation + UBias/VBias
        (PBR_Structures.fxh:249-251)."""
        th = math.radians(self.rotation)
        c, s = math.cos(th), math.sin(th)
        su, sv = self.scale
        return (c * su, s * su, -s * sv, c * sv,
                self.translation[0], self.translation[1])


class HnMaterialParameter:
    """One parsed parameter (HnMaterialParameter, hpp:43-144)."""
    __slots__ = ("type", "name", "fallback_value", "sampler_coords",
                 "swizzle", "input_scale", "input_bias", "transform2d")

    def __init__(self, type: int, name: str, fallback_value=None,
                 sampler_coords: Tuple[str, ...] = (),
                 swizzle: str = "", input_scale=(1, 1, 1, 1),
                 input_bias=(0, 0, 0, 0),
                 transform2d: Optional[Transform2d] = None):
        self.type = type
        self.name = name
        self.fallback_value = fallback_value
        self.sampler_coords = tuple(sampler_coords)
        self.swizzle = swizzle
        self.input_scale = tuple(float(x) for x in input_scale)
        self.input_bias = tuple(float(x) for x in input_bias)
        self.transform2d = transform2d

    def is_texture(self):
        return self.type == ParamType.TEXTURE


class TextureDescriptor:
    """HnMaterialNetwork::TextureDescriptor analogue: everything the texture
    registry + sampler need for one texture binding."""
    __slots__ = ("name", "payload", "wrap_u", "wrap_v", "uv_transform",
                 "primvar", "fallback", "swizzle", "input_scale", "input_bias")

    def __init__(self, name: str, payload: Optional[Payload],
                 wrap_u: int = WRAP_REPEAT, wrap_v: int = WRAP_REPEAT,
                 uv_transform: Tuple[float, ...] = (1, 0, 0, 1, 0, 0),
                 primvar: str = "st", fallback=(1.0, 1.0, 1.0, 1.0),
                 swizzle: str = "", input_scale=(1, 1, 1, 1),
                 input_bias=(0, 0, 0, 0)):
        self.name = name
        self.payload = payload
        self.wrap_u = int(wrap_u)
        self.wrap_v = int(wrap_v)
        self.uv_transform = tuple(float(x) for x in uv_transform)
        self.primvar = primvar
        self.fallback = tuple(fallback)
        self.swizzle = swizzle
        self.input_scale = tuple(float(x) for x in input_scale)
        self.input_bias = tuple(float(x) for x in input_bias)


def _surface_defaults() -> Dict[str, object]:
    """UsdPreviewSurface input fallbacks (the spec defaults the reference's
    LoadParams inherits from the Sdr registry)."""
    return {"diffuseColor": (0.18, 0.18, 0.18), "emissiveColor": (0, 0, 0),
            "metallic": 0.0, "roughness": 0.5, "opacity": 1.0,
            "opacityThreshold": 0.0, "ior": 1.5, "clearcoat": 0.0,
            "clearcoatRoughness": 0.01, "occlusion": 1.0,
            "normalScale": 1.0, "useSpecularWorkflow": 0,
            "specularColor": (0.0, 0.0, 0.0)}


class HnMaterialNetwork:
    """Node-graph material parse (HnMaterialNetwork.cpp LoadParams /
    GetMaterialTag semantics).  Also accepts the legacy flat dict."""

    def __init__(self, network: Optional[dict] = None):
        net = network or {}
        self.parameters: List[HnMaterialParameter] = []
        self.textures: Dict[str, TextureDescriptor] = {}   # by input name
        self._slot_tex: Dict[int, TextureDescriptor] = {}  # by PBR slot
        self._values = _surface_defaults()
        self._opacity_textured = False

        if "nodes" in net:
            self._parse_graph(net)
        else:
            self._parse_flat(net)

        # typed surface attributes (consumed by commit_resources)
        v = self._values
        self.diffuse_color = tuple(v["diffuseColor"])
        self.metallic = float(v["metallic"])
        self.roughness = float(v["roughness"])
        self.emissive_color = tuple(v["emissiveColor"])
        self.opacity = float(v["opacity"])
        self.opacity_threshold = float(v["opacityThreshold"])
        self.ior = float(v["ior"])
        self.clearcoat = float(v["clearcoat"])
        self.clearcoat_roughness = float(v["clearcoatRoughness"])
        self.normal_scale = float(v.get("normalScale", 1.0))

    # -- legacy flat form ------------------------------------------------------

    def _parse_flat(self, net: dict) -> None:
        surface = net.get("surface", {})
        for k, val in surface.items():
            self._values[k] = val
            self.parameters.append(
                HnMaterialParameter(ParamType.FALLBACK, k, val))
        for param, payload in (net.get("textures") or {}).items():
            slot = _SLOT_OF_INPUT.get(param)
            if payload is None:
                continue
            desc = TextureDescriptor(param, payload,
                                     swizzle=_DEFAULT_SWIZZLE.get(param, ""))
            self.textures[param] = desc
            if slot is not None and slot not in self._slot_tex:
                self._slot_tex[slot] = desc
            self.parameters.append(HnMaterialParameter(
                ParamType.TEXTURE, param, sampler_coords=("st",)))

    # -- node-graph form -------------------------------------------------------

    def _parse_graph(self, net: dict) -> None:
        nodes: Dict[str, dict] = net["nodes"]
        # (dst, dst_input) -> (src, src_output)
        conn: Dict[Tuple[str, str], Tuple[str, str]] = {}
        for dst, dst_in, src, src_out in net.get("connections", ()):
            conn[(dst, dst_in)] = (src, src_out)

        term = net.get("terminal")
        if term is None:  # find the UsdPreviewSurface node
            term = next((p for p, n in nodes.items()
                         if n.get("type") == "UsdPreviewSurface"), None)
        if term is None or term not in nodes:
            return
        surf = nodes[term]
        for k, val in surf.get("params", {}).items():
            self._values[k] = val

        def resolve_st(tex_path: str) -> Tuple[str, Optional[Transform2d]]:
            """Follow the texture's `st` input through an optional
            UsdTransform2d chain to the primvar reader (LoadParams'
            transform2d + primvar-redirect walk)."""
            primvar, xf = "st", None
            nxt = conn.get((tex_path, "st"))
            while nxt is not None:
                node = nodes.get(nxt[0], {})
                ntype = node.get("type", "")
                params = node.get("params", {})
                if ntype == "UsdTransform2d":
                    x = Transform2d(params.get("scale", (1, 1)),
                                    params.get("rotation", 0.0),
                                    params.get("translation", (0, 0)))
                    # chained transforms compose: the walk visits outermost
                    # first (closest to the texture), so the accumulated xf
                    # wraps the newly found one: uv_final = xf(x(uv))
                    xf = x if xf is None else _compose(xf, x)
                    nxt = conn.get((nxt[0], "in"))
                elif ntype.startswith("UsdPrimvarReader"):
                    primvar = str(params.get("varname", "st"))
                    nxt = None
                else:
                    nxt = None
            return primvar, xf

        for inp in ("diffuseColor", "normal", "metallic", "roughness",
                    "emissiveColor", "occlusion", "opacity", "clearcoat",
                    "clearcoatRoughness", "ior", "specularColor"):
            src = conn.get((term, inp))
            if src is None:
                val = surf.get("params", {}).get(inp)
                if val is not None:
                    self.parameters.append(HnMaterialParameter(
                        ParamType.FALLBACK, inp, val))
                continue
            src_path, src_out = src
            node = nodes.get(src_path, {})
            ntype = node.get("type", "")
            params = node.get("params", {})
            if ntype == "UsdUVTexture":
                primvar, xf = resolve_st(src_path)
                wrap_u = _WRAP_TOKENS.get(str(params.get("wrapS", "useMetadata")),
                                          WRAP_REPEAT)
                wrap_v = _WRAP_TOKENS.get(str(params.get("wrapT", "useMetadata")),
                                          WRAP_REPEAT)
                uvxf = (xf.as_scale_rot_bias() if xf is not None
                        else (1, 0, 0, 1, 0, 0))
                desc = TextureDescriptor(
                    inp, params.get("file"),
                    wrap_u=wrap_u, wrap_v=wrap_v, uv_transform=uvxf,
                    primvar=primvar,
                    fallback=tuple(params.get("fallback", (1, 1, 1, 1))),
                    swizzle=src_out or _DEFAULT_SWIZZLE.get(inp, ""),
                    input_scale=tuple(params.get("scale", (1, 1, 1, 1))),
                    input_bias=tuple(params.get("bias", (0, 0, 0, 0))))
                self.textures[inp] = desc
                slot = _SLOT_OF_INPUT.get(inp)
                if slot is not None and slot not in self._slot_tex:
                    self._slot_tex[slot] = desc
                if inp == "opacity":
                    self._opacity_textured = True
                self.parameters.append(HnMaterialParameter(
                    ParamType.TEXTURE, inp, sampler_coords=(primvar,),
                    swizzle=desc.swizzle, transform2d=xf,
                    input_scale=desc.input_scale, input_bias=desc.input_bias))
            elif ntype.startswith("UsdPrimvarReader"):
                self.parameters.append(HnMaterialParameter(
                    ParamType.PRIMVAR_REDIRECT, inp,
                    fallback_value=params.get("fallback"),
                    sampler_coords=(str(params.get("varname", inp)),)))

    # -- products ---------------------------------------------------------------

    def texture_for_slot(self, slot: int) -> Optional[TextureDescriptor]:
        """PBR texture slot → descriptor (None if unbound).  Physical
        descriptor payloads (slot 2) are channel-normalized by
        `normalized_payload` so the device layout is always G=roughness,
        B=metallic regardless of the authored swizzle."""
        return self._slot_tex.get(slot)

    @property
    def tag(self) -> str:
        """Material tag (HnMaterialNetwork::GetTag semantics): masked when an
        opacity threshold is authored; translucent when opacity < 1 or
        opacity is texture-connected."""
        if self.opacity_threshold > 0.0:
            return "masked"
        if self.opacity < 1.0 or self._opacity_textured:
            return "translucent"
        return "default"

    # legacy API compatibility: iterate texture payloads by input name
    @property
    def texture_payloads(self) -> Dict[str, Payload]:
        return {k: d.payload for k, d in self.textures.items()
                if d.payload is not None}


class _ComposedTransform2d(Transform2d):
    """Exact affine composition of chained UsdTransform2d nodes.  A product
    of scale-rotations with non-uniform scale is NOT itself a scale-rotation
    (S·R·S'·R' ≠ (SS')(R+R')), so the composite carries its full 6-float
    row-vector matrix instead of scale/rotation/translation fields."""
    __slots__ = ("_matrix",)

    def __init__(self, matrix: Tuple[float, ...]):
        super().__init__()
        self._matrix = tuple(float(x) for x in matrix)

    def as_scale_rot_bias(self) -> Tuple[float, ...]:
        return self._matrix


def _compose(outer: Transform2d, inner: Transform2d) -> Transform2d:
    """outer(inner(uv)): with row-vector transforms T(uv) = uv @ M + t, the
    composite is uv @ (Mi @ Mo) + (ti @ Mo + to)."""
    i00, i01, i10, i11, ibu, ibv = inner.as_scale_rot_bias()
    o00, o01, o10, o11, obu, obv = outer.as_scale_rot_bias()
    return _ComposedTransform2d((
        i00 * o00 + i01 * o10, i00 * o01 + i01 * o11,
        i10 * o00 + i11 * o10, i10 * o01 + i11 * o11,
        ibu * o00 + ibv * o10 + obu, ibu * o01 + ibv * o11 + obv))


def normalized_payload(desc: TextureDescriptor, slot: int
                       ) -> Optional[Payload]:
    """Remap a texture payload's channels so the device atlas always holds
    the PBR slot layout (slot 2: G=roughness, B=metallic; slot 4: R=AO),
    honoring the authored swizzle.  Host-side, once per texture — the
    sampling kernels stay swizzle-free."""
    if desc.payload is None:
        return None
    sw = desc.swizzle

    def remap(img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        ch = {"r": 0, "g": 1, "b": 2, "a": 3}
        if slot == 2 and sw in ("r", "b", "a"):
            # single-channel roughness/metallic authored in a non-G channel:
            # rebuild (x, rough, metal, 1)
            c = img[..., min(ch[sw], img.shape[-1] - 1)]
            out = np.stack([np.zeros_like(c), c, c,
                            np.ones_like(c)], axis=-1)
            return out
        if slot == 4 and sw in ("g", "b", "a") and img.shape[-1] > ch[sw]:
            c = img[..., ch[sw]]
            return np.stack([c, c, c, np.ones_like(c)], axis=-1)
        return img

    p = desc.payload
    if callable(p):
        return lambda: remap(p())
    return remap(p)
