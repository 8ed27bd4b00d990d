"""Material textures, atlas binding mode (the port of the atlas half of
diligentfx_tpu/ops/texture.py).

All material textures live in one mip-mapped texture array
(layers, size, size, 4); each logical texture occupies a rectangle of a
layer described by its (su, sv, bu, bv) scale and bias, as in
PBRMaterialTextureAttribs (PBR_Structures.fxh:244-255).  Sampling is a
per-pixel trilinear gather with the mip level chosen from the raster's
analytic UV derivatives.

The dynamic texture-array mode (TextureHeap, sample_heap) comes with a
later slice and raises.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from diligentfx_tpu_torch.device import resolve_device
from diligentfx_tpu_torch.ops.sampling import WRAP_MIRROR, WRAP_REPEAT

Tensor = torch.Tensor

HEAP_LATER = ("the texture heap (dynamic texture-array mode) is not ported "
              "yet: a later slice (slice 9, ROADMAP.md §1 item 4)")


class TextureAtlas(NamedTuple):
    """Device-resident atlas: a tuple of mip arrays (L, S>>m, S>>m, 4)."""
    mips: tuple               # of (L, Sm, Sm, 4) float32
    scale_bias: Tensor        # (N, 4) = (su, sv, bu, bv) per logical texture
    layer: Tensor             # (N,) int32

    @property
    def size(self) -> int:
        return self.mips[0].shape[1]

    @property
    def num_layers(self) -> int:
        return self.mips[0].shape[0]


class TextureHeap(NamedTuple):
    """Placeholder of the dynamic texture-array mode (JAX texture.py:203)."""
    texels: Tensor
    mip_base: Tensor
    mip_size: Tensor
    num_mips: int


class AtlasBuilder:
    """Host-side packer (JAX texture.py:42): shelf packing of images into
    fixed-size layers with box-filtered mips, in numpy; build() uploads."""

    def __init__(self, size: int = 1024, srgb_slots=()):
        self.size = size
        self.images: List[np.ndarray] = []

    def add(self, img: np.ndarray) -> int:
        """img: (h, w, c) uint8 or float in [0,1]. Returns the texture id."""
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        h, w = img.shape[:2]
        if max(h, w) > self.size:
            s = self.size / max(h, w)
            nh, nw = max(int(h * s), 1), max(int(w * s), 1)
            yi = (np.arange(nh) * (h / nh)).astype(np.int32)
            xi = (np.arange(nw) * (w / nw)).astype(np.int32)
            img = img[yi][:, xi]
        self.images.append(img.astype(np.float32))
        return len(self.images) - 1

    def build(self, num_mips: int = 6, device=None) -> TextureAtlas:
        """Pack the added images (numpy) and upload the atlas to `device`
        (CUDA unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        size = self.size
        layers: List[np.ndarray] = []
        scale_bias, layer_ids = [], []
        cur = np.zeros((size, size, 4), np.float32)
        shelf_y = shelf_h = cursor_x = 0
        for img in self.images:
            h, w = img.shape[:2]
            if cursor_x + w > size:
                shelf_y += shelf_h
                cursor_x = 0
                shelf_h = 0
            if shelf_y + h > size:
                layers.append(cur)
                cur = np.zeros((size, size, 4), np.float32)
                shelf_y = shelf_h = cursor_x = 0
            cur[shelf_y:shelf_y + h, cursor_x:cursor_x + w] = img
            scale_bias.append([w / size, h / size, cursor_x / size,
                               shelf_y / size])
            layer_ids.append(len(layers))
            cursor_x += w
            shelf_h = max(shelf_h, h)
        layers.append(cur)

        stack = np.stack(layers)                    # (L, S, S, 4)
        mips = [stack]
        curm = stack
        for _ in range(num_mips - 1):
            if curm.shape[1] < 2:
                break
            curm = 0.25 * (curm[:, 0::2, 0::2] + curm[:, 1::2, 0::2]
                           + curm[:, 0::2, 1::2] + curm[:, 1::2, 1::2])
            mips.append(curm)
        if not scale_bias:
            scale_bias, layer_ids = [[1.0, 1.0, 0.0, 0.0]], [0]
        return TextureAtlas(
            mips=tuple(torch.from_numpy(np.ascontiguousarray(m)).to(dev)
                       for m in mips),
            scale_bias=torch.tensor(scale_bias, dtype=torch.float32,
                                    device=dev),
            layer=torch.tensor(layer_ids, dtype=torch.int32, device=dev))


def white_atlas(device=None) -> TextureAtlas:
    """Default white texture (CreateDefaultTextures analogue)."""
    b = AtlasBuilder(size=8)
    b.add(np.ones((8, 8, 4), np.float32))
    return b.build(num_mips=2, device=device)


def _wrap_uv(u: Tensor, wrap) -> Tensor:
    """Per-pixel wrap mode (PBRMaterialTextureAttribs packed wrap)."""
    rep = u - torch.floor(u)
    mir = torch.abs(u - 2.0 * torch.floor(u * 0.5) - 1.0)
    mir = 1.0 - torch.abs(mir)                  # triangle wave
    clp = torch.clamp(u, 0.0, 1.0)
    wrap = torch.as_tensor(wrap, device=u.device)
    return torch.where(wrap == WRAP_REPEAT, rep,
                       torch.where(wrap == WRAP_MIRROR, mir, clp))


def sample_atlas(atlas: TextureAtlas, tex_id: Tensor, uv: Tensor, lod: Tensor,
                 wrap_u: Optional[Tensor] = None,
                 wrap_v: Optional[Tensor] = None) -> Tensor:
    """Trilinear atlas sample (JAX texture.py:144).

    tex_id (...,) logical texture index; uv (..., 2) in texture space;
    lod (...,).  Returns (..., 4).  Every mip level is sampled and weighted
    (the static sum over the short chain); at most two weights are
    nonzero."""
    tex_id = tex_id.long()
    sb = atlas.scale_bias[tex_id]                       # (..., 4)
    layer = atlas.layer[tex_id].long()                  # (...,)
    u = _wrap_uv(uv[..., 0], wrap_u if wrap_u is not None else 0)
    v = _wrap_uv(uv[..., 1], wrap_v if wrap_v is not None else 0)
    au = u * sb[..., 0] + sb[..., 2]
    av = v * sb[..., 1] + sb[..., 3]

    n_mips = len(atlas.mips)
    lod = torch.clamp(lod, 0.0, n_mips - 1.0)
    l0 = torch.floor(lod).to(torch.int32)
    frac = lod - l0.to(torch.float32)

    def sample_level(level: int) -> Tensor:
        mip = atlas.mips[level]
        s = mip.shape[1]
        fx = au * s - 0.5
        fy = av * s - 0.5
        x0 = torch.floor(fx).long()
        y0 = torch.floor(fy).long()
        tx = (fx - x0.to(torch.float32))[..., None]
        ty = (fy - y0.to(torch.float32))[..., None]
        x0c = torch.clamp(x0, 0, s - 1)
        x1c = torch.clamp(x0 + 1, 0, s - 1)
        y0c = torch.clamp(y0, 0, s - 1)
        y1c = torch.clamp(y0 + 1, 0, s - 1)
        flat = mip.reshape(-1, 4)
        base = layer * (s * s)
        c00 = flat[base + y0c * s + x0c]
        c10 = flat[base + y0c * s + x1c]
        c01 = flat[base + y1c * s + x0c]
        c11 = flat[base + y1c * s + x1c]
        top = c00 + (c10 - c00) * tx
        bot = c01 + (c11 - c01) * tx
        return top + (bot - top) * ty

    zero = torch.zeros((), dtype=torch.float32, device=uv.device)
    out = torch.zeros(uv.shape[:-1] + (4,), dtype=torch.float32,
                      device=uv.device)
    for i in range(n_mips):
        w_i = torch.where(l0 == i, 1.0 - frac,
                          torch.where(l0 == i - 1, frac, zero))
        if i == n_mips - 1:
            w_i = torch.where(l0 >= n_mips - 1, torch.ones_like(w_i), w_i)
        out = out + sample_level(i) * w_i[..., None]
    return out


def sample_heap(heap, tex_id, uv, lod, wrap_u=None, wrap_v=None):
    raise NotImplementedError(HEAP_LATER)


def texture_base_size(tex, tex_id: Tensor):
    """(w, h) f32 of a logical texture at mip 0: the packed sub-rectangle's
    extent (JAX texture.py:344)."""
    if isinstance(tex, TextureHeap):
        raise NotImplementedError(HEAP_LATER)
    res = tex.mips[0].shape[1]
    sb = tex.scale_bias[tex_id.long()]
    return res * sb[..., 0], res * sb[..., 1]


def sample_material_texture(tex, tex_id: Tensor, uv: Tensor, lod: Tensor,
                            wrap_u: Optional[Tensor] = None,
                            wrap_v: Optional[Tensor] = None) -> Tensor:
    """Binding-mode dispatch by container type (JAX texture.py:355)."""
    if isinstance(tex, TextureHeap):
        return sample_heap(tex, tex_id, uv, lod, wrap_u=wrap_u, wrap_v=wrap_v)
    return sample_atlas(tex, tex_id, uv, lod, wrap_u=wrap_u, wrap_v=wrap_v)


def apply_uv_transform(uv: Tensor, scale_rotation: Tensor,
                       bias: Tensor) -> Tensor:
    """KHR_texture_transform: uv @ 2x2 + bias (JAX texture.py:365)."""
    m00 = scale_rotation[..., 0]
    m01 = scale_rotation[..., 1]
    m10 = scale_rotation[..., 2]
    m11 = scale_rotation[..., 3]
    u = uv[..., 0] * m00 + uv[..., 1] * m10 + bias[..., 0]
    v = uv[..., 0] * m01 + uv[..., 1] * m11 + bias[..., 1]
    return torch.stack([u, v], dim=-1)
