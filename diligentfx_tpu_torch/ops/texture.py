"""Material textures (the port of diligentfx_tpu/ops/texture.py), in the
two binding modes the JAX package has:

  * atlas: all material textures live in one mip-mapped texture array
    (layers, size, size, 4); each logical texture occupies a rectangle of
    a layer described by its (su, sv, bu, bv) scale and bias, as in
    PBRMaterialTextureAttribs (PBR_Structures.fxh:244-255);
  * heap (the dynamic texture-array mode): every texture keeps its native
    size and mip chain in one flat texel buffer with a per-texture mip
    table; a sample is integer arithmetic into that buffer, with exact
    wrap at the texture's own edges.

Sampling is a per-pixel trilinear gather with the mip level chosen from
the raster's analytic UV derivatives; the container's type selects the
mode (`sample_material_texture`).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from diligentfx_tpu_torch.device import resolve_device
from diligentfx_tpu_torch.ops.sampling import WRAP_MIRROR, WRAP_REPEAT

Tensor = torch.Tensor

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
    """The dynamic texture-array mode (JAX texture.py:203): every texture at
    its native size with its box-filtered mip chain, mip-major, in one flat
    texel buffer; a sample gathers `mip_base[tex, level] + y * w + x`."""
    texels: Tensor     # (total, 4) float32
    mip_base: Tensor   # (N, M) int32 flat offset of mip m of texture n;
    #                    levels past a texture's last mip repeat the last
    mip_size: Tensor   # (N, M, 2) int32 (w, h) of each mip (>= 1)
    num_mips: int      # the table width M

    @property
    def max_levels(self) -> int:
        return self.mip_base.shape[1]


def _rgba_f32(img: np.ndarray, max_size: int) -> np.ndarray:
    """An added image as (h, w, 4) float32 (JAX texture.py:50, :236):
    uint8 to [0, 1], gray to RGB to RGBA (alpha 1), and a nearest-neighbour
    downscale when its longer side exceeds `max_size`."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    h, w = img.shape[:2]
    if max(h, w) > max_size:
        s = max_size / max(h, w)
        nh, nw = max(int(h * s), 1), max(int(w * s), 1)
        yi = (np.arange(nh) * (h / nh)).astype(np.int32)
        xi = (np.arange(nw) * (w / nw)).astype(np.int32)
        img = img[yi][:, xi]
    return img.astype(np.float32)


class AtlasBuilder:
    """Host-side packer (JAX texture.py:42): shelf packing of images into
    fixed-size layers with box-filtered mips, in numpy; build() uploads."""

    def __init__(self, size: int = 1024, srgb_slots=()):
        self.size = size
        self.images: List[np.ndarray] = []

    def add(self, img: np.ndarray) -> int:
        """img: (h, w, c) uint8 or float in [0,1]. Returns the texture id."""
        self.images.append(_rgba_f32(img, self.size))
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


class TextureHeapBuilder:
    """Host-side builder of the texture heap (JAX texture.py:226): every
    added image at its native size (up to `max_size`) with a box-filtered
    mip chain, in numpy; build() uploads.  The same `add` contract as
    AtlasBuilder, so a scene build can switch modes."""

    def __init__(self, max_size: int = 4096):
        self.max_size = max_size
        self.images: List[np.ndarray] = []

    def add(self, img: np.ndarray) -> int:
        """img: (h, w, c) uint8 or float in [0,1]. Returns the texture id."""
        self.images.append(_rgba_f32(img, self.max_size))
        return len(self.images) - 1

    def build(self, num_mips: int = 6, device=None) -> TextureHeap:
        """The heap of the added images on `device` (CUDA unless the caller
        asks for the CPU).  A mip halves each side (an odd edge is padded by
        repeating its last row or column) and the chain stops at 1x1;
        table entries past a texture's last mip repeat it."""
        dev = resolve_device(device)
        if not self.images:
            self.add(np.ones((4, 4, 4), np.float32))
        chunks, bases, sizes = [], [], []
        off = 0
        for img in self.images:
            tb, ts = [], []
            cur = img
            for _ in range(num_mips):
                h, w = cur.shape[:2]
                tb.append(off)
                ts.append([w, h])
                chunks.append(cur.reshape(-1, 4))
                off += h * w
                if h < 2 and w < 2:
                    break
                if h % 2 or w % 2:
                    cur = np.pad(cur, ((0, h % 2), (0, w % 2), (0, 0)),
                                 mode="edge")
                cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                              + cur[0::2, 1::2] + cur[1::2, 1::2])
            while len(tb) < num_mips:
                tb.append(tb[-1])
                ts.append(ts[-1])
            bases.append(tb)
            sizes.append(ts)
        return TextureHeap(
            texels=torch.from_numpy(np.concatenate(chunks, axis=0)).to(dev),
            mip_base=torch.tensor(bases, dtype=torch.int32, device=dev),
            mip_size=torch.tensor(sizes, dtype=torch.int32, device=dev),
            num_mips=num_mips)


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


def _wrap_texel(x: Tensor, n: Tensor, mode) -> Tensor:
    """Texel-level edge rule after the uv fold (JAX texture.py:310): REPEAT
    continues across the texture's own edge (-1 -> n - 1, n -> 0); MIRROR's
    continuation after the fold equals a clamp; CLAMP clamps."""
    rep = torch.where(x < 0, x + n, torch.where(x >= n, x - n, x))
    return torch.where(mode == WRAP_REPEAT, rep,
                       torch.minimum(torch.clamp(x, min=0), n - 1))


def sample_heap(heap: TextureHeap, tex_id: Tensor, uv: Tensor, lod: Tensor,
                wrap_u: Optional[Tensor] = None,
                wrap_v: Optional[Tensor] = None) -> Tensor:
    """Trilinear sample from the texture heap (JAX texture.py:288).

    tex_id (...,); uv (..., 2) in texture space; lod (...,), clipped to
    [0, num_mips - 1].  Exactly two levels are gathered, l0 and
    min(l0 + 1, num_mips - 1), four texels each, by flat int64 indices
    into `texels`.  Returns (..., 4)."""
    tex_id = tex_id.long()
    mb = heap.mip_base[tex_id].long()                   # (..., M)
    ms = heap.mip_size[tex_id].long()                   # (..., M, 2)
    n_mips = heap.num_mips
    lod = torch.clamp(lod, 0.0, n_mips - 1.0)
    l0 = torch.floor(lod).long()
    frac = (lod - l0.to(torch.float32))[..., None]
    wu = torch.as_tensor(wrap_u if wrap_u is not None else 0,
                         device=uv.device)
    wv = torch.as_tensor(wrap_v if wrap_v is not None else 0,
                         device=uv.device)
    u = _wrap_uv(uv[..., 0], wu)
    v = _wrap_uv(uv[..., 1], wv)
    flat = heap.texels

    def sample_level(lv: Tensor) -> Tensor:
        base = torch.gather(mb, -1, lv[..., None])[..., 0]
        wh = torch.gather(ms, -2, lv[..., None, None].expand(
            lv.shape + (1, 2)))[..., 0, :]
        w = wh[..., 0]
        h = wh[..., 1]
        fx = u * w.to(torch.float32) - 0.5
        fy = v * h.to(torch.float32) - 0.5
        x0 = torch.floor(fx).long()
        y0 = torch.floor(fy).long()
        tx = (fx - x0.to(torch.float32))[..., None]
        ty = (fy - y0.to(torch.float32))[..., None]
        x0c = _wrap_texel(x0, w, wu)
        x1c = _wrap_texel(x0 + 1, w, wu)
        y0c = _wrap_texel(y0, h, wv)
        y1c = _wrap_texel(y0 + 1, h, wv)
        c00 = flat[base + y0c * w + x0c]
        c10 = flat[base + y0c * w + x1c]
        c01 = flat[base + y1c * w + x0c]
        c11 = flat[base + y1c * w + x1c]
        top = c00 + (c10 - c00) * tx
        bot = c01 + (c11 - c01) * tx
        return top + (bot - top) * ty

    s0 = sample_level(l0)
    s1 = sample_level(torch.clamp(l0 + 1, max=n_mips - 1))
    return s0 + (s1 - s0) * frac


def texture_base_size(tex, tex_id: Tensor):
    """(w, h) f32 of a logical texture at mip 0 (JAX texture.py:344): the
    heap's native size, or the atlas's packed sub-rectangle extent."""
    if isinstance(tex, TextureHeap):
        wh = tex.mip_size[tex_id.long(), 0]
        return wh[..., 0].to(torch.float32), wh[..., 1].to(torch.float32)
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
