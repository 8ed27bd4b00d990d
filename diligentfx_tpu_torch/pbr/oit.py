"""Order-independent transparency and the alpha-mask resolve (the port of
diligentfx_tpu/pbr/oit.py): the K-layer visibility buffer.

Transparent (and alpha-masked) triangles rasterize into a per-pixel list of
the K nearest fragments, depth-ascending: each tile walks its candidates in
binning order and inserts each covered fragment through an unrolled
insertion network with a strict `<` (ties keep the earlier candidate, and
the earlier slot).  A fragment pushed past slot K is the "tail": it is
counted in `overflow` and, given per-triangle alphas and colours, its own
opacity and colour accumulate into `tail_alpha` / `tail_color` (the
OIT.fxh RGBA8 tail average).  The layers are shaded like the opaque path
and composited front to back over the opaque frame.

The JAX package runs the walk as one XLA scan, not a Pallas kernel; the
port runs it as plain PyTorch over (tiles, tile_h, tile_w) tensors, a
Python loop over chunks of candidates, the candidates of a chunk and the
slots.  A fragment's fields (depth, triangle id, the two barycentrics and
the carried alpha and colour) ride one tensor, so each slot's compare and
swap is four tensor operations; every value moves through `torch.where`
alone, so the layers are exact copies of the fragments' plane values.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from diligentfx_tpu_torch import math3d as m3
from diligentfx_tpu_torch.config import RasterizerConfig
from diligentfx_tpu_torch.ops import raster as rz

Tensor = torch.Tensor

# fields of a fragment in the insertion network: depth, triangle id (exact
# in f32 below 2^24; -1 empty), the original triangle's two screen
# barycentrics, then the carried extras (alpha, colour r, g, b)
_Z, _ID, _B0, _B1, _EX = 0, 1, 2, 3, 4


class KLayerBuffer(NamedTuple):
    """Per-pixel K nearest transparent fragments, depth-ascending."""
    depth: Tensor     # (K, H, W)
    tri_id: Tensor    # (K, H, W) int32, -1 empty
    bary: Tensor      # (K, H, W, 2)
    overflow: Tensor  # (H, W) int32: fragments dropped past K (the tail)
    # accumulated opacity of the dropped fragments, 1 - prod(1 - a_i)
    tail_alpha: Optional[Tensor] = None
    # alpha-weighted mean colour of the dropped fragments themselves
    tail_color: Optional[Tensor] = None  # (H, W, 3)


def klayer_walk_columns(counts: Tensor, chunk: int) -> int:
    """How many columns of the compact candidate lists the K-layer walk
    visits: the longest tile's count, rounded up to a multiple of the
    chunk (one host read).  Entries past a tile's count are -1, which the
    insertion network passes over, so walking them changes nothing."""
    n = int(counts.max()) if counts.numel() else 0
    return -(-n // chunk) * chunk


def _klayer_raster_tiles(setup: Tensor, compact: Tensor, width: int,
                         height: int, cfg: RasterizerConfig, num_layers: int,
                         tri_alpha: Optional[Tensor] = None,
                         tri_rgb: Optional[Tensor] = None,
                         screen_offset=(0, 0),
                         n_cols: Optional[int] = None) -> KLayerBuffer:
    """The K-layer insertion walk over the first `n_cols` columns of the
    compact per-tile candidate lists (all of them when None), in chunks of
    cfg.chunk (JAX oit.py:46, which walks the padded small lists and then
    the big list: the same live candidates in the same order).

    setup: (P, 16) rows of ops/raster.py `_triangle_setup` (the coverage
    planes in columns 0-5, depth 6-8, the original triangle's barycentric
    planes 9-14, its id in 15); tri_alpha (P,), tri_rgb (P, 3): per setup
    row."""
    dev = setup.device
    th, tw = cfg.tile_h, cfg.tile_w
    tiles_x = width // tw
    num_tiles = tiles_x * (height // th)
    cols = compact.shape[1] if n_cols is None else n_cols
    chunk = min(cfg.chunk, max(cols, 1))
    n_steps = -(-cols // chunk)
    cand = compact[:, :cols].long()
    pad = n_steps * chunk - cols
    if pad:
        cand = torch.cat([cand, torch.full((num_tiles, pad), -1,
                                           dtype=torch.long, device=dev)], 1)

    # integer viewport offset added before the float convert (the same
    # contract as ops/raster.py)
    tile = torch.arange(num_tiles, device=dev)
    px0 = ((tile % tiles_x) * tw + int(screen_offset[0])).to(torch.float32)
    py0 = ((tile // tiles_x) * th + int(screen_offset[1])).to(torch.float32)
    lx = torch.arange(tw, dtype=torch.float32, device=dev) + 0.5
    ly = torch.arange(th, dtype=torch.float32, device=dev) + 0.5
    px = (px0[:, None, None] + lx[None, None, :]).expand(num_tiles, th, tw)
    py = (py0[:, None, None] + ly[None, :, None]).expand(num_tiles, th, tw)
    px = px[:, None]                                   # (tiles, 1, th, tw)
    py = py[:, None]

    k = num_layers
    extra = None
    if tri_alpha is not None:
        ex_cols = [tri_alpha[:, None]]
        if tri_rgb is not None:
            ex_cols.append(tri_rgb)
        extra = torch.cat(ex_cols, dim=1).to(torch.float32)   # (P, E)
    n_ex = extra.shape[1] if extra is not None else 0
    n_f = _EX + n_ex

    # the K slots, one tensor: (K, fields, tiles, th, tw)
    slots = torch.zeros((k, n_f, num_tiles, th, tw), dtype=torch.float32,
                        device=dev)
    slots[:, _Z] = float("inf")
    slots[:, _ID] = -1.0
    ovf = torch.zeros((num_tiles, th, tw), dtype=torch.int32, device=dev)
    if extra is not None:
        ttrans = torch.ones((num_tiles, th, tw), dtype=torch.float32,
                            device=dev)
        twt = torch.zeros_like(ttrans)
        trgb = torch.zeros((3, num_tiles, th, tw), dtype=torch.float32,
                           device=dev)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    neg1 = torch.full((), -1.0, dtype=torch.float32, device=dev)

    for step in range(n_steps):
        ck = cand[:, step * chunk:(step + 1) * chunk]           # (tiles, C)
        live = (ck >= 0)[..., None, None]
        s = setup[torch.clamp(ck, min=0)]                      # (tiles, C, 16)

        def plane(ai, bi, ci):
            return ((s[..., ai, None, None] * px + s[..., bi, None, None] * py)
                    + s[..., ci, None, None])

        l0 = plane(0, 1, 2)
        l1 = plane(3, 4, 5)
        l2 = (1.0 - l0) - l1
        cover = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & live
        # this chunk's fragments, one tensor: (C, fields, tiles, th, tw)
        frag = torch.empty((chunk, n_f, num_tiles, th, tw),
                           dtype=torch.float32, device=dev)
        frag[:, _Z] = torch.where(cover, plane(6, 7, 8), inf).transpose(0, 1)
        frag[:, _ID] = torch.where(cover, s[..., 15, None, None],
                                   neg1).transpose(0, 1)
        frag[:, _B0] = plane(9, 10, 11).transpose(0, 1)
        frag[:, _B1] = plane(12, 13, 14).transpose(0, 1)
        if extra is not None:
            ex = extra[torch.clamp(ck, min=0)]                  # (tiles, C, E)
            frag[:, _EX:] = ex.permute(1, 2, 0)[..., None, None]
        for c in range(chunk):
            f = frag[c]
            for slot in range(k):
                closer = f[_Z] < slots[slot, _Z]
                kept = torch.where(closer, f, slots[slot])
                f = torch.where(closer, slots[slot], f)
                slots[slot] = kept
            # whatever the candidate holds after K swaps overflowed: count
            # it, and accumulate its opacity and weighted colour
            dropped = torch.isfinite(f[_Z]) & (f[_ID] >= 0)
            ovf += dropped.to(torch.int32)
            if extra is not None:
                w = torch.where(dropped, f[_EX], 0.0)
                ttrans = ttrans * (1.0 - w)
                twt = twt + w
                if n_ex > 1:
                    trgb = trgb + w * f[_EX + 1:_EX + 4]

    def untile(x):
        return rz._untile(x, tiles_x, th, tw)

    tail_alpha = tail_color = None
    if extra is not None:
        tail_alpha = 1.0 - untile(ttrans)
        if n_ex > 1:
            wsum = torch.clamp(untile(twt), min=1e-6)
            tail_color = torch.stack([untile(trgb[i]) for i in range(3)],
                                     dim=-1) / wsum[..., None]
    return KLayerBuffer(
        depth=torch.stack([untile(slots[i, _Z]) for i in range(k)]),
        tri_id=torch.stack([untile(slots[i, _ID]) for i in range(k)]
                           ).to(torch.int32),
        bary=torch.stack([torch.stack([untile(slots[i, _B0]),
                                       untile(slots[i, _B1])], dim=-1)
                          for i in range(k)]),
        overflow=untile(ovf),
        tail_alpha=tail_alpha,
        tail_color=tail_color)


def rasterize_klayers(clip: Tensor, indices: Tensor, *, width: int,
                      height: int, cfg: RasterizerConfig = RasterizerConfig(),
                      num_layers: int = 4, tri_alpha: Optional[Tensor] = None,
                      tri_rgb: Optional[Tensor] = None, screen_size=None,
                      screen_offset=(0, 0)) -> KLayerBuffer:
    """Rasterize (transparent) triangles keeping the K nearest fragments
    per pixel (JAX oit.py:204; transparent geometry is double-sided).

    tri_alpha: optional (T,) per-triangle opacity: fragments dropped past K
    accumulate 1 - prod(1 - a) into tail_alpha.  tri_rgb: optional (T, 3)
    per-triangle colour: their alpha-weighted mean colour goes to
    tail_color; tri_rgb without tri_alpha implies opaque tail fragments.

    Setup and binning are ops/raster.py's; the walk visits each tile's
    compact candidate list up to the longest tile's count
    (`klayer_walk_columns`)."""
    if width % cfg.tile_w or height % cfg.tile_h:
        raise ValueError(f"{width}x{height} not tile-aligned")
    if tri_rgb is not None and tri_alpha is None:
        tri_alpha = torch.ones((indices.shape[0],), dtype=torch.float32,
                               device=clip.device)
    t_in = indices.shape[0]
    both = torch.ones((t_in,), dtype=torch.bool, device=clip.device)
    setup, valid, bbox, orig, _clip_ovf = rz._triangle_setup(
        clip, indices, width, height, both, True, 1e-3,
        screen_size=screen_size, screen_offset=screen_offset)
    compact, counts, *_ = rz._bin_triangles(valid, bbox, width, height, cfg)
    # setup rows past t_in are the near-clip sub-triangles: orig maps each
    # back to the triangle it came from
    orig2 = orig[t_in:]
    ta2 = (torch.cat([tri_alpha, tri_alpha[orig2]])
           if tri_alpha is not None else None)
    tr2 = (torch.cat([tri_rgb, tri_rgb[orig2]], dim=0)
           if tri_rgb is not None else None)
    return _klayer_raster_tiles(setup, compact, width, height, cfg,
                                num_layers, tri_alpha=ta2, tri_rgb=tr2,
                                screen_offset=screen_offset,
                                n_cols=klayer_walk_columns(counts, cfg.chunk))


def resolve_alpha_mask(vb, clip: Tensor, scene, winv: Tensor, *, width: int,
                       height: int, cfg: RasterizerConfig = RasterizerConfig(),
                       atlas=None, use_textures: bool = False,
                       num_layers: int = 2, tally: Optional[dict] = None):
    """ALPHA_MODE_MASK resolve (JAX oit.py:236; the reference's alpha-cutoff
    PSO variants: BaseColor.a < AlphaMaskCutoff -> discard).

    The masked triangles, the tail of scene.indices, rasterize into a
    K-layer buffer; each fragment's alpha (factor x the base-colour
    texture's, at lod 0, when textured) is tested against its material's
    cutoff, and the nearest passing fragment depth-merges into the opaque
    visibility buffer `vb`.  Its tri_id indexes scene.indices (the K-layer
    id plus the opaque count).  `tally`, when given, gains the counts of
    fragments that passed and were discarded ("passed", "discarded": 0-dim
    tensors, no host wait)."""
    from diligentfx_tpu_torch.ops.texture import (apply_uv_transform,
                                                  sample_material_texture)
    mask_idx = scene.mask_indices
    base = scene.num_opaque
    klb = rasterize_klayers(clip, mask_idx, width=width, height=height,
                            cfg=cfg, num_layers=num_layers)
    mats = scene.materials
    alpha_tab = torch.stack([mats.base_color_factor[:, 3],
                             mats.alpha_mask_cutoff], dim=-1)   # (M, 2)
    dev = vb.depth.device
    best_z = torch.full(vb.depth.shape, float("inf"), dtype=torch.float32,
                        device=dev)
    best_id = torch.full(vb.tri_id.shape, -1, dtype=torch.int32, device=dev)
    best_b = torch.zeros(vb.bary.shape, dtype=torch.float32, device=dev)
    for i in range(klb.depth.shape[0]):
        tri_l = klb.tri_id[i]
        valid = tri_l >= 0
        gtid = torch.where(valid, tri_l + base, torch.zeros_like(tri_l))
        mat = scene.tri_material[gtid.long()].long()
        av = alpha_tab[mat]
        alpha = av[..., 0]
        if use_textures and atlas is not None and scene.tex_ids is not None:
            lvb = rz.VisibilityBuffer(
                depth=klb.depth[i],
                tri_id=torch.where(valid, gtid, torch.full_like(gtid, -1)),
                bary=klb.bary[i])
            uv_px = rz.interpolate_all(lvb, scene.indices, scene.uvs, winv)
            s_tid = scene.tex_ids[mat, 0]
            xf = scene.tex_uv_transform[mat, 0]
            wraps = scene.tex_wraps[mat, 0]
            uv_t = apply_uv_transform(uv_px, xf[..., :4], xf[..., 4:6])
            # lod 0: the alpha test wants the crispest cutout
            tex = sample_material_texture(atlas, torch.clamp(s_tid, min=0),
                                          uv_t, torch.zeros_like(alpha),
                                          wrap_u=wraps[..., 0],
                                          wrap_v=wraps[..., 1])
            alpha = alpha * torch.where(s_tid >= 0, tex[..., 3],
                                        torch.ones_like(alpha))
        passed = valid & (alpha >= av[..., 1])
        if tally is not None:
            n_pass = passed.sum()
            tally["passed"] = tally.get("passed", 0) + n_pass
            tally["discarded"] = (tally.get("discarded", 0) + valid.sum()
                                  - n_pass)
        # layers are depth-ascending, so the first pass wins
        take = passed & (best_id < 0)
        best_z = torch.where(take, klb.depth[i], best_z)
        best_id = torch.where(take, gtid, best_id)
        best_b = torch.where(take[..., None], klb.bary[i], best_b)
    win = (best_id >= 0) & (best_z < vb.depth)
    return rz.VisibilityBuffer(
        depth=torch.where(win, best_z, vb.depth),
        tri_id=torch.where(win, best_id, vb.tri_id),
        bary=torch.where(win[..., None], best_b, vb.bary))


def shade_klayers(scene, info, ibl_maps, layers: KLayerBuffer,
                  world_pos: Tensor, world_nrm: Tensor, winv: Tensor,
                  use_ibl: bool = True) -> Tuple[Tensor, Tensor, Tensor]:
    """Shade each transparent layer like the opaque path (factors-only
    materials; JAX oit.py:310) -> (colours (K, H, W, 3), alphas (K, H, W,
    1), unshaded base colours (K, H, W, 3)).  `scene` carries the blend
    geometry as its indices and tri_material."""
    from diligentfx_tpu_torch.pbr import shading as sh
    packed = torch.cat([world_pos, world_nrm], dim=-1)
    mats = scene.materials
    colors, alphas, albedos = [], [], []
    for i in range(layers.depth.shape[0]):
        tri_l = layers.tri_id[i]
        vb = rz.VisibilityBuffer(depth=layers.depth[i], tri_id=tri_l,
                                 bary=layers.bary[i])
        interp = rz.interpolate_all(vb, scene.indices, packed, winv)
        pos_px = interp[..., 0:3]
        nrm_px = m3.normalize(interp[..., 3:6])
        mat_id = scene.tri_material[torch.clamp(tri_l, min=0).long()].long()
        base_rgba = mats.base_color_factor[mat_id]
        metallic = mats.metallic_factor[mat_id][..., None]
        roughness = mats.roughness_factor[mat_id][..., None]
        view = m3.normalize(info.camera.position - pos_px)
        srf = sh.get_surface_reflectance_mr(base_rgba[..., :3], metallic,
                                            roughness)
        ndotv = torch.clamp(m3.dot(nrm_px, view), 0.0, 1.0)
        shading = sh.SurfaceShadingInfo(
            pos=pos_px, view=view, occlusion=torch.ones_like(metallic),
            emissive=mats.emissive_factor[mat_id],
            base=sh.BaseLayerShadingInfo(srf=srf, metallic=metallic,
                                         normal=nrm_px, ndotv=ndotv),
            ibl_scale=info.renderer_params.ibl_scale[:3])
        lighting = sh.default_lighting(pos_px)
        lighting = sh.apply_punctual_lights(shading, info.lights, lighting)
        if use_ibl and ibl_maps is not None:
            lighting = sh.apply_ibl(shading, ibl_maps, lighting)
        color = sh.resolve_lighting(shading, lighting)
        hit3 = (tri_l >= 0)[..., None]
        zero = torch.zeros((), dtype=torch.float32, device=color.device)
        colors.append(torch.where(hit3, color, zero))
        alphas.append(torch.where(hit3, base_rgba[..., 3:4], zero))
        albedos.append(torch.where(hit3, base_rgba[..., :3], zero))
    return torch.stack(colors), torch.stack(alphas), torch.stack(albedos)


_LUMA = (0.2126, 0.7152, 0.0722)


def composite_klayers(opaque_color: Tensor, opaque_depth: Tensor,
                      layers: KLayerBuffer, layer_colors: Tensor,
                      layer_alphas: Tensor,
                      layer_albedos: Optional[Tensor] = None) -> Tensor:
    """Front-to-back composite of the shaded transparent layers over the
    opaque frame (JAX oit.py:351; the ApplyOITAttenuation analogue).
    Layers behind the opaque depth are rejected.  The tail attenuates
    what is behind it and adds its colour: the dropped fragments' unshaded
    colour scaled by the kept layers' shaded-to-albedo luminance ratio when
    `layer_albedos` is given, else the kept layers' mean colour."""
    k = layers.depth.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=opaque_color.device)
    out = torch.zeros_like(opaque_color)
    transmittance = torch.ones_like(layer_alphas[0])
    csum = torch.zeros_like(opaque_color)
    asum = torch.zeros_like(layer_alphas[0])
    albsum = torch.zeros_like(opaque_color)
    for i in range(k):
        valid = ((layers.tri_id[i] >= 0)
                 & (layers.depth[i] <= opaque_depth))[..., None]
        a = torch.where(valid, layer_alphas[i], zero)
        out = out + transmittance * a * layer_colors[i]
        transmittance = transmittance * (1.0 - a)
        csum = csum + a * layer_colors[i]
        asum = asum + a
        if layer_albedos is not None:
            albsum = albsum + a * layer_albedos[i]
    if layers.tail_alpha is not None:
        ta = layers.tail_alpha[..., None]
        if layers.tail_color is not None:
            tail_color = layers.tail_color
            if layer_albedos is not None:
                lum = torch.tensor(_LUMA, dtype=torch.float32,
                                   device=opaque_color.device)
                shade_l = torch.sum(csum * lum, dim=-1, keepdim=True)
                alb_l = torch.sum(albsum * lum, dim=-1, keepdim=True)
                ratio = shade_l / torch.clamp(alb_l, min=1e-6)
                tail_color = tail_color * torch.where(
                    asum > 1e-6, ratio, torch.ones_like(ratio))
        else:
            tail_color = csum / torch.clamp(asum, min=1e-6)
            ta = torch.where(asum > 1e-6, ta, zero)
        out = out + transmittance * ta * tail_color
        transmittance = transmittance * (1.0 - ta)
    return out + transmittance * opaque_color
