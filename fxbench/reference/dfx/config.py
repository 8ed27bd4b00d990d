"""Static configuration (the port's own copy of diligentfx_tpu/config.py,
limited to what the ported slices use).

Frozen dataclasses and IntEnums select code paths; dynamic per-frame values
travel as tensors (attribs.py).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class PSOFlags(enum.IntFlag):
    """The per-draw feature flags that PBRRenderer.render reads, at their
    PBR_Renderer.hpp:538-616 bit positions.  The texture and vertex flags
    of the JAX package's copy select nothing there and are left out."""
    NONE = 0
    USE_IBL = 1 << 29
    USE_LIGHTS = 1 << 30
    ENABLE_TONE_MAPPING = 1 << 35


class DebugViewType(enum.IntEnum):
    """PBR_Renderer.hpp:401-439 debug AOVs (only NONE is rendered so far)."""
    NONE = 0
    TEXCOORD0 = 1
    TEXCOORD1 = 2
    BASE_COLOR = 3
    TRANSPARENCY = 4
    OCCLUSION = 5
    EMISSIVE = 6
    METALLIC = 7
    ROUGHNESS = 8
    DIFFUSE_COLOR = 9
    SPECULAR_COLOR = 10
    REFLECTANCE90 = 11
    MESH_NORMAL = 12
    SHADING_NORMAL = 13
    MOTION_VECTORS = 14
    NDOTV = 15
    PUNCTUAL_LIGHTING = 16
    DIFFUSE_IBL = 17
    SPECULAR_IBL = 18
    WHITE_BASE_COLOR = 19
    CLEAR_COAT = 20
    CLEAR_COAT_FACTOR = 21
    CLEAR_COAT_ROUGHNESS = 22
    CLEAR_COAT_NORMAL = 23
    SHEEN = 24
    SHEEN_COLOR = 25
    SHEEN_ROUGHNESS = 26
    ANISOTROPY_STRENGTH = 27
    ANISOTROPY_DIRECTION = 28
    IRIDESCENCE = 29
    IRIDESCENCE_FACTOR = 30
    IRIDESCENCE_THICKNESS = 31
    TRANSMISSION = 32
    THICKNESS = 33
    SCENE_DEPTH = 34


class ToneMappingMode(enum.IntEnum):
    """ToneMappingStructures.fxh:11-22."""
    NONE = 0
    EXP = 1
    REINHARD = 2
    REINHARD_MOD = 3
    UNCHARTED2 = 4
    FILMIC_ALU = 5
    LOGARITHMIC = 6
    ADAPTIVE_LOG = 7
    AGX = 8
    AGX_CUSTOM = 9
    PBR_NEUTRAL = 10
    COMMERCE = 11


MAX_CASCADES = 8  # BasicStructures.fxh:27


class ShadowMode(enum.IntEnum):
    """BasicStructures.fxh:19-27."""
    PCF = 1
    VSM = 2
    EVSM2 = 3
    EVSM4 = 4


@dataclass(frozen=True)
class PBRRendererCreateInfo:
    """PBR_Renderer::CreateInfo (PBR_Renderer.hpp:143-375), the fields the
    port reads plus the rest of the reference's switches."""
    enable_ibl: bool = True
    enable_ao: bool = True
    enable_emissive: bool = True
    enable_clear_coat: bool = False
    enable_sheen: bool = False
    enable_anisotropy: bool = False
    enable_iridescence: bool = False
    enable_transmission: bool = False
    enable_volume: bool = False
    enable_shadows: bool = False
    pcf_kernel_size: int = 3
    max_light_count: int = 16
    num_brdf_samples: int = 512
    brdf_lut_dim: int = 512
    irradiance_cube_dim: int = 64
    prefiltered_env_map_dim: int = 256
    num_specular_env_samples: int = 256
    reversed_z: bool = False

    def __post_init__(self):
        if self.pcf_kernel_size not in (2, 3, 5, 7):
            raise ValueError(
                f"PCFKernelSize must be 2/3/5/7, got {self.pcf_kernel_size}")


@dataclass(frozen=True)
class RasterizerConfig:
    """Tile rasterizer configuration (same fields and meaning as the JAX
    package's RasterizerConfig, without its profiling knobs).

    Tiles are tile_h x tile_w pixels.  Small triangles bin through a bounded
    expansion (max_tiles_per_tri) + stable sort; bigger ones go to a big
    list.  sub_bins > 1 bins small triangles per (tile_h / sub_bins) row
    band and big_tile_capacity > 0 bins big triangles by exact per-tile bbox
    overlap (the segmented candidate layout of the fused kernel)."""
    tile_h: int = 32
    tile_w: int = 128
    bin_capacity: int = 256
    max_tiles_per_tri: int = 16
    big_tri_capacity: int = 64
    chunk: int = 64
    pair_compaction_cap: int = 0
    sub_bins: int = 1
    big_tile_capacity: int = 0

    def __post_init__(self):
        if self.tile_w % 128 != 0:
            raise ValueError("tile_w must be a multiple of 128")
        if self.tile_h % 8 != 0:
            raise ValueError("tile_h must be a multiple of 8")
        if self.sub_bins > 1:
            if self.tile_h % self.sub_bins or (self.tile_h // self.sub_bins) % 8:
                raise ValueError("tile_h / sub_bins must be a multiple of 8")
            if self.bin_capacity % self.sub_bins:
                raise ValueError("bin_capacity must divide into sub_bins")

