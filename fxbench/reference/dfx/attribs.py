"""Per-frame / per-material / per-light attributes (the port of
diligentfx_tpu/attribs.py).

The JAX package registers these as pytrees; here they are NamedTuples of
tensors.  Field names follow the reference's constant-buffer structs
(PBR_Structures.fxh, BasicStructures.fxh) in snake_case.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from fxbench.reference.dfx import math3d as m3

Tensor = torch.Tensor


def _vec(x, n, device=None) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32,
                           device=device).reshape(-1).expand(n).clone()


def _f32(x, device=None) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class LightType:
    """PBRLightAttribs.Type (PBR_Structures.fxh:318)."""
    DIRECTIONAL = 1
    POINT = 2
    SPOT = 3


class CameraAttribs(NamedTuple):
    """CameraAttribs (BasicStructures.fxh:56-100)."""
    view: Tensor           # 4x4 world -> view (row-vector)
    proj: Tensor           # 4x4 view -> clip
    view_proj: Tensor      # 4x4 world -> clip
    view_proj_inv: Tensor
    position: Tensor       # (3,)
    near_z: Tensor         # ()
    far_z: Tensor          # ()
    viewport_size: Tensor  # (4,) = (w, h, 1/w, 1/h)
    f2_jitter: Tensor      # (2,) TAA jitter in NDC units

    @classmethod
    def create(cls, view, proj, position, near_z, far_z, width, height,
               jitter=(0.0, 0.0), device=None):
        view = _f32(view, device)
        dev = view.device
        proj = _f32(proj, dev)
        vp = m3.mul44(view, proj)
        return cls(
            view=view, proj=proj, view_proj=vp,
            view_proj_inv=m3.inverse(vp),
            position=_f32(position, dev),
            near_z=_f32(near_z, dev),
            far_z=_f32(far_z, dev),
            viewport_size=_f32([width, height, 1.0 / width, 1.0 / height],
                               dev),
            f2_jitter=_f32(jitter, dev),
        )


class PBRMaterialBasicAttribs(NamedTuple):
    """PBRMaterialBasicAttribs (PBR_Structures.fxh:154-180).  Leaves carry a
    leading material dimension once stacked (stack_materials)."""
    base_color_factor: Tensor        # (4,)
    emissive_factor: Tensor          # (3,)
    normal_scale: Tensor             # ()
    specular_factor: Tensor          # (3,)
    clearcoat_normal_scale: Tensor   # ()
    workflow: Tensor                 # () int32
    alpha_mode: Tensor               # () int32
    alpha_mask_cutoff: Tensor        # ()
    metallic_factor: Tensor          # ()
    roughness_factor: Tensor         # ()
    occlusion_factor: Tensor         # ()
    clearcoat_factor: Tensor         # ()
    clearcoat_roughness_factor: Tensor  # ()
    custom_data: Tensor              # (4,)

    @classmethod
    def create(cls, base_color_factor=(1, 1, 1, 1), emissive_factor=(0, 0, 0),
               normal_scale=1.0, specular_factor=(1, 1, 1),
               clearcoat_normal_scale=1.0, workflow=0, alpha_mode=0,
               alpha_mask_cutoff=0.5, metallic_factor=1.0,
               roughness_factor=1.0, occlusion_factor=1.0,
               clearcoat_factor=0.0, clearcoat_roughness_factor=0.0,
               custom_data=(0, 0, 0, 0)):
        return cls(
            base_color_factor=_vec(base_color_factor, 4),
            emissive_factor=_vec(emissive_factor, 3),
            normal_scale=_f32(normal_scale),
            specular_factor=_vec(specular_factor, 3),
            clearcoat_normal_scale=_f32(clearcoat_normal_scale),
            workflow=torch.as_tensor(workflow, dtype=torch.int32),
            alpha_mode=torch.as_tensor(alpha_mode, dtype=torch.int32),
            alpha_mask_cutoff=_f32(alpha_mask_cutoff),
            metallic_factor=_f32(metallic_factor),
            roughness_factor=_f32(roughness_factor),
            occlusion_factor=_f32(occlusion_factor),
            clearcoat_factor=_f32(clearcoat_factor),
            clearcoat_roughness_factor=_f32(clearcoat_roughness_factor),
            custom_data=_vec(custom_data, 4),
        )


class PBRMaterialSheenAttribs(NamedTuple):
    """PBR_Structures.fxh:185-191 (KHR_materials_sheen)."""
    color_factor: Tensor      # (3,)
    roughness_factor: Tensor  # ()

    @classmethod
    def create(cls, color_factor=(0, 0, 0), roughness_factor=0.0):
        return cls(_vec(color_factor, 3), _f32(roughness_factor))


class PBRMaterialAnisotropyAttribs(NamedTuple):
    """PBR_Structures.fxh:196-202 (KHR_materials_anisotropy)."""
    strength: Tensor  # ()
    rotation: Tensor  # () radians

    @classmethod
    def create(cls, strength=0.0, rotation=0.0):
        return cls(_f32(strength), _f32(rotation))


class PBRMaterialIridescenceAttribs(NamedTuple):
    """PBR_Structures.fxh:207-213 (KHR_materials_iridescence)."""
    factor: Tensor             # ()
    ior: Tensor                # ()
    thickness_minimum: Tensor  # () nm
    thickness_maximum: Tensor  # () nm

    @classmethod
    def create(cls, factor=0.0, ior=1.3, thickness_minimum=100.0,
               thickness_maximum=400.0):
        return cls(_f32(factor), _f32(ior), _f32(thickness_minimum),
                   _f32(thickness_maximum))


class PBRMaterialTransmissionAttribs(NamedTuple):
    """PBR_Structures.fxh:218-224 (KHR_materials_transmission)."""
    factor: Tensor  # ()

    @classmethod
    def create(cls, factor=0.0):
        return cls(_f32(factor))


class PBRMaterialVolumeAttribs(NamedTuple):
    """PBR_Structures.fxh:229-239 (KHR_materials_volume)."""
    attenuation_color: Tensor     # (3,)
    thickness_factor: Tensor      # ()
    attenuation_distance: Tensor  # ()

    @classmethod
    def create(cls, attenuation_color=(1, 1, 1), thickness_factor=0.0,
               attenuation_distance=1e9):
        return cls(_vec(attenuation_color, 3), _f32(thickness_factor),
                   _f32(attenuation_distance))


def stack_materials(mats: Sequence[NamedTuple], device=None):
    """Stack per-material attribs of one kind (PBRMaterialBasicAttribs or
    an extension's) into one batched tuple (leading dim = material id)."""
    cls = type(mats[0])
    return cls(*(torch.stack([getattr(m, f) for m in mats]).to(device)
                 for f in cls._fields))


class PBRLightAttribs(NamedTuple):
    """PBRLightAttribs (PBR_Structures.fxh:316-334) with a leading light
    dimension."""
    type: Tensor              # (N,) int32, LightType
    position: Tensor          # (N, 3)
    direction: Tensor         # (N, 3) normalized
    shadow_map_index: Tensor  # (N,) int32, -1 = no shadow
    intensity: Tensor         # (N, 3)
    range4: Tensor            # (N,) range^4
    spot_angle_scale: Tensor  # (N,)
    spot_angle_offset: Tensor  # (N,)

    @classmethod
    def directional(cls, direction, intensity, shadow_map_index=-1,
                    device=None):
        d = _f32(direction, device).reshape(1, 3)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return cls(
            type=torch.tensor([LightType.DIRECTIONAL], dtype=torch.int32,
                              device=device),
            position=torch.zeros((1, 3), dtype=torch.float32, device=device),
            direction=d,
            shadow_map_index=torch.tensor([shadow_map_index],
                                          dtype=torch.int32, device=device),
            intensity=_f32(intensity, device).reshape(1, 3),
            range4=_f32([math.inf], device),
            spot_angle_scale=torch.zeros((1,), dtype=torch.float32,
                                         device=device),
            spot_angle_offset=torch.zeros((1,), dtype=torch.float32,
                                          device=device),
        )


    @property
    def count(self) -> int:
        return self.type.shape[0]


class PBRShadowMapInfo(NamedTuple):
    """PBRShadowMapInfo (PBR_Structures.fxh:339-351): each shadow-casting
    light's projection and atlas placement, leading dim the light count
    (JAX attribs.py:275; no frame of the port reads it yet)."""
    world_to_light_proj_space: Tensor  # (N, 4, 4)
    uv_scale: Tensor                   # (N, 2)
    uv_bias: Tensor                    # (N, 2)
    shadow_map_slice: Tensor           # (N,) int32


class PBRRendererShaderParameters(NamedTuple):
    """PBRRendererShaderParameters (PBR_Structures.fxh:126-149)."""
    average_log_lum: Tensor
    middle_gray: Tensor
    white_point: Tensor
    prefiltered_cube_last_mip: Tensor
    ibl_scale: Tensor          # (4,)
    occlusion_strength: Tensor
    emission_scale: Tensor
    mip_bias: Tensor
    time: Tensor
    unshaded_color: Tensor     # (4,)
    highlight_color: Tensor    # (4,)

    @classmethod
    def create(cls, average_log_lum=0.3, middle_gray=0.18, white_point=3.0,
               prefiltered_cube_last_mip=4.0, ibl_scale=(1, 1, 1, 1),
               occlusion_strength=1.0, emission_scale=1.0, mip_bias=0.0,
               time=0.0, unshaded_color=(0.5, 0.5, 0.5, 1.0),
               highlight_color=(0, 0, 0, 0), device=None):
        return cls(
            average_log_lum=_f32(average_log_lum, device),
            middle_gray=_f32(middle_gray, device),
            white_point=_f32(white_point, device),
            prefiltered_cube_last_mip=_f32(prefiltered_cube_last_mip, device),
            ibl_scale=_vec(ibl_scale, 4, device),
            occlusion_strength=_f32(occlusion_strength, device),
            emission_scale=_f32(emission_scale, device),
            mip_bias=_f32(mip_bias, device),
            time=_f32(time, device),
            unshaded_color=_vec(unshaded_color, 4, device),
            highlight_color=_vec(highlight_color, 4, device),
        )
