"""Depth-range reduction (the port of diligentfx_tpu/components/
depth_range.py; Components/DepthRangeCalculator): the min / max scene
depth over the covered pixels as {SceneNearZ, SceneFarZ, SceneNearDepth,
SceneFarDepth}, which feeds the next frame's cascade fitting
(components/shadow_map_manager.py adjust_cascade_range).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diligentfx_tpu_torch.attribs import CameraAttribs
from diligentfx_tpu_torch.postfx.context import depth_to_camera_z

Tensor = torch.Tensor


class DepthRange(NamedTuple):
    """DepthRangeCalculator::DepthRange: 0-dim tensors on the depth's
    device."""
    scene_near_z: Tensor      # view-space distance of the nearest sample
    scene_far_z: Tensor
    scene_near_depth: Tensor  # NDC depth extrema
    scene_far_depth: Tensor


def compute_depth_range(depth: Tensor, camera: CameraAttribs,
                        background_depth: float = 1.0,
                        reversed_z: bool = False) -> DepthRange:
    """Masked min / max over the pixels not at `background_depth`
    (ComputeDepthRange.csh; JAX depth_range.py:29).  With no covered pixel
    the range is the whole depth range."""
    valid = depth != background_depth
    any_valid = torch.any(valid)
    big = torch.tensor(0.0 if reversed_z else 1.0, device=depth.device)
    small = torch.tensor(1.0 if reversed_z else 0.0, device=depth.device)
    dmin = torch.where(any_valid, torch.where(valid, depth, big).min(), small)
    dmax = torch.where(any_valid, torch.where(valid, depth, small).max(), big)
    near_d, far_d = (dmax, dmin) if reversed_z else (dmin, dmax)
    return DepthRange(
        scene_near_z=depth_to_camera_z(near_d, camera, reversed_z),
        scene_far_z=depth_to_camera_z(far_d, camera, reversed_z),
        scene_near_depth=near_d, scene_far_depth=far_d)
