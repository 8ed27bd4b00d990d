"""Texture slot order of ScenePrimitives.tex_ids (the port's own copy of
the constants of diligentfx_tpu/gltf/model.py:24-29; the glTF scene builder
itself is not ported yet)."""

SLOT_BASE_COLOR = 0
SLOT_NORMAL = 1
SLOT_PHYS_DESC = 2
SLOT_EMISSIVE = 3
SLOT_OCCLUSION = 4
NUM_SLOTS = 5
