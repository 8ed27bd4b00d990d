"""Radient, the second front end (the port of the JAX package's radient/):
engine, ECS scene, async assets, resolver, drawable cache, renderer, and
the ctypes wrapper of the C API (c_api, imported on its own)."""
from diligentfx_tpu_torch.radient import engine as engine
from diligentfx_tpu_torch.radient import scene_state as scene_state
from diligentfx_tpu_torch.radient import asset_manager as asset_manager
