"""A frozen copy of the port's plain frame path, the benchmark's reference.

Copied from `diligentfx_tpu_torch` (attribs, config, math3d, the vertex
stage, the tile raster's setup and binning, the deferred G-buffer, the IBL
precompute, the post-processing context, SSAO, SSR, TAA, bloom and the
tone map) with its imports pointed here.  The kernel wrappers keep only
their plain PyTorch versions, which run on any device, and the IBL maps
are always precomputed (no disk cache).  Nothing here imports the port,
the JAX package or JAX, so a later change to the port cannot move the
yardstick it is held to.
"""
