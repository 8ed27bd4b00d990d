"""diligentfx_tpu_torch — the PyTorch + CUDA port of diligentfx_tpu.

Mirrors the JAX package's module layout (config, math3d, attribs, ops/,
pbr/, postfx/, gltf/, components/, hydrogent/, radient/, native/, utils/)
so each module's counterpart is easy to find.  Plain tensor code is
PyTorch; the six Pallas kernels of the JAX package are hand-written CUDA
C++ under csrc/, built with nvcc at first use (ops/cuda_build.py); the
native host runtime (native/src/dfx_native.cpp and Radient's C API,
native/src/radient_c.cpp) is built with g++ at first use.

Entry points (PBRRenderer, HnTaskManager, build_scene, HnRenderDelegate,
create_radient_engine) run on "cuda" unless the caller passes
device="cpu"; on CPU every kernel wrapper runs its plain PyTorch version
instead.
"""
