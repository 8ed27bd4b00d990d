"""ctypes wrapper over the Radient public C API (native/src/radient_c.cpp;
the port of the JAX package's radient/c_api.py) — the analogue of
Radient/interface/*.h: reference-counted COM-style handles usable from plain
C, with RadientTypes.h status codes (RadientTypes.h:59-80).

The C layer owns asset dedup (content-hash, RadientMeshAssetManager.hpp:146)
and the scene graph with incremental change logs + cached world matrices
(RadientSceneState.hpp:58-115); the Python side consumes `renderables()` /
`world_matrices()` to drive rendering.  The library is the port's native
runtime (native/build.py), built at first use; a failed build raises here
(the JAX wrapper falls back to its Python SceneState quietly).
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

from diligentfx_tpu_torch.native import build as _build
from diligentfx_tpu_torch.radient.types import (LoadStatus, RadientError,
                                                RadientStatus)

_typed = threading.Lock()
_typed_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """The native library with the C API's prototypes set (built at first
    use; raises RuntimeError when the build fails)."""
    global _typed_lib
    lib = _build.load()
    if lib is not _typed_lib:
        with _typed:
            i32, i64, u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
            vp = ctypes.c_void_p
            for name, args, res in [
                ("dfx_rt_retain", [i64], i32),
                ("dfx_rt_release", [i64], i32),
                ("dfx_rt_refcount", [i64], i32),
                ("dfx_rt_engine_create", [i32], i64),
                ("dfx_rt_create_mesh", [i64, vp, vp, vp, i64, vp, i64,
                                        ctypes.POINTER(i64 * 2)], i32),
                ("dfx_rt_create_material", [i64, vp], i64),
                ("dfx_rt_asset_load_state", [i64], i32),
                ("dfx_rt_mesh_info", [i64, ctypes.POINTER(i64 * 4)], i32),
                ("dfx_rt_mesh_read", [i64, vp, vp, vp, vp], i32),
                ("dfx_rt_update_gpu_resources", [i64], i64),
                ("dfx_rt_scene_create", [i64], i64),
                ("dfx_rt_node_create", [i64, i32], i32),
                ("dfx_rt_node_set_transform", [i64, i32, vp], i32),
                ("dfx_rt_node_set_mesh", [i64, i32, i64, i64], i32),
                ("dfx_rt_node_set_visible", [i64, i32, i32], i32),
                ("dfx_rt_node_destroy", [i64, i32], i32),
                ("dfx_rt_scene_revision", [i64], u64),
                ("dfx_rt_scene_changes_since", [i64, u64, vp, vp, i64], i64),
                ("dfx_rt_scene_node_count", [i64], i32),
                ("dfx_rt_scene_world_matrices", [i64, vp], i32),
                ("dfx_rt_scene_renderables", [i64, vp, vp, vp, i64], i64),
            ]:
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _typed_lib = lib
    return lib


def available() -> bool:
    """Whether the native library builds and loads here.  It only reports:
    NativeEngine raises with the compiler's message where it does not."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def _check(status: int, what: str = "") -> None:
    if status < 0:
        raise RadientError(RadientStatus(status), what)


class NativeMesh:
    """A mesh asset handle (refcounted in the C layer)."""

    def __init__(self, lib, handle: int, deduped: bool):
        self._lib, self.handle, self.deduped = lib, handle, deduped

    @property
    def load_status(self) -> LoadStatus:
        return LoadStatus(self._lib.dfx_rt_asset_load_state(self.handle))

    def info(self) -> Tuple[int, int, int]:
        out = (ctypes.c_int64 * 4)()
        _check(self._lib.dfx_rt_mesh_info(self.handle, ctypes.byref(out)))
        return int(out[0]), int(out[1]), (int(out[2]) & 0xFFFFFFFFFFFFFFFF)

    def read(self):
        nv, nt, _ = self.info()
        pos = np.empty((nv, 3), np.float32)
        nrm = np.empty((nv, 3), np.float32)
        uv = np.empty((nv, 2), np.float32)
        idx = np.empty((nt, 3), np.int32)
        _check(self._lib.dfx_rt_mesh_read(
            self.handle, pos.ctypes.data, nrm.ctypes.data, uv.ctypes.data,
            idx.ctypes.data))
        return pos, nrm, uv, idx

    def release(self) -> None:
        self._lib.dfx_rt_release(self.handle)


class NativeScene:
    """Scene-graph handle: writer ops bump a revision and append to the
    incremental change log; reads expose world matrices + renderables."""

    def __init__(self, lib, handle: int):
        self._lib, self.handle = lib, handle

    def create_node(self, parent: int = -1) -> int:
        node = self._lib.dfx_rt_node_create(self.handle, parent)
        if node < 0:
            raise RadientError(RadientStatus.INVALID_ARGUMENT, "bad parent")
        return node

    def set_transform(self, node: int, local: np.ndarray) -> None:
        m = np.ascontiguousarray(local, np.float32)
        _check(self._lib.dfx_rt_node_set_transform(
            self.handle, node, m.ctypes.data))

    def set_mesh(self, node: int, mesh: NativeMesh,
                 material_handle: int = 0) -> None:
        _check(self._lib.dfx_rt_node_set_mesh(
            self.handle, node, mesh.handle, material_handle))

    def set_visible(self, node: int, visible: bool) -> None:
        _check(self._lib.dfx_rt_node_set_visible(
            self.handle, node, int(visible)))

    def destroy_node(self, node: int) -> None:
        _check(self._lib.dfx_rt_node_destroy(self.handle, node))

    @property
    def revision(self) -> int:
        return int(self._lib.dfx_rt_scene_revision(self.handle))

    @property
    def node_count(self) -> int:
        return int(self._lib.dfx_rt_scene_node_count(self.handle))

    def changes_since(self, base_revision: int,
                      cap: int = 4096) -> Optional[List[Tuple[int, int]]]:
        """(kind, node) entries newer than base_revision, or None when the
        base predates the kept log (OUT_OF_DATE → full resync needed)."""
        kinds = np.empty(cap, np.int32)
        nodes = np.empty(cap, np.int32)
        n = self._lib.dfx_rt_scene_changes_since(
            self.handle, base_revision, kinds.ctypes.data, nodes.ctypes.data,
            cap)
        if n == int(RadientStatus.OUT_OF_DATE):
            return None
        _check(int(n))
        return list(zip(kinds[:n].tolist(), nodes[:n].tolist()))

    def world_matrices(self) -> np.ndarray:
        n = self.node_count
        out = np.zeros((n, 4, 4), np.float32)
        if n:
            _check(self._lib.dfx_rt_scene_world_matrices(
                self.handle, out.ctypes.data))
        return out

    def renderables(self, cap: int = 65536):
        """(nodes, mesh_handles, material_handles) of visible meshes."""
        nodes = np.empty(cap, np.int32)
        meshes = np.empty(cap, np.int64)
        mats = np.empty(cap, np.int64)
        n = self._lib.dfx_rt_scene_renderables(
            self.handle, nodes.ctypes.data, meshes.ctypes.data,
            mats.ctypes.data, cap)
        _check(int(n))
        return nodes[:n].copy(), meshes[:n].copy(), mats[:n].copy()

    def release(self) -> None:
        self._lib.dfx_rt_release(self.handle)


class NativeEngine:
    """Engine handle (CreateRadientEngine analogue)."""

    def __init__(self, backend: int = 0):
        lib = _load()
        self._lib = lib
        self.handle = lib.dfx_rt_engine_create(backend)

    def refcount(self, handle: int) -> int:
        return int(self._lib.dfx_rt_refcount(handle))

    def retain(self, handle: int) -> None:
        _check(self._lib.dfx_rt_retain(handle))

    def release_handle(self, handle: int) -> None:
        _check(self._lib.dfx_rt_release(handle))

    def create_mesh(self, positions, indices, normals=None,
                    uvs=None) -> NativeMesh:
        pos = np.ascontiguousarray(positions, np.float32)
        idx = np.ascontiguousarray(indices, np.int32)
        nrm = (np.ascontiguousarray(normals, np.float32)
               if normals is not None else None)
        uv = (np.ascontiguousarray(uvs, np.float32)
              if uvs is not None else None)
        out = (ctypes.c_int64 * 2)()
        _check(self._lib.dfx_rt_create_mesh(
            self.handle, pos.ctypes.data,
            nrm.ctypes.data if nrm is not None else None,
            uv.ctypes.data if uv is not None else None,
            pos.shape[0], idx.ctypes.data, idx.shape[0], ctypes.byref(out)),
            "create_mesh")
        return NativeMesh(self._lib, int(out[0]), bool(out[1]))

    def create_material(self, params) -> int:
        p = np.zeros(16, np.float32)
        arr = np.asarray(params, np.float32).ravel()
        p[:arr.size] = arr[:16]
        h = self._lib.dfx_rt_create_material(self.handle, p.ctypes.data)
        if h == 0:
            raise RadientError(RadientStatus.FAILED, "create_material")
        return int(h)

    def create_scene(self) -> NativeScene:
        h = self._lib.dfx_rt_scene_create(self.handle)
        if h == 0:
            raise RadientError(RadientStatus.FAILED, "create_scene")
        return NativeScene(self._lib, h)

    def update_gpu_resources(self) -> int:
        """Per-frame commit tick (UpdateGPUResources analogue); returns the
        number of assets moved LOADED_HOST → COMMITTED."""
        return int(self._lib.dfx_rt_update_gpu_resources(self.handle))

    def release(self) -> None:
        self._lib.dfx_rt_release(self.handle)
