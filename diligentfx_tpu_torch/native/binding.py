"""ctypes binding of the native host runtime (the port of the JAX
package's native/binding.py).

The host loops the reference writes in C++: the content hash of the dedup
caches, the geometry pool's suballocator and the fan triangulation of
polygon faces.  Each runs in the library `build.py` compiles at first use;
a failed build raises (the JAX binding falls back to Python quietly).  The
Python loops stay as the plain versions (`*_plain`): the same results,
which the tests hold the library against.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Tuple

import numpy as np

from diligentfx_tpu_torch.native import build as _build

_u64 = ctypes.c_uint64
_i64 = ctypes.c_int64
_typed = threading.Lock()
_ready = False


def _lib() -> ctypes.CDLL:
    """The native library with its prototypes set (built at first use)."""
    global _ready
    lib = _build.load()
    if not _ready:
        with _typed:
            lib.dfx_content_hash.argtypes = [ctypes.c_void_p, _u64, _u64,
                                             ctypes.POINTER(_u64 * 2)]
            lib.dfx_pool_create.argtypes = [_u64]
            lib.dfx_pool_create.restype = _i64
            lib.dfx_pool_alloc.argtypes = [_i64, _u64, _u64]
            lib.dfx_pool_alloc.restype = _i64
            lib.dfx_pool_free.argtypes = [_i64, _u64]
            lib.dfx_pool_free.restype = ctypes.c_int
            lib.dfx_pool_stats.argtypes = [_i64, ctypes.POINTER(_u64 * 4)]
            lib.dfx_triangulate_faces.argtypes = [
                ctypes.c_void_p, _i64, ctypes.c_void_p, ctypes.c_void_p]
            lib.dfx_triangulate_faces.restype = _i64
            _ready = True
    return lib


# ---------------------------------------------------------------------------
# content hash
# ---------------------------------------------------------------------------


def _meta(a: np.ndarray) -> bytes:
    return (str(a.dtype) + str(a.shape)).encode()


def content_hash(*arrays) -> bytes:
    """128-bit content hash of array payloads (dedup cache keys): each
    array's dtype and shape, then its bytes, chained through the seed."""
    lib = _lib()
    out = (_u64 * 2)()
    seed = 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        meta = _meta(a)
        mbuf = (ctypes.c_char * len(meta)).from_buffer_copy(meta)
        lib.dfx_content_hash(ctypes.addressof(mbuf), len(meta), seed,
                             ctypes.byref(out))
        seed = out[0]
        lib.dfx_content_hash(a.ctypes.data, a.nbytes, seed, ctypes.byref(out))
        seed = out[0] ^ out[1]
    return bytes(bytearray(out))


_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _mix(x: int) -> int:
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & _M64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & _M64
    return x ^ (x >> 33)


def _hash_plain(data: bytes, seed: int) -> Tuple[int, int]:
    """dfx_content_hash in Python integers (mod 2^64)."""
    n = len(data)
    h1 = seed ^ ((n * _P1) & _M64)
    h2 = _rotl(seed, 31) ^ ((n * _P2) & _M64)
    body = n // 16 * 16
    words = np.frombuffer(data[:body], "<u8").tolist()
    for a, b in zip(words[0::2], words[1::2]):
        h1 = (_rotl(h1 ^ ((a * _P2) & _M64), 27) * _P1 + _P3) & _M64
        h2 = (_rotl(h2 ^ ((b * _P1) & _M64), 31) * _P2 + _P3) & _M64
    tail = data[body:]
    if tail:
        h1 ^= _mix((int.from_bytes(tail[:8], "little") * _P3) & _M64)
        if len(tail) > 8:
            h2 ^= _mix((int.from_bytes(tail[8:], "little") * _P2) & _M64)
    h1 = _mix((h1 + h2) & _M64)
    h2 = _mix(h2 ^ h1)
    return h1, h2


def content_hash_plain(*arrays) -> bytes:
    """content_hash's plain version, equal to it byte for byte."""
    h1 = h2 = seed = 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        h1, h2 = _hash_plain(_meta(a), seed)
        h1, h2 = _hash_plain(a.tobytes(), h1)
        seed = h1 ^ h2
    return h1.to_bytes(8, "little") + h2.to_bytes(8, "little")


# ---------------------------------------------------------------------------
# geometry pool suballocator
# ---------------------------------------------------------------------------


class GeometryPool:
    """Suballocating geometry pool (HnGeometryPool / IBufferSuballocator
    analogue): first-fit offsets into one large buffer, in the native
    library."""

    def __init__(self, capacity: int):
        self._lib = _lib()
        self.capacity = capacity
        self._handle = self._lib.dfx_pool_create(capacity)

    def alloc(self, size: int, alignment: int = 16) -> int:
        """Returns the offset, or -1 when full."""
        return int(self._lib.dfx_pool_alloc(self._handle, size, alignment))

    def free(self, offset: int) -> None:
        if self._lib.dfx_pool_free(self._handle, offset) != 0:
            raise KeyError(f"offset {offset} not allocated")

    def stats(self) -> Tuple[int, int, int, int]:
        """(capacity, used, peak, free_fragments)."""
        out = (_u64 * 4)()
        self._lib.dfx_pool_stats(self._handle, ctypes.byref(out))
        return tuple(int(x) for x in out)


class GeometryPoolPlain:
    """GeometryPool's plain version: the same first-fit free list with
    coalescing, in Python."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._free: List[Tuple[int, int]] = [(0, capacity)]
        self._allocs: Dict[int, int] = {}
        self._used = 0
        self._peak = 0

    def alloc(self, size: int, alignment: int = 16) -> int:
        if size <= 0:
            return -1
        alignment = max(alignment, 1)
        for i, (off, blk) in enumerate(self._free):
            aligned = (off + alignment - 1) // alignment * alignment
            pad = aligned - off
            if blk < pad + size:
                continue
            del self._free[i]
            if pad:
                self._free.insert(i, (off, pad))
            rest = blk - pad - size
            if rest:
                self._free.append((aligned + size, rest))
            self._free.sort()
            self._allocs[aligned] = size
            self._used += size
            self._peak = max(self._peak, self._used)
            return aligned
        return -1

    def free(self, offset: int) -> None:
        if offset not in self._allocs:
            raise KeyError(f"offset {offset} not allocated")
        size = self._allocs.pop(offset)
        self._used -= size
        self._free.append((offset, size))
        self._free.sort()
        merged: List[Tuple[int, int]] = []
        for off, sz in self._free:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + sz)
            else:
                merged.append((off, sz))
        self._free = merged

    def stats(self) -> Tuple[int, int, int, int]:
        return (self.capacity, self._used, self._peak, len(self._free))


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------


def _faces(face_counts, face_indices):
    face_counts = np.ascontiguousarray(face_counts, np.int32)
    face_indices = np.ascontiguousarray(face_indices, np.int32)
    n_tris = int(np.maximum(face_counts - 2, 0).sum())
    return face_counts, face_indices, np.empty((n_tris, 3), np.int32)


def triangulate_faces(face_counts: np.ndarray,
                      face_indices: np.ndarray) -> np.ndarray:
    """Fan-triangulate polygon faces → (T, 3) int32 (HnMeshUtils
    analogue), in the native library."""
    face_counts, face_indices, out = _faces(face_counts, face_indices)
    if out.shape[0]:
        written = _lib().dfx_triangulate_faces(
            face_counts.ctypes.data, len(face_counts),
            face_indices.ctypes.data, out.ctypes.data)
        if written != out.shape[0]:
            raise RuntimeError(f"dfx_triangulate_faces wrote {written} of "
                               f"{out.shape[0]} triangles")
    return out


def triangulate_faces_plain(face_counts: np.ndarray,
                            face_indices: np.ndarray) -> np.ndarray:
    """triangulate_faces' plain version, in Python."""
    face_counts, face_indices, out = _faces(face_counts, face_indices)
    t = src = 0
    for c in face_counts:
        for k in range(1, c - 1):
            out[t] = (face_indices[src], face_indices[src + k],
                      face_indices[src + k + 1])
            t += 1
        src += c
    return out
