"""HnGeometryPool — content-hash-deduplicated, budgeted geometry pool with
persistent device storage and O(dirty-range) incremental commits (the port
of the JAX package's hydrogent/geometry_pool.py).

Reference: Hydrogent/src/HnGeometryPool.cpp (vertex/index pool with content
dedup, `HnGeometryPool.cpp:1083` cache lookup) and the geometry load budget
(Hydrogent/include/HnGeometryPool.hpp:66).

- Storage is a pair of persistent, capacity-padded tensors on the pool's
  device (vertex streams + triangle indices).  A dirty range is written
  with a slice assignment, so a content edit moves only that mesh's bytes
  to the card; the per-instance expansion is a gather on the device.
- Identical mesh content (positions/normals/uvs/indices bytes) maps to ONE
  refcounted pool entry: normals and tangents are generated once per
  unique blob, and its bytes are stored once.
- `load_budget_bytes` bounds the bytes uploaded per commit; entries past the
  budget stay PENDING (not resident) and upload on later commits.

Range allocation (offsets in ELEMENT units) uses the native suballocator
(native/binding.py GeometryPool); on exhaustion the pool doubles capacity
and replays the live allocations (every entry re-marks dirty: a
resident-size event, never a per-frame one).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from diligentfx_tpu_torch.device import resolve_device
from diligentfx_tpu_torch.gltf.primitives import compute_tangents
from diligentfx_tpu_torch.native import binding as native

# bytes a pooled vertex (positions 3, normals 3, uvs 2, tangents 4 floats)
# and a pooled triangle (3 int32) take on the device
VERTEX_BYTES, TRIANGLE_BYTES = 48, 12


def _area_normals(points: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals of a triangle soup."""
    n = np.zeros_like(points)
    t0, t1, t2 = indices[:, 0], indices[:, 1], indices[:, 2]
    fn = np.cross(points[t1] - points[t0], points[t2] - points[t0])
    for k in (t0, t1, t2):
        np.add.at(n, k, fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-12)).astype(np.float32)


@dataclass
class _Entry:
    key: bytes
    v_off: int
    v_len: int
    t_off: int
    t_len: int
    refcount: int = 1
    resident: bool = False
    # host staging kept until resident (dropped after upload)
    host: Optional[Tuple[np.ndarray, ...]] = None


class HnGeometryPool:
    """Deduplicated vertex/index pool (see module docstring); its tensors
    live on `device` (CUDA unless the caller asks for the CPU)."""

    VSTREAMS = (("positions", 3), ("normals", 3), ("uvs", 2), ("tangents", 4))

    def __init__(self, vertex_capacity: int = 1 << 14,
                 index_capacity: int = 1 << 14,
                 load_budget_bytes: int = 64 << 20, device=None):
        self.device = resolve_device(device)
        self.load_budget_bytes = int(load_budget_bytes)
        self._entries: Dict[bytes, _Entry] = {}
        self._dirty: List[bytes] = []        # keys with un-uploaded host data
        self.last_commit_upload_bytes = 0
        self.total_upload_bytes = 0
        self._vcap = int(vertex_capacity)
        self._tcap = int(index_capacity)
        self._valloc = native.GeometryPool(self._vcap)
        self._talloc = native.GeometryPool(self._tcap)
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._storage_version = 0

    # -- identity --------------------------------------------------------------

    @staticmethod
    def content_key(points: np.ndarray, normals: Optional[np.ndarray],
                    uvs: Optional[np.ndarray], indices: np.ndarray) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        for a in (points, normals, uvs, indices):
            if a is None:
                h.update(b"\x00none")
            else:
                h.update(np.ascontiguousarray(a).tobytes())
                h.update(str(a.shape).encode())
        return h.digest()

    # -- acquire / release -----------------------------------------------------

    @staticmethod
    def prepare_content(points: np.ndarray, normals: Optional[np.ndarray],
                        uvs: Optional[np.ndarray], indices: np.ndarray):
        """The PURE prep half of acquire: content hash + normal/tangent
        generation + staging.  No pool state is touched, so this is safe to
        fan out across a thread pool (the parallel-prim-Sync analogue,
        HnRenderDelegate.hpp:405).  Returns (key, staged) for
        `acquire_prepared`."""
        key = HnGeometryPool.content_key(points, normals, uvs, indices)
        pts = np.asarray(points, np.float32)
        nrm = (np.asarray(normals, np.float32) if normals is not None
               else _area_normals(pts, indices))
        uv = (np.asarray(uvs, np.float32) if uvs is not None
              else np.zeros((pts.shape[0], 2), np.float32))
        tan = np.asarray(compute_tangents(pts, nrm, uv, indices), np.float32)
        idx = np.asarray(indices, np.int32)
        return key, (pts, nrm, uv, tan, idx)

    def acquire_prepared(self, key: bytes, staged) -> bytes:
        """The SERIAL registration half of acquire: dedup lookup + range
        allocation + entry insert.  Call in a deterministic prim order, so
        that offsets never depend on thread completion order."""
        e = self._entries.get(key)
        if e is not None:
            e.refcount += 1
            return key
        pts, nrm, uv, tan, idx = staged
        v_len, t_len = pts.shape[0], idx.shape[0]
        v_off = self._alloc_range(True, v_len)
        t_off = self._alloc_range(False, t_len)
        # indices stored rebased to ABSOLUTE pool vertex ids so instances
        # gather them straight out of the pool
        e = _Entry(key, v_off, v_len, t_off, t_len,
                   host=(pts, nrm, uv, tan, idx + v_off))
        self._entries[key] = e
        self._dirty.append(key)
        return key

    def acquire(self, points: np.ndarray, normals: Optional[np.ndarray],
                uvs: Optional[np.ndarray], indices: np.ndarray) -> bytes:
        """Register mesh content; returns the (refcounted) content key."""
        key = self.content_key(points, normals, uvs, indices)
        e = self._entries.get(key)
        if e is not None:
            e.refcount += 1
            return key
        key2, staged = self.prepare_content(points, normals, uvs, indices)
        return self.acquire_prepared(key2, staged)

    def release(self, key: bytes) -> None:
        e = self._entries.get(key)
        if e is None:
            return
        e.refcount -= 1
        if e.refcount <= 0:
            self._valloc.free(e.v_off)
            self._talloc.free(e.t_off)
            if key in self._dirty:
                self._dirty.remove(key)
            del self._entries[key]

    def range_of(self, key: bytes) -> Tuple[int, int, int, int]:
        e = self._entries[key]
        return e.v_off, e.v_len, e.t_off, e.t_len

    def is_resident(self, key: bytes) -> bool:
        return self._entries[key].resident

    @property
    def num_pending(self) -> int:
        return len(self._dirty)

    @property
    def storage_version(self) -> int:
        return self._storage_version

    def stats(self) -> dict:
        vb = sum(e.v_len for e in self._entries.values())
        tb = sum(e.t_len for e in self._entries.values())
        return {
            "entries": len(self._entries),
            "instances": sum(e.refcount for e in self._entries.values()),
            "pooled_vertices": vb,
            "pooled_triangles": tb,
            "pooled_bytes": vb * VERTEX_BYTES + tb * TRIANGLE_BYTES,
            "pending": len(self._dirty),
        }

    # -- commit ----------------------------------------------------------------

    def commit(self) -> Dict[str, torch.Tensor]:
        """Upload pending entries (budgeted), returning the device pool as a
        dict of tensors.  Only dirty ranges cross to the device."""
        dev = self.device
        if self._dev is None:
            self._dev = {n: torch.zeros((self._vcap, w), dtype=torch.float32,
                                        device=dev)
                         for n, w in self.VSTREAMS}
            self._dev["indices"] = torch.zeros((self._tcap, 3),
                                               dtype=torch.int32, device=dev)
        spent = 0
        uploaded = []
        for key in list(self._dirty):
            e = self._entries[key]
            nbytes = e.v_len * VERTEX_BYTES + e.t_len * TRIANGLE_BYTES
            if uploaded and spent + nbytes > self.load_budget_bytes:
                break            # PENDING: upload on a later commit
            pts, nrm, uv, tan, idx = e.host
            for (name, _w), a in zip(self.VSTREAMS, (pts, nrm, uv, tan)):
                self._dev[name][e.v_off:e.v_off + e.v_len] = \
                    torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            self._dev["indices"][e.t_off:e.t_off + e.t_len] = \
                torch.from_numpy(np.ascontiguousarray(idx)).to(dev)
            e.resident = True
            e.host = None
            spent += nbytes
            uploaded.append(key)
        for k in uploaded:
            self._dirty.remove(k)
        if uploaded:
            self._storage_version += 1
        self.last_commit_upload_bytes = spent
        self.total_upload_bytes += spent
        return self._dev

    # -- capacity --------------------------------------------------------------

    def _alloc_range(self, is_vertex: bool, count: int) -> int:
        alloc = self._valloc if is_vertex else self._talloc
        off = alloc.alloc(max(count, 1), alignment=1)
        if off >= 0:
            return off
        self._grow(is_vertex, count)
        return self._alloc_range(is_vertex, count)

    def _grow(self, is_vertex: bool, need: int) -> None:
        """Double capacity and replay live allocations.  Entries keep their
        content; every entry re-marks dirty for re-upload at the new offsets
        (the device tensors are rebuilt: a resident-size copy, restaged
        through the host, never a per-frame one)."""
        if is_vertex:
            self._vcap = max(self._vcap * 2, self._vcap + need * 2)
        else:
            self._tcap = max(self._tcap * 2, self._tcap + need * 2)
        # rebuild BOTH allocators before the replay: allocating new ranges
        # out of the live allocator that did not grow would leak every old
        # range (usage doubles a grow) and can return -1 offsets
        self._valloc = native.GeometryPool(self._vcap)
        self._talloc = native.GeometryPool(self._tcap)
        dev = self._dev
        self._dev = None
        for e in self._entries.values():
            old_v, old_t = e.v_off, e.t_off
            e.v_off = self._valloc.alloc(max(e.v_len, 1), alignment=1)
            e.t_off = self._talloc.alloc(max(e.t_len, 1), alignment=1)
            if e.v_off < 0 or e.t_off < 0:
                raise RuntimeError("HnGeometryPool: replay allocation failed "
                                   "during grow (live size exceeds capacity)")
            if e.host is None:       # was resident: restage from the device
                pts, nrm, uv, tan = (
                    dev[n][old_v:old_v + e.v_len].cpu().numpy()
                    for n, _ in self.VSTREAMS)
                idx = dev["indices"][old_t:old_t + e.t_len].cpu().numpy()
                e.resident = False
            else:
                pts, nrm, uv, tan, idx = e.host
            # indices are stored pool-absolute: rebase old→new vertex offset
            e.host = (pts, nrm, uv, tan, idx - old_v + e.v_off)
            if e.key not in self._dirty:
                self._dirty.append(e.key)
