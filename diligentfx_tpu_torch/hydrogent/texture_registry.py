"""Async texture registry (the port of the JAX package's
hydrogent/texture_registry.py) — the analogue of Hydrogent's
HnTextureRegistry (include/HnTextureRegistry.hpp:141-176): textures load
asynchronously through a worker pool, deduplicate by content hash, respect
a per-commit upload budget, and commit into the device texture atlas (the
GLTF::ResourceManager atlas mode; ops/texture.AtlasBuilder).  Storage/data
version counters let the delegate skip atlas rebuilds when nothing
changed.

The reference's states:
  * loading (worker decoding)          → future not done
  * loaded, not on device (PENDING)    → decoded, past this frame's budget
  * resident                           → packed into the committed atlas
Until a texture is resident, its atlas slot is a 1x1 neutral placeholder, so
frames render immediately and refine as uploads land (the load-budget
graceful-degradation scheme, HnRenderDelegate interface:254-274).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from diligentfx_tpu_torch.device import resolve_device
from diligentfx_tpu_torch.native import binding as native
from diligentfx_tpu_torch.ops.texture import AtlasBuilder, TextureAtlas

ImageSource = Union[np.ndarray, Callable[[], np.ndarray]]

_NEUTRAL = np.full((1, 1, 4), 0.7, np.float32)


class _Entry:
    __slots__ = ("tex_id", "future", "image", "resident", "nbytes")

    def __init__(self, tex_id: int):
        self.tex_id = tex_id
        self.future: Optional[Future] = None
        self.image: Optional[np.ndarray] = None
        self.resident = False
        self.nbytes = 0


class HnTextureRegistry:
    """Allocate returns a stable texture id immediately; commit() packs every
    resident texture into a TextureAtlas on `device` (CUDA unless the caller
    asks for the CPU), admitting newly-decoded textures up to
    `upload_budget_bytes` per call."""

    def __init__(self, atlas_dim: int = 1024,
                 upload_budget_bytes: int = 32 << 20,
                 max_workers: int = 2, device=None):
        self.device = resolve_device(device)
        self.atlas_dim = atlas_dim
        self.upload_budget_bytes = upload_budget_bytes
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="hn-tex")
        self._lock = threading.Lock()
        self._by_hash: Dict[bytes, _Entry] = {}
        self._entries: List[_Entry] = []
        self.storage_version = 0     # bumps when the atlas layout changes
        self.data_version = 0        # bumps when any texel data changes
        self._atlas: Optional[TextureAtlas] = None

    # -- allocation ----------------------------------------------------------

    def allocate(self, image: ImageSource, key: Optional[bytes] = None) -> int:
        """Register a texture; returns its stable id.  `image` may be an
        ndarray or a zero-arg loader callable (decoded on the worker pool).
        Identical content (by hash or explicit key) dedups to one id."""
        if key is None and isinstance(image, np.ndarray):
            key = native.content_hash(np.ascontiguousarray(image))
        with self._lock:
            if key is not None and key in self._by_hash:
                return self._by_hash[key].tex_id
            e = _Entry(len(self._entries))
            self._entries.append(e)
            if key is not None:
                self._by_hash[key] = e
        if callable(image):
            e.future = self._pool.submit(self._decode, image)
        else:
            e.image = self._normalize(image)
            e.nbytes = e.image.nbytes
        self.data_version += 1
        return e.tex_id

    @staticmethod
    def _normalize(img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return np.ascontiguousarray(img, np.float32)

    def _decode(self, loader: Callable[[], np.ndarray]) -> np.ndarray:
        return self._normalize(loader())

    # -- commit ---------------------------------------------------------------

    def commit(self, upload_budget_bytes: Optional[int] = None
               ) -> Optional[TextureAtlas]:
        """Admit decoded textures (budgeted), rebuild the atlas if the
        resident set changed.  Returns the current atlas (None if empty)."""
        budget = (self.upload_budget_bytes if upload_budget_bytes is None
                  else upload_budget_bytes)
        changed = False
        spent = 0
        for e in self._entries:
            if e.resident:
                continue
            if e.image is None and e.future is not None and e.future.done():
                e.image = e.future.result()
                e.nbytes = e.image.nbytes
                e.future = None
            if e.image is not None and spent + e.nbytes <= budget:
                e.resident = True
                spent += e.nbytes
                changed = True
        if changed or (self._atlas is None and self._entries):
            builder = AtlasBuilder(self.atlas_dim)
            for e in self._entries:
                builder.add(e.image if e.resident and e.image is not None
                            else _NEUTRAL)
            self._atlas = builder.build(device=self.device)
            self.storage_version += 1
        return self._atlas

    # -- introspection ---------------------------------------------------------

    @property
    def num_textures(self) -> int:
        return len(self._entries)

    @property
    def num_pending(self) -> int:
        return sum(1 for e in self._entries if not e.resident)

    @property
    def resident_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries if e.resident)

    def wait_idle(self) -> None:
        """Block until every async decode finished (test helper — the
        WaitForTextureManagerIdle analogue, RadientGPUTestHelpers.hpp)."""
        for e in self._entries:
            if e.future is not None:
                e.future.result()

    def stop(self) -> None:
        self._pool.shutdown(wait=True)
