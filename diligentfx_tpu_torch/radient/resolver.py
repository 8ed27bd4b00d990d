"""Asset resolver chain (the port of the JAX package's radient/resolver.py)
— the analogue of RadientAssetResolver.cpp and
RadientFilesystemAssetResolver.cpp: URIs resolve to (bytes, canonical
location) through an ordered chain of resolvers; the filesystem resolver searches a list of root directories and
accepts plain paths and file:// URIs.  The canonical location is the
dedup/caching identity (the reference's IRadientAssetLocation.GetLocation
contract).
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence


class ResolvedAsset(NamedTuple):
    """IRadientAssetData analogue: payload + the canonical URI that owns it."""
    data: bytes
    location: str        # canonical identity (absolute path for files)


class FilesystemAssetResolver:
    """RadientFilesystemAssetResolver: root-relative search with canonical
    absolute-path locations; understands bare paths and file:// URIs."""

    def __init__(self, roots: Sequence[str] = (".",)):
        self.roots = [os.path.abspath(r) for r in roots]

    def can_resolve(self, uri: str) -> bool:
        return not ("://" in uri and not uri.startswith("file://"))

    def resolve(self, uri: str) -> Optional[ResolvedAsset]:
        path = uri[len("file://"):] if uri.startswith("file://") else uri
        candidates = ([path] if os.path.isabs(path)
                      else [os.path.join(r, path) for r in self.roots])
        for c in candidates:
            if os.path.isfile(c):
                with open(c, "rb") as f:
                    return ResolvedAsset(f.read(), os.path.abspath(c))
        return None


class MemoryAssetResolver:
    """Test/seam resolver: mem://name URIs backed by a dict (the analogue of
    the reference's in-memory glTF test documents)."""

    def __init__(self, store: Optional[dict] = None):
        self.store = store if store is not None else {}

    def can_resolve(self, uri: str) -> bool:
        return uri.startswith("mem://")

    def resolve(self, uri: str) -> Optional[ResolvedAsset]:
        data = self.store.get(uri[len("mem://"):])
        return None if data is None else ResolvedAsset(bytes(data), uri)


class AssetResolverChain:
    """Ordered resolver chain: the first resolver that can_resolve AND finds
    the asset wins (RadientAssetResolver's chained lookup)."""

    def __init__(self, resolvers: Optional[List] = None):
        self.resolvers = resolvers if resolvers is not None else [
            FilesystemAssetResolver()]

    def push_front(self, resolver) -> None:
        self.resolvers.insert(0, resolver)

    def resolve(self, uri: str) -> Optional[ResolvedAsset]:
        for r in self.resolvers:
            if r.can_resolve(uri):
                found = r.resolve(uri)
                if found is not None:
                    return found
        return None
