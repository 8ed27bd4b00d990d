"""Hydra (pxr) render-delegate adapter (the port of the JAX package's
hydrogent/usd_adapter.py) — the analogue of Hydrogent's
HnRenderDelegate implementing pxr::HdRenderDelegate
(Hydrogent/interface/HnRenderDelegate.hpp:156-539) with prim adapters for
HnMesh::Sync (HnMesh.cpp:192), HnMaterial::Sync (HnMaterial.cpp), HnLight /
HnCamera / HnRenderBuffer, and CommitResources (interface:402).

The adapter is built by a factory, `build_adapter(pxr_module)`, that binds
the Hydra protocol classes from whatever `pxr`-shaped module it is given:

- with real OpenUSD, `bind_usd()` imports `pxr` and returns the adapter
  classes registered against `pxr.Hd` (note: stock OpenUSD only loads render
  delegates as C++ plugins — a production deployment wraps these Python
  classes through a thin C++ HdRendererPlugin shim that forwards the virtual
  calls, exactly how the structural test's fake pxr drives them);
- the tests and chip_smoke.py pass a fake `pxr` shim
  (tests/torch_pxr_shim.py) with the same class/attribute shape and drive
  the full create → Sync → CommitResources → Execute flow headlessly.

The adapter maps:
  HdMesh.Sync        → HnMesh.set_topology/set_points/set_primvar/...
  HdMaterial.Sync    → HnMaterialNetwork node-graph parse (material_network)
  HdLight.Sync       → HnLight.set_params
  HdCamera.Sync      → HnCamera.set_params
  HdRenderBuffer     → HnRenderBuffer AOV views
  HdRenderDelegate.CommitResources → HnRenderDelegate.commit_resources
  HdTask(Execute)    → HnRenderDelegate.execute (task-graph frame)
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from diligentfx_tpu_torch.hydrogent.render_delegate import (
    HnRenderDelegate, HnRenderDelegateCreateInfo)

# Hydra light prim types → HnLight.type (HnLight.cpp light-kind switch)
_LIGHT_TYPES = {
    "distantLight": "distant",
    "sphereLight": "point",
    "diskLight": "spot",
    "rectLight": "point",
    "domeLight": "dome",
    "simpleLight": "point",
}


def material_network_from_hd(network_map: Any) -> dict:
    """HdMaterialNetworkMap → the plain node-graph dict consumed by
    HnMaterialNetwork (material_network.py docstring format).

    Accepts either a real pxr.HdMaterialNetworkMap-shaped object (``.map``
    dict of terminal-token → network with ``.nodes`` / ``.relationships``)
    or an already-plain dict (passed through).  Mirrors
    HnMaterialNetwork::LoadParams' network walk (HnMaterialNetwork.cpp)."""
    if isinstance(network_map, dict):
        # already-plain form: node-graph or legacy flat dict — both are
        # consumed directly by HnMaterialNetwork
        return network_map
    nets = getattr(network_map, "map", None)
    if nets is None:
        return {}
    nodes: Dict[str, dict] = {}
    connections = []
    terminal = None
    for _terminal_token, net in dict(nets).items():
        for node in getattr(net, "nodes", ()):
            path = str(getattr(node, "path"))
            ident = str(getattr(node, "identifier"))
            params = dict(getattr(node, "parameters", {}) or {})
            nodes[path] = {"type": ident, "params": params}
            if ident == "UsdPreviewSurface":
                terminal = path
        for rel in getattr(net, "relationships", ()):
            # HdMaterialRelationship: input node/name → output node/name
            # (Hydra's "input" is the upstream source)
            connections.append((str(getattr(rel, "outputId")),
                                str(getattr(rel, "outputName")),
                                str(getattr(rel, "inputId")),
                                str(getattr(rel, "inputName"))))
    out = {"nodes": nodes, "connections": connections}
    if terminal is not None:
        out["terminal"] = terminal
    return out


def build_adapter(pxr: Any) -> dict:
    """Bind the Hydra protocol classes from `pxr` and return the adapter
    class dict: {"RenderDelegate", "RendererPlugin", "RenderTask", ...}.

    `pxr` must expose `Hd.RenderDelegate`, `Hd.Mesh`, `Hd.Sprim`,
    `Hd.Bprim`, `Hd.Task`, and a `Hd.ChangeTracker` with the usual
    Dirty* bit constants (any missing bits default to "all dirty")."""
    Hd = pxr.Hd

    def _dirty(bits, name) -> bool:
        flag = getattr(Hd.ChangeTracker, name, None)
        if flag is None or bits is None:
            return True
        try:
            return bool(bits & flag)
        except TypeError:
            return True

    class DfxHdMesh(Hd.Mesh):
        """Rprim adapter (HnMesh.cpp:192-1408 Sync semantics)."""

        def __init__(self, type_id, prim_id, inner: HnRenderDelegate):
            super().__init__()
            self._id = prim_id
            self._mesh = inner.create_rprim("mesh", str(prim_id))

        def GetId(self):
            return self._id

        def Sync(self, sceneDelegate, renderParam, dirtyBits, reprToken=None):
            pid = self._id
            m = self._mesh
            if _dirty(dirtyBits, "DirtyTopology"):
                topo = sceneDelegate.GetMeshTopology(pid)
                counts = np.asarray(topo.GetFaceVertexCounts(), np.int32)
                indices = np.asarray(topo.GetFaceVertexIndices(), np.int32)
                m.set_topology(counts, indices)
                subsets = getattr(topo, "GetGeomSubsets", lambda: ())()
                if subsets:
                    m.set_geom_subsets(
                        [(str(s.materialId), np.asarray(s.indices, np.int32))
                         for s in subsets])
            if _dirty(dirtyBits, "DirtyPoints"):
                pts = sceneDelegate.Get(pid, "points")
                if pts is not None:
                    m.set_points(np.asarray(pts, np.float32))
            if _dirty(dirtyBits, "DirtyPrimvar"):
                for name in ("normals", "st"):
                    v = sceneDelegate.Get(pid, name)
                    if v is not None:
                        m.set_primvar(name, np.asarray(v, np.float32))
            if _dirty(dirtyBits, "DirtyTransform"):
                m.set_transform(np.asarray(
                    sceneDelegate.GetTransform(pid), np.float32))
            if _dirty(dirtyBits, "DirtyMaterialId"):
                mat = sceneDelegate.GetMaterialId(pid)
                if mat:
                    m.set_material(str(mat))
            if _dirty(dirtyBits, "DirtyVisibility"):
                m.set_visibility(bool(sceneDelegate.GetVisible(pid)))

        def Finalize(self, renderParam=None):
            pass

    class DfxHdMaterial(Hd.Sprim):
        """Material Sprim adapter: GetMaterialResource →
        HnMaterialNetwork node-graph parse (HnMaterial.cpp Sync)."""

        def __init__(self, type_id, prim_id, inner: HnRenderDelegate):
            super().__init__()
            self._id = prim_id
            self._mat = inner.create_sprim("material", str(prim_id))

        def GetId(self):
            return self._id

        def Sync(self, sceneDelegate, renderParam, dirtyBits):
            res = sceneDelegate.GetMaterialResource(self._id)
            self._mat.set_network(material_network_from_hd(res))

        def Finalize(self, renderParam=None):
            pass

    class DfxHdLight(Hd.Sprim):
        """Light Sprim adapter (HnLight.cpp Sync: GetLightParamValue walk)."""

        def __init__(self, type_id, prim_id, inner: HnRenderDelegate):
            super().__init__()
            self._id = prim_id
            self._type = _LIGHT_TYPES.get(str(type_id), "distant")
            self._light = inner.create_sprim("light", str(prim_id))
            self._light.set_params(type=self._type)

        def GetId(self):
            return self._id

        def Sync(self, sceneDelegate, renderParam, dirtyBits):
            pid = self._id

            def p(token, default=None):
                v = sceneDelegate.GetLightParamValue(pid, token)
                return default if v is None else v

            kw: Dict[str, Any] = {"type": self._type}
            color = p("color", (1.0, 1.0, 1.0))
            kw["color"] = tuple(np.asarray(color, np.float32))
            kw["intensity"] = float(p("intensity", 1.0))
            xf = p("transform")
            if xf is not None:
                xf = np.asarray(xf, np.float32)
                # row-vector convention: light -Z forward, position = row 3
                kw["direction"] = tuple(-xf[2, :3] /
                                        max(np.linalg.norm(xf[2, :3]), 1e-9))
                kw["position"] = tuple(xf[3, :3])
            if self._type == "spot":
                angle = float(p("shaping:cone:angle", 45.0))
                kw["cone_angles"] = (0.0, float(np.radians(angle)))
            rng = p("range")
            if rng is not None:
                kw["range"] = float(rng)
            kw["cast_shadows"] = bool(p("shadow:enable", False))
            if self._type == "dome":
                tex = p("texture:file")
                if tex is not None and not isinstance(tex, str):
                    kw["dome_env"] = np.asarray(tex, np.float32)
            self._light.set_params(**kw)

        def Finalize(self, renderParam=None):
            pass

    class DfxHdCamera(Hd.Sprim):
        """Camera Sprim adapter (HnCamera Sync: view matrix → eye/target)."""

        def __init__(self, type_id, prim_id, inner: HnRenderDelegate):
            super().__init__()
            self._id = prim_id
            self._cam = inner.create_sprim("camera", str(prim_id))

        def GetId(self):
            return self._id

        def Sync(self, sceneDelegate, renderParam, dirtyBits):
            pid = self._id
            xf = sceneDelegate.GetTransform(pid)
            kw: Dict[str, Any] = {}
            if xf is not None:
                xf = np.asarray(xf, np.float32)
                eye = xf[3, :3]
                fwd = -xf[2, :3]   # camera looks down -Z (CameraConventions)
                kw["eye"] = tuple(eye)
                kw["target"] = tuple(eye + fwd)
            for token, attr, conv in (("focalLength", None, None),
                                      ("fov", "fov_y", np.radians),
                                      ("clippingRange", None, None)):
                v = sceneDelegate.GetCameraParamValue(pid, token) \
                    if hasattr(sceneDelegate, "GetCameraParamValue") else None
                if v is None:
                    continue
                if token == "fov":
                    kw["fov_y"] = float(np.radians(float(v)))
                elif token == "clippingRange":
                    kw["near_z"], kw["far_z"] = float(v[0]), float(v[1])
            if kw:
                self._cam.set_params(**kw)

        def Finalize(self, renderParam=None):
            pass

    class DfxHdRenderBuffer(Hd.Bprim):
        """Bprim adapter: AOV views over the frame output."""

        def __init__(self, type_id, prim_id, inner: HnRenderDelegate):
            super().__init__()
            self._id = prim_id
            self._inner = inner
            self._buf = None

        def GetId(self):
            return self._id

        def Sync(self, sceneDelegate, renderParam, dirtyBits):
            aov = sceneDelegate.Get(self._id, "aov") or "color"
            self._buf = self._inner.create_bprim(
                "renderBuffer", str(self._id), aov=str(aov))

        def Read(self):
            return None if self._buf is None else self._buf.read()

        def Finalize(self, renderParam=None):
            pass

    class DfxRenderTask(Hd.Task):
        """The frame task: drives HnTaskManager.execute through the inner
        delegate (the HnTaskManager::GetTasks() + HdEngine::Execute
        analogue collapsed into one task — the inner task manager already
        orders the 22-task frame internally)."""

        def __init__(self, inner: HnRenderDelegate, width=512, height=512,
                     camera_id: Optional[str] = None):
            super().__init__()
            self._inner = inner
            self.width = width
            self.height = height
            self.camera_id = camera_id
            self.output = None

        def Sync(self, sceneDelegate=None, taskContext=None, dirtyBits=None):
            pass

        def Prepare(self, taskContext=None, renderIndex=None):
            pass

        def Execute(self, taskContext=None):
            self.output = self._inner.execute(
                self.width, self.height, camera_id=self.camera_id)
            return self.output

    _SPRIM_FACTORY = {"material": DfxHdMaterial, "camera": DfxHdCamera}
    _SPRIM_FACTORY.update({k: DfxHdLight for k in _LIGHT_TYPES})

    class DfxHdRenderDelegate(Hd.RenderDelegate):
        """pxr.HdRenderDelegate implementation backed by HnRenderDelegate
        (HnRenderDelegate.hpp:156-405 method-for-method)."""

        SUPPORTED_RPRIM_TYPES = ("mesh",)
        SUPPORTED_SPRIM_TYPES = ("material", "camera") + tuple(_LIGHT_TYPES)
        SUPPORTED_BPRIM_TYPES = ("renderBuffer",)

        def __init__(self, ci: HnRenderDelegateCreateInfo =
                     HnRenderDelegateCreateInfo(), **inner_kwargs):
            super().__init__()
            self.inner = HnRenderDelegate(ci, **inner_kwargs)
            self._prims: Dict[Any, Any] = {}

        # -- capability queries -------------------------------------------
        def GetSupportedRprimTypes(self):
            return list(self.SUPPORTED_RPRIM_TYPES)

        def GetSupportedSprimTypes(self):
            return list(self.SUPPORTED_SPRIM_TYPES)

        def GetSupportedBprimTypes(self):
            return list(self.SUPPORTED_BPRIM_TYPES)

        def GetRenderParam(self):
            return self.inner.render_param

        def GetResourceRegistry(self):
            return self.inner.texture_registry

        # -- prim factories ------------------------------------------------
        def CreateRprim(self, type_id, prim_id):
            if str(type_id) != "mesh":
                return None
            prim = DfxHdMesh(type_id, prim_id, self.inner)
            self._prims[prim_id] = prim
            return prim

        def CreateSprim(self, type_id, prim_id):
            cls = _SPRIM_FACTORY.get(str(type_id))
            if cls is None:
                return None
            prim = cls(type_id, prim_id, self.inner)
            self._prims[prim_id] = prim
            return prim

        def CreateFallbackSprim(self, type_id):
            return self.CreateSprim(type_id, f"__fallback_{type_id}")

        def CreateBprim(self, type_id, prim_id):
            if str(type_id) != "renderBuffer":
                return None
            prim = DfxHdRenderBuffer(type_id, prim_id, self.inner)
            self._prims[prim_id] = prim
            return prim

        def CreateFallbackBprim(self, type_id):
            return self.CreateBprim(type_id, f"__fallback_{type_id}")

        def _destroy(self, prim):
            if prim is None:
                return
            pid = prim.GetId()
            self._prims.pop(pid, None)
            self.inner.destroy_prim(str(pid))

        DestroyRprim = _destroy
        DestroySprim = _destroy
        DestroyBprim = _destroy

        def CreateRenderPass(self, index=None, collection=None):
            return DfxRenderTask(self.inner)

        def CreateInstancer(self, delegate=None, prim_id=None):
            return None

        def DestroyInstancer(self, instancer):
            pass

        # -- sync/execute hooks -------------------------------------------
        def CommitResources(self, tracker=None):
            self.inner.commit_resources()

        def IsParallelSyncEnabled(self, prim_type=None):
            return self.inner.ci.allow_parallel_sync

    return {
        "RenderDelegate": DfxHdRenderDelegate,
        "Mesh": DfxHdMesh,
        "Material": DfxHdMaterial,
        "Light": DfxHdLight,
        "Camera": DfxHdCamera,
        "RenderBuffer": DfxHdRenderBuffer,
        "RenderTask": DfxRenderTask,
        "material_network_from_hd": material_network_from_hd,
    }


def bind_usd() -> dict:
    """Import real OpenUSD and return the bound adapter classes.  Raises
    ImportError when pxr is absent."""
    import pxr  # noqa: F401
    return build_adapter(pxr)
