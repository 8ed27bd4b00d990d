"""A fake `pxr` for the port's Hydra front end, and a Kitchen-shaped stage.

OpenUSD is installed neither for the CPU tests nor on the card's machine,
so the port's USD adapter (diligentfx_tpu_torch/hydrogent/usd_adapter.py)
is driven through this shim: the minimal Hd protocol surface the adapter
binds against, and a scene delegate that serves authored prim data by id.
`_Base`, `_ChangeTracker`, `make_fake_pxr`, `FakeMeshTopology` and
`FakeSceneDelegate` are copied from tests/test_usd_adapter.py:16-86 (the JAX
package's shim, which stays where it is); this module imports neither JAX
nor the JAX package, so chip_smoke.py imports it too.

`kitchen_corpus` authors the structures the Kitchen_set exercises, as
tests/test_usd_kitchen_corpus.py `build_kitchen_corpus` does: quad / n-gon
prop topologies, geom subsets with their own materials, UsdPreviewSurface
networks with UsdUVTexture + UsdPrimvarReader_float2 + UsdTransform2d
chains, per-prop transforms, a distant and a sphere light, a camera.  Its
random streams are seeded from each path's CRC-32 (the JAX test seeds a
texture from Python's `hash`, which changes with every process).
"""
import types
import zlib

import numpy as np


class _Base:
    def __init__(self, *a, **k):
        pass


class _ChangeTracker:
    DirtyTopology = 1 << 0
    DirtyPoints = 1 << 1
    DirtyPrimvar = 1 << 2
    DirtyTransform = 1 << 3
    DirtyMaterialId = 1 << 4
    DirtyVisibility = 1 << 5
    AllDirty = (1 << 6) - 1


def make_fake_pxr():
    Hd = types.SimpleNamespace(
        RenderDelegate=_Base, Mesh=_Base, Sprim=_Base, Bprim=_Base,
        Task=_Base, ChangeTracker=_ChangeTracker)
    return types.SimpleNamespace(Hd=Hd)


class FakeMeshTopology:
    def __init__(self, counts, indices, subsets=()):
        self._c, self._i = counts, indices
        self._subsets = subsets

    def GetFaceVertexCounts(self):
        return self._c

    def GetFaceVertexIndices(self):
        return self._i

    def GetGeomSubsets(self):
        return self._subsets


class FakeSceneDelegate:
    """pxr.HdSceneDelegate stand-in: serves authored prim data by id."""

    def __init__(self):
        self.data = {}

    def GetMeshTopology(self, pid):
        return self.data[pid]["topology"]

    def Get(self, pid, name):
        return self.data.get(pid, {}).get(name)

    def GetTransform(self, pid):
        return self.data.get(pid, {}).get("transform", np.eye(4, dtype=np.float32))

    def GetMaterialId(self, pid):
        return self.data.get(pid, {}).get("materialId", "")

    def GetVisible(self, pid):
        return self.data.get(pid, {}).get("visible", True)

    def GetMaterialResource(self, pid):
        return self.data.get(pid, {}).get("material", {})

    def GetLightParamValue(self, pid, token):
        return self.data.get(pid, {}).get(token)

    def GetCameraParamValue(self, pid, token):
        return self.data.get(pid, {}).get(token)


# ---------------------------------------------------------------------------
# the Kitchen-shaped stage
# ---------------------------------------------------------------------------


def _seed(path: str) -> int:
    return zlib.crc32(path.encode())


def grid_mesh(nx, ny, quad=True, ngon_every=0, z=0.0, scale=1.0):
    """Quad-grid topology like Kitchen props; optionally every k-th quad
    pair becomes a pentagon (n-gon fan triangulation).  Returns (points,
    st, face counts, face indices)."""
    xs = np.linspace(-0.5, 0.5, nx + 1) * scale
    ys = np.linspace(-0.5, 0.5, ny + 1) * scale
    pts = [[x, y, z + 0.02 * np.sin(3 * x + 2 * y)] for y in ys for x in xs]
    st = [[(x / scale + 0.5), (y / scale + 0.5)] for y in ys for x in xs]
    counts, indices = [], []
    for j in range(ny):
        for i in range(nx):
            a = j * (nx + 1) + i
            b, c, d = a + 1, a + nx + 2, a + nx + 1
            if ngon_every and (j * nx + i) % ngon_every == 0 and i + 1 < nx:
                counts.append(5)                  # pentagon over two quads
                indices += [a, b, b + 1, c + 1, d]
            elif quad:
                counts.append(4)
                indices += [a, b, c, d]
            else:
                counts += [3, 3]
                indices += [a, b, c, a, c, d]
    return (np.asarray(pts, np.float32), np.asarray(st, np.float32),
            counts, indices)


def node(path, ident, params):
    return types.SimpleNamespace(path=path, identifier=ident,
                                 parameters=params)


def rel(src, src_out, dst, dst_in):
    """HdMaterialRelationship: the input (upstream) node and output, then
    the downstream node and its input."""
    return types.SimpleNamespace(inputId=src, inputName=src_out,
                                 outputId=dst, outputName=dst_in)


def preview_surface_network(mat_path, diffuse, rough, metallic,
                            textured=False, normal_map=False,
                            transform2d=False, tex_size=8):
    """UsdPreviewSurface network in HdMaterialNetworkMap shape, its
    textures (tex_size² RGBA) seeded from the material's path."""
    surf = node(f"{mat_path}/surf", "UsdPreviewSurface",
                {"diffuseColor": diffuse, "roughness": rough,
                 "metallic": metallic})
    nodes, rels = [surf], []
    if textured:
        rng = np.random.default_rng(_seed(mat_path))
        img = rng.random((tex_size, tex_size, 4)).astype(np.float32)
        nodes.append(node(f"{mat_path}/tex", "UsdUVTexture",
                          {"file": img, "wrapS": "repeat",
                           "wrapT": "repeat"}))
        nodes.append(node(f"{mat_path}/st", "UsdPrimvarReader_float2",
                          {"varname": "st"}))
        rels.append(rel(f"{mat_path}/tex", "rgb", f"{mat_path}/surf",
                        "diffuseColor"))
        if transform2d:
            nodes.append(node(f"{mat_path}/xf", "UsdTransform2d",
                              {"scale": (2.0, 2.0), "rotation": 0.0,
                               "translation": (0.25, 0.0)}))
            rels.append(rel(f"{mat_path}/st", "result", f"{mat_path}/xf",
                            "in"))
            rels.append(rel(f"{mat_path}/xf", "result", f"{mat_path}/tex",
                            "st"))
        else:
            rels.append(rel(f"{mat_path}/st", "result", f"{mat_path}/tex",
                            "st"))
    if normal_map:
        rng = np.random.default_rng(_seed(mat_path + "/ntex"))
        nimg = np.full((tex_size, tex_size, 4), 0.5, np.float32)
        nimg[..., :2] += rng.uniform(-0.15, 0.15, (tex_size, tex_size, 2))
        nimg[..., 2] = 1.0
        nodes.append(node(f"{mat_path}/ntex", "UsdUVTexture",
                          {"file": nimg, "wrapS": "repeat",
                           "wrapT": "repeat"}))
        rels.append(rel(f"{mat_path}/ntex", "rgb", f"{mat_path}/surf",
                        "normal"))
    net = types.SimpleNamespace(nodes=nodes, relationships=rels)
    return types.SimpleNamespace(map={"surface": net})


def kitchen_materials(sd, tex_size=8, colors=None):
    """The corpus's 12 material networks: 0-7 textured (2 and 5 with
    normal maps, 1 and 4 through UsdTransform2d), 8-11 constant; `colors`
    overrides (diffuse, roughness, metallic) of materials 8-11.  Returns
    their paths."""
    rng = np.random.default_rng(11)
    mats = []
    for k in range(12):
        mid = f"/Kitchen/Looks/mat{k}"
        diffuse = tuple(rng.uniform(0.2, 0.9, 3).tolist())
        rough = float(rng.uniform(0.2, 0.9))
        metallic = float(k % 3 == 0)
        if colors is not None and k >= 8:
            diffuse, rough, metallic = colors[k - 8]
        sd.data[mid] = {"material": preview_surface_network(
            mid, diffuse=diffuse, rough=rough, metallic=metallic,
            textured=k < 8, normal_map=k in (2, 5), transform2d=k in (1, 4),
            tex_size=tex_size)}
        mats.append(mid)
    return mats


def kitchen_props(sd, mats, n_props=24, density=1, origin=(0.0, 0.0, 0.0),
                  spacing=(1.0, 1.0)):
    """The corpus's props: prop k a (3 + k % 5) x (2 + k % 4) grid (times
    `density` on each axis), quads, triangles (k % 4 == 1), pentagons
    (k % 4 == 2), or quads with two geom subsets (k % 4 == 3), in a 6 x 4
    wall of props around `origin`.  Returns their paths."""
    meshes = []
    ox, oy, oz = origin
    for k in range(n_props):
        pid = f"/Kitchen/Geom/prop{k:03d}"
        kind = k % 4
        pts, st, counts, idx = grid_mesh(
            (3 + k % 5) * density, (2 + k % 4) * density,
            quad=(kind != 1), ngon_every=(7 if kind == 2 else 0),
            scale=0.5 + 0.1 * (k % 6))
        subsets = ()
        if kind == 3 and len(counts) >= 4:
            # two geom subsets with distinct materials (Kitchen cabinets)
            half = len(counts) // 2
            subsets = (
                types.SimpleNamespace(id=f"{pid}/ss0",
                                      materialId=mats[(k + 1) % len(mats)],
                                      indices=list(range(half))),
                types.SimpleNamespace(id=f"{pid}/ss1",
                                      materialId=mats[(k + 2) % len(mats)],
                                      indices=list(range(half, len(counts)))),
            )
        xf = np.eye(4, dtype=np.float32)
        xf[3, :3] = [ox + ((k % 6) - 2.5) * spacing[0],
                     oy + (((k // 6) % 4) - 1.5) * spacing[1],
                     oz - (k % 3) * 0.4]
        sd.data[pid] = {
            "topology": FakeMeshTopology(counts, idx, subsets),
            "points": pts, "st": st, "transform": xf,
            "materialId": mats[k % len(mats)],
        }
        meshes.append(pid)
    return meshes


def look_transform(eye, target):
    """A camera or light prim's transform (row vectors): row 3 the
    position, row 2 the backward axis, so it looks from `eye` at
    `target` down its -Z."""
    eye = np.asarray(eye, np.float64)
    back = eye - np.asarray(target, np.float64)
    back /= np.linalg.norm(back)
    up = np.array([0.0, 1.0, 0.0])
    if abs(back @ up) > 0.99:
        up = np.array([0.0, 0.0, 1.0])
    right = np.cross(up, back)
    right /= np.linalg.norm(right)
    xf = np.eye(4)
    xf[0, :3], xf[1, :3], xf[2, :3], xf[3, :3] = (
        right, np.cross(back, right), back, eye)
    return xf.astype(np.float32)


def kitchen_corpus(sd, n_props=24, density=1, tex_size=8):
    """The whole Kitchen-shaped inventory of the JAX corpus test, in `sd`:
    returns (mesh_ids, material_ids, light_ids, camera_id)."""
    mats = kitchen_materials(sd, tex_size=tex_size)
    meshes = kitchen_props(sd, mats, n_props, density)
    cam_xf = np.eye(4, dtype=np.float32)
    cam_xf[3, :3] = (0.0, 0.0, 6.0)
    sd.data["/Kitchen/cam"] = {"transform": cam_xf,
                               "clippingRange": (0.1, 80.0), "fov": 55.0}
    sd.data["/Kitchen/sun"] = {"color": (1.0, 0.98, 0.9), "intensity": 3.0,
                               "transform": np.eye(4, dtype=np.float32)}
    lxf = np.eye(4, dtype=np.float32)
    lxf[3, :3] = (1.0, 2.0, 2.0)
    sd.data["/Kitchen/bulb"] = {"color": (1.0, 0.8, 0.6), "intensity": 8.0,
                                "radius": 0.1, "transform": lxf}
    return meshes, mats, ["/Kitchen/sun", "/Kitchen/bulb"], "/Kitchen/cam"


def populate(rd, sd, meshes, mats, lights, cam_id, light_types=(
        "distantLight", "sphereLight")):
    """Create every prim through the adapter's factories, Sync all of them
    with every bit dirty and CommitResources.  Returns the prims (meshes,
    then materials, the camera, the lights)."""
    bits = _ChangeTracker.AllDirty
    prims = [rd.CreateRprim("mesh", m) for m in meshes]
    prims += [rd.CreateSprim("material", m) for m in mats]
    prims.append(rd.CreateSprim("camera", cam_id))
    prims += [rd.CreateSprim(t, lid) for t, lid in zip(light_types, lights)]
    for p in prims:
        p.Sync(sd, rd.GetRenderParam(), bits)
    rd.CommitResources(None)
    return prims
