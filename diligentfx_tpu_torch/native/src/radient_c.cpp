// Radient public C API (a copy of the JAX package's native/src/radient_c.cpp)
// — the native analogue of Radient/interface/*.h (reference-counted
// COM-style handles usable from C; RadientTypes.h status codes incl. the
// recoverable PENDING / OUT_OF_DATE / NO_GPU_DATA trio,
// RadientTypes.h:59-80).  This layer owns asset dedup + the scene graph with
// incremental change logs (RadientSceneState.hpp:58-115); the Python side
// consumes `renderables` + world matrices and runs the actual rendering.
//
// Built by native/build.py into one library with dfx_native.cpp; consumed
// via ctypes (radient/c_api.py).

#include <cstdint>
#include <cstring>
#include <atomic>
#include <map>
#include <mutex>
#include <unordered_map>
#include <vector>

extern "C" void dfx_content_hash(const uint8_t*, uint64_t, uint64_t,
                                 uint64_t[2]);

namespace {

// ---- status codes (mirror RadientTypes.h:59-80 / radient/types.py) --------
enum Status : int32_t {
    RT_OK = 0,
    RT_PENDING = 1,
    RT_OUT_OF_DATE = 2,
    RT_NO_GPU_DATA = 3,
    RT_INVALID_ARGUMENT = -1,
    RT_NOT_FOUND = -2,
    RT_FAILED = -3,
    RT_UNSUPPORTED = -4,
};

enum LoadState : int32_t {
    LS_NONE = 0, LS_QUEUED = 1, LS_LOADING = 2,
    LS_LOADED_HOST = 3, LS_COMMITTED = 4, LS_FAILED = 5,
};

enum HandleKind : int32_t {
    HK_NONE = 0, HK_ENGINE = 1, HK_SCENE = 2, HK_MESH = 3, HK_MATERIAL = 4,
};

struct MeshAsset {
    std::vector<float> positions, normals, uvs;
    std::vector<int32_t> indices;
    uint64_t hash[2] = {0, 0};
    int32_t load_state = LS_LOADED_HOST;   // host data arrives synchronously
};

struct MaterialAsset {
    float params[16] = {0};
    int32_t load_state = LS_COMMITTED;     // factors-only: nothing to upload
};

struct Node {
    int32_t parent = -1;
    float local[16];
    int64_t mesh = 0;       // handle (0 = none)
    int64_t material = 0;
    bool visible = true;
    bool alive = true;
};

struct Change {
    uint64_t revision;
    int32_t kind;           // matches radient/scene_state.py ChangeKind
    int32_t node;
};

enum ChangeKind : int32_t {
    CK_ADDED = 0, CK_REMOVED = 1, CK_TRANSFORM = 2, CK_MESH = 3,
    CK_VISIBILITY = 4, CK_MATERIAL = 5,
};

struct Scene {
    std::vector<Node> nodes;
    std::vector<Change> log;
    uint64_t revision = 0;
    uint64_t log_base = 0;              // oldest revision still in the log
    bool world_dirty = true;
    std::vector<float> world_cache;     // nodes * 16
    std::mutex mu;
};

struct Engine {
    int32_t backend = 0;
    std::unordered_map<uint64_t, int64_t> mesh_dedup;  // hash lo -> handle
    std::vector<int64_t> pending_uploads;              // mesh handles
    std::mutex mu;
};

struct Obj {
    std::atomic<int32_t> refs{1};
    int32_t kind = HK_NONE;
    Engine* engine = nullptr;
    Scene* scene = nullptr;
    MeshAsset* mesh = nullptr;
    MaterialAsset* material = nullptr;
};

std::mutex g_mu;
std::vector<Obj*> g_objs;           // handle = index + 1 (0 invalid)

Obj* get(int64_t h, int32_t kind) {
    std::lock_guard<std::mutex> lock(g_mu);
    if (h <= 0 || h > (int64_t)g_objs.size()) return nullptr;
    Obj* o = g_objs[h - 1];
    if (!o || (kind != HK_NONE && o->kind != kind)) return nullptr;
    return o;
}

int64_t put(Obj* o) {
    std::lock_guard<std::mutex> lock(g_mu);
    g_objs.push_back(o);
    return (int64_t)g_objs.size();
}

void ident(float m[16]) {
    std::memset(m, 0, 16 * sizeof(float));
    m[0] = m[5] = m[10] = m[15] = 1.0f;
}

// row-vector 4x4 multiply: out = a @ b
void mul44(const float* a, const float* b, float* out) {
    float t[16];
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
            float s = 0;
            for (int k = 0; k < 4; ++k) s += a[i * 4 + k] * b[k * 4 + j];
            t[i * 4 + j] = s;
        }
    std::memcpy(out, t, sizeof(t));
}

void refresh_world(Scene* s) {
    if (!s->world_dirty) return;
    size_t n = s->nodes.size();
    s->world_cache.assign(n * 16, 0.0f);
    // parents always precede children (nodes append-only), one forward pass
    for (size_t i = 0; i < n; ++i) {
        Node& nd = s->nodes[i];
        if (!nd.alive) continue;
        float* w = &s->world_cache[i * 16];
        if (nd.parent >= 0 && (size_t)nd.parent < i)
            mul44(nd.local, &s->world_cache[nd.parent * 16], w);
        else
            std::memcpy(w, nd.local, 16 * sizeof(float));
    }
    s->world_dirty = false;
}

void log_change(Scene* s, int32_t kind, int32_t node) {
    s->revision++;
    s->log.push_back({s->revision, kind, node});
    // bound the log (the reference's delta-log invalidation: consumers with
    // a base older than log_base get OUT_OF_DATE and must resync fully)
    const size_t kMaxLog = 4096;
    if (s->log.size() > kMaxLog) {
        size_t drop = s->log.size() - kMaxLog;
        s->log_base = s->log[drop - 1].revision;
        s->log.erase(s->log.begin(), s->log.begin() + drop);
    }
}

}  // namespace

extern "C" {

// ---- lifetime (COM-style) --------------------------------------------------

int32_t dfx_rt_retain(int64_t h) {
    Obj* o = get(h, HK_NONE);
    if (!o) return RT_NOT_FOUND;
    o->refs.fetch_add(1);
    return RT_OK;
}

int32_t dfx_rt_release(int64_t h) {
    Obj* o = get(h, HK_NONE);
    if (!o) return RT_NOT_FOUND;
    if (o->refs.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lock(g_mu);
        delete o->engine;
        delete o->scene;
        delete o->mesh;
        delete o->material;
        g_objs[h - 1] = nullptr;
        delete o;
    }
    return RT_OK;
}

int32_t dfx_rt_refcount(int64_t h) {
    Obj* o = get(h, HK_NONE);
    return o ? o->refs.load() : -1;
}

// ---- engine ----------------------------------------------------------------

int64_t dfx_rt_engine_create(int32_t backend_type) {
    Obj* o = new Obj();
    o->kind = HK_ENGINE;
    o->engine = new Engine();
    o->engine->backend = backend_type;
    return put(o);
}

// ---- assets (RadientAssetManager analogue) ---------------------------------

// Creates (or dedups) a mesh asset. out[0] = handle, out[1] = 1 if deduped.
int32_t dfx_rt_create_mesh(int64_t engine_h,
                           const float* positions, const float* normals,
                           const float* uvs, int64_t num_vertices,
                           const int32_t* indices, int64_t num_triangles,
                           int64_t out[2]) {
    Obj* e = get(engine_h, HK_ENGINE);
    if (!e || !positions || !indices || num_vertices <= 0 || num_triangles <= 0)
        return RT_INVALID_ARGUMENT;
    uint64_t hp[2], hi[2];
    dfx_content_hash((const uint8_t*)positions,
                     num_vertices * 3 * sizeof(float), 0x9042, hp);
    dfx_content_hash((const uint8_t*)indices,
                     num_triangles * 3 * sizeof(int32_t), hp[0], hi);
    {
        std::lock_guard<std::mutex> lock(e->engine->mu);
        auto it = e->engine->mesh_dedup.find(hi[0]);
        if (it != e->engine->mesh_dedup.end()) {
            dfx_rt_retain(it->second);
            out[0] = it->second;
            out[1] = 1;
            return RT_OK;
        }
    }
    Obj* m = new Obj();
    m->kind = HK_MESH;
    m->mesh = new MeshAsset();
    m->mesh->positions.assign(positions, positions + num_vertices * 3);
    if (normals) m->mesh->normals.assign(normals, normals + num_vertices * 3);
    if (uvs) m->mesh->uvs.assign(uvs, uvs + num_vertices * 2);
    m->mesh->indices.assign(indices, indices + num_triangles * 3);
    m->mesh->hash[0] = hi[0];
    m->mesh->hash[1] = hi[1];
    int64_t h = put(m);
    {
        std::lock_guard<std::mutex> lock(e->engine->mu);
        e->engine->mesh_dedup[hi[0]] = h;
        e->engine->pending_uploads.push_back(h);
    }
    out[0] = h;
    out[1] = 0;
    return RT_OK;
}

int64_t dfx_rt_create_material(int64_t engine_h, const float params[16]) {
    if (!get(engine_h, HK_ENGINE)) return 0;
    Obj* m = new Obj();
    m->kind = HK_MATERIAL;
    m->material = new MaterialAsset();
    if (params) std::memcpy(m->material->params, params, sizeof(float) * 16);
    return put(m);
}

int32_t dfx_rt_asset_load_state(int64_t h) {
    Obj* o = get(h, HK_NONE);
    if (!o) return RT_NOT_FOUND;
    if (o->mesh) return o->mesh->load_state;
    if (o->material) return o->material->load_state;
    return RT_INVALID_ARGUMENT;
}

// mesh accessors: sizes → out[0] verts, out[1] tris; data via pointers
int32_t dfx_rt_mesh_info(int64_t h, int64_t out[4]) {
    Obj* o = get(h, HK_MESH);
    if (!o) return RT_NOT_FOUND;
    out[0] = (int64_t)(o->mesh->positions.size() / 3);
    out[1] = (int64_t)(o->mesh->indices.size() / 3);
    out[2] = (int64_t)o->mesh->hash[0];
    out[3] = (int64_t)o->mesh->hash[1];
    return RT_OK;
}

int32_t dfx_rt_mesh_read(int64_t h, float* positions, float* normals,
                         float* uvs, int32_t* indices) {
    Obj* o = get(h, HK_MESH);
    if (!o) return RT_NOT_FOUND;
    MeshAsset* m = o->mesh;
    if (positions)
        std::memcpy(positions, m->positions.data(),
                    m->positions.size() * sizeof(float));
    if (normals && !m->normals.empty())
        std::memcpy(normals, m->normals.data(),
                    m->normals.size() * sizeof(float));
    if (uvs && !m->uvs.empty())
        std::memcpy(uvs, m->uvs.data(), m->uvs.size() * sizeof(float));
    if (indices)
        std::memcpy(indices, m->indices.data(),
                    m->indices.size() * sizeof(int32_t));
    return RT_OK;
}

// Per-frame tick (UpdateGPUResources analogue): commits pending host assets.
// Returns the number of assets committed this tick.
int64_t dfx_rt_update_gpu_resources(int64_t engine_h) {
    Obj* e = get(engine_h, HK_ENGINE);
    if (!e) return -1;
    std::vector<int64_t> pending;
    {
        std::lock_guard<std::mutex> lock(e->engine->mu);
        pending.swap(e->engine->pending_uploads);
    }
    int64_t n = 0;
    for (int64_t h : pending) {
        Obj* o = get(h, HK_MESH);
        if (o && o->mesh->load_state == LS_LOADED_HOST) {
            o->mesh->load_state = LS_COMMITTED;
            ++n;
        }
    }
    return n;
}

// ---- scene (RadientSceneState / writer analogue) ---------------------------

int64_t dfx_rt_scene_create(int64_t engine_h) {
    if (!get(engine_h, HK_ENGINE)) return 0;
    Obj* o = new Obj();
    o->kind = HK_SCENE;
    o->scene = new Scene();
    return put(o);
}

int32_t dfx_rt_node_create(int64_t scene_h, int32_t parent) {
    Obj* o = get(scene_h, HK_SCENE);
    if (!o) return -1;
    Scene* s = o->scene;
    std::lock_guard<std::mutex> lock(s->mu);
    if (parent >= (int32_t)s->nodes.size()) return -1;
    Node n;
    n.parent = parent;
    ident(n.local);
    s->nodes.push_back(n);
    int32_t id = (int32_t)s->nodes.size() - 1;
    s->world_dirty = true;
    log_change(s, CK_ADDED, id);
    return id;
}

#define NODE_OP_PROLOGUE                                          \
    Obj* o = get(scene_h, HK_SCENE);                              \
    if (!o) return RT_NOT_FOUND;                                  \
    Scene* s = o->scene;                                          \
    std::lock_guard<std::mutex> lock(s->mu);                      \
    if (node < 0 || node >= (int32_t)s->nodes.size() ||           \
        !s->nodes[node].alive)                                    \
        return RT_NOT_FOUND;

int32_t dfx_rt_node_set_transform(int64_t scene_h, int32_t node,
                                  const float local[16]) {
    NODE_OP_PROLOGUE
    std::memcpy(s->nodes[node].local, local, 16 * sizeof(float));
    s->world_dirty = true;
    log_change(s, CK_TRANSFORM, node);
    return RT_OK;
}

int32_t dfx_rt_node_set_mesh(int64_t scene_h, int32_t node, int64_t mesh_h,
                             int64_t material_h) {
    NODE_OP_PROLOGUE
    s->nodes[node].mesh = mesh_h;
    s->nodes[node].material = material_h;
    log_change(s, CK_MESH, node);
    return RT_OK;
}

int32_t dfx_rt_node_set_visible(int64_t scene_h, int32_t node,
                                int32_t visible) {
    NODE_OP_PROLOGUE
    s->nodes[node].visible = visible != 0;
    log_change(s, CK_VISIBILITY, node);
    return RT_OK;
}

int32_t dfx_rt_node_destroy(int64_t scene_h, int32_t node) {
    NODE_OP_PROLOGUE
    s->nodes[node].alive = false;
    s->world_dirty = true;
    log_change(s, CK_REMOVED, node);
    return RT_OK;
}

uint64_t dfx_rt_scene_revision(int64_t scene_h) {
    Obj* o = get(scene_h, HK_SCENE);
    if (!o) return 0;
    std::lock_guard<std::mutex> lock(o->scene->mu);
    return o->scene->revision;
}

// Incremental change log (RadientSceneState.hpp:58-115 semantics): entries
// with revision > base_revision are copied to out_kinds/out_nodes (cap max).
// Returns count, or RT_OUT_OF_DATE (<0) when base predates the kept log —
// the consumer must resync from the full scene.
int64_t dfx_rt_scene_changes_since(int64_t scene_h, uint64_t base_revision,
                                   int32_t* out_kinds, int32_t* out_nodes,
                                   int64_t cap) {
    Obj* o = get(scene_h, HK_SCENE);
    if (!o) return RT_NOT_FOUND;
    Scene* s = o->scene;
    std::lock_guard<std::mutex> lock(s->mu);
    if (base_revision < s->log_base) return RT_OUT_OF_DATE;
    int64_t n = 0;
    for (const Change& c : s->log) {
        if (c.revision <= base_revision) continue;
        if (n >= cap) return RT_OUT_OF_DATE;   // consumer buffer too small
        out_kinds[n] = c.kind;
        out_nodes[n] = c.node;
        ++n;
    }
    return n;
}

int32_t dfx_rt_scene_node_count(int64_t scene_h) {
    Obj* o = get(scene_h, HK_SCENE);
    if (!o) return -1;
    std::lock_guard<std::mutex> lock(o->scene->mu);
    return (int32_t)o->scene->nodes.size();
}

// World matrices for all nodes (dead nodes get zeros); out = count * 16.
int32_t dfx_rt_scene_world_matrices(int64_t scene_h, float* out) {
    Obj* o = get(scene_h, HK_SCENE);
    if (!o) return RT_NOT_FOUND;
    Scene* s = o->scene;
    std::lock_guard<std::mutex> lock(s->mu);
    refresh_world(s);
    std::memcpy(out, s->world_cache.data(),
                s->world_cache.size() * sizeof(float));
    return RT_OK;
}

// Renderables: visible alive nodes with a mesh (effective visibility walks
// ancestors). Fills out_nodes/out_meshes/out_materials up to cap; returns
// count.
int64_t dfx_rt_scene_renderables(int64_t scene_h, int32_t* out_nodes,
                                 int64_t* out_meshes, int64_t* out_materials,
                                 int64_t cap) {
    Obj* o = get(scene_h, HK_SCENE);
    if (!o) return RT_NOT_FOUND;
    Scene* s = o->scene;
    std::lock_guard<std::mutex> lock(s->mu);
    int64_t n = 0;
    for (int32_t i = 0; i < (int32_t)s->nodes.size(); ++i) {
        const Node& nd = s->nodes[i];
        if (!nd.alive || !nd.mesh) continue;
        bool vis = nd.visible;
        int32_t p = nd.parent;
        while (vis && p >= 0) {
            vis = s->nodes[p].alive && s->nodes[p].visible;
            p = s->nodes[p].parent;
        }
        if (!vis) continue;
        if (n < cap) {
            out_nodes[n] = i;
            out_meshes[n] = nd.mesh;
            out_materials[n] = nd.material;
        }
        ++n;
    }
    return n < cap ? n : cap;
}

}  // extern "C"
