// Native host-side runtime for diligentfx_tpu_torch (a copy of the JAX
// package's native/src/dfx_native.cpp).
//
// The analogues of the reference's performance-critical C++ host loops:
//   * content hashing for asset dedup caches
//     (RadientAssetCache keys, RadientMeshAssetManager.hpp:146-148)
//   * geometry-pool suballocation
//     (HnGeometryPool / GLTF::ResourceManager vertex+index pools)
//   * polygon-face triangulation (HnMeshUtils proxy indices)
//   * vertex-stream interleaving (dfx_pack_vertex_streams)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Built by native/build.py at first use: g++ -std=c++17 -O3 -shared -fPIC.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <map>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 128-bit content hash (xxhash3-inspired mixing, self-contained)
// ---------------------------------------------------------------------------

static inline uint64_t rotl64(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

static inline uint64_t mix64(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

void dfx_content_hash(const uint8_t* data, uint64_t len, uint64_t seed,
                      uint64_t out[2]) {
    const uint64_t P1 = 0x9E3779B185EBCA87ULL;
    const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
    const uint64_t P3 = 0x165667B19E3779F9ULL;
    uint64_t h1 = seed ^ (len * P1);
    uint64_t h2 = rotl64(seed, 31) ^ (len * P2);
    const uint8_t* p = data;
    uint64_t n = len;
    while (n >= 16) {
        uint64_t a, b;
        std::memcpy(&a, p, 8);
        std::memcpy(&b, p + 8, 8);
        h1 = rotl64(h1 ^ (a * P2), 27) * P1 + P3;
        h2 = rotl64(h2 ^ (b * P1), 31) * P2 + P3;
        p += 16;
        n -= 16;
    }
    // Tail: n in [1, 15] — read as up to two 8-byte words so every byte
    // enters the hash and nothing writes past an 8-byte buffer.
    if (n) {
        uint64_t tail = 0;
        std::memcpy(&tail, p, n < 8 ? n : 8);
        h1 ^= mix64(tail * P3);
        if (n > 8) {
            uint64_t tail2 = 0;
            std::memcpy(&tail2, p + 8, n - 8);
            h2 ^= mix64(tail2 * P2);
        }
    }
    h1 = mix64(h1 + h2);
    h2 = mix64(h2 ^ h1);
    out[0] = h1;
    out[1] = h2;
}

// ---------------------------------------------------------------------------
// Geometry pool suballocator: first-fit free list with coalescing
// (the IBufferSuballocator / GLTF::ResourceManager analogue)
// ---------------------------------------------------------------------------

struct Pool {
    // free list as offset -> size (ordered)
    std::map<uint64_t, uint64_t> free_blocks;
    std::map<uint64_t, uint64_t> allocations;  // offset -> size
    uint64_t capacity = 0;
    uint64_t used = 0;
    uint64_t peak = 0;
};

static std::vector<Pool*> g_pools;
static std::mutex g_pool_mutex;

int64_t dfx_pool_create(uint64_t capacity) {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    Pool* p = new Pool();
    p->capacity = capacity;
    p->free_blocks[0] = capacity;
    g_pools.push_back(p);
    return (int64_t)g_pools.size() - 1;
}

// Returns offset or -1 when out of space.
int64_t dfx_pool_alloc(int64_t pool, uint64_t size, uint64_t alignment) {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    if (pool < 0 || pool >= (int64_t)g_pools.size() || size == 0) return -1;
    Pool* p = g_pools[pool];
    if (alignment == 0) alignment = 1;
    for (auto it = p->free_blocks.begin(); it != p->free_blocks.end(); ++it) {
        uint64_t off = it->first;
        uint64_t blk = it->second;
        uint64_t aligned = (off + alignment - 1) / alignment * alignment;
        uint64_t pad = aligned - off;
        if (blk < pad + size) continue;
        // carve
        p->free_blocks.erase(it);
        if (pad) p->free_blocks[off] = pad;
        uint64_t rest = blk - pad - size;
        if (rest) p->free_blocks[aligned + size] = rest;
        p->allocations[aligned] = size;
        p->used += size;
        if (p->used > p->peak) p->peak = p->used;
        return (int64_t)aligned;
    }
    return -1;
}

int dfx_pool_free(int64_t pool, uint64_t offset) {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    if (pool < 0 || pool >= (int64_t)g_pools.size()) return -1;
    Pool* p = g_pools[pool];
    auto it = p->allocations.find(offset);
    if (it == p->allocations.end()) return -1;
    uint64_t size = it->second;
    p->allocations.erase(it);
    p->used -= size;
    // insert + coalesce
    auto ins = p->free_blocks.emplace(offset, size).first;
    if (ins != p->free_blocks.begin()) {
        auto prev = std::prev(ins);
        if (prev->first + prev->second == ins->first) {
            prev->second += ins->second;
            p->free_blocks.erase(ins);
            ins = prev;
        }
    }
    auto next = std::next(ins);
    if (next != p->free_blocks.end() &&
        ins->first + ins->second == next->first) {
        ins->second += next->second;
        p->free_blocks.erase(next);
    }
    return 0;
}

void dfx_pool_stats(int64_t pool, uint64_t out[4]) {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    out[0] = out[1] = out[2] = out[3] = 0;
    if (pool < 0 || pool >= (int64_t)g_pools.size()) return;
    Pool* p = g_pools[pool];
    out[0] = p->capacity;
    out[1] = p->used;
    out[2] = p->peak;
    out[3] = (uint64_t)p->free_blocks.size();
}

// ---------------------------------------------------------------------------
// Polygon triangulation: fan-triangulate faces with arbitrary vertex counts
// (HnMeshUtils::Triangulate proxy-index generation)
// ---------------------------------------------------------------------------

// face_counts: number of vertices per face; face_indices: concatenated
// vertex indices. out_tris must hold 3 * sum(max(c-2, 0)) int32.
// Returns the number of triangles written.
int64_t dfx_triangulate_faces(const int32_t* face_counts, int64_t num_faces,
                              const int32_t* face_indices,
                              int32_t* out_tris) {
    int64_t src = 0;
    int64_t t = 0;
    for (int64_t f = 0; f < num_faces; ++f) {
        int32_t c = face_counts[f];
        for (int32_t k = 1; k + 1 < c; ++k) {
            out_tris[t * 3 + 0] = face_indices[src];
            out_tris[t * 3 + 1] = face_indices[src + k];
            out_tris[t * 3 + 2] = face_indices[src + k + 1];
            ++t;
        }
        src += c;
    }
    return t;
}

// ---------------------------------------------------------------------------
// Interleave / pack vertex streams into a pooled buffer region
// ---------------------------------------------------------------------------

// streams: array of pointers; strides in floats; counts = num vertices.
void dfx_pack_vertex_streams(const float** streams, const int32_t* widths,
                             int32_t num_streams, int64_t num_vertices,
                             float* out) {
    int64_t total_w = 0;
    for (int32_t s = 0; s < num_streams; ++s) total_w += widths[s];
    for (int64_t v = 0; v < num_vertices; ++v) {
        float* dst = out + v * total_w;
        for (int32_t s = 0; s < num_streams; ++s) {
            std::memcpy(dst, streams[s] + v * widths[s],
                        widths[s] * sizeof(float));
            dst += widths[s];
        }
    }
}

}  // extern "C"
