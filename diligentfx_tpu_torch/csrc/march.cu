// SSR row-DDA march: per pixel, the first crossing of the screen-space ray
// o + d t (t in [0, 1], in (u, v, ndc z)) with a small min-depth table.
//
// Replaces the TPU kernel diligentfx_tpu/ops/march_pallas.py `_march_kernel`
// (:95, row body `_dda_body` :35, entry `march_small_table_pallas` :175) and
// computes the function of its reference `march_dda_reference` (:230):
//   * v(t) is linear, so the ray crosses table row r in at most one
//     t-interval [tin, tout] = the clipped t's of v = r / rows and
//     (r + 1) / rows; a nearly horizontal ray (|dv| <= 1e-7) lives in its
//     home row for the whole of [0, 1];
//   * each crossed row is split at its midpoint into two sub-intervals; each
//     samples the row at its entry and exit columns and tests the ray
//     against the entry texel's depth plane, the exit texel's, and the mixed
//     entry->exit secant: a crossing from in front (with half a sub-interval
//     of z slack at the entry) to behind within the thickness window;
//   * the running minimum over all rows of the crossing t gives (t_lo,
//     t_hit); rows are visited in ascending order and a candidate replaces
//     the minimum only when strictly smaller, so the first candidate to
//     reach it wins.
// A ray can only cross the rows of its v-span widened by one row on each
// side (ops/march.py `march_row_span` gives them); the other rows have an
// empty t-interval and cannot change the result.
//
// What bounds it on an H100: operations, about 100 instructions for each
// (ray, row) pair (two sub-intervals, three plane tests each) over some 23
// rows a ray at the 1080p bench frame; a ray reads 24 bytes and writes 9.
// The first port (one thread a ray, 1024-thread blocks) ran at about 10% of
// the bound (PERF.md): eight IEEE divisions a row, one block an SM (45
// registers x 1024 threads) in 4.1 waves, and lanes idle while the longest
// ray of their warp walked on (lane efficiency 0.64 at the frame's rays).
// This design:
//   * the row boundaries r / rows are divided once a block (the same fp32
//     quotients) into shared memory beside the table, row r + 1's lower
//     boundary t is row r's upper one, carried, and the crossing t* is
//     divided only where a plane test holds, which is rare;
//   * blocks of 8 x 32 rays, 256 threads, at most 64 registers (2,176
//     blocks at the frame, several an SM); the table is copied with
//     cp.async, its rows at an odd pitch where that fits (neighbouring
//     rows, no bank conflicts), while the threads load their rays;
//   * each block sorts its 256 rays by the rows they walk (a counting sort
//     over 64 buckets, longest first), and warp w marches the sorted rays
//     32w..32w+31: a warp's lanes walk about as far (lane efficiency 0.92
//     at the frame's rays, against 0.64 for a grid row of 32).
// Measured on an H100 (PERF.md): about 0.10-0.11 ms of device time at the
// frame's 544 x 1024 rays, a quarter of the operation bound (0.24 ms and
// a tenth of it before); what is left is instruction issue and latency a
// row.
// Spreading a warp's (ray, row) pairs over its lanes (a prefix sum, a
// binary search and shuffles a pair, a keyed minimum for the first hit)
// made every lane busy but cost more than it saved (PERF.md).
// A table that does not fit in shared memory beside the sort and its row
// boundaries (ops/march.py `march_table_pitch`) is read from global memory
// through the read-only cache, its row boundaries divided where they are
// used.  Built with -fmad=false and IEEE division so it rounds like the
// plain PyTorch version (ops/march.py `march_dda_plain`).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 8;                 // the wrapper's grid: 8 x 128 tiles
constexpr int kTileW = 128;
constexpr int kWarps = 8;                 // a block: 8 x 32 rays, 8 warps
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;
constexpr int kMaxSmem = 232448;          // a block's limit, sm_90
constexpr int kBuckets = 64;              // the sort's walk-length buckets
constexpr int kSortWords = kBuckets + kThreads;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

struct Ray {
  float ou, ov, oz, du, dz, inv_dv;
  bool flat;
};

// Row boundary i / rows: staged in shared memory beside a shared table, or
// divided here.
template <bool kShared>
__device__ __forceinline__ float bound(const float* bnd, int i, float frows) {
  return kShared ? bnd[i] : (float)i / frows;
}

// The three plane tests of one sub-interval [t0, t1] of a row: the entry
// texel's plane (z - d0), the exit texel's (z - d1) and the entry -> exit
// secant, each from f0 at t0 to f1 at t1.
struct Sub {
  float e0, e1, x0, x1, eps0, win, t_span;   // z0 - d0, z1 - d0, z0 - d1, ...
  bool ok;
};

template <bool kShared>
__device__ __forceinline__ float texel(const float* row, int x) {
  return kShared ? row[x] : __ldg(row + x);
}

template <bool kShared>
__device__ __forceinline__ Sub sub_setup(const float* row, int cols, float t0,
                                         float t1, const Ray& ray,
                                         float thick) {
  Sub s;
  const float u0 = ray.ou + ray.du * t0;
  const float u1 = ray.ou + ray.du * t1;
  s.ok = (u0 > 0.0f) && (u0 < 1.0f) && (u1 > 0.0f) && (u1 < 1.0f);
  const int x0 = min(max((int)floorf(u0 * (float)cols), 0), cols - 1);
  const int x1 = min(max((int)floorf(u1 * (float)cols), 0), cols - 1);
  const float d0 = texel<kShared>(row, x0);
  const float d1 = texel<kShared>(row, x1);
  const float z0 = ray.oz + ray.dz * t0;
  const float z1 = ray.oz + ray.dz * t1;
  const float slop = fabsf(ray.dz) * (t1 - t0);
  s.win = thick + slop;
  s.t_span = t1 - t0;
  s.eps0 = 0.5f * slop;
  s.e0 = z0 - d0;
  s.e1 = z1 - d0;
  s.x0 = z0 - d1;
  s.x1 = z1 - d1;
  return s;
}

// plane 0: (z0 - d0, z1 - d0); 1: (z0 - d1, z1 - d1); 2: (z0 - d0, z1 - d1)
__device__ __forceinline__ float plane_f0(const Sub& s, int p) {
  return p == 1 ? s.x0 : s.e0;
}
__device__ __forceinline__ float plane_f1(const Sub& s, int p) {
  return p == 0 ? s.e1 : s.x1;
}

__device__ __forceinline__ bool crosses(const Sub& s, int p) {
  const float f0 = plane_f0(s, p), f1 = plane_f1(s, p);
  return s.ok && (f0 <= s.eps0) && (f1 > 0.0f) && (f1 < s.win);
}

__device__ __forceinline__ float t_star(const Sub& s, int p, float t0) {
  const float f0 = plane_f0(s, p), f1 = plane_f1(s, p);
  const float denom = f1 - f0;
  const float frac = fabsf(denom) > 1e-12f ? -f0 / denom : 1.0f;
  return t0 + clamp01(frac) * s.t_span;
}

// A ray's data and the rows [r_begin, r_end) it walks: those of its v-span
// widened by one row on each side, or a flat ray's home row.
__device__ __forceinline__ void load_ray(const float* __restrict__ origin,
                                         const float* __restrict__ dir,
                                         size_t pix, int rows, float frows,
                                         Ray& ray, int& r_begin, int& r_end) {
  ray.ou = origin[3 * pix];
  ray.ov = origin[3 * pix + 1];
  ray.oz = origin[3 * pix + 2];
  ray.du = dir[3 * pix];
  const float dv = dir[3 * pix + 1];
  ray.dz = dir[3 * pix + 2];
  const float eps = 1e-7f;
  ray.flat = fabsf(dv) <= eps;
  ray.inv_dv = 1.0f / (ray.flat ? eps : dv);
  const int home_row = min(max((int)floorf(ray.ov * frows), 0), rows - 1);
  r_begin = home_row;
  r_end = home_row + 1;
  if (!ray.flat) {
    // the row span of v in [ov, ov + dv], clamped before the int cast
    const float v_end = ray.ov + dv;
    const float lo =
        fminf(fmaxf(fminf(ray.ov, v_end) * frows, -2.0f), frows);
    const float hi =
        fminf(fmaxf(fmaxf(ray.ov, v_end) * frows, -2.0f), frows);
    r_begin = max((int)floorf(lo) - 1, 0);
    r_end = min((int)floorf(hi) + 2, rows);
  }
}

// kShared: the row boundaries and the table (rows x pitch) in shared
// memory, else the table read from global memory and the boundaries divided
// where used.  Dynamic shared memory holds, in order: the sort's buckets and
// order, then (kShared) the boundaries and the table.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
march_kernel(const float* __restrict__ coarse,
             const float* __restrict__ origin, const float* __restrict__ dir,
             const float* __restrict__ thick_p, float* __restrict__ t_lo_out,
             float* __restrict__ t_hit_out, unsigned char* __restrict__ hit_out,
             int rows, int cols, int pitch, int W) {
  extern __shared__ float sh[];
  int* bucket_start = (int*)sh;                      // kBuckets
  int* order = bucket_start + kBuckets;              // kThreads
  float* bnd = sh + kSortWords;                      // rows + 1
  float* tab = bnd + ((rows + 4) & ~3);
  const float frows = (float)rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the table's rows in flight to shared memory while the rays load
  if (kShared) {
    for (int r = warp; r < rows; r += kWarps)
      for (int x = lane; x < cols; x += 32)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         (unsigned)__cvta_generic_to_shared(tab + r * pitch +
                                                            x)),
                     "l"(coarse + r * cols + x) : "memory");
    for (int i = threadIdx.x; i <= rows; i += kThreads)
      bnd[i] = (float)i / frows;
  }
  if (threadIdx.x < kBuckets) bucket_start[threadIdx.x] = 0;
  const float* table = kShared ? tab : coarse;
  const int tpitch = kShared ? pitch : cols;

  // the block: kWarps grid rows of 32 rays
  const int tiles_x = W / 32;
  const size_t y0 = (size_t)(blockIdx.x / tiles_x) * kWarps;
  const int x0 = (blockIdx.x % tiles_x) * 32;
  int me = threadIdx.x;                    // the ray this thread marches
  Ray ray;
  int r_begin, r_end;
  load_ray(origin, dir, (y0 + (me >> 5)) * W + x0 + (me & 31), rows, frows,
           ray, r_begin, r_end);
  // counting sort by min(rows walked, kBuckets - 1), longest first, so
  // that a warp's 32 rays walk about as far (its lanes idle less)
  __syncthreads();
  const int bucket = min(r_end - r_begin, kBuckets - 1);
  const int within = atomicAdd(&bucket_start[bucket], 1);
  __syncthreads();
  if (warp == 0) {
    const int a = bucket_start[lane], b = bucket_start[lane + 32];
    int sa = a, sb = b;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int va = __shfl_up_sync(kFull, sa, d);
      const int vb = __shfl_up_sync(kFull, sb, d);
      if (lane >= d) {
        sa += va;
        sb += vb;
      }
    }
    bucket_start[lane] = sa - a;
    bucket_start[lane + 32] = __shfl_sync(kFull, sa, 31) + sb - b;
  }
  __syncthreads();
  order[kThreads - 1 - (bucket_start[bucket] + within)] = threadIdx.x;
  if (kShared) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  me = order[threadIdx.x];
  load_ray(origin, dir, (y0 + (me >> 5)) * W + x0 + (me & 31), rows, frows,
           ray, r_begin, r_end);
  const float thick = *thick_p;

  // rows in ascending order; a candidate replaces the first hit only when
  // strictly earlier; row r + 1's lower boundary t is row r's upper one
  float t_lo = 2.0f, t_hit = 2.0f;
  float ta = ray.flat ? 0.0f
                      : (bound<kShared>(bnd, r_begin, frows) - ray.ov) *
                            ray.inv_dv;
  for (int r = r_begin; r < r_end; ++r) {
    float tin = 0.0f, tout = 1.0f;         // a flat ray's home row
    if (!ray.flat) {
      const float tb =
          (bound<kShared>(bnd, r + 1, frows) - ray.ov) * ray.inv_dv;
      tin = clamp01(fminf(ta, tb));
      tout = clamp01(fmaxf(ta, tb));
      ta = tb;
      if (!(tout > tin)) continue;
    }
    const float tm = 0.5f * (tin + tout);
    const float* row = table + (size_t)r * tpitch;
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      const float t0 = sub ? tm : tin, t1 = sub ? tout : tm;
      const Sub s = sub_setup<kShared>(row, cols, t0, t1, ray, thick);
      if (!s.ok) continue;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        if (!crosses(s, p)) continue;
        const float t = t_star(s, p, t0);  // divided only here
        if (t < t_hit) {
          t_lo = t0;
          t_hit = t;
        }
      }
    }
  }
  const bool found = t_hit < 1.5f;
  const size_t pix = (y0 + (me >> 5)) * W + x0 + (me & 31);
  t_lo_out[pix] = found ? t_lo : 0.0f;
  t_hit_out[pix] = found ? t_hit : 1.0f;
  hit_out[pix] = found ? 1 : 0;
}

template <bool kShared>
cudaError_t launch(int blocks, size_t smem, cudaStream_t st, const float* c,
                   const void* origin, const void* dir, const void* thick,
                   void* t_lo, void* t_hit, void* hit, int rows, int cols,
                   int pitch, int W) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        march_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  march_kernel<kShared><<<blocks, kThreads, smem, st>>>(
      c, (const float*)origin, (const float*)dir, (const float*)thick,
      (float*)t_lo, (float*)t_hit, (unsigned char*)hit, rows, cols, pitch, W);
  return cudaGetLastError();
}

}  // namespace

// pitch: the table's row pitch in shared memory (cols or more), where the
// sort's 1,280 bytes, the row boundaries' and the table fit in 232,448
// bytes, or 0: the table read from global memory (ops/march.py
// `march_table_pitch` decides).
extern "C" int dfx_march_small_table(const void* coarse, const void* origin,
                                     const void* dir, const void* thick,
                                     void* t_lo, void* t_hit, void* hit,
                                     int rows, int cols, int H, int W,
                                     int pitch, void* stream) {
  if (rows < 1 || cols < 1 || cols > kTileW || H % kTileH || W % kTileW)
    return (int)cudaErrorInvalidValue;
  const size_t sort_bytes = (size_t)kSortWords * 4;
  const size_t smem =
      pitch ? sort_bytes + (size_t)(((rows + 4) & ~3) + rows * pitch) * 4
            : sort_bytes;
  if ((pitch && pitch < cols) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return 0;
  const int blocks = (H / kWarps) * (W / 32);
  cudaStream_t st = (cudaStream_t)stream;
  const float* c = (const float*)coarse;
  if (pitch)
    return (int)launch<true>(blocks, smem, st, c, origin, dir, thick, t_lo,
                             t_hit, hit, rows, cols, pitch, W);
  return (int)launch<false>(blocks, smem, st, c, origin, dir, thick, t_lo,
                            t_hit, hit, rows, cols, cols, W);
}
