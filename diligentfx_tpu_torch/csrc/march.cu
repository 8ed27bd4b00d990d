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
//     t_hit); rows are visited in ascending order, as the reference does,
//     so ties resolve the same way.
// The TPU kernel broadcasts table rows over an 8 x 128 tile and gathers
// columns with a 128-lane take_along_axis (the Mosaic limits).  Here each
// thread walks only its own rows: those of its v-span widened by one row on
// each side (a row outside that range has an empty t-interval, so it could
// not update the result), and reads the table from shared memory.
//
// Design: one block per 8 x 128 tile, one thread per pixel; a table of up
// to 232,448 bytes (454 rows of 128 columns; the launcher opts in to
// Hopper's dynamic shared memory above 48 KB) is staged in shared memory
// once per block.  A taller table, which the reference also marches, takes
// the same kernel reading its rows from global memory through the
// read-only cache (kShared false); the wrapper picks the variant
// (ops/march.py `table_in_shared`).  What bounds it on an H100:
// operations.  A pixel reads 24 bytes and writes 9, but runs about 100
// flops for each table row it crosses (dozens of rows for a ray that
// travels up the screen).  Built with
// -fmad=false and IEEE division so it rounds like the plain PyTorch
// version (ops/march.py `march_dda_plain`).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = kTileH * kTileW;

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// One plane test folded into the running first hit (the reference's fold).
__device__ __forceinline__ void fold(bool ok, float f0, float f1, float eps0,
                                     float win, float t0, float t_span,
                                     float& t_lo, float& t_hit) {
  const bool cross = ok && (f0 <= eps0) && (f1 > 0.0f) && (f1 < win);
  const float denom = f1 - f0;
  const float frac = fabsf(denom) > 1e-12f ? -f0 / denom : 1.0f;
  const float t_star = t0 + clamp01(frac) * t_span;
  if (cross && t_star < t_hit) {
    t_lo = t0;
    t_hit = t_star;
  }
}

template <bool kShared>
__device__ __forceinline__ float texel(const float* row, int x) {
  return kShared ? row[x] : __ldg(row + x);
}

// One sub-interval [t0, t1] of a crossed row.
template <bool kShared>
__device__ __forceinline__ void sub_interval(const float* row, int cols,
                                             float t0, float t1, float ou,
                                             float du, float oz, float dz,
                                             float thick, float& t_lo,
                                             float& t_hit) {
  const float u0 = ou + du * t0;
  const float u1 = ou + du * t1;
  const int x0 = min(max((int)floorf(u0 * (float)cols), 0), cols - 1);
  const int x1 = min(max((int)floorf(u1 * (float)cols), 0), cols - 1);
  const float d0 = texel<kShared>(row, x0);
  const float d1 = texel<kShared>(row, x1);
  const float z0 = oz + dz * t0;
  const float z1 = oz + dz * t1;
  const float slop = fabsf(dz) * (t1 - t0);
  const float win = thick + slop;
  const bool ok = (u0 > 0.0f) && (u0 < 1.0f) && (u1 > 0.0f) && (u1 < 1.0f);
  const float t_span = t1 - t0;
  const float eps0 = 0.5f * slop;
  fold(ok, z0 - d0, z1 - d0, eps0, win, t0, t_span, t_lo, t_hit);
  fold(ok, z0 - d1, z1 - d1, eps0, win, t0, t_span, t_lo, t_hit);
  fold(ok, z0 - d0, z1 - d1, eps0, win, t0, t_span, t_lo, t_hit);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
march_kernel(const float* __restrict__ coarse,
             const float* __restrict__ origin, const float* __restrict__ dir,
             const float* __restrict__ thick_p, float* __restrict__ t_lo_out,
             float* __restrict__ t_hit_out, unsigned char* __restrict__ hit_out,
             int rows, int cols, int W) {
  extern __shared__ float tab_sh[];
  if (kShared) {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads)
      tab_sh[i] = coarse[i];
    __syncthreads();
  }
  const float* tab = kShared ? tab_sh : coarse;

  const int tiles_x = W / kTileW;
  const int y = (blockIdx.x / tiles_x) * kTileH + threadIdx.x / kTileW;
  const int x = (blockIdx.x % tiles_x) * kTileW + threadIdx.x % kTileW;
  const size_t pix = (size_t)y * W + x;
  const float ou = origin[3 * pix], ov = origin[3 * pix + 1],
              oz = origin[3 * pix + 2];
  const float du = dir[3 * pix], dv = dir[3 * pix + 1], dz = dir[3 * pix + 2];
  const float thick = *thick_p;

  const float eps = 1e-7f;
  const bool flat = fabsf(dv) <= eps;
  const float inv_dv = 1.0f / (flat ? eps : dv);
  const float frows = (float)rows;
  const int home_row = min(max((int)floorf(ov * frows), 0), rows - 1);
  int r_begin = home_row, r_end = home_row + 1;
  if (!flat) {
    // the row span of v in [ov, ov + dv], clamped before the int cast
    const float v_end = ov + dv;
    const float lo = fminf(fmaxf(fminf(ov, v_end) * frows, -2.0f), frows);
    const float hi = fminf(fmaxf(fmaxf(ov, v_end) * frows, -2.0f), frows);
    r_begin = max((int)floorf(lo) - 1, 0);
    r_end = min((int)floorf(hi) + 2, rows);
  }

  float t_lo = 2.0f, t_hit = 2.0f;
  for (int r = r_begin; r < r_end; ++r) {
    float tin = 0.0f, tout = 1.0f;
    if (!flat) {
      const float ta = ((float)r / frows - ov) * inv_dv;
      const float tb = (((float)r + 1.0f) / frows - ov) * inv_dv;
      tin = clamp01(fminf(ta, tb));
      tout = clamp01(fmaxf(ta, tb));
      if (!(tout > tin)) continue;
    }
    const float tm = 0.5f * (tin + tout);
    const float* row = tab + r * cols;
    sub_interval<kShared>(row, cols, tin, tm, ou, du, oz, dz, thick, t_lo,
                          t_hit);
    sub_interval<kShared>(row, cols, tm, tout, ou, du, oz, dz, thick, t_lo,
                          t_hit);
  }
  const bool found = t_hit < 1.5f;
  t_lo_out[pix] = found ? t_lo : 0.0f;
  t_hit_out[pix] = found ? t_hit : 1.0f;
  hit_out[pix] = found ? 1 : 0;
}

}  // namespace

// table_in_shared: stage the table in shared memory (rows * cols * 4 bytes,
// at most 232,448: ops/march.py `table_in_shared` decides) or read it from
// global memory.
extern "C" int dfx_march_small_table(const void* coarse, const void* origin,
                                     const void* dir, const void* thick,
                                     void* t_lo, void* t_hit, void* hit,
                                     int rows, int cols, int H, int W,
                                     int table_in_shared, void* stream) {
  if (rows < 1 || cols < 1 || cols > kTileW || H % kTileH || W % kTileW)
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return 0;
  const int blocks = (H / kTileH) * (W / kTileW);
  cudaStream_t st = (cudaStream_t)stream;
  const float* c = (const float*)coarse;
  if (table_in_shared) {
    const size_t smem = (size_t)rows * cols * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        march_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    march_kernel<true><<<blocks, kThreads, smem, st>>>(
        c, (const float*)origin, (const float*)dir, (const float*)thick,
        (float*)t_lo, (float*)t_hit, (unsigned char*)hit, rows, cols, W);
  } else {
    march_kernel<false><<<blocks, kThreads, 0, st>>>(
        c, (const float*)origin, (const float*)dir, (const float*)thick,
        (float*)t_lo, (float*)t_hit, (unsigned char*)hit, rows, cols, W);
  }
  return (int)cudaGetLastError();
}
