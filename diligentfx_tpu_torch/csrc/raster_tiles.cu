// Two-pass tile raster: the per-tile visibility z-loop that emits depth,
// the original triangle id and the original triangle's barycentrics, one
// block per screen tile.
//
// Replaces the TPU kernel diligentfx_tpu/ops/raster_pallas.py
// `_raster_tile_kernel` (:35), entry `raster_tiles_pallas` (:496).
//
// What it computes, per tile of th x tw pixels (pixel centres are global:
// the integer tile origin plus the viewport offset, converted to float,
// plus 0.5):
//   * z-loop over the tile's first min(count, cap) candidates, in order:
//     the candidate's edge planes l0, l1 and l2 = 1-l0-l1 (all >= 0 means
//     covered) and its depth plane; the nearest covered candidate wins and
//     ties go to the first in candidate order.  One strict-less test per
//     candidate in order gives the TPU kernel's winner (its chunk argmin
//     takes the first minimum, and chunks merge with strict less).
//   * epilogue: from the winner's setup row, the original triangle id
//     (column 15) and the original-triangle barycentric planes (columns
//     9-14) evaluated at the pixel centre.  A miss keeps the clear values:
//     depth +inf (-inf for reversed depth), id -1, barycentrics 0.
//   Outputs are in tile layout, (tiles, th, tw) each.
//
// What bounds it on an H100: operations.  At the --csm frame's shadow
// cascades (1024 tiles of 32 x 128 at 2048^2, up to 1,103 candidates a
// tile) the z-loop is about 1.2 G candidate-pixel tests of ~14 flops a
// frame, while the outputs are 16 B a pixel.  So the per-pixel running
// (z, slot) stays in registers (each thread owns th*tw/256 pixels), the
// candidates' nine plane coefficients are staged through shared memory a
// chunk at a time (one global read per candidate per block), and every
// output is written once with coalesced stores.  Built with -fmad=false,
// the plane evaluations (a*px + b*py) + c round exactly like the plain
// PyTorch version, so coverage on shared edges agrees bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kStage = 64;      // candidates staged in shared memory per round
constexpr int kCoefs = 9;       // l0 (a,b,c), l1 (a,b,c), z (a,b,c)
constexpr int kSetupDim = 16;   // setup row width (raster._triangle_setup)

struct Args {
  const float* setup;   // (P, 16)
  const int* cand;      // (num_tiles, cap)
  const int* counts;    // (num_tiles,)
  float* z_out;         // (num_tiles, th, tw)
  int* id_out;
  float* b0_out;
  float* b1_out;
  int cap, tiles_x, th, tw;
  float sign;
  int off_x, off_y;
};

template <int NK>
__global__ void __launch_bounds__(kThreads)
raster_tiles_kernel(Args a) {
  __shared__ float stage[kStage * kCoefs];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int npx = a.th * a.tw;
  const float x0 = (float)((tile % a.tiles_x) * a.tw + a.off_x);
  const float y0 = (float)((tile / a.tiles_x) * a.th + a.off_y);
  const int* cand_row = a.cand + (size_t)tile * a.cap;
  const int count = max(min(a.counts[tile], a.cap), 0);

  float zr[NK];
  int sr[NK];
  float pxr[NK], pyr[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int p = tid + k * kThreads;
    zr[k] = INFINITY;
    sr[k] = 0;
    pxr[k] = x0 + (float)(p % a.tw) + 0.5f;
    pyr[k] = y0 + (float)(p / a.tw) + 0.5f;
  }

  for (int base = 0; base < count; base += kStage) {
    const int n = min(kStage, count - base);
    __syncthreads();  // previous round's stage fully consumed
    for (int e = tid; e < n * kCoefs; e += kThreads) {
      const int j = e / kCoefs;
      const int id = max(cand_row[base + j], 0);
      stage[e] = a.setup[(size_t)id * kSetupDim + (e - j * kCoefs)];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* s = stage + j * kCoefs;
      const float a0 = s[0], b0 = s[1], c0 = s[2];
      const float a1 = s[3], b1 = s[4], c1 = s[5];
      const float az = s[6], bz = s[7], cz = s[8];
      const int sl = base + j;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const float l0 = a0 * pxr[k] + b0 * pyr[k] + c0;
        const float l1 = a1 * pxr[k] + b1 * pyr[k] + c1;
        const float l2 = 1.0f - l0 - l1;
        const float zc = a.sign * (az * pxr[k] + bz * pyr[k] + cz);
        if (l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f && zc < zr[k]) {
          zr[k] = zc;
          sr[k] = sl;
        }
      }
    }
  }

  // ---- epilogue: the winner's original id and barycentric planes --------
  const size_t o0 = (size_t)tile * npx;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int p = tid + k * kThreads;
    const bool hit = zr[k] < INFINITY;
    int id = -1;
    float bary0 = 0.0f, bary1 = 0.0f;
    if (hit) {
      const float* s = a.setup + (size_t)max(cand_row[sr[k]], 0) * kSetupDim;
      bary0 = s[9] * pxr[k] + s[10] * pyr[k] + s[11];
      bary1 = s[12] * pxr[k] + s[13] * pyr[k] + s[14];
      id = (int)s[15];
    }
    a.z_out[o0 + p] = a.sign * zr[k];
    a.id_out[o0 + p] = id;
    a.b0_out[o0 + p] = bary0;
    a.b1_out[o0 + p] = bary1;
  }
}

}  // namespace

extern "C" int dfx_raster_tiles(
    const void* setup, const void* cand, int cap, const void* counts,
    void* z_out, void* id_out, void* b0_out, void* b1_out, int num_tiles,
    int tiles_x, int th, int tw, int depth_less, int off_x, int off_y,
    void* stream) {
  Args a;
  a.setup = (const float*)setup;
  a.cand = (const int*)cand;
  a.counts = (const int*)counts;
  a.z_out = (float*)z_out;
  a.id_out = (int*)id_out;
  a.b0_out = (float*)b0_out;
  a.b1_out = (float*)b1_out;
  a.cap = cap;
  a.tiles_x = tiles_x;
  a.th = th;
  a.tw = tw;
  a.sign = depth_less ? 1.0f : -1.0f;
  a.off_x = off_x;
  a.off_y = off_y;
  cudaStream_t st = (cudaStream_t)stream;
  switch (th * tw / kThreads) {
    case 4: raster_tiles_kernel<4><<<num_tiles, kThreads, 0, st>>>(a); break;
    case 8: raster_tiles_kernel<8><<<num_tiles, kThreads, 0, st>>>(a); break;
    case 16: raster_tiles_kernel<16><<<num_tiles, kThreads, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;  // the wrapper rejects these
  }
  return (int)cudaGetLastError();
}
