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
//     ties go to the first in candidate order (the TPU kernel's chunk
//     argmin takes the first minimum, and chunks merge with strict less).
//   * epilogue: from the winner's setup row, the original triangle id
//     (column 15) and the original-triangle barycentric planes (columns
//     9-14) evaluated at the pixel centre.  A miss keeps the clear values:
//     depth +inf (-inf for reversed depth), id -1, barycentrics 0.
//   Outputs are in tile layout, (tiles, th, tw) each.
//
// What bounds it on an H100: bytes, once the z-loop tests only what its
// inputs need.  At the --csm frame's four 2048^2 shadow cascades the loop
// needs about 40 M candidate-pixel tests inside the candidates' rectangles
// (about 0.6 G flops: microseconds at the fp32 rate), while the outputs are
// 16 B a pixel, 268 MB for the four cascades (80 us at 3.35 TB/s).  Testing
// every candidate on its whole tile cost 1.16 G tests, which set the time.
// The z-loop (csrc/raster_zloop.cuh) culls each candidate to its rectangle,
// scatters the small ones over every thread of the block (the heavy tiles
// of the far cascades) and runs the large ones on warp blocks, with the
// candidate stage overlapping the tests; the epilogue reads each winner's
// setup row with two float4 loads and writes every output once, four pixels
// to a thread in 16-byte stores.  Any tile of a multiple of 8 rows by a
// multiple of 32 columns runs, in passes of 8 warp blocks.
#include "raster_zloop.cuh"

namespace {

struct Args {
  const float* setup;   // (P, 16)
  const int4* rects;    // (P, 4) candidate pixel rectangles
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

template <int R>
__global__ void __launch_bounds__(zloop::kThreads, 2)
raster_tiles_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  zloop::Shared& sh = *reinterpret_cast<zloop::Shared*>(smem);
  __shared__ zloop::Seg segs[2];
  const int tile = blockIdx.x;
  const int tx = tile % a.tiles_x, ty = tile / a.tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* cand_row = a.cand + (size_t)tile * a.cap;
  zloop::Tile t;
  t.x0 = tx * a.tw;
  t.y0 = ty * a.th;
  t.tw = a.tw;
  t.cols = a.tw / 32;                         // warp blocks across the tile
  t.nb = t.cols * (a.th / R);                 // warp blocks in the tile
  t.offx = a.off_x;
  t.offy = a.off_y;
  if (threadIdx.x == 0) {
    segs[0] = {0, 0, t.y0, t.y0 + a.th - 1};
    segs[1] = {max(min(a.counts[tile], a.cap), 0), 0, 0, -1};
  }

  for (t.pass = 0; t.pass < t.nb; t.pass += zloop::kWarps) {
    const int last = min(t.pass + zloop::kWarps, t.nb) - 1;
    t.plo = t.y0 + (t.pass / t.cols) * R;
    t.phi = t.y0 + (last / t.cols) * R + R - 1;
    const int wb = t.pass + warp;
    const int lx = (wb % t.cols) * 32 + lane;   // tile-local column
    zloop::Block b;
    b.active = wb < t.nb;
    b.x0 = t.x0 + lx - lane;
    b.y0 = t.y0 + (wb / t.cols) * R;
    b.key0 = warp * 32 * R;
    b.px = (float)(t.x0 + a.off_x + lx) + 0.5f;
    b.py0 = (float)(b.y0 + a.off_y) + 0.5f;
    zloop::run<R>(a.setup, a.rects, cand_row, segs, 1, sh, t, b, a.sign);

    // ---- epilogue, four pixels a thread: the winner's original id and
    // barycentric planes -----------------------------------------------------
    zloop::for_quads<R>(t, [&](int key0, int ly, int qx) {
      const ulonglong2 k01 =
          *reinterpret_cast<const ulonglong2*>(sh.key + key0);
      const ulonglong2 k23 =
          *reinterpret_cast<const ulonglong2*>(sh.key + key0 + 2);
      const unsigned long long keys[4] = {k01.x, k01.y, k23.x, k23.y};
      const float py = (float)(t.y0 + ly + a.off_y) + 0.5f;
      float z[4], b0[4], b1[4];
      int id[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float zs = __uint_as_float((unsigned)(keys[i] >> 32));
        z[i] = a.sign * zs;
        id[i] = -1;
        b0[i] = b1[i] = 0.0f;
        if (zs < INFINITY) {
          const float px = (float)(t.x0 + a.off_x + qx + i) + 0.5f;
          const float4* s =
              reinterpret_cast<const float4*>(a.setup) +
              (size_t)max(__ldg(cand_row + (unsigned)keys[i]), 0) *
                  (zloop::kSetupDim / 4);
          const float4 p = __ldg(s + 2);      // columns 8-11
          const float4 q = __ldg(s + 3);      // columns 12-15
          b0[i] = (p.y * px + p.z * py) + p.w;
          b1[i] = (q.x * px + q.y * py) + q.z;
          id[i] = (int)q.w;
        }
      }
      const size_t o = (size_t)tile * a.th * a.tw + (size_t)ly * a.tw + qx;
      *reinterpret_cast<float4*>(a.z_out + o) =
          make_float4(z[0], z[1], z[2], z[3]);
      *reinterpret_cast<int4*>(a.id_out + o) =
          make_int4(id[0], id[1], id[2], id[3]);
      *reinterpret_cast<float4*>(a.b0_out + o) =
          make_float4(b0[0], b0[1], b0[2], b0[3]);
      *reinterpret_cast<float4*>(a.b1_out + o) =
          make_float4(b1[0], b1[1], b1[2], b1[3]);
    });
  }
}

}  // namespace

extern "C" int dfx_raster_tiles(
    const void* setup, const void* rects, const void* cand, int cap,
    const void* counts, void* z_out, void* id_out, void* b0_out,
    void* b1_out, int num_tiles, int tiles_x, int th, int tw, int depth_less,
    int off_x, int off_y, void* stream) {
  if (th < 8 || th % 8 || tw < 32 || tw % 32)
    return (int)cudaErrorInvalidValue;   // the wrapper rejects these
  if (num_tiles == 0) return 0;
  Args a;
  a.setup = (const float*)setup;
  a.rects = (const int4*)rects;
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
  const int smem = (int)sizeof(zloop::Shared);
  auto kernel = zloop::block_rows(th, tw) == 16 ? raster_tiles_kernel<16>
                                                : raster_tiles_kernel<8>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles, zloop::kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
