// Multi-tap bounded bilinear warp: out[k, y, x] = bilinear(img) at
// (x + dx_k, y + dy_k) for K offset fields of one (H, W) image, one launch.
//
// Replaces the TPU kernel diligentfx_tpu/ops/warp_pallas.py
// `_warp_multi_kernel` (:181, entry `warp_bilinear_multi_pallas` :227) and
// keeps its semantics exactly; they are the single-tap warp's (csrc/warp.cu):
//   * offsets are clamped to +-(halo - 1) px (the wrapper passes the halos
//     already shrunk for small images, warp_pallas.py:239-240, and the
//     clamps cx, cy);
//   * each 8 x 128 screen tile samples inside one window of win_h x win_w
//     texels whose origin is clamped into the image and rounded down to the
//     8 x 128 grid (:190-194); the window is one tile column wider when the
//     horizontal halo is not a multiple of 128 (:243-245);
//   * window coordinates are clamped to the window, and the x+1 / y+1 taps
//     stay inside it.
// The TPU kernel's row sweep (:210-221) adds only exact zeros to the two
// weighted rows, so each tap k equals the single-tap warp of offsets[k]
// bit for bit; the arithmetic here follows csrc/warp.cu's order.
//
// What bounds it on an H100: bytes.  K taps read 8 B of offset and write
// 4 B a pixel each, the image is read once: about 109 MB for the 16 SSAO
// horizon taps at 544 x 1024 (~33 us at 3.35 TB/s, ~2 flops a byte).  The
// design keeps the TPU kernel's reason to exist, one window load for all K
// taps, and makes the load cheap and overlapped:
//   * one block a 8 x 128 tile; its window's rows arrive by Hopper's bulk
//     copy (cp.async.bulk, one instruction a 16-byte-aligned window row,
//     sent by one warp) onto one mbarrier, and every thread loads its
//     first taps' offsets before it waits for the window;
//   * a thread serves one column and 4 rows of the tile, 2 taps at a time:
//     8 float2 offset loads in flight, then 8 taps from shared memory,
//     stored along x so the (K, H, W) stores coalesce;
//   * at most 80 registers, so 3 blocks of 256 threads stay resident on an
//     SM beside their 61,448 B of shared memory (halo (16, 64));
//   * the launcher raises the dynamic shared-memory limit once a device,
//     not on every launch.
// The fill copies win_h / 8 times the image's rows (15x in all at the SSAO
// taps); a ring of window rows shared by consecutive tiles halved that and
// ran no faster, so it is not kept.  Measured on an H100 (PERF.md, the A/B):
// 0.050-0.052 ms of device time for 16 random taps at 544 x 1024, 63-65%
// of the byte bound (one tile a block, the window filled by scalar loads
// before any tap: 0.113-0.115 ms).  Built with -fmad=false so the lerps
// round like the plain PyTorch version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTileW;         // 2
constexpr int kRows = kTileH / kRowStep;            // rows a thread serves
constexpr int kUnroll = 2;                          // taps a chunk
constexpr int kMinBlocks = 3;                       // resident a SM
constexpr int kMaxSmem = 232448;                    // a block's limit, sm_90
constexpr int kMaxDevices = 64;

// The launch parameters (ops/warp.py `_MultiParams`).
struct Geo {
  int H, W, K, halo_r, halo_c, win_h, win_w;
  float cx, cy;
  int smem;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Wait for the barrier's first phase.  A copy that never lands traps (an
// error the launch reports) instead of spinning for ever.
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
    if (done) return;
    if (spin > (1u << 22)) __trap();
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
warp_multi_kernel(const float* __restrict__ img,
                  const float2* __restrict__ off, float* __restrict__ out,
                  Geo g) {
  extern __shared__ __align__(128) float win[];     // win_h x win_w
  const uint32_t bar = smem_u32(win + g.win_h * g.win_w);
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  int rx = min(max(x0 - g.halo_c, 0), g.W - g.win_w);
  rx = (rx / kTileW) * kTileW;
  int ry = min(max(y0 - g.halo_r, 0), g.H - g.win_h);
  ry = (ry / kTileH) * kTileH;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(1u) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {                           // warp 0 sends the rows
    const uint32_t row_bytes = (uint32_t)g.win_w * 4u;
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"((uint32_t)g.win_h * row_bytes) : "memory");
    __syncwarp();
    for (int r = threadIdx.x; r < g.win_h; r += 32) {
      const float* src = img + (size_t)(ry + r) * g.W + rx;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          ::"r"(smem_u32(win + r * g.win_w)), "l"(src), "r"(row_bytes),
          "r"(bar) : "memory");
    }
  }

  const int xl = threadIdx.x % kTileW;
  const int rl = threadIdx.x / kTileW;
  const int x = x0 + xl;
  const float bx = (float)xl + (float)(x0 - rx);
  const float win_h1 = (float)(g.win_h - 1), win_w1 = (float)(g.win_w - 1);

  // the first chunk's offsets, in flight while the window arrives
  float2 o[kUnroll][kRows];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      o[u][j] = u < g.K
                    ? __ldg(off + ((size_t)u * g.H + y0 + rl + kRowStep * j)
                                      * g.W + x)
                    : make_float2(0.0f, 0.0f);
  mbar_wait(bar);

  for (int k0 = 0; k0 < g.K; k0 += kUnroll) {
    if (k0 > 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (k0 + u < g.K)
            o[u][j] = __ldg(off + ((size_t)(k0 + u) * g.H + y0 + rl
                                   + kRowStep * j) * g.W + x);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u >= g.K) break;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int y = y0 + rl + kRowStep * j;
        const float by = (float)(y - y0) + (float)(y0 - ry);
        const float ox = fminf(fmaxf(o[u][j].x, -g.cx), g.cx);
        const float oy = fminf(fmaxf(o[u][j].y, -g.cy), g.cy);
        float sy = by + oy;
        float sx = bx + ox;
        sy = fminf(fmaxf(sy, 0.0f), win_h1);
        sx = fminf(fmaxf(sx, 0.0f), win_w1);
        const float yf = floorf(sy), xf = floorf(sx);
        const int yi = (int)yf, xi = (int)xf;
        const float fy = sy - yf, fx = sx - xf;
        const int xi1 = min(xi + 1, g.win_w - 1);
        const bool row1 = yi + 1 < g.win_h;
        const float* row0 = win + yi * g.win_w;
        const float* rowb = row1 ? row0 + g.win_w : row0;
        const float a0 = row0[xi], b0 = row0[xi1];
        const float a1 = rowb[xi], b1 = rowb[xi1];
        const float h0 = a0 + (b0 - a0) * fx;
        float v = h0 * (1.0f - fy);
        const float h1 = a1 + (b1 - a1) * fx;
        if (row1) v = v + h1 * fy;
        out[((size_t)(k0 + u) * g.H + y) * g.W + x] = v;
      }
    }
  }
}

}  // namespace

// dfx_warp_bilinear_multi(img, off, out, params, device, stream): the
// wrapper checks shapes, types, contiguity, alignment (16 bytes for the
// image's bulk copies, 8 for the offsets) and that the window fits
// (raising above 232,448 B); params points to the host struct Geo.
// Launches one block a tile on `stream` on `device`, switching the current
// device only when it differs (and back after).
extern "C" int dfx_warp_bilinear_multi(const void* img, const void* off,
                                       void* out, const void* params,
                                       int device, void* stream) {
  static bool smem_set[kMaxDevices];
  const Geo g = *(const Geo*)params;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  if (device >= kMaxDevices || !smem_set[device]) {
    err = cudaFuncSetAttribute(warp_multi_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err == cudaSuccess && device < kMaxDevices) smem_set[device] = true;
  }
  if (err == cudaSuccess) {
    warp_multi_kernel<<<dim3(g.W / kTileW, g.H / kTileH), kThreads, g.smem,
                        (cudaStream_t)stream>>>(
        (const float*)img, (const float2*)off, (float*)out, g);
    err = cudaGetLastError();
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
