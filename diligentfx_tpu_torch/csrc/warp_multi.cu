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
// design follows the TPU kernel's reason to exist, one window load for all
// K taps: one block per 8 x 128 tile copies the tile's window into shared
// memory with coalesced row loads (61,440 B at halo (16, 64), dynamic
// shared memory above the 48 KB static limit), then every thread computes
// its pixels' K taps from shared memory; x-contiguous threads make the
// offset loads and the (K, H, W) stores coalesce.  Built with -fmad=false
// so the lerps round like the plain PyTorch version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / kTileW;   // tile rows a pass covers

__global__ void __launch_bounds__(kThreads)
warp_multi_kernel(const float* __restrict__ img, const float* __restrict__ off,
                  float* __restrict__ out, int H, int W, int K, int halo_r,
                  int halo_c, int win_h, int win_w, float cx, float cy) {
  extern __shared__ float win[];                    // win_h x win_w
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  int ry = min(max(y0 - halo_r, 0), H - win_h);
  ry = (ry / kTileH) * kTileH;
  int rx = min(max(x0 - halo_c, 0), W - win_w);
  rx = (rx / kTileW) * kTileW;

  const int n = win_h * win_w;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / win_w;
    const int c = i - r * win_w;
    win[i] = img[(size_t)(ry + r) * W + rx + c];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x % kTileW;
  const float bx = (float)(x - x0) + (float)(x0 - rx);
  for (int y = y0 + threadIdx.x / kTileW; y < y0 + kTileH; y += kRowsPerPass) {
    const float by = (float)(y - y0) + (float)(y0 - ry);
    for (int k = 0; k < K; ++k) {
      const size_t pix = ((size_t)k * H + y) * W + x;
      const float ox = fminf(fmaxf(off[2 * pix], -cx), cx);
      const float oy = fminf(fmaxf(off[2 * pix + 1], -cy), cy);
      float sy = by + oy;
      float sx = bx + ox;
      sy = fminf(fmaxf(sy, 0.0f), (float)(win_h - 1));
      sx = fminf(fmaxf(sx, 0.0f), (float)(win_w - 1));
      const float yf = floorf(sy), xf = floorf(sx);
      const int yi = (int)yf, xi = (int)xf;
      const float fy = sy - yf, fx = sx - xf;
      const int xi1 = min(xi + 1, win_w - 1);
      const float* row0 = win + yi * win_w;
      const float ga0 = row0[xi];
      const float gb0 = row0[xi1];
      const float h0 = ga0 + (gb0 - ga0) * fx;
      float v = h0 * (1.0f - fy);
      if (yi + 1 < win_h) {
        const float* row1 = row0 + win_w;
        const float ga1 = row1[xi];
        const float gb1 = row1[xi1];
        const float h1 = ga1 + (gb1 - ga1) * fx;
        v = v + h1 * fy;
      }
      out[pix] = v;
    }
  }
}

}  // namespace

// The window's bytes must not exceed what one block may use (the wrapper
// checks against 232,448 B and raises above it).
extern "C" int dfx_warp_bilinear_multi(const void* img, const void* off,
                                       void* out, int H, int W, int K,
                                       int halo_r, int halo_c, int win_h,
                                       int win_w, float cx, float cy,
                                       void* stream) {
  const int smem = win_h * win_w * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      warp_multi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(W / kTileW, H / kTileH);
  warp_multi_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)off, (float*)out, H, W, K, halo_r,
      halo_c, win_h, win_w, cx, cy);
  return (int)cudaGetLastError();
}
