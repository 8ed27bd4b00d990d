// Bounded bilinear warp: out[y, x, c] = bilinear(img[..., c]) at
// (x + dx, y + dy), all C channels in one launch.
//
// Replaces the TPU kernel diligentfx_tpu/ops/warp_pallas.py `_warp_kernel`
// (:34, entry `warp_bilinear_pallas` :101) and reproduces its clamp
// semantics exactly:
//   * offsets are clamped to +-(halo - 1) px (the wrapper passes the halos
//     already shrunk for small images, warp_pallas.py:118-119, and the
//     clamps cx, cy);
//   * each 8 x 128 screen tile samples inside a window of win_h x win_w
//     texels whose origin is clamped into the image and rounded down to the
//     8 x 128 grid (:46-49); the window is one tile column wider when the
//     horizontal halo is not a multiple of 128 (:127-130);
//   * window coordinates are clamped to the window, and the x+1 / y+1 taps
//     stay inside it (:62-75).
// The arithmetic follows the TPU kernel's order: a horizontal lerp per
// window row, then rows weighted (1 - fy) and fy and summed.
//
// What bounds it on an H100: bytes (8 B of offset + 4 C B in, 4 C B out
// per pixel: 8.3 MB for an SSAO tap at 544 x 1024, C = 1, 2.5 us at 3.35
// TB/s; 24.9 MB for a DoF tap, C = 5 at the same size, 7.4 us; about 2
// flops a byte).  A tap reads its texels through L1/L2 (a pixel's four
// texels land within a few cache lines of its neighbours'); a shared-memory
// window would cost a fill of 15x the tile's pixels for one tap.  One
// kernel a channel class, chosen by the launcher from C, so that every load
// and store instruction of a warp covers consecutive memory:
//   * C = 1, 2, 4: one pixel a thread; its offset one float2 load, each
//     texel one float / float2 / float4 load, its result one store (four or
//     two pixels a thread measured slower: a warp's gathers spanned more);
//   * C = 5 (the DoF taps) and any other C: a thread takes 4 elements
//     (pixel, channel) 32 apart, so a warp's texel loads and stores cover
//     32 consecutive floats of the (H, W, C) image (a texel of 5 floats
//     cannot be one vector load).
// Indices are 32-bit; an image of 2^31 elements or more takes the same
// kernels with 64-bit indices.
// Measured on an H100 (PERF.md, kernel table): 43-60% of the byte bound at
// the frames' shapes, 46% at the DoF taps, where about 3 us of a small
// launch is not bytes.  The wrapper passes the launch parameters as one
// cached struct and the device index; the launcher switches devices only
// when the index differs from the current one.  Built with -fmad=false so
// the lerps round like the plain PyTorch version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = 256;

// The launch parameters (ops/warp.py `_WarpParams`): the image's shape and
// the geometry after the halo shrink.
struct Geo {
  int H, W, C, halo_r, halo_c, win_h, win_w;
  float cx, cy;
};

// One tap: the texel (pixel) indices of its four texels and its weights.
// I is the index type: int, or long long where an image holds 2^31
// elements or more.
template <typename I>
struct Tap {
  I i00, i01, i10, i11;
  float fx, fy;
  bool row1;
};

// The tile's window origin (ry, rx) and the tile's origin (y0, x0).
__device__ __forceinline__ void window_origin(int x, int y, const Geo& g,
                                              int& x0, int& y0, int& rx,
                                              int& ry) {
  y0 = (y / kTileH) * kTileH;
  x0 = (x / kTileW) * kTileW;
  ry = min(max(y0 - g.halo_r, 0), g.H - g.win_h);
  ry = (ry / kTileH) * kTileH;
  rx = min(max(x0 - g.halo_c, 0), g.W - g.win_w);
  rx = (rx / kTileW) * kTileW;
}

template <typename I>
__device__ __forceinline__ Tap<I> make_tap(int x, int y, int x0, int y0,
                                           int rx, int ry, float dx, float dy,
                                           const Geo& g) {
  const float ox = fminf(fmaxf(dx, -g.cx), g.cx);
  const float oy = fminf(fmaxf(dy, -g.cy), g.cy);
  float sy = ((float)(y - y0) + (float)(y0 - ry)) + oy;
  float sx = ((float)(x - x0) + (float)(x0 - rx)) + ox;
  sy = fminf(fmaxf(sy, 0.0f), (float)(g.win_h - 1));
  sx = fminf(fmaxf(sx, 0.0f), (float)(g.win_w - 1));
  const float yf = floorf(sy), xf = floorf(sx);
  const int yi = (int)yf, xi = (int)xf;
  Tap<I> t;
  t.fy = sy - yf;
  t.fx = sx - xf;
  t.row1 = yi + 1 < g.win_h;
  const int xi1 = min(xi + 1, g.win_w - 1);
  const I r0 = (I)(ry + yi) * g.W + rx;
  const I r1 = t.row1 ? r0 + g.W : r0;
  t.i00 = r0 + xi;
  t.i01 = r0 + xi1;
  t.i10 = r1 + xi;
  t.i11 = r1 + xi1;
  return t;
}

// h0 = lerp of row 0, h1 of row 1, then h0 (1 - fy) [+ h1 fy].
template <typename T>
__device__ __forceinline__ float blend(float a0, float b0, float a1, float b1,
                                       const T& t) {
  const float h0 = a0 + (b0 - a0) * t.fx;
  const float v = h0 * (1.0f - t.fy);
  const float h1 = a1 + (b1 - a1) * t.fx;
  return t.row1 ? v + h1 * t.fy : v;
}

template <typename T>
__device__ __forceinline__ float blend_v(float a, float b, float c, float d,
                                         const T& t) {
  return blend(a, b, c, d, t);
}

template <typename T>
__device__ __forceinline__ float2 blend_v(float2 a, float2 b, float2 c,
                                          float2 d, const T& t) {
  return make_float2(blend(a.x, b.x, c.x, d.x, t),
                     blend(a.y, b.y, c.y, d.y, t));
}

template <typename T>
__device__ __forceinline__ float4 blend_v(float4 a, float4 b, float4 c,
                                          float4 d, const T& t) {
  return make_float4(blend(a.x, b.x, c.x, d.x, t),
                     blend(a.y, b.y, c.y, d.y, t),
                     blend(a.z, b.z, c.z, d.z, t),
                     blend(a.w, b.w, c.w, d.w, t));
}

// C = 1, 2, 4: one pixel a thread, its texels as one vector load each
// (float, float2, float4), so each load and store instruction of a warp
// covers 32 consecutive pixels.
template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
warp_tap_vec(const V* __restrict__ img, const float2* __restrict__ off,
             V* __restrict__ out, Geo g) {
  const I p = (I)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (I)g.H * g.W) return;
  const float2 o = __ldg(off + p);
  const int y = (int)(p / g.W);
  const int x = (int)(p - (I)y * g.W);
  int x0, y0, rx, ry;
  window_origin(x, y, g, x0, y0, rx, ry);
  const Tap<I> t = make_tap<I>(x, y, x0, y0, rx, ry, o.x, o.y, g);
  out[p] = blend_v(__ldg(img + t.i00), __ldg(img + t.i01),
                   __ldg(img + t.i10), __ldg(img + t.i11), t);
}

// Elements (pixel, channel) a thread for the other channel counts.
constexpr int kElemsPerThread = 4;

// C = 5 (CC, the DoF taps) and any other C (CC = 0, C at run time): a
// thread takes EP elements (pixel, channel) 32 apart, so a warp's texel
// loads and its stores cover 32 consecutive floats of the (H, W, C) image;
// the C threads of a pixel compute its tap alike.
template <int CC, int EP, typename I>
__global__ void __launch_bounds__(kThreads)
warp_tap_elem(const float* __restrict__ img, const float2* __restrict__ off,
              float* __restrict__ out, Geo g) {
  const int C = CC > 0 ? CC : g.C;
  const I total = (I)g.H * g.W * C;
  const I base = ((I)blockIdx.x * (kThreads / 32) + threadIdx.x / 32)
                 * (32 * EP) + threadIdx.x % 32;
  float2 o[EP];
#pragma unroll
  for (int i = 0; i < EP; ++i)
    if (base + 32 * i < total) o[i] = __ldg(off + (base + 32 * i) / C);
  float v[EP];
#pragma unroll
  for (int i = 0; i < EP; ++i) {
    const I e = base + 32 * i;
    if (e >= total) break;
    const I p = e / C;
    const int ch = (int)(e - p * C);
    const int y = (int)(p / g.W);
    const int x = (int)(p - (I)y * g.W);
    int x0, y0, rx, ry;
    window_origin(x, y, g, x0, y0, rx, ry);
    const Tap<I> t = make_tap<I>(x, y, x0, y0, rx, ry, o[i].x, o[i].y, g);
    v[i] = blend(__ldg(img + t.i00 * C + ch), __ldg(img + t.i01 * C + ch),
                 __ldg(img + t.i10 * C + ch), __ldg(img + t.i11 * C + ch), t);
  }
#pragma unroll
  for (int i = 0; i < EP; ++i)
    if (base + 32 * i < total) out[base + 32 * i] = v[i];
}

// Blocks for `items` work items at `per_thread` a thread.
inline unsigned blocks(long long items, int per_thread) {
  const long long per_block = kThreads * per_thread;
  return (unsigned)((items + per_block - 1) / per_block);
}

// The channel class's kernel for C, with index type I.
template <typename I>
void launch(const void* img, const void* off, void* out, const Geo& g,
            long long n, cudaStream_t s) {
  switch (g.C) {
    case 1:
      warp_tap_vec<float, I><<<blocks(n, 1), kThreads, 0, s>>>(
          (const float*)img, (const float2*)off, (float*)out, g);
      break;
    case 2:
      warp_tap_vec<float2, I><<<blocks(n, 1), kThreads, 0, s>>>(
          (const float2*)img, (const float2*)off, (float2*)out, g);
      break;
    case 4:
      warp_tap_vec<float4, I><<<blocks(n, 1), kThreads, 0, s>>>(
          (const float4*)img, (const float2*)off, (float4*)out, g);
      break;
    case 5:
      warp_tap_elem<5, kElemsPerThread, I>
          <<<blocks(5 * n, kElemsPerThread), kThreads, 0, s>>>(
          (const float*)img, (const float2*)off, (float*)out, g);
      break;
    default:
      warp_tap_elem<0, kElemsPerThread, I>
          <<<blocks(g.C * n, kElemsPerThread), kThreads, 0, s>>>(
          (const float*)img, (const float2*)off, (float*)out, g);
  }
}

// Past this many elements (less a block's reach beyond the last one) a
// 32-bit index would overflow, and the kernels index in 64 bits.
constexpr long long kNarrowElems = 0x7fffffffLL - kThreads * 32;

}  // namespace

// dfx_warp_bilinear(img, off, out, params, device, stream): the wrapper
// checks shapes, types, contiguity and the alignment of the vector loads
// (the image's texel, 4, 8 or 16 bytes, and 8 for the offsets); params is a
// pointer to the host struct Geo.  Launches on `stream` on `device`, and
// switches the current device only when it differs (and back after).
extern "C" int dfx_warp_bilinear(const void* img, const void* off, void* out,
                                 const void* params, int device,
                                 void* stream) {
  const Geo g = *(const Geo*)params;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const long long n = (long long)g.H * g.W;
  if (n > 0 && g.C > 0) {                   // an empty image launches nothing
    if (n * g.C <= kNarrowElems)
      launch<int>(img, off, out, g, n, (cudaStream_t)stream);
    else
      launch<long long>(img, off, out, g, n, (cudaStream_t)stream);
  }
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
