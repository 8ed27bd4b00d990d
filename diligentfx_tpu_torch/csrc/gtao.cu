// Fused GTAO: the whole horizon-slice integral of one pixel in one thread,
// slices x 2 sides x steps depth taps, the projected-normal angle and the
// cosine-weighted arc integral.
//
// Replaces the TPU kernel diligentfx_tpu/ops/gtao_pallas.py `_gtao_kernel`
// (:63, entry `gtao_pallas` :258) and reproduces its semantics:
//   * the depth is edge-padded to the 32 x 128 tile grid by the wrapper
//     (ops/gtao.py), which also passes the halos after the small-image
//     shrink and the window size after widening (:274-287);
//   * a pixel of the 32 x 128 tile (y0, x0) taps inside the window whose
//     origin is clamp(y0 - halo_r, 0, hp - win_h) rounded down to 32 rows and
//     clamp(x0 - halo_c, 0, wp - win_w) rounded down to 128 columns (:76-79);
//     tap offsets clamp to +-(halo - 1) px, window coordinates to the window,
//     and the x+1 / y+1 taps stay inside it, as in the bounded warp;
//   * the interleaved-gradient noise, the slice geometry and the Hastings
//     arccos follow the TPU kernel's formulas and operation order.
// The TPU kernel sweeps the window rows per tap and skips rows outside the
// tap's vertical reach; every row a tap needs lies inside that reach, so
// reading the two rows directly gives the same value.
//
// What bounds it on an H100: operations.  A pixel reads 16 bytes and
// writes 4, but runs slices x (the slice geometry, two arccos, three cosines)
// plus slices x 2 x steps taps of about 170 instructions each (seven IEEE
// divisions, an IEEE square root, the bilinear tap, reconstruction,
// distance and falloff): about 3,500 instructions at 2 slices x 4 steps.
// Design: one thread a pixel in blocks of 2 x 128 pixels (a block lies in
// one 32 x 128 tile, whose window all its taps share); the taps read the
// depth through L1 from global memory; only the h x w pixels the caller
// keeps are computed and stored: the depth stays edge-padded to the tile
// grid, since taps read the padding, while the normals are read only at
// the pixel, unpadded.  Each pixel turns its slices by its own noise, so a
// warp-wide texel load touches 16.9 distinct 32-byte sectors at the 1080p
// frame's inputs; staging each block's tap reach in shared memory by bulk
// copies took those loads off L1 and did not make the kernel faster
// (PERF.md): the tap loop's exact IEEE divisions and square root, not its
// loads, set the time, about a tenth of the operation bound.
// Built with -fmad=false and IEEE division and square root; sinf/cosf are
// the precise library functions, so the kernel rounds like the plain
// PyTorch version on the card.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kBlockX = 128;
constexpr int kBlockY = 2;
constexpr int kMinBlocks = 4;
constexpr double kPi = 3.141592653589793;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Hastings arccos (max error about 7e-5 rad), gtao_pallas.py:54-60.
__device__ __forceinline__ float acos_hastings(float x) {
  const float ax = fabsf(x);
  const float p = sqrtf(fmaxf(1.0f - ax, 0.0f)) *
                  (1.5707288f + ax * (-0.2121144f +
                                      ax * (0.0742610f - 0.0187293f * ax)));
  return x >= 0.0f ? p : (float)kPi - p;
}

__global__ void __launch_bounds__(kBlockX * kBlockY, kMinBlocks)
gtao_kernel(const float* __restrict__ depth, const float* __restrict__ normal,
            const float* __restrict__ sc, float* __restrict__ out, int hp,
            int wp, int h, int w, int halo_r, int halo_c, int win_h,
            int win_w, int num_slices, int num_steps, int fh, int wl) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;               // padding: computed by no one
  const float f_idx = sc[0], radius = sc[1], falloff_from = sc[2],
              falloff_range = sc[3], p00 = sc[4], p11 = sc[5], near = sc[6],
              far = sc[7];

  // the tile's window, rounded down to the tile grid
  const int y0 = (y / kTileH) * kTileH;
  const int x0 = (x / kTileW) * kTileW;
  int ry = min(max(y0 - halo_r, 0), hp - win_h);
  ry = (ry / kTileH) * kTileH;
  int rx = min(max(x0 - halo_c, 0), wp - win_w);
  rx = (rx / kTileW) * kTileW;

  const float py = (float)y, px = (float)x;
  const float xi = px + 0.5f, yi = py + 0.5f;
  const size_t pix = (size_t)y * w + x;

  const float view_z = near * far /
      fmaxf(far - depth[(size_t)y * wp + x] * (far - near), 1e-12f);
  const float x_ndc = xi / (float)wl * 2.0f - 1.0f;
  const float y_ndc = 1.0f - yi / (float)fh * 2.0f;
  const float pos_x = x_ndc * view_z / p00;
  const float pos_y = y_ndc * view_z / p11;
  const float pos_z = -view_z;
  const float inv_len =
      1.0f / sqrtf(fmaxf(pos_x * pos_x + pos_y * pos_y + pos_z * pos_z,
                         1e-12f));
  const float v_x = -pos_x * inv_len;
  const float v_y = -pos_y * inv_len;
  const float v_z = -pos_z * inv_len;

  // interleaved gradient noise (postfx/context.py), global pixel keyed
  const float fo = 5.588238f * (f_idx - 64.0f * floorf(f_idx / 64.0f));
  float m1 = 0.06711056f * (px + fo) + 0.00583715f * (py + fo);
  m1 = m1 - floorf(m1);
  float noise = 52.9829189f * m1;
  noise = noise - floorf(noise);

  float radius_px = radius * p11 * ((float)fh * 0.5f) / fmaxf(view_z, 1e-4f);
  radius_px = clampf(radius_px, 2.0f, (float)max(fh, wl) * 0.25f);

  const float n_x = normal[3 * pix], n_y = normal[3 * pix + 1],
              n_z = normal[3 * pix + 2];
  const float cx = (float)max(halo_c - 1, 0);
  const float cy = (float)max(halo_r - 1, 0);
  const float ryf = (float)ry, rxf = (float)rx;
  const float slice_angle = (float)(kPi / num_slices);
  const float half_pi = (float)(kPi / 2);
  const float falloff_den = fmaxf(falloff_range, 1e-5f);

  float visibility = 0.0f;
  for (int s = 0; s < num_slices; ++s) {
    const float phi = ((float)s + noise) * slice_angle;
    const float cos_p = cosf(phi);
    const float sin_p = sinf(phi);
    const float sdv = cos_p * v_x + sin_p * v_y;
    const float o_x = cos_p - v_x * sdv;
    const float o_y = sin_p - v_y * sdv;
    const float o_z = -v_z * sdv;
    float a_x = o_y * v_z - o_z * v_y;
    float a_y = o_z * v_x - o_x * v_z;
    float a_z = o_x * v_y - o_y * v_x;
    const float a_il =
        1.0f / sqrtf(fmaxf(a_x * a_x + a_y * a_y + a_z * a_z, 1e-12f));
    a_x = a_x * a_il;
    a_y = a_y * a_il;
    a_z = a_z * a_il;
    const float ndota = n_x * a_x + n_y * a_y + n_z * a_z;
    const float np_x = n_x - a_x * ndota;
    const float np_y = n_y - a_y * ndota;
    const float np_z = n_z - a_z * ndota;
    const float np_len =
        sqrtf(fmaxf(np_x * np_x + np_y * np_y + np_z * np_z, 1e-8f));
    const float cos_norm =
        clampf((np_x * v_x + np_y * v_y + np_z * v_z) / np_len, -1.0f, 1.0f);
    const float sgn_n =
        (np_x * o_x + np_y * o_y + np_z * o_z >= 0.0f) ? 1.0f : -1.0f;
    const float n_angle = acos_hastings(cos_norm) * sgn_n;

    float best[2] = {-1.0f, -1.0f};
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const float sgn = side == 0 ? 1.0f : -1.0f;
      for (int step = 0; step < num_steps; ++step) {
        float tt = ((float)step + 0.5f + 0.5f * noise) / (float)num_steps;
        tt = tt * tt;
        const float reach = sgn * tt * radius_px;
        const float off_x = clampf(cos_p * reach, -cx, cx);
        const float off_y = clampf(-sin_p * reach, -cy, cy);

        // bilinear window tap
        const float sy = clampf(py - ryf + off_y, 0.0f, (float)(win_h - 1));
        const float sx = clampf(px - rxf + off_x, 0.0f, (float)(win_w - 1));
        const float yf = floorf(sy), xf = floorf(sx);
        const float fy = sy - yf, fx = sx - xf;
        const int yi0 = (int)yf, xi0 = (int)xf;
        const int xi1 = min(xi0 + 1, win_w - 1);
        const float* row0 = depth + (size_t)(ry + yi0) * wp + rx;
        const float ga0 = row0[xi0], gb0 = row0[xi1];
        const float hv0 = ga0 + (gb0 - ga0) * fx;
        float d = hv0 * (1.0f - fy);
        if (yi0 + 1 < win_h) {
          const float* row1 = row0 + wp;
          const float ga1 = row1[xi0], gb1 = row1[xi1];
          const float hv1 = ga1 + (gb1 - ga1) * fx;
          d = d + hv1 * fy;
        }

        const float su = (xi + off_x) / (float)wl;
        const float sv = (yi + off_y) / (float)fh;
        const float zs = near * far / fmaxf(far - d * (far - near), 1e-12f);
        const float dx = (su * 2.0f - 1.0f) * zs / p00 - pos_x;
        const float dy = (1.0f - sv * 2.0f) * zs / p11 - pos_y;
        const float dz = -zs - pos_z;
        const float dist = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-10f));
        float cos_h = (dx * v_x + dy * v_y + dz * v_z) / dist;
        const float wgt =
            clampf(1.0f - (dist - falloff_from) / falloff_den, 0.0f, 1.0f);
        cos_h = cos_h * wgt - (1.0f - wgt);
        best[side] = fmaxf(best[side], cos_h);
      }
    }

    // side 0 (+dir_px) is the +ortho half-plane: the positive horizon h1
    float h0 = -acos_hastings(clampf(best[1], -1.0f, 1.0f));
    float h1 = acos_hastings(clampf(best[0], -1.0f, 1.0f));
    h0 = n_angle + fmaxf(h0 - n_angle, -half_pi);
    h1 = n_angle + fminf(h1 - n_angle, half_pi);
    const float sin_n =
        sgn_n * sqrtf(fmaxf(1.0f - cos_norm * cos_norm, 0.0f));
    const float arc =
        0.25f * (-cosf(2.0f * h0 - n_angle) + cos_norm + 2.0f * h0 * sin_n) +
        0.25f * (-cosf(2.0f * h1 - n_angle) + cos_norm + 2.0f * h1 * sin_n);
    visibility = visibility + np_len * arc;
  }
  out[pix] = clampf(visibility / (float)num_slices, 0.0f, 1.0f);
}

}  // namespace

// depth: the (hp, wp) edge-padded depth; normal (h, w, 3) and out (h, w):
// the pixels the caller keeps.
extern "C" int dfx_gtao_fused(const void* depth, const void* normal,
                              const void* scalars, void* out, int hp, int wp,
                              int h, int w, int halo_r, int halo_c, int win_h,
                              int win_w, int num_slices, int num_steps,
                              int fh, int wl, void* stream) {
  if (num_slices < 1 || num_steps < 1 || h > hp || w > wp || hp % kTileH ||
      wp % kTileW)
    return (int)cudaErrorInvalidValue;
  if (h == 0 || w == 0) return 0;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  gtao_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)depth, (const float*)normal, (const float*)scalars,
      (float*)out, hp, wp, h, w, halo_r, halo_c, win_h, win_w, num_slices,
      num_steps, fh, wl);
  return (int)cudaGetLastError();
}
