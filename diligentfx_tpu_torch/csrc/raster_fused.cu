// Fused tile raster: visibility z-loop + perspective-correct attribute
// interpolation + material-row fetch, one block per screen tile.
//
// Replaces the TPU kernel diligentfx_tpu/ops/raster_pallas.py
// `_fused_tile_kernel_sub` (:261) and `_fused_tile_kernel` (:117) with their
// shared `_fused_epilogue` (:188); one kernel with `sub` as a parameter
// serves both candidate layouts.
//
// What it computes, per tile of th x tw pixels:
//   * z-loop: each candidate triangle's edge planes l0, l1 and l2 = 1-l0-l1
//     (all >= 0 means covered) and its depth plane; the nearest covered
//     candidate wins and ties go to the first in candidate order (strict
//     less in order — the TPU kernel's chunk argmin + strict-less across
//     chunks gives the same winner).  With sub > 0 the candidate table is
//     segmented: segment j (< sub) holds small triangles tested only on
//     rows [j*th/sub, (j+1)*th/sub); the last segment holds big triangles
//     tested on the whole tile.  Smalls run before bigs, as on the TPU.
//   * epilogue: the winner's attribute-plane row (read straight from global
//     memory by candidate id) gives N_c/D per channel, d/dx and d/dy for
//     the deriv channels, the per-triangle constants and the original
//     triangle id (-1 on a miss); const 0 indexes the material table, whose
//     shared-memory copy supplies the material row.  Outputs are written in
//     final layouts: z (H, W), id (H, W), channels (C, H, W).
//   Miss pixels keep slot 0, as the TPU kernel does, so their channels are
//   the first candidate's (garbage that downstream masks).
//
// What bounds it on an H100: bytes.  At the 1080p bench frame it writes
// ~30 f32 per pixel (z, id, 28 channels: ~250 MB, ~75 us at 3.35 TB/s),
// while the z-loop needs only the ~7-9 M candidate-pixel tests whose pixel
// lies inside the candidate's rectangle.  Testing every candidate on all of
// its segment's rows cost 0.1-0.26 G tests and set the time.  The z-loop
// (csrc/raster_zloop.cuh) culls each candidate to its rectangle, scatters
// the small ones over every thread of the block and runs the large ones on
// warp blocks across all segments, with the candidate stage overlapping
// the tests.  The epilogue then writes every output once, four pixels to a
// thread in 16-byte stores.  Any tile of a multiple of 8 rows
// by a multiple of 32 columns and any sub-bin count dividing th runs;
// shared memory holds the stage, a pass's keys and slots, the segment table
// and the material table.  Build with -fmad=false: the plane evaluations
// then round exactly like the plain PyTorch version (no contraction), so
// coverage on exact edges agrees bit for bit.
#include "raster_zloop.cuh"

namespace {

struct Args {
  const float* setup;   // (P, 16)
  const int4* rects;    // (P, 4) candidate pixel rectangles
  const float* planes;  // (P, n_planes)
  const int* cand;      // (num_tiles, cap)
  const int* counts;    // (num_tiles, counts_stride)
  const float* mat;     // (n_mrow, n_mat) or null
  float* z_out;         // (H, W)
  int* id_out;          // (H, W)
  float* ch_out;        // (out_ch, H, W)
  int n_planes, cap, counts_stride, n_mrow, n_mat;
  int tiles_x, th, tw, H, W;
  int sub, cap_sub, big_cap;
  int n_ch, n_const, deriv_mask;
  float sign;
  int off_x, off_y;
};

// Dynamic shared memory: zloop::Shared, then the segment counts (nseg),
// the segment table (nseg + 1 Seg) and the material table (n_mrow * n_mat
// floats).  ops/raster_kernel.py `check_tile_shape` counts the same.
inline size_t dynamic_bytes(int nseg, int n_mrow, int n_mat) {
  return sizeof(zloop::Shared) +
         4 * ((size_t)nseg + 4 * ((size_t)nseg + 1) + (size_t)n_mrow * n_mat);
}

// Four pixels of a row of the epilogue (output offset o, the first's
// pixel-centre x px0): each winner's plane row at its pixel centre, written
// four floats at a time.
__device__ __forceinline__ void shade_quad(const Args& a, const float* mat_sh,
                                           size_t o, float px0, float py,
                                           const float (&z)[4],
                                           const int (&cid)[4]) {
  const size_t plane_hw = (size_t)a.H * a.W;
  const int const0 = 3 + 3 * a.n_ch;
  const float* pr[4];
  float px[4], da[4], db[4], rcp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pr[i] = a.planes + (size_t)cid[i] * a.n_planes;
    px[i] = px0 + (float)i;
    da[i] = __ldg(pr[i]);
    db[i] = __ldg(pr[i] + 1);
    const float den = da[i] * px[i] + db[i] * py + __ldg(pr[i] + 2);
    rcp[i] = 1.0f / (fabsf(den) < 1e-20f ? 1.0f : den);
  }
  auto put = [&](int ch, const float (&v)[4]) {
    *reinterpret_cast<float4*>(a.ch_out + ch * plane_hw + o) =
        make_float4(v[0], v[1], v[2], v[3]);
  };
  int d = 0;
  for (int c = 0; c < a.n_ch; ++c) {
    float val[4], ddx[4], ddy[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pa = __ldg(pr[i] + 3 + 3 * c), pb = __ldg(pr[i] + 4 + 3 * c);
      val[i] = (pa * px[i] + pb * py + __ldg(pr[i] + 5 + 3 * c)) * rcp[i];
      ddx[i] = (pa - val[i] * da[i]) * rcp[i];
      ddy[i] = (pb - val[i] * db[i]) * rcp[i];
    }
    put(c, val);
    if (a.deriv_mask & (1 << c)) {
      put(a.n_ch + 2 * d, ddx);
      put(a.n_ch + 2 * d + 1, ddy);
      ++d;
    }
  }
  const int oc = a.n_ch + 2 * __popc(a.deriv_mask);
  float v[4];
  for (int k = 0; k + 1 < a.n_const; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __ldg(pr[i] + const0 + k);
    put(oc + k, v);
  }
  int id[4], mid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = a.sign * z[i];
    id[i] = z[i] < INFINITY ? (int)__ldg(pr[i] + const0 + a.n_const - 1) : -1;
    mid[i] = min(max((int)__ldg(pr[i] + const0), 0), a.n_mat - 1);
  }
  *reinterpret_cast<float4*>(a.z_out + o) =
      make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<int4*>(a.id_out + o) =
      make_int4(id[0], id[1], id[2], id[3]);
  const int om = oc + a.n_const - 1;
  for (int r = 0; r < a.n_mrow; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = mat_sh[r * a.n_mat + mid[i]];
    put(om + r, v);
  }
}

template <int R>
__global__ void __launch_bounds__(zloop::kThreads, 3)
raster_fused_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  zloop::Shared& sh = *reinterpret_cast<zloop::Shared*>(smem);
  int* dyn = reinterpret_cast<int*>(smem + sizeof(zloop::Shared));
  const int nseg = a.sub > 0 ? a.sub + 1 : 1;
  int* seg_count = dyn;                                          // (nseg)
  zloop::Seg* segs = reinterpret_cast<zloop::Seg*>(dyn + nseg);  // (nseg+1)
  float* mat_sh = reinterpret_cast<float*>(dyn + nseg + 4 * (nseg + 1));

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tile % a.tiles_x, ty = tile / a.tiles_x;
  const int warp = tid >> 5, lane = tid & 31;
  const int* cand_row = a.cand + (size_t)tile * a.cap;
  zloop::Tile t;
  t.x0 = tx * a.tw;
  t.y0 = ty * a.th;
  t.tw = a.tw;
  t.cols = a.tw / 32;                         // warp blocks across the tile
  t.nb = t.cols * (a.th / R);                 // warp blocks in the tile
  t.offx = a.off_x;
  t.offy = a.off_y;

  // segment counts, clamped to their capacities
  for (int s = tid; s < nseg; s += zloop::kThreads) {
    const int* cnt = a.counts + (size_t)tile * a.counts_stride;
    const int cap = a.sub == 0 ? a.cap : s < a.sub ? a.cap_sub : a.big_cap;
    seg_count[s] = max(min(cnt[s], cap), 0);
  }
  for (int e = tid; e < a.n_mrow * a.n_mat; e += zloop::kThreads)
    mat_sh[e] = a.mat[e];
  // a miss keeps slot 0's candidate
  const int id0 = max(__ldg(cand_row), 0);

  for (t.pass = 0; t.pass < t.nb; t.pass += zloop::kWarps) {
    const int last = min(t.pass + zloop::kWarps, t.nb) - 1;
    t.plo = t.y0 + (t.pass / t.cols) * R;
    t.phi = t.y0 + (last / t.cols) * R + R - 1;
    __syncthreads();   // counts loaded; the last pass is done with segs
    if (tid == 0) {
      // segment s: sub-bin s on its rows, then the big segment on the tile
      // (or one segment, the tile); a segment off this pass's rows is empty
      const int rows = a.sub > 0 ? a.th / a.sub : a.th;
      int first = 0;
      for (int s = 0; s < nseg; ++s) {
        const bool small = a.sub > 0 && s < a.sub;
        const int lo = max(t.y0 + (small ? s * rows : 0), t.plo);
        const int hi = min(t.y0 + (small ? (s + 1) * rows : a.th) - 1, t.phi);
        segs[s] = {first, s * a.cap_sub, lo, hi};
        first += lo <= hi ? seg_count[s] : 0;
      }
      segs[nseg] = {first, 0, 0, -1};
    }

    const int wb = t.pass + warp;
    const int lx = (wb % t.cols) * 32 + lane;   // tile-local column
    zloop::Block b;
    b.active = wb < t.nb;
    b.x0 = t.x0 + lx - lane;
    b.y0 = t.y0 + (wb / t.cols) * R;
    b.key0 = warp * 32 * R;
    b.px = (float)(t.x0 + a.off_x + lx) + 0.5f;
    b.py0 = (float)(b.y0 + a.off_y) + 0.5f;
    zloop::run<R>(a.setup, a.rects, cand_row, segs, nseg, sh, t, b, a.sign);

    // ---- epilogue, four pixels a thread: one winner plane row a pixel ----
    zloop::for_quads<R>(t, [&](int key0, int ly, int qx) {
      const ulonglong2 k01 =
          *reinterpret_cast<const ulonglong2*>(sh.key + key0);
      const ulonglong2 k23 =
          *reinterpret_cast<const ulonglong2*>(sh.key + key0 + 2);
      const unsigned long long keys[4] = {k01.x, k01.y, k23.x, k23.y};
      float z[4];
      int cid[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned slot = (unsigned)keys[i];
        z[i] = __uint_as_float((unsigned)(keys[i] >> 32));
        cid[i] = slot == 0 ? id0 : max(__ldg(cand_row + slot), 0);
      }
      shade_quad(a, mat_sh, (size_t)(t.y0 + ly) * a.W + t.x0 + qx,
                 (float)(t.x0 + a.off_x + qx) + 0.5f,
                 (float)(t.y0 + ly + a.off_y) + 0.5f, z, cid);
    });
  }
}

}  // namespace

extern "C" int dfx_raster_fused(
    const void* setup, const void* rects, const void* planes, int n_planes,
    const void* cand, int cap, const void* counts, int counts_stride,
    const void* mat, int n_mrow, int n_mat, void* z_out, void* id_out,
    void* ch_out, int num_tiles, int tiles_x, int th, int tw, int sub,
    int cap_sub, int big_cap, int n_ch, int n_const, int deriv_mask,
    int depth_less, int off_x, int off_y, void* stream) {
  if (th < 8 || th % 8 || tw < 32 || tw % 32 || sub < 0 ||
      (sub > 0 && th % sub))
    return (int)cudaErrorInvalidValue;   // the wrapper rejects these
  if (num_tiles == 0) return 0;
  Args a;
  a.setup = (const float*)setup;
  a.rects = (const int4*)rects;
  a.planes = (const float*)planes;
  a.cand = (const int*)cand;
  a.counts = (const int*)counts;
  a.mat = (const float*)mat;
  a.z_out = (float*)z_out;
  a.id_out = (int*)id_out;
  a.ch_out = (float*)ch_out;
  a.n_planes = n_planes;
  a.cap = cap;
  a.counts_stride = counts_stride;
  a.n_mrow = mat ? n_mrow : 0;
  a.n_mat = n_mat;
  a.tiles_x = tiles_x;
  a.th = th;
  a.tw = tw;
  a.H = (num_tiles / tiles_x) * th;
  a.W = tiles_x * tw;
  a.sub = sub;
  a.cap_sub = cap_sub;
  a.big_cap = big_cap;
  a.n_ch = n_ch;
  a.n_const = n_const;
  a.deriv_mask = deriv_mask;
  a.sign = depth_less ? 1.0f : -1.0f;
  a.off_x = off_x;
  a.off_y = off_y;
  const int nseg = sub > 0 ? sub + 1 : 1;
  const size_t smem = dynamic_bytes(nseg, a.n_mrow, n_mat);
  auto kernel = zloop::block_rows(th, tw) == 16 ? raster_fused_kernel<16>
                                                : raster_fused_kernel<8>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles, zloop::kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
