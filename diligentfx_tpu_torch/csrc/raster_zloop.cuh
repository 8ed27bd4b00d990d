// The visibility z-loop of the two tile rasters, K4 (csrc/raster_tiles.cu)
// and K1 (csrc/raster_fused.cu): for every pixel of a screen tile, the
// nearest candidate triangle whose three edge planes cover the pixel centre,
// ties to the first in candidate order.
//
// What bounds the loop on an H100, and what this design does about it:
//   * Wasted tests.  Testing every candidate at every pixel of its tile (or
//     sub-bin rows) costs 12-37x the (candidate, pixel) pairs whose pixel
//     lies inside the candidate's screen rectangle, and the time follows the
//     tests.  Each candidate therefore carries a conservative pixel
//     rectangle (ops/raster.py `candidate_rects`: every pixel the fp32 test
//     can find covered lies inside it), and only pixels inside it are
//     tested.  A skipped pair is one the test finds uncovered.
//   * Latency and balance.  Culled, a candidate is a few dependent shared-
//     memory loads and plane evaluations, and the cascades' heavy tiles
//     hold up to a thousand small candidates, tests on up to 28 times the
//     tile's pixels: left to the warps that own those pixels, they would
//     run one after another on a few warps.  So a small candidate (its
//     rectangle, clipped to the tile, its segment and the pass, holds at
//     most kScatterMax pixels) is scattered: the pixels of a group's small
//     candidates are shared out evenly, a contiguous run of them to each
//     thread of the block, and each covered pixel's (z, slot) is folded into
//     a 64-bit key in shared memory with atomicMin (read first: keys only
//     fall, so the atomic runs only for a nearer candidate).  A large
//     candidate is tested on compact warp blocks: each warp owns 32 columns
//     x R rows, one column a lane, the R running depths in registers and
//     their slots in shared memory (written only when a depth improves),
//     skips a candidate whose rectangle misses its block and tests four
//     register rows at a time only where the rectangle's rows meet them
//     (warp-uniform branches, no dynamic register indexing, four
//     independent chains).  The two partial results merge per pixel at the
//     end of the loop, and the epilogues then read the pass's winners from
//     shared memory four pixels to a thread and write 16-byte vectors.
//   * Stage.  Candidates are staged in shared memory 64 at a time (slot,
//     segment rows, the nine plane coefficients as three float4, the
//     rectangle as one int4), double-buffered with cp.async: the next
//     group's copies are in flight while the current group is tested, and
//     the candidate ids of the group after that are loaded into registers
//     ahead of use.
//   * Tile shape.  A tile of th x tw pixels (th a multiple of 8, tw of 32)
//     is covered in passes of up to kWarps warp blocks; each pass streams
//     the candidates of the segments that meet its rows.
//   * Segments.  A tile's candidate list is a run of segments, each tested
//     only on its own rows (K1's sub-bins; K4 has one segment, the tile); a
//     candidate's rows are its rectangle's, clamped to its segment's.
//   * Exactness.  Both routes evaluate the plain version's expressions in
//     its operation order, (a*px + b*py) + c for each plane and
//     l2 = (1 - l0) - l1, built with -fmad=false.  The block route takes a
//     winner on strict less in candidate order; the key is (z mapped to an
//     order-preserving uint32, slot), with -0.0 made +0.0 first and a NaN
//     or +inf depth never entered, so its minimum is the same winner: the
//     nearest, ties to the lowest slot, which is the first in order.  A key
//     winner at depth 0 has its depth recomputed, keeping the sign of zero.
//   * Tensor cores do not apply: each test is a 3-term fp32 plane
//     evaluation that must round exactly like the plain version, and TF32
//     or bf16 operands would move coverage on shared edges.
//   * Registers.  K1 runs three blocks an SM (80 registers), K4, whose
//     epilogue holds four setup rows, two; neither spills.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace zloop {

constexpr int kWarps = 8;                  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 64;                 // candidates a stage buffer
constexpr int kSetupDim = 16;              // setup row width (floats)
constexpr int kRowsMax = 16;               // rows a warp block holds, at most
constexpr int kPassPx = kWarps * 32 * kRowsMax;
constexpr int kScatterMax = 512;           // pixels of a scattered candidate
// no candidate yet: depth +inf (mapped) and the largest slot
constexpr unsigned long long kEmptyKey = 0xFF800000FFFFFFFFull;

// One segment of a tile's candidate list: stream positions [first, the next
// segment's first) are the slots from slot0 of the tile's candidate row, and
// are tested on framebuffer rows [lo, hi].
struct Seg {
  int first, slot0, lo, hi;
};

struct __align__(16) Stage {
  float4 coef[2][kStage][3];   // setup columns 0-11 (0-8: l0, l1, z planes)
  int4 rect[2][kStage];        // x0, y0, x1, y1: framebuffer pixels, inclusive
  int slot[2][kStage];         // position in the tile's candidate row
  int lo[2][kStage];           // the segment's rows
  int hi[2][kStage];
};
static_assert(sizeof(Stage) == 9728, "Stage layout changed");

// What a block shares in shared memory: the stage and one pass's keys.
struct Shared {
  Stage st;
  unsigned long long key[kPassPx];
  int slot[kPassPx];           // the block route's winning slot a pixel
};
// ops/raster_kernel.py SHARED_BYTES: dynamic shared memory, as it is over
// the 48 KB a block gets without opting in
static_assert(sizeof(Shared) == 58880, "Shared layout changed");

// A tile and one pass over it.
struct Tile {
  int x0, y0;        // framebuffer column and row of the tile's first pixel
  int tw;            // columns
  int cols, nb;      // warp blocks across the tile, in the tile
  int pass;          // the pass's first warp block
  int plo, phi;      // framebuffer rows the pass covers
  int offx, offy;    // viewport offset of the pixel centres
};

// This warp's block of 32 columns x R rows in a pass.
struct Block {
  bool active;       // the pass has a block for this warp
  int x0, y0;        // framebuffer column and row of its first pixel
  int key0;          // its first pixel's key
  float px;          // this lane's pixel-centre x
  float py0;         // the first row's pixel-centre y
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// float -> uint32 preserving order (no NaN), and back
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// The candidate's rectangle clipped to the tile's columns and to the rows
// of its segment and of the pass; false when empty.
__device__ __forceinline__ bool clip_rect(const Stage& st, int buf, int j,
                                          const Tile& t, int& x0, int& y0,
                                          int& x1, int& y1) {
  const int4 r = st.rect[buf][j];
  x0 = max(r.x, t.x0);
  x1 = min(r.z, t.x0 + t.tw - 1);
  y0 = max(r.y, max(st.lo[buf][j], t.plo));
  y1 = min(r.w, min(st.hi[buf][j], t.phi));
  return x0 <= x1 && y0 <= y1;
}

// Inclusive prefix sum across the warp.
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Candidate j's entry of a pair of per-lane values (lane l holds candidate
// l in `a`, candidate l + 32 in `b`).
__device__ __forceinline__ int pick(int a, int b, int j) {
  const int x = __shfl_sync(0xFFFFFFFFu, a, j & 31);
  const int y = __shfl_sync(0xFFFFFFFFu, b, j & 31);
  return j < 32 ? x : y;
}

// A run of `count` pixel jobs of the small candidates, from job i of
// candidate c on (the jobs of a candidate are the pixels of its clipped
// rectangle, row by row): each covered pixel's (z, slot) is folded into
// its key.
template <int R>
__device__ __forceinline__ void scatter_run(const Stage& st, int buf, int c,
                                            int i, int count,
                                            const unsigned (&small)[2],
                                            const Tile& t, float sign,
                                            unsigned long long* key) {
  int x0, y0, x1, y1;
  float4 q0, q1;
  float cz;
  unsigned slot;
  auto enter = [&](int j) {
    clip_rect(st, buf, j, t, x0, y0, x1, y1);
    q0 = st.coef[buf][j][0];   // a0 b0 c0 a1
    q1 = st.coef[buf][j][1];   // b1 c1 az bz
    cz = st.coef[buf][j][2].x;
    slot = (unsigned)st.slot[buf][j];
  };
  enter(c);
  int dy = i / (x1 - x0 + 1);
  int dx = i - dy * (x1 - x0 + 1);
  for (int n = 0; n < count; ++n) {
    const int gx = x0 + dx, gy = y0 + dy;
    // the pixel's key: its warp block must be in this pass
    const int lx = gx - t.x0, ly = gy - t.y0;
    const int wb = (ly / R) * t.cols + (lx >> 5) - t.pass;
    if (wb >= 0 && wb < kWarps && wb + t.pass < t.nb) {
      const float px = (float)(gx + t.offx) + 0.5f;
      const float py = (float)(gy + t.offy) + 0.5f;
      const float l0 = (q0.x * px + q0.y * py) + q0.z;
      const float l1 = (q0.w * px + q1.x * py) + q1.y;
      const float l2 = 1.0f - l0 - l1;
      const float zc = sign * ((q1.z * px + q1.w * py) + cz);
      if (l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f && zc < INFINITY) {
        // keys only fall, so a key already at or below this one stays the
        // minimum: the atomic (a compare-and-swap loop for 64 bits) runs
        // only for a candidate that is nearer than the key it reads
        unsigned long long* p = key + wb * 32 * R + (ly % R) * 32 + (lx & 31);
        const unsigned long long k =
            ((unsigned long long)ordered(zc + 0.0f) << 32) | slot;
        if (k < *(volatile unsigned long long*)p) atomicMin(p, k);
      }
    }
    if (gx < x1) {
      ++dx;
    } else if (gy < y1) {
      dx = 0;
      ++dy;
    } else if (n + 1 < count) {   // the next small candidate
      const int j = c + 1;
      const unsigned m0 = j < 32 ? small[0] & (~0u << j) : 0u;
      c = m0 ? __ffs(m0) - 1 : 31 + __ffs(small[1] & (~0u << max(j - 32, 0)));
      enter(c);
      dx = dy = 0;
    }
  }
}

// A large candidate on this warp's block: strict less in candidate order.
template <int R>
__device__ __forceinline__ void test_block(const Stage& st, int buf, int j,
                                           const Block& b, float sign,
                                           float (&zr)[R], int* bslot) {
  const int4 r = st.rect[buf][j];
  // the rows to test, relative to the block: the rectangle's, within the
  // segment's and the block's
  const int klo = max(r.y, max(st.lo[buf][j], b.y0)) - b.y0;
  const int khi = min(r.w, min(st.hi[buf][j], b.y0 + R - 1)) - b.y0;
  if (r.x > b.x0 + 31 || r.z < b.x0 || klo > khi) return;   // warp-uniform
  const float4 q0 = st.coef[buf][j][0];
  const float4 q1 = st.coef[buf][j][1];
  const float cz = st.coef[buf][j][2].x;
  const int slot = st.slot[buf][j];
  const float ax0 = q0.x * b.px, ax1 = q0.w * b.px, axz = q1.z * b.px;
#pragma unroll
  for (int k0 = 0; k0 < R; k0 += 4) {
    if (k0 + 3 < klo || k0 > khi) continue;                   // warp-uniform
#pragma unroll
    for (int k = k0; k < k0 + 4; ++k) {
      const float py = b.py0 + (float)k;
      const float l0 = (ax0 + q0.y * py) + q0.z;
      const float l1 = (ax1 + q1.x * py) + q1.y;
      const float l2 = 1.0f - l0 - l1;
      const float zc = sign * ((axz + q1.w * py) + cz);
      if (k >= klo && k <= khi && l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f &&
          zc < zr[k]) {
        zr[k] = zc;
        bslot[k * 32] = slot;
      }
    }
  }
}

// Test the n staged candidates of buffer `buf`: the pixels of the small
// candidates are shared out evenly, a contiguous run of them to each thread
// of the block; every warp runs each large candidate that meets its block,
// in order.
template <int R>
__device__ __forceinline__ void test_stage(Shared& sh, int buf, int n,
                                           const Tile& t, const Block& b,
                                           float sign, float (&zr)[R],
                                           int* bslot) {
  const int lane = threadIdx.x & 31;
  unsigned small[2], large[2];
  int area[2];       // pixels of the small candidates lane and lane + 32
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    int x0, y0, x1, y1;
    const bool any = j < n && clip_rect(sh.st, buf, j, t, x0, y0, x1, y1);
    const int a = any ? (x1 - x0 + 1) * (y1 - y0 + 1) : 0;
    small[h] = __ballot_sync(0xFFFFFFFFu, any && a <= kScatterMax);
    large[h] = __ballot_sync(0xFFFFFFFFu, a > kScatterMax);
    area[h] = a <= kScatterMax ? a : 0;
  }
  // job prefix sums over the 64 candidates, and this thread's run
  const int inc0 = warp_scan(area[0]);
  const int inc1 = warp_scan(area[1]) + __shfl_sync(0xFFFFFFFFu, inc0, 31);
  const int jobs = __shfl_sync(0xFFFFFFFFu, inc1, 31);
  const int per = (jobs + kThreads - 1) / kThreads;
  const int q = min((int)threadIdx.x * per, jobs);
  // the candidate holding job q: the first whose inclusive sum exceeds q
  int lo = 0, hi = 2 * 32 - 1;
#pragma unroll
  for (int step = 0; step < 6; ++step) {
    const int mid = (lo + hi) >> 1;
    if (pick(inc0, inc1, mid) > q) hi = mid; else lo = mid + 1;
  }
  const int first = pick(inc0, inc1, lo) - pick(area[0], area[1], lo);
  if (q < jobs) {
    scatter_run<R>(sh.st, buf, lo, q - first, min(per, jobs - q), small, t,
                   sign, sh.key);
  }
  if (!b.active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned m = large[h];
    while (m) {
      const int j = 32 * h + __ffs(m) - 1;
      m &= m - 1;
      test_block<R>(sh.st, buf, j, b, sign, zr, bslot);
    }
  }
}

// The z-loop of one pass: streams the candidates of segs[0 .. nseg) (a
// sentinel segs[nseg].first holds the stream length) through the double-
// buffered stage, and leaves in sh.key each pixel's winner of the pass (see
// the merge below).  Every thread of the block calls it (threads 0-63 fill
// the stage, and it synchronises the block).
template <int R>
__device__ __forceinline__ void run(const float* __restrict__ setup,
                                    const int4* __restrict__ rects,
                                    const int* __restrict__ cand_row,
                                    const Seg* segs, int nseg, Shared& sh,
                                    const Tile& t, const Block& b,
                                    float sign) {
  const int tid = threadIdx.x;
  float zr[R];       // the block route's running sign * z (slots: sh.slot)
#pragma unroll
  for (int k = 0; k < R; ++k) zr[k] = INFINITY;
  int* bslot = sh.slot + b.key0 + (tid & 31);
  __syncthreads();           // the last pass is done with the keys and stage
  for (int i = tid; i < kWarps * 32 * R; i += kThreads) {
    sh.key[i] = kEmptyKey;
    sh.slot[i] = 0;
  }
  __syncthreads();
  const int total = segs[nseg].first;
  const int groups = (total + kStage - 1) / kStage;
  // this thread's stage slot of a group, loaded one group ahead
  int slot = 0, id = 0, lo = 0, hi = -1;
  auto load = [&](int g) {
    const int v = g * kStage + tid;
    if (tid < kStage && v < total) {
      int s = 0;
      while (segs[s + 1].first <= v) ++s;
      slot = segs[s].slot0 + (v - segs[s].first);
      id = max(__ldg(cand_row + slot), 0);
      lo = segs[s].lo;
      hi = segs[s].hi;
    }
  };
  auto copy_group = [&](int g, int buf) {
    if (tid < kStage && g * kStage + tid < total) {
      const float4* row =
          reinterpret_cast<const float4*>(setup) + (size_t)id * (kSetupDim / 4);
      cp_async16(&sh.st.coef[buf][tid][0], row);
      cp_async16(&sh.st.coef[buf][tid][1], row + 1);
      cp_async16(&sh.st.coef[buf][tid][2], row + 2);
      cp_async16(&sh.st.rect[buf][tid], rects + id);
      sh.st.slot[buf][tid] = slot;
      sh.st.lo[buf][tid] = lo;
      sh.st.hi[buf][tid] = hi;
    }
    cp_async_commit();
  };
  if (groups > 0) {
    load(0);
    copy_group(0, 0);
    load(1);
  }
  for (int g = 0; g < groups; ++g) {
    const int buf = g & 1;
    if (g + 1 < groups) {
      copy_group(g + 1, buf ^ 1);   // its buffer was freed by the last barrier
      load(g + 2);
      cp_async_wait<1>();      // this thread's copies of group g are done
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();           // ... and every thread's
    test_stage<R>(sh, buf, min(kStage, total - g * kStage), t, b, sign, zr,
                  bslot);
    __syncthreads();           // group g consumed: its buffer is free
  }
  // merge the scattered keys with the block route's registers: the smaller
  // (z, slot) wins; a key winner at depth 0 gets its depth recomputed (the
  // key holds +0 for -0).  Each pixel's key then holds its winner: the bits
  // of sign * z (+inf on a miss) and the slot (0 on a miss).
  if (b.active) {
    const int lane = tid & 31;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      unsigned long long* p = sh.key + b.key0 + k * 32 + lane;
      const float zk = unordered((unsigned)(*p >> 32));
      const unsigned sk = (unsigned)*p;
      const float zc = zr[k] + 0.0f;
      float z = zr[k];
      unsigned slot = (unsigned)bslot[k * 32];
      if (zk < zc || (zk == zc && sk < slot)) {
        z = zk;
        slot = sk;
        if (zk == 0.0f) {
          const float4* s = reinterpret_cast<const float4*>(setup) +
                            (size_t)max(__ldg(cand_row + sk), 0) *
                                (kSetupDim / 4);
          const float4 u = __ldg(s + 1), v = __ldg(s + 2);   // columns 4-11
          z = sign * ((u.z * b.px + u.w * (b.py0 + (float)k)) + v.x);
        }
      }
      *p = ((unsigned long long)__float_as_uint(z) << 32) | slot;
    }
  }
  __syncthreads();
}

// The pass's pixels four at a time (a row-major quad of the pass's rows),
// for the epilogues: calls f(quad's first key, tile-local row, column) for
// each quad of this thread whose warp block is in the pass.
template <int R, typename F>
__device__ __forceinline__ void for_quads(const Tile& t, F f) {
  const int qrow = t.tw / 4;
  const int nq = (t.phi - t.plo + 1) * qrow;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int ly = t.plo - t.y0 + q / qrow, lx = 4 * (q % qrow);
    const int wb = (ly / R) * t.cols + (lx >> 5) - t.pass;
    if (wb < 0 || wb >= kWarps || wb + t.pass >= t.nb) continue;
    f(wb * 32 * R + (ly % R) * 32 + (lx & 31), ly, lx);
  }
}

// Rows a warp block holds: 16 when the tile still fills every warp of a
// pass with 16-row blocks, else 8.
inline int block_rows(int th, int tw) {
  return (th % 16 == 0 && (th / 16) * (tw / 32) >= kWarps) ? 16 : 8;
}

}  // namespace zloop
