// In-loop deblocking filter (K8) as one launch per frame, for sm_90a.
//
// Replaces the XLA loop deblock_frame_device_impl
// (h264_fer_tpu/kernels/deblock_tpu.py:204, fori_loop at :289), which is
// bit-identical to the norm's per-MB raster order (8.7): for each MB its 4
// vertical edges left to right, then its 4 horizontal edges top to bottom,
// each edge filtering luma lines of 4 samples either side, and at luma
// offsets 0 and 8 the Cb and Cr edges (chroma line j takes the bS of luma
// 4-line group j / 2). The bS of every edge comes from the syntax state
// before filtering: 4 on an MB edge and 3 inside when either side is intra,
// else 2 when either 4x4 block has coefficients, else 1 when the quadrant
// MVs differ by 4 quarter pels or more, else 0; frame edges are not
// filtered.
//
// What bounds it on an H100: one read and one write of the three planes
// (6.3 MB at 1080p, ~2 us at 3.35 TB/s) and a few hundred int32 operations
// per filtered line; neither. The floor is the dependency chain. MB (r, c)
// reads and writes 3-4 samples into its left and top neighbours, and its
// top edge reads, as p samples, columns 16c+13..16c+15 of rows
// 16r-4..16r-1, which the top-right MB (r-1, c+1)'s left edge writes
// first in raster order. So MB (r, c) needs the final samples of its left,
// top, top-right (and, implied, top-left) neighbours: wmb + 2 hmb - 2 MBs
// (254 at 1080p) in a chain, at most min(hmb, ceil(wmb / 2)) (60) ready at
// once. The first design paid a launch (~11 us) per knight wave.
//
// Design: one launch per frame on csrc/mb_dataflow.cuh. A persistent grid
// of two-warp blocks takes the MBs by ticket in knight order and waits on
// all four neighbours. Before the wait a block loads what no MB with an
// earlier ticket writes: its 32 bS values (lane t of the luma warp derives
// one from the syntax state, read-only in the launch) and its own 16x16
// luma and 8x8 Cb and Cr samples (the only other MBs that write into them,
// its right and bottom neighbours, wait on it). After the wait it loads
// the strips its neighbours write: the luma window's top 4x20 (corner
// included) and left 16x4, and the top 4x12 and left 8x4 of the two chroma
// windows, as 32-bit words whose loads all go out at once. The windows
// (ints, ~3 KB with the bS, so block slots, not memory, bound the blocks
// per SM) live in shared memory, padded so that a step's lanes hit
// distinct banks. Warp 0 runs the 8 luma edge steps (lanes 0..15 one line
// each) while warp 1 runs the 4 chroma ones (lanes 0..15 the 8 Cb and 8
// Cr lines), each with __syncwarp between steps: the two never touch each
// other's samples, and a warp with both would serialise their paths. Each
// warp writes back only what the filter can change (its own MB, the top
// neighbour's bottom 3 luma rows and 1 chroma row, the left neighbour's
// right 3 luma columns and 1 chroma column); then the block publishes. The planes are
// filtered in place on the caller's copies and are written in the launch:
// every read of them is a plain load, never __ldg or `const __restrict__`.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>

#include "intra_common.cuh"
#include "mb_dataflow.cuh"

namespace {

// alpha, beta and tc0 (bS 1..3) of one indexA / indexB
struct EdgeTab {
  int alpha, beta, tc0[3];
};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Filter one line of one edge in place: s points at q0, and p_k / q_k lie
// at s[-(k + 1) * st] / s[k * st]. p3 and q3 are read, never written. The
// branches return early where a line needs no work (bS 0, or the alpha /
// beta test fails), which is most lines of a P frame; the lanes of one
// edge share whether it is an MB edge of an intra MB (bS 4), so the normal
// and the strong filter do not diverge within a step.
__device__ __forceinline__ void filter_line(int* s, int st, int bs, const EdgeTab& t,
                                            bool chroma) {
  if (bs == 0) return;
  const int p0 = s[-st], p1 = s[-2 * st], p2 = s[-3 * st], p3 = s[-4 * st];
  const int q0 = s[0], q1 = s[st], q2 = s[2 * st], q3 = s[3 * st];
  if (!(abs(p0 - q0) < t.alpha && abs(p1 - p0) < t.beta &&
        abs(q1 - q0) < t.beta))
    return;
  const bool ap = abs(p2 - p0) < t.beta, aq = abs(q2 - q0) < t.beta;
  if (bs < 4) {  // normal filter
    // by selects: an index into the parameter struct would copy it to the stack
    const int tc0 = bs == 1 ? t.tc0[0] : (bs == 2 ? t.tc0[1] : t.tc0[2]);
    const int tc = chroma ? tc0 + 1 : tc0 + ap + aq;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    s[-st] = clip255(p0 + delta);
    s[0] = clip255(q0 - delta);
    if (!chroma) {
      const int avg = (p0 + q0 + 1) >> 1;
      if (ap) s[-2 * st] = p1 + clip3(-tc0, tc0, (p2 + avg - p1 * 2) >> 1);
      if (aq) s[st] = q1 + clip3(-tc0, tc0, (q2 + avg - q1 * 2) >> 1);
    }
    return;
  }
  // bS 4: strong filter; chroma changes p0 and q0 only, with the 3-tap form
  const bool strong = !chroma && abs(p0 - q0) < ((t.alpha >> 2) + 2);
  if (strong && ap) {
    s[-st] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
    s[-2 * st] = (p2 + p1 + p0 + q0 + 2) >> 2;
    s[-3 * st] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
  } else {
    s[-st] = (2 * p1 + p0 + q1 + 2) >> 2;
  }
  if (strong && aq) {
    s[0] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
    s[st] = (q2 + q1 + q0 + p0 + 2) >> 2;
    s[2 * st] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
  } else {
    s[0] = (2 * q1 + q0 + p1 + 2) >> 2;
  }
}

// MV quadrant of raster 4x4 block b
__device__ __forceinline__ int quadrant(int b) { return (b >> 3) * 2 + ((b & 3) >> 1); }

constexpr int kThreads = 64;  // warp 0 the luma, warp 1 the chroma

// The 4 samples of a 32-bit word, byte k at bits 8k..8k+7, into dst[0..3]
__device__ __forceinline__ void unpack4(unsigned v, int* dst) {
#pragma unroll
  for (int k = 0; k < 4; ++k) dst[k] = (v >> (8 * k)) & 0xff;
}

__device__ __forceinline__ unsigned pack4(const int* s) {
  return (unsigned)(s[0] & 0xff) | (unsigned)(s[1] & 0xff) << 8 |
         (unsigned)(s[2] & 0xff) << 16 | (unsigned)(s[3] & 0xff) << 24;
}

// The word at p, or 0 where p is null; the load is issued either way (from
// `fallback`, a valid address), so that a lane's loads go out together.
__device__ __forceinline__ unsigned word_or_0(const uint8_t* p, const uint8_t* fallback) {
  const unsigned v = *reinterpret_cast<const unsigned*>(p ? p : fallback);
  return p ? v : 0u;
}

struct Frame {
  uint8_t *y, *cb, *cr;  // (H, W), (H/2, W/2): filtered in place, in the launch
  const bool* mb_intra;  // (nmb,)
  const bool* nz_luma;   // (nmb, 16) Z-scan blocks
  const int32_t* mv;     // (nmb, 4 quadrants, 2)
  int wmb;
  EdgeTab luma, chroma;
};

__global__ void __launch_bounds__(kThreads)
deblock_kernel(Frame f, Dataflow df) {
  // windows padded by one column, so that the lanes of a vertical-edge
  // step (one row each) hit distinct banks
  __shared__ int wy[20][21];     // luma window, origin (16 r - 4, 16 c - 4)
  __shared__ int wc[2][12][13];  // Cb, Cr windows, origin (8 r - 4, 8 c - 4)
  __shared__ int bs[2][4][4];    // [vertical, horizontal][edge][4-line group]
  __shared__ int s_mb;
  const bool* __restrict__ mb_intra = f.mb_intra;  // read-only in the launch
  const bool* __restrict__ nz_luma = f.nz_luma;
  const int32_t* __restrict__ mv = f.mv;
  const int wmb = f.wmb, W = wmb * 16, Wc = wmb * 8;
  const int lane = threadIdx.x & 31;
  const bool luma = threadIdx.x < 32;

  for (;;) {
    const int mb = dataflow_next(df, &s_mb);
    if (mb < 0) return;
    const int r = mb / wmb, c = mb - r * wmb;
    uint8_t* const y0 = f.y + (size_t)(16 * r) * W + 16 * c;  // the MB's first samples
    uint8_t* const cb0 = f.cb + (size_t)(8 * r) * Wc + 8 * c;
    uint8_t* const cr0 = f.cr + (size_t)(8 * r) * Wc + 8 * c;

    // ---- before the wait: what no earlier ticket writes. The luma warp:
    // lanes 0..15 a row of the MB's own 16x16 luma, and lane t the bS of
    // edge e (xblk of a vertical edge, yblk of a horizontal one), 4-line
    // group g, direction t >> 4. The chroma warp: lanes 0..15 a row of the
    // own 8x8 Cb (0..7) or Cr (8..15) ---------------------------------------
    if (luma) {
      if (lane < 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(y0 + (size_t)lane * W);
        unpack4(v.x, &wy[4 + lane][4]);
        unpack4(v.y, &wy[4 + lane][8]);
        unpack4(v.z, &wy[4 + lane][12]);
        unpack4(v.w, &wy[4 + lane][16]);
      }
      const int dir = lane >> 4, e = (lane >> 2) & 3, g = lane & 3;
      const int qb = dir ? e * 4 + g : g * 4 + e;  // raster blocks
      int pmb = mb, pb = dir ? qb - 4 : qb - 1;
      bool avail = true;
      if (e == 0) {
        pmb = dir ? mb - wmb : mb - 1;
        pb = dir ? 12 + g : g * 4 + 3;
        avail = dir ? r > 0 : c > 0;
      }
      int v = 0;
      if (avail) {
        if (mb_intra[pmb] || mb_intra[mb]) {
          v = e == 0 ? 4 : 3;
        } else if (nz_luma[pmb * 16 + kRasterToZ[pb]] ||
                   nz_luma[mb * 16 + kRasterToZ[qb]]) {
          v = 2;
        } else {
          const int32_t* a = mv + (pmb * 4 + quadrant(pb)) * 2;
          const int32_t* b = mv + (mb * 4 + quadrant(qb)) * 2;
          v = abs(a[0] - b[0]) >= 4 || abs(a[1] - b[1]) >= 4;
        }
      }
      bs[dir][e][g] = v;
    } else if (lane < 16) {
      const int p = lane >> 3, j = lane & 7;
      const uint2 v = *reinterpret_cast<const uint2*>((p ? cr0 : cb0) + (size_t)j * Wc);
      unpack4(v.x, &wc[p][4 + j][4]);
      unpack4(v.y, &wc[p][4 + j][8]);
    }

    dataflow_wait(df, r, c, wmb);  // left, top, top-right, top-left

    if (luma) {
      // ---- the strips the neighbours write, as 32-bit words: word i < 20
      // of the top 4x20 (corner included; row i / 5, word i % 5), then the
      // left 16x4 (20..35); 0 outside the frame (beyond an edge of bS 0)
      unsigned word[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = lane + 32 * k;
        const uint8_t* src = nullptr;
        if (i < 20) {
          if (r > 0 && (c > 0 || i % 5 > 0))
            src = y0 + (ptrdiff_t)(i / 5 - 4) * W + 4 * (i % 5) - 4;
        } else if (i < 36 && c > 0) {
          src = y0 + (size_t)(i - 20) * W - 4;
        }
        word[k] = word_or_0(src, y0);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = lane + 32 * k;
        if (i < 20) {
          unpack4(word[k], &wy[i / 5][4 * (i % 5)]);
        } else if (i < 36) {
          unpack4(word[k], &wy[4 + i - 20][0]);
        }
      }
      __syncwarp();

      // vertical edges left to right, then horizontal edges top to bottom:
      // lanes 0..15 the 16 lines of each
#pragma unroll
      for (int step = 0; step < 8; ++step) {
        const int dir = step >> 2, e = step & 3;
        if (lane < 16) {
          int* s = dir ? &wy[4 + 4 * e][4 + lane] : &wy[4 + lane][4 + 4 * e];
          filter_line(s, dir ? 21 : 1, bs[dir][e][lane >> 2], f.luma, false);
        }
        __syncwarp();
      }

      // ---- write back what the filter can change: the own rows and the
      // left MB's right 3 columns (lanes 0..15), the top MB's bottom 3
      // rows (lanes 16..18)
      if (lane < 16) {
        const int* w = &wy[4 + lane][4];
        uint8_t* row = y0 + (size_t)lane * W;
        *reinterpret_cast<uint4*>(row) =
            make_uint4(pack4(w), pack4(w + 4), pack4(w + 8), pack4(w + 12));
        if (c > 0) {
          row[-3] = (uint8_t)w[-3];
          row[-2] = (uint8_t)w[-2];
          row[-1] = (uint8_t)w[-1];
        }
      } else if (lane < 19 && r > 0) {
        const int* w = &wy[lane - 15][4];
        *reinterpret_cast<uint4*>(y0 - (ptrdiff_t)(19 - lane) * W) =
            make_uint4(pack4(w), pack4(w + 4), pack4(w + 8), pack4(w + 12));
      }
    } else {
      // ---- the chroma strips: per plane (20 words each) its top 4x12 (12
      // words: row j / 3, word j % 3), then its left 8x4 (12..19)
      unsigned word[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = lane + 32 * k;
        const uint8_t* src = nullptr;
        const uint8_t* base = i < 20 ? cb0 : cr0;
        const int j = i < 20 ? i : i - 20;
        if (i < 40) {
          if (j < 12) {
            if (r > 0 && (c > 0 || j % 3 > 0))
              src = base + (ptrdiff_t)(j / 3 - 4) * Wc + 4 * (j % 3) - 4;
          } else if (c > 0) {
            src = base + (size_t)(j - 12) * Wc - 4;
          }
        }
        word[k] = word_or_0(src, cb0);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = lane + 32 * k;
        if (i < 40) {
          const int p = i / 20, j = i % 20;
          unpack4(word[k], j < 12 ? &wc[p][j / 3][4 * (j % 3)] : &wc[p][4 + j - 12][0]);
        }
      }
      __syncwarp();

      // the chroma edges at luma offsets 0 and 8, vertical then horizontal:
      // lanes 0..15 the 8 Cb and 8 Cr lines of each (chroma line j takes
      // the bS of luma 4-line group j / 2)
#pragma unroll
      for (int step = 0; step < 4; ++step) {
        const int dir = step >> 1, e = 2 * (step & 1);
        if (lane < 16) {
          const int p = lane >> 3, j = lane & 7;
          int* s = dir ? &wc[p][4 + 2 * e][4 + j] : &wc[p][4 + j][4 + 2 * e];
          filter_line(s, dir ? 13 : 1, bs[dir][e][j >> 1], f.chroma, true);
        }
        __syncwarp();
      }

      // ---- write back: the own rows and the left MB's right column (lanes
      // 0..15), the top MB's bottom row (lanes 16, 17)
      if (lane < 16) {
        const int p = lane >> 3, j = lane & 7;
        const int* w = &wc[p][4 + j][4];
        uint8_t* row = (p ? cr0 : cb0) + (size_t)j * Wc;
        *reinterpret_cast<uint2*>(row) = make_uint2(pack4(w), pack4(w + 4));
        if (c > 0) row[-1] = (uint8_t)w[-1];
      } else if (lane < 18 && r > 0) {
        const int p = lane - 16;
        const int* w = &wc[p][3][4];
        *reinterpret_cast<uint2*>((p ? cr0 : cb0) - Wc) = make_uint2(pack4(w), pack4(w + 4));
      }
    }
    dataflow_publish(df, mb);
  }
}

}  // namespace

// K8: filters the uint8 planes y (H, W), cb and cr (H/2, W/2) in place in
// one launch on `stream`: a persistent grid of `blocks` two-warp blocks
// (0: as many as fit on the card; at most nmb) taking the MBs in the
// knight order `order` (nmb,) through the dataflow scratch `sched` (nmb + 1
// int32, zeroed). State: mb_intra (nmb,) and nz_luma (nmb, 16, Z-scan)
// bool, mv (nmb, 4 quadrants, 2) int32. tab: 10 ints, alpha, beta and
// tc0[3] of the luma QP, then of the chroma QP. The planes must be 16-byte
// (y) and 8-byte (cb, cr) aligned. *launched gets 1 when the launch was
// accepted. Returns its CUDA error (0 when accepted).
extern "C" int deblock_frame(uint8_t* y, uint8_t* cb, uint8_t* cr,
                             const bool* mb_intra, const bool* nz_luma,
                             const int32_t* mv, const int32_t* order,
                             int32_t* sched, int wmb, int hmb, const int* tab,
                             int blocks, cudaStream_t stream, int* launched) {
  *launched = 0;
  const Frame f{y, cb, cr, mb_intra, nz_luma, mv, wmb,
                {tab[0], tab[1], {tab[2], tab[3], tab[4]}},
                {tab[5], tab[6], {tab[7], tab[8], tab[9]}}};
  const Dataflow df{order, sched, wmb * hmb};
  const int grid = dataflow_grid(deblock_kernel, kThreads, 0, wmb * hmb, blocks);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  deblock_kernel<<<grid, kThreads, 0, stream>>>(f, df);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
