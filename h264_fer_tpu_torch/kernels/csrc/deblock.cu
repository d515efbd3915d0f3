// In-loop deblocking filter over MB knight waves (K8), for sm_90a.
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
// Schedule: an MB reads and writes 4 samples into its left and top
// neighbours, so MB (r, c) and (r - 1, c + 1) (same anti-diagonal) both
// touch the 4x4 corner they share. Under d = 2r + c every MB that writes
// into MB (r, c)'s 20x20 luma window (origin 4 samples up and left) comes
// earlier in raster order on an earlier wave or later in raster order on a
// later one, and the windows of one wave are disjoint. One launch per
// non-empty wave (2 (hmb - 1) + wmb at most, 254 at 1080p), one thread
// block per MB of the wave.
//
// Block: one warp. The MB's 20x20 luma and two 12x12 chroma windows (int,
// never uint8 arithmetic) and its 32 bS values live in shared memory; lane
// t computes one bS, then on each of the 8 edge steps lanes 0..15 filter
// the 16 luma lines and lanes 16..31 the 8 Cb and 8 Cr lines (on the two
// steps per direction that have a chroma edge), with __syncthreads between
// steps. The planes are filtered in place: the caller passes copies of the
// input planes, which earlier waves have already written.
//
// What bounds it on an H100: one read and one write of the three planes
// (6.3 MB at 1080p, ~2 us at 3.35 TB/s); the floor is the chain of 254
// dependent launches.

#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>

#include "intra_common.cuh"

namespace {

// alpha, beta and tc0 (bS 1..3) of one indexA / indexB
struct EdgeTab {
  int alpha, beta, tc0[3];
};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Filter one line of one edge in place: s points at q0, and p_k / q_k lie
// at s[-(k + 1) * st] / s[k * st]. p3 and q3 are read, never written.
__device__ void filter_line(int* s, int st, int bs, const EdgeTab& t,
                            bool chroma) {
  if (bs == 0) return;
  const int p0 = s[-st], p1 = s[-2 * st], p2 = s[-3 * st], p3 = s[-4 * st];
  const int q0 = s[0], q1 = s[st], q2 = s[2 * st], q3 = s[3 * st];
  if (!(abs(p0 - q0) < t.alpha && abs(p1 - p0) < t.beta &&
        abs(q1 - q0) < t.beta))
    return;
  const bool ap = abs(p2 - p0) < t.beta, aq = abs(q2 - q0) < t.beta;
  if (bs < 4) {  // normal filter
    const int tc0 = t.tc0[bs - 1];
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

__global__ void __launch_bounds__(32)
deblock_wave_kernel(uint8_t* y, uint8_t* cb, uint8_t* cr,
                    const bool* __restrict__ mb_intra,
                    const bool* __restrict__ nz_luma,
                    const int32_t* __restrict__ mv, int wmb, int hmb, int d,
                    int r0, EdgeTab luma, EdgeTab chroma) {
  const int r = r0 + blockIdx.x, c = d - 2 * r;
  const int mb = r * wmb + c, W = wmb * 16, Wc = wmb * 8;
  const int t = threadIdx.x;
  __shared__ int wy[20][20];     // luma window, origin (16 r - 4, 16 c - 4)
  __shared__ int wc[2][12][12];  // Cb, Cr windows, origin (8 r - 4, 8 c - 4)
  __shared__ int bs[2][4][4];    // [vertical, horizontal][edge][4-line group]

  // the windows; samples outside the frame sit beyond an edge of bS 0
  for (int i = t; i < 400; i += 32) {
    const int gy = 16 * r - 4 + i / 20, gx = 16 * c - 4 + i % 20;
    wy[i / 20][i % 20] = gy >= 0 && gx >= 0 ? y[gy * W + gx] : 0;
  }
  for (int i = t; i < 288; i += 32) {
    const int p = i / 144, k = i % 144;
    const int gy = 8 * r - 4 + k / 12, gx = 8 * c - 4 + k % 12;
    wc[p][k / 12][k % 12] = gy >= 0 && gx >= 0 ? (p ? cr : cb)[gy * Wc + gx] : 0;
  }
  // lane t: bS of edge e (xblk of a vertical edge, yblk of a horizontal
  // one), 4-line group g, direction t >> 4
  {
    const int dir = t >> 4, e = (t >> 2) & 3, g = t & 3;
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
  }
  __syncthreads();

  // vertical edges left to right, then horizontal edges top to bottom
  for (int step = 0; step < 8; ++step) {
    const int dir = step >> 2, e = step & 3;
    if (t < 16) {
      int* s = dir ? &wy[4 + 4 * e][4 + t] : &wy[4 + t][4 + 4 * e];
      filter_line(s, dir ? 20 : 1, bs[dir][e][t >> 2], luma, false);
    } else if ((e & 1) == 0) {  // chroma edges at luma offsets 0 and 8
      const int p = (t - 16) >> 3, j = (t - 16) & 7;
      int* s = dir ? &wc[p][4 + 2 * e][4 + j] : &wc[p][4 + j][4 + 2 * e];
      filter_line(s, dir ? 12 : 1, bs[dir][e][j >> 1], chroma, true);
    }
    __syncthreads();
  }

  for (int i = t; i < 400; i += 32) {
    const int gy = 16 * r - 4 + i / 20, gx = 16 * c - 4 + i % 20;
    if (gy >= 0 && gx >= 0) y[gy * W + gx] = (uint8_t)wy[i / 20][i % 20];
  }
  for (int i = t; i < 288; i += 32) {
    const int p = i / 144, k = i % 144;
    const int gy = 8 * r - 4 + k / 12, gx = 8 * c - 4 + k % 12;
    if (gy >= 0 && gx >= 0) (p ? cr : cb)[gy * Wc + gx] = (uint8_t)wc[p][k / 12][k % 12];
  }
}

}  // namespace

// K8: filters the uint8 planes y (H, W), cb and cr (H/2, W/2) in place, one
// launch per non-empty knight wave on `stream`. State: mb_intra (nmb,) and
// nz_luma (nmb, 16, Z-scan) bool, mv (nmb, 4 quadrants, 2) int32. tab: 10
// ints, alpha, beta and tc0[3] of the luma QP, then of the chroma QP.
// *launched gets the number of accepted launches. Returns the first CUDA
// error (0 when every launch was accepted).
extern "C" int deblock_frame(uint8_t* y, uint8_t* cb, uint8_t* cr,
                             const bool* mb_intra, const bool* nz_luma,
                             const int32_t* mv, int wmb, int hmb, const int* tab,
                             cudaStream_t stream, int* launched) {
  *launched = 0;
  const EdgeTab luma = {tab[0], tab[1], {tab[2], tab[3], tab[4]}};
  const EdgeTab chroma = {tab[5], tab[6], {tab[7], tab[8], tab[9]}};
  for (int d = 0; d < 2 * (hmb - 1) + wmb; ++d) {
    int r0, r1;
    knight_rows(d, wmb, hmb, &r0, &r1);
    if (r1 < r0) continue;
    deblock_wave_kernel<<<r1 - r0 + 1, 32, 0, stream>>>(
        y, cb, cr, mb_intra, nz_luma, mv, wmb, hmb, d, r0, luma, chroma);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}
