// The Intra_4x4 coding of one macroblock, shared by the K4x4 wavefront
// (csrc/wavefront_i4x4.cu) and the K6 arbitration wavefront
// (csrc/wavefront_mixed.cu): the device form of
// kernels/wavefront_i4x4.i4x4_mb_code, which replaces the per-block body of
// the Pallas kernel _i4_kernel_body
// (h264_fer_tpu/kernels/wavefront_pallas.py:551).
//
// One warp codes one MB: its 16 blocks one after another in Z-scan order,
// lanes 0..15 one sample each of the current block (prediction, forward
// transform, quantisation, inverse, reconstruction), lanes 0..12 gathering
// the block's 13 neighbour samples first. The MB's reconstruction so far
// lives in shared memory; __syncwarp orders the steps.

#pragma once

#include <cstdint>

#include "intra_common.cuh"

namespace {

// Z-scan block → its x / y sample offset in the MB (Intra4x4ScanOrder)
__constant__ int kBlkX[16] = {0, 4, 0, 4, 8, 12, 8, 12, 0, 4, 0, 4, 8, 12, 8, 12};
__constant__ int kBlkY[16] = {0, 0, 4, 4, 0, 0, 4, 4, 8, 8, 12, 12, 8, 8, 12, 12};

// The reconstructed samples an MB reads from its neighbours, -1 where
// unavailable.
struct MbNbr {
  int left[16];  // column 15 of the left MB
  int top[20];   // row 15 of the top MB, then the first 4 samples of the
                 // top-right MB's row 15 (read only where tr_ok)
  int corner;    // the top-left MB's sample (15, 15)
  int top_ok, tr_ok;
};

// Fill nb for MB (r, c) of the row-major uint8 plane rec (W samples wide,
// wmb MBs), by threads tid of nthreads; the caller synchronises after.
__device__ void load_nbr(const uint8_t* rec, int W, int wmb, int r, int c,
                         MbNbr& nb, int tid, int nthreads) {
  const bool left_ok = c > 0, top_ok = r > 0;
  const bool tr_ok = top_ok && c + 1 < wmb;
  const int x0 = c * 16, y0 = r * 16;
  for (int i = tid; i < 37; i += nthreads) {
    if (i < 16) {
      nb.left[i] = left_ok ? rec[(y0 + i) * W + x0 - 1] : -1;
    } else if (i < 32) {
      nb.top[i - 16] = top_ok ? rec[(y0 - 1) * W + x0 + i - 16] : -1;
    } else if (i < 36) {
      nb.top[i - 16] = tr_ok ? rec[(y0 - 1) * W + x0 + i - 16] : -1;
    } else {
      nb.corner = left_ok && top_ok ? rec[(y0 - 1) * W + x0 - 1] : -1;
      nb.top_ok = top_ok;
      nb.tr_ok = tr_ok;
    }
  }
}

// Neighbour sample p(x, y) of a block (ops/intra._p4): x == -1 is the left
// column p[y + 1], so (-1, -1) is the corner p[0]; otherwise the top row.
__device__ __forceinline__ int p4(const int* p, int x, int y) {
  return x == -1 ? p[y + 1] : p[x + 5];
}

__device__ __forceinline__ int f3(int a, int b, int c) {
  return (a + 2 * b + c + 2) >> 2;
}

__device__ __forceinline__ int f2(int a, int b) { return (a + b + 1) >> 1; }

// Intra_4x4 prediction of sample (x, y) in `mode` from the 13 neighbour
// samples p (norm 8.3.1.2; ops/intra.predict_4x4).
__device__ int pred4(const int* p, int mode, int x, int y) {
  switch (mode) {
    case 0: return p[5 + x];
    case 1: return p[1 + y];
    case 2: {
      const int top4 = p[5] + p[6] + p[7] + p[8];
      const int left4 = p[1] + p[2] + p[3] + p[4];
      if (p[0] != -1) return (top4 + left4 + 4) >> 3;
      if (p[1] != -1) return (left4 + 2) >> 2;
      if (p[5] != -1) return (top4 + 2) >> 2;
      return 128;
    }
    case 3:  // diagonal down left
      if (x == 3 && y == 3) return (p4(p, 6, -1) + 3 * p4(p, 7, -1) + 2) >> 2;
      return f3(p4(p, x + y, -1), p4(p, x + y + 1, -1), p4(p, x + y + 2, -1));
    case 4:  // diagonal down right
      if (x > y) return f3(p4(p, x - y - 2, -1), p4(p, x - y - 1, -1), p4(p, x - y, -1));
      if (x < y) return f3(p4(p, -1, y - x - 2), p4(p, -1, y - x - 1), p4(p, -1, y - x));
      return f3(p4(p, 0, -1), p4(p, -1, -1), p4(p, -1, 0));
    case 5: {  // vertical right
      const int z = 2 * x - y, u = x - (y >> 1);
      if (z >= 0 && !(z & 1)) return f2(p4(p, u - 1, -1), p4(p, u, -1));
      if (z > 0) return f3(p4(p, u - 2, -1), p4(p, u - 1, -1), p4(p, u, -1));
      if (z == -1) return f3(p4(p, -1, 0), p4(p, -1, -1), p4(p, 0, -1));
      return f3(p4(p, -1, y - 1), p4(p, -1, y - 2), p4(p, -1, y - 3));
    }
    case 6: {  // horizontal down
      const int z = 2 * y - x, u = y - (x >> 1);
      if (z >= 0 && !(z & 1)) return f2(p4(p, -1, u - 1), p4(p, -1, u));
      if (z > 0) return f3(p4(p, -1, u - 2), p4(p, -1, u - 1), p4(p, -1, u));
      if (z == -1) return f3(p4(p, -1, 0), p4(p, -1, -1), p4(p, 0, -1));
      return f3(p4(p, x - 1, -1), p4(p, x - 2, -1), p4(p, x - 3, -1));
    }
    case 7: {  // vertical left
      const int u = x + (y >> 1);
      if (y == 0 || y == 2) return f2(p4(p, u, -1), p4(p, u + 1, -1));
      return f3(p4(p, u, -1), p4(p, u + 1, -1), p4(p, u + 2, -1));
    }
    default: {  // 8, horizontal up
      const int z = x + 2 * y, u = y + (x >> 1);
      if (z <= 4 && !(z & 1)) return f2(p4(p, -1, u), p4(p, -1, u + 1));
      if (z <= 3) return f3(p4(p, -1, u), p4(p, -1, u + 1), p4(p, -1, u + 2));
      if (z == 5) return (p4(p, -1, 2) + 3 * p4(p, -1, 3) + 2) >> 2;
      return p4(p, -1, 3);
    }
  }
}

struct I4Scratch {
  int p[13];   // the current block's neighbour samples
  int a[16];   // transform passes
  int b[16];
};

// Code one MB as Intra_4x4; all 32 lanes of one warp call it. src: the
// MB's top-left source sample (row stride W); modes: its 16 Z-scan modes;
// nb: its neighbours. Writes the reconstruction to work and the
// quantised levels to lv[16 * z + zig-zag index]. The above-right samples
// follow _fetch_p13 (intra.cpp:345-378): the last top sample replicated
// for blocks 3 and 11 and for the right column below the MB's top row;
// for block 5 the top-right MB's row 15, or the replica where it is
// unavailable; all -1 on the frame's top edge.
__device__ void i4x4_mb(const uint8_t* __restrict__ src, int W,
                        const int* modes, const MbNbr& nb, int qp,
                        const QpTab& tab, int (*work)[16], int* lv,
                        I4Scratch& sc, int lane) {
  const int x = lane & 3, y = lane >> 2;  // the sample of lanes 0..15
  for (int z = 0; z < 16; ++z) {
    const int bx = kBlkX[z], by = kBlkY[z];
    if (lane < 13) {
      int v;
      if (lane == 0) {
        v = bx > 0 && by > 0 ? work[by - 1][bx - 1]
            : by > 0         ? nb.left[by - 1]
            : bx > 0         ? nb.top[bx - 1]
                             : nb.corner;
      } else if (lane < 5) {
        v = bx > 0 ? work[by + lane - 1][bx - 1] : nb.left[by + lane - 1];
      } else if (lane < 9) {
        v = by > 0 ? work[by - 1][bx + lane - 5] : nb.top[bx + lane - 5];
      } else {
        const int j = lane - 9;
        const int last = by > 0 ? work[by - 1][bx + 3] : nb.top[bx + 3];
        if (z == 3 || z == 11 || (bx == 12 && by > 0)) {
          v = last;
        } else if (by > 0) {
          v = work[by - 1][bx + 4 + j];
        } else if (bx == 12) {
          v = nb.tr_ok ? nb.top[16 + j] : last;
        } else {
          v = nb.top[bx + 4 + j];
        }
        if (by == 0 && !nb.top_ok) v = -1;
      }
      sc.p[lane] = v;
    }
    __syncwarp();
    int pred = 0;
    if (lane < 16) {
      pred = pred4(sc.p, modes[z], x, y);
      const int diff = (int)src[(by + y) * W + bx + x] - pred;
      sc.a[lane] = diff == 0 ? 0 : diff * 64 - 32;
    }
    __syncwarp();
    if (lane < 16) sc.b[lane] = fwd_step(y, sc.a[x], sc.a[4 + x], sc.a[8 + x], sc.a[12 + x]);
    __syncwarp();
    if (lane < 16) {
      const int coef = fwd_step(x, sc.b[4 * y], sc.b[4 * y + 1], sc.b[4 * y + 2],
                                sc.b[4 * y + 3]);
      const int q = quant_ac(coef, qp, tab.lq[pat(y, x)]);
      lv[16 * z + kInvZigzag[lane]] = q;
      sc.a[lane] = scale_ac(q, qp, tab.ls[pat(y, x)]);
    }
    __syncwarp();
    if (lane < 16) sc.b[lane] = inv_step(x, sc.a[4 * y], sc.a[4 * y + 1], sc.a[4 * y + 2],
                                         sc.a[4 * y + 3]);
    __syncwarp();
    if (lane < 16) {
      const int h = inv_step(y, sc.b[x], sc.b[4 + x], sc.b[8 + x], sc.b[12 + x]);
      work[by + y][bx + x] = clip255(pred + ((h + 32) >> 6));
    }
    __syncwarp();
  }
}

}  // namespace
