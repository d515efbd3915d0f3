// The Intra_4x4 coding of one macroblock, shared by the K4x4 wavefront
// (csrc/wavefront_i4x4.cu) and the K6 arbitration wavefront
// (csrc/wavefront_mixed.cu): the device form of
// kernels/wavefront_i4x4.i4x4_mb_code, which replaces the per-block body of
// the Pallas kernel _i4_kernel_body
// (h264_fer_tpu/kernels/wavefront_pallas.py:551).
//
// One warp codes one MB: its 16 blocks in 10 diagonal steps, two blocks at
// once where a step has two, one sample per lane (prediction, forward
// transform, quantisation, inverse, reconstruction). The MB's
// reconstruction so far and its neighbour samples live in shared memory;
// __syncwarp orders the steps.

#pragma once

#include <cstdint>

#include "intra_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

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

// The Intra_4x4 working state of one MB. ext: its reconstruction with the
// neighbour samples around it: row 0 the corner, the top MB's row 15 and
// the top-right MB's first 4 samples of row 15 (as MbNbr: -1 where
// unavailable), column 0 the left MB's column 15, the MB's sample (x, y)
// at [1 + y][1 + x]. pred: the prediction of every (mode, sample) as one
// int (ops/intra.packed_mode_table), filled by load_pred_table.
struct I4Scratch {
  int ext[17][21];
  int pred[144];
};

// Copy the packed prediction table (global) into sc.pred, by threads tid of
// nthreads; the caller synchronises after.
__device__ __forceinline__ void load_pred_table(I4Scratch& sc, const int32_t* table,
                                                int tid, int nthreads) {
  for (int i = tid; i < 144; i += nthreads) sc.pred[i] = table[i];
}

// zig-zag index of raster position i (0..15) of a 4x4 block, from a
// register constant (INV_ZIGZAG_FLAT, four bits each)
__device__ __forceinline__ int inv_zigzag(int i) {
  return (int)((0xFEA9DB83C7426510ull >> (4 * i)) & 15);
}

// Code one MB as Intra_4x4; all 32 lanes of one warp call it. src: the
// MB's 16x16 source samples (row-major, in shared memory); modes: its 16
// Z-scan modes; nb: its neighbours. Leaves the reconstruction in sc.ext and
// writes the quantised levels to lv[16 * z + zig-zag index].
//
// Block (i, j) (column i, row j of the MB's 4x4 grid) predicts from its 13
// neighbour samples p (ops/intra._p4: p[0] the corner, p[1..4] the left
// column, p[5..8] the top row, p[9..12] the above-right samples). The
// above-right samples follow _fetch_p13 (intra.cpp:345-378): the last top
// sample replicated for blocks 3 and 11 and for the right column below the
// MB's top row; for block 5 the top-right MB's row 15, or the replica where
// it is unavailable; all -1 on the frame's top edge. So block (i, j) reads
// only blocks of earlier diagonals t = i + 2j: left t - 1, top t - 2,
// top-left t - 3, and top-right t - 1 where it reads it. The 16 blocks run
// in 10 steps t = 0..9, two at once on t = 2..7: lanes 0..15 code the block
// of the smaller row j, lanes 16..31 the other (where t has one block they
// recompute it and write nothing), one sample per lane. A lane reads its
// three prediction samples straight from ext through the packed table
// (DC sums its 8), so no lane branches on the mode but DC; the transform
// passes move values between the lanes of a half-warp with shuffles. The
// two blocks of a step read only cells of earlier steps and write disjoint
// cells, so one __syncwarp per step orders it all.
__device__ void i4x4_mb(const uint8_t* src, const int* modes, const MbNbr& nb,
                        int qp, const QpTab& tab, int* lv, I4Scratch& sc, int lane) {
  for (int i = lane; i < 37; i += 32) {
    if (i < 21) {
      sc.ext[0][i] = i == 0 ? nb.corner : nb.top[i - 1];
    } else {
      sc.ext[i - 20][0] = nb.left[i - 21];
    }
  }
  __syncwarp();
  const int half = lane >> 4, h = lane & 15, base = lane & 16;
  const int x = h & 3, y = h >> 2;  // the lane's sample of its block
  const int lq = tab.lq[pat(y, x)], ls = tab.ls[pat(y, x)];
  const int zz = inv_zigzag(h);
  for (int t = 0; t < 10; ++t) {
    const int j0 = t < 3 ? 0 : (t - 2) >> 1;  // rows j with 0 <= t - 2j <= 3
    const int j1 = min(3, t >> 1);
    const bool active = j0 + half <= j1;
    const int j = active ? j0 + half : j0;
    const int i = t - 2 * j;
    const int bx = 4 * i, by = 4 * j;
    const int z = ((j >> 1) << 3) | ((i >> 1) << 2) | ((j & 1) << 1) | (i & 1);
    const int (*e)[21] = &sc.ext[by];  // e[0][bx] is the block's corner p[0]
    const int m = modes[z];
    int pred;
    if (m == 2) {  // DC: availability from the -1 samples (intra.cpp:164-181)
      int top4 = 0, left4 = 0;
#pragma unroll
      for (int k = 1; k <= 4; ++k) {
        top4 += e[0][bx + k];
        left4 += e[k][bx];
      }
      pred = e[0][bx] != -1   ? (top4 + left4 + 4) >> 3
             : e[1][bx] != -1 ? (left4 + 2) >> 2
             : e[0][bx + 1] != -1 ? (top4 + 2) >> 2 : 128;
    } else {
      const int code = sc.pred[16 * m + h];
      const bool rep = z == 3 || z == 11 || (bx == 12 && (by > 0 || !nb.tr_ok));
      int acc = (code >> 18) & 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int idx = (code >> (4 * k)) & 15;
        const int row = idx >= 1 && idx <= 4 ? idx : 0;
        const int col = idx < 5 ? 0 : (rep && idx >= 9 ? 4 : idx - 4);
        acc += ((code >> (12 + 2 * k)) & 3) * e[row][bx + col];
      }
      pred = acc >> ((code >> 20) & 3);
    }
    const int diff = (int)src[(by + y) * 16 + bx + x] - pred;
    const int a = diff == 0 ? 0 : diff * 64 - 32;
    // forward core transform: columns (sample (x, y) takes rows 0..3 of
    // column x), then rows
    const int b = fwd_step(y, __shfl_sync(kFull, a, base + x),
                           __shfl_sync(kFull, a, base + 4 + x),
                           __shfl_sync(kFull, a, base + 8 + x),
                           __shfl_sync(kFull, a, base + 12 + x));
    const int coef = fwd_step(x, __shfl_sync(kFull, b, base + 4 * y),
                              __shfl_sync(kFull, b, base + 4 * y + 1),
                              __shfl_sync(kFull, b, base + 4 * y + 2),
                              __shfl_sync(kFull, b, base + 4 * y + 3));
    const int q = quant_ac(coef, qp, lq);
    const int d = scale_ac(q, qp, ls);
    // inverse: rows, then columns
    const int g = inv_step(x, __shfl_sync(kFull, d, base + 4 * y),
                           __shfl_sync(kFull, d, base + 4 * y + 1),
                           __shfl_sync(kFull, d, base + 4 * y + 2),
                           __shfl_sync(kFull, d, base + 4 * y + 3));
    const int r = inv_step(y, __shfl_sync(kFull, g, base + x),
                           __shfl_sync(kFull, g, base + 4 + x),
                           __shfl_sync(kFull, g, base + 8 + x),
                           __shfl_sync(kFull, g, base + 12 + x));
    if (active) {
      lv[16 * z + zz] = q;
      sc.ext[by + 1 + y][bx + 1 + x] = clip255(pred + ((r + 32) >> 6));
    }
    __syncwarp();
  }
}

}  // namespace
