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
// has_top: row 0 has a top neighbour, the plane row above it (a band's
// halo, written before the launch).
__device__ void load_nbr(const uint8_t* rec, int W, int wmb, int r, int c,
                         bool has_top, MbNbr& nb, int tid, int nthreads) {
  const bool left_ok = c > 0, top_ok = r > 0 || has_top;
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

// The do-nothing hook of i4x4_mb's steps (K6 runs it so: the code
// compiles as if there were no hook). A hook with kActive true (K4x4's
// EdgeHook, csrc/wavefront_i4x4.cu) takes over the MB's neighbour samples: i4x4_mb then leaves row 0 and column 0
// of sc.ext to it, calls before(t) ahead of step t (it must leave the cells
// step t reads in sc.ext, ordered before its return for every lane) and
// after(t) once step t's cells are in sc.ext and its lanes have passed
// __syncwarp.
struct NoStepHook {
  static constexpr bool kActive = false;
  __device__ __forceinline__ void before(int) const {}
  __device__ __forceinline__ void after(int) const {}
};

// The block a lane of half-warp `half` codes on diagonal step t = i + 2j
// (rows j with 0 <= t - 2j <= 3): the half with the smaller row takes lanes
// 0..15; where t has one block, lanes 16..31 recompute it and write
// nothing (active false). With t a compile-time constant, all of it folds.
struct I4Step {
  bool active;
  int bx, by, z;  // the block's sample origin in the MB and its Z-scan index
};

__device__ __forceinline__ I4Step i4_step(int t, int half) {
  const int j0 = t < 3 ? 0 : (t - 2) >> 1;
  const int j1 = min(3, t >> 1);
  const bool active = j0 + half <= j1;
  const int j = active ? j0 + half : j0;
  const int i = t - 2 * j;
  return {active, 4 * i, 4 * j, ((j >> 1) << 3) | ((i >> 1) << 2) | ((j & 1) << 1) | (i & 1)};
}

// Calls f(StepIndex<S>{}) for S = T .. Last - 1 in order: the step is
// a compile-time constant in each call, so its geometry folds and the
// per-step values of the caller's arrays stay in registers (a runtime loop,
// even under #pragma unroll, left them in local memory).
template <int T>
struct StepIndex {
  static constexpr int value = T;
};

template <int T, int Last, typename F>
__device__ __forceinline__ void for_steps(F& f) {
  if constexpr (T < Last) {
    f(StepIndex<T>{});
    for_steps<T + 1, Last>(f);
  }
}

constexpr int kDcTaps = INT32_MIN;  // taps word of a DC block: no tap

// The taps word of one sample of a non-DC block: its packed-table entry
// `code` (ops/intra.packed_mode_table: sample indices of p in bits 0-11,
// weights 12-17, rounding 18-19, shift 20-21) turned into offsets from the
// block's corner cell in sc.ext (p[0] the corner, p[1..4] the left column,
// p[5..8] the top row, p[9..12] the above-right samples, which replicate
// the last top sample where `rep`): offsets in bits 0-6, 7-13, 14-20 (at
// most 4 * 21 + 8), weights 21-26, rounding 27-28, shift 29-30.
__device__ __forceinline__ int pack_taps(int code, bool rep) {
  int taps = ((code >> 12) & 0x3ff) << 21;  // weights, rounding and shift, in order
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int idx = (code >> (4 * k)) & 15;
    const int row = idx >= 1 && idx <= 4 ? idx : 0;
    const int col = idx < 5 ? 0 : (rep && idx >= 9 ? 4 : idx - 4);
    taps |= (row * 21 + col) << (7 * k);
  }
  return taps;
}

// Code one MB as Intra_4x4; all 32 lanes of one warp call it. src: the
// MB's 16x16 source samples (row-major, in shared memory); modes: its 16
// Z-scan modes; nb: its neighbours (with an active hook only nb.tr_ok is
// read). Leaves the reconstruction in sc.ext and writes the quantised
// levels to lv[16 * z + zig-zag index].
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
// in 10 steps t = 0..9, two at once on t = 2..7 (i4_step), one sample per
// lane. Before the steps each lane reads what does not depend on the
// reconstruction: for every step its source sample and its mode's three
// taps as offsets into sc.ext (pack_taps), so a step's prediction is three
// (or, for DC, eight) independent shared loads and no lane branches on the
// mode; the transform passes move values between the lanes of a half-warp
// with shuffles. The two blocks of a step read only cells of earlier steps
// and write disjoint cells, so one __syncwarp per step orders it all. The
// steps are unrolled at compile time (for_steps).
template <typename Hook = NoStepHook>
__device__ void i4x4_mb(const uint8_t* src, const int* modes, const MbNbr& nb,
                        int qp, const QpTab& tab, int* lv, I4Scratch& sc, int lane,
                        const Hook& hook = Hook()) {
  if constexpr (!Hook::kActive) {
    for (int i = lane; i < 37; i += 32) {
      if (i < 21) {
        sc.ext[0][i] = i == 0 ? nb.corner : nb.top[i - 1];
      } else {
        sc.ext[i - 20][0] = nb.left[i - 21];
      }
    }
  }
  const int half = lane >> 4, h = lane & 15, base = lane & 16;
  const int x = h & 3, y = h >> 2;  // the lane's sample of its block
  const int pt = pat(y, x);  // selects, not an index: QpTab stays in registers
  const int lq = pt == 0 ? tab.lq[0] : pt == 1 ? tab.lq[1] : tab.lq[2];
  const int ls = pt == 0 ? tab.ls[0] : pt == 1 ? tab.ls[1] : tab.ls[2];
  const int zz = inv_zigzag(h);
  int taps[10], sv[10];  // per step: the prediction's taps, the source sample
  auto plan = [&](auto step) {
    constexpr int t = decltype(step)::value;
    const I4Step st = i4_step(t, half);
    const int m = modes[st.z];
    const bool rep = st.z == 3 || st.z == 11 || (st.bx == 12 && (st.by > 0 || !nb.tr_ok));
    taps[t] = m == 2 ? kDcTaps : pack_taps(sc.pred[16 * m + h], rep);
    sv[t] = src[(st.by + y) * 16 + st.bx + x];
  };
  for_steps<0, 10>(plan);
  __syncwarp();
  auto code = [&](auto step) {
    constexpr int t = decltype(step)::value;
    if constexpr (Hook::kActive) hook.before(t);
    const I4Step st = i4_step(t, half);
    const int* e = &sc.ext[st.by][st.bx];  // e[0] is the block's corner p[0]
    const int tp = taps[t];
    const int tab3 = ((tp >> 27) & 3) + ((tp >> 21) & 3) * e[tp & 127] +
                     ((tp >> 23) & 3) * e[(tp >> 7) & 127] +
                     ((tp >> 25) & 3) * e[(tp >> 14) & 127];
    // DC: availability from the -1 samples (intra.cpp:164-181)
    const int top4 = e[1] + e[2] + e[3] + e[4];
    const int left4 = e[21] + e[42] + e[63] + e[84];
    const int dc = e[0] != -1   ? (top4 + left4 + 4) >> 3
                   : e[21] != -1 ? (left4 + 2) >> 2
                   : e[1] != -1  ? (top4 + 2) >> 2 : 128;
    const int pred = tp == kDcTaps ? dc : tab3 >> ((tp >> 29) & 3);
    const int diff = sv[t] - pred;
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
    if (st.active) {
      lv[16 * st.z + zz] = q;
      sc.ext[st.by + 1 + y][st.bx + 1 + x] = clip255(pred + ((r + 32) >> 6));
    }
    __syncwarp();
    if constexpr (Hook::kActive) hook.after(t);
  };
  for_steps<0, 10>(code);
}

}  // namespace
