// Whole-frame intra mode decision (K11) for sm_90a.
//
// The device form of the XLA program intra_mode_decision_impl
// (h264_fer_tpu/codec/tpu_intra.py:55) with modes_only=True; no Pallas
// kernel replaced it. Its plain twins are codec/intra_decision
// .intra16_mode_decision_plain (the I16 form, i16_only=True) and
// intra_mode_decision_plain (the full form). From the source plane alone,
// with no dependency between MBs: the SATD (sum of |quantised forward
// transform| of source minus prediction per 4x4 block, inter rounding at the
// real QP, intra.cpp:819) of the 4 Intra16x16 modes of each MB (16 blocks
// each) and, in the full form, of the 9 Intra4x4 modes of each 4x4 block;
// the availability gates (1 << 30 added where the mode's neighbour sample is
// -1); and the first least gated cost in mode order, with its value.
//
// Neighbours, as the twin reads them: -1 outside the frame; the row above
// the plane is top_row where given (a band's source row above, in which -1
// also means unavailable), and the first MB column's corner is -1 even then.
// Intra4x4's above-right samples are the last top sample (intra.cpp:345-370)
// at the frame's right edge, in the MB's right column below its top row and
// for Z-blocks 3 and 11.
//
// What bounds it on an H100: operations. At 1920x1088 the full form scores
// 1.2 M Intra4x4 and 0.5 M Intra16x16 4x4-block candidates, each 16 samples
// of some 21 int32 operations (residual, two transform passes, quantisation,
// the sum) and its prediction: ~0.65 G operations, 0.039 ms at the CUDA
// cores' int32 rate (chip_smoke.k11_ops); the I16 form 0.011 ms. Its bytes
// (a 2.1 MB uint8 plane or an 8.4 MB int32 one in, 0.6 MB out) take less.
//
// Design: one block per MB, one launch per frame or band. The block stages
// the MB's source with its neighbours in shared memory as int (I4Scratch
// .ext of csrc/intra4x4.cuh: the corner, the 16 top samples and 4
// above-right ones in row 0, the left column in column 0, the MB at [1 + y][1
// + x]; the left column also contiguous for the Intra16x16 predictor) and,
// in the full form, the Intra4x4 prediction table as taps (pack_taps of
// every (mode, sample), without and with the replica). Then each thread scores
// one 4x4 block in one mode, in registers: warps 0-1 the 64 Intra16x16
// (mode, block) pairs, after thread 0 has computed the DC and Plane
// parameters of the MB once (csrc/intra16.cuh's predictor; the two warps
// wait on their own named barrier); in the full form warps 2-6 the 144
// Intra4x4 pairs, their prediction three weighted taps per sample from the
// table (pack_taps, as K4x4 reads it) or the block's DC. The costs go to
// shared memory. After one barrier, 16 threads take each block's first
// least gated Intra4x4 cost (a strict < scan over modes 0..8, as the twin's
// _first_min), 4 threads each Intra16x16 mode's sum, and thread 0 the
// Intra16x16 choice and the sum of the 16 chosen Intra4x4 costs.

#include <cstdint>
#include <cuda_runtime.h>

#include "intra16.cuh"
#include "intra4x4.cuh"

namespace {

constexpr int kBig = 1 << 30;  // the gate of a mode whose neighbour is missing
constexpr int kI16Threads = 64;     // 4 modes x 16 blocks, warps 0-1
constexpr int kI4Threads = 144;     // 9 modes x 16 blocks, from thread 64 on
constexpr int kFullThreads = 224;   // 64 + 144, in whole warps
constexpr int kExtCells = 17 * 21;  // I4Scratch.ext

// the neighbour each Intra4x4 mode's gate reads (intra_decision._GATE4,
// "tlntccctl" for V H DC DDL DDR VR HD VL HU): 0 top, 1 left, 2 none, 3 corner
__constant__ int kGate4[9] = {0, 1, 2, 0, 3, 3, 3, 0, 1};

struct Args {
  const int32_t* top_row;  // (W,) source row above the plane, or null
  const int32_t* pred4;    // ops/intra.packed_mode_table (144), null in the I16 form
  int32_t* out;            // mode16, satd16 (nmb each), then satd4 (nmb), mode4 (nmb, 16)
  int wmb, nmb, qp;
  int lq[3];               // LEVEL_QUANTIZE of qp in QpTab's pattern order
};

struct Smem {
  I4Scratch sc;       // ext only: the table goes to taps
  int taps[2][144];   // pack_taps of every (mode, sample), without and with the replica
  int left[16];
  int par[4];         // the Intra16x16 DC value and Plane a, b, c
  int cost16[4][16];  // per mode and block, ungated
  int cost4[16][9];   // per block and mode, gated
  int sum16[4];
  int best4[16];
};

// Sum of |q| over a 4x4 residual block d (row-major, 4 y + x): the forward
// core transform (columns, then rows), then the quantisation of every
// coefficient with the inter rounding (transform.quantize_residual(...,
// qp, False)).
__device__ __forceinline__ int block_satd(const int (&d)[16], int qp, const int (&lq)[3]) {
  int a[16], f[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) a[k] = d[k] == 0 ? 0 : d[k] * 64 - 32;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[4 * i + x] = fwd_step(i, a[x], a[4 + x], a[8 + x], a[12 + x]);
  }
  int sum = 0;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int coef = fwd_step(j, f[4 * y], f[4 * y + 1], f[4 * y + 2], f[4 * y + 3]);
      const int q = quant_ac(coef, qp, lq[pat(y, j)]);
      sum += q < 0 ? -q : q;
    }
  }
  return sum;
}

// Sample x of the source row above MB row r (y0 its first sample row): the
// plane's row y0 - 1, or top_row on the first MB row (-1 without one), -1
// beyond the plane's width W.
template <typename T>
__device__ __forceinline__ int above(const T* __restrict__ y, const int32_t* top_row, int W,
                                     int y0, int x) {
  if (x >= W) return -1;
  if (y0 > 0) return (int)y[(size_t)(y0 - 1) * W + x];
  return top_row ? top_row[x] : -1;
}

template <typename T, bool kFull>
__global__ void __launch_bounds__(kFull ? kFullThreads : kI16Threads)
    decide_kernel(const T* __restrict__ y, Args a) {
  __shared__ Smem s;
  const int mb = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int W = 16 * a.wmb, c = mb % a.wmb, x0 = 16 * c, y0 = 16 * (mb / a.wmb);

  for (int k = tid; k < kExtCells; k += nth) {
    const int row = k / 21, col = k % 21;
    if (row == 0) {
      s.sc.ext[0][col] = col == 0 ? (c > 0 ? above(y, a.top_row, W, y0, x0 - 1) : -1)
                                  : above(y, a.top_row, W, y0, x0 + col - 1);
    } else if (col == 0) {
      const int v = c > 0 ? (int)y[(size_t)(y0 + row - 1) * W + x0 - 1] : -1;
      s.sc.ext[row][0] = v;
      s.left[row - 1] = v;
    } else if (col <= 16) {
      s.sc.ext[row][col] = (int)y[(size_t)(y0 + row - 1) * W + x0 + col - 1];
    }
  }
  if constexpr (kFull) {
    for (int k = tid; k < 288; k += nth)
      s.taps[k / 144][k % 144] = pack_taps(a.pred4[k % 144], k >= 144);
  }
  __syncthreads();

  const int corner = s.sc.ext[0][0];
  const int* top = &s.sc.ext[0][1];
  if (tid < kI16Threads) {
    if (tid == 0)
      i16_params(top, s.left, corner, corner != -1, s.left[0] != -1, top[0] != -1, s.par);
    group_sync(1, kI16Threads);
    const int m = tid >> 4, z = tid & 15;
    const int bx = 4 * z_col(z), by = 4 * z_row(z);
    int d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int X = bx + (k & 3), Y = by + (k >> 2);
      d[k] = s.sc.ext[1 + Y][1 + X] - i16_pred(m, X, Y, top, s.left, s.par);
    }
    s.cost16[m][z] = block_satd(d, a.qp, a.lq);
  } else if (kFull && tid < kI16Threads + kI4Threads) {
    const int v = tid - kI16Threads, m = v >> 4, z = v & 15;
    const int i = z_col(z), j = z_row(z);
    const int* e = &s.sc.ext[4 * j][4 * i];  // e[0] is the block's corner
    const bool rep = z == 3 || z == 11 || (i == 3 && (j > 0 || c + 1 == a.wmb));
    // DC: availability from the -1 samples (intra.cpp:164-181)
    const int top4 = e[1] + e[2] + e[3] + e[4];
    const int left4 = e[21] + e[42] + e[63] + e[84];
    const int dc = e[0] != -1 ? (top4 + left4 + 4) >> 3
                   : e[21] != -1 ? (left4 + 2) >> 2
                   : e[1] != -1  ? (top4 + 2) >> 2 : 128;
    const int* taps = &s.taps[rep][16 * m];
    int d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int tp = taps[k];  // DC's table entry is 0: no tap
      const int tab3 = ((tp >> 27) & 3) + ((tp >> 21) & 3) * e[tp & 127] +
                       ((tp >> 23) & 3) * e[(tp >> 7) & 127] +
                       ((tp >> 25) & 3) * e[(tp >> 14) & 127];
      const int pred = m == 2 ? dc : tab3 >> ((tp >> 29) & 3);
      d[k] = e[(1 + (k >> 2)) * 21 + 1 + (k & 3)] - pred;
    }
    const int g = kGate4[m];
    const bool ok = g == 2 || (g == 0 ? e[1] : g == 1 ? e[21] : e[0]) != -1;
    s.cost4[z][m] = block_satd(d, a.qp, a.lq) + (ok ? 0 : kBig);
  }
  __syncthreads();

  if (kFull && tid < 16) {
    int best = s.cost4[tid][0], idx = 0;
#pragma unroll
    for (int m = 1; m < 9; ++m) {
      if (s.cost4[tid][m] < best) {
        best = s.cost4[tid][m];
        idx = m;
      }
    }
    s.best4[tid] = best;
    a.out[3 * (size_t)a.nmb + 16 * (size_t)mb + tid] = idx;
  } else if (tid >= 32 && tid < 36) {
    int sum = 0;
    for (int z = 0; z < 16; ++z) sum += s.cost16[tid - 32][z];
    s.sum16[tid - 32] = sum;
  }
  __syncthreads();
  if (tid == 0) {
    const int gate[4] = {top[0] != -1 ? 0 : kBig, s.left[0] != -1 ? 0 : kBig, 0,
                         corner != -1 ? 0 : kBig};  // V top, H left, DC, Plane corner
    int best = s.sum16[0] + gate[0], idx = 0;
#pragma unroll
    for (int m = 1; m < 4; ++m) {
      if (s.sum16[m] + gate[m] < best) {
        best = s.sum16[m] + gate[m];
        idx = m;
      }
    }
    a.out[mb] = idx;
    a.out[a.nmb + mb] = best;
    if constexpr (kFull) {
      int sum = 0;
      for (int z = 0; z < 16; ++z) sum += s.best4[z];
      a.out[2 * a.nmb + mb] = sum;
    }
  }
}

template <typename T>
cudaError_t launch(const void* y, const Args& a, bool full, cudaStream_t stream) {
  const T* p = static_cast<const T*>(y);
  if (full)
    decide_kernel<T, true><<<a.nmb, kFullThreads, 0, stream>>>(p, a);
  else
    decide_kernel<T, false><<<a.nmb, kI16Threads, 0, stream>>>(p, a);
  return cudaGetLastError();
}

}  // namespace

// The mode decision of a (16 hmb, 16 wmb) source luma plane y (uint8 where
// is_u8, else int32) at qp, in one launch on `stream`. top_row: the (W,)
// int32 source row above the plane, or null (the frame's top). pred4: the
// Intra4x4 prediction table (ops/intra.packed_mode_table) for the full
// form, null for the I16 form. out (int32): mode16 (nmb) and satd16 (nmb);
// the full form then satd4 (nmb) and mode4 (nmb, 16, Z-scan). qtab: 3 ints,
// LEVEL_QUANTIZE of qp in QpTab's order (more may follow). *launched gets 1
// when the launch was accepted. Returns its CUDA error (0 when accepted).
extern "C" int mode_decision(const void* y, int is_u8, const int32_t* top_row,
                             const int32_t* pred4, int32_t* out, int wmb, int hmb, int qp,
                             const int* qtab, cudaStream_t stream, int* launched) {
  *launched = 0;
  Args a{top_row, pred4, out, wmb, wmb * hmb, qp, {qtab[0], qtab[1], qtab[2]}};
  if (a.nmb <= 0) return (int)cudaErrorInvalidConfiguration;
  const bool full = pred4 != nullptr;
  const cudaError_t err = is_u8 ? launch<uint8_t>(y, a, full, stream)
                                : launch<int32_t>(y, a, full, stream);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
