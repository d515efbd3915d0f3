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
// Design: one launch a frame or band, a half-warp per MB (two MBs a warp,
// eight a block, in raster order across row ends), a lane per 4x4 block
// (raster in the MB), every lane doing the same work, with no shared memory
// and no barrier (the first design, a block per MB with a thread per (mode,
// block), waited on one thread's Intra16x16 parameters and ran its tail on
// a few threads). A lane reads its 16 source samples and 13 neighbour
// samples from the plane (-1 where the twin has -1), then scores, in
// registers, the 4 Intra16x16 modes of its block and, in the full form, its
// 9 Intra4x4 modes, the modes and samples unrolled at compile time: an
// Intra4x4 prediction is three taps of fixed registers from the mode table
// compiled in (kPred4, ops/intra.packed_mode_table), the Intra16x16
// parameters (DC, Plane's H and V) are sums over the half-warp by xor
// shuffles, the MB's top and left samples shuffles from the lanes of its
// first row and column. Each lane keeps its first least gated Intra4x4
// cost (a strict < over modes in order, as the twin's _first_min); the
// per-mode Intra16x16 sums and the sum of the 16 chosen costs are xor
// shuffle sums, and lane 0 of the MB writes its Intra16x16 choice.

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_common.cuh"

namespace {

constexpr int kBig = 1 << 30;  // the gate of a mode whose neighbour is missing
constexpr int kWarps = 4;      // a block: 4 warps, 8 MBs
constexpr unsigned kAll = 0xffffffffu;

// ops/intra.packed_mode_table, read at compile time only: per (Intra4x4
// mode, sample 4 y + x) the indices into p of three samples (bits 0-3, 4-7,
// 8-11), their weights (12-13, 14-15, 16-17), the rounding (18-19) and the
// shift (20-21); 0 for DC
__host__ __device__ constexpr int pred4_code(int i) {
  constexpr int kPred4[144] = {
      0x001005, 0x001006, 0x001007, 0x001008, 0x001005, 0x001006, 0x001007, 0x001008,
      0x001005, 0x001006, 0x001007, 0x001008, 0x001005, 0x001006, 0x001007, 0x001008,
      0x001001, 0x001001, 0x001001, 0x001001, 0x001002, 0x001002, 0x001002, 0x001002,
      0x001003, 0x001003, 0x001003, 0x001003, 0x001004, 0x001004, 0x001004, 0x001004,
      0x000000, 0x000000, 0x000000, 0x000000, 0x000000, 0x000000, 0x000000, 0x000000,
      0x000000, 0x000000, 0x000000, 0x000000, 0x000000, 0x000000, 0x000000, 0x000000,
      0x299765, 0x299876, 0x299987, 0x299A98, 0x299876, 0x299987, 0x299A98, 0x299BA9,
      0x299987, 0x299A98, 0x299BA9, 0x299CBA, 0x299A98, 0x299BA9, 0x299CBA, 0x28D0CB,
      0x296510, 0x299650, 0x299765, 0x299876, 0x299210, 0x296510, 0x299650, 0x299765,
      0x299321, 0x299210, 0x296510, 0x299650, 0x299432, 0x299321, 0x299210, 0x296510,
      0x145050, 0x145065, 0x145076, 0x145087, 0x296510, 0x299650, 0x299765, 0x299876,
      0x299210, 0x145050, 0x145065, 0x145076, 0x299321, 0x296510, 0x299650, 0x299765,
      0x145010, 0x296510, 0x299650, 0x299765, 0x145021, 0x299210, 0x145010, 0x296510,
      0x145032, 0x299321, 0x145021, 0x299210, 0x145043, 0x299432, 0x145032, 0x299321,
      0x145065, 0x145076, 0x145087, 0x145098, 0x299765, 0x299876, 0x299987, 0x299A98,
      0x145076, 0x145087, 0x145098, 0x1450A9, 0x299876, 0x299987, 0x299A98, 0x299BA9,
      0x145021, 0x299321, 0x145032, 0x299432, 0x145032, 0x299432, 0x145043, 0x28D043,
      0x145043, 0x28D043, 0x001004, 0x001004, 0x001004, 0x001004, 0x001004, 0x001004};
  return kPred4[i];
}

// the gate each Intra4x4 mode reads (intra_decision._GATE4, "tlntccctl" for
// V H DC DDL DDR VR HD VL HU): 0 top, 1 left, 2 none, 3 corner
__host__ __device__ constexpr int gate4(int m) { return (0x103330210 >> (4 * m)) & 15; }

struct Args {
  const int32_t* top_row;  // (W,) source row above the plane, or null
  int32_t* out;            // mode16, satd16 (nmb each), then satd4 (nmb), mode4 (nmb, 16)
  int wmb, nmb, qp;
  int lq[3];               // LEVEL_QUANTIZE of qp in QpTab's pattern order
};

// quant_ac(coef, qp, lq[k]) as ((coef >> s) * mul[k] + add[k]) >> 15: below
// QP 24 s = 0, mul = lq << qbits and add = 16384 - adjust * lq (the same
// int32 value), from QP 24 s = qp / 6 - 4, mul = lq and add = 16384
struct Quant {
  int s, mul[3], add[3];
};

__device__ __forceinline__ Quant make_quant(int qp, const int (&lq)[3]) {
  Quant q;
  q.s = qp < 24 ? 0 : qp / 6 - 4;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q.mul[k] = qp < 24 ? lq[k] * pow2(4 - qp / 6) : lq[k];
    q.add[k] = qp < 24 ? 16384 - (1 << (3 - qp / 6)) * lq[k] : 16384;
  }
  return q;
}

// Sum of |q| over the 4x4 residual block d (row-major, 4 y + x): the
// forward core transform (columns, then rows), then the quantisation of
// every coefficient with the inter rounding (transform.quantize_residual(...,
// qp, False)).
__device__ __forceinline__ int block_satd(const int (&d)[16], const Quant& q) {
  int f[16];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    int a[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) a[y] = d[4 * y + x] == 0 ? 0 : d[4 * y + x] * 64 - 32;
#pragma unroll
    for (int i = 0; i < 4; ++i) f[4 * i + x] = fwd_step(i, a[0], a[1], a[2], a[3]);
  }
  int sum = 0;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int coef = fwd_step(j, f[4 * y], f[4 * y + 1], f[4 * y + 2], f[4 * y + 3]);
      const int k = pat(y, j);
      const int v = ((coef >> q.s) * q.mul[k] + q.add[k]) >> 15;
      sum += v < 0 ? -v : v;
    }
  }
  return sum;
}

// Sample (x, y) of the plane as a block's neighbour: -1 left of the plane
// or beyond its width; the row above the plane (y = -1) is top_row, or -1
// without one.
template <typename T>
__device__ __forceinline__ int sample(const T* __restrict__ plane, const int32_t* top_row,
                                      int W, int x, int y) {
  if (x < 0 || x >= W) return -1;
  if (y >= 0) return (int)plane[(size_t)y * W + x];
  return top_row ? top_row[x] : -1;
}

// xor-shuffle sum over the lane's half-warp
__device__ __forceinline__ int half_sum(int v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

// The Intra4x4 prediction of mode M, samples K .. 15, from the block's
// neighbours p (p[0] the corner, p[1..4] the left column, p[5..8] the top
// row, p[9..12] the above-right samples) and its DC value dc: each sample's
// three taps, weights, rounding and shift known at compile time.
template <int M, int K = 0>
__device__ __forceinline__ void pred4(const int (&p)[13], int dc, int (&pred)[16]) {
  if constexpr (K < 16) {
    constexpr int c = pred4_code(16 * M + K);
    if constexpr (M == 2) {
      pred[K] = dc;
    } else {
      pred[K] = (((c >> 12) & 3) * p[c & 15] + ((c >> 14) & 3) * p[(c >> 4) & 15] +
                 ((c >> 16) & 3) * p[(c >> 8) & 15] + ((c >> 18) & 3)) >> ((c >> 20) & 3);
    }
    pred4<M, K + 1>(p, dc, pred);
  }
}

// Score Intra4x4 modes M .. 8 of one block into its first least gated cost
// (best, mode): a strict < in mode order.
template <int M = 0>
__device__ __forceinline__ void i4_modes(const int (&src)[16], const int (&p)[13], int dc,
                                         const Quant& q, int& best, int& mode) {
  if constexpr (M < 9) {
    int pred[16], d[16];
    pred4<M>(p, dc, pred);
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = src[k] - pred[k];
    constexpr int g = gate4(M);
    const bool ok = g == 2 || (g == 0 ? p[5] : g == 1 ? p[1] : p[0]) != -1;
    const int cost = block_satd(d, q) + (ok ? 0 : kBig);
    if (M == 0 || cost < best) {
      best = cost;
      mode = M;
    }
    i4_modes<M + 1>(src, p, dc, q, best, mode);
  }
}

template <typename T, bool kFull>
__global__ void __launch_bounds__(kWarps * 32)
    decide_kernel(const T* __restrict__ y, Args a) {
  const int lane = threadIdx.x & 31, h = lane & 15, base = lane & 16;
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (2 * pair >= a.nmb) return;
  // a half-warp past the last MB scores the last MB again and writes nothing
  const bool live = 2 * pair + (lane >> 4) < a.nmb;
  const int mb = live ? 2 * pair + (lane >> 4) : a.nmb - 1;
  const int W = 16 * a.wmb, c = mb % a.wmb;
  const int i = h & 3, j = h >> 2;  // the lane's block: column, row
  const int bx = 16 * c + 4 * i, by = 16 * (mb / a.wmb) + 4 * j;
  int src[16], p[13];
#pragma unroll
  for (int k = 0; k < 16; ++k) src[k] = (int)y[(size_t)(by + (k >> 2)) * W + bx + (k & 3)];
  p[0] = sample(y, a.top_row, W, bx - 1, by - 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p[1 + k] = sample(y, a.top_row, W, bx - 1, by + k);
    p[5 + k] = sample(y, a.top_row, W, bx + k, by - 1);
  }
  const Quant q = make_quant(a.qp, a.lq);

  // Intra16x16: the MB's top row from lanes 0-3, its left column from lanes
  // 0, 4, 8, 12, the predictor's sums over the half-warp (H = sum of (k - 7)
  // top[k] - 8 corner, V likewise on the left)
  int top[4], left[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    top[k] = __shfl_sync(kAll, p[5 + k], base + i);
    left[k] = __shfl_sync(kAll, p[1 + k], base + 4 * j);
  }
  const int corner = __shfl_sync(kAll, p[0], base);
  const int top0 = __shfl_sync(kAll, p[5], base), left0 = __shfl_sync(kAll, p[1], base);
  const int top15 = __shfl_sync(kAll, p[8], base + 3);
  const int left15 = __shfl_sync(kAll, p[4], base + 12);
  int st = 0, sl = 0, hg = 0, vg = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    st += j == 0 ? p[5 + k] : 0;
    sl += i == 0 ? p[1 + k] : 0;
    hg += j == 0 ? (4 * i + k - 7) * p[5 + k] : 0;
    vg += i == 0 ? (4 * j + k - 7) * p[1 + k] : 0;
  }
  st = half_sum(st);
  sl = half_sum(sl);
  hg = half_sum(hg) - 8 * corner;
  vg = half_sum(vg) - 8 * corner;
  const int dc16 = corner != -1 ? (st + sl + 16) >> 5
                   : left0 != -1 ? (sl + 8) >> 4
                   : top0 != -1  ? (st + 8) >> 4 : 128;
  const int pa = (left15 + top15) * 16, pb = (5 * hg + 32) >> 6, pc = (5 * vg + 32) >> 6;
  int sum16[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    int d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int x = k & 3, yy = k >> 2;
      const int pred = m == 0 ? top[x] : m == 1 ? left[yy] : m == 2 ? dc16
                       : clip255((pa + pb * (4 * i + x - 7) + pc * (4 * j + yy - 7) + 16) >> 5);
      d[k] = src[k] - pred;
    }
    sum16[m] = half_sum(block_satd(d, q));
  }
  const int gate16[4] = {top0 != -1 ? 0 : kBig, left0 != -1 ? 0 : kBig, 0,
                         corner != -1 ? 0 : kBig};  // V top, H left, DC, Plane corner
  int best16 = sum16[0] + gate16[0], mode16 = 0;
#pragma unroll
  for (int m = 1; m < 4; ++m) {
    if (sum16[m] + gate16[m] < best16) {
      best16 = sum16[m] + gate16[m];
      mode16 = m;
    }
  }

  if constexpr (kFull) {
    const int z = ((j >> 1) << 3) | ((i >> 1) << 2) | ((j & 1) << 1) | (i & 1);
    const bool rep = z == 3 || z == 11 || (i == 3 && (j > 0 || c + 1 == a.wmb));
#pragma unroll
    for (int k = 0; k < 4; ++k) p[9 + k] = rep ? p[8] : sample(y, a.top_row, W, bx + 4 + k, by - 1);
    // DC: availability from the -1 samples (intra.cpp:164-181)
    const int top4 = p[5] + p[6] + p[7] + p[8], left4 = p[1] + p[2] + p[3] + p[4];
    const int dc = p[0] != -1 ? (top4 + left4 + 4) >> 3
                   : p[1] != -1 ? (left4 + 2) >> 2
                   : p[5] != -1 ? (top4 + 2) >> 2 : 128;
    int best4 = 0, mode4 = 0;
    i4_modes(src, p, dc, q, best4, mode4);
    const int sum4 = half_sum(best4);
    if (live) {
      a.out[3 * (size_t)a.nmb + 16 * (size_t)mb + z] = mode4;
      if (h == 0) a.out[2 * a.nmb + mb] = sum4;
    }
  }
  if (live && h == 0) {
    a.out[mb] = mode16;
    a.out[a.nmb + mb] = best16;
  }
}

template <typename T>
cudaError_t launch(const void* y, const Args& a, bool full, cudaStream_t stream) {
  const T* p = static_cast<const T*>(y);
  const int blocks = (a.nmb + 2 * kWarps - 1) / (2 * kWarps);
  if (full)
    decide_kernel<T, true><<<blocks, kWarps * 32, 0, stream>>>(p, a);
  else
    decide_kernel<T, false><<<blocks, kWarps * 32, 0, stream>>>(p, a);
  return cudaGetLastError();
}

}  // namespace

// The mode decision of a (16 hmb, 16 wmb) source luma plane y (uint8 where
// is_u8, else int32) at qp, in one launch on `stream`. top_row: the (W,)
// int32 source row above the plane, or null (the frame's top). full: 1 for
// the full form (with Intra4x4), 0 for the I16 form. out (int32): mode16
// (nmb) and satd16 (nmb); the full form then satd4 (nmb) and mode4 (nmb,
// 16, Z-scan). qtab: 3 ints, LEVEL_QUANTIZE of qp in QpTab's order (more
// may follow). *launched gets 1 when the launch was accepted. Returns its
// CUDA error (0 when accepted).
extern "C" int mode_decision(const void* y, int is_u8, const int32_t* top_row, int full,
                             int32_t* out, int wmb, int hmb, int qp, const int* qtab,
                             cudaStream_t stream, int* launched) {
  *launched = 0;
  Args a{top_row, out, wmb, wmb * hmb, qp, {qtab[0], qtab[1], qtab[2]}};
  if (a.nmb <= 0) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = is_u8 ? launch<uint8_t>(y, a, full != 0, stream)
                                : launch<int32_t>(y, a, full != 0, stream);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
