// Mixed I-frame arbitration wavefront (K6): the exact Intra_4x4-vs-
// Intra_16x16 choice per MB by coded bit size, for sm_90a.
//
// The device form of the XLA loop wavefront_mixed_luma_impl
// (h264_fer_tpu/kernels/wavefront_mixed.py:54, fori_loop at :411); no
// Pallas kernel replaced it. For every MB: the I16 candidate (prediction in
// the decided mode, 4x4 DCT, quantisation, 4x4 Hadamard DC path, inverse,
// reconstruction), the I4x4 candidate (csrc/intra4x4.cuh, in the decided
// block modes), the prediction-mode syntax (MPM), the exact CAVLC bits of
// both candidates' macroblock layers with the chroma bits given, the
// strict choice size4 < size16 (intra.cpp:1088), and the state its later
// neighbours read: the winner's reconstruction, TotalCoeffs, CBP and class.
//
// What bounds it on an H100: neither bytes (~2 MB of uint8 planes in and out
// and ~27 MB of int32 levels and state per 1920x1088 frame, ~9 us at
// 3.35 TB/s) nor operations (two candidate codings and 33 CAVLC block sizes
// per MB, some 150 int32 operations per sample, ~25 us). The floor is the
// dependency chain, three ways: the winner's reconstruction feeds the
// neighbours' prediction, its TotalCoeffs their nC contexts, its class
// their most-probable modes. MB (r, c) waits for (r - 1, c + 1), so the MBs
// run as 2 * (hmb - 1) + wmb knight waves d = 2r + c (254 at 1080p), each
// at most wmb / 2 + 1 (61) MBs.
//
// Design: one launch per knight wave, one 288-thread block per MB. The two
// candidates run at once: the I16 one on warps 0..7, a thread per sample
// on its own named barrier (K1's luma function, csrc/intra16.cuh), the
// I4x4 one on warp 8 (K4x4's function, csrc/intra4x4.cuh). Then the CAVLC
// sizes run a thread per block (1 DC, 16 AC and 16 I4 blocks), each
// looping over its 16 levels. The length
// tables come in one device buffer from ops/cavlc_tables.py (see TABLES in
// kernels/wavefront_mixed.py). The state goes to global memory at the end of
// each MB and later launches read it, in stream order. Shortening the
// MB's 16 I4x4 steps and filling the card are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "intra16.cuh"
#include "intra4x4.cuh"

namespace {

// offsets in the table buffer
constexpr int kCtLen = 0;      // coeff_token length [ctx 0..4][tc 0..16][t1 0..3]
constexpr int kTzLen = 340;    // total_zeros length [tc - 1][zeros 0..15]
constexpr int kRbLen = 580;    // run_before length [zeros_left - 1][run 0..6]
constexpr int kCbpCode = 622;  // intra CBP code number [cbp_chroma << 4 | cbp_luma]

// per Z-scan block: A (left) in this MB, A's block, B (above) in this MB,
// B's block (ops/tables.LUMA_NBR)
__constant__ int kLumaNbr[16][4] = {
    {0, 5, 0, 10}, {1, 0, 0, 11}, {0, 7, 1, 0},  {1, 2, 1, 1},
    {1, 1, 0, 14}, {1, 4, 0, 15}, {1, 3, 1, 4},  {1, 6, 1, 5},
    {0, 13, 1, 2}, {1, 8, 1, 3},  {0, 15, 1, 8}, {1, 10, 1, 9},
    {1, 9, 1, 6},  {1, 12, 1, 7}, {1, 11, 1, 12}, {1, 14, 1, 13}};

// Bit length of ue(v), v >= 0: 2 floor(log2(v + 1)) + 1.
__device__ __forceinline__ int ue_bits(int v) { return 2 * (31 - __clz(v + 1)) + 1; }

// CAVLC bits of one block apart from its coeff_token (block_symbols_bulk's
// rest_bits, ops/cavlc_bulk.py): trailing-one signs, level prefixes and
// suffixes with the adaptive suffixLength, total_zeros, run_before. lv: the
// block's L (15 or 16 = maxNumCoeff) levels in zig-zag order. Sets *tc and
// *t1 (TotalCoeff, TrailingOnes).
__device__ int rest_bits(const int* lv, int L, const int32_t* __restrict__ tabs,
                         int* tc_out, int* t1_out) {
  int vals[16], pos[16];
  int tc = 0;
  for (int i = L - 1; i >= 0; --i) {
    if (lv[i] != 0) {
      vals[tc] = lv[i];
      pos[tc] = i;
      ++tc;
    }
  }
  int t1 = 0;
  while (t1 < tc && t1 < 3 && (vals[t1] == 1 || vals[t1] == -1)) ++t1;
  int bits = t1;
  int sl = (tc > 10 && t1 < 3) ? 1 : 0;
  for (int i = t1; i < tc; ++i) {
    const int v = vals[i];
    int code = v > 0 ? 2 * v - 2 : -2 * v - 1;
    if (i == t1 && t1 < 3) code -= 2;
    if (sl == 0) {
      bits += code < 14 ? code + 1 : (code < 30 ? 19 : 28);
    } else {
      const int pr = code >> sl;
      bits += pr < 15 ? pr + 1 + sl : 28;
    }
    const int sl1 = sl > 1 ? sl : 1;
    const int av = v < 0 ? -v : v;
    sl = sl1 + ((av > 3 * pow2(sl1 - 1) && sl1 < 6) ? 1 : 0);
  }
  if (tc > 0 && tc < L) bits += tabs[kTzLen + (tc - 1) * 16 + pos[0] + 1 - tc];
  for (int k = 0; k + 1 < tc; ++k) {
    const int zl = pos[k] + k + 1 - tc;
    if (zl <= 0) continue;
    const int run = pos[k] - pos[k + 1] - 1;
    bits += zl > 6 ? (run < 7 ? 3 : run - 3) : tabs[kRbLen + (zl - 1) * 7 + run];
  }
  *tc_out = tc;
  *t1_out = t1;
  return bits;
}

// TotalCoeff of block blk, 0 where its 8x8 quadrant is not coded
__device__ __forceinline__ int gated(const int* tc, int cbp, int blk) {
  return ((cbp >> (blk / 4)) & 1) ? tc[blk] : 0;
}

__global__ void __launch_bounds__(288)
mixed_wave_kernel(const uint8_t* __restrict__ ysrc,
                  const int32_t* __restrict__ mode16,
                  const int32_t* __restrict__ mode4,
                  const int32_t* __restrict__ cmode,
                  const int32_t* __restrict__ cbp_c,
                  const int32_t* __restrict__ chroma_bits,
                  const int32_t* __restrict__ tabs, uint8_t* yrec,
                  bool* choice4, int32_t* __restrict__ i16dc,
                  int32_t* __restrict__ i16ac, int32_t* __restrict__ lv4,
                  bool* __restrict__ prev_flags, int32_t* __restrict__ rem_modes,
                  int32_t* cbp_luma, int32_t* tc_luma, int wmb, int d, int r0,
                  int qp, QpTab tab) {
  const int r = r0 + blockIdx.x, c = d - 2 * r;
  const int mb = r * wmb + c, W = wmb * 16;
  const int x0 = 16 * c, y0 = 16 * r;
  const bool left_ok = c > 0, top_ok = r > 0;
  const int mb_l = mb - 1, mb_t = mb - wmb;  // read only where left_ok / top_ok
  const int t = threadIdx.x;
  const int y = t >> 4, x = t & 15;

  __shared__ MbNbr nb;
  __shared__ int m4[16];
  __shared__ int tc_l[16], tc_t[16], cbp_l, cbp_t;  // the neighbours' state
  __shared__ I16Scratch s16;
  __shared__ int work[16][16];  // the I4x4 reconstruction
  __shared__ I4Scratch sc;
  __shared__ int lv_dc[16], lv_ac[16 * 15], lv_4[256];
  __shared__ int tcs[33], t1s[33], rest[33], bits[33];  // DC, 16 AC, 16 I4
  __shared__ int s_pf[16];
  __shared__ int s_cbp16, s_cbp4, s_choice;

  // ---- neighbours and their state ----------------------------------------
  load_nbr(yrec, W, wmb, r, c, nb, t, 288);
  if (t >= 64 && t < 80) m4[t - 64] = mode4[16 * mb + t - 64];
  if (t >= 80 && t < 96) tc_l[t - 80] = left_ok ? tc_luma[16 * mb_l + t - 80] : 0;
  if (t >= 96 && t < 112) tc_t[t - 96] = top_ok ? tc_luma[16 * mb_t + t - 96] : 0;
  if (t == 112) cbp_l = left_ok ? cbp_luma[mb_l] : 0;
  if (t == 113) cbp_t = top_ok ? cbp_luma[mb_t] : 0;
  __syncthreads();

  // ---- both candidates at once: I16 on warps 0..7, one thread per sample
  // (csrc/intra16.cuh), I4x4 on warp 8 (csrc/intra4x4.cuh) ---------------
  int rec16 = 0;
  if (t < 256) {
    rec16 = i16_luma_mb(nb.top, nb.left, nb.corner, left_ok, top_ok, mode16[mb],
                        ysrc + y0 * W + x0, W, qp, tab, s16, lv_dc, lv_ac, t, 1);
  } else {
    i4x4_mb(ysrc + y0 * W + x0, W, m4, nb, qp, tab, work, lv_4, sc, t - 256);
  }
  __syncthreads();
  if (t < 240) i16ac[240 * mb + t] = lv_ac[t];
  if (t < 16) i16dc[16 * mb + t] = lv_dc[t];

  // ---- prediction-mode syntax (MPM, intra.cpp:878-942), threads 0..15 ----
  // a neighbour that is I16 or absent gives mode 2; either absent makes
  // both 2; the class is the neighbour's chained choice
  if (t < 16) {
    const int* nbr = kLumaNbr[t];
    const int mode_a = nbr[0] ? m4[nbr[1]]
                       : (left_ok && choice4[mb_l]) ? mode4[16 * mb_l + nbr[1]] : 2;
    const int mode_b = nbr[2] ? m4[nbr[3]]
                       : (top_ok && choice4[mb_t]) ? mode4[16 * mb_t + nbr[3]] : 2;
    const bool ok = (nbr[0] || left_ok) && (nbr[2] || top_ok);
    const int mpm = ok ? (mode_a < mode_b ? mode_a : mode_b) : 2;
    const int m = m4[t];
    s_pf[t] = m == mpm;
    prev_flags[16 * mb + t] = m == mpm;
    rem_modes[16 * mb + t] = m < mpm ? m : m - 1;
  }
  // ---- CAVLC: TotalCoeff, TrailingOnes and the rest of each block --------
  if (t >= 32 && t < 65) {
    const int b = t - 32;
    const int* lv = b == 0 ? lv_dc : (b <= 16 ? lv_ac + 15 * (b - 1) : lv_4 + 16 * (b - 17));
    rest[b] = rest_bits(lv, b >= 1 && b <= 16 ? 15 : 16, tabs, &tcs[b], &t1s[b]);
  }
  __syncthreads();
  if (t == 0) {
    int any_ac = 0, cbp4 = 0;
    for (int i = 0; i < 16; ++i) {
      any_ac |= tcs[1 + i];
      if (tcs[17 + i]) cbp4 |= 1 << (i / 4);
    }
    s_cbp16 = any_ac ? 15 : 0;
    s_cbp4 = cbp4;
  }
  __syncthreads();
  // nC (residual.cpp:251-294) and the coeff_token of each block; the DC
  // block takes the nC of block 0
  if (t >= 32 && t < 65) {
    const int b = t - 32;
    const bool i4 = b >= 17;
    const int z = b == 0 ? 0 : (i4 ? b - 17 : b - 1);
    const int* own = i4 ? tcs + 17 : tcs + 1;
    const int cbp_own = i4 ? s_cbp4 : s_cbp16;
    const int* nbr = kLumaNbr[z];
    const int nA = nbr[0] ? gated(own, cbp_own, nbr[1]) : gated(tc_l, cbp_l, nbr[1]);
    const int nB = nbr[2] ? gated(own, cbp_own, nbr[3]) : gated(tc_t, cbp_t, nbr[3]);
    const bool a_ok = nbr[0] || left_ok, b_ok = nbr[2] || top_ok;
    const int nc = a_ok && b_ok ? (nA + nB + 1) >> 1 : a_ok ? nA : b_ok ? nB : 0;
    const int ctx = (nc >= 2) + (nc >= 4) + (nc >= 8);
    bits[b] = tabs[kCtLen + (ctx * 17 + tcs[b]) * 4 + t1s[b]] + rest[b];
  }
  __syncthreads();

  // ---- exact sizes (coded_mb_size) and the choice ------------------------
  if (t == 0) {
    const int cbp16 = s_cbp16, cbp4 = s_cbp4;
    const int cbpc = cbp_c[mb], cm = cmode[mb], cbits = chroma_bits[mb];
    int ac_sum = 0, l4_sum = 0, pm_bits = 0;
    for (int i = 0; i < 16; ++i) {
      ac_sum += bits[1 + i];
      if ((cbp4 >> (i / 4)) & 1) l4_sum += bits[17 + i];
      pm_bits += s_pf[i] ? 1 : 4;
    }
    const int size16 = ue_bits(1 + mode16[mb] + 4 * cbpc + (cbp16 == 15 ? 12 : 0))
                       + ue_bits(cm) + 1 + bits[0] + (cbp16 == 15 ? ac_sum : 0)
                       + cbits;
    const bool resid4 = cbp4 > 0 || cbpc > 0;
    const int size4 = 1 + pm_bits + ue_bits(cm)
                      + ue_bits(tabs[kCbpCode + ((cbpc << 4) | cbp4)])
                      + (resid4 ? 1 + l4_sum + cbits : 0);
    const bool ch = size4 < size16;
    s_choice = ch;
    choice4[mb] = ch;
    cbp_luma[mb] = ch ? cbp4 : cbp16;
  }
  __syncthreads();

  // ---- the winner's state; an I16 MB without AC keeps its DC block's
  // TotalCoeff in slot 0 (wavefront_mixed.py:348-351) ---------------------
  const bool ch = s_choice;
  if (t < 256) {
    yrec[(y0 + y) * W + x0 + x] = (uint8_t)(ch ? work[y][x] : rec16);
    lv4[256 * mb + t] = lv_4[t];
  }
  if (t < 16) {
    tc_luma[16 * mb + t] = ch ? gated(tcs + 17, s_cbp4, t)
                         : s_cbp16 == 15 ? tcs[1 + t] : (t == 0 ? tcs[0] : 0);
  }
}

}  // namespace

// Codes the luma of a mixed I frame: one launch per non-empty knight wave
// on `stream`. Inputs: ysrc (H, W) uint8; mode16, cmode, cbp_c, chroma_bits
// (nmb,) and mode4 (nmb, 16) int32; tabs, the length tables. Outputs, as
// kernels/wavefront_mixed.KEYS: yrec, choice4, i16dc, i16ac, lv4,
// prev_flags, rem_modes, cbp_luma, tc_luma (the last two double as the
// state later MBs read). qtab: 6 ints, LEVEL_QUANTIZE / LEVEL_SCALE of qp.
// *launched gets the number of accepted launches. Returns the first CUDA
// error (0 when every launch was accepted).
extern "C" int wavefront_mixed_frame(
    const uint8_t* ysrc, const int32_t* mode16, const int32_t* mode4,
    const int32_t* cmode, const int32_t* cbp_c, const int32_t* chroma_bits,
    const int32_t* tabs, uint8_t* yrec, bool* choice4, int32_t* i16dc,
    int32_t* i16ac, int32_t* lv4, bool* prev_flags, int32_t* rem_modes,
    int32_t* cbp_luma, int32_t* tc_luma, int wmb, int hmb, int qp,
    const int* qtab, cudaStream_t stream, int* launched) {
  *launched = 0;
  QpTab tab;
  for (int i = 0; i < 3; ++i) {
    tab.lq[i] = qtab[i];
    tab.ls[i] = qtab[3 + i];
  }
  for (int d = 0; d < 2 * (hmb - 1) + wmb; ++d) {
    int r0, r1;
    knight_rows(d, wmb, hmb, &r0, &r1);
    if (r1 < r0) continue;
    mixed_wave_kernel<<<r1 - r0 + 1, 288, 0, stream>>>(
        ysrc, mode16, mode4, cmode, cbp_c, chroma_bits, tabs, yrec, choice4,
        i16dc, i16ac, lv4, prev_flags, rem_modes, cbp_luma, tc_luma, wmb, d, r0,
        qp, tab);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}
