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
// their most-probable modes. MB (r, c) waits for its left, top, top-right
// and top-left MBs, all on earlier knight waves d = 2r + c, so the critical
// path is 2 * (hmb - 1) + wmb MBs long (254 at 1080p), with at most
// wmb / 2 + 1 (61) MBs ready at once.
//
// The band form (wavefront_mixed_band) replaces the band= form of that
// loop (wavefront_mixed.py:74-404, with m4_halo=): the same kernel over one
// MB-row band, whose row 0 reads its top neighbours' state from one MB row
// above the band in the state arrays: the band above's last recon row, its
// classes, TotalCoeffs and CBP, and its pre-decided Intra4x4 modes, copied
// there before the launch (the bands pipeline across frames,
// parallel/tile.py, so the band above has finished the frame).
//
// Design: one launch per frame (csrc/mb_dataflow.cuh): a persistent grid
// of 288-thread blocks takes the MBs in knight order by ticket, and each MB
// starts as soon as its neighbours have published, not when the whole
// previous wave is done. Before it waits, the block copies the source MB
// into shared memory (cp.async) and reads its modes, its left and top
// MBs' Intra4x4 modes and its chroma inputs. After the acquire it reads
// the neighbours' reconstructed samples, TotalCoeffs, CBP and class
// (written in this launch: never through the read-only path). The two
// candidates run at once, each sizing itself: the I16 one on warps 0..7, a
// thread per sample on its own named barrier (K1's luma function,
// csrc/intra16.cuh), then its 17 blocks' CAVLC sizes on warp 0, a lane per
// block; the I4x4 one on warp 8 (K4x4's function, csrc/intra4x4.cuh: 10
// diagonal steps of one or two 4x4 blocks), then its 16 blocks' sizes, the
// prediction-mode syntax and the CBP code on the same warp, a lane per
// block, with shuffles, ballots and warp sums in place of block barriers.
// The CAVLC arithmetic is csrc/cavlc.cuh's, shared with K10; its length
// tables come in one device buffer from ops/cavlc_tables.py (see TABLES in
// kernels/wavefront_mixed.py), copied to shared memory once per block. After one barrier the block makes the choice, writes the
// state later MBs read and publishes it, then writes the levels and the
// mode syntax, which no later MB reads.

#include <cstdint>
#include <cuda_runtime.h>

#include "cavlc.cuh"
#include "intra16.cuh"
#include "intra4x4.cuh"
#include "mb_dataflow.cuh"

namespace {

using namespace cavlc;  // rest_bits, luma_nbr, gate, nc_ctx, ue_bits, the table offsets

constexpr int kThreads = 288;

// The frame's arrays. In-launch state (yrec, choice4, cbp_luma, tc_luma:
// written by one MB, read by its later neighbours) is never read through
// __ldg or a const __restrict__ pointer.
struct Frame {
  const uint8_t* ysrc;          // (H, W)
  const int32_t* mode16;        // (nmb,)
  const int32_t* mode4;         // (nmb, 16)
  const int32_t* cmode;         // (nmb,)
  const int32_t* cbp_c;         // (nmb,)
  const int32_t* chroma_bits;   // (nmb,)
  const int32_t* tabs;          // the length tables
  const int32_t* pred4;         // the Intra4x4 prediction table
  uint8_t* yrec;                // (H, W) out, and state
  bool* choice4;                // (nmb,) out, and state
  int32_t* i16dc;               // (nmb, 16) out
  int32_t* i16ac;               // (nmb, 16, 15) out
  int32_t* lv4;                 // (nmb, 16, 16) out
  bool* prev_flags;             // (nmb, 16) out
  int32_t* rem_modes;           // (nmb, 16) out
  int32_t* cbp_luma;            // (nmb,) out, and state
  int32_t* tc_luma;             // (nmb, 16) out, and state
  int wmb, qp;
  bool has_top;  // row 0 reads the state one MB row above (a band's halo)
  QpTab tab;
};

__global__ void __launch_bounds__(kThreads) mixed_kernel(Frame f, Dataflow df) {
  const int t = threadIdx.x, lane = t & 31;
  const int y = t >> 4, x = t & 15;
  const int W = f.wmb * 16;

  __shared__ int s_tabs[kK6TabLen];  // the length tables, read once per block
  __shared__ int s_mb;
  __shared__ __align__(16) uint8_t s_src[256];
  __shared__ MbNbr nb;
  __shared__ int m4[16], m4_l[16], m4_t[16];  // own, left and top modes
  __shared__ int s_m16, s_cm, s_cbpc, s_cbits;
  __shared__ int tc_l[16], tc_t[16], cbp_l, cbp_t, i4_l, i4_t;  // neighbours' state
  __shared__ I16Scratch s16;
  __shared__ I4Scratch sc;  // the I4x4 reconstruction and prediction table
  __shared__ int lv_dc[16], lv_ac[16 * 15], lv_4[256];
  __shared__ int s_pf[16], s_rm[16];
  __shared__ int s_tc16[16], s_tc4[16];  // each candidate's TotalCoeff state
  __shared__ int s_size16, s_size4, s_cbp16, s_cbp4;
  for (int i = t; i < kK6TabLen; i += kThreads) s_tabs[i] = f.tabs[i];
  load_pred_table(sc, f.pred4, t, kThreads);

  for (;;) {
    const int mb = dataflow_next(df, &s_mb);
    if (mb < 0) return;
    const int r = mb / f.wmb, c = mb - r * f.wmb;
    const int x0 = 16 * c, y0 = 16 * r;
    const bool left_ok = c > 0, top_ok = r > 0 || f.has_top;
    const int mb_l = mb - 1, mb_t = mb - f.wmb;  // read only where left_ok / top_ok

    // ---- what does not depend on the neighbours, before the wait --------
    if (t < 16) cp_async16(s_src + 16 * t, f.ysrc + (size_t)(y0 + t) * W + x0);
    if (t >= 64 && t < 80) m4[t - 64] = f.mode4[16 * mb + t - 64];
    if (t >= 80 && t < 96) m4_l[t - 80] = left_ok ? f.mode4[16 * mb_l + t - 80] : 2;
    if (t >= 96 && t < 112) m4_t[t - 96] = top_ok ? f.mode4[16 * mb_t + t - 96] : 2;
    if (t == 112) s_m16 = f.mode16[mb];
    if (t == 113) s_cm = f.cmode[mb];
    if (t == 114) s_cbpc = f.cbp_c[mb];
    if (t == 115) s_cbits = f.chroma_bits[mb];
    cp_async_wait_all();
    dataflow_wait(df, r, c, f.wmb);

    // ---- the neighbours' state (written in this launch) ------------------
    load_nbr(f.yrec, W, f.wmb, r, c, f.has_top, nb, t, kThreads);
    if (t >= 64 && t < 80) tc_l[t - 64] = left_ok ? f.tc_luma[16 * mb_l + t - 64] : 0;
    if (t >= 80 && t < 96) tc_t[t - 80] = top_ok ? f.tc_luma[16 * mb_t + t - 80] : 0;
    if (t == 96) cbp_l = left_ok ? f.cbp_luma[mb_l] : 0;
    if (t == 97) cbp_t = top_ok ? f.cbp_luma[mb_t] : 0;
    if (t == 98) i4_l = left_ok && f.choice4[mb_l];
    if (t == 99) i4_t = top_ok && f.choice4[mb_t];
    __syncthreads();

    // ---- both candidates at once, each with its exact size: I16 on warps
    // 0..7, one thread per sample (csrc/intra16.cuh), then its CAVLC sizes
    // on warp 0; I4x4 on warp 8 (csrc/intra4x4.cuh), then its sizes, the
    // prediction-mode syntax and the CBP code on the same warp ------------
    int rec16 = 0;
    if (t < 256) {
      rec16 = i16_luma_mb(nb.top, nb.left, nb.corner, left_ok, top_ok, s_m16, s_src,
                          16, f.qp, f.tab, s16, lv_dc, lv_ac, t, 1);
      if (t < 32) {
        // lane b: block 0 the DC block (maxNumCoeff 16, the nC of block 0:
        // neighbour MBs only), b = 1..16 the AC block of Z-scan block b - 1
        const int z = lane == 0 ? 0 : (lane - 1) & 15;
        int tc = 0, t1 = 0, rest = 0;
        if (lane <= 16) {
          rest = rest_bits(lane == 0 ? lv_dc : lv_ac + 15 * z, lane == 0 ? 16 : 15,
                           s_tabs, &tc, &t1);
        }
        const bool any_ac = __any_sync(kAll, lane >= 1 && lane <= 16 && tc != 0);
        const int cbp16 = any_ac ? 15 : 0;
        bool a_same, b_same;
        int a_blk, b_blk;
        luma_nbr(z, &a_same, &a_blk, &b_same, &b_blk);
        const int own_a = __shfl_sync(kAll, tc, 1 + a_blk);
        const int own_b = __shfl_sync(kAll, tc, 1 + b_blk);
        const int ctx = nc_ctx(a_same ? gate(own_a, cbp16, a_blk) : gate(tc_l[a_blk], cbp_l, a_blk),
                               b_same ? gate(own_b, cbp16, b_blk) : gate(tc_t[b_blk], cbp_t, b_blk),
                               a_same || left_ok, b_same || top_ok);
        const int bits = lane <= 16 ? s_tabs[kCtLen + (ctx * 17 + tc) * 4 + t1] + rest : 0;
        int ac_sum = lane >= 1 ? bits : 0;
        for (int o = 16; o; o >>= 1) ac_sum += __shfl_xor_sync(kAll, ac_sum, o);
        const int dc_tc = __shfl_sync(kAll, tc, 0), dc_bits = __shfl_sync(kAll, bits, 0);
        // the TC state if I16 wins: an I16 MB without AC keeps its DC
        // block's TotalCoeff in slot 0 (wavefront_mixed.py:348-351)
        if (lane >= 1 && lane <= 16) s_tc16[z] = cbp16 == 15 ? tc : (z == 0 ? dc_tc : 0);
        if (lane == 0) {
          s_cbp16 = cbp16;
          s_size16 = ue_bits(1 + s_m16 + 4 * s_cbpc + (cbp16 == 15 ? 12 : 0)) + ue_bits(s_cm)
                     + 1 + dc_bits + (cbp16 == 15 ? ac_sum : 0) + s_cbits;
        }
      }
    } else {
      i4x4_mb(s_src, m4, nb, f.qp, f.tab, lv_4, sc, lane);
      // lane z < 16: Z-scan block z
      const int z = lane & 15;
      int tc = 0, t1 = 0, rest = 0;
      if (lane < 16) rest = rest_bits(lv_4 + 16 * z, 16, s_tabs, &tc, &t1);
      const unsigned nzb = __ballot_sync(kAll, lane < 16 && tc != 0);
      const int cbp4 = ((nzb & 0xFu) ? 1 : 0) | ((nzb & 0xF0u) ? 2 : 0) |
                       ((nzb & 0xF00u) ? 4 : 0) | ((nzb & 0xF000u) ? 8 : 0);
      bool a_same, b_same;
      int a_blk, b_blk;
      luma_nbr(z, &a_same, &a_blk, &b_same, &b_blk);
      const int own_a = __shfl_sync(kAll, tc, a_blk);
      const int own_b = __shfl_sync(kAll, tc, b_blk);
      const int ctx = nc_ctx(a_same ? gate(own_a, cbp4, a_blk) : gate(tc_l[a_blk], cbp_l, a_blk),
                             b_same ? gate(own_b, cbp4, b_blk) : gate(tc_t[b_blk], cbp_t, b_blk),
                             a_same || left_ok, b_same || top_ok);
      int l4_sum = lane < 16 && ((cbp4 >> (z / 4)) & 1)
                   ? s_tabs[kCtLen + (ctx * 17 + tc) * 4 + t1] + rest : 0;
      for (int o = 16; o; o >>= 1) l4_sum += __shfl_xor_sync(kAll, l4_sum, o);
      // prediction-mode syntax (MPM, intra.cpp:878-942): a neighbour that is
      // I16 or absent gives mode 2; either absent makes both 2; the class
      // is the neighbour's chained choice
      const int mode_a = a_same ? m4[a_blk] : i4_l ? m4_l[a_blk] : 2;
      const int mode_b = b_same ? m4[b_blk] : i4_t ? m4_t[b_blk] : 2;
      const int mpm = (a_same || left_ok) && (b_same || top_ok) ? min(mode_a, mode_b) : 2;
      const int m = m4[z];
      const int n_pf = __popc(__ballot_sync(kAll, lane < 16 && m == mpm));
      if (lane < 16) {
        s_pf[z] = m == mpm;
        s_rm[z] = m < mpm ? m : m - 1;
        s_tc4[z] = gate(tc, cbp4, z);
      }
      if (lane == 0) {
        const bool resid4 = cbp4 > 0 || s_cbpc > 0;
        s_cbp4 = cbp4;
        s_size4 = 1 + n_pf + 4 * (16 - n_pf) + ue_bits(s_cm)
                  + ue_bits(s_tabs[kCbpIntra + ((s_cbpc << 4) | cbp4)])
                  + (resid4 ? 1 + l4_sum + s_cbits : 0);
      }
    }
    __syncthreads();

    // ---- the choice (strict, intra.cpp:1088), the winner's state, publish
    const bool ch = s_size4 < s_size16;
    if (t < 256) f.yrec[(y0 + y) * W + x0 + x] = (uint8_t)(ch ? sc.ext[1 + y][1 + x] : rec16);
    if (t < 16) f.tc_luma[16 * mb + t] = ch ? s_tc4[t] : s_tc16[t];
    if (t == 0) {
      f.choice4[mb] = ch;
      f.cbp_luma[mb] = ch ? s_cbp4 : s_cbp16;
    }
    dataflow_publish(df, mb);

    // ---- the outputs no later MB reads -----------------------------------
    if (t < 256) f.lv4[256 * mb + t] = lv_4[t];
    if (t < 240) f.i16ac[240 * mb + t] = lv_ac[t];
    if (t < 16) {
      f.i16dc[16 * mb + t] = lv_dc[t];
      f.prev_flags[16 * mb + t] = s_pf[t];
      f.rem_modes[16 * mb + t] = s_rm[t];
    }
  }
}

}  // namespace

namespace {

// One launch of mixed_kernel, *launched 1 when accepted.
int launch_mixed(const uint8_t* ysrc, const int32_t* mode16, const int32_t* mode4,
                 const int32_t* cmode, const int32_t* cbp_c, const int32_t* chroma_bits,
                 const int32_t* tabs, const int32_t* pred4, uint8_t* yrec, bool* choice4,
                 int32_t* i16dc, int32_t* i16ac, int32_t* lv4, bool* prev_flags,
                 int32_t* rem_modes, int32_t* cbp_luma, int32_t* tc_luma,
                 const int32_t* order, int32_t* sched, int wmb, int hmb, bool has_top,
                 int qp, const int* qtab, int blocks, cudaStream_t stream,
                 int* launched) {
  *launched = 0;
  Frame f{ysrc, mode16, mode4, cmode, cbp_c, chroma_bits, tabs, pred4, yrec, choice4,
          i16dc, i16ac, lv4, prev_flags, rem_modes, cbp_luma, tc_luma, wmb, qp, has_top,
          {}};
  for (int i = 0; i < 3; ++i) {
    f.tab.lq[i] = qtab[i];
    f.tab.ls[i] = qtab[3 + i];
  }
  const Dataflow df{order, sched, wmb * hmb};
  const int grid = dataflow_grid(mixed_kernel, kThreads, 0, wmb * hmb, blocks);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  mixed_kernel<<<grid, kThreads, 0, stream>>>(f, df);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

}  // namespace

// Codes the luma of a mixed I frame in one launch on `stream`: a
// persistent grid of `blocks` blocks (0: as many as fit on the card; at
// most nmb) taking the MBs in the knight order `order` (nmb,) through the
// dataflow scratch `sched` (nmb + 1 int32, zeroed). Inputs: ysrc (H, W)
// uint8; mode16, cmode, cbp_c, chroma_bits (nmb,) and mode4 (nmb, 16)
// int32; tabs, the length tables; pred4, the Intra4x4 prediction table
// (ops/intra.packed_mode_table). Outputs, as kernels/wavefront_mixed.KEYS:
// yrec, choice4, i16dc, i16ac, lv4, prev_flags, rem_modes, cbp_luma,
// tc_luma (yrec, choice4 and the last two double as the state later MBs
// read). qtab: 6 ints, LEVEL_QUANTIZE / LEVEL_SCALE of qp. *launched gets 1
// when the launch was accepted. Returns its CUDA error (0 when accepted).
extern "C" int wavefront_mixed_frame(
    const uint8_t* ysrc, const int32_t* mode16, const int32_t* mode4,
    const int32_t* cmode, const int32_t* cbp_c, const int32_t* chroma_bits,
    const int32_t* tabs, const int32_t* pred4, uint8_t* yrec, bool* choice4,
    int32_t* i16dc,
    int32_t* i16ac, int32_t* lv4, bool* prev_flags, int32_t* rem_modes,
    int32_t* cbp_luma, int32_t* tc_luma, const int32_t* order, int32_t* sched,
    int wmb, int hmb, int qp, const int* qtab, int blocks, cudaStream_t stream,
    int* launched) {
  return launch_mixed(ysrc, mode16, mode4, cmode, cbp_c, chroma_bits, tabs, pred4, yrec,
                      choice4, i16dc, i16ac, lv4, prev_flags, rem_modes, cbp_luma,
                      tc_luma, order, sched, wmb, hmb, false, qp, qtab, blocks, stream,
                      launched);
}

// K6-band: K6 over one band of hmb MB rows (the band= form of
// wavefront_mixed_luma_impl, h264_fer_tpu/kernels/wavefront_mixed.py:54,
// with m4_halo=). The arguments of wavefront_mixed_frame for the band, and
// has_top: when 1, row 0 reads its top neighbours from one MB row before
// the band in yrec (its last sample row: yrec - W), mode4 (mode4 - 16 wmb),
// choice4, cbp_luma (- wmb) and tc_luma (- 16 wmb), which hold the band
// above's last row: its recon, pre-decided Intra4x4 modes, classes, CBP and
// TotalCoeffs.
extern "C" int wavefront_mixed_band(
    const uint8_t* ysrc, const int32_t* mode16, const int32_t* mode4,
    const int32_t* cmode, const int32_t* cbp_c, const int32_t* chroma_bits,
    const int32_t* tabs, const int32_t* pred4, uint8_t* yrec, bool* choice4,
    int32_t* i16dc, int32_t* i16ac, int32_t* lv4, bool* prev_flags, int32_t* rem_modes,
    int32_t* cbp_luma, int32_t* tc_luma, const int32_t* order, int32_t* sched,
    int wmb, int hmb, int has_top, int qp, const int* qtab, int blocks,
    cudaStream_t stream, int* launched) {
  return launch_mixed(ysrc, mode16, mode4, cmode, cbp_c, chroma_bits, tabs, pred4, yrec,
                      choice4, i16dc, i16ac, lv4, prev_flags, rem_modes, cbp_luma,
                      tc_luma, order, sched, wmb, hmb, has_top != 0, qp, qtab, blocks,
                      stream, launched);
}
