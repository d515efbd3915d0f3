// Intra_16x16 reconstruction of a frame as one launch (K1), the same
// writing its levels (K1t), and its chroma half alone (K7), for sm_90a.
//
// K1 replaces the Pallas kernel _i16_recon_kernel_body
// (h264_fer_tpu/kernels/wavefront_pallas.py:890, called by
// pallas_i16_frame_fast_impl at :1170). It computes the same function: for
// every MB, in the decided Intra16x16 mode, the prediction from the
// reconstructed top row, left column and corner; the forward 4x4 integer
// DCT and quantisation; the 4x4 Hadamard DC path; the inverse of both; and
// the clipped reconstruction. The same for Cb and Cr (8x8, 2x2 DC, chroma
// mode given per MB). K1 writes no levels. K1t
// (wavefront_i16_frame_levels) replaces _i16_kernel_body
// (wavefront_pallas.py:173, via pallas_i16_frame at :437): the same kernel
// and per-MB code, which also write each MB's levels as they leave the
// quantiser, so no pass rebuilds them from the reconstruction. K7
// (wavefront_chroma_frame_levels; wavefront_chroma_frame without levels)
// replaces the XLA loop wavefront_chroma_impl
// (h264_fer_tpu/kernels/wavefront.py:222): K1's chroma half alone, the
// mixed I frame's chroma (whose luma is K6's, csrc/wavefront_mixed.cu),
// with its levels cdc (2, nmb, 4) and cac (2, nmb, 4, 15) written as they
// leave the quantiser.
//
// What bounds them on an H100: neither bytes (about 6.3 MB of uint8 in and
// out per 1920x1088 frame for K1, ~2 us at 3.35 TB/s; as much for K7, a
// third of K1's samples plus 4.2 MB of int32 levels) nor integer
// operations (~32-36 per pixel in the function's butterfly form, ~6 us at
// the card's int32 rate for K1, ~2 us for K7; chip_smoke.k1_ops and
// chroma_ops count them). The floor is the dependency chain: MB (r, c)
// needs (r-1, c), (r, c-1) and (r-1, c-1), so hmb + wmb - 1 MBs (187 at
// 1080p) lie on a chain and at most hmb (68) are ready at once, far fewer
// than the card can run. A launch per anti-diagonal (~4.4 us each, 187 a
// frame, enqueued no faster than the host issues them) would pay that
// chain in launches.
//
// The band forms (wavefront_i16_band_levels, wavefront_chroma_band_levels)
// replace the XLA loop _banded_i16_wavefront (h264_fer_tpu/parallel/
// tile.py:57, fori_loop at :240) and the band= form of
// wavefront_chroma_impl (wavefront.py:237-330): the same kernels over one
// MB-row band of a frame, whose row 0 reads its top neighbours from the
// row above the band in the recon planes (has_top), the band above's last
// recon row, copied there before the launch. The JAX form exchanges that
// row a segment per wave between devices; here the band above has
// finished the frame before the band below launches (the bands pipeline
// across frames, parallel/tile.py), so no launch waits on another.
//
// Design of K1, K1t and K7: one launch per frame on csrc/mb_dataflow.cuh.
// A persistent grid takes the MBs by ticket in diagonal order (d = r + c,
// then r) and waits on the I16 wait set, left, top and top-left: no
// Intra_16x16 or chroma prediction reads a top-right sample, so the chain
// stays 187 MBs (the four-neighbour set would stretch it to 254). Before
// the wait the block stages the source MB (16x16 luma, two 8x8 chroma) in
// shared memory with cp.async and reads the MB's modes; after it, the top
// row, left column and corner from the recon planes, written in this
// launch and so read with plain loads (never __ldg). K1's block has 384
// threads: warps 0..7 code the luma, one thread per sample, on named
// barrier 1, while warps 8..11 code both chroma planes on barrier 2 (the
// per-MB functions of csrc/intra16.cuh, which K6 shares); all 384 meet at
// the scheduler's __syncthreads. K7's block is that chroma half alone:
// 128 threads, one per sample of Cb and Cr, so a step of its chain is one
// flag hop plus one MB's chroma code.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "intra16.cuh"
#include "mb_dataflow.cuh"

namespace {

// Level arrays K1t writes, null for K1: i16dc (nmb, 16), ac (nmb, 16, 15),
// cdc (2, nmb, 4), cac (2, nmb, 4, 15) int32.
struct Levels {
  int32_t *dc, *ac, *cdc, *cac;
};

struct Frame {
  const uint8_t *ysrc, *cbsrc, *crsrc;  // (H, W), (H/2, W/2)
  const int32_t *modes, *cmodes;        // (nmb,)
  uint8_t *yrec, *cbrec, *crrec;        // written in the launch: no __ldg
  Levels lv;
  int wmb, nmb, qp, qpc;
  bool has_top;  // row 0 reads the recon row above the planes (a band's halo)
  QpTab luma, chroma;
};

constexpr int kThreads = 384;

// kBand: the band entry point's instance, which reads f.has_top; the frame
// entry points' instance compiles as it did before bands (top_ok = r > 0).
template <bool kBand>
__global__ void __launch_bounds__(kThreads)
i16_kernel(Frame f, Dataflow df) {
  __shared__ __align__(16) uint8_t s_src[256];     // the source MB's luma
  __shared__ __align__(16) uint8_t s_csrc[2][64];  // and its Cb, Cr
  __shared__ int top[16], left[16], corner, s_mode, s_cmode, s_mb;
  __shared__ I16Scratch ls;
  __shared__ ChromaScratch cs;
  const int t = threadIdx.x;
  const int W = f.wmb * 16, Wc = f.wmb * 8;

  for (;;) {
    const int mb = dataflow_next(df, &s_mb);
    if (mb < 0) return;
    const int r = mb / f.wmb, c = mb - r * f.wmb;
    const int x0 = c * 16, y0 = r * 16;
    const bool top_ok = r > 0 || (kBand && f.has_top), left_ok = c > 0;

    // ---- before the wait: the source MB and its modes (read-only) --------
    if (t >= 32 && t < 48) {  // warp 1: a luma row of 16 each
      const int i = t - 32;
      cp_async16(s_src + 16 * i, f.ysrc + (size_t)(y0 + i) * W + x0);
    } else if (t >= 256 && t < 272) {  // warp 8: a chroma row of 8 each
      const int p = (t - 256) >> 3, i = (t - 256) & 7;
      cp_async8(&s_csrc[p][8 * i], (p ? f.crsrc : f.cbsrc) + (size_t)(8 * r + i) * Wc + 8 * c);
    } else if (t == 64) {
      s_mode = __ldg(f.modes + mb);
      s_cmode = __ldg(f.cmodes + mb);
    }
    cp_async_wait_all();
    dataflow_wait<kIntraSet>(df, r, c, f.wmb);  // left, top, top-left

    // ---- after the wait: code the MB --------------------------------------
    if (t < 256) {
      if (t < 16) {
        top[t] = top_ok ? f.yrec[(ptrdiff_t)(y0 - 1) * W + x0 + t] : -1;
      } else if (t < 32) {
        left[t - 16] = left_ok ? f.yrec[(size_t)(y0 + t - 16) * W + x0 - 1] : -1;
      } else if (t == 32) {
        corner = top_ok && left_ok ? f.yrec[(ptrdiff_t)(y0 - 1) * W + x0 - 1] : -1;
      }
      group_sync(1, 256);
      const int v = i16_luma_mb(top, left, corner, left_ok, top_ok, s_mode, s_src, 16,
                                f.qp, f.luma, ls, f.lv.dc ? f.lv.dc + mb * 16 : nullptr,
                                f.lv.ac ? f.lv.ac + mb * 240 : nullptr, t, 1);
      f.yrec[(size_t)(y0 + (t >> 4)) * W + x0 + (t & 15)] = (uint8_t)v;
    } else {
      chroma_mb(s_csrc[0], s_csrc[1], 8, f.cbrec, f.crrec, Wc, r, c, kBand && f.has_top,
                s_cmode, f.qpc, f.chroma, cs, f.lv.cdc ? f.lv.cdc + mb * 4 : nullptr,
                f.lv.cac ? f.lv.cac + mb * 60 : nullptr, f.nmb, t - 256, 2);
    }
    dataflow_publish(df, mb);
  }
}

// K7: the intra chroma of one frame (chroma_mb of csrc/intra16.cuh), MB by
// MB on the dataflow schedule. The recon planes are written in the launch:
// chroma_mb reads the neighbours from them with plain loads.
struct ChromaFrame {
  const uint8_t *cbsrc, *crsrc;  // (H/2, W/2)
  const int32_t* cmodes;         // (nmb,)
  uint8_t *cbrec, *crrec;        // written in the launch: no __ldg
  int32_t *cdc, *cac;            // (2, nmb, 4), (2, nmb, 4, 15); null: no levels
  int wmb, nmb, qpc;
  bool has_top;  // row 0 reads the recon row above the planes (a band's halo)
  QpTab chroma;
};

constexpr int kChromaThreads = 128;

__global__ void __launch_bounds__(kChromaThreads)
chroma_kernel(ChromaFrame f, Dataflow df) {
  __shared__ __align__(16) uint8_t s_csrc[2][64];  // the source MB's Cb, Cr
  __shared__ int s_cmode, s_mb;
  __shared__ ChromaScratch cs;
  const int t = threadIdx.x;
  const int Wc = f.wmb * 8;

  for (;;) {
    const int mb = dataflow_next(df, &s_mb);
    if (mb < 0) return;
    const int r = mb / f.wmb, c = mb - r * f.wmb;

    // ---- before the wait: the source MB and its mode (read-only) ----------
    if (t < 16) {  // a chroma row of 8 each
      const int p = t >> 3, i = t & 7;
      cp_async8(&s_csrc[p][8 * i], (p ? f.crsrc : f.cbsrc) + (size_t)(8 * r + i) * Wc + 8 * c);
    } else if (t == 32) {
      s_cmode = __ldg(f.cmodes + mb);
    }
    cp_async_wait_all();
    dataflow_wait<kIntraSet>(df, r, c, f.wmb);  // left, top, top-left: chroma

    // ---- after the wait: code the MB ----------------------------------------
    chroma_mb(s_csrc[0], s_csrc[1], 8, f.cbrec, f.crrec, Wc, r, c, f.has_top, s_cmode,
              f.qpc, f.chroma, cs, f.cdc ? f.cdc + mb * 4 : nullptr,
              f.cac ? f.cac + mb * 60 : nullptr, f.nmb, t, 1);
    dataflow_publish(df, mb);  // the MB's chroma is final
  }
}

// qtab: 6 ints of one QP, LEVEL_QUANTIZE then LEVEL_SCALE, in QpTab order
QpTab make_tab(const int* qtab) {
  QpTab tab;
  for (int i = 0; i < 3; ++i) {
    tab.lq[i] = qtab[i];
    tab.ls[i] = qtab[3 + i];
  }
  return tab;
}

// K1 and K1t: one launch of i16_kernel, *launched 1 when accepted.
int launch_i16(const uint8_t* ysrc, const uint8_t* cbsrc, const uint8_t* crsrc,
               const int32_t* modes, const int32_t* cmodes, uint8_t* yrec,
               uint8_t* cbrec, uint8_t* crrec, Levels lv, const int32_t* order,
               int32_t* sched, int wmb, int hmb, bool band, bool has_top, int qp,
               int qpc, const int* qtab, int blocks, cudaStream_t stream,
               int* launched) {
  *launched = 0;
  const int nmb = wmb * hmb;
  const Frame f{ysrc, cbsrc, crsrc, modes, cmodes, yrec, cbrec, crrec, lv,
                wmb, nmb, qp, qpc, has_top, make_tab(qtab), make_tab(qtab + 6)};
  const Dataflow df{order, sched, nmb};
  const auto kernel = band ? i16_kernel<true> : i16_kernel<false>;
  const int grid = dataflow_grid(kernel, kThreads, 0, nmb, blocks);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, 0, stream>>>(f, df);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// K7 with or without levels: one launch of chroma_kernel, *launched 1
// when accepted.
int launch_chroma(const uint8_t* cbsrc, const uint8_t* crsrc, const int32_t* cmodes,
                  uint8_t* cbrec, uint8_t* crrec, int32_t* cdc, int32_t* cac,
                  const int32_t* order, int32_t* sched, int wmb, int hmb, bool has_top,
                  int qpc, const int* qtab, int blocks, cudaStream_t stream,
                  int* launched) {
  *launched = 0;
  const int nmb = wmb * hmb;
  const ChromaFrame f{cbsrc, crsrc, cmodes, cbrec, crrec, cdc, cac,
                      wmb, nmb, qpc, has_top, make_tab(qtab)};
  const Dataflow df{order, sched, nmb};
  const int grid = dataflow_grid(chroma_kernel, kChromaThreads, 0, nmb, blocks);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  chroma_kernel<<<grid, kChromaThreads, 0, stream>>>(f, df);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

}  // namespace

// K1: reconstructs a whole all-I16 frame (luma and chroma) in one launch
// on `stream`: a persistent grid of `blocks` blocks (0: as many as fit on
// the card; at most nmb) taking the MBs in the diagonal order `order`
// (nmb,) through the dataflow scratch `sched` (nmb + 1 int32, zeroed).
// ysrc must be 16-byte and cbsrc / crsrc 8-byte aligned. qtab: 12 ints,
// LEVEL_QUANTIZE / LEVEL_SCALE of qp (6), then of qpc (6). *launched gets
// 1 when the launch was accepted. Returns its CUDA error (0 when accepted).
extern "C" int wavefront_i16_frame(const uint8_t* ysrc, const uint8_t* cbsrc,
                                   const uint8_t* crsrc, const int32_t* modes,
                                   const int32_t* cmodes, uint8_t* yrec,
                                   uint8_t* cbrec, uint8_t* crrec,
                                   const int32_t* order, int32_t* sched, int wmb,
                                   int hmb, int qp, int qpc, const int* qtab,
                                   int blocks, cudaStream_t stream, int* launched) {
  return launch_i16(ysrc, cbsrc, crsrc, modes, cmodes, yrec, cbrec, crrec,
                    Levels{nullptr, nullptr, nullptr, nullptr}, order, sched, wmb,
                    hmb, false, false, qp, qpc, qtab, blocks, stream, launched);
}

// K1t: K1 that also writes every MB's levels as they leave the quantiser
// (the Pallas kernel _i16_kernel_body, h264_fer_tpu/kernels/
// wavefront_pallas.py:173, via pallas_i16_frame at :437): i16dc (nmb, 16),
// ac (nmb, 16, 15), cdc (2, nmb, 4), cac (2, nmb, 4, 15) int32.
extern "C" int wavefront_i16_frame_levels(
    const uint8_t* ysrc, const uint8_t* cbsrc, const uint8_t* crsrc,
    const int32_t* modes, const int32_t* cmodes, uint8_t* yrec, uint8_t* cbrec,
    uint8_t* crrec, int32_t* i16dc, int32_t* ac, int32_t* cdc, int32_t* cac,
    const int32_t* order, int32_t* sched, int wmb, int hmb, int qp, int qpc,
    const int* qtab, int blocks, cudaStream_t stream, int* launched) {
  return launch_i16(ysrc, cbsrc, crsrc, modes, cmodes, yrec, cbrec, crrec,
                    Levels{i16dc, ac, cdc, cac}, order, sched, wmb, hmb, false, false, qp,
                    qpc, qtab, blocks, stream, launched);
}

// K1t-band: K1t over one band of hmb MB rows (the device form of the XLA
// loop _banded_i16_wavefront, h264_fer_tpu/parallel/tile.py:57). The
// arguments of wavefront_i16_frame_levels for the band's planes, and
// has_top: when 1, row 0 takes its top and corner samples from the row
// above yrec, cbrec and crrec (yrec - W, cbrec - W / 2, crrec - W / 2),
// which hold the band above's last recon rows.
extern "C" int wavefront_i16_band_levels(
    const uint8_t* ysrc, const uint8_t* cbsrc, const uint8_t* crsrc,
    const int32_t* modes, const int32_t* cmodes, uint8_t* yrec, uint8_t* cbrec,
    uint8_t* crrec, int32_t* i16dc, int32_t* ac, int32_t* cdc, int32_t* cac,
    const int32_t* order, int32_t* sched, int wmb, int hmb, int has_top, int qp,
    int qpc, const int* qtab, int blocks, cudaStream_t stream, int* launched) {
  return launch_i16(ysrc, cbsrc, crsrc, modes, cmodes, yrec, cbrec, crrec,
                    Levels{i16dc, ac, cdc, cac}, order, sched, wmb, hmb, true,
                    has_top != 0, qp, qpc, qtab, blocks, stream, launched);
}

// K7: reconstructs the intra chroma of a frame in one launch, the chroma
// half of K1 (the device form of the XLA loop wavefront_chroma_impl,
// h264_fer_tpu/kernels/wavefront.py:222), without its levels: the
// arguments of wavefront_i16_frame for the chroma alone (cbsrc / crsrc
// 8-byte aligned). qtab: 6 ints, LEVEL_QUANTIZE / LEVEL_SCALE of qpc.
extern "C" int wavefront_chroma_frame(const uint8_t* cbsrc, const uint8_t* crsrc,
                                      const int32_t* cmodes, uint8_t* cbrec,
                                      uint8_t* crrec, const int32_t* order,
                                      int32_t* sched, int wmb, int hmb, int qpc,
                                      const int* qtab, int blocks, cudaStream_t stream,
                                      int* launched) {
  return launch_chroma(cbsrc, crsrc, cmodes, cbrec, crrec, nullptr, nullptr, order,
                       sched, wmb, hmb, false, qpc, qtab, blocks, stream, launched);
}

// K7 writing every MB's chroma levels as they leave the quantiser, the
// tuple of wavefront_chroma_impl: cdc (2, nmb, 4), cac (2, nmb, 4, 15)
// int32.
extern "C" int wavefront_chroma_frame_levels(
    const uint8_t* cbsrc, const uint8_t* crsrc, const int32_t* cmodes, uint8_t* cbrec,
    uint8_t* crrec, int32_t* cdc, int32_t* cac, const int32_t* order, int32_t* sched,
    int wmb, int hmb, int qpc, const int* qtab, int blocks, cudaStream_t stream,
    int* launched) {
  return launch_chroma(cbsrc, crsrc, cmodes, cbrec, crrec, cdc, cac, order, sched, wmb,
                       hmb, false, qpc, qtab, blocks, stream, launched);
}

// K7-band: K7 with its levels over one band of hmb MB rows (the band= form
// of wavefront_chroma_impl, h264_fer_tpu/kernels/wavefront.py:237-330). The
// arguments of wavefront_chroma_frame_levels for the band's planes, and
// has_top: when 1, row 0 takes its top and corner samples from the row
// above cbrec and crrec, which hold the band above's last recon rows.
extern "C" int wavefront_chroma_band_levels(
    const uint8_t* cbsrc, const uint8_t* crsrc, const int32_t* cmodes, uint8_t* cbrec,
    uint8_t* crrec, int32_t* cdc, int32_t* cac, const int32_t* order, int32_t* sched,
    int wmb, int hmb, int has_top, int qpc, const int* qtab, int blocks,
    cudaStream_t stream, int* launched) {
  return launch_chroma(cbsrc, crsrc, cmodes, cbrec, crrec, cdc, cac, order, sched, wmb,
                       hmb, has_top != 0, qpc, qtab, blocks, stream, launched);
}
