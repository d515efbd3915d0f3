// Intra_16x16 reconstruction wavefront over MB anti-diagonals (K1), the
// same writing its levels (K1t), and its chroma half alone (K7), for
// sm_90a.
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
// (wavefront_pallas.py:173, via pallas_i16_frame at :437): the same launches
// and per-MB code, which also write each MB's levels as they leave the
// quantiser, so no pass rebuilds them from the reconstruction. K7
// (wavefront_chroma_frame) is K1's chroma half alone: the mixed I frame's
// chroma, whose luma is K6's (csrc/wavefront_mixed.cu).
//
// What bounds it on an H100: neither bytes (about 6.3 MB of uint8 in and
// out per 1920x1088 frame, ~2 us at 3.35 TB/s) nor integer operations
// (~32-36 per pixel in the function's butterfly form, ~6 us at the card's
// int32 rate; chip_smoke.k1_ops counts them). The floor is the
// dependency chain: MB (r, c) needs (r-1, c), (r, c-1) and (r-1, c-1), so
// the hmb+wmb-1 anti-diagonals (187 at 1080p) run one after another and a
// diagonal holds at most hmb (68) MBs, far fewer blocks than the card can
// run at once.
//
// Design: one launch per diagonal d = r + c, one thread block per MB of the
// diagonal. K1's block has 384 threads: warps 0..7 code the luma, one
// thread per sample, while warps 8..11 code both chroma planes, each group
// on its own named barrier (the per-MB functions of csrc/intra16.cuh, which
// K6 and K7 share). The MB's working arrays live in shared memory.
// Neighbours are read straight from the row-major uint8 output planes,
// which the earlier launches have finished; stream order makes them
// visible. No skewed layout. A persistent kernel with per-MB ready flags,
// or a CUDA graph over the launches, is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "intra16.cuh"

namespace {

// Level arrays K1t writes, null for K1: i16dc (nmb, 16), ac (nmb, 16, 15),
// cdc (2, nmb, 4), cac (2, nmb, 4, 15) int32.
struct Levels {
  int32_t *dc, *ac, *cdc, *cac;
};

__global__ void __launch_bounds__(384)
i16_diag_kernel(const uint8_t* __restrict__ ysrc,
                const uint8_t* __restrict__ cbsrc,
                const uint8_t* __restrict__ crsrc,
                const int32_t* __restrict__ modes,
                const int32_t* __restrict__ cmodes, uint8_t* yrec,
                uint8_t* cbrec, uint8_t* crrec, Levels lv, int wmb, int nmb,
                int d, int r0, int qp, int qpc, QpTab luma, QpTab chroma) {
  const int r = r0 + blockIdx.x, c = d - r;
  const int mb = r * wmb + c, W = wmb * 16;
  const int x0 = c * 16, y0 = r * 16;
  const bool top_ok = r > 0, left_ok = c > 0;
  const int t = threadIdx.x;
  __shared__ int top[16], left[16], corner;
  __shared__ I16Scratch ls;
  __shared__ ChromaScratch cs;
  if (t < 256) {
    if (t < 16) {
      top[t] = top_ok ? yrec[(y0 - 1) * W + x0 + t] : -1;
    } else if (t < 32) {
      left[t - 16] = left_ok ? yrec[(y0 + t - 16) * W + x0 - 1] : -1;
    } else if (t == 32) {
      corner = top_ok && left_ok ? yrec[(y0 - 1) * W + x0 - 1] : -1;
    }
    group_sync(1, 256);
    const int v = i16_luma_mb(top, left, corner, left_ok, top_ok, modes[mb],
                              ysrc + y0 * W + x0, W, qp, luma, ls,
                              lv.dc ? lv.dc + mb * 16 : nullptr,
                              lv.ac ? lv.ac + mb * 240 : nullptr, t, 1);
    yrec[(y0 + (t >> 4)) * W + x0 + (t & 15)] = (uint8_t)v;
  } else {
    chroma_mb(cbsrc, crsrc, cbrec, crrec, wmb * 8, r, c, cmodes[mb], qpc, chroma,
              cs, lv.cdc ? lv.cdc + mb * 4 : nullptr,
              lv.cac ? lv.cac + mb * 60 : nullptr, nmb, t - 256, 2);
  }
}

__global__ void __launch_bounds__(128)
chroma_diag_kernel(const uint8_t* __restrict__ cbsrc,
                   const uint8_t* __restrict__ crsrc,
                   const int32_t* __restrict__ cmodes, uint8_t* cbrec,
                   uint8_t* crrec, int wmb, int d, int r0, int qpc,
                   QpTab chroma) {
  const int r = r0 + blockIdx.x, c = d - r;
  __shared__ ChromaScratch cs;
  chroma_mb(cbsrc, crsrc, cbrec, crrec, wmb * 8, r, c, cmodes[r * wmb + c], qpc,
            chroma, cs, nullptr, nullptr, 0, threadIdx.x, 1);
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

// One launch per anti-diagonal d = r + c, launch(d, r0, MBs on it), one
// thread block per MB; *launched counts the accepted launches. Returns the
// first CUDA error (0 when every launch was accepted).
template <typename Launch>
int launch_diagonals(int wmb, int hmb, Launch launch, int* launched) {
  *launched = 0;
  for (int d = 0; d < hmb + wmb - 1; ++d) {
    const int r0 = d - wmb + 1 > 0 ? d - wmb + 1 : 0;
    const int r1 = d < hmb - 1 ? d : hmb - 1;
    launch(d, r0, r1 - r0 + 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}

int launch_i16(const uint8_t* ysrc, const uint8_t* cbsrc, const uint8_t* crsrc,
               const int32_t* modes, const int32_t* cmodes, uint8_t* yrec,
               uint8_t* cbrec, uint8_t* crrec, Levels lv, int wmb, int hmb,
               int qp, int qpc, const int* qtab, cudaStream_t stream,
               int* launched) {
  const QpTab luma = make_tab(qtab), chroma = make_tab(qtab + 6);
  return launch_diagonals(wmb, hmb, [&](int d, int r0, int n) {
    i16_diag_kernel<<<n, 384, 0, stream>>>(ysrc, cbsrc, crsrc, modes, cmodes,
                                           yrec, cbrec, crrec, lv, wmb,
                                           wmb * hmb, d, r0, qp, qpc, luma,
                                           chroma);
  }, launched);
}

}  // namespace

// K1: reconstructs a whole all-I16 frame (luma and chroma). qtab: 12 ints,
// LEVEL_QUANTIZE / LEVEL_SCALE of qp (6), then of qpc (6).
extern "C" int wavefront_i16_frame(const uint8_t* ysrc, const uint8_t* cbsrc,
                                   const uint8_t* crsrc, const int32_t* modes,
                                   const int32_t* cmodes, uint8_t* yrec,
                                   uint8_t* cbrec, uint8_t* crrec, int wmb,
                                   int hmb, int qp, int qpc, const int* qtab,
                                   cudaStream_t stream, int* launched) {
  return launch_i16(ysrc, cbsrc, crsrc, modes, cmodes, yrec, cbrec, crrec,
                    Levels{nullptr, nullptr, nullptr, nullptr}, wmb, hmb, qp,
                    qpc, qtab, stream, launched);
}

// K1t: K1 that also writes every MB's levels as they leave the quantiser
// (the Pallas kernel _i16_kernel_body, h264_fer_tpu/kernels/
// wavefront_pallas.py:173, via pallas_i16_frame at :437): i16dc (nmb, 16),
// ac (nmb, 16, 15), cdc (2, nmb, 4), cac (2, nmb, 4, 15) int32.
extern "C" int wavefront_i16_frame_levels(
    const uint8_t* ysrc, const uint8_t* cbsrc, const uint8_t* crsrc,
    const int32_t* modes, const int32_t* cmodes, uint8_t* yrec, uint8_t* cbrec,
    uint8_t* crrec, int32_t* i16dc, int32_t* ac, int32_t* cdc, int32_t* cac,
    int wmb, int hmb, int qp, int qpc, const int* qtab, cudaStream_t stream,
    int* launched) {
  return launch_i16(ysrc, cbsrc, crsrc, modes, cmodes, yrec, cbrec, crrec,
                    Levels{i16dc, ac, cdc, cac}, wmb, hmb, qp, qpc, qtab,
                    stream, launched);
}

// K7: reconstructs the intra chroma of a frame, the chroma half of K1 (the
// device form of the XLA loop wavefront_chroma_impl,
// h264_fer_tpu/kernels/wavefront.py:222). qtab: 6 ints, LEVEL_QUANTIZE /
// LEVEL_SCALE of qpc.
extern "C" int wavefront_chroma_frame(const uint8_t* cbsrc, const uint8_t* crsrc,
                                      const int32_t* cmodes, uint8_t* cbrec,
                                      uint8_t* crrec, int wmb, int hmb, int qpc,
                                      const int* qtab, cudaStream_t stream,
                                      int* launched) {
  const QpTab chroma = make_tab(qtab);
  return launch_diagonals(wmb, hmb, [&](int d, int r0, int n) {
    chroma_diag_kernel<<<n, 128, 0, stream>>>(cbsrc, crsrc, cmodes, cbrec, crrec,
                                              wmb, d, r0, qpc, chroma);
  }, launched);
}
