// All-Intra_4x4 luma reconstruction wavefront (K4x4), for sm_90a.
//
// Replaces the Pallas kernel _i4_kernel_body
// (h264_fer_tpu/kernels/wavefront_pallas.py:551, called by pallas_i4x4_luma
// at :753) and the bulk level rebuild i4x4_levels_from_recon (:822): for
// every MB, in its 16 given Intra4x4 modes, each 4x4 block predicted from
// its reconstructed neighbours, transformed, quantised, dequantised and
// reconstructed, in Z-scan order; the levels are written as each block
// finishes.
//
// What bounds it on an H100: neither bytes (~2 MB of uint8 planes and 0.5 MB
// of modes in, 8.4 MB of int32 levels out per 1920x1088 frame, ~3 us at
// 3.35 TB/s) nor operations (~60 int32 operations per sample, ~10 us). The
// floor is the dependency chain: a block needs its left, top, top-left and
// top-right neighbours, so MB (r, c) waits for (r - 1, c + 1), and the
// frame's MBs run as 2 * (hmb - 1) + wmb knight waves d = 2r + c (254 at
// 1080p), each at most wmb / 2 + 1 (61) MBs; inside an MB a block waits
// for its left, top, top-left and top-right blocks.
//
// Design: one launch per knight wave, one warp per MB (csrc/intra4x4.cuh:
// the MB's 16 blocks in 10 diagonal steps, two at once where a step has
// two), the source MB and the reconstruction in shared memory, the
// neighbours read from the row-major uint8 output plane that the earlier
// launches finished (stream order makes them visible). The Pallas form ran
// 4x4-block waves (1022 at 1080p); MB waves cut the launches fourfold. One
// launch per frame (csrc/mb_dataflow.cuh, as K4 and K6) is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "intra4x4.cuh"

namespace {

__global__ void __launch_bounds__(32)
i4x4_wave_kernel(const uint8_t* __restrict__ ysrc,
                 const int32_t* __restrict__ modes,
                 const int32_t* __restrict__ pred4, uint8_t* yrec,
                 int32_t* __restrict__ levels, int wmb, int d, int r0, int qp,
                 QpTab tab) {
  const int r = r0 + blockIdx.x, c = d - 2 * r;
  const int mb = r * wmb + c, W = wmb * 16;
  const int lane = threadIdx.x;
  __shared__ MbNbr nb;
  __shared__ I4Scratch sc;
  __shared__ int m4[16];
  __shared__ __align__(16) uint8_t s_src[256];
  load_nbr(yrec, W, wmb, r, c, nb, lane, 32);
  if (lane < 16) m4[lane] = modes[16 * mb + lane];
  load_pred_table(sc, pred4, lane, 32);
  {  // the source MB, 8 bytes a lane (W and 16 c are multiples of 16)
    const uint2 v = *reinterpret_cast<const uint2*>(
        ysrc + (size_t)(16 * r + (lane >> 1)) * W + 16 * c + 8 * (lane & 1));
    *reinterpret_cast<uint2*>(s_src + 8 * lane) = v;
  }
  __syncwarp();
  i4x4_mb(s_src, m4, nb, qp, tab, levels + 256 * mb, sc, lane);
  for (int i = lane; i < 256; i += 32) {
    yrec[(16 * r + i / 16) * W + 16 * c + i % 16] = (uint8_t)sc.ext[1 + i / 16][1 + i % 16];
  }
}

}  // namespace

// Reconstructs an all-Intra_4x4 frame: one launch per non-empty knight wave
// on `stream`. modes (nmb, 16) Z-scan; pred4 the Intra4x4 prediction table
// (ops/intra.packed_mode_table); levels (nmb, 16, 16) zig-zag lists.
// qtab: 6 ints, LEVEL_QUANTIZE / LEVEL_SCALE of qp in the order of QpTab.
// *launched gets the number of launches that were accepted. Returns the
// first CUDA error (0 when every launch was accepted).
extern "C" int wavefront_i4x4_frame(const uint8_t* ysrc, const int32_t* modes,
                                    const int32_t* pred4, uint8_t* yrec,
                                    int32_t* levels, int wmb,
                                    int hmb, int qp, const int* qtab,
                                    cudaStream_t stream, int* launched) {
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
    i4x4_wave_kernel<<<r1 - r0 + 1, 32, 0, stream>>>(ysrc, modes, pred4, yrec, levels,
                                                      wmb, d, r0, qp, tab);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}
