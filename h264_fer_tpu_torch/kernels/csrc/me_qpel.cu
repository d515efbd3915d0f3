// Quarter-pel refinement maps (K3) for sm_90a.
//
// Replaces the Pallas kernel _refine_kernel
// (h264_fer_tpu/kernels/me_pallas.py:28, called by qpel_refine_pallas_impl
// at :154). It computes the same function: for every 8x8 block and each of
// its two centres (c1, the integer argmin; c2, the previous frame's
// co-located MV, clamped), the distortion at the 49 quarter-pel offsets
// (dx, dy) in [-3, 3]^2 around the centre. The window of MV (mvx, mvy) is
// read from phase (mvy & 3) * 4 + (mvx & 3) of the 16-phase stack at
// integer offset (mvx >> 2, mvy >> 2), both on signed int: arithmetic
// shift and two's-complement mask. The metric is SAD, SSD or 2*SSD
// (template M). Output two (nb, 49) int32 maps, offset index
// (dy + 3) * 7 + (dx + 3): the layout of codec/tpu_pframe.qpel_refine_map.
//
// What bounds it on an H100: operations. At 1080p the function is
// 2 x 32640 x 49 x 64 samples x 3 int32 operations, 0.61 G, ~0.037 ms at
// the CUDA cores' int32 rate; its bytes take ~0.015 ms: the source, 0.5 MB
// of centres, 12.8 MB of maps out, and the phase samples the windows
// cover, read once. The 49 offsets around a centre reach all 16 phases
// (8x8 to 9x9 samples of each), so over a frame of blocks the windows
// cover about H x W samples of every phase, ~33 MB of the 34 MB stack.
//
// Design: one thread per (map, block, offset); 49 neighbouring threads
// share one block's source and overlapping windows, which L1 serves. The
// window origin is clamped into the planes, so a centre outside the
// caller's range contract reads a wrong window, never outside the buffer.
// No VMEM strips, no SMEM centre blocks, no phantom-offset masking.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int M>
__device__ __forceinline__ int dist(int d) {
  if (M == 0) return d < 0 ? -d : d;
  return M == 1 ? d * d : 2 * d * d;
}

template <int M>
__global__ void qpel_kernel(const uint8_t* __restrict__ src,
                            const uint8_t* __restrict__ planes,
                            const int32_t* __restrict__ c1,
                            const int32_t* __restrict__ c2, int W, int he,
                            int we, int ext, int wb, int nb,
                            int32_t* __restrict__ q1, int32_t* __restrict__ q2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * nb * 49) return;
  const int k = t % 49;
  const int rest = t / 49;
  const int b = rest % nb;
  const int m = rest / nb;
  const int32_t* c = m ? c2 : c1;
  const int mvx = c[2 * b] + k % 7 - 3;
  const int mvy = c[2 * b + 1] + k / 7 - 3;
  const int bx0 = (b % wb) * 8, by0 = (b / wb) * 8;
  const int px = min(max(bx0 + (mvx >> 2) + ext, 0), we - 8);
  const int py = min(max(by0 + (mvy >> 2) + ext, 0), he - 8);
  const uint8_t* p = planes + (size_t)((mvy & 3) * 4 + (mvx & 3)) * he * we;
  int sum = 0;
  for (int i = 0; i < 8; ++i) {
    const uint8_t* prow = p + (py + i) * we + px;
    const uint8_t* srow = src + (by0 + i) * W + bx0;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += dist<M>((int)prow[j] - (int)srow[j]);
  }
  (m ? q2 : q1)[b * 49 + k] = sum;
}

}  // namespace

// src (H, W) and planes (16, H + 2 ext, W + 2 ext) uint8; c1, c2 (nb, 2)
// int32 qpel centres; q1, q2 (nb, 49) int32 out. One launch for both maps.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int me_qpel_refine(const uint8_t* src, const uint8_t* planes,
                              const int32_t* c1, const int32_t* c2,
                              int32_t* q1, int32_t* q2, int W, int H, int ext,
                              int metric, cudaStream_t stream) {
  const int wb = W / 8, nb = wb * (H / 8);
  const int he = H + 2 * ext, we = W + 2 * ext;
  const int threads = 256;
  const int blocks = (2 * nb * 49 + threads - 1) / threads;
  if (metric == 0) {
    qpel_kernel<0><<<blocks, threads, 0, stream>>>(src, planes, c1, c2, W, he,
                                                   we, ext, wb, nb, q1, q2);
  } else if (metric == 1) {
    qpel_kernel<1><<<blocks, threads, 0, stream>>>(src, planes, c1, c2, W, he,
                                                   we, ext, wb, nb, q1, q2);
  } else {
    qpel_kernel<2><<<blocks, threads, 0, stream>>>(src, planes, c1, c2, W, he,
                                                   we, ext, wb, nb, q1, q2);
  }
  return (int)cudaGetLastError();
}
