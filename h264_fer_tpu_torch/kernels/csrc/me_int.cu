// Integer full-search score map (K2) for sm_90a.
//
// Replaces the Pallas kernel _int_kernel
// (h264_fer_tpu/kernels/me_int_pallas.py:34, called by
// integer_score_map_pallas_impl at :73) together with the XLA block fold
// that follows it (:114-117). It computes the same function: for every 8x8
// block of the source luma and every integer shift (dx, dy) in
// [-window, window]^2, the distortion between the block and the reference
// window at that shift, read from plane 0 of the 16-phase stack (the
// reference edge-extended by ext >= window). The metric is SAD, SSD or
// 2*SSD (template M = 0, 1, 2). Output (nb, S*S) int32, S = 2*window + 1,
// shift index (dy + window) * S + (dx + window): the layout
// codec/tpu_pframe.integer_score_map returns.
//
// What bounds it on an H100: operations. At 1080p and window 8 the function
// is 32640 blocks x 289 shifts x 64 samples x 3 int32 operations (subtract,
// abs or multiply, add), 1.8 G, ~0.11 ms at the CUDA cores' int32 rate; its
// bytes (4.2 MB of uint8 source and plane in, 37.7 MB of int32 map out) take
// ~0.013 ms at 3.35 TB/s.
//
// Design: one thread per (block, dy, chunk of CH consecutive dx). The
// thread keeps the chunk's CH sums in registers and, per row of the block,
// reads the 8 source samples and the 8 + CH - 1 reference samples the chunk
// needs once, so each loaded sample feeds up to CH differences. Both reads
// go through L1: the 2 MB uint8 plane and the source stay cache resident.
// No shared memory, no TPU strip DMA, no lane rolls, no int16 column sums:
// the block fold is the thread's own sum.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 4;

template <int M>
__device__ __forceinline__ int dist(int d) {
  if (M == 0) return d < 0 ? -d : d;
  return M == 1 ? d * d : 2 * d * d;
}

template <int M>
__global__ void int_score_kernel(const uint8_t* __restrict__ src,
                                 const uint8_t* __restrict__ plane, int W,
                                 int we, int ext, int window, int wb, int nb,
                                 int nchunk, int32_t* __restrict__ out) {
  const int S = 2 * window + 1;
  const int dy = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb * nchunk) return;
  const int j = t % nchunk;
  const int b = t / nchunk;
  const int by = b / wb, bx = b % wb;
  const int dx0 = j * CH;
  const int x0 = bx * 8 + ext - window + dx0;  // plane column of the chunk
  const int y0 = by * 8 + ext - window + dy;   // plane row of the window
  int acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0;
  for (int i = 0; i < 8; ++i) {
    const uint8_t* srow = src + (by * 8 + i) * W + bx * 8;
    const uint8_t* prow = plane + (y0 + i) * we;
    int s[8], p[8 + CH - 1];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = srow[k];
#pragma unroll
    for (int k = 0; k < 8 + CH - 1; ++k) {
      // columns past the last shift of the last chunk feed no output;
      // clamping keeps their reads inside the plane
      p[k] = prow[min(x0 + k, we - 1)];
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[c] += dist<M>(p[c + k] - s[k]);
    }
  }
  int32_t* o = out + (size_t)b * S * S + dy * S + dx0;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (dx0 + c < S) o[c] = acc[c];
  }
}

}  // namespace

// src (H, W) and plane (H + 2 ext, W + 2 ext) uint8, row-major; out
// (nb, S*S) int32. The caller guarantees window <= ext. Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int me_int_score_map(const uint8_t* src, const uint8_t* plane,
                                int32_t* out, int W, int H, int ext,
                                int window, int metric, cudaStream_t stream) {
  const int wb = W / 8, hb = H / 8, nb = wb * hb;
  const int S = 2 * window + 1;
  const int nchunk = (S + CH - 1) / CH;
  const int we = W + 2 * ext;
  const int threads = 128;
  const dim3 grid((nb * nchunk + threads - 1) / threads, S);
  if (metric == 0) {
    int_score_kernel<0><<<grid, threads, 0, stream>>>(
        src, plane, W, we, ext, window, wb, nb, nchunk, out);
  } else if (metric == 1) {
    int_score_kernel<1><<<grid, threads, 0, stream>>>(
        src, plane, W, we, ext, window, wb, nb, nchunk, out);
  } else {
    int_score_kernel<2><<<grid, threads, 0, stream>>>(
        src, plane, W, we, ext, window, wb, nb, nchunk, out);
  }
  return (int)cudaGetLastError();
}
