// The 16 interpolated luma phase planes (K13) for sm_90a.
//
// The device form of the XLA stage interpolated_planes_jax
// (h264_fer_tpu/ops/interp.py:131) and its band form
// interpolated_planes_banded_jax (:138), which no Pallas kernel replaced
// (the reference's FillInterpolatedRefFrame, moestimation.cpp:74-173); its
// plain twins are ops/interp.interpolated_planes_plain and
// interpolated_planes_banded_plain. Plane frac = fy * 4 + fx, sample (X, Y)
// of the grid extended by ext on every side, from the reference samples
// G(dx, dy) at (X + dx - ext, Y + dy + row_off):
//   b  = the horizontal 6-tap (1, -5, 20, 20, -5, 1) at row Y, clipped;
//   hv = the vertical 6-tap at column X, clipped;
//   s  = b one row down, m = hv one column right;
//   j  = the horizontal 6-tap over the clipped hv of columns X-2 .. X+3
//        (the reference's chained Bordered intermediates, mocomp.cpp:66-71);
// and the planes g, (g+b), b, (b+gx1), (g+hv), (b+hv), (b+j), (b+m), hv,
// (hv+j), j, (j+m), (hv+gy1), (hv+s), (j+s), (s+m), each (x + y + 1) >> 1.
// A reference coordinate is clamped into the plane on both axes, which
// makes the frame form's edge padding: row_off = -ext there. The band form
// reads ref_v, the band's rows between ext + 4 real rows of the bands above
// and below, with row_off = 4: its rows never leave ref_v, so only the
// column clamp acts, as the twin pads only horizontally.
//
// What bounds it on an H100: bytes. At 1920x1088 with ext 10 it reads the
// 2.1 MB reference and writes 16 planes of 1108 x 1940 bytes, 34.4 MB:
// 0.011 ms at 3.35 TB/s. Its ~0.14 G int32 operations (three 6-taps a
// position, each half-pel value computed once, and twelve averages) take
// less.
//
// Design: one launch, a block per 64 x 16 tile of positions, 256 threads.
// The block stages the tile's reference window (21 x 69 samples, clamped
// while staging, so the ref is read directly and no padded copy is made),
// then the window's vertical half-pels hv (16 x 69) and horizontal ones b
// (17 x 64) in shared memory, each computed once; a thread then makes the
// 16 planes of 4 positions of one column, a warp 32 neighbouring columns of
// one row, so that each of its byte stores writes one 32-byte run of a
// plane's row. Rows are W + 2 ext bytes, at any alignment.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 64, kTy = 16;          // positions per tile
constexpr int kThreads = 256;
constexpr int kIx = kTx + 5, kIy = kTy + 5;  // window: columns X-2 .. X+3, rows Y-2 .. Y+3

struct Tile {
  int in[kIy][kIx];      // G at rows Y0-2 .., columns X0-2 ..
  int hv[kTy][kIx];      // hv at rows Y0 .., columns X0-2 ..
  int b[kTy + 1][kTx];   // b at rows Y0 .. Y0+16, columns X0 ..
};

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
  const int v = (a - 5 * b + 20 * c + 20 * d - 5 * e + f + 16) >> 5;
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__device__ __forceinline__ int avg(int a, int b) { return (a + b + 1) >> 1; }

__global__ void __launch_bounds__(kThreads)
interp_kernel(const uint8_t* __restrict__ ref, int rows, int W, int ext, int row_off, int he,
              uint8_t* __restrict__ out) {
  __shared__ Tile t;
  const int we = W + 2 * ext;
  const int X0 = blockIdx.x * kTx, Y0 = blockIdx.y * kTy;
  const int tid = threadIdx.x;
  for (int i = tid; i < kIy * kIx; i += kThreads) {
    const int r = i / kIx, c = i % kIx;
    const int y = min(max(Y0 - 2 + r + row_off, 0), rows - 1);
    const int x = min(max(X0 - 2 + c - ext, 0), W - 1);
    t.in[r][c] = (int)ref[(size_t)y * W + x];
  }
  __syncthreads();
  for (int i = tid; i < kTy * kIx; i += kThreads) {
    const int r = i / kIx, c = i % kIx;
    t.hv[r][c] = tap6(t.in[r][c], t.in[r + 1][c], t.in[r + 2][c], t.in[r + 3][c],
                      t.in[r + 4][c], t.in[r + 5][c]);
  }
  for (int i = tid; i < (kTy + 1) * kTx; i += kThreads) {
    const int r = i / kTx, c = i % kTx;
    const int* g = &t.in[r + 2][c];
    t.b[r][c] = tap6(g[0], g[1], g[2], g[3], g[4], g[5]);
  }
  __syncthreads();
  const int c = tid % kTx, X = X0 + c;
  if (X >= we) return;
  const size_t plane = (size_t)he * we;
#pragma unroll
  for (int k = 0; k < kTy / (kThreads / kTx); ++k) {
    const int r = tid / kTx + k * (kThreads / kTx), Y = Y0 + r;
    if (Y >= he) return;
    const int g = t.in[r + 2][c + 2], gx1 = t.in[r + 2][c + 3], gy1 = t.in[r + 3][c + 2];
    const int* v = &t.hv[r][c];
    const int hv = v[2], m = v[3];
    const int j = tap6(v[0], v[1], v[2], v[3], v[4], v[5]);
    const int b = t.b[r][c], s = t.b[r + 1][c];
    const int p[16] = {g, avg(g, b), b, avg(b, gx1),
                       avg(g, hv), avg(b, hv), avg(b, j), avg(b, m),
                       hv, avg(hv, j), j, avg(j, m),
                       avg(hv, gy1), avg(hv, s), avg(j, s), avg(s, m)};
    uint8_t* o = out + (size_t)Y * we + X;
#pragma unroll
    for (int f = 0; f < 16; ++f) o[f * plane] = (uint8_t)p[f];
  }
}

}  // namespace

// ref (rows, W) uint8; out (16, he, W + 2 ext) uint8. Frame form: rows = H, he = H + 2 ext, row_off = -ext; band
// form: rows = hb + 2 (ext + 4), he = hb + 2 ext, row_off = 4. Returns the
// CUDA error of the launch (0 when it was accepted) and counts it in
// *launched.
extern "C" int interp_planes(const uint8_t* ref, uint8_t* out, int rows, int W,
                             int ext, int row_off, int he, cudaStream_t stream,
                             int* launched) {
  *launched = 0;
  if (rows <= 0 || W <= 0 || ext < 0 || he <= 0) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((W + 2 * ext + kTx - 1) / kTx, (he + kTy - 1) / kTy);
  interp_kernel<<<grid, kThreads, 0, stream>>>(ref, rows, W, ext, row_off, he, out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
