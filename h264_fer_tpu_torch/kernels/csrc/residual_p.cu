// P-frame residual, transform, quantisation and reconstruction (K12) for
// sm_90a.
//
// The device form of the XLA stage pframe_residual_recon
// (h264_fer_tpu/codec/tpu_pframe.py:343), which no Pallas kernel replaced;
// its plain twin is codec/pframe.pframe_residual_recon_plain. For every MB
// of a decided P frame (or MB-row band), with no dependency between MBs:
// - the MAXDIFF prefilter (moestimation.cpp:570-584) where `prefilter` is
//   set and the MB is not skipped: a luma source sample within |s - p| <
//   maxdiff of its prediction takes the prediction; a chroma one within
//   |s - p| <= maxdiff (the twin compares the 2x-subsampled MB values so);
// - the 16 luma 4x4 blocks in Z-scan order: forward core transform,
//   quantisation of every coefficient (no DC bypass), the zig-zag list;
// - the 4 raster 4x4 blocks of each chroma plane: forward core transform,
//   AC quantisation, the 2x2 DCs through the Hadamard and quantisationChromaDC,
//   the AC lists as zig-zag positions 1-15;
// - zero levels where the MB is skipped;
// - the reconstruction from those levels (inverse DC, dequantisation,
//   inverse core transform), clamp(pred + res, 0, 255).
// The steps are intra_common.cuh's, which K1t and K6 hold to their twins.
//
// What bounds it on an H100: bytes. At 1920x1088 it reads the uint8 source
// (3.1 MB), the int32 prediction (12.5 MB) and per MB a skip flag and a
// MAXDIFF, and writes the int32 levels (12.5 MB) and the int32 recon (12.5
// MB): ~41 MB, 0.012 ms at 3.35 TB/s. Its ~0.2 G int32 operations take less.
//
// Design: one warp per MB, 4 MBs per block, one launch per frame or band.
// Lane z < 16 codes luma block z (Z-scan), lanes 16-19 the Cb blocks and
// 20-23 the Cr blocks (raster); lanes 24-31 only take part in the shuffles.
// A lane holds its block in registers: it reads the 4 source bytes of each
// row as one aligned word and the 4 prediction ints as one int4, and writes
// its recon rows as int4 stores and its luma list as 4 int4 stores. The
// zig-zag permutations are register constants (intra_common.cuh), so every
// index into the block's registers is known at compile time. The 2x2 chroma
// DC transforms, forward and inverse, are shuffles within the plane's 4
// lanes.

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_common.cuh"

namespace {

constexpr int kWarps = 4;  // MBs per block

struct Args {
  const uint8_t *src_y, *src_cb, *src_cr;    // (H, W), (H/2, W/2)
  const int32_t *pred_y, *pred_cb, *pred_cr;  // the same shapes
  const bool* skip;                           // (nmb,)
  const int32_t* maxdiff;                     // (nmb,)
  int32_t *luma, *cdc, *cac;                  // (nmb, 16, 16), (2, nmb, 4), (2, nmb, 4, 15)
  int32_t *recon_y, *recon_cb, *recon_cr;     // as the prediction
  int wmb, nmb, qp, qpc, prefilter;
  QpTab ty, tc;                               // qp's and qpc's tables
};

// Sum over the 4 lanes of this lane's group of 4 of sign * v, the sign of
// lane j (-1)^popcount(k & j): output k of the 2x2 Hadamard H2 V H2 of the
// values V[j >> 1][j & 1] of the group. Every lane of the warp calls it.
__device__ __forceinline__ int hadamard2(int v, int k) {
  int acc = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = __shfl_sync(0xffffffffu, v, j, 4);
    acc += (__popc(k & j) & 1) ? -x : x;
  }
  return acc;
}

__global__ void __launch_bounds__(32 * kWarps) residual_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int mb = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (mb >= a.nmb) return;  // the whole warp: the shuffles below see all 32 lanes
  const bool luma = lane < 16, active = lane < 24;
  const int ci = luma ? 0 : (lane < 20 ? 1 : 2);  // 0 Y, 1 Cb, 2 Cr
  const int blk = luma ? lane : (lane & 3);
  const int n = luma ? 16 : 8, stride = n * a.wmb;
  const int x0 = (mb % a.wmb) * n + 4 * (luma ? z_col(blk) : (blk & 1));
  const int y0 = (mb / a.wmb) * n + 4 * (luma ? z_row(blk) : (blk >> 1));
  const uint8_t* src = ci == 0 ? a.src_y : (ci == 1 ? a.src_cb : a.src_cr);
  const int32_t* pred = ci == 0 ? a.pred_y : (ci == 1 ? a.pred_cb : a.pred_cr);
  int32_t* recon = ci == 0 ? a.recon_y : (ci == 1 ? a.recon_cb : a.recon_cr);
  const size_t at = (size_t)y0 * stride + x0;
  const bool sk = a.skip[mb];
  const bool filter = a.prefilter && !sk;
  const int md = a.maxdiff[mb];
  const int qp = luma ? a.qp : a.qpc;
  const QpTab tab = luma ? a.ty : a.tc;

  // residual, then the forward core transform (columns, then rows)
  int p[16], h[16];
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    int4 pv = make_int4(0, 0, 0, 0);
    uint32_t sw = 0;
    if (active) {
      pv = *reinterpret_cast<const int4*>(pred + at + (size_t)y * stride);
      sw = *reinterpret_cast<const uint32_t*>(src + at + (size_t)y * stride);
    }
    p[4 * y] = pv.x, p[4 * y + 1] = pv.y, p[4 * y + 2] = pv.z, p[4 * y + 3] = pv.w;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      int s = (int)((sw >> (8 * x)) & 0xffu);
      const int d = abs(s - p[4 * y + x]);
      if (filter && (luma ? d < md : d <= md)) s = p[4 * y + x];
      const int r = s - p[4 * y + x];
      h[4 * y + x] = r == 0 ? 0 : r * 64 - 32;
    }
  }
  int f[16], c[16];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[4 * i + x] = fwd_step(i, h[x], h[4 + x], h[8 + x], h[12 + x]);
  }
#pragma unroll
  for (int y = 0; y < 4; ++y) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[4 * y + j] = fwd_step(j, f[4 * y], f[4 * y + 1], f[4 * y + 2], f[4 * y + 3]);
  }
  // levels: every coefficient quantised, zero in a skipped MB; a chroma
  // block's DC is replaced by its plane's quantised 2x2 DC
  int q[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) q[k] = sk ? 0 : quant_ac(c[k], qp, tab.lq[pat(k >> 2, k & 3)]);
  int qdc = quant_dc_chroma((hadamard2(c[0], blk) + 2) >> 2, a.qpc, a.tc.lq[0]);
  if (sk) qdc = 0;
  const int dcv = scale_dc_chroma(hadamard2(qdc, blk), a.qpc, a.tc.ls[0]);
  if (luma) {
    int4* out = reinterpret_cast<int4*>(a.luma + ((size_t)mb * 16 + blk) * 16);
#pragma unroll
    for (int k = 0; k < 16; k += 4)
      out[k >> 2] = make_int4(q[zigzag(k)], q[zigzag(k + 1)], q[zigzag(k + 2)], q[zigzag(k + 3)]);
  } else if (active) {
    const size_t plane = (size_t)(ci - 1) * a.nmb + mb;
    a.cdc[plane * 4 + blk] = qdc;
    int32_t* ac = a.cac + (plane * 4 + blk) * 15;
#pragma unroll
    for (int k = 1; k < 16; ++k) ac[k - 1] = q[zigzag(k)];
  }
  // reconstruction: dequantise (a chroma DC from the inverse DC path), the
  // inverse core transform (rows, then columns), clamp(pred + res)
  int d[16], g[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = scale_ac(q[k], qp, tab.ls[pat(k >> 2, k & 3)]);
  if (!luma) d[0] = dcv;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      g[4 * y + j] = inv_step(j, d[4 * y], d[4 * y + 1], d[4 * y + 2], d[4 * y + 3]);
  }
  if (!active) return;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    int o[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int res = (inv_step(y, g[x], g[4 + x], g[8 + x], g[12 + x]) + 32) >> 6;
      o[x] = clip255(p[4 * y + x] + res);
    }
    *reinterpret_cast<int4*>(recon + at + (size_t)y * stride) = make_int4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// src_y (H, W) and src_cb / src_cr (H/2, W/2) uint8, 4-byte aligned;
// pred_* int32 of the same shapes, 16-byte aligned; skip (nmb,) bool;
// maxdiff (nmb,) int32; out one int32 buffer, 16-byte aligned, of
// luma (nmb, 16, 16), cdc (2, nmb, 4), cac (2, nmb, 4, 15), recon_y,
// recon_cb, recon_cr in that order (768 nmb ints); qtab / qtabc
// wavefront_i16.qtab of qp and qpc (host arrays). Returns the CUDA error of
// the launch (0 when it was accepted) and counts it in *launched.
extern "C" int residual_p(const uint8_t* src_y, const uint8_t* src_cb, const uint8_t* src_cr,
                          const int32_t* pred_y, const int32_t* pred_cb,
                          const int32_t* pred_cr, const bool* skip, const int32_t* maxdiff,
                          int32_t* out, int wmb, int hmb, int qp, int qpc, int prefilter,
                          const int* qtab, const int* qtabc, cudaStream_t stream,
                          int* launched) {
  *launched = 0;
  const int nmb = wmb * hmb;
  if (nmb <= 0) return (int)cudaErrorInvalidConfiguration;
  Args a{src_y, src_cb, src_cr, pred_y, pred_cb, pred_cr, skip, maxdiff,
         out, out + 256 * nmb, out + 264 * nmb,
         out + 384 * nmb, out + 640 * nmb, out + 704 * nmb,
         wmb, nmb, qp, qpc, prefilter,
         {{qtab[0], qtab[1], qtab[2]}, {qtab[3], qtab[4], qtab[5]}},
         {{qtabc[0], qtabc[1], qtabc[2]}, {qtabc[3], qtabc[4], qtabc[5]}}};
  residual_kernel<<<(nmb + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
