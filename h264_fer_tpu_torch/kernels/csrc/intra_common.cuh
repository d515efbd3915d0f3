// Integer transform and quantisation steps of the H.264 intra paths and the
// knight-wave schedule, shared by the wavefront kernels (included by
// csrc/*.cu; the build hashes it with each source that includes it).
//
// Arithmetic is int32 exactly as the reference: `>>` on signed int is an
// arithmetic shift under nvcc, and a left shift of a value that may be
// negative is written as a multiplication by a power of two, since a left
// shift of a negative int is undefined in C++.

#pragma once

#include <cstdint>

namespace {

__constant__ int kHad4[4][4] = {
    {1, 1, 1, 1}, {1, 1, -1, -1}, {1, -1, -1, 1}, {1, -1, 1, -1}};

__device__ __forceinline__ int pat(int i, int j) {
  const int oi = i & 1, oj = j & 1;
  return (!oi && !oj) ? 0 : ((oi && oj) ? 1 : 2);
}

__device__ __forceinline__ int pow2(int s) { return 1 << s; }

// quantisationResidualBlock (quantizationTransform.cpp:183-223)
__device__ __forceinline__ int quant_ac(int d, int qp, int lq) {
  if (qp < 24) {
    const int qbits = 4 - qp / 6;
    const int adjust = 1 << (3 - qp / 6);
    return ((d * pow2(qbits) - adjust) * lq + 16384) >> 15;
  }
  return ((d >> (qp / 6 - 4)) * lq + 16384) >> 15;
}

// scaleResidualBlock (scaleTransform.cpp:308-340)
__device__ __forceinline__ int scale_ac(int c, int qp, int ls) {
  if (qp >= 24) return (c * ls) * pow2(qp / 6 - 4);
  return (c * ls + (1 << (3 - qp / 6))) >> (4 - qp / 6);
}

// quantisationLumaDCIntra (quantizationTransform.cpp:227-260)
__device__ __forceinline__ int quant_dc_luma(int f, int qp, int lq0) {
  if (qp >= 36) return ((f >> (qp / 6 - 6)) * lq0 + 16384) >> 15;
  return ((f * pow2(6 - qp / 6) - (1 << (5 - qp / 6))) * lq0 + 16384) >> 15;
}

// scaleLumaDCIntra (scaleTransform.cpp:344-404)
__device__ __forceinline__ int scale_dc_luma(int f, int qp, int ls0) {
  if (qp >= 36) return (f * ls0) * pow2(qp / 6 - 6);
  return (f * ls0 + (1 << (5 - qp / 6))) >> (6 - qp / 6);
}

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// One step of the forward core transform along one axis of a 4-group:
// out_i = (sum_k W[i][k] * in_k + 512) >> 10 with the rows of W
// 256 (1, 1, 1, 1), 208 (2, 1, -1, -2), 256 (1, -1, -1, 1) and
// 208 (1, -2, 2, -1), written as selects so that lanes with different i
// neither diverge nor serialise on a table read.
__device__ __forceinline__ int fwd_step(int i, int v0, int v1, int v2, int v3) {
  const int s = v0 + v3, d = v0 - v3, s2 = v1 + v2, d2 = v1 - v2;
  const int even = 256 * ((i & 2) ? s - s2 : s + s2);
  const int odd = 208 * ((i & 2) ? d - 2 * d2 : 2 * d + d2);
  return ((i & 1 ? odd : even) + 512) >> 10;
}

// One step of the inverse core transform butterfly (scaleTransform.cpp:101-150):
// output j is e0 + e3, e1 + e2, e1 - e2 or e0 - e3, as selects.
__device__ __forceinline__ int inv_step(int j, int d0, int d1, int d2, int d3) {
  const int e0 = d0 + d2, e1 = d0 - d2;
  const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  const bool outer = j == 0 || j == 3;
  const int u = outer ? e0 : e1, v = outer ? e3 : e2;
  return j < 2 ? u + v : u - v;
}

// quantisationChromaDC (quantizationTransform.cpp:264-282) of one
// forward-Hadamard output f (already (.. + 2) >> 2)
__device__ __forceinline__ int quant_dc_chroma(int f, int qp, int lq0) {
  return (((f * 32) >> (qp / 6)) * lq0 + 16384) >> 15;
}

// scaleChromaDC (scaleTransform.cpp:408-445) of one inverse-Hadamard output
__device__ __forceinline__ int scale_dc_chroma(int f, int qp, int ls0) {
  return (f * ls0 * pow2(qp / 6)) >> 5;
}

// zig-zag index of raster position i (0..15) of a 4x4 block, from a
// register constant (INV_ZIGZAG_FLAT, four bits each)
__device__ __forceinline__ int inv_zigzag(int i) {
  return (int)((0xFEA9DB83C7426510ull >> (4 * i)) & 15);
}

// raster position of zig-zag index k (0..15) of a 4x4 block (ZIGZAG_FLAT,
// four bits each): with k known at compile time, an index into registers
__device__ __forceinline__ int zigzag(int k) {
  return (int)((0xFEB7ADC963258410ull >> (4 * k)) & 15);
}

// LEVEL_QUANTIZE / LEVEL_SCALE of one QP in the 3-value pattern:
// [0] (even, even), [1] (odd, odd), [2] mixed position parity.
struct QpTab {
  int lq[3];
  int ls[3];
};

// Barrier over the `count` threads (a multiple of 32) that use barrier `id`
// (1..15; 0 is __syncthreads's), so that two groups of warps of one block
// can work and synchronise apart; it orders their shared-memory accesses as
// __syncthreads does.
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// raster position (4 * row + column) of a 4x4 block's coefficient → its
// index in the zig-zag list (INV_ZIGZAG_FLAT)
__constant__ int kInvZigzag[16] = {0, 1, 5, 6, 2, 4, 7, 12,
                                   3, 8, 11, 13, 9, 10, 14, 15};
// raster 4x4 block of an MB (4 * row + column) → its Z-scan index
__constant__ int kRasterToZ[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                   8, 9, 12, 13, 10, 11, 14, 15};

// The column and row (in 4x4 blocks) of Z-scan block z of an MB.
__device__ __forceinline__ int z_col(int z) { return ((z >> 2) & 1) * 2 + (z & 1); }
__device__ __forceinline__ int z_row(int z) { return ((z >> 3) & 1) * 2 + ((z >> 1) & 1); }

}  // namespace
