// Whole-frame motion compensation (K5) for sm_90a.
//
// Replaces the Pallas kernel _mc_kernel (h264_fer_tpu/kernels/mc_pallas.py:42,
// called by mc_bulk_pallas_impl at :98). It computes the same function: the
// inter prediction of a P frame at its final per-quadrant MVs (mocomp.cpp:
// 152-208). Luma sample (x, y) of quadrant MV (mvx, mvy) is phase
// (mvy & 3) * 4 + (mvx & 3) of the 16-phase stack at
// (x + (mvx >> 2) + ext, y + (mvy >> 2) + ext); chroma sample (x, y) is the
// eighth-pel bilinear ((8-fx)(8-fy)a + fx(8-fy)b + (8-fx)fy c + fx fy d
// + 32) >> 6 of the padded plane at (x + (mvx >> 3) + ext_c + 1, ...), with
// fx = mvx & 7, fy = mvy & 7. Shifts and masks act on signed int:
// arithmetic shift, two's-complement mask. Outputs int32 planes, as
// codec/tpu_pframe.mc_luma_bulk and mc_chroma_bulk return them.
//
// What bounds it on an H100: bytes. At 1080p it writes 12.5 MB of int32
// predictions and reads at most one phase sample per luma output (2.1 MB
// of the 34 MB uint8 phase stack), the bilinear taps of nonzero weight in
// the padded chroma (at most 1.1 MB) and 0.26 MB of MVs: ~16 MB, ~0.005 ms
// at 3.35 TB/s; its few operations per sample take less.
//
// Design: one launch, one thread per quadrant row. A luma thread makes the
// 8 samples of one row of an 8x8 quadrant, a chroma thread the 4 of one row
// of a 4x4 quadrant of Cb or Cr; each reads its quadrant's MV once (8
// bytes), then its samples as aligned 32-bit words: the 8 bytes of one
// phase plane row from 3 words, the 5 bytes of each of its 2 chroma rows
// from 2, funnel-shifted (__funnelshift_r) by the byte offset into place.
// Rows are not word-aligned (a luma row is W + 2 ext bytes, a chroma row
// W/2 + 2 ext_c + 2: 974 at 1080p), so each word index comes from the
// absolute byte offset in the buffer, never from a row start. It writes its
// 8 or 4 int32 outputs in 2 or 1 int4 stores. The grid is 2D: x over strips
// of 32 quadrant columns, y over (MB row, part): luma rows 0-7, luma rows
// 8-15, Cb, Cr; a warp is one sample row of 32 neighbouring quadrants, so
// its stores are 1 KB (luma) or 512 B (chroma) of one output row. That is
// 0.52 M threads at 1080p: a thread per sample would be 3.13 M, ~12 waves
// of single-word loads and stores whose latency, not bytes, would be the
// time.
//
// Read positions are clamped into the planes per sample, as the reference's
// contract allows: an MV outside the caller's range gives a wrong sample,
// never a read outside the buffer. A row whose samples need that clamp (or
// whose words would reach past the buffer's last whole word) takes a byte
// path; within the caller's MV range no row does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 32;  // quadrant columns per block: one warp row
constexpr int kRows = 8;    // warps per block

__device__ __forceinline__ size_t min_sz(size_t a, size_t b) { return a < b ? a : b; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Bytes [b, b + 8) of a buffer of nwords whole 32-bit words (b + 8 <=
// 4 nwords): the words b / 4, b / 4 + 1 and b / 4 + 2, funnel-shifted right
// by 8 (b % 4) bits into bytes b..b+3 (x) and b+4..b+7 (y). The third word
// holds a wanted byte only when b % 4 != 0; its index is clamped to the
// last word, so no load passes the end of the buffer.
__device__ __forceinline__ uint2 load8(const uint32_t* words, size_t nwords, size_t b) {
  const size_t k = b >> 2;
  const unsigned sh = 8u * (unsigned)(b & 3);
  const uint32_t w0 = __ldg(words + k), w1 = __ldg(words + k + 1);
  const uint32_t w2 = __ldg(words + min_sz(k + 2, nwords - 1));
  return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
}

// Bytes [b, b + 5) (b + 5 <= 4 nwords): bytes b..b+3 in x, byte b+4 in y.
// Both words hold a wanted byte.
__device__ __forceinline__ uint2 load5(const uint32_t* words, size_t b) {
  const size_t k = b >> 2;
  const unsigned sh = 8u * (unsigned)(b & 3);
  const uint32_t w0 = __ldg(words + k), w1 = __ldg(words + k + 1);
  return make_uint2(__funnelshift_r(w0, w1, sh), (w1 >> sh) & 0xffu);
}

__device__ __forceinline__ int byte_of(uint32_t w, int i) { return (int)((w >> (8 * i)) & 0xffu); }

__global__ void __launch_bounds__(kStrip * kRows)
mc_kernel(const uint8_t* __restrict__ planes, const uint8_t* __restrict__ cb_pad,
          const uint8_t* __restrict__ cr_pad, const int2* __restrict__ mv, int wmb,
          int hmb, int ext, int ext_c, int32_t* __restrict__ pred_y,
          int32_t* __restrict__ pred_cb, int32_t* __restrict__ pred_cr) {
  const int qc = blockIdx.x * kStrip + threadIdx.x;  // quadrant column
  if (qc >= 2 * wmb) return;
  const int mbr = blockIdx.y >> 2, part = blockIdx.y & 3;
  const int mb = mbr * wmb + (qc >> 1);
  const int W = 16 * wmb, H = 16 * hmb;
  if (part < 2) {  // ---- luma: row 8 part + threadIdx.y of MB row mbr ------
    const int2 v = __ldg(mv + 4 * mb + 2 * part + (qc & 1));
    const int he = H + 2 * ext, we = W + 2 * ext;
    const int y = 16 * mbr + 8 * part + threadIdx.y, x0 = 8 * qc;
    const int py = clampi(y + (v.y >> 2) + ext, 0, he - 1);
    const int px = x0 + (v.x >> 2) + ext;
    const size_t row = ((size_t)((v.y & 3) * 4 + (v.x & 3)) * he + py) * we;
    const size_t nwords = (size_t)16 * he * we / 4;
    int s[8];
    if (px >= 0 && px + 8 <= we && row + px + 8 <= 4 * nwords) {
      const uint2 w = load8(reinterpret_cast<const uint32_t*>(planes), nwords, row + px);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = byte_of(w.x, i);
        s[4 + i] = byte_of(w.y, i);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = __ldg(planes + row + clampi(px + i, 0, we - 1));
    }
    int4* out = reinterpret_cast<int4*>(pred_y + (size_t)y * W + x0);
    out[0] = make_int4(s[0], s[1], s[2], s[3]);
    out[1] = make_int4(s[4], s[5], s[6], s[7]);
    return;
  }
  // ---- chroma: row threadIdx.y of MB row mbr of Cb (part 2) or Cr (3) -----
  const int2 v = __ldg(mv + 4 * mb + 2 * (threadIdx.y >> 2) + (qc & 1));
  const uint8_t* p = part == 2 ? cb_pad : cr_pad;
  const int hp = H / 2 + 2 * ext_c + 2, wp = W / 2 + 2 * ext_c + 2;
  const int y = 8 * mbr + threadIdx.y, x0 = 4 * qc;
  const int cy = clampi(y + (v.y >> 3) + ext_c + 1, 0, hp - 2);
  const int cx = x0 + (v.x >> 3) + ext_c + 1;
  const int fx = v.x & 7, fy = v.y & 7;
  const size_t b = (size_t)cy * wp + cx;
  const size_t nwords = (size_t)hp * wp / 4;
  int t0[5], t1[5];  // rows cy and cy + 1, samples cx .. cx + 4
  int a0[4], a1[4];  // sample i's right taps: t0[i + 1], t1[i + 1] unclamped
  if (cx >= 0 && cx + 5 <= wp && b + wp + 5 <= 4 * nwords) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(p);
    const uint2 r0 = load5(words, b), r1 = load5(words, b + wp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t0[i] = byte_of(r0.x, i);
      t1[i] = byte_of(r1.x, i);
    }
    t0[4] = (int)r0.y;
    t1[4] = (int)r1.y;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a0[i] = t0[i + 1];
      a1[i] = t1[i + 1];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t o = (size_t)cy * wp + clampi(cx + i, 0, wp - 2);
      t0[i] = __ldg(p + o);
      a0[i] = __ldg(p + o + 1);
      t1[i] = __ldg(p + o + wp);
      a1[i] = __ldg(p + o + wp + 1);
    }
  }
  const int w00 = (8 - fx) * (8 - fy), w01 = fx * (8 - fy), w10 = (8 - fx) * fy, w11 = fx * fy;
  int o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = (w00 * t0[i] + w01 * a0[i] + w10 * t1[i] + w11 * a1[i] + 32) >> 6;
  }
  int32_t* pc = part == 2 ? pred_cb : pred_cr;
  *reinterpret_cast<int4*>(pc + (size_t)y * (W / 2) + x0) = make_int4(o[0], o[1], o[2], o[3]);
}

}  // namespace

// planes (16, H + 2 ext, W + 2 ext) and cb_pad / cr_pad
// (H/2 + 2 ext_c + 2, W/2 + 2 ext_c + 2) uint8, each 4-byte aligned; mv
// (nmb, 4, 2) int32 quadrant-major qpel MVs, 8-byte aligned; pred_y (H, W),
// pred_cb / pred_cr (H/2, W/2) int32 out, 16-byte aligned. Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int mc_bulk(const uint8_t* planes, const uint8_t* cb_pad,
                       const uint8_t* cr_pad, const int32_t* mv,
                       int32_t* pred_y, int32_t* pred_cb, int32_t* pred_cr,
                       int W, int H, int ext, int ext_c, cudaStream_t stream) {
  const int wmb = W / 16, hmb = H / 16;
  const dim3 grid((2 * wmb + kStrip - 1) / kStrip, 4 * hmb), block(kStrip, kRows);
  mc_kernel<<<grid, block, 0, stream>>>(planes, cb_pad, cr_pad,
                                        reinterpret_cast<const int2*>(mv), wmb, hmb,
                                        ext, ext_c, pred_y, pred_cb, pred_cr);
  return (int)cudaGetLastError();
}
