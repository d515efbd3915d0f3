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
// The window origin is clamped into the planes, so a centre outside the
// caller's range contract reads a wrong window, never outside the buffer.
//
// What bounds it on an H100: bytes. The windows of a frame's blocks cover
// about H x W samples of every phase, so the function reads ~33 MB of the
// 34 MB stack at 1080p, plus the source, 0.5 MB of centres and 12.8 MB of
// maps out: ~0.015 ms at 3.35 TB/s. In packed bytes its arithmetic is two
// instructions per 4 samples (a per-byte absolute difference, then a
// 4-way dot product that sums it or its square), 2 x 32,640 x 49 x 32 =
// 0.10 G at 1080p, ~0.006 ms at the int32 rate. A first design ran one
// thread per (map, block, offset) with 64 single-byte window loads each:
// the 49 threads of a block read 16 phase planes 2.2 MB apart at unaligned
// origins, so the load path, not the bytes or the arithmetic, set its time.
//
// Design: one warp per (block, centre); a CTA takes kWarps neighbouring
// blocks of one map. Around a centre, the 7 offsets of an axis reach each
// quarter-pel phase at one or two integer positions one apart, so the 49
// windows of a phase lie in one tile of 9 x 9 samples. The warp stages the
// 16 tiles in shared memory: each lane copies whole tile rows, three
// aligned words each, and stores every row twice, as its samples [0, 8) and
// [1, 9), so a window row is one aligned 8-byte load. The source block is
// 16 words in every lane's registers (one load per lane, then shuffles).
// Lane l scores offsets l and l + 32: per window row, __vabsdiffu4 of two
// words against the source, then __dp4a with 0x01010101 (SAD) or with
// itself (SSD); exact in int32, as 64 x 255^2 < 2^31. Each map is written
// with coalesced stores, 49 neighbouring words per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // (block, centre) tasks of a CTA
constexpr int kTile = 9;   // rows and columns of a phase tile

// A warp's 16 phase tiles: row i of phase p's tile as two 8-byte windows,
// its samples [0, 8) and [1, 9).
struct Tiles {
  uint2 row[16][kTile][2];
};

// The tile's origin along one axis of length n (n >= 9): both window
// origins clamp(o, 0, n - 8) and clamp(o + 1, 0, n - 8) that the offsets
// of one phase can reach lie in [T, T + 1], T = clamp(o, 0, n - 9).
__device__ __forceinline__ int tile_origin(int o, int n) {
  return min(max(o, 0), n - kTile);
}

// The unclamped origin, along one axis, of the first window of phase f
// around centre c of the block at b0: the smallest MV in [c - 3, c + 3]
// whose quarter-pel phase is f, as an integer sample offset.
__device__ __forceinline__ int first_window(int c, int f, int b0, int ext) {
  const int mv = c - 3 + ((f - (c - 3)) & 3);
  return b0 + (mv >> 2) + ext;
}

template <int M>
__global__ void __launch_bounds__(kWarps * 32)
qpel_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ planes,
            const int32_t* __restrict__ c1, const int32_t* __restrict__ c2, int W,
            int he, int we, int ext, int wb, int nb, int32_t* __restrict__ q1,
            int32_t* __restrict__ q2) {
  __shared__ Tiles s_tiles[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int task = blockIdx.x * kWarps + warp;
  if (task >= 2 * nb) return;  // warp-uniform
  const int m = task >= nb, b = task - m * nb;
  const int32_t* c = m ? c2 : c1;
  const int cx = __ldg(c + 2 * b), cy = __ldg(c + 2 * b + 1);
  const int bx0 = (b % wb) * 8, by0 = (b / wb) * 8;
  Tiles& tiles = s_tiles[warp];

  // ---- stage the 16 phase tiles: 144 rows, three aligned words each -------
  for (int k = lane; k < 16 * kTile; k += 32) {
    const int ph = k / kTile, i = k - ph * kTile;
    const int tx = tile_origin(first_window(cx, ph & 3, bx0, ext), we);
    const int ty = tile_origin(first_window(cy, ph >> 2, by0, ext), he);
    const uint8_t* p = planes + (size_t)ph * he * we + (size_t)(ty + i) * we + tx;
    const uint32_t* a = reinterpret_cast<const uint32_t*>((uintptr_t)p & ~(uintptr_t)3);
    const unsigned sh = 8u * ((uintptr_t)p & 3);
    const uint32_t w0 = __ldg(a), w1 = __ldg(a + 1), w2 = __ldg(a + 2);
    tiles.row[ph][i][0] = make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
    tiles.row[ph][i][1] = make_uint2(__funnelshift_rc(w0, w1, sh + 8),
                                     __funnelshift_rc(w1, w2, sh + 8));
  }
  // ---- the source block: word j is row j / 2, samples 4 (j & 1) .. +3 -----
  const uint32_t mine = lane < 16 ? __ldg(reinterpret_cast<const uint32_t*>(
      src + (size_t)(by0 + (lane >> 1)) * W + bx0 + 4 * (lane & 1))) : 0u;
  uint32_t s[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = __shfl_sync(0xffffffffu, mine, j);
  __syncwarp();

  // ---- score offsets lane and lane + 32 ---------------------------------
  int32_t* q = (m ? q2 : q1) + (size_t)b * 49;
  for (int k = lane; k < 49; k += 32) {
    const int mvx = cx + k % 7 - 3, mvy = cy + k / 7 - 3;
    const int fx = mvx & 3, fy = mvy & 3;
    const int sx = min(max(bx0 + (mvx >> 2) + ext, 0), we - 8) -
                   tile_origin(first_window(cx, fx, bx0, ext), we);
    const int sy = min(max(by0 + (mvy >> 2) + ext, 0), he - 8) -
                   tile_origin(first_window(cy, fy, by0, ext), he);
    const uint2(*rows)[2] = tiles.row[fy * 4 + fx] + sy;
    unsigned acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint2 w = rows[i][sx];
      const unsigned d0 = __vabsdiffu4(w.x, s[2 * i]), d1 = __vabsdiffu4(w.y, s[2 * i + 1]);
      if (M == 0) {
        acc = __dp4a(d0, 0x01010101u, acc);
        acc = __dp4a(d1, 0x01010101u, acc);
      } else {
        acc = __dp4a(d0, d0, acc);
        acc = __dp4a(d1, d1, acc);
      }
    }
    q[k] = M == 2 ? 2 * (int)acc : (int)acc;
  }
}

}  // namespace

// src (H, W) and planes (16, H + 2 ext, W + 2 ext) uint8, both 4-byte
// aligned, H + 2 ext and W + 2 ext at least 9; c1, c2 (nb, 2) int32 qpel
// centres; q1, q2 (nb, 49) int32 out. One launch for both maps. Returns
// the CUDA error of the launch (0 when it was accepted).
extern "C" int me_qpel_refine(const uint8_t* src, const uint8_t* planes,
                              const int32_t* c1, const int32_t* c2,
                              int32_t* q1, int32_t* q2, int W, int H, int ext,
                              int metric, cudaStream_t stream) {
  const int wb = W / 8, nb = wb * (H / 8);
  const int he = H + 2 * ext, we = W + 2 * ext;
  const int blocks = (2 * nb + kWarps - 1) / kWarps;
  if (metric == 0) {
    qpel_kernel<0><<<blocks, kWarps * 32, 0, stream>>>(src, planes, c1, c2, W, he,
                                                       we, ext, wb, nb, q1, q2);
  } else if (metric == 1) {
    qpel_kernel<1><<<blocks, kWarps * 32, 0, stream>>>(src, planes, c1, c2, W, he,
                                                       we, ext, wb, nb, q1, q2);
  } else {
    qpel_kernel<2><<<blocks, kWarps * 32, 0, stream>>>(src, planes, c1, c2, W, he,
                                                       we, ext, wb, nb, q1, q2);
  }
  return (int)cudaGetLastError();
}
