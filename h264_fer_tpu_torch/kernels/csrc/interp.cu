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
// Design (the first design, a block per 64 x 16 tile staging int32
// in shared memory and storing a byte a position and plane, reached a
// quarter of the bound): one launch of a persistent grid, block b taking
// rows [b he / grid, (b + 1) he / grid) of the 16 planes, one row at a time,
// and a warp per strip of kStrip = 120 positions (two strips a warp where a
// row has more than kMaxWarps), in packed bytes. Lane l holds 4 reference
// samples a row, the strip's base word l (positions X0 - 4 + 4l .. X0 - 1 +
// 4l; 32 words cover the strip and its halo), read as aligned words
// funnel-shifted (bytes where a column clamps), and keeps the six rows the
// vertical 6-tap reads in registers from one row to the next, the row below
// read a row ahead. A row's hv is a 16-bit-lane SIMD 6-tap (two columns a
// register, biased so no lane borrows); b and j of the lane's positions X0
// + 4l .. + 3 are dp4a.u32.s32 over packed words (unsigned samples times
// signed taps), the words of lanes l + 1 and l + 2 come by shuffles, and
// the twelve averages are per-byte (a | b) - (((a ^ b) & 0xfe..) >> 1).
// Stores decide the time: each lane storing its 4 bytes of the 16 planes
// straight to memory was, on the card, as slow as the whole kernel and
// half the speed of one contiguous fill of the same bytes, while blocks
// writing whole plane rows come near that fill. So lanes 0-29 put their
// bytes of each plane into a shared-memory row buffer laid out so that
// every byte sits at its global address mod 32, and after one barrier 16
// threads hand each plane's row to the bulk copy engine (cp.async.bulk) in
// whole 32-byte sectors: the bytes of the sector the row before ended in
// are carried ahead of the row, and the row's last bytes go on to the next.
// The warps compute the next row into the second buffer while the engine
// writes. Bytes outside whole sectors at a block's first and last rows, and
// rows of under 32 bytes, are stored one by one.

#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace {

constexpr int kStrip = 120;    // positions a warp computes in a row (lanes 0-29)
constexpr int kMaxWarps = 18;  // warps a block: a warp a strip, or two where a row has more
constexpr int kSmem = 232448;  // shared memory a block may have on sm_90
constexpr unsigned kAll = 0xffffffffu;

// a.u8[0] * b.s8[0] + ... + a.u8[3] * b.s8[3] + c: unsigned samples, signed taps
__device__ __forceinline__ int dp4a_us(unsigned a, unsigned b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ unsigned clip8(int v) {
  return (unsigned)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// the horizontal 6-tap, clipped, of the 4 positions x .. x + 3 whose
// samples x - 4 .. x + 7 are the bytes of w0, w1, w2, packed a byte each;
// each tap's words of dp4a weights are its taps at the bytes they meet
__device__ __forceinline__ unsigned tap6_h(unsigned w0, unsigned w1, unsigned w2) {
  const int v0 = dp4a_us(w1, 0x01FB1414u, dp4a_us(w0, 0xFB010000u, 16));
  const int v1 = dp4a_us(w2, 0x00000001u, dp4a_us(w1, 0xFB1414FBu,
                                                   dp4a_us(w0, 0x01000000u, 16)));
  const int v2 = dp4a_us(w2, 0x000001FBu, dp4a_us(w1, 0x1414FB01u, 16));
  const int v3 = dp4a_us(w2, 0x0001FB14u, dp4a_us(w1, 0x14FB0100u, 16));
  return __byte_perm(__byte_perm(clip8(v0 >> 5), clip8(v1 >> 5), 0x0040),
                     __byte_perm(clip8(v2 >> 5), clip8(v3 >> 5), 0x0040), 0x5410);
}

// the vertical 6-tap, clipped, of two columns held as 16-bit lanes (rows
// r0 .. r5): each lane is x + 16 + 2560 in 26 .. 13286 (2560 = 80 x 32
// keeps it from borrowing), so (lane >> 5) - 80 is (x + 16) >> 5
__device__ __forceinline__ unsigned tap6_v(unsigned r0, unsigned r1, unsigned r2, unsigned r3,
                                           unsigned r4, unsigned r5) {
  const unsigned t = (r0 + r5) + 20u * (r2 + r3) + (0x0A100A10u - 5u * (r1 + r4));
  const unsigned v = (t >> 5) & 0x07FF07FFu;
  return __vminu2(__vmaxu2(v, 0x00500050u), 0x014F014Fu) - 0x00500050u;
}

// (a + b + 1) >> 1 of each byte
__device__ __forceinline__ unsigned avg4(unsigned a, unsigned b) {
  return (a | b) - (((a ^ b) & 0xFEFEFEFEu) >> 1);
}

// the 16 planes' 4 bytes at o (stride bytes apart), n of them in the row
// (n < 4 at a row's ragged end): 32-bit stores where every plane's bytes
// are 4-byte aligned, 16-bit stores where 2-byte aligned, else bytes
__device__ __forceinline__ void store16(uint8_t* o, int stride, const unsigned (&p)[16],
                                        int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(o) | (uintptr_t)stride;
  if (n == 4 && (a & 3) == 0) {
#pragma unroll
    for (int f = 0; f < 16; ++f) *reinterpret_cast<uint32_t*>(o + f * stride) = p[f];
  } else if (n == 4 && (a & 1) == 0) {
#pragma unroll
    for (int f = 0; f < 16; ++f) {
      reinterpret_cast<uint16_t*>(o + f * stride)[0] = (uint16_t)p[f];
      reinterpret_cast<uint16_t*>(o + f * stride)[1] = (uint16_t)(p[f] >> 16);
    }
  } else {
#pragma unroll
    for (int f = 0; f < 16; ++f) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < n) o[f * stride + k] = (uint8_t)(p[f] >> (8 * k));
      }
    }
  }
}

// The async proxy's bulk copy of `bytes` (a multiple of 16) from shared
// memory at src to global memory at dst, both 16-byte aligned, in this
// thread's current bulk group; the issuing thread's groups are committed,
// and waited on until their sources have been read, apart.
__device__ __forceinline__ void bulk_store(uint8_t* dst, const uint8_t* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(static_cast<unsigned>(__cvta_generic_to_shared(src))),
                  "r"(bytes) : "memory");
}

// The rolling state of one strip at row Y: rows Y - 2 .. Y + 3 of its
// lane's word as 16-bit-lane halves (bytes 0, 2 and 1, 3), row Y's words of
// lanes l + 1 and l + 2, and row Y's b.
struct Strip {
  unsigned lo[6], hi[6], c1, c2, b;
};

// Plane f's row lies in a buffer at f * stride + 32 + ph, whose address is
// the row's global address mod 32 (stride = plane mod 32, ph that of plane
// 0; the 32 bytes before it take the bytes carried from the row before).
template <int kS>
__global__ void __launch_bounds__(kMaxWarps * 32)
interp_kernel(const uint8_t* __restrict__ ref, int rows, int W, int ext, int row_off, int he,
              int words, int stride, int boff, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int we = W + 2 * ext, strips = (we + kStrip - 1) / kStrip;
  const size_t plane = (size_t)he * we;
  const int Yb = (int)((size_t)blockIdx.x * he / gridDim.x);
  const int Ye = (int)((size_t)(blockIdx.x + 1) * he / gridDim.x);
  // the lane's word of reference row Y of strip s
  auto row_word = [&](int s, int Y) -> unsigned {
    const int X0 = s * kStrip, x = X0 - 4 - ext + 4 * lane;
    const uint8_t* r = ref + (size_t)min(max(Y + row_off, 0), rows - 1) * W;
    // aligned words where no column of the strip clamps (words: ref and W
    // allow 4-byte reads)
    if (words && X0 - 4 - ext >= 0 && X0 + 123 - ext <= W - 1) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(r + (x & ~3));
      const int sh = 8 * (x & 3);
      return sh ? __funnelshift_r(p[0], p[1], sh) : p[0];
    }
    unsigned g = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) g |= (unsigned)r[min(max(x + q, 0), W - 1)] << (8 * q);
    return g;
  };
  Strip st[kS];
#pragma unroll
  for (int u = 0; u < kS; ++u) {
    const int s = warp + u * warps;
    if (s < strips) {
#pragma unroll
      for (int t = 0; t < 6; ++t) {
        const unsigned g = row_word(s, Yb - 2 + t);
        st[u].lo[t] = g & 0x00FF00FFu;
        st[u].hi[t] = (g >> 8) & 0x00FF00FFu;
      }
      const unsigned g0 = st[u].lo[2] | st[u].hi[2] << 8;
      st[u].c1 = __shfl_down_sync(kAll, g0, 1);
      st[u].c2 = __shfl_down_sync(kAll, g0, 2);
      st[u].b = tap6_h(g0, st[u].c1, st[u].c2);
    }
  }
  int ph_prev = 0;
  for (int Y = Yb, k = 0; Y < Ye; ++Y, ++k) {
    uint8_t* buf = stage + (k & 1) * boff;
    const int ph = (int)((reinterpret_cast<uintptr_t>(out) + (size_t)Y * we) & 31);
#pragma unroll
    for (int u = 0; u < kS; ++u) {
      const int s = warp + u * warps;
      if (s >= strips) continue;
      Strip& a = st[u];
      const int X = s * kStrip + 4 * lane;
      const int n = min(4, we - X);
      const unsigned ahead = row_word(s, Y + 4);
      const unsigned hv0 = __byte_perm(
          tap6_v(a.lo[0], a.lo[1], a.lo[2], a.lo[3], a.lo[4], a.lo[5]),
          tap6_v(a.hi[0], a.hi[1], a.hi[2], a.hi[3], a.hi[4], a.hi[5]), 0x6240);
      const unsigned hv1 = __shfl_down_sync(kAll, hv0, 1);
      const unsigned hv2 = __shfl_down_sync(kAll, hv0, 2);
      const unsigned g1 = a.lo[3] | a.hi[3] << 8;  // row Y + 1
      const unsigned n1 = __shfl_down_sync(kAll, g1, 1), n2 = __shfl_down_sync(kAll, g1, 2);
      const unsigned sb = tap6_h(g1, n1, n2);  // b one row down
      if (lane < 30 && n > 0) {
        const unsigned j = tap6_h(hv0, hv1, hv2), hv = hv1, m = __funnelshift_r(hv1, hv2, 8);
        const unsigned gg = a.c1, gx1 = __funnelshift_r(a.c1, a.c2, 8), gy1 = n1, b = a.b;
        const unsigned p[16] = {gg, avg4(gg, b), b, avg4(b, gx1),
                                avg4(gg, hv), avg4(b, hv), avg4(b, j), avg4(b, m),
                                hv, avg4(hv, j), j, avg4(j, m),
                                avg4(hv, gy1), avg4(hv, sb), avg4(j, sb), avg4(sb, m)};
        store16(buf + 32 + ph + X, stride, p, n);
      }
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        a.lo[t] = a.lo[t + 1];
        a.hi[t] = a.hi[t + 1];
      }
      a.lo[5] = ahead & 0x00FF00FFu;
      a.hi[5] = (ahead >> 8) & 0x00FF00FFu;
      a.c1 = n1;
      a.c2 = n2;
      a.b = sb;
    }
    // Plane f's row: global [gs, gs + we). The engine writes whole sectors
    // from the first boundary (a block's first row) or from the sector the
    // row before ended in, whose last bytes are carried ahead of the row,
    // to the last boundary, whose bytes go on to the next row.
    const bool first = Y == Yb, last = Y + 1 == Ye, bulk = we >= 32;
    if (bulk && !first) {
      const uint8_t* prev = stage + ((k - 1) & 1) * boff + 32 + ph_prev + we;
      for (int t = threadIdx.x; t < 16 * 32; t += blockDim.x) {
        const int f = t & 15, q = t >> 4;
        const int c = (int)((reinterpret_cast<uintptr_t>(out) + f * plane + (size_t)Y * we) & 31);
        if (q < c) buf[f * stride + 32 + ph - c + q] = prev[f * stride - c + q];
      }
    }
    // the row's shared-memory writes, seen by the bulk copies; the copies
    // of the row before done reading the other buffer
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (threadIdx.x < 16) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncthreads();
    if (bulk && threadIdx.x < 16) {
      const int f = threadIdx.x;
      const uintptr_t gs = reinterpret_cast<uintptr_t>(out + f * plane + (size_t)Y * we);
      const uintptr_t lo = first ? (gs + 31) & ~(uintptr_t)31 : gs & ~(uintptr_t)31;
      const uintptr_t hi = (gs + we) & ~(uintptr_t)31;
      if (hi > lo)
        bulk_store(reinterpret_cast<uint8_t*>(lo), buf + f * stride + 32 + ph - (int)(gs - lo),
                   (int)(hi - lo));
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (first || last || !bulk) {
      for (int t = threadIdx.x; t < 16 * (bulk ? 64 : we); t += blockDim.x) {
        const int f = t & 15, q = t >> 4;
        uint8_t* g = out + f * plane + (size_t)Y * we;
        const int c = (int)(reinterpret_cast<uintptr_t>(g) & 31);
        const int head = first ? min(we, (32 - c) & 31) : 0;  // bytes before the first sector
        const int tail = last ? we - max(head, ((we + c) & ~31) - c) : 0;  // after the last
        const int at = !bulk ? q : q < 32 ? q : we - tail + q - 32;
        if (!bulk || (q < 32 ? q < head : q - 32 < tail && at >= head))
          g[at] = buf[f * stride + 32 + ph + at];
      }
    }
    ph_prev = ph;
  }
  if (threadIdx.x < 16) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int kS>
cudaError_t launch(const uint8_t* ref, uint8_t* out, int rows, int W, int ext, int row_off,
                   int he, int words, cudaStream_t stream) {
  const int we = W + 2 * ext;
  const size_t plane = (size_t)he * we;
  // room for a row, the 32 bytes carried ahead of it and its offset of up
  // to 31 bytes, equal to plane mod 32; a buffer of 16 rows, rounded up to
  // 32 bytes; two buffers
  const int stride = we + 63 + (int)((plane - (size_t)(we + 63)) & 31);
  const int boff = (16 * stride + 31) & ~31;
  const int bytes = 2 * boff;
  const int warps = ((we + kStrip - 1) / kStrip + kS - 1) / kS;
  if (bytes > kSmem || warps > kMaxWarps) return cudaErrorInvalidValue;
  // the shared-memory allowance and the blocks an SM holds, set and asked
  // for again only when the device or the launch's shape changes
  static std::mutex mu;
  static int last_dev = -1, last_warps = 0, last_bytes = 0, grid_max = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev != last_dev || warps != last_warps || bytes != last_bytes) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(interp_kernel<kS>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, interp_kernel<kS>,
                                                             32 * warps, bytes)) != cudaSuccess)
      return err;
    last_dev = dev;
    last_warps = warps;
    last_bytes = bytes;
    grid_max = per_sm * sms;
  }
  interp_kernel<kS><<<max(1, min(grid_max, he)), 32 * warps, bytes, stream>>>(
      ref, rows, W, ext, row_off, he, words, stride, boff, out);
  return cudaGetLastError();
}

}  // namespace

// ref (rows, W) uint8; out (16, he, W + 2 ext) uint8. Frame form: rows = H, he = H + 2 ext, row_off = -ext; band
// form: rows = hb + 2 (ext + 4), he = hb + 2 ext, row_off = 4. Returns the
// CUDA error of the launch (0 when it was accepted; cudaErrorInvalidValue
// where a row is wider than 2 x kMaxWarps strips or its two buffers do not
// fit in shared memory) and counts it in *launched.
extern "C" int interp_planes(const uint8_t* ref, uint8_t* out, int rows, int W,
                             int ext, int row_off, int he, cudaStream_t stream,
                             int* launched) {
  *launched = 0;
  if (rows <= 0 || W <= 0 || ext < 0 || he <= 0) return (int)cudaErrorInvalidConfiguration;
  const int words = (reinterpret_cast<uintptr_t>(ref) & 3) == 0 && W % 4 == 0;
  const int strips = (W + 2 * ext + kStrip - 1) / kStrip;
  const cudaError_t err =
      strips <= kMaxWarps ? launch<1>(ref, out, rows, W, ext, row_off, he, words, stream)
                          : launch<2>(ref, out, rows, W, ext, row_off, he, words, stream);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
