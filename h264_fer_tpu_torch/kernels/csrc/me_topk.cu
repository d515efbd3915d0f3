// Stable top-K selection of integer MV candidates (K9) for sm_90a.
//
// Replaces `jax.lax.top_k(-sads_all.T, topk)` and the MV arithmetic after
// it in h264_fer_tpu/ops/me.full_search_topk (ops/me.py:56-58; the function
// at :27). Input: the (nb, S*S) int32 score map of K2 (csrc/me_int.cu), S =
// 2*window + 1, shift index s = (dy + window) * S + (dx + window). Output,
// one (3, nb, topk) int32 buffer: per block the topk least scores in
// ascending order, ties to the lower shift index (the order of a stable
// sort, so slot 0 is the first least score), then their MVs in quarter pel,
// mvx = (s % S - window) * 4 and mvy = (s / S - window) * 4.
//
// What bounds it on an H100: bytes. At 1080p, window 8 and topk 16 it
// reads the 37.7 MB map once and writes 6.3 MB, ~0.013 ms at 3.35 TB/s; its
// selection is ~0.2 G int32 operations.
//
// Design: one warp per block of the map. Lane l holds the keys of the
// shifts l, l + 32, ... in registers (NK of them, loaded coalesced), a key
// being (score with its sign bit flipped) << 32 | shift: unsigned order is
// score order, then shift order, and no two keys are equal. Round r finds
// the least key not below `lo` (0, then the last winner + 1): a lane-local
// minimum over its keys, then the warp minimum as two __reduce_min_sync,
// the high halves first, then the low halves of the lanes that hold that
// high half. No key is ever retired or moved, so there is no dynamically
// indexed register array. Lane r % 32 keeps round r's result; every 32
// rounds (and after the last) the lanes store theirs, coalesced. For maps
// wider than 32 * 36 shifts (window > 16) the keys are read from the row
// every round instead of held.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // blocks of the map per thread block

__device__ __forceinline__ uint64_t make_key(int32_t score, int s) {
  return (uint64_t)((uint32_t)score ^ 0x80000000u) << 32 | (uint32_t)s;
}

// NK > 0: the keys held in registers, NK per lane; NK == 0: re-read.
template <int NK>
__global__ void topk_kernel(const int32_t* __restrict__ map, int nb, int ss,
                            int S, int window, int topk,
                            int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= nb) return;  // the whole warp leaves together
  const int32_t* row = map + (size_t)b * ss;
  uint64_t key[NK > 0 ? NK : 1];
  if constexpr (NK > 0) {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int s = lane + 32 * k;
      key[k] = s < ss ? make_key(row[s], s) : ~0ull;
    }
  }
  int32_t* sads = out;
  int32_t* mvx = out + (size_t)nb * topk;
  int32_t* mvy = mvx + (size_t)nb * topk;
  uint64_t lo = 0;
  int hs = 0, hx = 0, hy = 0;
  for (int r = 0; r < topk; ++r) {
    uint64_t best = ~0ull;
    if constexpr (NK > 0) {
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        if (key[k] >= lo && key[k] < best) best = key[k];
      }
    } else {
      for (int s = lane; s < ss; s += 32) {
        const uint64_t k = make_key(row[s], s);
        if (k >= lo && k < best) best = k;
      }
    }
    const unsigned hi = __reduce_min_sync(kFull, (unsigned)(best >> 32));
    const unsigned low = __reduce_min_sync(
        kFull, (unsigned)(best >> 32) == hi ? (unsigned)best : kFull);
    if (lane == (r & 31)) {
      hs = (int32_t)(hi ^ 0x80000000u);
      hx = ((int)low % S - window) * 4;
      hy = ((int)low / S - window) * 4;
    }
    if ((r & 31) == 31 || r == topk - 1) {
      if (lane <= (r & 31)) {
        const size_t o = (size_t)b * topk + (r & ~31) + lane;
        sads[o] = hs;
        mvx[o] = hx;
        mvy[o] = hy;
      }
    }
    lo = ((uint64_t)hi << 32 | low) + 1;
  }
}

}  // namespace

// map (nb, S*S) int32, row-major; out (3, nb, topk) int32: scores, mvx,
// mvy. The caller guarantees 1 <= topk <= S*S. Returns the CUDA error of
// the launch (0 when it was accepted).
extern "C" int me_topk_select(const int32_t* map, int32_t* out, int nb,
                              int window, int topk, cudaStream_t stream) {
  const int S = 2 * window + 1;
  const int ss = S * S;
  const int nk = (ss + 31) / 32;
  const dim3 grid((nb + kWarps - 1) / kWarps);
  const int threads = 32 * kWarps;
  if (nk <= 4) {
    topk_kernel<4><<<grid, threads, 0, stream>>>(map, nb, ss, S, window, topk, out);
  } else if (nk <= 10) {
    topk_kernel<10><<<grid, threads, 0, stream>>>(map, nb, ss, S, window, topk, out);
  } else if (nk <= 36) {
    topk_kernel<36><<<grid, threads, 0, stream>>>(map, nb, ss, S, window, topk, out);
  } else {
    topk_kernel<0><<<grid, threads, 0, stream>>>(map, nb, ss, S, window, topk, out);
  }
  return (int)cudaGetLastError();
}
