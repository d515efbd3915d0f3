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
// reads the 37.7 MB map once and writes 6.3 MB, ~0.013 ms at 3.35 TB/s. A
// selection that rescans every key each round is bound by instruction
// issue instead, so this one does each key's work once and keeps the
// instruction count of a row low.
//
// Design: one warp per block of the map (a row), 8 warps a thread block.
// Lane l loads the scores of the shifts l, l + 32, ... (NK of them,
// coalesced, from one base at constant offsets), and the warp takes the
// row's least and largest score (two reductions, once). Each score becomes
// a key whose unsigned order is score order, then shift order, with no two
// keys equal. Where the row's range fits in 32 - sbits bits (sbits =
// ceil(log2(S*S))), the key is 32 bits, (score - row min) << sbits | s:
// one compare per compare-exchange and one __reduce_min_sync per round
// (every SAD row at window 8, whose range is below 2^14). Other rows (the
// int32 extremes) take 64 bits, (score with its sign bit flipped) << 32 |
// s, and two reductions, the high halves first. The data chooses per row;
// both forms share the code below. Each lane sorts its NK keys once in
// registers, with Batcher's odd-even merge network (32 compare-exchanges
// at NK = 10), keeps its least as its head and the rest in its column of
// shared memory. Round r takes the warp minimum of the heads; the one lane
// holding it reads its next key from shared memory, and lane 0 writes the
// winner to won[r % 32]. Every 32 rounds (and after the last) lane l
// decodes won[l] and stores it, coalesced. The CLI's window 8 has an
// instance of its own with S = 17 fixed, so that the row's bounds, the
// shift bits and the division by S are constants. For maps wider than 32
// * 36 shifts (window > 16) each round instead takes the least key above
// the last winner, re-reading the row. (Shifting each list down in
// registers, NK selects a round, and a persistent grid loading the next
// row during this row's rounds were both slower: PERF.md.)

#include <climits>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // blocks of the map per thread block

// The 32-bit key of a row whose range fits in 32 - sbits bits.
struct Narrow {
  using Key = uint32_t;
  int32_t base;  // the row's least score
  int sbits;
  __device__ __forceinline__ Key key(int32_t score, int s) const {
    return ((uint32_t)score - (uint32_t)base) << sbits | (uint32_t)s;
  }
  __device__ __forceinline__ int32_t score(Key k) const {
    return (int32_t)((uint32_t)base + (k >> sbits));
  }
  __device__ __forceinline__ int shift(Key k) const {
    return (int)(k & ((1u << sbits) - 1));
  }
};

// The 64-bit key of any row.
struct Wide {
  using Key = uint64_t;
  __device__ __forceinline__ Key key(int32_t score, int s) const {
    return (uint64_t)((uint32_t)score ^ 0x80000000u) << 32 | (uint32_t)s;
  }
  __device__ __forceinline__ int32_t score(Key k) const {
    return (int32_t)((uint32_t)(k >> 32) ^ 0x80000000u);
  }
  __device__ __forceinline__ int shift(Key k) const { return (int)(uint32_t)k; }
};

__device__ __forceinline__ uint32_t warp_min(uint32_t k) {
  return __reduce_min_sync(kFull, k);
}

__device__ __forceinline__ uint64_t warp_min(uint64_t k) {
  const unsigned hi = __reduce_min_sync(kFull, (unsigned)(k >> 32));
  const unsigned lo =
      __reduce_min_sync(kFull, (unsigned)(k >> 32) == hi ? (unsigned)k : kFull);
  return (uint64_t)hi << 32 | lo;
}

struct Cmp {
  int i, j;
};

// The idx-th compare-exchange (i, j), i < j, of Batcher's odd-even merge
// sort of n keys, or past the last {-1, the network's size}: the network
// of the next power of two without the compare-exchanges that touch an
// index >= n (those would only meet keys above every key). Evaluated at
// compile time only.
__host__ __device__ constexpr Cmp batcher(int n, int idx) {
  int c = 0;
  for (int p = 1; p < n; p *= 2) {
    for (int k = p; k >= 1; k /= 2) {
      for (int j = k % p; j + k < n; j += 2 * k) {
        for (int i = 0; i < k && i + j + k < n; ++i) {
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            if (c == idx) return {i + j, i + j + k};
            ++c;
          }
        }
      }
    }
  }
  return {-1, c};
}

template <int I, int J, typename Key, int N>
__device__ __forceinline__ void compare_exchange(Key (&a)[N]) {
  const Key x = a[I], y = a[J];
  a[I] = x < y ? x : y;
  a[J] = x < y ? y : x;
}

template <int N, typename Key, int... C>
__device__ __forceinline__ void sort_keys(Key (&a)[N], std::integer_sequence<int, C...>) {
  (compare_exchange<batcher(N, C).i, batcher(N, C).j>(a), ...);
}

// a[0..N) ascending, by a network whose every index is a template
// argument, so the keys stay in registers (32 compare-exchanges at N = 10).
template <int N, typename Key>
__device__ __forceinline__ void sort_keys(Key (&a)[N]) {
  sort_keys(a, std::make_integer_sequence<int, batcher(N, -1).j>());
}

// Bits of x >= 0 (0 for 0).
__host__ __device__ constexpr int bit_width(int x) {
  int b = 0;
  while (x >> b) ++b;
  return b;
}

struct Row {
  const int32_t* scores;  // the row of the map
  int b, nb, ss, S, window, topk;
  int32_t* out;  // the (3, nb, topk) output

  // Decodes key k into the row's slot: its score, mvx and mvy.
  template <typename Codec>
  __device__ __forceinline__ void store(const Codec& c, int slot,
                                        typename Codec::Key k) const {
    const int s = c.shift(k);
    int32_t* o = out + (size_t)b * topk + slot;
    const size_t plane = (size_t)nb * topk;
    o[0] = c.score(k);
    o[plane] = (s % S - window) * 4;
    o[2 * plane] = (s / S - window) * 4;
  }
};

// Round r of a chunk of up to 32 rounds leaves its winner in won[r] (lane
// 0 writes it); lane l then decodes and stores won[l].
template <typename Codec>
__device__ __forceinline__ void store_chunk(const Codec& c, const Row& row, int lane,
                                            int base, int n, const uint64_t* won) {
  __syncwarp();
  if (lane < n) row.store(c, base + lane, (typename Codec::Key)won[lane]);
  __syncwarp();  // read before the next chunk writes
}

// The rounds over held keys, NK a lane (v: the lane's scores). Each lane
// sorts its keys in registers, keeps its least as its head and the rest,
// then a pad, in its column of `list` (shared memory, NK * 32 keys a warp,
// widened to 64 bits whatever the key form: a lane reads and writes only
// its own column). The round's winner reads its next key from there.
template <int NK, typename Codec>
__device__ __forceinline__ void select_held(const Codec c, const int32_t (&v)[NK],
                                            const Row& row, int lane, uint64_t* list,
                                            uint64_t* won) {
  using Key = typename Codec::Key;
  Key key[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int s = lane + 32 * k;
    key[k] = s < row.ss ? c.key(v[k], s) : ~Key(0);
  }
  sort_keys(key);
#pragma unroll
  for (int k = 1; k < NK; ++k) list[(k - 1) * 32 + lane] = key[k];
  list[(NK - 1) * 32 + lane] = ~Key(0);
  Key head = key[0];
  const uint64_t* next = list + lane;
  for (int base = 0; base < row.topk; base += 32) {
    const int n = min(32, row.topk - base);
    for (int r = 0; r < n; ++r) {
      const Key m = warp_min(head);
      if (lane == 0) won[r] = m;
      if (head == m) {  // keys are unique: one lane
        head = (Key)*next;
        next += 32;
      }
    }
    store_chunk(c, row, lane, base, n, won);
  }
}

// The rounds re-reading the row: round r takes the least key above the
// last winner.
template <typename Codec>
__device__ __forceinline__ void select_reread(const Codec c, const Row& row, int lane,
                                              uint64_t* won) {
  using Key = typename Codec::Key;
  Key lo = 0;
  for (int base = 0; base < row.topk; base += 32) {
    const int n = min(32, row.topk - base);
    for (int r = 0; r < n; ++r) {
      Key best = ~Key(0);
      for (int s = lane; s < row.ss; s += 32) {
        const Key k = c.key(__ldg(row.scores + s), s);
        if (k >= lo && k < best) best = k;
      }
      const Key m = warp_min(best);
      if (lane == 0) won[r] = m;
      lo = m + 1;
    }
    store_chunk(c, row, lane, base, n, won);
  }
}

// One warp per row b. NK > 0: the keys held, NK per lane; NK == 0:
// re-read. KS > 0 fixes S (the CLI's window 8: S = 17), so that the row's
// bounds, the key's shift bits and the division by S are constants.
template <int NK, int KS>
__global__ void __launch_bounds__(32 * kWarps)
    topk_kernel(const int32_t* __restrict__ map, int nb, int S_arg, int window, int topk,
                int32_t* __restrict__ out) {
  extern __shared__ uint64_t lists[];  // NK > 0: NK * 32 keys a warp
  __shared__ uint64_t won[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= nb) return;  // the whole warp leaves together
  const int S = KS > 0 ? KS : S_arg;
  const int ss = S * S;
  const int sbits = KS > 0 ? bit_width(KS * KS - 1) : bit_width(ss - 1);
  const Row row{map + (size_t)b * ss, b, nb, ss, S, window, topk, out};
  int32_t v[NK > 0 ? NK : 1];
  int32_t lo = INT_MAX, hi = INT_MIN;
  if constexpr (NK > 0) {
    const int32_t* p = row.scores + lane;
    asm("" : "+l"(p));  // one base for the loads, each at a constant offset
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      v[k] = 0;
      if (lane + 32 * k < ss) {
        v[k] = __ldg(p + 32 * k);
        lo = min(lo, v[k]);
        hi = max(hi, v[k]);
      }
    }
  } else {
    for (int s = lane; s < ss; s += 32) {
      const int32_t x = __ldg(row.scores + s);
      lo = min(lo, x);
      hi = max(hi, x);
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  // hi - lo in [0, 2^32) is exact in unsigned arithmetic
  const bool narrow = (uint32_t)hi - (uint32_t)lo <= (kFull >> sbits);
  if constexpr (NK > 0) {
    uint64_t* list = lists + (size_t)warp * NK * 32;
    if (narrow) {
      select_held(Narrow{lo, sbits}, v, row, lane, list, won[warp]);
    } else {
      select_held(Wide{}, v, row, lane, list, won[warp]);
    }
  } else {
    if (narrow) {
      select_reread(Narrow{lo, sbits}, row, lane, won[warp]);
    } else {
      select_reread(Wide{}, row, lane, won[warp]);
    }
  }
}

// Launches topk_kernel<NK, KS>, one warp per row; returns the launch's CUDA
// error.
template <int NK, int KS>
int launch_topk(const int32_t* map, int32_t* out, int nb, int S, int window, int topk,
                cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * NK * 32 * sizeof(uint64_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_kernel<NK, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  topk_kernel<NK, KS><<<(nb + kWarps - 1) / kWarps, 32 * kWarps, smem, stream>>>(
      map, nb, S, window, topk, out);
  return (int)cudaGetLastError();
}

}  // namespace

// map (nb, S*S) int32, row-major; out (3, nb, topk) int32: scores, mvx,
// mvy. The caller guarantees 1 <= topk <= S*S. Returns the CUDA error of
// the launch (0 when it was accepted).
extern "C" int me_topk_select(const int32_t* map, int32_t* out, int nb, int window,
                              int topk, cudaStream_t stream) {
  const int S = 2 * window + 1;
  const int nk = (S * S + 31) / 32;
  if (nk <= 4) return launch_topk<4, 0>(map, out, nb, S, window, topk, stream);
  if (window == 8) return launch_topk<10, 17>(map, out, nb, S, window, topk, stream);
  if (nk <= 10) return launch_topk<10, 0>(map, out, nb, S, window, topk, stream);
  if (nk <= 36) return launch_topk<36, 0>(map, out, nb, S, window, topk, stream);
  return launch_topk<0, 0>(map, out, nb, S, window, topk, stream);
}
