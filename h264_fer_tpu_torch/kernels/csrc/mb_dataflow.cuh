// One-launch dataflow schedule of a frame's macroblocks, shared by the
// persistent wavefronts K4 (csrc/wavefront_p.cu), K6
// (csrc/wavefront_mixed.cu), K4x4 (csrc/wavefront_i4x4.cu), K8
// (csrc/deblock.cu) and K1 / K1t and K7 (csrc/wavefront_i16.cu).
//
// Instead of one launch per dependency wave, one launch runs a persistent
// grid whose blocks loop:
//   1. take a ticket (atomicAdd on a counter);
//   2. map it to an MB through the order table;
//   3. issue the MB's independent loads (cp.async into shared memory);
//   4. wait for the ready flags of the neighbours in its wait set;
//   5. code the MB;
//   6. publish it: set its ready flag.
// So each MB starts as soon as its own neighbours are done, not when the
// whole previous wave is.
//
// Wait sets (the template mask of dataflow_wait) and orders
// (kernels/dataflow.py):
//   - K4, K6 and K8 wait on left, top, top-right and top-left (kAllFour)
//     and take tickets in knight order (d = c + 2r, then r). K4's MV
//     predictor and K6's Intra_4x4 prediction read the top-right MB's final
//     state. K8's top edge reads, as p samples, columns 16c+13..16c+15 of
//     rows 16r-4..16r-1, which the top-right MB's left-edge filter writes
//     and which the norm's raster order filters first.
//   - K4x4 takes tickets in knight order and waits on the same four
//     neighbours, but per 4x4-block step, not per MB: it uses steps 1-2 of
//     the loop (dataflow_next) and, in place of the ready flags, edge
//     slots that carry their samples (csrc/wavefront_i4x4.cu).
//   - K1, K1t and K7 wait on left, top and top-left (kIntraSet) and take
//     tickets in diagonal order (d = r + c, then r): Intra_16x16 and
//     chroma prediction read the top row, left column and corner, never a
//     top-right sample, so the critical path is hmb + wmb - 1 MBs (187 at
//     1080p), not the knight order's wmb + 2 hmb - 2 (254).
// A neighbour outside the frame is not waited on. The top-left flag is
// implied by left and top in both sets (the left MB waited on it); waiting
// on it costs a poll that is already set.
//
// Why it cannot deadlock: tickets are handed out in a topological order of
// the wait set, so every MB a block waits on was taken by a block that is
// already running, and the smallest unfinished ticket never waits. A grid
// of any size, even one block, finishes; no cooperative launch is needed.
//
// Memory order: the producer's threads write the MB's state, __syncthreads,
// then thread 0 sets the flag with a release store at GPU scope; a consumer
// thread polls the flag, reads it once set with an acquire load at GPU
// scope (which also drops stale lines from its SM's L1), then
// __syncthreads. State that other blocks of the same launch write must
// never be read through __ldg or a `const __restrict__` pointer (the
// read-only path keeps no coherence with those writes).
//
// Scratch (kernels/dataflow.py, zeroed by the wrapper per launch): nmb
// int32 ready flags, then the int32 ticket counter. A flag that stays unset
// (a scheduling fault) makes the waiting block trap after kSpinLimit polls
// (seconds): the launch then fails with a CUDA error, not a hang.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// neighbour bits of a wait set: bit i is neighbour i of dataflow_wait
constexpr unsigned kLeft = 1, kTop = 2, kTopRight = 4, kTopLeft = 8;
constexpr unsigned kAllFour = kLeft | kTop | kTopRight | kTopLeft;  // K4, K6, K8
constexpr unsigned kIntraSet = kLeft | kTop | kTopLeft;             // K1, K1t, K7

struct Dataflow {
  const int32_t* order;  // (nmb,) ticket → raster MB index
  int32_t* flags;        // (nmb + 1,): ready flags, then the ticket counter
  int nmb;
};

constexpr long long kSpinLimit = 1ll << 25;  // ~8 s at the 256 ns backoff cap

__device__ __forceinline__ int ld_relaxed(const int32_t* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// 16-byte asynchronous copy global → shared (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}

// 8-byte asynchronous copy global → shared (both 8-byte aligned).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(gmem)
               : "memory");
}

// Wait for every cp.async this thread issued; a __syncthreads after it
// makes the data visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Steps 1-2: the block's next MB (raster index), or -1 when every ticket is
// taken. All threads call it; s_slot is a shared int. Starts with a
// __syncthreads, so the previous MB's shared memory is free to reuse.
__device__ __forceinline__ int dataflow_next(const Dataflow& df, int* s_slot) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(df.flags + df.nmb, 1);
    *s_slot = t < df.nmb ? df.order[t] : -1;
  }
  __syncthreads();
  return *s_slot;
}

// Step 4: threads 0..3 each wait for one existing neighbour of MB (r, c)
// (left, top, top-right, top-left) that lies in the wait set `Mask`:
// relaxed polls with a growing __nanosleep between them, then one acquire
// load; then the block synchronises. All threads call it.
template <unsigned Mask = kAllFour>
__device__ __forceinline__ void dataflow_wait(const Dataflow& df, int r, int c,
                                              int wmb) {
  const int i = threadIdx.x;
  if (i < 4 && ((Mask >> i) & 1u)) {
    const int rn = i == 0 ? r : r - 1;
    const int cn = i == 0 ? c - 1 : (i == 1 ? c : (i == 2 ? c + 1 : c - 1));
    if (rn >= 0 && cn >= 0 && cn < wmb) {
      const int32_t* flag = df.flags + rn * wmb + cn;
      unsigned ns = 32;
      for (long long polls = 0; ld_relaxed(flag) == 0; ++polls) {
        if (polls == kSpinLimit) __trap();
        __nanosleep(ns);
        ns = ns < 256 ? 2 * ns : ns;
      }
      ld_acquire(flag);  // the acquire, once the flag is seen set
    }
  }
  __syncthreads();
}

// Step 6: every thread's writes of the MB's state so far become visible
// to any block that acquires its flag: the barrier orders them before
// thread 0's release store (the pattern of CUTLASS's GenericBarrier). All
// threads call it.
__device__ __forceinline__ void dataflow_publish(const Dataflow& df, int mb) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(df.flags + mb, 1);
}

// The persistent grid of `kernel` (threads per block, dynamic shared
// bytes): `blocks` when it is positive, else as many blocks as fit on the
// card at once; at most nmb. Returns 0 on a query error.
template <typename Kernel>
int dataflow_grid(Kernel kernel, int threads, size_t smem, int nmb, int blocks) {
  if (blocks <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
            cudaSuccess) {
      return 0;
    }
    blocks = per_sm * sms;
  }
  return blocks < nmb ? blocks : nmb;
}

}  // namespace
