// All-Intra_4x4 luma reconstruction wavefront (K4x4), for sm_90a.
//
// Replaces the Pallas kernel _i4_kernel_body
// (h264_fer_tpu/kernels/wavefront_pallas.py:551, called by pallas_i4x4_luma
// at :753) and the bulk level rebuild i4x4_levels_from_recon (:822): for
// every MB, in its 16 given Intra4x4 modes, each 4x4 block predicted from
// its reconstructed neighbours, transformed, quantised, dequantised and
// reconstructed, in Z-scan order; the levels are written as each block
// finishes.
//
// What bounds it on an H100: neither bytes (~2 MB of uint8 planes and 0.5 MB
// of modes in, 8.4 MB of int32 levels out per 1920x1088 frame, ~3 us at
// 3.35 TB/s) nor operations (~60 int32 operations per sample, ~10 us). The
// floor is the dependency chain: a block needs its left, top, top-left and
// top-right neighbours, so MB (r, c) waits for (r - 1, c + 1), and the
// frame's MBs form a chain of 2 * (hmb - 1) + wmb knight steps d = 2r + c
// (254 at 1080p), each at most wmb / 2 + 1 (61) MBs wide; inside an MB a
// block waits for its left, top, top-left and top-right blocks.
//
// Design: one launch per frame (csrc/mb_dataflow.cuh's persistent grid, as
// K4, K6 and K8): one-warp blocks take the MBs by ticket in knight order and
// wait on all four neighbours, left, top, top-right and top-left: Intra_4x4
// reads the top-right MB's row 15 for block 5, so the I16 wait set of K1 and
// K7 does not apply. Each block stages the Intra4x4 prediction table in
// shared memory once, not once per MB. Before any wait it copies the source
// MB into shared memory (cp.async), reads its 16 modes and works out every
// step's taps (csrc/intra4x4.cuh). It codes the MB in 10 diagonal steps
// t = i + 2j, and it waits per step, not per MB: a neighbour publishes its
// edge as each 4x4 block of it is done, and step t waits only for the edge
// samples it reads (the rules below). A knight step of the frame's chain is
// then ~4 block steps and one hop, not 10 block steps and a hop.
//
// The edge slots: each MB has 8 64-bit words in the launch's scratch, slot
// k < 4 its column 15 rows 4k..4k+3, slot 4 + k its row 15 columns
// 4k..4k+3, the 4 samples in bytes 0-3 and a 1 in the high word. A slot is
// written once, by one relaxed 64-bit store as soon as the block that
// finishes it is done (column blocks (3, j) at steps 3, 5, 7, 9, row blocks
// (i, 3) at steps 6, 7, 8, 9), and read by polling it with relaxed 64-bit
// loads until its high word is set: a 64-bit access is single-copy atomic,
// so the samples come with their flag and no fence, acquire or second load
// is needed (a release store cost the producer ~850 cycles per publish in
// this kernel's one-flag form). Before step t MB (r, c) reads, by the
// _fetch_p13 rules (csrc/intra4x4.cuh):
//   t = 0: left slot 0, top slots 4 and 5 (the top row and the above-right
//          samples of block 0), top-left slot 7 (its sample (15, 15));
//   t = 1: top slot 6;  t = 2: left slot 1, top slot 7;
//   t = 3: top-right slot 4 (block 5's above-right samples);
//   t = 4: left slot 2;  t = 6: left slot 3.
// A neighbour outside the frame is not read: its cells stay -1. The
// reconstruction itself is written to yrec once the MB is done; no MB of
// the launch reads yrec. Tickets in knight order are topological for these
// waits, so any grid size finishes (the argument of csrc/mb_dataflow.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "intra4x4.cuh"
#include "mb_dataflow.cuh"

namespace {

// The frame's arrays.
struct Frame4 {
  const uint8_t* ysrc;    // (H, W)
  const int32_t* modes;   // (nmb, 16) Z-scan
  const int32_t* pred4;   // the Intra4x4 prediction table
  uint8_t* yrec;          // (H, W) out
  int32_t* levels;        // (nmb, 16, 16) out
  unsigned long long* slots;  // (nmb, 8) edge slots, zeroed
  int wmb, qp;
  QpTab tab;
};

__device__ __forceinline__ unsigned long long ld_relaxed64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The neighbour slots an MB reads, one per lane 0..9: the neighbour (0
// left, 1 top, 2 top-right, 3 top-left), its slot, the step that first
// reads it, and the first cell it fills (column 0 from the left MB, row 0
// from the top and top-right MBs, the corner from the top-left MB's byte 3).
constexpr int kReads = 10;
__constant__ int kFrom[kReads] = {0, 1, 1, 3, 1, 0, 1, 2, 0, 0};
__constant__ int kSlot[kReads] = {0, 4, 5, 7, 6, 1, 7, 4, 2, 3};
__constant__ int kNeed[kReads] = {0, 0, 0, 0, 1, 2, 2, 3, 4, 6};
__constant__ int kCell[kReads] = {1, 1, 5, 0, 9, 5, 13, 17, 9, 13};

// The step hook of i4x4_mb (csrc/intra4x4.cuh) that brings in the
// neighbour samples each step reads and publishes the MB's own edge slots
// as its blocks finish. Lane k < kReads keeps one neighbour slot (`mine`,
// null where that neighbour is outside the frame). Before a step that
// reads a slot not yet in, the lanes whose slots that step needs poll them
// until set, all together, and in the same round every lane whose slot a
// later step needs looks once: what is already set comes in without a
// round trip of its own later.
struct EdgeHook {
  static constexpr bool kActive = true;
  I4Scratch* sc;
  unsigned long long* own;
  const unsigned long long* mine;
  int need, lane;
  mutable bool got;

  __device__ __forceinline__ void take(unsigned long long v) const {
    const int k = lane, c0 = kCell[k];
    if (kFrom[k] == 3) {
      sc->ext[0][0] = (int)((v >> 24) & 0xffu);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = (int)((v >> (8 * i)) & 0xffu);
        if (kFrom[k] == 0) {
          sc->ext[c0 + i][0] = b;
        } else {
          sc->ext[0][c0 + i] = b;
        }
      }
    }
    got = true;
  }

  __device__ __forceinline__ void before(int t) const {
    if (t == 5 || t > 6) return;  // steps that read no new neighbour slot
    bool wait = mine != nullptr && !got && need <= t;
    if (!__any_sync(kFull, wait)) return;
    if (mine != nullptr && !got && need > t) {  // a later step's slot, once
      const unsigned long long v = ld_relaxed64(mine);
      if (v >> 32) take(v);
    }
    for (long long polls = 0; __any_sync(kFull, wait); ++polls) {
      if (wait) {  // no __nanosleep: a poll is a round trip to L2 already
        const unsigned long long v = ld_relaxed64(mine);
        if (v >> 32) {
          take(v);
          wait = false;
        } else if (polls == kSpinLimit) {
          __trap();
        }
      }
    }
    __syncwarp();
  }

  // lane `who` publishes slot k of this MB from sc.ext
  __device__ __forceinline__ void publish(int who, int k) const {
    if (lane != who) return;
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = k < 4 ? sc->ext[1 + 4 * k + i][16] : sc->ext[16][1 + 4 * (k - 4) + i];
      v |= (uint32_t)b << (8 * i);
    }
    st_relaxed64(own + k, 1ull << 32 | v);
  }

  __device__ __forceinline__ void after(int t) const {
    if (t == 3) publish(0, 0);
    if (t == 5) publish(0, 1);
    if (t == 6) publish(0, 4);
    if (t == 7) {
      publish(0, 2);
      publish(1, 5);
    }
    if (t == 8) publish(0, 6);
    if (t == 9) {
      publish(0, 3);
      publish(1, 7);
    }
  }
};

__global__ void __launch_bounds__(32) i4x4_kernel(Frame4 f, Dataflow df) {
  const int lane = threadIdx.x;
  const int W = f.wmb * 16;
  __shared__ int s_mb;
  __shared__ __align__(16) uint8_t s_src[256];
  __shared__ int m4[16];
  __shared__ MbNbr nb;      // only nb.tr_ok is read (the hook brings the samples)
  __shared__ I4Scratch sc;  // the reconstruction and the prediction table
  load_pred_table(sc, f.pred4, lane, 32);  // once per block

  for (;;) {
    const int mb = dataflow_next(df, &s_mb);
    if (mb < 0) return;
    const int r = mb / f.wmb, c = mb - r * f.wmb;
    const int x0 = 16 * c, y0 = 16 * r;
    if (lane < 16) {
      cp_async16(s_src + 16 * lane, f.ysrc + (size_t)(y0 + lane) * W + x0);
      m4[lane] = __ldg(f.modes + 16 * mb + lane);
    }
    for (int i = lane; i < 37; i += 32) {  // every neighbour sample unavailable
      if (i < 21) {
        sc.ext[0][i] = -1;
      } else {
        sc.ext[i - 20][0] = -1;
      }
    }
    const bool left_ok = c > 0, top_ok = r > 0, tr_ok = top_ok && c + 1 < f.wmb;
    if (lane == 0) nb.tr_ok = tr_ok;
    cp_async_wait_all();
    __syncwarp();
    unsigned long long* own = f.slots + 8 * (size_t)mb;
    const unsigned long long* mine = nullptr;  // this lane's neighbour slot
    if (lane < kReads) {
      const int from = kFrom[lane];
      const bool ok = from == 0 ? left_ok : from == 1 ? top_ok : from == 2 ? tr_ok
                                                                            : left_ok && top_ok;
      const int dmb = from == 0 ? -1 : from == 1 ? -f.wmb : from == 2 ? 1 - f.wmb : -1 - f.wmb;
      if (ok) mine = own + 8 * dmb + kSlot[lane];
    }
    const EdgeHook hook{&sc, own, mine, lane < kReads ? kNeed[lane] : 0, lane, false};
    i4x4_mb(s_src, m4, nb, f.qp, f.tab, f.levels + 256 * mb, sc, lane, hook);
    {  // the reconstruction: row lane / 2, samples 8 (lane & 1) .. + 7
      const int y = lane >> 1, x = 8 * (lane & 1);
      const int* e = &sc.ext[1 + y][1 + x];
      const uint2 v = make_uint2(
          (uint32_t)e[0] | (uint32_t)e[1] << 8 | (uint32_t)e[2] << 16 | (uint32_t)e[3] << 24,
          (uint32_t)e[4] | (uint32_t)e[5] << 8 | (uint32_t)e[6] << 16 | (uint32_t)e[7] << 24);
      *reinterpret_cast<uint2*>(f.yrec + (size_t)(y0 + y) * W + x0 + x) = v;
    }
  }
}

}  // namespace

// Reconstructs an all-Intra_4x4 frame in one launch on `stream`: a
// persistent grid of `blocks` one-warp blocks (0: as many as fit on the
// card; at most nmb) taking the MBs in the knight order `order` (nmb,).
// `scratch`, zeroed and 8-byte aligned, holds the edge slots (nmb x 8
// uint64) and then the dataflow scratch (nmb + 1 int32, of which only the
// ticket counter is used), so that one fill clears both. ysrc (H, W)
// uint8, 16-byte aligned; modes (nmb, 16) Z-scan; pred4 the Intra4x4
// prediction table (ops/intra.packed_mode_table); yrec (H, W) uint8 out;
// levels (nmb, 16, 16) zig-zag lists out. qtab: 6 ints, LEVEL_QUANTIZE / LEVEL_SCALE of qp
// in the order of QpTab. *launched gets 1 when the launch was accepted.
// Returns its CUDA error (0 when accepted).
extern "C" int wavefront_i4x4_frame(const uint8_t* ysrc, const int32_t* modes,
                                    const int32_t* pred4, uint8_t* yrec,
                                    int32_t* levels, unsigned long long* scratch,
                                    const int32_t* order, int wmb, int hmb, int qp,
                                    const int* qtab, int blocks, cudaStream_t stream,
                                    int* launched) {
  *launched = 0;
  Frame4 f{ysrc, modes, pred4, yrec, levels, scratch, wmb, qp, {}};
  for (int i = 0; i < 3; ++i) {
    f.tab.lq[i] = qtab[i];
    f.tab.ls[i] = qtab[3 + i];
  }
  const Dataflow df{order, reinterpret_cast<int32_t*>(scratch + 8 * (size_t)wmb * hmb),
                    wmb * hmb};
  const int grid = dataflow_grid(i4x4_kernel, 32, 0, wmb * hmb, blocks);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  i4x4_kernel<<<grid, 32, 0, stream>>>(f, df);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
