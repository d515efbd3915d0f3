// Whole-slice CAVLC (K10): every macroblock_layer symbol of an all-I16,
// mixed I4x4/I16 or P slice (or MB-row band), packed MSB-first into int64
// words, for sm_90a; and the chroma setup alone.
//
// The device form of the XLA programs h264_fer_tpu/codec/tpu_entropy.py
// i16_slice_entropy_impl (:433), mixed_slice_entropy_impl (:185),
// p_slice_entropy_impl (:298) and chroma_setup (:153), over
// ops/cavlc_jax.py block_symbols_bulk (:82), finalize_symbols (:243) and
// pack_symbols (:271); no Pallas kernel replaced them. Its plain twins are
// codec/entropy.py's *_plain functions, which it equals word for word.
//
// What bounds it on an H100: bytes. A 1920x1088 slice reads 12-21 MB of
// int32 levels and writes well under 1 MB of words (~0.004-0.006 ms at
// 3.35 TB/s); the arithmetic is ~25 int32 operations per nonzero level.
// What stands between the two is the chain: an MB's size needs its left
// and top neighbours' final TotalCoeffs, and its bit offset every earlier
// MB's size. The design reads each level from device memory once, in one
// launch, and carries the offsets through a single-pass scan.
//
// Design: one launch a slice or band (and one a chroma setup), a persistent
// grid whose blocks take tickets of kMbs consecutive MBs in raster order
// (atomicAdd on a counter in the zeroed workspace). A warp codes one MB, a
// lane per block list (lane 0 the MB header, lane 1 the Intra16x16 DC
// block, lanes 2-17 the 16 luma blocks in Z-scan order, 18-19 the chroma
// DC blocks, 20-27 the chroma AC blocks of Cb then Cr: the lanes' order is
// the stream's). Per ticket:
//   1. stage: each warp copies its MB's lists into shared memory, one
//      cp.async of 4 bytes a lane, neighbouring lanes on neighbouring
//      words (the mixed form only the winner's luma lists and the chroma
//      lists the chroma setup codes); every later step reads that copy;
//   2. state: each list's nonzero mask and TotalCoeff; the MB's CBP,
//      mb_type, final TotalCoeffs and nonzero flags, stored; the block
//      publishes its ticket's state flag (a barrier, then st.release.gpu);
//   3. wait: for the flags of the tickets holding the first MB's left
//      neighbour and the MBs' top neighbours (ld.acquire.gpu); a band's
//      first row reads the halo row (top_ctx) instead. The mixed form's
//      state is its input (K6's and the chroma setup's), so it waits on
//      nothing. Raster tickets are topological for {left, top}, and a
//      ticket's state needs no wait, so no block waits on a ticket that
//      cannot finish: any grid, even of one block, completes;
//   4. size: each lane counts its list (its nC context from the final
//      state) and keeps the count and context in registers; the warp sums
//      them to the MB's bits (0 at an invalid or skipped MB);
//   5. offsets: a decoupled look-back (Merrill & Garland, "Single-pass
//      Parallel Prefix Scan with Decoupled Look-back", 2016). The ticket's
//      aggregate goes to the workspace; then each thread of the block reads
//      one of the kThreads tickets before it (one round of loads; the
//      descriptors carry their own written tags, so no flag stands between),
//      and the block combines the aggregates back to the nearest inclusive
//      prefix, window by window, and publishes its own inclusive prefix.
//      The element is (bits, first coded MB, last coded MB); combining L
//      then R adds ue_bits(R.first - L.last - 1), P's mb_skip_run between
//      them, when L has a coded MB and R has one, which is associative. The
//      run before the slice's first coded MB (which counts the skips before
//      a band too: run_lead) is added where an offset or the total is read.
//      The ticket holding the last MB writes nbits, trail_bits and a whole
//      P slice's trailing mb_skip_run;
//   6. write: each lane places its list after the lanes before it (a warp
//      scan of the kept counts, the header's now with its run) and writes
//      its symbols. A symbol adds its bits to its one or two words, as
//      pack_symbols' index_add_ does; symbols whose values fit their
//      lengths are joined first (JoinWriter); a lane keeps its current word
//      in a register, stores the words wholly inside its span and adds its
//      first and last words atomically (64-bit atomicAdd) into the zeroed
//      words, where the neighbouring spans add theirs.
// The chroma setup is its own kernel (chroma_kernel): steps 1-4 over the
// chroma lists, two MBs a warp, its bits per MB the output.
//
// Before the launch the entry point zeroes the words, the flags and the
// descriptors with one cudaMemsetAsync; a call is that fill and one launch.
//
// Integers only; arithmetic shifts on signed values; int64 offsets. The
// length and code tables (kernels/cavlc_slice.TABLES, csrc/cavlc.cuh
// offsets) are copied to shared memory once per block. run_lead and the
// halo are device tensors, read on the card. State that other blocks of the
// launch write (the MB state, the flags, the look-back descriptors) is
// never read through __ldg or a const __restrict__ pointer.

#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

#include "cavlc.cuh"
#include "mb_dataflow.cuh"

namespace {

using namespace cavlc;

enum Form : int { kI16 = 0, kMixed = 1, kP = 2, kChroma = 3 };

constexpr int kMbs = 8;  // MBs a ticket: a warp each
constexpr int kThreads = 32 * kMbs;
constexpr int kLanes = 28;  // the header and the 27 block lists
constexpr int kRow = 16;    // ints a staged list

// The entry point's arguments (kernels/cavlc_slice.ARGS, in this order),
// one 8-byte slot each; null where a form has none.
struct Args {
  const int32_t* mode16;       // (nmb,) I16, mixed
  const int32_t* cmode;        // (nmb,) I16, mixed
  const int32_t* i16dc;        // (nmb, 16) I16, mixed
  const int32_t* i16ac;        // (nmb, 16, 15) I16, mixed
  const bool* choice4;         // (nmb,) mixed
  const int32_t* lv4;          // (nmb, 16, 16) mixed
  const bool* prev_flags;      // (nmb, 16) mixed
  const int32_t* rem_modes;    // (nmb, 16) mixed
  const bool* skip;            // (nmb,) P
  const int32_t* ptype;        // (nmb,) P: the raw inter mb_type 0..4
  const int32_t* mvd;          // (nmb, 4, 2) P
  const int32_t* luma;         // (nmb, 16, 16) P
  const int32_t* cdc;          // (2, nmb, 4)
  const int32_t* cac;          // (2, nmb, 4, 15)
  const bool* valid;           // (nmb,), null: every MB (I16, mixed)
  const int32_t* top_tc_luma;  // the halo row above a band, or null:
  const int32_t* top_cbp_luma;    //   (wmb, 16), (wmb,),
  const int32_t* top_tc_chroma;   //   (2, wmb, 4),
  const int32_t* top_cbp_chroma;  //   (wmb,)
  const int64_t* run_lead;     // P band: a device scalar, or null
  int64_t run_lead_value;      // P band: run_lead when it is a host int
  const int32_t* tabs;         // the table buffer (cavlc.cuh offsets)
  // the MB state step 2 writes and steps 4 and 6 read (mixed: cbp_luma,
  // tc_luma and the chroma state are the inputs)
  int32_t* mb_type;            // (nmb,) I16, mixed
  int32_t* cbp_luma;           // (nmb,)
  int32_t* tc_luma;            // (nmb, 16)
  int32_t* cbp_chroma;         // (nmb,)
  int32_t* tc_chroma;          // (2, nmb, 4)
  bool* nz_luma;               // (nmb, 16) mixed, P
  int32_t* mb_bits;            // (nmb,) the chroma setup's bits
  int64_t* nbits;              // () the payload's bits
  int32_t* trail_bits;         // () P: the trailing mb_skip_run's bits
  unsigned long long* words;   // (nwords,) zeroed
  int64_t nwords;
  int32_t* sync;               // zeroed: the ticket counter, then per ticket
                               //   its state flag
  unsigned long long* desc;    // zeroed (tickets, 2, 2): aggregate, inclusive
                               //   prefix, tagged (step 5)
  void* zeroed;                // the workspace that holds words, nbits, desc
  int64_t zeroed_bytes;        //   and sync, zeroed here before the launch
  int64_t wmb, nmb, band;      // band: 1 for a P band (no trailing run)
};
constexpr int kArgs = 40;
static_assert(sizeof(Args) == 8 * kArgs, "one 8-byte slot an argument");

// ---- the MB's lists ---------------------------------------------------

// Length (maxNumCoeff) of lane `lane`'s list; i16: its luma lists are
// Intra16x16 AC lists.
__device__ __forceinline__ int list_len(int lane, bool i16) {
  if (lane == 1) return 16;
  if (lane < 18) return i16 ? 15 : 16;
  return lane < 20 ? 4 : 15;
}

// 4-byte asynchronous copy global → shared.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}

// kCount lists of kLen ints, contiguous at src, into rows[0..kCount) by the
// warp's lanes, lane l taking words l, l + 32, ...
template <int kLen, int kCount>
__device__ __forceinline__ void stage_lists(const int32_t* src, int (*rows)[kRow], int lane) {
#pragma unroll
  for (int g = lane; g < kLen * kCount; g += 32) cp_async4(&rows[g / kLen][g % kLen], src + g);
}

// Step 1: MB mb's lists of form F into rows (the warp's); the mixed form
// the winner's luma lists and the chroma lists that cbp_c codes. Row 0, the
// header's, gets what the header writes per block: an Intra4x4 MB's 16
// rem_modes (and *pf, the prev_flags as a mask, in every lane), a P MB's 8
// mvd components. Returns whether lane `lane` holds a staged list.
template <int F>
__device__ __forceinline__ bool stage_mb(const Args& s, int mb, bool i4, int cbp_c,
                                         int (*rows)[kRow], int lane, unsigned* pf) {
  const int nmb = (int)s.nmb;
  if (F == kMixed && i4) {
    if (lane < 16) cp_async4(&rows[0][lane], s.rem_modes + 16 * mb + lane);
    *pf = __ballot_sync(kAll, lane < 16 && s.prev_flags[16 * mb + lane]);
  }
  if (F == kP && lane < 8) cp_async4(&rows[0][lane], s.mvd + 8 * mb + lane);
  if (F == kI16 || (F == kMixed && !i4)) {
    stage_lists<16, 1>(s.i16dc + 16 * mb, rows + 1, lane);
    stage_lists<15, 16>(s.i16ac + 240 * mb, rows + 2, lane);
  } else if (F == kMixed || F == kP) {
    stage_lists<16, 16>((F == kP ? s.luma : s.lv4) + 256 * mb, rows + 2, lane);
  }
  const bool dc = F != kMixed || cbp_c > 0, ac = F != kMixed || cbp_c == 2;
  for (int p = 0; p < 2; ++p) {
    if (dc) stage_lists<4, 1>(s.cdc + 4 * (p * nmb + mb), rows + 18 + p, lane);
    if (ac) stage_lists<15, 4>(s.cac + 60 * (p * nmb + mb), rows + 20 + 4 * p, lane);
  }
  cp_async_wait_all();
  __syncwarp();
  if (lane == 0 || lane >= kLanes) return false;
  if (lane == 1) return F == kI16 || (F == kMixed && !i4);
  if (lane < 18) return true;
  return lane < 20 ? dc : ac;
}

// ---- step 2: the MB state ---------------------------------------------
// nz: lane `lane`'s nonzero mask (0 for a lane without a staged list).
template <int F>
__device__ __forceinline__ void mb_state(const Args& s, int mb, bool i4, unsigned nz,
                                         int lane) {
  const int nmb = (int)s.nmb;
  const int tc = __popc(nz);
  int cbp_c;
  if (F == kMixed) {
    cbp_c = s.cbp_chroma[mb];
  } else {
    const bool has_cac = __any_sync(kAll, lane >= 20 && nz);
    const bool has_cdc = __any_sync(kAll, (lane == 18 || lane == 19) && nz);
    cbp_c = has_cac ? 2 : (has_cdc ? 1 : 0);
    if (lane >= 20 && lane < kLanes) {
      const int ci = (lane - 20) >> 2, b = (lane - 20) & 3;
      s.tc_chroma[4 * (ci * nmb + mb) + b] = cbp_c == 2 ? tc : 0;
    }
    if (lane == 0) s.cbp_chroma[mb] = cbp_c;
  }
  const bool luma_lane = lane >= 2 && lane < 18;
  const int z = lane - 2;
  if (F == kI16) {
    const int cbp_l = __any_sync(kAll, luma_lane && nz) ? 15 : 0;
    const int dc_tc = __shfl_sync(kAll, tc, 1);
    // an MB without AC keeps its DC block's TotalCoeff in slot 0
    if (luma_lane) s.tc_luma[16 * mb + z] = cbp_l == 15 ? tc : (z == 0 ? dc_tc : 0);
    if (lane == 0) {
      s.cbp_luma[mb] = cbp_l;
      s.mb_type[mb] = 1 + s.mode16[mb] + 4 * cbp_c + (cbp_l == 15 ? 12 : 0);
    }
  } else if (F == kP) {
    const unsigned quads = __ballot_sync(kAll, luma_lane && nz);
    const int cbp_l = ((quads >> 2) & 0xF ? 1 : 0) | ((quads >> 6) & 0xF ? 2 : 0) |
                      ((quads >> 10) & 0xF ? 4 : 0) | ((quads >> 14) & 0xF ? 8 : 0);
    if (luma_lane) {
      s.tc_luma[16 * mb + z] = gate(tc, cbp_l, z);
      s.nz_luma[16 * mb + z] = nz != 0;
    }
    if (lane == 0) s.cbp_luma[mb] = cbp_l;
  } else {  // kMixed
    const bool dc_any = __shfl_sync(kAll, nz, 1) != 0;
    if (luma_lane) s.nz_luma[16 * mb + z] = nz != 0 || (!i4 && dc_any);
    if (lane == 0) {
      s.mb_type[mb] = i4 ? 0
                         : 1 + s.mode16[mb] + 4 * cbp_c + (s.cbp_luma[mb] == 15 ? 12 : 0);
    }
  }
}

// ---- step 3: the neighbours' state --------------------------------------

// Spins on a state flag until it is set: acquire loads, a growing
// __nanosleep between them (mostly the first load finds it set). Traps
// after kSpinLimit polls (a scheduling fault fails the launch, not hangs).
__device__ __forceinline__ void wait_flag(const int32_t* flag) {
  unsigned ns = 32;
  for (long long polls = 0; ld_acquire(flag) == 0; ++polls) {
    if (polls == kSpinLimit) __trap();
    __nanosleep(ns);
    ns = ns < 256 ? 2 * ns : ns;
  }
}

// Threads 0-2 wait for the state flags of the tickets (of M MBs) holding
// the left neighbour of the ticket's first MB and the top neighbours of its
// MBs [mb0, mb0 + cnt) (other than ticket t itself); then the block
// synchronises. All threads call it.
template <int M>
__device__ __forceinline__ void wait_neighbours(const int32_t* ready, int t, int mb0, int cnt,
                                                int wmb) {
  const int i = threadIdx.x, last = mb0 + cnt - 1;
  int tk = -1;
  if (i == 0 && mb0 % wmb != 0) tk = t - 1;
  if ((i == 1 || i == 2) && last >= wmb) tk = ((i == 1 ? max(mb0, wmb) : last) - wmb) / M;
  if (tk >= 0 && tk != t) wait_flag(ready + tk);
  __syncthreads();
}

// ---- step 4: sizes ------------------------------------------------------

// nC context of luma block z of MB (r, c) from the final state.
__device__ __forceinline__ int luma_ctx(const Args& s, int mb, int r, int c, int z) {
  const int wmb = (int)s.wmb;
  bool a_same, b_same;
  int a_blk, b_blk;
  luma_nbr(z, &a_same, &a_blk, &b_same, &b_blk);
  const bool halo = r == 0 && s.top_tc_luma != nullptr;
  int nA = 0, nB = 0;
  if (a_same) {
    nA = gate(s.tc_luma[16 * mb + a_blk], s.cbp_luma[mb], a_blk);
  } else if (c > 0) {
    nA = gate(s.tc_luma[16 * (mb - 1) + a_blk], s.cbp_luma[mb - 1], a_blk);
  }
  if (b_same) {
    nB = gate(s.tc_luma[16 * mb + b_blk], s.cbp_luma[mb], b_blk);
  } else if (r > 0) {
    nB = gate(s.tc_luma[16 * (mb - wmb) + b_blk], s.cbp_luma[mb - wmb], b_blk);
  } else if (halo) {
    nB = gate(s.top_tc_luma[16 * c + b_blk], s.top_cbp_luma[c], b_blk);
  }
  return nc_ctx(nA, nB, a_same || c > 0, b_same || r > 0 || halo);
}

// nC context of chroma AC block b of plane ci of MB (r, c).
__device__ __forceinline__ int chroma_ctx(const Args& s, int mb, int r, int c, int ci,
                                          int b) {
  const int wmb = (int)s.wmb;
  bool a_same, b_same;
  int a_blk, b_blk;
  chroma_nbr(b, &a_same, &a_blk, &b_same, &b_blk);
  const bool halo = r == 0 && s.top_tc_chroma != nullptr;
  const int32_t* tc = s.tc_chroma + 4 * ci * (int)s.nmb;
  int nA = 0, nB = 0;
  if (a_same) {
    nA = (s.cbp_chroma[mb] & 2) ? tc[4 * mb + a_blk] : 0;
  } else if (c > 0) {
    nA = (s.cbp_chroma[mb - 1] & 2) ? tc[4 * (mb - 1) + a_blk] : 0;
  }
  if (b_same) {
    nB = (s.cbp_chroma[mb] & 2) ? tc[4 * mb + b_blk] : 0;
  } else if (r > 0) {
    nB = (s.cbp_chroma[mb - wmb] & 2) ? tc[4 * (mb - wmb) + b_blk] : 0;
  } else if (halo) {
    nB = (s.top_cbp_chroma[c] & 2) ? s.top_tc_chroma[4 * (ci * wmb + c) + b_blk] : 0;
  }
  return nc_ctx(nA, nB, a_same || c > 0, b_same || r > 0 || halo);
}

// The coeff_token context of lane `lane`'s list (0..3 from nC; 4: chroma DC).
__device__ __forceinline__ int list_ctx(const Args& s, int mb, int lane) {
  const int r = mb / (int)s.wmb, c = mb - r * (int)s.wmb;
  if (lane < 18) return luma_ctx(s, mb, r, c, lane == 1 ? 0 : lane - 2);  // DC: block 0's nC
  if (lane < 20) return 4;
  return chroma_ctx(s, mb, r, c, (lane - 20) >> 2, (lane - 20) & 3);
}

// Is lane `lane`'s list coded in its MB (its CBP gate)?
template <int F>
__device__ __forceinline__ bool coded(const Args& s, int mb, int lane, bool i4) {
  if (lane == 0 || lane >= kLanes) return false;
  if (lane == 1) return F != kP && !i4;  // I16: always; mixed: an Intra16x16 MB
  if (lane < 18) return (s.cbp_luma[mb] >> ((lane - 2) >> 2)) & 1;
  return lane < 20 ? s.cbp_chroma[mb] > 0 : s.cbp_chroma[mb] == 2;
}

// The symbols of a list (coded<F>) to sink: its coeff_token, then
// block_rest. row: the staged list of n levels, nz its nonzero mask.
template <class Sink>
__device__ __forceinline__ void code_list(const int* tabs, int ctx, const int* row, int n,
                                          unsigned nz, Sink& sink) {
  const int ti = (ctx * 17 + __popc(nz)) * 4 + trailing_ones(row, nz);
  emit(sink, tabs[kCtLen + ti], [&] { return tabs[kCtBits + ti]; });
  block_rest(row, n, nz, tabs, sink);
}

// The MB header (lane 0) to sink. run: P's mb_skip_run, written when
// with_run; hdr, pf: row 0 and the prev_flags mask (stage_mb).
template <int F, class Sink>
__device__ __forceinline__ void code_header(const Args& s, const int* tabs, int mb, int run,
                                            bool with_run, const int* hdr, unsigned pf,
                                            Sink& sink) {
  const int cbp_l = s.cbp_luma[mb], cbp_c = s.cbp_chroma[mb];
  if (F == kI16) {
    const int t = s.mb_type[mb], cm = s.cmode[mb];
    emit(sink, ue_bits(t), [&] { return t + 1; });
    emit(sink, ue_bits(cm), [&] { return cm + 1; });
    emit(sink, 1, [&] { return 1; });  // mb_qp_delta se(0)
  } else if (F == kMixed) {
    const bool i4 = s.choice4[mb];
    const int t = s.mb_type[mb], cm = s.cmode[mb];
    emit(sink, ue_bits(t), [&] { return t + 1; });
    if (i4) {  // the 16 prediction modes: flag 1, or flag 0 and rem_mode
      for (int z = 0; z < 16; ++z) {
        const bool flag = (pf >> z) & 1;
        emit(sink, flag ? 1 : 4, [&] { return flag ? 1 : hdr[z]; });
      }
    }
    emit(sink, ue_bits(cm), [&] { return cm + 1; });
    if (i4) {
      const int code = tabs[kCbpIntra + ((cbp_c << 4) | cbp_l)];
      emit(sink, ue_bits(code), [&] { return code + 1; });
    }
    if (!i4 || cbp_l > 0 || cbp_c > 0) emit(sink, 1, [&] { return 1; });
  } else if (F == kP) {
    if (with_run) emit(sink, ue_bits(run), [&] { return run + 1; });
    const int t = s.ptype[mb];
    emit(sink, ue_bits(t), [&] { return t + 1; });
    if (t >= 3) {
      for (int k = 0; k < 4; ++k) emit(sink, 1, [&] { return 1; });  // sub_mb_type 0
    }
    const int nparts = t <= 0 ? 1 : (t <= 2 ? 2 : 4);
    for (int k = 0; k < 2 * nparts; ++k) {
      const int code = se_num(hdr[k]);
      emit(sink, ue_bits(code), [&] { return code + 1; });
    }
    const int code = tabs[kCbpInter + ((cbp_c << 4) | cbp_l)];
    emit(sink, ue_bits(code), [&] { return code + 1; });
    if (cbp_l > 0 || cbp_c > 0) emit(sink, 1, [&] { return 1; });
  }
}

// Is MB mb written at all: a valid MB (I16, mixed), a coded one (P)?
template <int F>
__device__ __forceinline__ bool mb_written(const Args& s, int mb) {
  if (F == kP) return !s.skip[mb];
  return s.valid == nullptr || s.valid[mb];
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// ---- the words ----------------------------------------------------------

// One symbol of len bits at bit offset off, added into the words.
struct Writer {
  static constexpr bool kWrite = true;
  unsigned long long* words;
  int64_t nwords, w;
  unsigned long long acc;
  int pos;     // bits of word w before the next symbol
  bool first;  // word w is the span's first: other spans may add to it

  __device__ Writer(unsigned long long* words_, int64_t nwords_, int64_t off)
      : words(words_), nwords(nwords_), w(off >> 6), acc(0), pos((int)(off & 63)),
        first(true) {}

  __device__ void store(bool shared) {
    if (w >= nwords) return;  // past the buffer: nothing the payload holds
    if (shared) {
      atomicAdd(words + w, acc);
    } else {
      words[w] = acc;
    }
  }

  // pack_symbols' placement: the value, sign-extended to 64 bits, shifted
  // to end at bit pos + len of the word, its low bits carried into the
  // next word where it does not fit; the parts are added.
  __device__ void put(int val, int len) {
    if (len > 0) put64((unsigned long long)(long long)val, len);
  }

  // The same for a 64-bit value of len (1..64) bits.
  __device__ void put64(unsigned long long v, int len) {
    const int sh = 64 - pos - len;
    if (sh >= 0) {
      acc += v << sh;
      pos += len;
      if (pos < 64) return;
      store(first);
      acc = 0;
      pos = 0;
    } else {
      acc += v >> -sh;
      store(first);
      acc = v << (64 + sh);
      pos = -sh;
    }
    first = false;
    ++w;
  }

  // The span's last word, which the next span may share.
  __device__ void finish() {
    if (pos > 0) store(true);
  }
};

// A Writer that joins consecutive symbols whose values fit their lengths
// (value < 2^len) into one value of up to 64 bits before placing it: such
// symbols share no bit, so their join adds the same bits to the same words
// as they do one by one. A value wider than its length (which pack_symbols
// adds into the bits before it) goes to the Writer alone, in its turn.
struct JoinWriter {
  static constexpr bool kWrite = true;
  Writer out;
  unsigned long long pend = 0;  // the joined symbols, right-aligned
  int plen = 0;                 // their bits

  __device__ JoinWriter(unsigned long long* words, int64_t nwords, int64_t off)
      : out(words, nwords, off) {}

  __device__ void flush() {
    if (plen > 0) out.put64(pend, plen);
    pend = 0;
    plen = 0;
  }

  __device__ void put(int val, int len) {
    if (len <= 0) return;
    if (len < 32 && (unsigned)val < (1u << len)) {
      if (plen + len > 64) flush();
      pend = (pend << len) | (unsigned)val;
      plen += len;
    } else {
      flush();
      out.put(val, len);
    }
  }

  __device__ void finish() {
    flush();
    out.finish();
  }
};

// ---- step 5: the offsets --------------------------------------------------

// A run of the slice's MBs in the scan: its bits (the mb_skip_runs between
// its coded MBs included), its first and last coded MB (-1: none).
struct Agg {
  long long bits;
  int first, last;
};

__device__ __forceinline__ Agg agg_none() { return {0, -1, -1}; }

// L then R: the mb_skip_run before R's first coded MB enters when L has a
// coded MB. The run before the slice's first coded MB, which counts the
// skips before a band too (run_lead), is added by the caller (lead_bits).
__device__ __forceinline__ Agg combine(const Agg& l, const Agg& r) {
  Agg o;
  o.bits = l.bits + r.bits;
  if (l.last >= 0 && r.first >= 0) o.bits += ue_bits(r.first - l.last - 1);
  o.first = l.first >= 0 ? l.first : r.first;
  o.last = r.last >= 0 ? r.last : l.last;
  return o;
}

__device__ __forceinline__ Agg shfl_down_agg(const Agg& a, int o) {
  return {__shfl_down_sync(kAll, a.bits, o), __shfl_down_sync(kAll, a.first, o),
          __shfl_down_sync(kAll, a.last, o)};
}

// A ticket's descriptor is four 64-bit words: its aggregate, then its
// inclusive prefix, each as (bits, first + 1 | (last + 1) << 31), every
// word with bit 63 set when written. Each word is written once, from 0, so
// a reader that sees both words of a pair tagged has the pair: one round
// of relaxed loads reads a ticket's state, no flag and acquire between.
constexpr unsigned long long kTag = 1ull << 63;

__device__ __forceinline__ unsigned long long ld_relaxed64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Writes pair k (0: aggregate, 1: inclusive prefix) of ticket t.
__device__ __forceinline__ void put_desc(unsigned long long* desc, int t, int k,
                                         const Agg& a) {
  unsigned long long* d = desc + 4 * t + 2 * k;
  st_relaxed64(d, kTag | (unsigned long long)a.bits);
  st_relaxed64(d + 1, kTag | (unsigned long long)(a.first + 1) |
                          ((unsigned long long)(a.last + 1) << 31));
}

// Ticket j's state: 2 and its inclusive prefix, 1 and its aggregate, or 0.
__device__ __forceinline__ int get_desc(const unsigned long long* desc, int j, Agg* out) {
  const unsigned long long* d = desc + 4 * j;
  const unsigned long long a0 = ld_relaxed64(d), a1 = ld_relaxed64(d + 1);
  const unsigned long long i0 = ld_relaxed64(d + 2), i1 = ld_relaxed64(d + 3);
  const int k = (i0 & i1 & kTag) ? 2 : ((a0 & a1 & kTag) ? 1 : 0);
  const unsigned long long w0 = k == 2 ? i0 : a0, w1 = k == 2 ? i1 : a1;
  *out = {(long long)(w0 & ~kTag), (int)(w1 & 0x7fffffff) - 1,
          (int)((w1 >> 31) & 0x7fffffff) - 1};
  return k;
}

// The exclusive prefix of ticket t, in thread 0 (every thread calls it):
// thread i reads ticket end - i, window by window back from t - 1 (a window
// of kThreads tickets), until a window holds an inclusive prefix; before
// ticket 0 lies the empty prefix. Each window: a round of loads, repeated
// (after a short sleep) for the tickets that have published nothing while
// one of them lies after the window's nearest inclusive prefix (found by
// ballots); then an ordered reduction of the tickets after it (warp
// shuffles, then the warps' results in thread 0).
__device__ Agg look_back(const unsigned long long* desc, int t, unsigned* s_mask,
                         Agg* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Agg acc = agg_none();  // thread 0: the windows passed, later in the stream
  for (int end = t - 1;; end -= kThreads) {
    const int j = end - tid;
    Agg v = agg_none();
    int st = j >= 0 ? 0 : 2;  // before ticket 0: the empty prefix, inclusive
    int near;                 // the nearest inclusive prefix: the lowest such thread
    unsigned ns = 32;
    for (long long polls = 0;; ++polls) {
      if (st == 0) st = get_desc(desc, j, &v);
      const unsigned inclusive = __ballot_sync(kAll, st == 2);
      const unsigned missing = __ballot_sync(kAll, st == 0);
      __syncthreads();  // the last round's masks are read
      if (lane == 0) s_mask[2 * warp] = inclusive, s_mask[2 * warp + 1] = missing;
      __syncthreads();
      near = kThreads;
      int gap = kThreads;  // the lowest thread still without a descriptor
      for (int w = kMbs - 1; w >= 0; --w) {
        if (s_mask[2 * w]) near = 32 * w + __ffs(s_mask[2 * w]) - 1;
        if (s_mask[2 * w + 1]) gap = 32 * w + __ffs(s_mask[2 * w + 1]) - 1;
      }
      if (gap > near || gap == kThreads) break;
      if (polls == kSpinLimit) __trap();
      __nanosleep(ns);
      ns = ns < 256 ? 2 * ns : ns;
    }
    if (tid > near) v = agg_none();
    for (int o = 1; o < 32; o <<= 1) {  // in stream order: higher threads first
      const Agg y = shfl_down_agg(v, o);
      if (lane + o < 32) v = combine(y, v);
    }
    if (lane == 0) s_warp[warp] = v;
    __syncthreads();
    if (tid == 0) {
      Agg w_all = agg_none();
      for (int w = kMbs - 1; w >= 0; --w) w_all = combine(w_all, s_warp[w]);
      acc = combine(w_all, acc);
    }
    if (near < kThreads) return acc;
    __syncthreads();  // s_warp is read before the next window
  }
}

// The bits of the slice's first coded MB's mb_skip_run (coded MB `first`,
// -1: none): its run counts the MBs before it, and a P band's the skips
// before the band (lead).
__device__ __forceinline__ int lead_bits(int first, long long lead) {
  return first >= 0 ? ue_bits((int)(first + lead)) : 0;
}

// Step 5, every thread: ticket t's aggregate over its MBs [mb0, mb0 + cnt)
// (bits in s_bits), published; its exclusive prefix by look-back; its
// inclusive prefix, published; each MB's bit offset (s_off) and P's
// mb_skip_run (s_run); and, at the slice's last ticket, nbits, trail_bits
// and a whole P slice's trailing mb_skip_run. Ends with a barrier.
template <int F>
__device__ void offsets(const Args& s, int t, int mb0, int cnt, const int* s_bits,
                        long long* s_off, int* s_run, unsigned* s_mask, Agg* s_warp) {
  auto element = [&](int k) {
    Agg e{s_bits[k], -1, -1};
    if (F == kP && !s.skip[mb0 + k]) e.first = e.last = mb0 + k;
    return e;
  };
  Agg agg = agg_none();
  if (threadIdx.x == 0) {
    for (int k = 0; k < cnt; ++k) agg = combine(agg, element(k));
    put_desc(s.desc, t, 0, agg);
  }
  const Agg prefix = look_back(s.desc, t, s_mask, s_warp);
  if (threadIdx.x == 0) {
    put_desc(s.desc, t, 1, combine(prefix, agg));
    const long long lead =
        F == kP && s.band ? (s.run_lead != nullptr ? *s.run_lead : s.run_lead_value) : 0;
    Agg e = prefix;
    for (int k = 0; k < cnt; ++k) {
      const Agg x = element(k);
      s_off[k] = e.bits + lead_bits(e.first, lead);
      if (F == kP) {
        s_run[k] = x.first < 0 ? 0 : e.last >= 0 ? x.first - e.last - 1 : (int)(x.first + lead);
      }
      e = combine(e, x);
    }
    if (mb0 + cnt == s.nmb) {  // the slice's last ticket
      const long long bits = e.bits + lead_bits(e.first, lead);
      int tl = 0;
      if (F == kP) {  // the trailing skip run of a whole slice
        const int trail = (int)s.nmb - 1 - e.last;
        if (!s.band && trail > 0) {
          tl = ue_bits(trail);
          Writer wr(s.words, s.nwords, bits);
          wr.put(trail + 1, tl);
          wr.finish();
        }
        *s.trail_bits = tl;
      }
      *s.nbits = bits + tl;
    }
  }
  __syncthreads();
}

// ---- the kernel ------------------------------------------------------------
// The slice forms (kI16, kMixed, kP); at most 64 registers a thread, 4
// blocks an SM.
template <int F>
__global__ void __launch_bounds__(kThreads, 4) slice_kernel(Args s) {
  __shared__ int s_tabs[kTabLen];
  __shared__ int s_lv[kMbs][kLanes][kRow];
  __shared__ int s_bits[kMbs];
  __shared__ long long s_off[kMbs];
  __shared__ int s_run[kMbs];
  __shared__ unsigned s_mask[2 * kMbs];
  __shared__ Agg s_warp[kMbs];
  __shared__ int s_ticket;
  for (int i = threadIdx.x; i < kTabLen; i += kThreads) s_tabs[i] = s.tabs[i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nmb = (int)s.nmb, ntk = (nmb + kMbs - 1) / kMbs;
  int32_t* ready = s.sync + 1;
  for (;;) {
    __syncthreads();  // the last ticket's shared memory is free
    if (threadIdx.x == 0) s_ticket = atomicAdd(s.sync, 1);
    __syncthreads();
    const int t = s_ticket;
    if (t >= ntk) return;
    const int mb0 = t * kMbs, cnt = min(kMbs, nmb - mb0), mb = mb0 + warp;
    const bool on = warp < cnt;
    int(*rows)[kRow] = s_lv[warp];
    const bool i4 = on && F == kMixed && s.choice4[mb];
    // the luma lists are Intra16x16 AC lists of 15 levels (else 16)
    const int n = list_len(lane, F == kI16 || (F == kMixed && !i4));
    unsigned nz = 0, pf = 0;
    if (on) {  // 1-2: stage, state
      if (stage_mb<F>(s, mb, i4, F == kMixed ? s.cbp_chroma[mb] : 0, rows, lane, &pf)) {
        nz = block_nz(rows[lane], n);
      }
      mb_state<F>(s, mb, i4, nz, lane);
    }
    if (F != kMixed) {  // 3: publish the state, wait for the neighbours'
      __syncthreads();
      if (threadIdx.x == 0) st_release(ready + t, 1);
      wait_neighbours<kMbs>(ready, t, mb0, cnt, (int)s.wmb);
    }
    // 4: sizes, each list's count and context kept for the write
    const bool written = on && mb_written<F>(s, mb);
    const bool list = written && coded<F>(s, mb, lane, i4);
    int ctx = 0, bits = 0;
    if (list) {
      ctx = list_ctx(s, mb, lane);
      Count c;
      code_list(s_tabs, ctx, rows[lane], n, nz, c);
      bits = c.n;
    } else if (written && lane == 0) {
      Count c;
      code_header<F>(s, s_tabs, mb, 0, false, rows[0], pf, c);  // P: the run's bits: 5
      bits = c.n;
    }
    const int total = warp_sum(bits);
    if (lane == 0) s_bits[warp] = total;
    __syncthreads();
    offsets<F>(s, t, mb0, cnt, s_bits, s_off, s_run, s_mask, s_warp);  // 5
    // 6: the symbols
    if (!written) continue;
    const int run = F == kP ? s_run[warp] : 0;
    if (F == kP && lane == 0) bits += ue_bits(run);
    int before = bits;  // inclusive scan over the lanes, then exclusive
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, before, o);
      if (lane >= o) before += y;
    }
    before -= bits;
    if (bits == 0) continue;
    // the mixed form joins its symbols (an Intra4x4 MB's 16 mode symbols
    // and 16-level lists): 11 % faster there on an H100, 4-6 % slower in
    // the other forms
    using Sink = std::conditional_t<F == kMixed, JoinWriter, Writer>;
    Sink wr(s.words, s.nwords, s_off[warp] + before);
    if (list) {
      code_list(s_tabs, ctx, rows[lane], n, nz, wr);
    } else {
      code_header<F>(s, s_tabs, mb, run, true, rows[0], pf, wr);
    }
    wr.finish();
  }
}

// ---- the chroma setup alone ---------------------------------------------
// Steps 1-4 over the chroma lists: two MBs a warp, a half-warp each (lanes
// 0-9 of the half its lists, in the order of the slice lanes 18-27), so
// kChromaMbs MBs a ticket; its bits per MB the output. 32 registers a
// thread, 8 blocks an SM: a 1080p slice's tickets fit on the card at once.
constexpr int kChromaMbs = 2 * kMbs;

__global__ void __launch_bounds__(kThreads, 8) chroma_kernel(Args s) {
  __shared__ int s_tabs[kTabLen];
  __shared__ int s_lv[kChromaMbs][10][kRow];
  __shared__ int s_ticket;
  for (int i = threadIdx.x; i < kTabLen; i += kThreads) s_tabs[i] = s.tabs[i];
  const int lane = threadIdx.x & 31, half = lane >> 4, li = lane & 15;
  const int nmb = (int)s.nmb, ntk = (nmb + kChromaMbs - 1) / kChromaMbs;
  const int n = li < 2 ? 4 : 15;  // the list's maxNumCoeff
  int32_t* ready = s.sync + 1;
  for (;;) {
    __syncthreads();
    if (threadIdx.x == 0) s_ticket = atomicAdd(s.sync, 1);
    __syncthreads();
    const int t = s_ticket;
    if (t >= ntk) return;
    const int mb0 = t * kChromaMbs, cnt = min(kChromaMbs, nmb - mb0);
    const int k = 2 * (threadIdx.x >> 5) + half, mb = mb0 + k;
    const bool on = k < cnt, list = on && li < 10;
    int(*rows)[kRow] = s_lv[k];
    if (on) {  // 1: stage
      for (int p = 0; p < 2; ++p) {
        if (li < 4) cp_async4(&rows[p][li], s.cdc + 4 * (p * nmb + mb) + li);
        for (int q = li; q < 60; q += 16) {
          cp_async4(&rows[2 + 4 * p + q / 15][q % 15], s.cac + 60 * (p * nmb + mb) + q);
        }
      }
    }
    cp_async_wait_all();
    __syncwarp();
    // 2: state
    const unsigned nz = list ? block_nz(rows[li], n) : 0;
    const unsigned ac = __ballot_sync(kAll, li >= 2 && nz), dc = __ballot_sync(kAll, nz);
    const int cbp_c = (ac >> (16 * half)) & 0xffff ? 2 : ((dc >> (16 * half)) & 0xffff ? 1 : 0);
    if (list && li >= 2) {
      s.tc_chroma[4 * (((li - 2) >> 2) * nmb + mb) + ((li - 2) & 3)] = cbp_c == 2 ? __popc(nz) : 0;
    }
    if (on && li == 0) s.cbp_chroma[mb] = cbp_c;
    // 3: publish, wait
    __syncthreads();
    if (threadIdx.x == 0) st_release(ready + t, 1);
    wait_neighbours<kChromaMbs>(ready, t, mb0, cnt, (int)s.wmb);
    // 4: sizes
    int bits = 0;
    if (list && (li < 2 ? cbp_c > 0 : cbp_c == 2)) {
      Count c;
      code_list(s_tabs, list_ctx(s, mb, 18 + li), rows[li], n, nz, c);
      bits = c.n;
    }
    for (int o = 8; o; o >>= 1) bits += __shfl_xor_sync(kAll, bits, o);  // the half's sum
    if (on && li == 0) s.mb_bits[mb] = bits;
  }
}

// Launches form F's kernel on a persistent grid: as many blocks as fit on
// the card at once (per device, queried once), at most one per ticket.
template <int F>
int launch_form(const Args& s, cudaStream_t stream, int* launched) {
  static int fit[64];  // blocks at once on device d, 0 until queried
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  void (*kernel)(Args);
  if constexpr (F == kChroma) {
    kernel = chroma_kernel;
  } else {
    kernel = slice_kernel<F>;
  }
  if (fit[dev] == 0) fit[dev] = dataflow_grid(kernel, kThreads, 0, INT_MAX, 0);
  if (fit[dev] == 0) return (int)cudaErrorInvalidConfiguration;
  const int m = F == kChroma ? kChromaMbs : kMbs, tickets = (int)((s.nmb + m - 1) / m);
  const int grid = fit[dev] < tickets ? fit[dev] : tickets;
  if (s.zeroed_bytes > 0 &&
      (err = cudaMemsetAsync(s.zeroed, 0, (size_t)s.zeroed_bytes, stream)) != cudaSuccess) {
    return (int)err;
  }
  kernel<<<grid, kThreads, 0, stream>>>(s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

}  // namespace

// Codes one slice (or MB-row band) of form `form` (0 all-I16, 1 mixed, 2 P,
// 3 the chroma setup alone) on `stream`: one fill of the workspace
// (cudaMemsetAsync of zeroed_bytes at zeroed, which holds words, sync and
// desc), then one launch, counted in *launched. args: the nargs (kArgs)
// 8-byte slots of Args above, in its order (a pointer the form does not
// read may be 0). Returns the first CUDA error (0 when both were accepted).
extern "C" int cavlc_slice(int form, const int64_t* args, int nargs, cudaStream_t stream,
                           int* launched) {
  *launched = 0;
  if (nargs != kArgs) return (int)cudaErrorInvalidValue;
  Args s;
  std::memcpy(&s, args, sizeof s);
  if (s.nmb <= 0 || s.wmb <= 0 || s.nmb % s.wmb || s.nmb > INT_MAX / 256) {
    return (int)cudaErrorInvalidValue;
  }
  switch (form) {
    case kI16: return launch_form<kI16>(s, stream, launched);
    case kMixed: return launch_form<kMixed>(s, stream, launched);
    case kP: return launch_form<kP>(s, stream, launched);
    case kChroma: return launch_form<kChroma>(s, stream, launched);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The fill alone: zeroes bytes at p on `stream` with the cudaMemsetAsync a
// call of cavlc_slice makes before its launch (for timing the fill apart).
extern "C" int cavlc_slice_fill(void* p, int64_t bytes, cudaStream_t stream) {
  return (int)cudaMemsetAsync(p, 0, (size_t)bytes, stream);
}
