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
// The reference's program is some 1,000 small XLA ops a slice (the port's
// eager chain launched each of them), so what the design does about its
// bound is to read each level a fixed few times in a fixed few launches.
//
// Design: one warp per MB, a lane per block list (lane 0 the MB header,
// lane 1 the Intra16x16 DC block, lanes 2-17 the 16 luma blocks in Z-scan
// order, 18-19 the chroma DC blocks, 20-27 the chroma AC blocks of Cb then
// Cr: the lanes' order is the stream's), each list staged in shared memory.
// Four launches a slice:
//   A. state: each list's TotalCoeff; the MB's CBP, mb_type, final
//      TotalCoeff state and nonzero flags (the nC state the neighbours read);
//   B. size: each list's nC context from the final state of its MB and the
//      left and top MBs (a band's first row: the halo row above it,
//      top_ctx), its coeff_token and the rest of its syntax counted; the
//      header; the MB's bit total (0 at an invalid or skipped MB);
//   C. scan: one block of 1024 threads; for a P slice first the max-scan of
//      the coded MBs, whose mb_skip_run (with run_lead at a band's first
//      coded MB) enters each coded MB's total, then the exclusive sum into
//      int64 bit offsets, nbits and the trailing mb_skip_run (written here;
//      none for a band);
//   D. write: each lane recounts its list, a warp scan places it after the
//      lanes before it, and it writes its symbols. A symbol adds its bits
//      to its one or two words, as pack_symbols' index_add_ does; a lane
//      keeps its current word in a register, stores the words wholly inside
//      its span and adds its first and last words atomically (64-bit
//      atomicAdd) into the zeroed buffer, where the neighbouring spans add
//      theirs.
// The chroma setup alone is A and B over the chroma lanes. The mixed form
// takes the chroma setup's cbp_chroma, tc_chroma and bits, computed once a
// frame, so its A reads only the winner's luma lists (the DC list of an
// Intra16x16 MB, its AC lists or an Intra4x4 MB's 16 lists), and writes the
// chroma lists in D.
//
// Integers only; arithmetic shifts on signed values; int64 offsets. The
// length and code tables (kernels/cavlc_slice.TABLES, csrc/cavlc.cuh
// offsets) are copied to shared memory once per block. run_lead and the
// halo are device tensors, read on the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "cavlc.cuh"

namespace {

using namespace cavlc;

enum Form : int { kI16 = 0, kMixed = 1, kP = 2, kChroma = 3 };

constexpr int kWarps = 8;  // MBs per block of passes A, B and D
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 28;  // the header and the 27 block lists
constexpr int kScanThreads = 1024;

// The slice's arrays (null where a form has none) and outputs.
struct Slice {
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
  const int32_t* chroma_bits;  // (nmb,) mixed: the chroma setup's bits
  const int32_t* top_tc_luma;  // the halo row above a band, or null:
  const int32_t* top_cbp_luma;    //   (wmb, 16), (wmb,),
  const int32_t* top_tc_chroma;   //   (2, wmb, 4),
  const int32_t* top_cbp_chroma;  //   (wmb,)
  const int64_t* run_lead;     // P band: a device scalar, or null
  int64_t run_lead_value;      // P band: run_lead when it is a host int
  const int32_t* tabs;         // the table buffer (cavlc.cuh offsets)
  // the MB state A writes and B, D read (mixed: cbp_luma, tc_luma and the
  // chroma state are the inputs)
  int32_t* mb_type;            // (nmb,) I16, mixed
  int32_t* cbp_luma;           // (nmb,)
  int32_t* tc_luma;            // (nmb, 16)
  int32_t* cbp_chroma;         // (nmb,)
  int32_t* tc_chroma;          // (2, nmb, 4)
  bool* nz_luma;               // (nmb, 16) mixed, P
  int32_t* mb_bits;            // (nmb,) B's totals; the chroma setup's bits
  int32_t* run;                // (nmb,) P: C's mb_skip_run of each coded MB
  int64_t* offs;               // (nmb,) C's bit offset of each MB
  int64_t* nbits;              // () the payload's bits
  int32_t* trail_bits;         // () P: the trailing mb_skip_run's bits
  unsigned long long* words;   // (nwords,) zeroed
  int64_t nwords;
  int wmb, nmb, band;          // band: 1 for a P band (no trailing run)
};

// Does lane `lane` hold a block list in form F?
template <int F>
__device__ __forceinline__ bool has_list(int lane) {
  if (F == kChroma) return lane >= 18 && lane < kLanes;
  if (F == kP) return lane >= 2 && lane < kLanes;
  return lane >= 1 && lane < kLanes;
}

struct List {
  const int32_t* lv;  // its levels in zig-zag order
  int n;              // how many (maxNumCoeff)
};

// Lane `lane`'s block list of MB mb (has_list<F>(lane)); i4: a mixed MB
// coded Intra4x4.
template <int F>
__device__ __forceinline__ List list_of(const Slice& s, int mb, int lane, bool i4) {
  if (lane == 1) return {s.i16dc + 16 * mb, 16};
  if (lane < 18) {
    const int z = lane - 2;
    if (F == kP) return {s.luma + 256 * mb + 16 * z, 16};
    if (F == kMixed && i4) return {s.lv4 + 256 * mb + 16 * z, 16};
    return {s.i16ac + 240 * mb + 15 * z, 15};
  }
  if (lane < 20) return {s.cdc + 4 * ((lane - 18) * s.nmb + mb), 4};
  const int ci = (lane - 20) >> 2, b = (lane - 20) & 3;
  return {s.cac + 15 * (4 * (ci * s.nmb + mb) + b), 15};
}

// Copies the list to row (16 ints) and returns its nonzero mask.
__device__ __forceinline__ unsigned stage(List l, int* row) {
  for (int i = 0; i < l.n; ++i) row[i] = l.lv[i];
  return block_nz(row, l.n);
}

// ---- A: the MB state ------------------------------------------------------
template <int F>
__global__ void __launch_bounds__(kThreads) state_kernel(Slice s) {
  const int lane = threadIdx.x & 31;
  const int mb = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (mb >= s.nmb) return;
  const bool i4 = F == kMixed && s.choice4[mb];
  // the mixed form reads the winner's luma lists alone: its chroma state is
  // the chroma setup's, and an Intra4x4 MB has no DC list
  const bool skip_list = F == kMixed && (lane >= 18 || (lane == 1 && i4));
  unsigned nz = 0;
  if (has_list<F>(lane) && !skip_list) {
    const List l = list_of<F>(s, mb, lane, i4);
    nz = block_nz(l.lv, l.n);
  }
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
      s.tc_chroma[4 * (ci * s.nmb + mb) + b] = cbp_c == 2 ? tc : 0;
    }
    if (lane == 0) s.cbp_chroma[mb] = cbp_c;
  }
  if (F == kChroma) return;
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

// nC context of luma block z of MB (r, c) from the final state.
__device__ __forceinline__ int luma_ctx(const Slice& s, int mb, int r, int c, int z) {
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
    nB = gate(s.tc_luma[16 * (mb - s.wmb) + b_blk], s.cbp_luma[mb - s.wmb], b_blk);
  } else if (halo) {
    nB = gate(s.top_tc_luma[16 * c + b_blk], s.top_cbp_luma[c], b_blk);
  }
  return nc_ctx(nA, nB, a_same || c > 0, b_same || r > 0 || halo);
}

// nC context of chroma AC block b of plane ci of MB (r, c).
__device__ __forceinline__ int chroma_ctx(const Slice& s, int mb, int r, int c, int ci,
                                          int b) {
  bool a_same, b_same;
  int a_blk, b_blk;
  chroma_nbr(b, &a_same, &a_blk, &b_same, &b_blk);
  const bool halo = r == 0 && s.top_tc_chroma != nullptr;
  const int32_t* tc = s.tc_chroma + 4 * ci * s.nmb;
  int nA = 0, nB = 0;
  if (a_same) {
    nA = (s.cbp_chroma[mb] & 2) ? tc[4 * mb + a_blk] : 0;
  } else if (c > 0) {
    nA = (s.cbp_chroma[mb - 1] & 2) ? tc[4 * (mb - 1) + a_blk] : 0;
  }
  if (b_same) {
    nB = (s.cbp_chroma[mb] & 2) ? tc[4 * mb + b_blk] : 0;
  } else if (r > 0) {
    nB = (s.cbp_chroma[mb - s.wmb] & 2) ? tc[4 * (mb - s.wmb) + b_blk] : 0;
  } else if (halo) {
    nB = (s.top_cbp_chroma[c] & 2) ? s.top_tc_chroma[4 * (ci * s.wmb + c) + b_blk] : 0;
  }
  return nc_ctx(nA, nB, a_same || c > 0, b_same || r > 0 || halo);
}

// Is lane `lane`'s list coded in its MB (its CBP gate)? with_chroma: the
// chroma lists count here (the mixed form's B takes the chroma setup's bits
// in their place).
template <int F>
__device__ __forceinline__ bool coded(const Slice& s, int mb, int lane, bool i4,
                                      bool with_chroma) {
  if (!has_list<F>(lane)) return false;
  if (lane == 1) return !i4;  // I16: always; mixed: an Intra16x16 MB
  if (lane < 18) return (s.cbp_luma[mb] >> ((lane - 2) >> 2)) & 1;
  if (!with_chroma) return false;
  return lane < 20 ? s.cbp_chroma[mb] > 0 : s.cbp_chroma[mb] == 2;
}

// The symbols of lane `lane`'s list (coded<F>) to sink: its coeff_token,
// then block_rest. row: the list staged by stage().
template <class Sink>
__device__ __forceinline__ void code_list(const Slice& s, const int* tabs, int mb, int lane,
                                          const int* row, int n, unsigned nz, Sink& sink) {
  const int r = mb / s.wmb, c = mb - r * s.wmb;
  int ctx;
  if (lane < 18) {
    ctx = luma_ctx(s, mb, r, c, lane == 1 ? 0 : lane - 2);  // DC: block 0's nC
  } else if (lane < 20) {
    ctx = 4;  // chroma DC: nC = -1
  } else {
    ctx = chroma_ctx(s, mb, r, c, (lane - 20) >> 2, (lane - 20) & 3);
  }
  const int ti = (ctx * 17 + __popc(nz)) * 4 + trailing_ones(row, nz);
  emit(sink, tabs[kCtLen + ti], [&] { return tabs[kCtBits + ti]; });
  block_rest(row, n, nz, tabs, sink);
}

// The MB header (lane 0) to sink. run: P's mb_skip_run, written when
// with_run.
template <int F, class Sink>
__device__ __forceinline__ void code_header(const Slice& s, const int* tabs, int mb, int run,
                                            bool with_run, Sink& sink) {
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
        const bool pf = s.prev_flags[16 * mb + z];
        emit(sink, pf ? 1 : 4, [&] { return pf ? 1 : s.rem_modes[16 * mb + z]; });
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
      const int code = se_num(s.mvd[8 * mb + k]);
      emit(sink, ue_bits(code), [&] { return code + 1; });
    }
    const int code = tabs[kCbpInter + ((cbp_c << 4) | cbp_l)];
    emit(sink, ue_bits(code), [&] { return code + 1; });
    if (cbp_l > 0 || cbp_c > 0) emit(sink, 1, [&] { return 1; });
  }
}

// Is MB mb written at all: a valid MB (I16, mixed), a coded one (P)?
template <int F>
__device__ __forceinline__ bool mb_written(const Slice& s, int mb) {
  if (F == kP) return !s.skip[mb];
  if (F == kChroma) return true;
  return s.valid == nullptr || s.valid[mb];
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// ---- B: each MB's bit total ---------------------------------------------
template <int F>
__global__ void __launch_bounds__(kThreads) size_kernel(Slice s) {
  __shared__ int s_tabs[kTabLen];
  __shared__ int s_lv[kWarps][kLanes][16];
  for (int i = threadIdx.x; i < kTabLen; i += kThreads) s_tabs[i] = s.tabs[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mb = blockIdx.x * kWarps + warp;
  if (mb >= s.nmb) return;
  const bool i4 = F == kMixed && s.choice4[mb];
  int bits = 0;
  if (coded<F>(s, mb, lane, i4, F != kMixed)) {
    const List l = list_of<F>(s, mb, lane, i4);
    const unsigned nz = stage(l, s_lv[warp][lane]);
    Count n;
    code_list(s, s_tabs, mb, lane, s_lv[warp][lane], l.n, nz, n);
    bits = n.n;
  } else if (lane == 0 && F != kChroma) {
    Count n;
    code_header<F>(s, s_tabs, mb, 0, false, n);  // P: the run's bits come in C
    bits = n.n;
  }
  bits = warp_sum(bits);
  if (lane == 0) {
    if (F == kMixed) bits += s.chroma_bits[mb];
    s.mb_bits[mb] = mb_written<F>(s, mb) ? bits : 0;
  }
}

// Exclusive scan over the block of v (op, identity id); *total gets the
// reduction of every thread's v. Every thread of the block calls it.
template <class T, class Op>
__device__ T block_scan(T v, T id, Op op, T* total) {
  __shared__ T warp_tot[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x = op(x, y);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = warp_tot[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w = op(w, y);
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  T before = warp == 0 ? id : warp_tot[warp - 1];
  const T prev = __shfl_up_sync(kAll, x, 1);
  if (lane > 0) before = op(before, prev);
  *total = warp_tot[31];
  __syncthreads();
  return before;
}

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
    if (len <= 0) return;
    const unsigned long long v = (unsigned long long)(long long)val;
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

// ---- C: the offsets -------------------------------------------------------
template <int F>
__global__ void __launch_bounds__(kScanThreads) scan_kernel(Slice s) {
  const int per = (s.nmb + kScanThreads - 1) / kScanThreads;
  const int lo = min(s.nmb, (int)threadIdx.x * per), hi = min(s.nmb, lo + per);
  int last_coded = -1;
  if (F == kP) {  // mb_skip_run before each coded MB
    int last = -1;
    for (int i = lo; i < hi; ++i) {
      if (!s.skip[i]) last = i;
    }
    int prev = block_scan(last, -1, [](int a, int b) { return a > b ? a : b; }, &last_coded);
    const int64_t lead = s.run_lead != nullptr ? *s.run_lead : s.run_lead_value;
    for (int i = lo; i < hi; ++i) {
      if (s.skip[i]) continue;
      // the band's first coded MB carries the skips before the band
      s.run[i] = (int)((int64_t)(i - prev - 1) + (s.band && prev < 0 ? lead : 0));
      prev = i;
    }
  }
  auto mb_total = [&](int i) -> int64_t {
    return s.mb_bits[i] + (F == kP && !s.skip[i] ? ue_bits(s.run[i]) : 0);
  };
  int64_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += mb_total(i);
  int64_t total;
  int64_t off = block_scan(sum, (int64_t)0, [](int64_t a, int64_t b) { return a + b; },
                           &total);
  for (int i = lo; i < hi; ++i) {
    s.offs[i] = off;
    off += mb_total(i);
  }
  if (threadIdx.x == 0) {
    int tl = 0;
    if (F == kP) {  // the trailing skip run of a whole slice
      const int trail = s.nmb - 1 - last_coded;
      if (!s.band && trail > 0) {
        tl = ue_bits(trail);
        Writer wr(s.words, s.nwords, total);
        wr.put(trail + 1, tl);
        wr.finish();
      }
      *s.trail_bits = tl;
    }
    *s.nbits = total + tl;
  }
}

// ---- D: the symbols ----------------------------------------------------
template <int F>
__global__ void __launch_bounds__(kThreads) write_kernel(Slice s) {
  __shared__ int s_tabs[kTabLen];
  __shared__ int s_lv[kWarps][kLanes][16];
  for (int i = threadIdx.x; i < kTabLen; i += kThreads) s_tabs[i] = s.tabs[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mb = blockIdx.x * kWarps + warp;
  if (mb >= s.nmb || !mb_written<F>(s, mb)) return;
  const bool i4 = F == kMixed && s.choice4[mb];
  const int run = F == kP ? s.run[mb] : 0;
  const bool on = coded<F>(s, mb, lane, i4, true);
  int n = 0;
  unsigned nz = 0;
  int bits = 0;
  if (on) {
    const List l = list_of<F>(s, mb, lane, i4);
    n = l.n;
    nz = stage(l, s_lv[warp][lane]);
    Count cnt;
    code_list(s, s_tabs, mb, lane, s_lv[warp][lane], n, nz, cnt);
    bits = cnt.n;
  } else if (lane == 0) {
    Count cnt;
    code_header<F>(s, s_tabs, mb, run, true, cnt);
    bits = cnt.n;
  }
  int before = bits;  // inclusive scan over the lanes, then exclusive
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, before, o);
    if (lane >= o) before += y;
  }
  before -= bits;
  if (bits == 0) return;
  Writer wr(s.words, s.nwords, s.offs[mb] + before);
  if (on) {
    code_list(s, s_tabs, mb, lane, s_lv[warp][lane], n, nz, wr);
  } else {
    code_header<F>(s, s_tabs, mb, run, true, wr);
  }
  wr.finish();
}

template <int F>
int launch_form(const Slice& s, cudaStream_t stream, int* launched) {
  const int grid = (s.nmb + kWarps - 1) / kWarps;
  state_kernel<F><<<grid, kThreads, 0, stream>>>(s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  size_kernel<F><<<grid, kThreads, 0, stream>>>(s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  if (F == kChroma) return 0;
  scan_kernel<F><<<1, kScanThreads, 0, stream>>>(s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  write_kernel<F><<<grid, kThreads, 0, stream>>>(s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

}  // namespace

// Codes one slice (or MB-row band) of form `form` (0 all-I16, 1 mixed, 2 P,
// 3 the chroma setup alone) on `stream`: passes A, B (and C, D but for the
// chroma setup), counted in *launched. Arguments as the fields of Slice
// above, in its order; a pointer the form does not read may be null, and
// words must be zeroed. Returns the first CUDA error (0 when every launch
// was accepted).
extern "C" int cavlc_slice(
    int form, const int32_t* mode16, const int32_t* cmode, const int32_t* i16dc,
    const int32_t* i16ac, const bool* choice4, const int32_t* lv4, const bool* prev_flags,
    const int32_t* rem_modes, const bool* skip, const int32_t* ptype, const int32_t* mvd,
    const int32_t* luma, const int32_t* cdc, const int32_t* cac, const bool* valid,
    const int32_t* chroma_bits, const int32_t* top_tc_luma, const int32_t* top_cbp_luma,
    const int32_t* top_tc_chroma, const int32_t* top_cbp_chroma, const int64_t* run_lead,
    int run_lead_value, const int32_t* tabs, int32_t* mb_type, int32_t* cbp_luma,
    int32_t* tc_luma, int32_t* cbp_chroma, int32_t* tc_chroma, bool* nz_luma,
    int32_t* mb_bits, int32_t* run, int64_t* offs, int64_t* nbits, int32_t* trail_bits,
    unsigned long long* words, int nwords, int wmb, int nmb, int band,
    cudaStream_t stream, int* launched) {
  *launched = 0;
  const Slice s{mode16, cmode, i16dc, i16ac, choice4, lv4, prev_flags, rem_modes, skip,
                ptype, mvd, luma, cdc, cac, valid, chroma_bits, top_tc_luma, top_cbp_luma,
                top_tc_chroma, top_cbp_chroma, run_lead, run_lead_value, tabs, mb_type,
                cbp_luma, tc_luma, cbp_chroma, tc_chroma, nz_luma, mb_bits, run, offs,
                nbits, trail_bits, words, nwords, wmb, nmb, band};
  if (nmb <= 0 || wmb <= 0 || nmb % wmb) return (int)cudaErrorInvalidValue;
  switch (form) {
    case kI16: return launch_form<kI16>(s, stream, launched);
    case kMixed: return launch_form<kMixed>(s, stream, launched);
    case kP: return launch_form<kP>(s, stream, launched);
    case kChroma: return launch_form<kChroma>(s, stream, launched);
    default: return (int)cudaErrorInvalidValue;
  }
}
