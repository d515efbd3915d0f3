// CAVLC arithmetic shared by the kernels that size or write macroblock
// layers: K6 (csrc/wavefront_mixed.cu) sizes both candidates of every MB,
// K10 (csrc/cavlc_slice.cu) sizes and writes whole slices. The device form
// of ops/cavlc_bulk.block_symbols_bulk (norm 9.2; reference
// residual_block_cavlc_write, residual.cpp:374-957) and of the nC context
// of codec/entropy.py (residual.cpp:251-294), in integers only.
//
// One table buffer (kernels/cavlc_slice.TABLES) holds every length and code
// table at the offsets below; K6 takes its first kK6TabLen entries, the
// length tables and the intra CBP code numbers (kernels/wavefront_mixed
// .TABLES).

#pragma once

#include <cstdint>

namespace cavlc {

constexpr int kCtLen = 0;        // coeff_token length [ctx 0..4][tc 0..16][t1 0..3]
constexpr int kTzLen = 340;      // total_zeros length [tc - 1][zeros 0..15]
constexpr int kRbLen = 580;      // run_before length [zeros_left - 1][run 0..6]
constexpr int kCbpIntra = 622;   // intra CBP code number [cbp_chroma << 4 | cbp_luma]
constexpr int kK6TabLen = 670;   // K6's part of the buffer
constexpr int kCtBits = 670;     // coeff_token code, as kCtLen
constexpr int kTzBits = 1010;    // total_zeros code, as kTzLen
constexpr int kRbBits = 1250;    // run_before code, as kRbLen
constexpr int kTzCdcLen = 1292;  // chroma DC total_zeros length [tc - 1][zeros 0..3]
constexpr int kTzCdcBits = 1304; // chroma DC total_zeros code
constexpr int kCbpInter = 1316;  // inter CBP code number [cbp_chroma << 4 | cbp_luma]
constexpr int kTabLen = 1364;    // the whole buffer

constexpr unsigned kAll = 0xffffffffu;

// Z-scan index of the 4x4 block in column i, row j of the MB
__device__ __forceinline__ int zidx(int i, int j) {
  return ((j >> 1) << 3) | ((i >> 1) << 2) | ((j & 1) << 1) | (i & 1);
}

// The left (A) and top (B) neighbours of Z-scan block z (ops/tables.LUMA_NBR):
// whether each is in this MB, and its block (in this MB, or in the left /
// top MB).
__device__ __forceinline__ void luma_nbr(int z, bool* a_same, int* a_blk,
                                         bool* b_same, int* b_blk) {
  const int i = ((z >> 2) & 1) * 2 + (z & 1), j = ((z >> 3) & 1) * 2 + ((z >> 1) & 1);
  *a_same = i > 0;
  *a_blk = zidx(i > 0 ? i - 1 : 3, j);
  *b_same = j > 0;
  *b_blk = zidx(i, j > 0 ? j - 1 : 3);
}

// The same for chroma AC block b of a 2x2 plane (ops/tables.CHROMA_NBR).
__device__ __forceinline__ void chroma_nbr(int b, bool* a_same, int* a_blk,
                                           bool* b_same, int* b_blk) {
  const int x = b & 1, y = b >> 1;
  *a_same = x > 0;
  *a_blk = 2 * y + (x ^ 1);
  *b_same = y > 0;
  *b_blk = 2 * (y ^ 1) + x;
}

// Bit length of ue(v), v >= 0: 2 floor(log2(v + 1)) + 1.
__device__ __forceinline__ int ue_bits(int v) { return 2 * (31 - __clz(v + 1)) + 1; }

// se(v) as the ue code number: 2v - 1 for v > 0, -2v otherwise.
__device__ __forceinline__ int se_num(int v) { return v > 0 ? 2 * v - 1 : -2 * v; }

// TotalCoeff tc of a block of quadrant blk / 4, 0 where the quadrant is
// not coded
__device__ __forceinline__ int gate(int tc, int cbp, int blk) {
  return ((cbp >> (blk / 4)) & 1) ? tc : 0;
}

// nC of a block (residual.cpp:251-294) from its A and B TotalCoeffs and
// their availability, as the coeff_token context 0..3.
__device__ __forceinline__ int nc_ctx(int nA, int nB, bool a_ok, bool b_ok) {
  const int nc = a_ok && b_ok ? (nA + nB + 1) >> 1 : a_ok ? nA : b_ok ? nB : 0;
  return (nc >= 2) + (nc >= 4) + (nc >= 8);
}

// Nonzero positions of a block of L levels (bit i: level i).
__device__ __forceinline__ unsigned block_nz(const int* lv, int L) {
  unsigned nz = 0;
  for (int i = 0; i < L; ++i) nz |= (lv[i] != 0 ? 1u : 0u) << i;
  return nz;
}

// TrailingOnes of a block with nonzero positions nz: the run of levels +-1
// from the last nonzero one, capped at 3.
__device__ __forceinline__ int trailing_ones(const int* lv, unsigned nz) {
  int t1 = 0;
  for (unsigned m = nz; m && t1 < 3; ++t1) {
    const int p = 31 - __clz(m);
    if (lv[p] != 1 && lv[p] != -1) break;
    m &= ~(1u << p);
  }
  return t1;
}

// A sink that counts the bits of the symbols it is given.
struct Count {
  static constexpr bool kWrite = false;
  int n = 0;
};

// Hands sink one symbol of len bits; its value, code(), is computed only
// for a sink that writes.
template <class Sink, class Code>
__device__ __forceinline__ void emit(Sink& sink, int len, Code code) {
  if constexpr (Sink::kWrite) {
    sink.put(code(), len);
  } else {
    sink.n += len;
  }
}

// The CAVLC syntax of a block after its coeff_token (block_symbols_bulk's
// slots 1..): the trailing-one signs (a bit each), the level codes with the
// adaptive suffixLength (both escapes), total_zeros (none when tc ==
// max_coeff; max_coeff 4: the chroma DC table) and run_before (the
// zerosLeft > 6 escape). lv: the block's levels in zig-zag order; nz:
// block_nz of them; tabs: the table buffer (a counting sink reads only its
// length tables). One pass over the nonzero levels from the last, found by
// the mask; a writing sink takes run_before in a second pass, after
// total_zeros, in stream order. Returns TrailingOnes.
template <class Sink>
__device__ __forceinline__ int block_rest(const int* lv, int max_coeff, unsigned nz,
                                          const int* tabs, Sink& sink) {
  const int tc = __popc(nz);
  // run_before of the nonzero level at p, the k-th from the last, with the
  // nonzero levels `below` it: none for the first level, or none left
  auto run_before = [&](int p, int k, unsigned below) {
    const int zl = p + k + 1 - tc;  // zeros left below p
    if (!below || zl <= 0) return;
    const int run = p - (31 - __clz(below)) - 1;
    if (zl > 6) {
      emit(sink, run < 7 ? 3 : run - 3, [&] { return run < 7 ? 7 - run : 1; });
    } else {
      const int i = (zl - 1) * 7 + run;
      emit(sink, tabs[kRbLen + i], [&] { return tabs[kRbBits + i]; });
    }
  };
  int t1 = 0, sl = 0, k = 0;
  for (unsigned m = nz; m; ++k) {
    const int p = 31 - __clz(m);
    m &= ~(1u << p);
    const int v = lv[p];
    if (k == t1 && t1 < 3 && (v == 1 || v == -1)) {
      ++t1;  // a trailing one: its sign bit
      emit(sink, 1, [&] { return v < 0 ? 1 : 0; });
    } else {
      int code = v > 0 ? 2 * v - 2 : -2 * v - 1;
      if (k == t1) {  // the first level: TrailingOnes is final here
        if (t1 < 3) code -= 2;
        sl = (tc > 10 && t1 < 3) ? 1 : 0;
      }
      int prefix, ssize, suffix;
      if (sl == 0) {
        prefix = code < 14 ? code : (code < 30 ? 14 : 15);
        ssize = code < 14 ? 0 : (code < 30 ? 4 : 12);
        suffix = code < 14 ? 0 : (code < 30 ? code - 14 : code - 30);
      } else {
        const int pr = code >> sl;
        prefix = pr < 15 ? pr : 15;
        ssize = pr < 15 ? sl : 12;
        suffix = pr < 15 ? code & ((1 << sl) - 1) : code - (15 << sl);
      }
      emit(sink, prefix + 1 + ssize, [&] { return (1 << ssize) | suffix; });
      const int sl1 = sl > 1 ? sl : 1;
      const int av = v < 0 ? -v : v;
      sl = sl1 + ((av > (3 << (sl1 - 1)) && sl1 < 6) ? 1 : 0);
    }
    if constexpr (!Sink::kWrite) run_before(p, k, m);
  }
  if (tc > 0 && tc < max_coeff) {
    const int tz = (31 - __clz(nz)) + 1 - tc;
    const int i = max_coeff == 4 ? (tc - 1) * 4 + tz : (tc - 1) * 16 + tz;
    emit(sink, tabs[(max_coeff == 4 ? kTzCdcLen : kTzLen) + i],
         [&] { return tabs[(max_coeff == 4 ? kTzCdcBits : kTzBits) + i]; });
  }
  if constexpr (Sink::kWrite) {
    k = 0;
    for (unsigned m = nz; m; ++k) {
      const int p = 31 - __clz(m);
      m &= ~(1u << p);
      run_before(p, k, m);
    }
  }
  return t1;
}

// CAVLC bits of one block apart from its coeff_token (block_symbols_bulk's
// rest_bits): block_rest counted. Sets *tc_out and *t1_out (TotalCoeff,
// TrailingOnes).
__device__ __forceinline__ int rest_bits(const int* lv, int L, const int* tabs, int* tc_out,
                                         int* t1_out) {
  const unsigned nz = block_nz(lv, L);
  Count n;
  *t1_out = block_rest(lv, L, nz, tabs, n);
  *tc_out = __popc(nz);
  return n.n;
}

}  // namespace cavlc
