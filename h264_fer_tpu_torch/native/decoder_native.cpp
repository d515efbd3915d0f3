// Native whole-slice decoder: CAVLC parse + prediction + reconstruction.
//
// A copy of the JAX package's native/decoder_native.cpp, the C++ form of
// the decoder's hot path (codec/decoder.py, itself the bit-exact
// re-implementation of the reference decoder's behavior,
// rbsp_decoding.cpp:17-367): the slice loop is scalar-sequential (bit
// reader, per-MB syntax, neighbor-dependent intra prediction), which is
// host code, exactly as the reference's decoder is. codec/decoder.py's
// Python form (Decoder(native=False)) remains the semantic reference;
// tests assert byte-identical planes and state on every stream family.
//
// Built by g++ with a plain C interface (kernels/build.compile_host_source)
// and loaded by native/__init__.py with ctypes. Tables arrive from Python
// at init (ops/cavlc_tables.py, ops/tables.py) and dense prefix-decode
// LUTs are built here, mirroring ops/cavlc.py's _get_dense_table (the
// reference's 24-bit peek + binary search, residual_tables.cpp:1012-1030,
// as a direct-indexed LUT).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// tables (filled by decoder_init)

static int32_t CT_LEN[5 * 17 * 4], CT_BITS[5 * 17 * 4];
static int32_t TZ_LEN[15 * 16], TZ_BITS[15 * 16];
static int32_t TZC_LEN[3 * 4], TZC_BITS[3 * 4];
static int32_t RB_LEN[6 * 7], RB_BITS[6 * 7];
static int32_t CBP_INTRA[48], CBP_INTER[48];
static int32_t BLK_XY[16 * 2];      // z-scan block -> (x, y) pixel offset
static int32_t RASTER_TO_Z[16];
static int32_t QPC_TAB[52];
static int32_t ZIG[16];             // scan index -> block cell (r*4+c)

struct Lut {
  int maxlen;
  int32_t len[1 << 16];
  int32_t v0[1 << 16];
  int32_t v1[1 << 16];
};
// ct[5], tz[15], tzc[3], rb[6]
static Lut *g_ct[5], *g_tz[15], *g_tzc[3], *g_rb[6];
static int g_init = 0;

static Lut *build_lut(const int32_t *len2d, const int32_t *bits2d, int n0,
                      int n1, int swap01) {
  // entries (i, j) with len>0; payload (i, j). swap01: payload order.
  int maxlen = 0;
  for (int i = 0; i < n0; i++)
    for (int j = 0; j < n1; j++) {
      int n = len2d[i * n1 + j];
      if (n > maxlen) maxlen = n;
    }
  Lut *t = (Lut *)calloc(1, sizeof(Lut));
  t->maxlen = maxlen;
  for (int i = 0; i < n0; i++)
    for (int j = 0; j < n1; j++) {
      int n = len2d[i * n1 + j];
      if (n <= 0) continue;
      uint32_t code = (uint32_t)bits2d[i * n1 + j];
      uint32_t base = code << (maxlen - n);
      uint32_t cnt = 1u << (maxlen - n);
      for (uint32_t s = 0; s < cnt; s++) {
        t->len[base + s] = n;
        t->v0[base + s] = swap01 ? j : i;
        t->v1[base + s] = swap01 ? i : j;
      }
    }
  return t;
}

void decoder_init(const int32_t *ct_len, const int32_t *ct_bits,
                  const int32_t *tz_len, const int32_t *tz_bits,
                  const int32_t *tzc_len, const int32_t *tzc_bits,
                  const int32_t *rb_len, const int32_t *rb_bits,
                  const int32_t *cbp_intra, const int32_t *cbp_inter,
                  const int32_t *blk_xy, const int32_t *raster_to_z,
                  const int32_t *qpc_tab, const int32_t *zig) {
  memcpy(CT_LEN, ct_len, sizeof(CT_LEN));
  memcpy(CT_BITS, ct_bits, sizeof(CT_BITS));
  memcpy(TZ_LEN, tz_len, sizeof(TZ_LEN));
  memcpy(TZ_BITS, tz_bits, sizeof(TZ_BITS));
  memcpy(TZC_LEN, tzc_len, sizeof(TZC_LEN));
  memcpy(TZC_BITS, tzc_bits, sizeof(TZC_BITS));
  memcpy(RB_LEN, rb_len, sizeof(RB_LEN));
  memcpy(RB_BITS, rb_bits, sizeof(RB_BITS));
  memcpy(CBP_INTRA, cbp_intra, sizeof(CBP_INTRA));
  memcpy(CBP_INTER, cbp_inter, sizeof(CBP_INTER));
  memcpy(BLK_XY, blk_xy, sizeof(BLK_XY));
  memcpy(RASTER_TO_Z, raster_to_z, sizeof(RASTER_TO_Z));
  memcpy(QPC_TAB, qpc_tab, sizeof(QPC_TAB));
  memcpy(ZIG, zig, sizeof(ZIG));
  if (!g_init) {
    // ct payload (total_coeff, t1): entries indexed [ctx][tc][t1]
    for (int c = 0; c < 5; c++)
      g_ct[c] = build_lut(CT_LEN + c * 17 * 4, CT_BITS + c * 17 * 4, 17, 4, 0);
    for (int i = 0; i < 15; i++)
      g_tz[i] = build_lut(TZ_LEN + i * 16, TZ_BITS + i * 16, 1, 16, 1);
    for (int i = 0; i < 3; i++)
      g_tzc[i] = build_lut(TZC_LEN + i * 4, TZC_BITS + i * 4, 1, 4, 1);
    for (int i = 0; i < 6; i++)
      g_rb[i] = build_lut(RB_LEN + i * 7, RB_BITS + i * 7, 1, 7, 1);
    g_init = 1;
  }
}

// ---------------------------------------------------------------------------
// bit reader (bitstream/bitio.py BitReader semantics, incl. zero-padded
// peek and the reference's byte-count more_rbsp_data)

struct Reader {
  const uint8_t *d;
  long nbytes;
  long byte;
  int bit;
};

static inline uint32_t rd_peek(Reader *r, int nbits) {
  uint64_t acc = 0;
  int need = r->bit + nbits;
  int nb = (need + 7) >> 3;
  for (int i = 0; i < nb; i++) {
    uint32_t b = (r->byte + i < r->nbytes) ? r->d[r->byte + i] : 0;
    acc = (acc << 8) | b;
  }
  acc >>= nb * 8 - need;
  return (uint32_t)(acc & ((1u << nbits) - 1));
}

static inline void rd_skip(Reader *r, int nbits) {
  long pos = r->byte * 8 + r->bit + nbits;
  r->byte = pos >> 3;
  r->bit = (int)(pos & 7);
}

static inline uint32_t rd_read(Reader *r, int nbits) {
  if (nbits > 24) {  // rare corrupt-stream escape; chunk to stay in range
    uint32_t hi = rd_read(r, nbits - 24);
    return (hi << 24) | rd_read(r, 24);
  }
  uint32_t v = rd_peek(r, nbits);
  rd_skip(r, nbits);
  return v;
}

static inline int rd_bit(Reader *r) {
  // past-the-end reads return 1 (terminates prefix scans on corrupt
  // streams without reading out of bounds; Python would raise)
  int v = (r->byte < r->nbytes) ? (r->d[r->byte] >> (7 - r->bit)) & 1 : 1;
  if (++r->bit == 8) { r->bit = 0; r->byte++; }
  return v;
}

static inline int rd_more(Reader *r) { return r->byte < r->nbytes - 1; }

static inline int bitlen(uint32_t v) {
  int n = 0;
  while (v) { n++; v >>= 1; }
  return n;
}

static int read_ue(Reader *r) {
  uint32_t v = rd_peek(r, 24);
  if (v) {
    int zeros = 24 - bitlen(v);
    if (zeros <= 11) {
      rd_skip(r, 2 * zeros + 1);
      return (int)((v >> (23 - 2 * zeros)) - 1);
    }
  }
  int zeros = 0;
  while (rd_bit(r) == 0) zeros++;
  if (zeros == 0) return 0;
  return (1 << zeros) - 1 + (int)rd_read(r, zeros);
}

static int read_se(Reader *r) {
  int k = read_ue(r);
  return (k & 1) ? (k + 1) / 2 : -(k / 2);
}

static int read_te(Reader *r, int range_max) {
  // bitstream read_te semantics: te(v) with range>1 -> ue; ==1 -> !bit
  if (range_max > 1) return read_ue(r);
  return 1 - rd_bit(r);
}

// ---------------------------------------------------------------------------
// CAVLC residual block decode (ops/cavlc.py decode_residual_block)

static inline void lut_decode(Reader *r, Lut *t, int *v0, int *v1) {
  uint32_t v = rd_peek(r, t->maxlen);
  int n = t->len[v];
  if (n == 0) { *v0 = -1000; return; }  // invalid codeword
  rd_skip(r, n);
  *v0 = t->v0[v];
  *v1 = t->v1[v];
}

static int nc_ctx(int nc) {
  if (nc == -1) return 4;
  if (nc < 2) return 0;
  if (nc < 4) return 1;
  if (nc < 8) return 2;
  return 3;
}

static int decode_level_code(Reader *r, int suffix_len) {
  uint32_t v = rd_peek(r, 24);
  int prefix;
  if (v) {
    prefix = 24 - bitlen(v);
    rd_skip(r, prefix + 1);
  } else {
    rd_skip(r, 24);
    prefix = 24;
    while (rd_bit(r) == 0) prefix++;
  }
  int size;
  if (prefix == 14 && suffix_len == 0) size = 4;
  else if (prefix >= 15) size = prefix - 3;
  else size = suffix_len;
  int suffix = (size > 0 || prefix >= 14) ? (int)rd_read(r, size) : 0;
  int pc = prefix < 15 ? prefix : 15;
  int level_code = (pc << suffix_len) + suffix;
  if (prefix >= 15 && suffix_len == 0) level_code += 15;
  return level_code;
}

// returns total_coeff or negative error
static int decode_block(Reader *r, int nc, int max_num_coeff,
                        int32_t *coeff /* max_num_coeff zeros on entry */) {
  int tc, t1;
  lut_decode(r, g_ct[nc_ctx(nc)], &tc, &t1);
  if (tc < 0) return -1;
  if (tc == 0) return 0;
  int suffix_len = (tc > 10 && t1 < 3) ? 1 : 0;
  int level[16];
  for (int i = 0; i < tc; i++) {
    if (i < t1) {
      level[i] = 1 - 2 * rd_bit(r);
    } else {
      int lc = decode_level_code(r, suffix_len);
      if (i == t1 && t1 < 3) lc += 2;
      level[i] = (lc & 1) ? (-lc - 1) >> 1 : (lc + 2) >> 1;
      if (suffix_len == 0) suffix_len = 1;
      int a = level[i] < 0 ? -level[i] : level[i];
      if (a > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
    }
  }
  int zeros_left = 0;
  if (tc < max_num_coeff) {
    int z, dummy;
    lut_decode(r, nc != -1 ? g_tz[tc - 1] : g_tzc[tc - 1], &z, &dummy);
    if (z < -100) return -1;
    zeros_left = z;
  }
  int run[16];
  for (int j = 0; j < tc; j++) run[j] = 0;
  for (int j = 0; j < tc - 1; j++) {
    if (zeros_left > 0) {
      int rb;
      if (zeros_left > 6) {
        rb = 7 - (int)rd_read(r, 3);
        if (rb == 7) {
          while (rd_bit(r) == 0) rb++;
        }
      } else {
        int dummy;
        lut_decode(r, g_rb[zeros_left - 1], &rb, &dummy);
        if (rb < -100) return -1;
      }
      run[j] = rb;
    }
    zeros_left -= run[j];
  }
  run[tc - 1] = zeros_left;
  int coeff_num = -1;
  for (int i = tc - 1; i >= 0; i--) {
    coeff_num += run[i] + 1;
    if (coeff_num < 0 || coeff_num >= max_num_coeff) return -1;
    coeff[coeff_num] = level[i];
  }
  return tc;
}

// ---------------------------------------------------------------------------
// transforms (ops/transform.py inverse path)

static const int LS_V0[6] = {10, 11, 13, 14, 16, 18};
static const int LS_V1[6] = {16, 18, 20, 23, 25, 29};
static const int LS_V2[6] = {13, 14, 16, 18, 20, 23};

static inline int level_scale(int qp6, int r, int c) {
  // LEVEL_SCALE = 16 * normAdjust (scaleTransform.cpp:32-40)
  int v;
  if ((r & 1) == 0 && (c & 1) == 0) v = LS_V0[qp6];
  else if ((r & 1) == 1 && (c & 1) == 1) v = LS_V1[qp6];
  else v = LS_V2[qp6];
  return 16 * v;
}

static void scale_residual(int32_t *d /*16, r*4+c*/, int qp, int dc_bypass) {
  int dc = d[0];
  int q6 = qp % 6;
  if (qp >= 24) {
    int sh = qp / 6 - 4;
    for (int i = 0; i < 16; i++)
      d[i] = (d[i] * level_scale(q6, i >> 2, i & 3)) << sh;
  } else {
    int adjust = 1 << (3 - qp / 6);
    int sh = 4 - qp / 6;
    for (int i = 0; i < 16; i++)
      d[i] = (d[i] * level_scale(q6, i >> 2, i & 3) + adjust) >> sh;
  }
  if (dc_bypass) d[0] = dc;
}

static void inverse_transform_4x4(int32_t *d /*in/out 16*/) {
  int32_t f[16];
  for (int r = 0; r < 4; r++) {
    int d0 = d[r * 4 + 0], d1 = d[r * 4 + 1], d2 = d[r * 4 + 2],
        d3 = d[r * 4 + 3];
    int e0 = d0 + d2, e1 = d0 - d2;
    int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
    f[r * 4 + 0] = e0 + e3;
    f[r * 4 + 1] = e1 + e2;
    f[r * 4 + 2] = e1 - e2;
    f[r * 4 + 3] = e0 - e3;
  }
  for (int c = 0; c < 4; c++) {
    int f0 = f[0 * 4 + c], f1 = f[1 * 4 + c], f2 = f[2 * 4 + c],
        f3 = f[3 * 4 + c];
    int g0 = f0 + f2, g1 = f0 - f2;
    int g2 = (f1 >> 1) - f3, g3 = f1 + (f3 >> 1);
    d[0 * 4 + c] = (g0 + g3 + 32) >> 6;
    d[1 * 4 + c] = (g1 + g2 + 32) >> 6;
    d[2 * 4 + c] = (g1 - g2 + 32) >> 6;
    d[3 * 4 + c] = (g0 - g3 + 32) >> 6;
  }
}

static void inverse_residual_zz(const int32_t *levels16, int qp,
                                int dc_bypass, int32_t *out16) {
  int32_t d[16];
  for (int i = 0; i < 16; i++) d[i] = 0;
  for (int i = 0; i < 16; i++) d[ZIG[i]] = levels16[i];
  scale_residual(d, qp, dc_bypass);
  inverse_transform_4x4(d);
  for (int i = 0; i < 16; i++) out16[i] = d[i];
}

static void inverse_dc_luma(const int32_t *zz16, int qp, int32_t *out /*r4c4*/) {
  int32_t c[16];
  for (int i = 0; i < 16; i++) c[i] = 0;
  for (int i = 0; i < 16; i++) c[ZIG[i]] = zz16[i];
  // H*c*H^T with H rows {1,1,1,1},{1,1,-1,-1},{1,-1,-1,1},{1,-1,1,-1}
  static const int H[16] = {1, 1, 1, 1, 1, 1, -1, -1, 1, -1, -1, 1,
                            1, -1, 1, -1};
  int32_t t[16], f[16];
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
      int s = 0;
      for (int k = 0; k < 4; k++) s += H[i * 4 + k] * c[k * 4 + j];
      t[i * 4 + j] = s;
    }
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
      int s = 0;
      for (int k = 0; k < 4; k++) s += t[i * 4 + k] * H[j * 4 + k];
      f[i * 4 + j] = s;
    }
  int ls = level_scale(qp % 6, 0, 0);
  if (qp >= 36) {
    int sh = qp / 6 - 6;
    for (int i = 0; i < 16; i++) out[i] = (f[i] * ls) << sh;
  } else {
    int adjust = 1 << (5 - qp / 6);
    int sh = 6 - qp / 6;
    for (int i = 0; i < 16; i++) out[i] = (f[i] * ls + adjust) >> sh;
  }
}

static void inverse_dc_chroma(const int32_t *c4 /*raster 2x2*/, int qp,
                              int32_t *out4) {
  // H2*c*H2 with H2 = {1,1;1,-1}
  int a = c4[0], b = c4[1], cc = c4[2], dd = c4[3];
  int f0 = a + b + cc + dd;
  int f1 = a - b + cc - dd;
  int f2 = a + b - cc - dd;
  int f3 = a - b - cc + dd;
  int ls = level_scale(qp % 6, 0, 0);
  int sh = qp / 6;
  out4[0] = ((f0 * ls) << sh) >> 5;
  out4[1] = ((f1 * ls) << sh) >> 5;
  out4[2] = ((f2 * ls) << sh) >> 5;
  out4[3] = ((f3 * ls) << sh) >> 5;
}

static inline int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// ---------------------------------------------------------------------------
// intra prediction (ops/intra.py scalar port); p layouts as documented there

static void predict_4x4(const int32_t *p /*13*/, int mode, int32_t *out /*16*/) {
  // _p4 semantics (ops/intra.py): P(x, -1) with x == -1 is the CORNER
  // sample p[0] (the DDR/VR/HD formulas reach x-1 = -1 on their first
  // column); left-column reads PL(-1) land on p[0] by construction.
#define PT(x) ((x) == -1 ? p[0] : p[(x) + 5])
#define PL(y) p[(y) + 1]
#define PC p[0]
  switch (mode) {
    case 0:  // V
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) out[y * 4 + x] = PT(x);
      break;
    case 1:  // H
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) out[y * 4 + x] = PL(y);
      break;
    case 2: {  // DC
      int top4 = PT(0) + PT(1) + PT(2) + PT(3);
      int left4 = PL(0) + PL(1) + PL(2) + PL(3);
      int v;
      if (PC != -1) v = (top4 + left4 + 4) >> 3;
      else if (PL(0) != -1) v = (left4 + 2) >> 2;
      else if (PT(0) != -1) v = (top4 + 2) >> 2;
      else v = 128;
      for (int i = 0; i < 16; i++) out[i] = v;
      break;
    }
    case 3:  // DDL
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int v;
          if (x == 3 && y == 3) v = (PT(6) + 3 * PT(7) + 2) >> 2;
          else v = (PT(x + y) + (PT(x + y + 1) << 1) + PT(x + y + 2) + 2) >> 2;
          out[y * 4 + x] = v;
        }
      break;
    case 4:  // DDR
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int v;
          if (x > y)
            v = (PT(x - y - 2) + (PT(x - y - 1) << 1) + PT(x - y) + 2) >> 2;
          else if (x < y)
            v = (PL(y - x - 2) + (PL(y - x - 1) << 1) + PL(y - x) + 2) >> 2;
          else
            v = (PT(0) + (PC << 1) + PL(0) + 2) >> 2;
          out[y * 4 + x] = v;
        }
      break;
    case 5:  // VR
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int z = 2 * x - y, v;
          if (z >= 0 && (z & 1) == 0)
            v = (PT(x - (y >> 1) - 1) + PT(x - (y >> 1)) + 1) >> 1;
          else if (z >= 1 && (z & 1) == 1)
            v = (PT(x - (y >> 1) - 2) + (PT(x - (y >> 1) - 1) << 1)
                 + PT(x - (y >> 1)) + 2) >> 2;
          else if (z == -1)
            v = (PL(0) + (PC << 1) + PT(0) + 2) >> 2;
          else
            v = (PL(y - 1) + (PL(y - 2) << 1) + PL(y - 3) + 2) >> 2;
          out[y * 4 + x] = v;
        }
      break;
    case 6:  // HD
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int z = 2 * y - x, v;
          if (z >= 0 && (z & 1) == 0)
            v = (PL(y - (x >> 1) - 1) + PL(y - (x >> 1)) + 1) >> 1;
          else if (z >= 1 && (z & 1) == 1)
            v = (PL(y - (x >> 1) - 2) + (PL(y - (x >> 1) - 1) << 1)
                 + PL(y - (x >> 1)) + 2) >> 2;
          else if (z == -1)
            v = (PL(0) + (PC << 1) + PT(0) + 2) >> 2;
          else
            v = (PT(x - 1) + (PT(x - 2) << 1) + PT(x - 3) + 2) >> 2;
          out[y * 4 + x] = v;
        }
      break;
    case 7:  // VL
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int v;
          if ((y & 1) == 0)
            v = (PT(x + (y >> 1)) + PT(x + (y >> 1) + 1) + 1) >> 1;
          else
            v = (PT(x + (y >> 1)) + (PT(x + (y >> 1) + 1) << 1)
                 + PT(x + (y >> 1) + 2) + 2) >> 2;
          out[y * 4 + x] = v;
        }
      break;
    default:  // 8 HU
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int z = x + 2 * y, v;
          if (z == 0 || z == 2 || z == 4)
            v = (PL(y + (x >> 1)) + PL(y + (x >> 1) + 1) + 1) >> 1;
          else if (z == 1 || z == 3)
            v = (PL(y + (x >> 1)) + (PL(y + (x >> 1) + 1) << 1)
                 + PL(y + (x >> 1) + 2) + 2) >> 2;
          else if (z == 5)
            v = (PL(2) + 3 * PL(3) + 2) >> 2;
          else
            v = PL(3);
          out[y * 4 + x] = v;
        }
      break;
  }
#undef PT
#undef PL
#undef PC
}

static void predict_16x16(const int32_t *p /*33*/, int mode,
                          int32_t *out /*256*/) {
  const int32_t *left = p + 1, *top = p + 17;
  if (mode == 0) {
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++) out[y * 16 + x] = top[x];
  } else if (mode == 1) {
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++) out[y * 16 + x] = left[y];
  } else if (mode == 2) {
    int st = 0, sl = 0;
    for (int i = 0; i < 16; i++) { st += top[i]; sl += left[i]; }
    int v;
    if (p[0] != -1) v = (st + sl + 16) >> 5;
    else if (left[0] != -1) v = (sl + 8) >> 4;
    else if (top[0] != -1) v = (st + 8) >> 4;
    else v = 128;
    for (int i = 0; i < 256; i++) out[i] = v;
  } else {
    // plane: tfull[0]=corner, tfull[1+i]=top[i]; h = sum (i+1)*(tfull[9+i]-tfull[7-i])
    int32_t tfull[17], lfull[17];
    tfull[0] = p[0]; lfull[0] = p[0];
    for (int i = 0; i < 16; i++) { tfull[1 + i] = top[i]; lfull[1 + i] = left[i]; }
    int h = 0, v = 0;
    for (int i = 0; i < 8; i++) {
      h += (i + 1) * (tfull[9 + i] - tfull[7 - i]);
      v += (i + 1) * (lfull[9 + i] - lfull[7 - i]);
    }
    int a = (left[15] + top[15]) << 4;
    int b = (5 * h + 32) >> 6;
    int c = (5 * v + 32) >> 6;
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++)
        out[y * 16 + x] = clip255((a + b * (x - 7) + c * (y - 7) + 16) >> 5);
  }
}

static void predict_chroma(const int32_t *p /*17*/, int mode,
                           int32_t *out /*64*/) {
  const int32_t *left = p + 1, *top = p + 9;
  if (mode == 1) {
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) out[y * 8 + x] = left[y];
  } else if (mode == 2) {
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) out[y * 8 + x] = top[x];
  } else if (mode == 0) {
    for (int blk = 0; blk < 4; blk++) {
      int x0 = (blk & 1) << 2, y0 = (blk >> 1) << 2;
      int sx = top[x0] + top[x0 + 1] + top[x0 + 2] + top[x0 + 3];
      int sy = left[y0] + left[y0 + 1] + left[y0 + 2] + left[y0 + 3];
      int la = left[y0] != -1, ta = top[x0] != -1;
      int r;
      if (blk == 0 || blk == 3) {
        if (la && ta) r = (sx + sy + 4) >> 3;
        else if (la) r = (sy + 2) >> 2;
        else if (ta) r = (sx + 2) >> 2;
        else r = 128;
      } else if (blk == 1) {
        if (ta) r = (sx + 2) >> 2;
        else if (la) r = (sy + 2) >> 2;
        else r = 128;
      } else {
        if (la) r = (sy + 2) >> 2;
        else if (ta) r = (sx + 2) >> 2;
        else r = 128;
      }
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) out[(y0 + y) * 8 + x0 + x] = r;
    }
  } else {
    int32_t tfull[9], lfull[9];
    tfull[0] = p[0]; lfull[0] = p[0];
    for (int i = 0; i < 8; i++) { tfull[1 + i] = top[i]; lfull[1 + i] = left[i]; }
    int h = 0, v = 0;
    for (int i = 0; i < 4; i++) {
      h += (i + 1) * (tfull[5 + i] - tfull[3 - i]);
      v += (i + 1) * (lfull[5 + i] - lfull[3 - i]);
    }
    int a = (left[7] + top[7]) << 4;
    int b = (34 * h + 32) >> 6;
    int c = (34 * v + 32) >> 6;
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++)
        out[y * 8 + x] = clip255((a + b * (x - 3) + c * (y - 3) + 16) >> 5);
  }
}

// ---------------------------------------------------------------------------
// motion compensation (ops/mc.py window path)

static inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

static void fetch_win(const int32_t *plane, int W, int H, int x0, int y0,
                      int w, int h, int32_t *out) {
  for (int y = 0; y < h; y++) {
    int sy = clampi(y0 + y, 0, H - 1);
    const int32_t *row = plane + (long)sy * W;
    for (int x = 0; x < w; x++) out[y * w + x] = row[clampi(x0 + x, 0, W - 1)];
  }
}

static inline int tap6(int e, int f, int g, int h, int i, int j) {
  return clip255((e - 5 * f + 20 * g + 20 * h - 5 * i + j + 16) >> 5);
}

static inline int middle(int a, int b) { return (a + b + 1) >> 1; }

// win: 9x9, [2][2] = integer origin; out 4x4 (mocomp.cpp:50-78 semantics,
// clipped intermediates chained for the center positions)
static void interp_luma(const int32_t *win, int frac, int32_t *out) {
#define PW(dx, dy) win[(2 + (dy) + yy) * 9 + 2 + (dx) + xx]
  for (int yy = 0; yy < 4; yy++)
    for (int xx = 0; xx < 4; xx++) {
      int G = PW(0, 0);
      if (frac == 0) { out[yy * 4 + xx] = G; continue; }
      int b = 0, h = 0, m = 0, s = 0, j = 0;
      static const uint16_t NEED_B = (1 << 1) | (1 << 2) | (1 << 3)
                                     | (1 << 5) | (1 << 6) | (1 << 7);
      static const uint16_t NEED_H = (1 << 4) | (1 << 5) | (1 << 8)
                                     | (1 << 9) | (1 << 12) | (1 << 13);
      static const uint16_t NEED_J = (1 << 6) | (1 << 9) | (1 << 10)
                                     | (1 << 11) | (1 << 14);
      static const uint16_t NEED_M = NEED_J | (1 << 7) | (1 << 15);
      static const uint16_t NEED_S = (1 << 13) | (1 << 14) | (1 << 15);
      uint16_t f = 1u << frac;
      if (f & NEED_B)
        b = tap6(PW(-2, 0), PW(-1, 0), G, PW(1, 0), PW(2, 0), PW(3, 0));
      if (f & (NEED_H | NEED_J))
        h = tap6(PW(0, -2), PW(0, -1), G, PW(0, 1), PW(0, 2), PW(0, 3));
      if (f & NEED_M)
        m = tap6(PW(1, -2), PW(1, -1), PW(1, 0), PW(1, 1), PW(1, 2),
                 PW(1, 3));
      if (f & NEED_S)
        s = tap6(PW(-2, 1), PW(-1, 1), PW(0, 1), PW(1, 1), PW(2, 1),
                 PW(3, 1));
      if (f & NEED_J) {
        int cc = tap6(PW(-2, -2), PW(-2, -1), PW(-2, 0), PW(-2, 1),
                      PW(-2, 2), PW(-2, 3));
        int dd = tap6(PW(-1, -2), PW(-1, -1), PW(-1, 0), PW(-1, 1),
                      PW(-1, 2), PW(-1, 3));
        int ee = tap6(PW(2, -2), PW(2, -1), PW(2, 0), PW(2, 1), PW(2, 2),
                      PW(2, 3));
        int ff = tap6(PW(3, -2), PW(3, -1), PW(3, 0), PW(3, 1), PW(3, 2),
                      PW(3, 3));
        j = tap6(cc, dd, h, m, ee, ff);
      }
      int v;
      switch (frac) {
        case 1: v = middle(G, b); break;
        case 2: v = b; break;
        case 3: v = middle(b, PW(1, 0)); break;
        case 4: v = middle(G, h); break;
        case 8: v = h; break;
        case 12: v = middle(h, PW(0, 1)); break;
        case 5: v = middle(b, h); break;
        case 7: v = middle(b, m); break;
        case 13: v = middle(h, s); break;
        case 15: v = middle(s, m); break;
        case 10: v = j; break;
        case 6: v = middle(b, j); break;
        case 9: v = middle(h, j); break;
        case 14: v = middle(j, s); break;
        default: v = middle(j, m); break;  // 11
      }
      out[yy * 4 + xx] = v;
    }
#undef PW
}

// ---------------------------------------------------------------------------
// decoder state (pointers into the Python-owned arrays)

struct Dec {
  int wmb, hmb, nmb, W, H;
  int32_t *y, *cb, *cr;
  const int32_t *ref_y, *ref_cb, *ref_cr;
  int32_t *mb_type, *tc_luma, *tc_chroma, *i4x4_mode, *mv, *num_parts;
  uint8_t *mb_intra, *mb_i4x4;
  int32_t *stale_cac;  // (2*4*15)
  int qpy, mb_qp_delta;
  int chroma_qp_off, constrained_intra, spec_mode;
  int num_ref_override, num_ref_active, num_ref_minus1;
};

static const int MBSKIP = -2;

// --- nC (decoder.py _nc_pair) ---
static int luma_nbr_tab[16][4];
static int chroma_nbr_tab[4][4];
static int nbr_init = 0;

static void build_nbr() {
  if (nbr_init) return;
  for (int blk = 0; blk < 16; blk++) {
    int bx = BLK_XY[blk * 2] / 4, by = BLK_XY[blk * 2 + 1] / 4;
    luma_nbr_tab[blk][0] = bx > 0;
    luma_nbr_tab[blk][1] = RASTER_TO_Z[by * 4 + ((bx - 1) & 3)];
    luma_nbr_tab[blk][2] = by > 0;
    luma_nbr_tab[blk][3] = RASTER_TO_Z[((by - 1) & 3) * 4 + bx];
  }
  for (int blk = 0; blk < 4; blk++) {
    int bx = blk % 2, by = blk / 2;
    chroma_nbr_tab[blk][0] = bx > 0;
    chroma_nbr_tab[blk][1] = by * 2 + ((bx - 1) & 1);
    chroma_nbr_tab[blk][2] = by > 0;
    chroma_nbr_tab[blk][3] = ((by - 1) & 1) * 2 + bx;
  }
  nbr_init = 1;
}

static int nc_pair(Dec *D, int curr, const int *nb, const int32_t *tc,
                   int stride) {
  int left_edge = curr % D->wmb == 0, top_edge = curr < D->wmb;
  int hasA = 0, hasB = 0, nA = 0, nB = 0;
  if (nb[0]) { hasA = 1; nA = tc[(long)curr * stride + nb[1]]; }
  else if (!left_edge) { hasA = 1; nA = tc[(long)(curr - 1) * stride + nb[1]]; }
  if (nb[2]) { hasB = 1; nB = tc[(long)curr * stride + nb[3]]; }
  else if (!top_edge) { hasB = 1; nB = tc[(long)(curr - D->wmb) * stride + nb[3]]; }
  if (hasA && hasB) return (nA + nB + 1) >> 1;
  if (hasA) return nA;
  if (hasB) return nB;
  return 0;
}

static int nc_luma(Dec *D, int curr, int blk) {
  return nc_pair(D, curr, luma_nbr_tab[blk], D->tc_luma, 16);
}

static int nc_chroma(Dec *D, int curr, int c, int blk) {
  return nc_pair(D, curr, chroma_nbr_tab[blk], D->tc_chroma + (long)c * D->nmb * 4,
                 4);
}

// --- mvpred (codec/mvpred.py port) ---

static int part_idx_of(Dec *D, int addr, int xw, int yw) {
  int t = D->mb_type[addr];
  if (t == MBSKIP || D->mb_intra[addr]) return 0;
  static const int PW_[5] = {16, 16, 8, 8, 8};
  static const int PH_[5] = {16, 8, 16, 8, 8};
  return ((yw / PH_[t]) << 1) + (xw / PW_[t]);
}

// returns 1 + fills addr/xw/yw, or 0 when unavailable
static int locate(Dec *D, int curr, int xn, int yn, int *addr, int *xw,
                  int *yw) {
  if (xn > 15 && yn >= 0) return 0;
  if (yn > 15) return 0;
  int wmb = D->wmb;
  if (xn >= 0 && xn < 16 && yn >= 0) { *addr = curr; *xw = xn; *yw = yn; return 1; }
  if (xn >= 0 && xn < 16) {  // above
    if (curr < wmb) return 0;
    *addr = curr - wmb; *xw = xn; *yw = yn + 16; return 1;
  }
  if (xn > 15) {  // above-right
    if (curr < wmb) return 0;
    int a = curr - wmb + 1;
    if (a % wmb == 0) return 0;
    *addr = a; *xw = xn - 16; *yw = yn + 16; return 1;
  }
  if (yn < 0) {  // above-left
    if (curr < wmb || curr % wmb == 0) return 0;
    *addr = curr - wmb - 1; *xw = xn + 16; *yw = yn + 16; return 1;
  }
  if (curr % wmb == 0) return 0;
  *addr = curr - 1; *xw = xn + 16; *yw = yn; return 1;
}

static void neighbor_mv(Dec *D, int addr, int pidx, int *mvx, int *mvy,
                        int *ref) {
  if (D->mb_intra[addr]) { *mvx = 0; *mvy = 0; *ref = -1; return; }
  const int32_t *m = D->mv + ((long)addr * 4 + pidx) * 4 * 2;
  *mvx = m[0]; *mvy = m[1]; *ref = 0;
}

static void predict_mv_luma(Dec *D, int curr, int mb_type, int num_parts,
                            int part_idx, const int *sub_mb_type, int *px,
                            int *py) {
  int x, y;
  if (num_parts == 1) { x = 0; y = 0; }
  else if (mb_type == 1) { x = 0; y = 8 * part_idx; }
  else if (mb_type == 2) { x = 8 * part_idx; y = 0; }
  else { x = 8 * (part_idx & 1); y = 8 * (part_idx >> 1); }
  int ppw = 16;
  if (mb_type == 3 || mb_type == 4)
    ppw = (sub_mb_type && (sub_mb_type[part_idx] == 2
                           || sub_mb_type[part_idx] == 3)) ? 4 : 8;
  if (mb_type == 2) ppw = 8;

  int have[3] = {0, 0, 0};
  int mvx[3], mvy[3], refn[3] = {-1, -1, -1};
  int coords[3][2] = {{x - 1, y}, {x, y - 1}, {x + ppw, y - 1}};
  for (int i = 0; i < 3; i++) {
    int a, xw, yw;
    int ok = locate(D, curr, coords[i][0], coords[i][1], &a, &xw, &yw);
    if (i == 2 && !ok)
      ok = locate(D, curr, x - 1, y - 1, &a, &xw, &yw);
    if (ok) {
      int pidx = part_idx_of(D, a, xw, yw);
      neighbor_mv(D, a, pidx, &mvx[i], &mvy[i], &refn[i]);
      have[i] = 1;
    }
  }

  if (mb_type == 3 || mb_type == 4) {
    int s0 = sub_mb_type ? sub_mb_type[0] : 0;
    if (s0 == 1 && have[1] && refn[1] == 0) { *px = mvx[1]; *py = mvy[1]; return; }
    if (s0 == 2 && have[0] && refn[0] == 0) { *px = mvx[0]; *py = mvy[0]; return; }
  } else {
    if (mb_type == 1 && part_idx == 0 && have[1] && refn[1] == 0) {
      *px = mvx[1]; *py = mvy[1]; return;
    }
    if (mb_type == 1 && part_idx == 1 && have[0] && refn[0] == 0) {
      *px = mvx[0]; *py = mvy[0]; return;
    }
    if (mb_type == 2 && part_idx == 0 && have[0] && refn[0] == 0) {
      *px = mvx[0]; *py = mvy[0]; return;
    }
    if (mb_type == 2 && part_idx == 1 && have[2] && refn[2] == 0) {
      *px = mvx[2]; *py = mvy[2]; return;
    }
  }

  if (!have[0] && !have[1]) { have[0] = 1; mvx[0] = 0; mvy[0] = 0; refn[0] = 0; }
  if (!have[0] && have[1]) { have[0] = 1; mvx[0] = 0; mvy[0] = 0; refn[0] = -1; }
  if (!have[1]) { have[1] = 1; mvx[1] = mvx[0]; mvy[1] = mvy[0]; refn[1] = refn[0]; }
  if (!have[2]) { have[2] = 1; mvx[2] = mvx[0]; mvy[2] = mvy[0]; refn[2] = refn[0]; }

  int m0 = refn[0] == 0, m1 = refn[1] == 0, m2 = refn[2] == 0;
  if (m0 && !m1 && !m2) { *px = mvx[0]; *py = mvy[0]; return; }
  if (!m0 && m1 && !m2) { *px = mvx[1]; *py = mvy[1]; return; }
  if (!m0 && !m1 && m2) { *px = mvx[2]; *py = mvy[2]; return; }
#define MED3(a, b, c) \
  ((a) > (b) ? ((b) > (c) ? (b) : ((a) > (c) ? (c) : (a))) \
             : ((a) > (c) ? (a) : ((b) > (c) ? (c) : (b))))
  *px = MED3(mvx[0], mvx[1], mvx[2]);
  *py = MED3(mvy[0], mvy[1], mvy[2]);
#undef MED3
}

static int skip_nbr_zero(Dec *D, int addr, int pidx) {
  if (D->mb_intra[addr]) return 0;
  const int32_t *m = D->mv + ((long)addr * 4 + pidx) * 4 * 2;
  return m[0] == 0 && m[1] == 0;
}

static void derive_skip_mv(Dec *D, int curr, int *px, int *py) {
  int wmb = D->wmb;
  if (curr < wmb || curr % wmb == 0) { *px = 0; *py = 0; return; }
  if (skip_nbr_zero(D, curr - wmb, 2) || skip_nbr_zero(D, curr - 1, 1)) {
    *px = 0; *py = 0; return;
  }
  predict_mv_luma(D, curr, 0, 1, 0, 0, px, py);
}

static void store_part_mvs(Dec *D, int curr, int mb_type, int num_parts,
                           const int32_t pm[4][2], int upto) {
  int32_t *mv = D->mv + (long)curr * 4 * 4 * 2;
  if (num_parts == 1) {
    for (int q = 0; q < 4; q++) { mv[q * 8] = pm[0][0]; mv[q * 8 + 1] = pm[0][1]; }
  } else if (mb_type == 1) {
    mv[0 * 8] = pm[0][0]; mv[0 * 8 + 1] = pm[0][1];
    mv[1 * 8] = pm[0][0]; mv[1 * 8 + 1] = pm[0][1];
    mv[2 * 8] = pm[1][0]; mv[2 * 8 + 1] = pm[1][1];
    mv[3 * 8] = pm[1][0]; mv[3 * 8 + 1] = pm[1][1];
  } else if (mb_type == 2) {
    mv[0 * 8] = pm[0][0]; mv[0 * 8 + 1] = pm[0][1];
    mv[2 * 8] = pm[0][0]; mv[2 * 8 + 1] = pm[0][1];
    mv[1 * 8] = pm[1][0]; mv[1 * 8 + 1] = pm[1][1];
    mv[3 * 8] = pm[1][0]; mv[3 * 8 + 1] = pm[1][1];
  } else {
    int n = upto + 1 < 4 ? upto + 1 : 4;
    for (int q = 0; q < n; q++) { mv[q * 8] = pm[q][0]; mv[q * 8 + 1] = pm[q][1]; }
  }
}

static void fan_out(Dec *D, int curr) {
  int32_t *mv = D->mv + (long)curr * 4 * 4 * 2;
  for (int q = 0; q < 4; q++)
    for (int j = 1; j < 4; j++) {
      mv[(q * 4 + j) * 2] = mv[q * 8];
      mv[(q * 4 + j) * 2 + 1] = mv[q * 8 + 1];
    }
}

// --- MC for a full MB (mc.py mc_macroblock window path) ---

static void mc_mb(Dec *D, int curr, int32_t *pl /*256*/, int32_t *pcb /*64*/,
                  int32_t *pcr /*64*/) {
  int mbx = curr % D->wmb, mby = curr / D->wmb;
  const int32_t *mv = D->mv + (long)curr * 4 * 4 * 2;
  for (int sub = 0; sub < 4; sub++)
    for (int part = 0; part < 4; part++) {
      int org_y = ((sub & 2) << 2) + ((part & 2) << 1);
      int org_x = ((sub & 1) << 3) + ((part & 1) << 2);
      int mvx = mv[(sub * 4 + part) * 2];
      int mvy = mv[(sub * 4 + part) * 2 + 1];
      int x_al = mbx * 16 + org_x, y_al = mby * 16 + org_y;
      int32_t win[81];
      fetch_win(D->ref_y, D->W, D->H, x_al + (mvx >> 2) - 2,
                y_al + (mvy >> 2) - 2, 9, 9, win);
      int frac = ((mvy & 3) << 2) | (mvx & 3);
      int32_t blk[16];
      interp_luma(win, frac, blk);
      for (int yy = 0; yy < 4; yy++)
        for (int xx = 0; xx < 4; xx++)
          pl[(org_y + yy) * 16 + org_x + xx] = blk[yy * 4 + xx];
      // chroma 2x2 per plane
      int cx = x_al / 2 + (mvx >> 3), cy = y_al / 2 + (mvy >> 3);
      int fx = mvx & 7, fy = mvy & 7;
      const int32_t *cpl[2] = {D->ref_cb, D->ref_cr};
      int32_t *out2[2] = {pcb, pcr};
      for (int c = 0; c < 2; c++) {
        int32_t w3[9];
        fetch_win(cpl[c], D->W / 2, D->H / 2, cx, cy, 3, 3, w3);
        for (int yy = 0; yy < 2; yy++)
          for (int xx = 0; xx < 2; xx++) {
            int a = w3[yy * 3 + xx], b = w3[yy * 3 + xx + 1];
            int cc = w3[(yy + 1) * 3 + xx], dd = w3[(yy + 1) * 3 + xx + 1];
            out2[c][(org_y / 2 + yy) * 8 + org_x / 2 + xx] =
                ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
                 + (8 - fx) * fy * cc + fx * fy * dd + 32) >> 6;
          }
      }
    }
}

// --- reconstruction ---

static void recon_chroma(Dec *D, int curr, const int32_t *pcb,
                         const int32_t *pcr, const int32_t *cdc /*2x4*/,
                         const int32_t *cac /*2x4x15*/) {
  int x0 = (curr % D->wmb) * 16, y0 = (curr / D->wmb) * 16;
  int cw = D->W / 2;
  int any = 0;
  for (int i = 0; i < 8 && !any; i++) any |= cdc[i] != 0;
  for (int i = 0; i < 2 * 4 * 15 && !any; i++) any |= cac[i] != 0;
  int32_t *pls[2] = {D->cb, D->cr};
  const int32_t *prd[2] = {pcb, pcr};
  if (!any) {
    for (int c = 0; c < 2; c++)
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++)
          pls[c][(long)(y0 / 2 + y) * cw + x0 / 2 + x] = prd[c][y * 8 + x];
    return;
  }
  int qpc = QPC_TAB[clampi(D->qpy + D->chroma_qp_off, 0, 51)];
  for (int c = 0; c < 2; c++) {
    int32_t dcv[4];
    inverse_dc_chroma(cdc + c * 4, qpc, dcv);
    int32_t rmb[64];
    for (int blk = 0; blk < 4; blk++) {
      int32_t lst[16];
      lst[0] = dcv[blk];
      for (int i = 0; i < 15; i++) lst[1 + i] = cac[(c * 4 + blk) * 15 + i];
      int32_t res[16];
      inverse_residual_zz(lst, qpc, 1, res);
      int bx = (blk % 2) * 4, by = (blk / 2) * 4;
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++)
          rmb[(by + y) * 8 + bx + x] = res[y * 4 + x];
    }
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++)
        pls[c][(long)(y0 / 2 + y) * cw + x0 / 2 + x] =
            clip255(prd[c][y * 8 + x] + rmb[y * 8 + x]);
  }
}

static void recon_inter(Dec *D, int curr, const int32_t *pl,
                        const int32_t *pcb, const int32_t *pcr,
                        const int32_t *luma_levels /*16x16*/, int cbp_luma,
                        const int32_t *cdc, const int32_t *cac) {
  int x0 = (curr % D->wmb) * 16, y0 = (curr / D->wmb) * 16;
  int W = D->W;
  int any = 0;
  if (cbp_luma)
    for (int i = 0; i < 256 && !any; i++) any |= luma_levels[i] != 0;
  if (!any) {
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++)
        D->y[(long)(y0 + y) * W + x0 + x] = pl[y * 16 + x];
  } else {
    for (int blk = 0; blk < 16; blk++) {
      int32_t res[16];
      inverse_residual_zz(luma_levels + blk * 16, D->qpy, 0, res);
      int bx = BLK_XY[blk * 2], by = BLK_XY[blk * 2 + 1];
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++)
          D->y[(long)(y0 + by + y) * W + x0 + bx + x] =
              clip255(pl[(by + y) * 16 + bx + x] + res[y * 4 + x]);
    }
  }
  recon_chroma(D, curr, pcb, pcr, cdc, cac);
}

static void fetch_p13(Dec *D, int curr, int blk, int32_t *p) {
  int x0 = (curr % D->wmb) * 16, y0 = (curr / D->wmb) * 16;
  int bx = BLK_XY[blk * 2], by = BLK_XY[blk * 2 + 1];
  int x = x0 + bx, y = y0 + by;
  int W = D->W;
  for (int i = 0; i < 13; i++) p[i] = -1;
  if (x > 0 && y > 0) p[0] = D->y[(long)(y - 1) * W + x - 1];
  if (x > 0)
    for (int i = 0; i < 4; i++) p[1 + i] = D->y[(long)(y + i) * W + x - 1];
  if (y > 0) {
    for (int i = 0; i < 4; i++) p[5 + i] = D->y[(long)(y - 1) * W + x + i];
    int xf = x + 4;
    int edge = (xf >= W) || (bx == 12 && by > 0);
    if (edge || blk == 3 || blk == 11) {
      for (int i = 0; i < 4; i++) p[9 + i] = D->y[(long)(y - 1) * W + x + 3];
    } else {
      for (int i = 0; i < 4; i++) p[9 + i] = D->y[(long)(y - 1) * W + xf + i];
    }
  }
}

static int derive_i4x4_mode(Dec *D, int curr, int blk, int prev_flag, int rem) {
  const int *nb = luma_nbr_tab[blk];
  int left_edge = curr % D->wmb == 0, top_edge = curr < D->wmb;
  int hasA = 0, hasB = 0, mode_a = 0, mode_b = 0;
  if (nb[0]) { hasA = 1; mode_a = D->i4x4_mode[(long)curr * 16 + nb[1]]; }
  else if (!left_edge) {
    hasA = 1;
    int addr = curr - 1;
    mode_a = D->mb_i4x4[addr] ? D->i4x4_mode[(long)addr * 16 + nb[1]] : 2;
  }
  if (nb[2]) { hasB = 1; mode_b = D->i4x4_mode[(long)curr * 16 + nb[3]]; }
  else if (!top_edge) {
    hasB = 1;
    int addr = curr - D->wmb;
    mode_b = D->mb_i4x4[addr] ? D->i4x4_mode[(long)addr * 16 + nb[3]] : 2;
  }
  if (!hasA || !hasB || D->constrained_intra) { mode_a = 2; mode_b = 2; }
  int pred = mode_a < mode_b ? mode_a : mode_b;
  if (prev_flag) return pred;
  return rem < pred ? rem : rem + 1;
}

static void recon_intra(Dec *D, int curr, int is_i4x4, int i16_mode,
                        const int *prev_flag, const int *rem_mode,
                        int chroma_mode, const int32_t *i16dc,
                        const int32_t *luma_levels, const int32_t *cdc,
                        const int32_t *cac, int cbp_luma) {
  int x0 = (curr % D->wmb) * 16, y0 = (curr / D->wmb) * 16;
  int W = D->W;
  if (is_i4x4) {
    for (int blk = 0; blk < 16; blk++) {
      int mode = derive_i4x4_mode(D, curr, blk, prev_flag[blk],
                                  rem_mode[blk]);
      D->i4x4_mode[(long)curr * 16 + blk] = mode;
      int32_t p[13], pred[16], res[16];
      fetch_p13(D, curr, blk, p);
      predict_4x4(p, mode, pred);
      inverse_residual_zz(luma_levels + blk * 16, D->qpy, 0, res);
      int bx = BLK_XY[blk * 2], by = BLK_XY[blk * 2 + 1];
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++)
          D->y[(long)(y0 + by + y) * W + x0 + bx + x] =
              clip255(pred[y * 4 + x] + res[y * 4 + x]);
    }
  } else {
    int32_t p[33];
    for (int i = 0; i < 33; i++) p[i] = -1;
    if (x0 > 0 && y0 > 0) p[0] = D->y[(long)(y0 - 1) * W + x0 - 1];
    if (x0 > 0)
      for (int i = 0; i < 16; i++) p[1 + i] = D->y[(long)(y0 + i) * W + x0 - 1];
    if (y0 > 0)
      for (int i = 0; i < 16; i++) p[17 + i] = D->y[(long)(y0 - 1) * W + x0 + i];
    int32_t pred[256];
    predict_16x16(p, i16_mode, pred);
    int32_t dcv[16];
    inverse_dc_luma(i16dc, D->qpy, dcv);
    for (int blk = 0; blk < 16; blk++) {
      int bx = BLK_XY[blk * 2], by = BLK_XY[blk * 2 + 1];
      int32_t lst[16];
      lst[0] = dcv[(by >> 2) * 4 + (bx >> 2)];
      for (int i = 0; i < 15; i++) lst[1 + i] = luma_levels[blk * 16 + i];
      int32_t res[16];
      inverse_residual_zz(lst, D->qpy, 1, res);
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++)
          D->y[(long)(y0 + by + y) * W + x0 + bx + x] =
              clip255(pred[(by + y) * 16 + bx + x] + res[y * 4 + x]);
    }
  }
  // chroma
  int cw = D->W / 2;
  int cx0 = x0 / 2, cy0 = y0 / 2;
  int32_t pcb[64], pcr[64];
  int32_t *pls[2] = {D->cb, D->cr};
  int32_t *out2[2] = {pcb, pcr};
  for (int c = 0; c < 2; c++) {
    int32_t p[17];
    for (int i = 0; i < 17; i++) p[i] = -1;
    if (cx0 > 0 && cy0 > 0) p[0] = pls[c][(long)(cy0 - 1) * cw + cx0 - 1];
    if (cx0 > 0)
      for (int i = 0; i < 8; i++) p[1 + i] = pls[c][(long)(cy0 + i) * cw + cx0 - 1];
    if (cy0 > 0)
      for (int i = 0; i < 8; i++) p[9 + i] = pls[c][(long)(cy0 - 1) * cw + cx0 + i];
    predict_chroma(p, chroma_mode, out2[c]);
  }
  recon_chroma(D, curr, pcb, pcr, cdc, cac);
}

// --- residual parse (decoder.py _parse_residual) ---

static int parse_residual(Dec *D, Reader *r, int curr, int is_i16,
                          int cbp_luma, int cbp_chroma, int32_t *i16dc,
                          int32_t *luma_levels, int32_t *cdc, int32_t *cac) {
  if (is_i16) {
    int tc = decode_block(r, nc_luma(D, curr, 0), 16, i16dc);
    if (tc < 0) return -1;
    if (tc > 16) return -2;
    D->tc_luma[(long)curr * 16 + 0] = tc;
  }
  for (int i8 = 0; i8 < 4; i8++)
    for (int i4 = 0; i4 < 4; i4++) {
      int blk = i8 * 4 + i4;
      if (cbp_luma & (1 << i8)) {
        int tc;
        if (is_i16) {
          int32_t tmp[15];
          for (int i = 0; i < 15; i++) tmp[i] = 0;
          tc = decode_block(r, nc_luma(D, curr, blk), 15, tmp);
          if (tc < 0) return -1;
          for (int i = 0; i < 15; i++) luma_levels[blk * 16 + i] = tmp[i];
        } else {
          tc = decode_block(r, nc_luma(D, curr, blk), 16,
                            luma_levels + blk * 16);
          if (tc < 0) return -1;
        }
        if (tc > 16) return -2;
        D->tc_luma[(long)curr * 16 + blk] = tc;
      } else {
        D->tc_luma[(long)curr * 16 + blk] = 0;
      }
    }
  for (int c = 0; c < 2; c++)
    if (cbp_chroma & 3) {
      int tc = decode_block(r, -1, 4, cdc + c * 4);
      if (tc < 0) return -1;
    }
  for (int c = 0; c < 2; c++)
    for (int blk = 0; blk < 4; blk++) {
      long ti = (long)c * D->nmb * 4 + (long)curr * 4 + blk;
      if (cbp_chroma & 2) {
        int32_t tmp[15];
        for (int i = 0; i < 15; i++) tmp[i] = 0;
        int tc = decode_block(r, nc_chroma(D, curr, c, blk), 15, tmp);
        if (tc < 0) return -1;
        if (tc > 16) return -2;
        for (int i = 0; i < 15; i++) cac[(c * 4 + blk) * 15 + i] = tmp[i];
        D->tc_chroma[ti] = tc;
      } else {
        for (int i = 0; i < 15; i++) cac[(c * 4 + blk) * 15 + i] = 0;
        D->tc_chroma[ti] = 0;
      }
    }
  return 0;
}

// --- per-MB decode (decoder.py _decode_skip_mb / _decode_mb) ---

static void decode_skip_mb(Dec *D, int curr) {
  D->mb_type[curr] = MBSKIP;
  D->mb_intra[curr] = 0;
  D->mb_i4x4[curr] = 0;
  D->num_parts[curr] = 1;
  for (int i = 0; i < 16; i++) D->tc_luma[(long)curr * 16 + i] = 0;
  for (int c = 0; c < 2; c++)
    for (int i = 0; i < 4; i++)
      D->tc_chroma[(long)c * D->nmb * 4 + (long)curr * 4 + i] = 0;
  int px, py;
  derive_skip_mv(D, curr, &px, &py);
  int32_t *mv = D->mv + (long)curr * 4 * 4 * 2;
  for (int i = 0; i < 16; i++) { mv[i * 2] = px; mv[i * 2 + 1] = py; }
  int32_t pl[256], pcb[64], pcr[64];
  mc_mb(D, curr, pl, pcb, pcr);
  D->qpy = ((D->qpy + D->mb_qp_delta) % 52 + 52) % 52;
  static const int32_t zero240[2 * 4 * 15] = {0};
  static const int32_t zero8[8] = {0};
  recon_inter(D, curr, pl, pcb, pcr, 0, 0, zero8, zero240);
}

// returns 0 ok, negative = error code
static int decode_mb(Dec *D, Reader *r, int curr, int slice_type) {
  int mb_type = read_ue(r);
  if (mb_type > 31 || (slice_type % 5 == 2 && mb_type > 24)) return -3;
  int is_p = slice_type % 5 == 0;
  int is_intra, is_i4x4 = 0, is_i16 = 0, i16_mode = 0;
  int cbp_luma_fixed = -1, cbp_chroma_fixed = -1;
  int num_parts = 1;
  if (is_p && mb_type < 5) {
    is_intra = 0;
    static const int NP[5] = {1, 2, 2, 4, 4};
    num_parts = NP[mb_type];
  } else {
    int it = is_p ? mb_type - 5 : mb_type;
    is_intra = 1;
    if (it == 0) is_i4x4 = 1;
    else if (it == 25) return -4;  // I_PCM
    else {
      is_i16 = 1;
      int n = it - 1;
      i16_mode = n % 4;
      cbp_chroma_fixed = (n / 4) % 3;
      cbp_luma_fixed = n >= 12 ? 15 : 0;
    }
  }
  D->mb_type[curr] = mb_type;
  D->mb_intra[curr] = is_intra;
  D->mb_i4x4[curr] = is_i4x4;
  D->num_parts[curr] = num_parts;

  int sub_mb_type[4] = {0, 0, 0, 0};
  int32_t mvd[4][2];
  for (int i = 0; i < 4; i++) { mvd[i][0] = 0; mvd[i][1] = 0; }
  int prev_flag[16], rem_mode[16];
  for (int i = 0; i < 16; i++) { prev_flag[i] = 0; rem_mode[i] = 0; }
  int chroma_mode = 0;

  if (!is_intra && num_parts == 4) {
    for (int p = 0; p < 4; p++) sub_mb_type[p] = read_ue(r);
    for (int p = 0; p < 4; p++)
      if (D->num_ref_override > 0 && mb_type != 4)
        read_te(r, D->num_ref_active);
    static const int SUBNP[4] = {1, 2, 2, 4};
    for (int p = 0; p < 4; p++) {
      int sn = sub_mb_type[p] >= 0 && sub_mb_type[p] < 4
                   ? SUBNP[sub_mb_type[p]] : 4;
      for (int sp = 0; sp < sn; sp++) {
        int dx = read_se(r), dy = read_se(r);
        if (sp == 0) { mvd[p][0] = dx; mvd[p][1] = dy; }
      }
    }
  } else if (is_intra) {
    if (is_i4x4) {
      for (int b = 0; b < 16; b++) {
        prev_flag[b] = rd_bit(r);
        if (!prev_flag[b]) rem_mode[b] = (int)rd_read(r, 3);
      }
    }
    chroma_mode = read_ue(r);
    if (chroma_mode > 3) return -5;
  } else {
    for (int p = 0; p < num_parts; p++)
      if (D->num_ref_minus1 > 0) read_te(r, D->num_ref_active);
    for (int p = 0; p < num_parts; p++) {
      mvd[p][0] = read_se(r);
      mvd[p][1] = read_se(r);
    }
  }

  int cbp_luma, cbp_chroma;
  if (!is_i16) {
    int code_num = read_ue(r);
    if (code_num > 47) return -6;
    int cbp = is_i4x4 ? CBP_INTRA[code_num] : CBP_INTER[code_num];
    cbp_luma = cbp & 15;
    cbp_chroma = cbp >> 4;
  } else {
    cbp_luma = cbp_luma_fixed;
    cbp_chroma = cbp_chroma_fixed;
  }

  int32_t i16dc[16] = {0};
  int32_t luma_levels[16 * 16];
  for (int i = 0; i < 256; i++) luma_levels[i] = 0;
  int32_t cdc[8] = {0};
  if (cbp_luma > 0 || cbp_chroma > 0 || is_i16) {
    D->mb_qp_delta = read_se(r);
    if (!(-27 < D->mb_qp_delta && D->mb_qp_delta < 26)) return -7;
    int e = parse_residual(D, r, curr, is_i16, cbp_luma, cbp_chroma, i16dc,
                           luma_levels, cdc, D->stale_cac);
    if (e < 0) return e == -2 ? -8 : -9;
  } else {
    for (int i = 0; i < 16; i++) D->tc_luma[(long)curr * 16 + i] = 0;
    for (int c = 0; c < 2; c++)
      for (int i = 0; i < 4; i++)
        D->tc_chroma[(long)c * D->nmb * 4 + (long)curr * 4 + i] = 0;
    if (D->spec_mode)
      for (int i = 0; i < 2 * 4 * 15; i++) D->stale_cac[i] = 0;
  }

  D->qpy = ((D->qpy + D->mb_qp_delta) % 52 + 52) % 52;

  if (is_intra) {
    recon_intra(D, curr, is_i4x4, i16_mode, prev_flag, rem_mode, chroma_mode,
                i16dc, luma_levels, cdc, D->stale_cac, cbp_luma);
  } else {
    // derive MVs incrementally (decoder.py _derive_inter_mv)
    int32_t part_mv[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
    for (int p = 0; p < num_parts; p++) {
      int px, py;
      predict_mv_luma(D, curr, mb_type, num_parts, p,
                      num_parts == 4 ? sub_mb_type : 0, &px, &py);
      part_mv[p][0] = px + mvd[p][0];
      part_mv[p][1] = py + mvd[p][1];
      store_part_mvs(D, curr, mb_type, num_parts, part_mv, p);
    }
    store_part_mvs(D, curr, mb_type, num_parts, part_mv, num_parts - 1);
    fan_out(D, curr);
    int32_t pl[256], pcb[64], pcr[64];
    mc_mb(D, curr, pl, pcb, pcr);
    recon_inter(D, curr, pl, pcb, pcr, luma_levels, cbp_luma, cdc,
                D->stale_cac);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// whole-slice entry
//
// returns final bit position (>= 0) or a negative error code

long decode_slice(const uint8_t *rbsp, long nbytes, long bit_pos,
                  int slice_type, int qpy, int wmb, int hmb,
                  int chroma_qp_off, int constrained_intra,
                  int num_ref_override, int num_ref_active,
                  int num_ref_minus1, int spec_mode,
                  int32_t *mb_qp_delta_io, int32_t *stale_cac,
                  int32_t *y, int32_t *cb, int32_t *cr,
                  const int32_t *ref_y, const int32_t *ref_cb,
                  const int32_t *ref_cr,
                  int32_t *mb_type, int32_t *tc_luma, int32_t *tc_chroma,
                  int32_t *i4x4_mode, int32_t *mv, int32_t *num_parts,
                  uint8_t *mb_intra, uint8_t *mb_i4x4, int32_t *qpy_out) {
  build_nbr();
  Dec D;
  D.wmb = wmb; D.hmb = hmb; D.nmb = wmb * hmb;
  D.W = wmb * 16; D.H = hmb * 16;
  D.y = y; D.cb = cb; D.cr = cr;
  D.ref_y = ref_y; D.ref_cb = ref_cb; D.ref_cr = ref_cr;
  D.mb_type = mb_type; D.tc_luma = tc_luma; D.tc_chroma = tc_chroma;
  D.i4x4_mode = i4x4_mode; D.mv = mv; D.num_parts = num_parts;
  D.mb_intra = mb_intra; D.mb_i4x4 = mb_i4x4;
  D.stale_cac = stale_cac;
  D.qpy = qpy;
  D.mb_qp_delta = *mb_qp_delta_io;
  D.chroma_qp_off = chroma_qp_off;
  D.constrained_intra = constrained_intra;
  D.spec_mode = spec_mode;
  D.num_ref_override = num_ref_override;
  D.num_ref_active = num_ref_active;
  D.num_ref_minus1 = num_ref_minus1;

  Reader r;
  r.d = rbsp; r.nbytes = nbytes;
  r.byte = bit_pos >> 3; r.bit = (int)(bit_pos & 7);

  int curr = 0;
  int more = 1;
  int is_i = slice_type % 5 == 2;
  if (!is_i && ref_y == 0) return -10;
  while (more && curr < D.nmb) {
    if (!is_i) {
      int skip_run = read_ue(&r);
      for (int k = 0; k < skip_run; k++) {
        if (curr >= D.nmb) break;
        decode_skip_mb(&D, curr);
        curr++;
      }
      if (curr != 0 || skip_run > 0) more = rd_more(&r);
    }
    if (more) {
      int e = decode_mb(&D, &r, curr, slice_type);
      if (e < 0) return e;
      more = rd_more(&r);
      curr++;
    }
  }
  *mb_qp_delta_io = D.mb_qp_delta;
  *qpy_out = D.qpy;
  return r.byte * 8 + r.bit;
}

}  // extern "C"

extern "C" {
// test hook: decode one CAVLC block from a packed bitstream
long dec_block_test(const uint8_t *data, long nbytes, long bit_pos, int nc,
                    int max_num_coeff, int32_t *coeff_out) {
  Reader r;
  r.d = data; r.nbytes = nbytes + 8;  // avoid more_rbsp semantics here
  r.byte = bit_pos >> 3; r.bit = (int)(bit_pos & 7);
  int tc = decode_block(&r, nc, max_num_coeff, coeff_out);
  if (tc < 0) return -1;
  return ((r.byte * 8 + r.bit) << 8) | tc;
}
}

extern "C" {
void pred16_test(const int32_t *p, int mode, int32_t *out) {
  predict_16x16(p, mode, out);
}
void pred4_test(const int32_t *p, int mode, int32_t *out) {
  predict_4x4(p, mode, out);
}
void predc_test(const int32_t *p, int mode, int32_t *out) {
  predict_chroma(p, mode, out);
}
}
