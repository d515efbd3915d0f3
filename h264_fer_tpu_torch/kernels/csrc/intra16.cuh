// The Intra16x16 luma coding and the intra chroma coding of one macroblock,
// shared by the K1 and K1t wavefronts (both), K7 (chroma; all three in
// csrc/wavefront_i16.cu) and K6 (the I16 candidate, csrc/wavefront_mixed.cu):
// the device forms of kernels/wavefront_i16._i16_luma_code and _chroma_code.
//
// One thread per sample: 256 for the luma, 128 for the chroma (64 of Cb, then
// 64 of Cr). The source MB is read through a pointer and a row stride, so a
// caller may stage it in shared memory first (K1, K1t, K6). Each function synchronises its own threads with a named barrier
// (group_sync), so that K1 can run the two on separate warps of one block at
// once. The MB's working arrays live in shared memory.

#pragma once

#include <cstdint>

#include "intra_common.cuh"

namespace {

struct I16Scratch {
  int par[4];  // DC value, plane a, b, c
  int a[256], b[256];
  int v[16], r[16], dcv[16];
};

// The Intra16x16 predictor's parameters of one MB, by one thread: par[0] the
// DC value, par[1..3] the Plane's a, b and c, from its top / left samples
// and corner (-1 where unavailable). DC averages top and left where both_ok,
// else the left or the top alone, else 128 (intra.cpp:426-533).
__device__ __forceinline__ void i16_params(const int* top, const int* left, int corner,
                                           bool both_ok, bool left_ok, bool top_ok,
                                           int* par) {
  int st = 0, sl = 0, hg = 0, vg = 0;
  for (int i = 0; i < 16; ++i) { st += top[i]; sl += left[i]; }
  for (int i = 0; i < 8; ++i) {
    const int tm = i == 7 ? corner : top[6 - i];
    const int lm = i == 7 ? corner : left[6 - i];
    hg += (i + 1) * (top[8 + i] - tm);
    vg += (i + 1) * (left[8 + i] - lm);
  }
  par[0] = both_ok ? (st + sl + 16) >> 5
         : left_ok ? (sl + 8) >> 4
         : top_ok  ? (st + 8) >> 4 : 128;
  par[1] = (left[15] + top[15]) * 16;
  par[2] = (5 * hg + 32) >> 6;
  par[3] = (5 * vg + 32) >> 6;
}

// The Intra16x16 prediction of sample (x, y) in `mode` (0 V, 1 H, 2 DC,
// 3 Plane), with par from i16_params.
__device__ __forceinline__ int i16_pred(int mode, int x, int y, const int* top,
                                        const int* left, const int* par) {
  switch (mode) {
    case 0: return top[x];
    case 1: return left[y];
    case 2: return par[0];
    default: return clip255((par[1] + par[2] * (x - 7) + par[3] * (y - 7) + 16) >> 5);
  }
}

// Code one MB as Intra16x16 luma in `mode`; the 256 threads t = 0..255 that
// use barrier `bar` call it, thread t owning sample (t / 16, t % 16). top /
// left: the 16 reconstructed samples above and to the left, corner the
// top-left one, -1 where unavailable, written before the call and
// synchronised. src: the MB's top-left source sample (row stride W). Where
// dc / ac are not null, writes the quantised levels: dc[zig-zag index] of the
// 4x4 DC block, ac[15 * z + zig-zag index - 1] of Z-scan block z. Returns
// thread t's reconstructed sample.
__device__ int i16_luma_mb(const int* top, const int* left, int corner,
                           bool left_ok, bool top_ok, int mode,
                           const uint8_t* __restrict__ src, int W, int qp,
                           const QpTab& tab, I16Scratch& s, int* dc, int* ac,
                           int t, int bar) {
  const int y = t >> 4, x = t & 15;
  if (t == 0) i16_params(top, left, corner, left_ok && top_ok, left_ok, top_ok, s.par);
  group_sync(bar, 256);
  const int pred = i16_pred(mode, x, y, top, left, s.par);
  {
    const int diff = (int)src[y * W + x] - pred;
    s.a[t] = diff == 0 ? 0 : diff * 64 - 32;
  }
  group_sync(bar, 256);
  // forward transform: column pass, then row pass
  {
    const int b = (y & ~3) * 16 + x;
    s.b[t] = fwd_step(y & 3, s.a[b], s.a[b + 16], s.a[b + 32], s.a[b + 48]);
  }
  group_sync(bar, 256);
  const int zz = kInvZigzag[(y & 3) * 4 + (x & 3)];
  const bool is_dc = zz == 0;
  int q;
  {
    const int b = y * 16 + (x & ~3);
    const int coef = fwd_step(x & 3, s.b[b], s.b[b + 1], s.b[b + 2], s.b[b + 3]);
    // the DC matrix dc[by][bx] at index by * 4 + bx
    if (is_dc) s.v[(y >> 2) * 4 + (x >> 2)] = coef;
    q = quant_ac(coef, qp, tab.lq[pat(y, x)]);
    if (ac && !is_dc) ac[15 * kRasterToZ[(y >> 2) * 4 + (x >> 2)] + zz - 1] = q;
  }
  group_sync(bar, 256);
  // DC path: forward Hadamard H v H^T, quant, inverse Hadamard, scale, by
  // threads 0..15 (row hi, column hj)
  const int hi = t >> 2, hj = t & 3;
  if (t < 16) {
    int acc = 0;
    for (int k = 0; k < 4; ++k) acc += kHad4[hi][k] * s.v[k * 4 + hj];
    s.r[t] = acc;
  }
  group_sync(bar, 256);
  if (t < 16) {
    int acc = 0;
    for (int k = 0; k < 4; ++k) acc += kHad4[hj][k] * s.r[hi * 4 + k];
    const int qdc = quant_dc_luma((acc + 8) >> 4, qp, tab.lq[0]);
    s.v[t] = qdc;
    if (dc) dc[kInvZigzag[t]] = qdc;
  }
  group_sync(bar, 256);
  if (t < 16) {
    int acc = 0;
    for (int k = 0; k < 4; ++k) acc += kHad4[hi][k] * s.v[k * 4 + hj];
    s.r[t] = acc;
  }
  group_sync(bar, 256);
  if (t < 16) {
    int acc = 0;
    for (int k = 0; k < 4; ++k) acc += kHad4[hj][k] * s.r[hi * 4 + k];
    s.dcv[t] = scale_dc_luma(acc, qp, tab.ls[0]);
  }
  group_sync(bar, 256);
  // dequantised coefficients (DC from the DC path), inverse transform
  s.a[t] = is_dc ? s.dcv[(y >> 2) * 4 + (x >> 2)] : scale_ac(q, qp, tab.ls[pat(y, x)]);
  group_sync(bar, 256);
  {
    const int b = y * 16 + (x & ~3);
    s.b[t] = inv_step(x & 3, s.a[b], s.a[b + 1], s.a[b + 2], s.a[b + 3]);
  }
  group_sync(bar, 256);
  const int b = (y & ~3) * 16 + x;
  const int h = inv_step(y & 3, s.b[b], s.b[b + 16], s.b[b + 32], s.b[b + 48]);
  return clip255(pred + ((h + 32) >> 6));
}

struct ChromaScratch {
  int top[2][8], left[2][8], corner[2];
  int par[2][7];  // 4 quadrant DCs, plane a, b, c
  int a[128], b[128];
  int v[8], r[8], dcv[8];
};

// Reconstruct the Cb and Cr of MB (r, c) in chroma mode `mode`; the 128
// threads t = 0..127 that use barrier `bar` call it, thread t owning sample
// ((t >> 3) & 7, t & 7) of plane t >> 6. cbs / crs: the MB's top-left Cb /
// Cr source sample (row stride ss), in the source planes or in shared
// memory. Reads the neighbours from, and writes the MB to, the uint8 recon
// planes (Wc samples wide), whose earlier MBs are final. has_top: row 0 has
// a top neighbour, the plane row above it (a band's halo, written before the
// launch). Where cdc / cac are not null (pointing at this MB's entry
// of the (2, nmb, 4) / (2, nmb, 4, 15) level arrays), writes the quantised
// levels: cdc[plane][raster index] of the 2x2 DC block, cac[plane][raster
// block][zig-zag index - 1].
__device__ void chroma_mb(const uint8_t* __restrict__ cbs,
                          const uint8_t* __restrict__ crs, int ss, uint8_t* cbrec,
                          uint8_t* crrec, int Wc, int r, int c, bool has_top,
                          int mode, int qpc, const QpTab& tab, ChromaScratch& s,
                          int32_t* cdc, int32_t* cac, int nmb, int t, int bar) {
  const bool top_ok = r > 0 || has_top, left_ok = c > 0, corner_ok = top_ok && left_ok;
  const int cx0 = c * 8, cy0 = r * 8;
  const int p = t >> 6, cy = (t >> 3) & 7, cx = t & 7;
  const uint8_t* csrc = p ? crs : cbs;
  uint8_t* crec = p ? crrec : cbrec;

  // neighbours from the finished planes; -1 where unavailable
  if (t < 16) {
    const int q = t >> 3, i = t & 7;
    const uint8_t* pl = q ? crrec : cbrec;
    s.top[q][i] = top_ok ? pl[(cy0 - 1) * Wc + cx0 + i] : -1;
  } else if (t < 32) {
    const int q = (t - 16) >> 3, i = (t - 16) & 7;
    const uint8_t* pl = q ? crrec : cbrec;
    s.left[q][i] = left_ok ? pl[(cy0 + i) * Wc + cx0 - 1] : -1;
  } else if (t < 34) {
    const int q = t - 32;
    const uint8_t* pl = q ? crrec : cbrec;
    s.corner[q] = corner_ok ? pl[(cy0 - 1) * Wc + cx0 - 1] : -1;
  }
  group_sync(bar, 128);

  // per-plane prediction parameters (threads 0 and 1)
  if (t < 2) {
    const int q = t;
    int sx[2] = {0, 0}, sy[2] = {0, 0}, hg = 0, vg = 0;
    for (int i = 0; i < 8; ++i) {
      sx[i >> 2] += s.top[q][i];
      sy[i >> 2] += s.left[q][i];
    }
    for (int i = 0; i < 4; ++i) {
      const int tm = i == 3 ? s.corner[q] : s.top[q][2 - i];
      const int lm = i == 3 ? s.corner[q] : s.left[q][2 - i];
      hg += (i + 1) * (s.top[q][4 + i] - tm);
      vg += (i + 1) * (s.left[q][4 + i] - lm);
    }
    for (int quad = 0; quad < 4; ++quad) {
      const int xq = quad & 1, yq = quad >> 1;
      const int both = (sx[xq] + sy[yq] + 4) >> 3;
      const int lonly = (sy[yq] + 2) >> 2, tonly = (sx[xq] + 2) >> 2;
      int v;
      if (xq == yq) {  // quadrants 0 and 3: both, then left, then top
        v = corner_ok ? both : left_ok ? lonly : top_ok ? tonly : 128;
      } else if (xq == 1) {  // top-right: top first
        v = top_ok ? tonly : left_ok ? lonly : 128;
      } else {  // bottom-left: left first
        v = left_ok ? lonly : top_ok ? tonly : 128;
      }
      s.par[q][quad] = v;
    }
    s.par[q][4] = (s.left[q][7] + s.top[q][7]) * 16;
    s.par[q][5] = (34 * hg + 32) >> 6;
    s.par[q][6] = (34 * vg + 32) >> 6;
  }
  group_sync(bar, 128);

  int pred;
  switch (mode) {
    case 0: pred = s.par[p][((cy >> 2) << 1) | (cx >> 2)]; break;
    case 1: pred = s.left[p][cy]; break;
    case 2: pred = s.top[p][cx]; break;
    default:
      pred = clip255((s.par[p][4] + s.par[p][5] * (cx - 3) + s.par[p][6] * (cy - 3) + 16) >> 5);
  }
  {
    const int diff = (int)csrc[cy * ss + cx] - pred;
    s.a[t] = diff == 0 ? 0 : diff * 64 - 32;
  }
  group_sync(bar, 128);
  // forward transform: column pass, then row pass
  {
    const int b = p * 64 + (cy & ~3) * 8 + cx;
    s.b[t] = fwd_step(cy & 3, s.a[b], s.a[b + 8], s.a[b + 16], s.a[b + 24]);
  }
  group_sync(bar, 128);
  const bool is_dc = ((cy | cx) & 3) == 0;
  int q;
  {
    const int b = p * 64 + cy * 8 + (cx & ~3);
    const int coef = fwd_step(cx & 3, s.b[b], s.b[b + 1], s.b[b + 2], s.b[b + 3]);
    // the DC matrices dc[plane][by][bx] at index plane * 4 + by * 2 + bx
    if (is_dc) s.v[p * 4 + (cy >> 2) * 2 + (cx >> 2)] = coef;
    q = quant_ac(coef, qpc, tab.lq[pat(cy, cx)]);
    if (cac && !is_dc)
      cac[p * nmb * 60 + ((cy >> 2) * 2 + (cx >> 2)) * 15 +
          kInvZigzag[(cy & 3) * 4 + (cx & 3)] - 1] = q;
  }
  group_sync(bar, 128);
  // 2x2 DC path by threads 0..7 (plane k, row i, column j)
  const int k = t >> 2, i = (t >> 1) & 1, j = t & 1;
  if (t < 8) {
    const int a = s.v[k * 4 + j], b = s.v[k * 4 + 2 + j];
    s.r[t] = i ? a - b : a + b;
  }
  group_sync(bar, 128);
  if (t < 8) {
    const int a = s.r[k * 4 + i * 2], b = s.r[k * 4 + i * 2 + 1];
    const int fdc = ((j ? a - b : a + b) + 2) >> 2;
    s.v[t] = quant_dc_chroma(fdc, qpc, tab.lq[0]);
    if (cdc) cdc[k * nmb * 4 + i * 2 + j] = s.v[t];
  }
  group_sync(bar, 128);
  if (t < 8) {
    const int a = s.v[k * 4 + j], b = s.v[k * 4 + 2 + j];
    s.r[t] = i ? a - b : a + b;
  }
  group_sync(bar, 128);
  if (t < 8) {
    const int a = s.r[k * 4 + i * 2], b = s.r[k * 4 + i * 2 + 1];
    s.dcv[t] = scale_dc_chroma(j ? a - b : a + b, qpc, tab.ls[0]);
  }
  group_sync(bar, 128);
  // dequantised coefficients (DC from the DC path), inverse transform
  s.a[t] = is_dc ? s.dcv[p * 4 + (cy >> 2) * 2 + (cx >> 2)]
                 : scale_ac(q, qpc, tab.ls[pat(cy, cx)]);
  group_sync(bar, 128);
  {
    const int b = p * 64 + cy * 8 + (cx & ~3);
    s.b[t] = inv_step(cx & 3, s.a[b], s.a[b + 1], s.a[b + 2], s.a[b + 3]);
  }
  group_sync(bar, 128);
  const int b = p * 64 + (cy & ~3) * 8 + cx;
  const int h = inv_step(cy & 3, s.b[b], s.b[b + 8], s.b[b + 16], s.b[b + 24]);
  crec[(cy0 + cy) * Wc + cx0 + cx] = (uint8_t)clip255(pred + ((h + 32) >> 6));
}

}  // namespace
