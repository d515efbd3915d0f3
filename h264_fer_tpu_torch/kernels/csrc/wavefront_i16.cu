// Intra_16x16 reconstruction wavefront over MB anti-diagonals, for sm_90a.
//
// Replaces the Pallas kernel _i16_recon_kernel_body
// (h264_fer_tpu/kernels/wavefront_pallas.py:890, called by
// pallas_i16_frame_fast_impl at :1170). It computes the same function: for
// every MB, in the decided Intra16x16 mode, the prediction from the
// reconstructed top row, left column and corner; the forward 4x4 integer
// DCT and quantisation; the 4x4 Hadamard DC path; the inverse of both; and
// the clipped reconstruction. The same for Cb and Cr (8x8, 2x2 DC, chroma
// mode given per MB). Levels are not written: the caller rebuilds them from
// the reconstruction in bulk (kernels/wavefront_i16.py).
//
// What bounds it on an H100: neither bytes (about 6.3 MB of uint8 in and
// out per 1920x1088 frame, ~2 us at 3.35 TB/s) nor integer operations
// (~32-36 per pixel in the function's butterfly form, ~6 us at the card's
// int32 rate; chip_smoke.k1_ops counts them). The floor is the
// dependency chain: MB (r, c) needs (r-1, c), (r, c-1) and (r-1, c-1), so
// the hmb+wmb-1 anti-diagonals (187 at 1080p) run one after another and a
// diagonal holds at most hmb (68) MBs, far fewer blocks than the card can
// run at once.
//
// Design: one launch per diagonal d = r + c, one thread block per MB of the
// diagonal, one thread per luma pixel (256); threads 0..127 also carry one
// chroma pixel each (2 planes x 64). The MB's working arrays live in shared
// memory. Neighbours are read straight from the row-major uint8 output
// planes, which the earlier launches have finished; stream order makes
// them visible. No skewed layout. A persistent kernel with per-MB ready
// flags, or a CUDA graph over the launches, is later work.
//
// Arithmetic is int32 exactly as the reference: `>>` on signed int is an
// arithmetic shift under nvcc, and a left shift of a value that may be
// negative is written as a multiplication by a power of two, since a left
// shift of a negative int is undefined in C++.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Per-QP coefficient multipliers in the 3-value H.264 pattern:
// [0] (even, even), [1] (odd, odd), [2] mixed position parity.
struct QTab {
  int lq[3];   // LEVEL_QUANTIZE[qp % 6]
  int ls[3];   // LEVEL_SCALE[qp % 6]
  int lqc[3];  // LEVEL_QUANTIZE[qpc % 6]
  int lsc[3];  // LEVEL_SCALE[qpc % 6]
};

__constant__ int kFwdW[4][4] = {{256, 256, 256, 256},
                                {416, 208, -208, -416},
                                {256, -256, -256, 256},
                                {208, -416, 416, -208}};
__constant__ int kHad4[4][4] = {
    {1, 1, 1, 1}, {1, 1, -1, -1}, {1, -1, -1, 1}, {1, -1, 1, -1}};

__device__ __forceinline__ int pat(int i, int j) {
  const int oi = i & 1, oj = j & 1;
  return (!oi && !oj) ? 0 : ((oi && oj) ? 1 : 2);
}

__device__ __forceinline__ int pow2(int s) { return 1 << s; }

// quantisationResidualBlock (quantizationTransform.cpp:183-223)
__device__ __forceinline__ int quant_ac(int d, int qp, int lq) {
  if (qp < 24) {
    const int qbits = 4 - qp / 6;
    const int adjust = 1 << (3 - qp / 6);
    return ((d * pow2(qbits) - adjust) * lq + 16384) >> 15;
  }
  return ((d >> (qp / 6 - 4)) * lq + 16384) >> 15;
}

// scaleResidualBlock (scaleTransform.cpp:308-340)
__device__ __forceinline__ int scale_ac(int c, int qp, int ls) {
  if (qp >= 24) return (c * ls) * pow2(qp / 6 - 4);
  return (c * ls + (1 << (3 - qp / 6))) >> (4 - qp / 6);
}

// quantisationLumaDCIntra (quantizationTransform.cpp:227-260)
__device__ __forceinline__ int quant_dc_luma(int f, int qp, int lq0) {
  if (qp >= 36) return ((f >> (qp / 6 - 6)) * lq0 + 16384) >> 15;
  return ((f * pow2(6 - qp / 6) - (1 << (5 - qp / 6))) * lq0 + 16384) >> 15;
}

// scaleLumaDCIntra (scaleTransform.cpp:344-404)
__device__ __forceinline__ int scale_dc_luma(int f, int qp, int ls0) {
  if (qp >= 36) return (f * ls0) * pow2(qp / 6 - 6);
  return (f * ls0 + (1 << (5 - qp / 6))) >> (6 - qp / 6);
}

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// One step of the forward core transform along one axis of a 4-group:
// out_i = (sum_k W[i][k] * in_k + 512) >> 10.
__device__ __forceinline__ int fwd_step(int i, int v0, int v1, int v2, int v3) {
  return (kFwdW[i][0] * v0 + kFwdW[i][1] * v1 + kFwdW[i][2] * v2 +
          kFwdW[i][3] * v3 + 512) >> 10;
}

// One step of the inverse core transform butterfly (scaleTransform.cpp:101-150).
__device__ __forceinline__ int inv_step(int j, int d0, int d1, int d2, int d3) {
  const int e0 = d0 + d2, e1 = d0 - d2;
  const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  switch (j) {
    case 0: return e0 + e3;
    case 1: return e1 + e2;
    case 2: return e1 - e2;
    default: return e0 - e3;
  }
}

__global__ void __launch_bounds__(256)
i16_diag_kernel(const uint8_t* __restrict__ ysrc,
                const uint8_t* __restrict__ cbsrc,
                const uint8_t* __restrict__ crsrc,
                const int32_t* __restrict__ modes,
                const int32_t* __restrict__ cmodes,
                uint8_t* __restrict__ yrec,
                uint8_t* __restrict__ cbrec,
                uint8_t* __restrict__ crrec,
                int wmb, int d, int r0, int qp, int qpc, QTab tab) {
  const int r = r0 + blockIdx.x;
  const int c = d - r;
  const int mb = r * wmb + c;
  const int W = wmb * 16, Wc = wmb * 8;
  const int x0 = c * 16, y0 = r * 16, cx0 = c * 8, cy0 = r * 8;
  const bool top_ok = r > 0, left_ok = c > 0, corner_ok = top_ok && left_ok;
  const int t = threadIdx.x;
  const int y = t >> 4, x = t & 15;
  // chroma pixel of threads 0..127: plane p, row cy, column cx
  const bool has_c = t < 128;
  const int p = t >> 6, cy = (t >> 3) & 7, cx = t & 7;
  const uint8_t* csrc = p ? crsrc : cbsrc;
  uint8_t* crec = p ? crrec : cbrec;

  __shared__ int s_top[16], s_left[16], s_corner;
  __shared__ int c_top[2][8], c_left[2][8], c_corner[2];
  __shared__ int s_par[4];      // luma: DC value, plane a, b, c
  __shared__ int c_par[2][7];   // chroma: 4 quadrant DCs, plane a, b, c
  __shared__ int s_a[256], s_b[256];
  __shared__ int c_a[128], c_b[128];
  __shared__ int s_v[16], s_r[16], s_dcv[16];
  __shared__ int c_v[8], c_r[8], c_dcv[8];

  // ---- neighbours from the finished planes; -1 where unavailable --------
  if (t < 16) {
    s_top[t] = top_ok ? yrec[(y0 - 1) * W + x0 + t] : -1;
  } else if (t < 32) {
    const int i = t - 16;
    s_left[i] = left_ok ? yrec[(y0 + i) * W + x0 - 1] : -1;
  } else if (t == 32) {
    s_corner = corner_ok ? yrec[(y0 - 1) * W + x0 - 1] : -1;
  } else if (t >= 64 && t < 80) {
    const int q = (t - 64) >> 3, i = (t - 64) & 7;
    const uint8_t* pl = q ? crrec : cbrec;
    c_top[q][i] = top_ok ? pl[(cy0 - 1) * Wc + cx0 + i] : -1;
  } else if (t >= 80 && t < 96) {
    const int q = (t - 80) >> 3, i = (t - 80) & 7;
    const uint8_t* pl = q ? crrec : cbrec;
    c_left[q][i] = left_ok ? pl[(cy0 + i) * Wc + cx0 - 1] : -1;
  } else if (t >= 96 && t < 98) {
    const int q = t - 96;
    const uint8_t* pl = q ? crrec : cbrec;
    c_corner[q] = corner_ok ? pl[(cy0 - 1) * Wc + cx0 - 1] : -1;
  }
  __syncthreads();

  // ---- per-MB prediction parameters ---------------------------------------
  if (t == 0) {
    int st = 0, sl = 0, hg = 0, vg = 0;
    for (int i = 0; i < 16; ++i) { st += s_top[i]; sl += s_left[i]; }
    for (int i = 0; i < 8; ++i) {
      const int tm = i == 7 ? s_corner : s_top[6 - i];
      const int lm = i == 7 ? s_corner : s_left[6 - i];
      hg += (i + 1) * (s_top[8 + i] - tm);
      vg += (i + 1) * (s_left[8 + i] - lm);
    }
    s_par[0] = corner_ok ? (st + sl + 16) >> 5
             : left_ok   ? (sl + 8) >> 4
             : top_ok    ? (st + 8) >> 4 : 128;
    s_par[1] = (s_left[15] + s_top[15]) * 16;
    s_par[2] = (5 * hg + 32) >> 6;
    s_par[3] = (5 * vg + 32) >> 6;
  } else if (t == 32 || t == 33) {
    const int q = t - 32;
    int sx[2] = {0, 0}, sy[2] = {0, 0}, hg = 0, vg = 0;
    for (int i = 0; i < 8; ++i) {
      sx[i >> 2] += c_top[q][i];
      sy[i >> 2] += c_left[q][i];
    }
    for (int i = 0; i < 4; ++i) {
      const int tm = i == 3 ? c_corner[q] : c_top[q][2 - i];
      const int lm = i == 3 ? c_corner[q] : c_left[q][2 - i];
      hg += (i + 1) * (c_top[q][4 + i] - tm);
      vg += (i + 1) * (c_left[q][4 + i] - lm);
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
      c_par[q][quad] = v;
    }
    c_par[q][4] = (c_left[q][7] + c_top[q][7]) * 16;
    c_par[q][5] = (34 * hg + 32) >> 6;
    c_par[q][6] = (34 * vg + 32) >> 6;
  }
  __syncthreads();

  // ---- prediction and residual -------------------------------------------
  const int m16 = modes[mb];
  int pred;
  switch (m16) {
    case 0: pred = s_top[x]; break;
    case 1: pred = s_left[y]; break;
    case 2: pred = s_par[0]; break;
    default:
      pred = clip255((s_par[1] + s_par[2] * (x - 7) + s_par[3] * (y - 7) + 16) >> 5);
  }
  {
    const int diff = (int)ysrc[(y0 + y) * W + x0 + x] - pred;
    s_a[t] = diff == 0 ? 0 : diff * 64 - 32;
  }
  int cpred = 0;
  if (has_c) {
    const int cm = cmodes[mb];
    switch (cm) {
      case 0: cpred = c_par[p][((cy >> 2) << 1) | (cx >> 2)]; break;
      case 1: cpred = c_left[p][cy]; break;
      case 2: cpred = c_top[p][cx]; break;
      default:
        cpred = clip255((c_par[p][4] + c_par[p][5] * (cx - 3) +
                         c_par[p][6] * (cy - 3) + 16) >> 5);
    }
    const int diff = (int)csrc[(cy0 + cy) * Wc + cx0 + cx] - cpred;
    c_a[t] = diff == 0 ? 0 : diff * 64 - 32;
  }
  __syncthreads();

  // ---- forward transform: column pass, then row pass ----------------------
  {
    const int b = (y & ~3) * 16 + x;
    s_b[t] = fwd_step(y & 3, s_a[b], s_a[b + 16], s_a[b + 32], s_a[b + 48]);
    if (has_c) {
      const int cb = p * 64 + (cy & ~3) * 8 + cx;
      c_b[t] = fwd_step(cy & 3, c_a[cb], c_a[cb + 8], c_a[cb + 16], c_a[cb + 24]);
    }
  }
  __syncthreads();
  int coef, ccoef = 0;
  {
    const int b = y * 16 + (x & ~3);
    coef = fwd_step(x & 3, s_b[b], s_b[b + 1], s_b[b + 2], s_b[b + 3]);
    if (has_c) {
      const int cb = p * 64 + cy * 8 + (cx & ~3);
      ccoef = fwd_step(cx & 3, c_b[cb], c_b[cb + 1], c_b[cb + 2], c_b[cb + 3]);
    }
  }
  const bool is_dc = ((y | x) & 3) == 0;
  const bool c_is_dc = ((cy | cx) & 3) == 0;
  // DC matrices: luma dc[by][bx] at index by*4+bx; chroma dc[p][by][bx]
  if (is_dc) s_v[(y >> 2) * 4 + (x >> 2)] = coef;
  if (has_c && c_is_dc) c_v[p * 4 + (cy >> 2) * 2 + (cx >> 2)] = ccoef;
  const int q = quant_ac(coef, qp, tab.lq[pat(y, x)]);
  const int cq = quant_ac(ccoef, qpc, tab.lqc[pat(cy, cx)]);
  __syncthreads();

  // ---- DC paths: forward Hadamard, quant, inverse Hadamard, scale ---------
  // luma H·v·H^T by threads 0..15 (i = row, j = column); chroma 2x2 by
  // threads 32..39 (plane k, row i, column j)
  const int hi = t >> 2, hj = t & 3;
  const int ck = (t - 32) >> 2, ci = ((t - 32) >> 1) & 1, cj = (t - 32) & 1;
  const bool c_dc_thread = t >= 32 && t < 40;
  if (t < 16) {
    int acc = 0;
    for (int k = 0; k < 4; ++k) acc += kHad4[hi][k] * s_v[k * 4 + hj];
    s_r[t] = acc;
  } else if (c_dc_thread) {
    const int a = c_v[ck * 4 + cj], b = c_v[ck * 4 + 2 + cj];
    c_r[t - 32] = ci ? a - b : a + b;
  }
  __syncthreads();
  if (t < 16) {
    int acc = 0;
    for (int k = 0; k < 4; ++k) acc += kHad4[hj][k] * s_r[hi * 4 + k];
    const int fdc = (acc + 8) >> 4;
    s_v[t] = quant_dc_luma(fdc, qp, tab.lq[0]);
  } else if (c_dc_thread) {
    const int a = c_r[ck * 4 + ci * 2], b = c_r[ck * 4 + ci * 2 + 1];
    const int cfdc = ((cj ? a - b : a + b) + 2) >> 2;
    c_v[t - 32] = (((cfdc * 32) >> (qpc / 6)) * tab.lqc[0] + 16384) >> 15;
  }
  __syncthreads();
  if (t < 16) {
    int acc = 0;
    for (int k = 0; k < 4; ++k) acc += kHad4[hi][k] * s_v[k * 4 + hj];
    s_r[t] = acc;
  } else if (c_dc_thread) {
    const int a = c_v[ck * 4 + cj], b = c_v[ck * 4 + 2 + cj];
    c_r[t - 32] = ci ? a - b : a + b;
  }
  __syncthreads();
  if (t < 16) {
    int acc = 0;
    for (int k = 0; k < 4; ++k) acc += kHad4[hj][k] * s_r[hi * 4 + k];
    s_dcv[t] = scale_dc_luma(acc, qp, tab.ls[0]);
  } else if (c_dc_thread) {
    const int a = c_r[ck * 4 + ci * 2], b = c_r[ck * 4 + ci * 2 + 1];
    c_dcv[t - 32] = ((cj ? a - b : a + b) * tab.lsc[0] * pow2(qpc / 6)) >> 5;
  }
  __syncthreads();

  // ---- dequantised coefficients (DC from the DC path) ---------------------
  s_a[t] = is_dc ? s_dcv[(y >> 2) * 4 + (x >> 2)]
                 : scale_ac(q, qp, tab.ls[pat(y, x)]);
  if (has_c) {
    c_a[t] = c_is_dc ? c_dcv[p * 4 + (cy >> 2) * 2 + (cx >> 2)]
                     : scale_ac(cq, qpc, tab.lsc[pat(cy, cx)]);
  }
  __syncthreads();

  // ---- inverse transform: pass along x, then along y ----------------------
  {
    const int b = y * 16 + (x & ~3);
    s_b[t] = inv_step(x & 3, s_a[b], s_a[b + 1], s_a[b + 2], s_a[b + 3]);
    if (has_c) {
      const int cb = p * 64 + cy * 8 + (cx & ~3);
      c_b[t] = inv_step(cx & 3, c_a[cb], c_a[cb + 1], c_a[cb + 2], c_a[cb + 3]);
    }
  }
  __syncthreads();
  {
    const int b = (y & ~3) * 16 + x;
    const int h = inv_step(y & 3, s_b[b], s_b[b + 16], s_b[b + 32], s_b[b + 48]);
    yrec[(y0 + y) * W + x0 + x] = (uint8_t)clip255(pred + ((h + 32) >> 6));
    if (has_c) {
      const int cb = p * 64 + (cy & ~3) * 8 + cx;
      const int ch = inv_step(cy & 3, c_b[cb], c_b[cb + 8], c_b[cb + 16], c_b[cb + 24]);
      crec[(cy0 + cy) * Wc + cx0 + cx] = (uint8_t)clip255(cpred + ((ch + 32) >> 6));
    }
  }
}

}  // namespace

// Reconstructs a whole frame: one launch per anti-diagonal on `stream`.
// qtab: 12 ints, LEVEL_QUANTIZE / LEVEL_SCALE of qp and of qpc in the order
// of QTab. *launched gets the number of launches that were accepted.
// Returns the first CUDA error (0 when every launch was accepted).
extern "C" int wavefront_i16_frame(const uint8_t* ysrc, const uint8_t* cbsrc,
                                   const uint8_t* crsrc, const int32_t* modes,
                                   const int32_t* cmodes, uint8_t* yrec,
                                   uint8_t* cbrec, uint8_t* crrec, int wmb,
                                   int hmb, int qp, int qpc, const int* qtab,
                                   cudaStream_t stream, int* launched) {
  *launched = 0;
  QTab tab;
  for (int i = 0; i < 3; ++i) {
    tab.lq[i] = qtab[i];
    tab.ls[i] = qtab[3 + i];
    tab.lqc[i] = qtab[6 + i];
    tab.lsc[i] = qtab[9 + i];
  }
  for (int d = 0; d < hmb + wmb - 1; ++d) {
    const int r0 = d - wmb + 1 > 0 ? d - wmb + 1 : 0;
    const int r1 = d < hmb - 1 ? d : hmb - 1;
    i16_diag_kernel<<<r1 - r0 + 1, 256, 0, stream>>>(
        ysrc, cbsrc, crsrc, modes, cmodes, yrec, cbrec, crrec, wmb, d, r0, qp,
        qpc, tab);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}
