// P-frame decision wavefront (K4) over knight diagonals, for sm_90a.
//
// Replaces the Pallas kernel _decide_kernel
// (h264_fer_tpu/kernels/wavefront_p_pallas.py:60, called by
// pframe_decide_pallas_impl at :387). It computes the same function as the
// XLA twin kernels/wavefront_p.pframe_decide_impl: for every MB, the P_Skip
// MV and test (mode_pred.cpp:381-426), then for each 8x8 quadrant in turn
// the MV predictor (PredictMV_Luma, mode_pred.cpp:252-371, over the left,
// top, top-right and top-left MBs and the quadrants already decided) and
// the argmin of distortion + lam * |mv - mvp| over the 387 candidates
// [289 integer shifts | 49 around c1 | 49 around c2], the first index on
// ties, c2's lanes at INT32_MAX where q2ok is false; then the 16x16 unify
// trial, the mb_type merge and the mvd of each partition.
//
// What bounds it on an H100: neither bytes (~50 MB of maps, centres and
// source read once per 1080p frame, ~0.016 ms at 3.35 TB/s) nor operations
// (~0.5 G int32 for the candidate costs and the skip / unify windows). The
// floor is the MV-prediction chain: MB (r, c) needs (r, c-1), (r-1, c),
// (r-1, c+1) and (r-1, c-1), which all lie on earlier diagonals of
// d = c + 2r, so the wmb + 2 hmb - 2 diagonals (254 at 1080p) run one after
// another, each with at most min(hmb, ceil(wmb / 2)) MBs (60).
//
// Design: one launch per diagonal, one thread block of 128 threads per
// MB. What the MB reads from memory does not depend on its own decisions,
// except the prediction windows, so the block first loads it all into
// shared memory with independent loads: the 4 x 387 candidate
// distortions, the source MB, the quadrant centres and the final state of
// its left, top, top-right and top-left neighbours (their quadrant MVs and
// type, written by earlier launches; stream order makes them visible).
// Every thread then carries the same scalar state of the MB (own.t,
// own.mv) and computes the predictors alike, with no divergence; the
// threads share only the per-candidate and per-sample work: the argmin of
// distortion + lam * |mv - mvp| over each quadrant's candidates (a
// (cost, index) reduction over warps), the 256-sample skip test and the
// four unify windows at once (one block vote, four block sums). Thread 0
// writes the MB's state at the end. No skewed layout, no bands, no SMEM
// halos. A persistent kernel or a CUDA graph over the launches is later
// work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSkip = -2;
constexpr unsigned kAll = 0xffffffffu;

struct Frame {
  const uint8_t* src;     // (H, W)
  const uint8_t* planes;  // (16, he, we)
  const int32_t* int_map; // (nmb, 4, S*S)
  const int32_t* c1mv;    // (nmb, 4, 2)
  const int32_t* q1map;   // (nmb, 4, 49)
  const int32_t* c2mv;    // (nmb, 4, 2)
  const int32_t* q2map;   // (nmb, 4, 49)
  const uint8_t* q2ok;    // (nmb, 4) bool
  const int32_t* maxdiff; // (nmb,)
  uint8_t* skip;          // (nmb,) bool out
  int32_t* mb_type;       // (nmb,) out: the merged type, also at skip MBs
  int32_t* mv;            // (nmb, 4, 2) out, and the MV state neighbours read
  int32_t* mvd;           // (nmb, 4, 2) out
  int32_t* state_t;       // (nmb,) type state neighbours read: kSkip or type
  int W, he, we, wmb, window, ext, lam;
};

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kNone = INT_MIN;  // a neighbour outside the frame

// The MB's view of the state: its own (as its later predictions read it)
// and its four neighbours' (left, top, top-right, top-left), in shared
// memory.
struct State {
  int t;
  int mv[4][2];
};

struct Nb {
  int x, y;
  bool ex;
};

template <int M>
__device__ __forceinline__ int dist(int d) {
  if (M == 0) return d < 0 ? -d : d;
  return M == 1 ? d * d : 2 * d * d;
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// Neighbour MV and existence at in-MB sample offset (xn, yn)
// (DeriveNeighbourLocation, mode_pred.cpp:61-97). nb: left, top, top-right,
// top-left. No MB is intra, so a neighbour that exists has reference 0.
__device__ Nb fetch(const State& own, const State* nb, int xn, int yn) {
  Nb n{0, 0, false};
  if ((xn > 15 && yn >= 0) || yn > 15) return n;
  const State* s;
  int xw, yw;
  if (xn >= 0 && xn < 16) {
    s = yn >= 0 ? &own : &nb[1];
    xw = xn;
    yw = yn >= 0 ? yn : yn + 16;
  } else if (xn > 15) {
    s = &nb[2]; xw = xn - 16; yw = yn + 16;
  } else if (yn < 0) {
    s = &nb[3]; xw = xn + 16; yw = yn + 16;
  } else {
    s = &nb[0]; xw = xn + 16; yw = yn;
  }
  const int t = s->t;
  if (t == kNone) return n;
  int pidx = 0;
  if (t != kSkip) {  // partition of (xw, yw) under type t (h264_globals.h:123-128)
    const int ti = min(max(t, 0), 4);
    const int pw = ti == 0 || ti == 1 ? 16 : 8;
    const int ph = ti == 0 || ti == 2 ? 16 : 8;
    pidx = ((yw / ph) << 1) + xw / pw;
  }
  n.x = s->mv[pidx][0];
  n.y = s->mv[pidx][1];
  n.ex = true;
  return n;
}

__device__ __forceinline__ int med3(int a, int b, int c) {
  return a + b + c - max(a, max(b, c)) - min(a, min(b, c));
}

// PredictMV_Luma for the encoder's partitions (mode_pred.cpp:252-371).
__device__ void predict(const State& own, const State* nbs, int type, int part,
                        int* px, int* py) {
  int x = 0, y = 0;
  if (type == 1) {
    y = 8 * part;
  } else if (type == 2) {
    x = 8 * part;
  } else if (type >= 3) {
    x = 8 * (part & 1);
    y = 8 * (part >> 1);
  }
  const int pw = type >= 2 ? 8 : 16;
  const Nb A = fetch(own, nbs, x - 1, y);
  const Nb B = fetch(own, nbs, x, y - 1);
  Nb C = fetch(own, nbs, x + pw, y - 1);
  const Nb D = fetch(own, nbs, x - 1, y - 1);
  if (!C.ex) C = D;  // C unavailable → D (mode_pred.cpp:297-299)
  const bool both_none = !A.ex && !B.ex;
  const int refA = (A.ex || both_none) ? 0 : -1;
  const int ax = A.ex ? A.x : 0, ay = A.ex ? A.y : 0;
  const int bx = B.ex ? B.x : ax, by = B.ex ? B.y : ay;
  const int cx = C.ex ? C.x : ax, cy = C.ex ? C.y : ay;
  const bool mA = refA == 0, mB = (B.ex ? 0 : refA) == 0,
             mC = (C.ex ? 0 : refA) == 0;
  int rx, ry;
  if (mA && !mB && !mC) {
    rx = ax; ry = ay;
  } else if (!mA && mB && !mC) {
    rx = bx; ry = by;
  } else if (!mA && !mB && mC) {
    rx = cx; ry = cy;
  } else {
    rx = med3(ax, bx, cx);
    ry = med3(ay, by, cy);
  }
  // directional cases, checked first by the reference: the raw neighbour
  if (type == 1 && part == 0 && B.ex) { rx = B.x; ry = B.y; }
  if (type == 1 && part == 1 && A.ex) { rx = A.x; ry = A.y; }
  if (type == 2 && part == 0 && A.ex) { rx = A.x; ry = A.y; }
  if (type == 2 && part == 1 && C.ex) { rx = C.x; ry = C.y; }
  *px = rx;
  *py = ry;
}

// Prediction sample (x, y) of the frame at qpel MV (mvx, mvy), read inside
// the planes.
__device__ __forceinline__ int sample(const Frame& f, int mvx, int mvy, int x,
                                      int y) {
  const int px = min(max(x + (mvx >> 2) + f.ext, 0), f.we - 1);
  const int py = min(max(y + (mvy >> 2) + f.ext, 0), f.he - 1);
  return f.planes[(size_t)((mvy & 3) * 4 + (mvx & 3)) * f.he * f.we +
                  py * f.we + px];
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// MV of candidate k (in [integer shifts | c1 + offsets | c2 + offsets]
// order) of a quadrant whose centres are cq[0] (c1) and cq[1] (c2).
__device__ __forceinline__ void candidate_mv(int k, int window,
                                             const int (*cq)[2], int* vx,
                                             int* vy) {
  const int S = 2 * window + 1, S2 = S * S;
  if (k < S2) {
    *vx = (k % S - window) * 4;
    *vy = (k / S - window) * 4;
  } else {
    const int second = k >= S2 + 49;
    const int o = k - S2 - 49 * second;
    *vx = cq[second][0] + o % 7 - 3;
    *vy = cq[second][1] + o / 7 - 3;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
decide_diag_kernel(Frame f, int d, int r0) {
  extern __shared__ int s_cost[];  // 4 x 387 distortions, INT_MAX if masked
  __shared__ int s_src[256];
  __shared__ State s_nb[4];        // left, top, top-right, top-left
  __shared__ int s_c[4][2][2];     // per quadrant: c1, c2
  __shared__ int s_red[kWarps][2];
  __shared__ int s_usum[kWarps][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = r0 + blockIdx.x, c = d - 2 * r;
  const int mb = r * f.wmb + c;
  const int x0 = c * 16, y0 = r * 16;
  const int S2 = (2 * f.window + 1) * (2 * f.window + 1), NC = S2 + 98;

  // ---- load what the MB reads, all at once --------------------------------
  // s_cost holds the MB's int_map rows (4 x S2), then its q1map rows
  // (4 x 49), then its q2map rows (4 x 49), each contiguous in memory too;
  // loads are staged in registers kUnroll at a time so that they overlap
  const int ni = 4 * S2, nc = ni + 4 * 49 * 2;
  for (int k0 = 0; k0 < nc; k0 += kUnroll * kThreads) {
    int v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads + tid;
      v[u] = 0;
      if (k < ni) {
        v[u] = f.int_map[mb * ni + k];
      } else if (k < ni + 196) {
        v[u] = f.q1map[mb * 196 + k - ni];
      } else if (k < nc) {
        const int o = k - ni - 196;
        v[u] = f.q2ok[mb * 4 + o / 49] ? f.q2map[mb * 196 + o] : INT_MAX;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads + tid;
      if (k < nc) s_cost[k] = v[u];
    }
  }
  if (tid < 64) {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(
        f.src + (y0 + (tid >> 2)) * f.W + x0) + (tid & 3);
    const uint32_t w = *row;  // 4 samples; W and x0 are multiples of 16
#pragma unroll
    for (int b = 0; b < 4; ++b) s_src[tid * 4 + b] = (w >> (8 * b)) & 255;
  } else if (tid < 68) {
    const int i = tid - 64;
    const int dr = i == 0 ? 0 : -1;
    const int dc = i == 0 ? -1 : (i == 1 ? 0 : (i == 2 ? 1 : -1));
    const int rn = r + dr, cn = c + dc;
    State& s = s_nb[i];
    s.t = kNone;
    for (int q = 0; q < 4; ++q) s.mv[q][0] = s.mv[q][1] = 0;
    if (rn >= 0 && cn >= 0 && cn < f.wmb) {
      const int n = rn * f.wmb + cn;
      s.t = f.state_t[n];
      for (int q = 0; q < 4; ++q) {
        s.mv[q][0] = f.mv[(n * 4 + q) * 2];
        s.mv[q][1] = f.mv[(n * 4 + q) * 2 + 1];
      }
    }
  } else if (tid < 84) {
    const int i = tid - 68, q = i >> 2, which = (i >> 1) & 1, a = i & 1;
    s_c[q][which][a] = (which ? f.c2mv : f.c1mv)[(mb * 4 + q) * 2 + a];
  }
  __syncthreads();
  const State* nbs = s_nb;
  State own;
  own.t = 4;
  for (int q = 0; q < 4; ++q) own.mv[q][0] = own.mv[q][1] = 0;

  // ---- P_Skip (its 16x16 predictor reads neighbours only) ----------------
  int px, py;
  predict(own, nbs, 0, 0, &px, &py);
  int sx = 0, sy = 0;
  if (r > 0 && c > 0 && !(nbs[1].mv[2][0] == 0 && nbs[1].mv[2][1] == 0) &&
      !(nbs[0].mv[1][0] == 0 && nbs[0].mv[1][1] == 0)) {
    sx = px;
    sy = py;
  }
  const int md = f.maxdiff[mb];
  int fits = 1;
  for (int k = tid; k < 256; k += kThreads) {
    fits &= iabs(s_src[k] - sample(f, sx, sy, x0 + (k & 15), y0 + (k >> 4))) <= md;
  }
  const bool is_skip = __syncthreads_and(fits);
  own.t = is_skip ? kSkip : 4;
  for (int q = 0; q < 4; ++q) {
    own.mv[q][0] = sx;
    own.mv[q][1] = sy;
  }

  // ---- per-quadrant search -----------------------------------------------
  int qmv[4][2], qmvp[4][2];
  int split = 0;
  for (int q = 0; q < 4; ++q) {
    int mx, my;
    predict(own, nbs, 4, q, &mx, &my);
    qmvp[q][0] = mx;
    qmvp[q][1] = my;
    int best = INT_MAX, bk = INT_MAX;
    for (int k = tid; k < NC; k += kThreads) {
      int cost = s_cost[k < S2 ? q * S2 + k
                        : 4 * S2 + (k < S2 + 49 ? 0 : 196) + q * 49 + (k - S2) % 49];
      if (cost != INT_MAX) {
        int vx, vy;
        candidate_mv(k, f.window, s_c[q], &vx, &vy);
        cost += f.lam * (iabs(vx - mx) + iabs(vy - my));
      }
      if (cost < best) {  // k rises: the thread keeps its first minimum
        best = cost;
        bk = k;
      }
    }
    for (int o = 16; o; o >>= 1) {
      const int ob = __shfl_xor_sync(kAll, best, o);
      const int ok = __shfl_xor_sync(kAll, bk, o);
      if (ob < best || (ob == best && ok < bk)) {
        best = ob;
        bk = ok;
      }
    }
    if (lane == 0) {
      s_red[warp][0] = best;
      s_red[warp][1] = bk;
    }
    __syncthreads();
    best = s_red[0][0];
    bk = s_red[0][1];
    for (int w = 1; w < kWarps; ++w) {
      if (s_red[w][0] < best || (s_red[w][0] == best && s_red[w][1] < bk)) {
        best = s_red[w][0];
        bk = s_red[w][1];
      }
    }
    __syncthreads();  // s_red is written again by the next quadrant
    candidate_mv(bk, f.window, s_c[q], &qmv[q][0], &qmv[q][1]);
    split += best;
    if (!is_skip) {
      own.mv[q][0] = qmv[q][0];
      own.mv[q][1] = qmv[q][1];
    }
  }

  // ---- 16x16 unify trial (encoder._maybe_unify) ---------------------------
  bool all_eq0 = true;
  for (int q = 1; q < 4; ++q)
    all_eq0 &= qmv[q][0] == qmv[0][0] && qmv[q][1] == qmv[0][1];
  if (!is_skip && !all_eq0) {
    // the four 16x16 windows at once; their predictor is the 16x16 one
    // again (neighbours only, unchanged)
    int s[4] = {0, 0, 0, 0};
    for (int k = tid; k < 256; k += kThreads) {
      const int x = x0 + (k & 15), y = y0 + (k >> 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j] += dist<M>(sample(f, qmv[j][0], qmv[j][1], x, y) - s_src[k]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = warp_sum(s[j]);
      if (lane == 0) s_usum[warp][j] = s[j];
    }
    __syncthreads();
    int best_c = split, ux = 0, uy = 0;
    bool found = false;
    for (int j = 0; j < 4; ++j) {
      int sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += s_usum[w][j];
      const int cost = sum + f.lam * (iabs(qmv[j][0] - px) + iabs(qmv[j][1] - py));
      if (cost < best_c) {
        best_c = cost;
        ux = qmv[j][0];
        uy = qmv[j][1];
        found = true;
      }
    }
    if (found) {
      for (int q = 0; q < 4; ++q) {
        qmv[q][0] = ux;
        qmv[q][1] = uy;
      }
    }
  }

  // ---- mb_type merge (moestimation.cpp:529-551) ---------------------------
#define EQ(a, b) (qmv[a][0] == qmv[b][0] && qmv[a][1] == qmv[b][1])
  const int type = (EQ(0, 1) && EQ(0, 2) && EQ(0, 3)) ? 0
                   : (EQ(0, 1) && EQ(2, 3))           ? 1
                   : (EQ(0, 2) && EQ(1, 3))           ? 2
                                                      : 4;
#undef EQ
  own.t = is_skip ? kSkip : type;
  if (!is_skip) {
    for (int q = 0; q < 4; ++q) {
      own.mv[q][0] = qmv[q][0];
      own.mv[q][1] = qmv[q][1];
    }
  }

  if (tid != 0) return;
  // ---- mvd, with the final state in place ---------------------------------
  int mvd[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
  if (!is_skip) {
    if (type == 0) {
      mvd[0][0] = qmv[0][0] - px;
      mvd[0][1] = qmv[0][1] - py;
    } else if (type == 4) {  // the search-time predictors still hold
      for (int q = 0; q < 4; ++q) {
        mvd[q][0] = qmv[q][0] - qmvp[q][0];
        mvd[q][1] = qmv[q][1] - qmvp[q][1];
      }
    } else {  // 16x8: quadrants 0 and 2; 8x16: quadrants 0 and 1
      for (int part = 0; part < 2; ++part) {
        const int q = part == 0 ? 0 : (type == 1 ? 2 : 1);
        int mx, my;
        predict(own, nbs, type, part, &mx, &my);
        mvd[part][0] = qmv[q][0] - mx;
        mvd[part][1] = qmv[q][1] - my;
      }
    }
  }
  for (int q = 0; q < 4; ++q) {
    f.mv[(mb * 4 + q) * 2] = own.mv[q][0];
    f.mv[(mb * 4 + q) * 2 + 1] = own.mv[q][1];
    f.mvd[(mb * 4 + q) * 2] = mvd[q][0];
    f.mvd[(mb * 4 + q) * 2 + 1] = mvd[q][1];
  }
  f.state_t[mb] = own.t;
  f.mb_type[mb] = type;
  f.skip[mb] = is_skip;
}

}  // namespace

// Decides a whole P frame: one launch per knight diagonal d = c + 2r on
// `stream`. Inputs and outputs as in struct Frame (W = frame width, hmb its
// MB rows). *launched gets the number of launches that were accepted.
// Returns the first CUDA error (0 when every launch was accepted).
extern "C" int wavefront_p_frame(
    const uint8_t* src, const uint8_t* planes, const int32_t* int_map,
    const int32_t* c1mv, const int32_t* q1map, const int32_t* c2mv,
    const int32_t* q2map, const uint8_t* q2ok, const int32_t* maxdiff,
    uint8_t* skip, int32_t* mb_type, int32_t* mv, int32_t* mvd,
    int32_t* state_t, int W, int hmb, int window, int ext, int metric,
    int lam, cudaStream_t stream, int* launched) {
  *launched = 0;
  const int wmb = W / 16;
  const Frame f{src, planes, int_map, c1mv, q1map, c2mv, q2map, q2ok, maxdiff,
                skip, mb_type, mv, mvd, state_t, W, 16 * hmb + 2 * ext,
                W + 2 * ext, wmb, window, ext, lam};
  const int S = 2 * window + 1;
  const size_t smem = 4 * (S * S + 98) * sizeof(int);  // 6.2 KB at window 8
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // window > 26
  for (int d = 0; d < wmb + 2 * hmb - 2; ++d) {
    const int r0 = max(0, (d - wmb + 2) / 2);  // ceil((d - wmb + 1) / 2)
    const int r1 = min(hmb - 1, d / 2);
    if (r1 < r0) continue;  // no MB on this diagonal (wmb == 1)
    const int n = r1 - r0 + 1;
    if (metric == 0) {
      decide_diag_kernel<0><<<n, kThreads, smem, stream>>>(f, d, r0);
    } else if (metric == 1) {
      decide_diag_kernel<1><<<n, kThreads, smem, stream>>>(f, d, r0);
    } else {
      decide_diag_kernel<2><<<n, kThreads, smem, stream>>>(f, d, r0);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}
