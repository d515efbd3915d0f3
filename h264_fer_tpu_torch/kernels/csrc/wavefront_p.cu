// P-frame decision wavefront (K4) in knight order, for sm_90a.
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
// d = c + 2r, so the critical path is wmb + 2 hmb - 2 MBs long (254 at
// 1080p), with at most min(hmb, ceil(wmb / 2)) MBs (60) ready at once.
//
// Design: one launch per frame (csrc/mb_dataflow.cuh): a persistent grid
// of one-warp blocks takes the MBs in knight order by ticket, and each MB
// starts as soon as its four neighbours have published their state, not
// when the whole previous diagonal is done. Before it waits, the warp
// stages what does not depend on the neighbours in shared memory: the
// source MB and the quadrant centres (cp.async), then for each quadrant
// every candidate's distortion (INT_MAX where q2ok masks it) and MV, so
// that after the wait a candidate costs two shared loads and a handful of
// operations (a lone warp on its SM pays every latency in full). After the
// acquire it reads the neighbours' final quadrant MVs and type (`mv`,
// `state_t`, written in this launch, so never through the read-only path).
// Every lane carries
// the same scalar state of the MB (own.t, own.mv) and computes the
// predictors alike; the lanes share the per-candidate and per-sample work:
// the argmin of distortion + lam * |mv - mvp| over each quadrant's
// candidates (lane k mod 32, a (cost, index) shuffle reduction), the
// 256-sample skip test (a warp vote) and the four unify windows (shuffle
// sums). One warp needs no block barrier, and the window loads are issued
// early: the skip window's before quadrant 0 (whose predictor reads
// neighbours only), each unify window's as soon as its quadrant MV is
// known. Lane 0 writes the state later MBs read, the warp publishes it,
// and lane 0 then writes the mvd, type and skip flag, which no later MB
// reads.
//
// K4-band (wavefront_p_band) is the same kernel over the MB rows of one
// band of a frame (the band= form of the XLA twin, pframe_decide_impl
// :177-423), taking the band's own knight order: 152 steps for a band of
// 17 MB rows at 1080p against the frame's 254. Its row 0 reads the top,
// top-right and top-left neighbours' final MVs and types from a row of
// state before the launch (top_mv, top_t: the band above's last MB row,
// has_top), where the reference sends them from the band above on every
// wave. It is the instance decide_kernel<M, true>, so that the frame's
// instance keeps its code: reading has_top there made ptxas spill the
// intra wavefront K1 (PERF.md).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "mb_dataflow.cuh"

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
                          // (mv and state_t are written in the launch: no __ldg)
  const int32_t* top_mv;  // band: (wmb, 4, 2) final MVs of the MB row above
  const int32_t* top_t;   // band: (wmb,) its types (kSkip or type)
  bool has_top;           // band: row 0 has that row above it
  int W, he, we, wmb, window, ext, lam;
};

constexpr int kThreads = 32;  // one warp per MB
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

// Component a of the MB's own MV of partition pidx, by selects, so that
// `own` stays in registers.
__device__ __forceinline__ int own_mv(const State& own, int pidx, int a) {
  return pidx == 0 ? own.mv[0][a] : pidx == 1 ? own.mv[1][a]
         : pidx == 2 ? own.mv[2][a] : own.mv[3][a];
}

// Neighbour MV and existence at in-MB sample offset (xn, yn)
// (DeriveNeighbourLocation, mode_pred.cpp:61-97). nb: left, top, top-right,
// top-left, in shared memory. No MB is intra, so a neighbour that exists
// has reference 0.
__device__ __forceinline__ Nb fetch(const State& own, const State* nb, int xn, int yn) {
  Nb n{0, 0, false};
  if ((xn > 15 && yn >= 0) || yn > 15) return n;
  const bool in_own = xn >= 0 && xn < 16 && yn >= 0;
  const State* s = nb;
  int xw = xn, yw = yn;
  if (xn >= 0 && xn < 16) {
    if (yn < 0) {
      s = &nb[1]; yw = yn + 16;
    }
  } else if (xn > 15) {
    s = &nb[2]; xw = xn - 16; yw = yn + 16;
  } else if (yn < 0) {
    s = &nb[3]; xw = xn + 16; yw = yn + 16;
  } else {
    s = &nb[0]; xw = xn + 16;
  }
  const int t = in_own ? own.t : s->t;
  if (t == kNone) return n;
  int pidx = 0;
  if (t != kSkip) {  // partition of (xw, yw) under type t (h264_globals.h:123-128)
    const int ti = min(max(t, 0), 4);
    const int pw = ti == 0 || ti == 1 ? 16 : 8;
    const int ph = ti == 0 || ti == 2 ? 16 : 8;
    pidx = ((yw / ph) << 1) + xw / pw;
  }
  n.x = in_own ? own_mv(own, pidx, 0) : s->mv[pidx][0];
  n.y = in_own ? own_mv(own, pidx, 1) : s->mv[pidx][1];
  n.ex = true;
  return n;
}

__device__ __forceinline__ int med3(int a, int b, int c) {
  return a + b + c - max(a, max(b, c)) - min(a, min(b, c));
}

// PredictMV_Luma for the encoder's partitions (mode_pred.cpp:252-371).
__device__ __forceinline__ void predict(const State& own, const State* nbs, int type, int part,
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

// A candidate MV (x, y), both within +-32767 qpel, as one int, and back.
__device__ __forceinline__ int pack_mv(int x, int y) { return y * 65536 + (x & 0xffff); }
__device__ __forceinline__ int mv_x(int v) { return (int)(int16_t)(v & 0xffff); }
__device__ __forceinline__ int mv_y(int v) { return v >> 16; }

// (cost, index) of two lanes: the smaller cost, the first index on ties.
__device__ __forceinline__ void warp_argmin(int* best, int* bk) {
  for (int o = 16; o; o >>= 1) {
    const int ob = __shfl_xor_sync(kAll, *best, o);
    const int ok = __shfl_xor_sync(kAll, *bk, o);
    if (ob < *best || (ob == *best && ok < *bk)) {
      *best = ob;
      *bk = ok;
    }
  }
}

// kBand: the band entry point's instance, which reads f.top_mv / f.top_t
// at row 0 when f.has_top; the frame's never reads them.
template <int M, bool kBand>
__global__ void __launch_bounds__(kThreads)
decide_kernel(Frame f, Dataflow df) {
  // per quadrant q, candidate k in [integer shifts | c1 + offsets | c2 +
  // offsets] order: its distortion (INT_MAX where masked) at s_d[q * NC +
  // k] and its MV (pack_mv) at s_m[q * NC + k]
  extern __shared__ int s_dyn[];
  const int S = 2 * f.window + 1, S2 = S * S, NC = S2 + 98;
  int* s_d = s_dyn;
  int* s_m = s_dyn + 4 * NC;
  __shared__ __align__(16) uint8_t s_src[256];
  __shared__ __align__(16) int s_cen[2][4][2];  // c1, c2 per quadrant
  __shared__ State s_nb[4];                     // left, top, top-right, top-left
  __shared__ int s_mb;
  const int lane = threadIdx.x;

  for (;;) {
    const int mb = dataflow_next(df, &s_mb);
    if (mb < 0) return;
    const int r = mb / f.wmb, c = mb - r * f.wmb;
    const int x0 = c * 16, y0 = r * 16;

    // ---- what does not depend on the neighbours, before the wait: the
    // source MB and the centres (cp.async), then every candidate's
    // distortion and MV, so that after the wait a candidate costs two
    // shared loads and a few operations --------------------------------------
    if (lane < 16) {
      cp_async16(s_src + 16 * lane, f.src + (size_t)(y0 + lane) * f.W + x0);
    } else if (lane < 20) {
      const int i = lane - 16;  // c1 lo, c1 hi, c2 lo, c2 hi
      cp_async16(&s_cen[i >> 1][2 * (i & 1)][0],
                 ((i >> 1) ? f.c2mv : f.c1mv) + mb * 8 + 4 * (i & 1));
    }
    const int md = f.maxdiff[mb];
    cp_async_wait_all();
    __syncwarp();
    for (int q = 0; q < 4; ++q) {
      const bool ok2 = f.q2ok[mb * 4 + q];
#pragma unroll 4
      for (int k = lane; k < NC; k += kThreads) {
        int d, vx, vy;
        if (k < S2) {
          d = f.int_map[((size_t)mb * 4 + q) * S2 + k];
          vx = (k % S - f.window) * 4;
          vy = (k / S - f.window) * 4;
        } else {
          const bool second = k >= S2 + 49;
          const int o = k - S2 - (second ? 49 : 0);
          d = second ? (ok2 ? f.q2map[(mb * 4 + q) * 49 + o] : INT_MAX)
                     : f.q1map[(mb * 4 + q) * 49 + o];
          vx = s_cen[second][q][0] + o % 7 - 3;
          vy = s_cen[second][q][1] + o / 7 - 3;
        }
        s_d[q * NC + k] = d;
        s_m[q * NC + k] = pack_mv(vx, vy);
      }
    }
    dataflow_wait(df, r, c, f.wmb);

    // ---- the neighbours' final state (written in this launch) -----------
    if (lane < 4) {
      const int rn = lane == 0 ? r : r - 1;
      const int cn = lane == 0 ? c - 1 : (lane == 1 ? c : (lane == 2 ? c + 1 : c - 1));
      State& s = s_nb[lane];
      s.t = kNone;
      for (int q = 0; q < 4; ++q) s.mv[q][0] = s.mv[q][1] = 0;
      if (rn >= 0 && cn >= 0 && cn < f.wmb) {
        const int n = rn * f.wmb + cn;
        s.t = f.state_t[n];
        for (int q = 0; q < 4; ++q) {
          s.mv[q][0] = f.mv[(n * 4 + q) * 2];
          s.mv[q][1] = f.mv[(n * 4 + q) * 2 + 1];
        }
      } else if (kBand && f.has_top && rn < 0 && cn >= 0 && cn < f.wmb) {
        s.t = f.top_t[cn];  // the band above's last row, written before the launch
        for (int q = 0; q < 4; ++q) {
          s.mv[q][0] = f.top_mv[(cn * 4 + q) * 2];
          s.mv[q][1] = f.top_mv[(cn * 4 + q) * 2 + 1];
        }
      }
    }
    __syncwarp();
    const State* nbs = s_nb;
    State own;
    own.t = 4;
    for (int q = 0; q < 4; ++q) own.mv[q][0] = own.mv[q][1] = 0;

    // ---- P_Skip: its 16x16 predictor reads neighbours only; the window's
    // loads are issued now and tested after quadrant 0, whose predictor
    // reads neighbours only too ----------------------------------------------
    int px, py;
    predict(own, nbs, 0, 0, &px, &py);
    int sx = 0, sy = 0;
    // a band's row 0 is no frame edge when it has a row above (the halo's)
    if ((r > 0 || (kBand && f.has_top)) && c > 0 &&
        !(nbs[1].mv[2][0] == 0 && nbs[1].mv[2][1] == 0) &&
        !(nbs[0].mv[1][0] == 0 && nbs[0].mv[1][1] == 0)) {
      sx = px;
      sy = py;
    }
    int win[5][8];  // the skip window, then the four unify windows
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = lane + 32 * i;
      win[0][i] = sample(f, sx, sy, x0 + (k & 15), y0 + (k >> 4));
    }

    // ---- per-quadrant search: every lane takes candidates k = lane + 32 i
    // and the warp reduces (cost, k); each quadrant's unify window is read
    // as soon as its MV is known ----------------------------------------------
    int qmv[4][2], qmvp[4][2];
    int split = 0;
    bool is_skip = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q == 1) {  // the skip test, before the first in-MB predictor
        int fits = 1;
#pragma unroll
        for (int i = 0; i < 8; ++i) fits &= iabs(s_src[lane + 32 * i] - win[0][i]) <= md;
        is_skip = __all_sync(kAll, fits);
        own.t = is_skip ? kSkip : 4;
        for (int j = 0; j < 4; ++j) {
          own.mv[j][0] = is_skip || j > 0 ? sx : qmv[0][0];
          own.mv[j][1] = is_skip || j > 0 ? sy : qmv[0][1];
        }
      }
      int mx, my;
      predict(own, nbs, 4, q, &mx, &my);
      qmvp[q][0] = mx;
      qmvp[q][1] = my;
      const int* qd = s_d + q * NC;
      const int* qm = s_m + q * NC;
      int best = INT_MAX, bk = INT_MAX;
#pragma unroll 4
      for (int k = lane; k < NC; k += kThreads) {  // k rises: the first minimum
        const int d = qd[k], v = qm[k];
        const int cost = d == INT_MAX ? INT_MAX
                         : d + f.lam * (iabs(mv_x(v) - mx) + iabs(mv_y(v) - my));
        if (cost < best) {
          best = cost;
          bk = k;
        }
      }
      warp_argmin(&best, &bk);
      qmv[q][0] = mv_x(qm[bk]);
      qmv[q][1] = mv_y(qm[bk]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = lane + 32 * i;
        win[1 + q][i] = sample(f, qmv[q][0], qmv[q][1], x0 + (k & 15), y0 + (k >> 4));
      }
      split += best;
      if (q > 0 && !is_skip) {
        own.mv[q][0] = qmv[q][0];
        own.mv[q][1] = qmv[q][1];
      }
    }

    // ---- 16x16 unify trial (encoder._maybe_unify): the four windows; their
    // predictor is the 16x16 one again (neighbours only, unchanged) ---------
    bool all_eq0 = true;
    for (int q = 1; q < 4; ++q)
      all_eq0 &= qmv[q][0] == qmv[0][0] && qmv[q][1] == qmv[0][1];
    if (!is_skip && !all_eq0) {
      int best_c = split, ux = 0, uy = 0;
      bool found = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int sum = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += dist<M>(win[1 + j][i] - s_src[lane + 32 * i]);
        sum = warp_sum(sum);
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

    // ---- mb_type merge (moestimation.cpp:529-551) -------------------------
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

    // ---- the state later MBs read, then publish ---------------------------
    if (lane == 0) {
      int4* mv4 = reinterpret_cast<int4*>(f.mv + mb * 8);
      mv4[0] = make_int4(own.mv[0][0], own.mv[0][1], own.mv[1][0], own.mv[1][1]);
      mv4[1] = make_int4(own.mv[2][0], own.mv[2][1], own.mv[3][0], own.mv[3][1]);
      f.state_t[mb] = own.t;
    }
    dataflow_publish(df, mb);
    if (lane != 0) continue;

    // ---- mvd, with the final state in place -------------------------------
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
      f.mvd[(mb * 4 + q) * 2] = mvd[q][0];
      f.mvd[(mb * 4 + q) * 2 + 1] = mvd[q][1];
    }
    f.mb_type[mb] = type;
    f.skip[mb] = is_skip;
  }
}

// One launch of decide_kernel<M, kBand> over frame f (the K4 and K4-band
// entry points' common body).
template <bool kBand>
int launch_decide(const Frame& f, const int32_t* order, int32_t* sched, int nmb,
                  int metric, int blocks, cudaStream_t stream, int* launched) {
  *launched = 0;
  const Dataflow df{order, sched, nmb};
  const int S = 2 * f.window + 1;
  // 4 x 387 distortions and MVs: 12.4 KB at window 8
  const size_t smem = 8 * (S * S + 98) * sizeof(int);
  void (*kernel)(Frame, Dataflow) =
      metric == 0 ? &decide_kernel<0, kBand>
                  : (metric == 1 ? &decide_kernel<1, kBand> : &decide_kernel<2, kBand>);
  if (smem > 48 * 1024) {  // above window 17: opt in to more shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = dataflow_grid(kernel, kThreads, smem, nmb, blocks);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, smem, stream>>>(f, df);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

}  // namespace

// Decides a whole P frame in one launch on `stream`: a persistent grid of
// `blocks` blocks (0: as many as fit on the card; at most nmb) taking the
// MBs in the knight order `order` (nmb,) through the dataflow scratch
// `sched` (nmb + 1 int32, zeroed). Inputs and outputs as in struct Frame
// (W = frame width, hmb its MB rows). *launched gets 1 when the launch was
// accepted. Returns its CUDA error (0 when accepted).
extern "C" int wavefront_p_frame(
    const uint8_t* src, const uint8_t* planes, const int32_t* int_map,
    const int32_t* c1mv, const int32_t* q1map, const int32_t* c2mv,
    const int32_t* q2map, const uint8_t* q2ok, const int32_t* maxdiff,
    uint8_t* skip, int32_t* mb_type, int32_t* mv, int32_t* mvd,
    int32_t* state_t, const int32_t* order, int32_t* sched, int W, int hmb,
    int window, int ext, int metric, int lam, int blocks, cudaStream_t stream,
    int* launched) {
  const int wmb = W / 16;
  const Frame f{src, planes, int_map, c1mv, q1map, c2mv, q2map, q2ok, maxdiff,
                skip, mb_type, mv, mvd, state_t, nullptr, nullptr, false, W,
                16 * hmb + 2 * ext, W + 2 * ext, wmb, window, ext, lam};
  return launch_decide<false>(f, order, sched, wmb * hmb, metric, blocks, stream,
                              launched);
}

// K4-band: wavefront_p_frame over one band of hmb MB rows (its planes,
// maps and outputs; order its own knight order), and has_top: when 1, row
// 0 reads its top, top-right and top-left neighbours' final MVs and types
// from top_mv (wmb, 4, 2) and top_t (wmb,), the band above's last MB row,
// which no launch writes while this one runs.
extern "C" int wavefront_p_band(
    const uint8_t* src, const uint8_t* planes, const int32_t* int_map,
    const int32_t* c1mv, const int32_t* q1map, const int32_t* c2mv,
    const int32_t* q2map, const uint8_t* q2ok, const int32_t* maxdiff,
    uint8_t* skip, int32_t* mb_type, int32_t* mv, int32_t* mvd,
    int32_t* state_t, const int32_t* top_mv, const int32_t* top_t,
    const int32_t* order, int32_t* sched, int W, int hmb, int has_top,
    int window, int ext, int metric, int lam, int blocks, cudaStream_t stream,
    int* launched) {
  const int wmb = W / 16;
  const Frame f{src, planes, int_map, c1mv, q1map, c2mv, q2map, q2ok, maxdiff,
                skip, mb_type, mv, mvd, state_t, top_mv, top_t, has_top != 0, W,
                16 * hmb + 2 * ext, W + 2 * ext, wmb, window, ext, lam};
  return launch_decide<true>(f, order, sched, wmb * hmb, metric, blocks, stream,
                             launched);
}
