// Integer full-search score map (K2) for sm_90a.
//
// Replaces the Pallas kernel _int_kernel
// (h264_fer_tpu/kernels/me_int_pallas.py:34, called by
// integer_score_map_pallas_impl at :73) together with the XLA block fold
// that follows it (:114-117), and, on the P frame, the argmin the reference
// takes as XLA glue (codec/tpu_pframe.py:230) and the copy of the map into
// the decision's MB-quadrant order. For every 8x8 block of the source luma
// and every integer shift (dx, dy) in [-window, window]^2 it computes the
// distortion between the block and the reference window at that shift,
// read from plane 0 of the 16-phase stack (the reference edge-extended by
// ext >= window). The metric is SAD, SSD or 2*SSD (template M = 0, 1, 2).
// A map row is the block's S*S int32 scores, S = 2 window + 1, shift index
// (dy + window) * S + (dx + window); rows in raster block order
// (codec/tpu_pframe.integer_score_map's layout) or, with `mbq`, in
// MB-quadrant order (row 4 m + 2 qy + qx: block (2 r + qy, 2 c + qx) of MB
// m = r wmb + c). With `idx`, each block's first least shift index in
// raster block order, ties to the first index as argmin breaks them.
//
// What bounds it on an H100: bytes. At 1080p and window 8 it reads 2.1 MB
// of source and 2.1 MB of plane and writes the 37.7 MB map (and the 0.13
// MB index): ~0.0126 ms at 3.35 TB/s. In packed bytes its arithmetic is
// two instructions per 4 samples, 32,640 x 289 x 32 = 0.30 G, ~0.009 ms at
// the SM's issue rate. The first design (one thread per (block, dy, 4 dx)
// with scalar byte loads and 3 int32 operations a sample difference, and 4
// scalar stores a thread spread over ~6 rows 1,156 bytes apart) issued
// ~230 instructions an output value and reached 8 % of the bound.
//
// Design: a tile is one MB row's two block rows over up to kTileMbs MBs
// (4 k blocks). A persistent grid (the CTAs the SMs hold) takes tiles
// tile = blockIdx.x + n gridDim.x and runs three stages at once: the next
// tile's source rows and reference window (16 + 16 rows, 16 k + S columns
// and a few more; bytes past the plane are never scored into a kept value)
// come in as aligned words by cp.async while this tile is scored, and the
// tile before's rows leave by the bulk copy engine (cp.async.bulk). A
// landed window is first funnel-shifted in shared memory to its first
// column, which is rarely 4-byte aligned in a plane of pitch W + 2 ext.
// Thread (block, column pair dx, dx + 1) keeps its block's 16 source words
// in registers and walks its columns' reference rows once, top to bottom:
// row rr (three aligned shared-memory words, funnel-shifted to each
// column's 8 bytes) meets source row i in shift dy = rr - i, so each row it
// loads feeds up to 16 shifts, whose sums stay in registers (8 a column
// open at a time). Per row pair of a shift:
//   SAD: two vabsdiff4 with accumulate (the sum of 4 byte differences
//        added to the running sum);
//   SSD: two dp4a of reference and source words, the sum of products;
//        (r - s)^2 summed is sum r^2 - 2 sum r s + sum s^2, where sum r^2
//        comes from a running sum of each row's squares (2 dp4a a row, not
//        a pair) and sum s^2 once per thread; exact in int32, every sum
//        below 64 x 255^2. 2*SSD doubles the result.
// A shift's score goes to the tile's rows in shared memory as soon as its
// last row pair is in, and the thread keeps the first least of its scores;
// a block's argmin is the first least of its threads' (the lower index on
// ties). The window 8 instance (S = 17) has S, the tile and the row pitch
// compiled in. The tile's rows are then written whole: in MB-quadrant
// order one run of 4 k rows, in block order two (one a block row), handed
// to the bulk copy engine where a run starts and ends on 16-byte
// boundaries (always in MB-quadrant order), else stored by the threads.
// On the card (NVIDIA H100, 1080p, window 8, SAD) the scoring sets the
// time: variants of this source with the scoring skipped ran at 0.018 ms
// and with the stores skipped at 0.026, against 0.029 whole. Its 0.16 G
// vabsdiff4 (544 a thread, 16 an output) at 32 a clock an SM take 0.019
// ms, about the scoring's time.
// Earlier forms on the way, for the record: a CTA a tile with every stage
// in turn, one column a thread, an argmin pass over the staged rows, 0.040
// ms; staging alone, in 4 waves of CTAs, took 0.0125.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>
#include <mutex>

namespace {

constexpr int kC = 17;        // shift rows (dy) a thread keeps in flight at once
constexpr int kTileMbs = 8;   // MB columns of a tile (fewer where a window's rows do not fit)
constexpr int kMaxNx = 9;     // threads a block along dx, two columns each
constexpr int kMaxThreads = 4 * kTileMbs * kMaxNx;
constexpr int kSmem = 232448; // shared memory a block may have on sm_90

// acc + |a0 - b0| + |a1 - b1| + |a2 - b2| + |a3 - b3| over the bytes
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned acc) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

// The launch's shape, as the host computes it (launch_shape).
struct Shape {
  int S, nx, rows, tk, pw;  // shifts a side, threads along dx, window rows, tile, row words
};

// Threads along dx (two columns each), the window's row count (16 + chunks
// * kC - 1: the rows a chunk's kC shift rows read) and words a row, pw: the
// three funnel words of the tile's last block's last column pair,
// 8 (2 tk - 1) + S - 1.
__host__ __device__ constexpr Shape shape_of(int S, int tk) {
  return Shape{S, (S + 1) / 2 < kMaxNx ? (S + 1) / 2 : kMaxNx,
               16 + (S + kC - 1) / kC * kC - 1, tk, (16 * tk + S - 9) / 4 + 3};
}

// Words a landed window row: a word more than pw, rounded up to even so
// that the landed source after the rows stays 8-byte aligned.
__host__ __device__ constexpr int raw_pitch(int pw) { return (pw + 2) & ~1; }

// Shared memory, in words, from offset 0: the tile's map rows; two landed
// buffers, each a window and the source rows after it (while a tile is
// scored, its landed window, already aligned, holds each thread's least
// score and its index); the aligned window.
struct Layout {
  int raw, ref, words;  // one landed buffer's size; the aligned window's offset; total
};

__host__ __device__ constexpr Layout layout_of(Shape s) {
  return Layout{s.rows * raw_pitch(s.pw) + 16 * 4 * s.tk,
                4 * s.tk * s.S * s.S + 2 * (s.rows * raw_pitch(s.pw) + 16 * 4 * s.tk),
                4 * s.tk * s.S * s.S + 2 * (s.rows * raw_pitch(s.pw) + 16 * 4 * s.tk) +
                    s.rows * s.pw};
}

// A tile: MB columns [c0, c0 + k) of MB row r.
struct Tile {
  int k, c0, r;
};

__device__ __forceinline__ Tile tile_of(int tile, int tk, int tiles_x, int wmbc) {
  Tile t;
  t.r = tile / tiles_x;
  t.c0 = (tile - t.r * tiles_x) * tk;
  t.k = min(tk, wmbc - t.c0);
  return t;
}

// The slot's block within the tile: (qy, jx) = block row 0/1, block column
// 0 .. 2k - 1; slot order is the output order of the tile's rows.
__device__ __forceinline__ void slot_block(int slot, int k, bool mbq, int& qy, int& jx) {
  if (mbq) {
    const int q = slot & 3;
    jx = 2 * (slot >> 2) + (q & 1);
    qy = q >> 1;
  } else {
    qy = slot / (2 * k);
    jx = slot - qy * 2 * k;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of one 4-byte word, zeros where `valid` is false
__device__ __forceinline__ void copy_word(uint32_t* dst, const uint32_t* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Score kC shift rows c0 .. c0 + kC - 1 of columns dx and dx + 1 for one
// block: ref points at the block's first reference row (row c0 of the
// shift) in shared memory, words apart `pw` a row; fs the funnel shift of
// column dx; s the 16 source words, ssq the sum of their squares. Calls
// put(dy, column 0/1, score) as each shift row completes, column 0 first.
template <int M, class Put>
__device__ __forceinline__ void score_columns(const uint32_t* ref, int pw, unsigned fs,
                                              const uint32_t (&s)[16], unsigned ssq, Put put) {
  // at row rr the shifts rr - 7 .. rr are open: 8 sums a column in flight
  unsigned acc[2][kC];
#pragma unroll
  for (int d = 0; d < kC; ++d) acc[0][d] = acc[1][d] = 0;
  unsigned cum[2][kC + 8];  // SSD: cum[c][rr] = sum of the squares of rows 0 .. rr - 1
  cum[0][0] = cum[1][0] = 0;
#pragma unroll
  for (int rr = 0; rr < kC + 7; ++rr) {
    const uint32_t* p = ref + rr * pw;
    const uint32_t w0 = p[0], w1 = p[1], w2 = p[2];
    // column dx + 1 starts a byte later; at shift 32 its words are w1, w2
    const unsigned r[2][2] = {{__funnelshift_r(w0, w1, fs), __funnelshift_r(w1, w2, fs)},
                              {__funnelshift_rc(w0, w1, fs + 8), __funnelshift_rc(w1, w2, fs + 8)}};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (M != 0) cum[c][rr + 1] = __dp4a(r[c][1], r[c][1], __dp4a(r[c][0], r[c][0], cum[c][rr]));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = rr - i;
        if (d < 0 || d >= kC) continue;
        if (M == 0) {
          acc[c][d] = sad4(r[c][1], s[2 * i + 1], sad4(r[c][0], s[2 * i], acc[c][d]));
        } else {
          acc[c][d] = __dp4a(r[c][1], s[2 * i + 1], __dp4a(r[c][0], s[2 * i], acc[c][d]));
        }
      }
    }
    if (rr >= 7) {
      const int d = rr - 7;  // its 8th and last row pair is in
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (M == 0) {
          put(d, c, (int)acc[c][d]);
        } else {
          const int v = (int)(ssq + (cum[c][rr + 1] - cum[c][d]) - 2u * acc[c][d]);
          put(d, c, M == 2 ? 2 * v : v);
        }
      }
    }
  }
}

// KS: 17 for the instance with the window 8 shape compiled in, else 0 (the
// shape from the arguments).
template <int M, int KS>
__global__ void __launch_bounds__(kMaxThreads, 4)
int_search_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ plane,
                  int W, int H, int ext, int window, Shape sh_rt, int tiles_x, int ntiles,
                  int mbq, int32_t* __restrict__ out, int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Shape sh = KS ? shape_of(KS, kTileMbs) : sh_rt;
  const Layout lay = layout_of(sh);
  const int S = sh.S, S2 = S * S, nx = sh.nx, rows = sh.rows, pw = sh.pw, tk = sh.tk;
  const int pwr = raw_pitch(pw);  // landed words a window row
  const int spw = 4 * tk;         // source words a row
  const int he = H + 2 * ext, we = W + 2 * ext;
  const int wb = W >> 3, hb = H >> 3, wmbc = (wb + 1) >> 1;
  const uint32_t* pwords = reinterpret_cast<const uint32_t*>(plane);
  const size_t last_word = ((size_t)he * we - 1) >> 2;  // the plane's last word
  int32_t* s_out = reinterpret_cast<int32_t*>(smem);
  uint32_t* s_ref = smem + lay.ref;

  // cp.async of tile `tile`'s window rows (the aligned words from each row's
  // first byte down) and source rows into landed buffer b
  auto stage = [&](int tile, int b) {
    const Tile t = tile_of(tile, tk, tiles_x, wmbc);
    uint32_t* raw = smem + 4 * tk * S2 + b * lay.raw;
    const int y0 = 16 * t.r + ext - window, x0 = 16 * t.c0 + ext - window;
    for (int e = threadIdx.x; e < rows * pwr; e += blockDim.x) {
      const int rr = e / pwr, w = e - rr * pwr;
      const int gy = y0 + rr;  // rows past the plane feed no kept score
      const size_t wi = min((((size_t)gy * we + x0) >> 2) + w, last_word);
      copy_word(raw + e, pwords + (gy < he ? wi : 0), gy < he);
    }
    uint32_t* raw_src = raw + rows * pwr;
    for (int e = threadIdx.x; e < 16 * spw; e += blockDim.x) {
      const int i = e / spw, w = e - i * spw;
      const int gy = 16 * t.r + i, gx = 16 * t.c0 + 4 * w;
      const bool ok = gy < H && gx < W;
      copy_word(raw_src + e,
                reinterpret_cast<const uint32_t*>(src + (ok ? (size_t)gy * W + gx : 0)), ok);
    }
  };

  int tile = blockIdx.x;
  if (tile < ntiles) stage(tile, 0);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const int b = it & 1;
    const Tile t = tile_of(tile, tk, tiles_x, wmbc);
    const int nslots = 4 * t.k;
    uint32_t* raw = smem + 4 * tk * S2 + b * lay.raw;
    const uint32_t* s_src = raw + rows * pwr;
    int2* s_cand = reinterpret_cast<int2*>(raw);  // once the window is aligned
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    // the next tile comes in while this one is scored (its buffer's last
    // reads, the tile before's, are behind the barrier)
    if (tile + (int)gridDim.x < ntiles) stage(tile + gridDim.x, b ^ 1);
    asm volatile("cp.async.commit_group;" ::: "memory");

    // ---- the window, aligned: row rr from its first byte -------------------
    {
      const int y0 = 16 * t.r + ext - window, x0 = 16 * t.c0 + ext - window;
      for (int e = threadIdx.x; e < rows * pw; e += blockDim.x) {
        const int rr = e / pw, w = e - rr * pw;
        const unsigned a = (unsigned)(((size_t)(y0 + rr) * we + x0) & 3);
        s_ref[e] = __funnelshift_r(raw[rr * pwr + w], raw[rr * pwr + w + 1], 8u * a);
      }
    }
    // the tile before's bulk store done reading the map rows
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncthreads();

    // ---- score: thread (slot, xl) takes column pairs dx = 2 xl, 2 xl + 2 nx,
    // ... and keeps the first least score of its columns
    const int slot = threadIdx.x / nx, xl = threadIdx.x - slot * nx;
    if (slot < nslots) {
      int qy, jx;
      slot_block(slot, t.k, mbq, qy, jx);
      int best = INT_MAX, bi = INT_MAX;
      if (2 * t.c0 + jx < wb && 2 * t.r + qy < hb) {
        uint32_t s[16];
        unsigned ssq = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint2 v = *reinterpret_cast<const uint2*>(s_src + (qy * 8 + i) * spw + 2 * jx);
          s[2 * i] = v.x;
          s[2 * i + 1] = v.y;
          if (M != 0) ssq = __dp4a(v.y, v.y, __dp4a(v.x, v.x, ssq));
        }
        int32_t* o = s_out + slot * S2;
        auto keep = [&](int v, int q) {  // the first least: lower index on ties
          o[q] = v;
          if (v < best || (v == best && q < bi)) {
            best = v;
            bi = q;
          }
        };
        if (KS) {  // one column pair and one chunk of shift rows a thread
          const int dx = 2 * xl, col = 8 * jx + dx;
          score_columns<M>(s_ref + qy * 8 * pw + (col >> 2), pw, 8u * (unsigned)(col & 3), s,
                           ssq, [&](int d, int c, int v) {
                             if (dx + c < S) keep(v, d * S + dx + c);
                           });
        } else {
          for (int dx = 2 * xl; dx < S; dx += 2 * nx) {
            const int col = 8 * jx + dx;
            for (int c0 = 0; c0 < S; c0 += kC) {
              score_columns<M>(s_ref + (qy * 8 + c0) * pw + (col >> 2), pw,
                               8u * (unsigned)(col & 3), s, ssq, [&](int d, int c, int v) {
                                 if (c0 + d < S && dx + c < S) keep(v, (c0 + d) * S + dx + c);
                               });
            }
          }
        }
      }
      s_cand[threadIdx.x] = make_int2(best, bi);
    }
    // the map rows' writes, seen by the bulk copies
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    // ---- the argmin: a block's first least score over its nx threads' -----
    if (idx != nullptr && threadIdx.x < nslots) {
      int qy, jx;
      slot_block(threadIdx.x, t.k, mbq, qy, jx);
      const int bx = 2 * t.c0 + jx, by = 2 * t.r + qy;
      if (bx < wb && by < hb) {
        int2 m = s_cand[threadIdx.x * nx];
        for (int x = 1; x < nx; ++x) {
          const int2 c = s_cand[threadIdx.x * nx + x];
          if (c.x < m.x || (c.x == m.x && c.y < m.y)) m = c;
        }
        idx[by * wb + bx] = m.y;
      }
    }

    // ---- write the tile's rows whole: runs of slots [s0, s0 + n) to the
    // map rows from g0
    for (int run = 0; run < (mbq ? 1 : 2); ++run) {
      int s0, n;
      size_t g0;
      if (mbq) {
        s0 = 0;
        n = nslots;
        g0 = 4 * ((size_t)t.r * wmbc + t.c0);
      } else {
        const int by = 2 * t.r + run;
        if (by >= hb) break;
        s0 = run * 2 * t.k;
        n = min(2 * t.k, wb - 2 * t.c0);
        g0 = (size_t)by * wb + 2 * t.c0;
      }
      const int32_t* from = s_out + s0 * S2;
      int32_t* to = out + g0 * S2;
      const int len = n * S2;
      if (((reinterpret_cast<uintptr_t>(to) | reinterpret_cast<uintptr_t>(from) | (4 * len)) &
           15) == 0) {
        if (threadIdx.x == 0)
          asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                       :: "l"(to), "r"(smem_addr(from)), "r"(4 * len) : "memory");
      } else {
        for (int e = threadIdx.x; e < len; e += blockDim.x) to[e] = from[e];
      }
    }
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The launch's shape: the widest tile (kTileMbs, then halves) whose
// shared memory fits; tk 0 where none does.
Shape launch_shape(int window) {
  const int S = 2 * window + 1;
  for (int tk = kTileMbs; tk >= 1; tk /= 2) {
    const Shape s = shape_of(S, tk);
    if (4 * (size_t)layout_of(s).words <= kSmem) return s;
  }
  return Shape{S, 0, 0, 0, 0};
}

template <int M, int KS>
cudaError_t launch(const uint8_t* src, const uint8_t* plane, int32_t* out, int32_t* idx, int W,
                   int H, int ext, int window, int mbq, Shape s, cudaStream_t stream) {
  const int wb = W / 8, hb = H / 8, wmbc = (wb + 1) / 2;
  const int tiles_x = (wmbc + s.tk - 1) / s.tk, ntiles = tiles_x * ((hb + 1) / 2);
  const int threads = (4 * s.tk * s.nx + 31) / 32 * 32;
  const size_t bytes = 4 * (size_t)layout_of(s).words;
  // the shared-memory allowance and the CTAs an SM holds, set and asked for
  // again only when the device or the launch's shape changes
  static std::mutex mu;
  static int last_dev = -1, last_threads = 0, grid_max = 0;
  static size_t last_bytes = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int grid = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev != last_dev || threads != last_threads || bytes != last_bytes) {
      int sms = 0, per_sm = 0;
      if ((err = cudaFuncSetAttribute(int_search_kernel<M, KS>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)bytes)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
              cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int_search_kernel<M, KS>,
                                                               threads, bytes)) != cudaSuccess)
        return err;
      if (per_sm < 1) return cudaErrorInvalidValue;
      last_dev = dev;
      last_threads = threads;
      last_bytes = bytes;
      grid_max = per_sm * sms;
    }
    grid = grid_max;
  }
  int_search_kernel<M, KS><<<ntiles < grid ? ntiles : grid, threads, bytes, stream>>>(
      src, plane, W, H, ext, window, s, tiles_x, ntiles, mbq, out, idx);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_metric(const uint8_t* src, const uint8_t* plane, int32_t* out, int32_t* idx,
                          int W, int H, int ext, int window, int mbq, cudaStream_t stream) {
  const Shape s = launch_shape(window);
  if (s.tk == 0) return cudaErrorInvalidValue;
  if (s.S == 17 && s.tk == kTileMbs)
    return launch<M, 17>(src, plane, out, idx, W, H, ext, window, mbq, s, stream);
  return launch<M, 0>(src, plane, out, idx, W, H, ext, window, mbq, s, stream);
}

}  // namespace

// src (H, W) and plane (H + 2 ext, W + 2 ext) uint8, row-major, both
// 4-byte aligned, H and W multiples of 8 (of 16 with mbq); out (nb, S*S)
// int32 map rows in block order, or in MB-quadrant order with mbq, 16-byte
// aligned; idx (nb,) int32 or null. Returns the CUDA error of the launch
// (0 when it was accepted; cudaErrorInvalidValue where a tile's rows do
// not fit in shared memory) and counts it in *launched.
extern "C" int me_int_score_map(const uint8_t* src, const uint8_t* plane, int32_t* out,
                                int32_t* idx, int W, int H, int ext, int window, int metric,
                                int mbq, cudaStream_t stream, int* launched) {
  *launched = 0;
  if (W <= 0 || H <= 0 || W % 8 || H % 8 || window < 0 || window > ext ||
      (mbq && (W % 16 || H % 16)))
    return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err =
      metric == 0   ? launch_metric<0>(src, plane, out, idx, W, H, ext, window, mbq, stream)
      : metric == 1 ? launch_metric<1>(src, plane, out, idx, W, H, ext, window, mbq, stream)
                    : launch_metric<2>(src, plane, out, idx, W, H, ext, window, mbq, stream);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
