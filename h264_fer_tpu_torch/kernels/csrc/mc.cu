// Whole-frame motion compensation (K5) for sm_90a.
//
// Replaces the Pallas kernel _mc_kernel (h264_fer_tpu/kernels/mc_pallas.py:42,
// called by mc_bulk_pallas_impl at :98). It computes the same function: the
// inter prediction of a P frame at its final per-quadrant MVs (mocomp.cpp:
// 152-208). Luma sample (x, y) of quadrant MV (mvx, mvy) is phase
// (mvy & 3) * 4 + (mvx & 3) of the 16-phase stack at
// (x + (mvx >> 2) + ext, y + (mvy >> 2) + ext); chroma sample (x, y) is the
// eighth-pel bilinear ((8-fx)(8-fy)a + fx(8-fy)b + (8-fx)fy c + fx fy d
// + 32) >> 6 of the padded plane at (x + (mvx >> 3) + ext_c + 1, ...), with
// fx = mvx & 7, fy = mvy & 7. Shifts and masks act on signed int:
// arithmetic shift, two's-complement mask. Outputs int32 planes, as
// codec/tpu_pframe.mc_luma_bulk and mc_chroma_bulk return them.
//
// What bounds it on an H100: bytes. At 1080p it writes 12.5 MB of int32
// predictions and reads at most one phase sample per luma output (2.1 MB
// of the 34 MB uint8 phase stack), the bilinear taps of nonzero weight in
// the padded chroma (at most 1.1 MB) and 0.26 MB of MVs: ~16 MB, ~0.005 ms
// at 3.35 TB/s; its few operations per sample take less.
//
// Design: one launch and one thread per output sample, luma first, then Cb,
// then Cr. Neighbouring threads read neighbouring samples of one phase
// plane (a quadrant shares its MV), so the reads coalesce. Read positions
// are clamped into the planes: an MV outside the caller's range contract
// gives a wrong sample, never a read outside the buffer. No strips, no
// rolls, no per-MB output slots to transpose back.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void mc_kernel(const uint8_t* __restrict__ planes,
                          const uint8_t* __restrict__ cb_pad,
                          const uint8_t* __restrict__ cr_pad,
                          const int32_t* __restrict__ mv, int W, int H, int ext,
                          int ext_c, int32_t* __restrict__ pred_y,
                          int32_t* __restrict__ pred_cb,
                          int32_t* __restrict__ pred_cr) {
  const int wmb = W / 16;
  const int nl = W * H, wc = W / 2, nc = wc * (H / 2);
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nl + 2 * nc) return;
  if (t < nl) {
    const int y = t / W, x = t % W;
    const int mb = (y >> 4) * wmb + (x >> 4);
    const int q = ((y >> 3) & 1) * 2 + ((x >> 3) & 1);
    const int mvx = mv[(mb * 4 + q) * 2], mvy = mv[(mb * 4 + q) * 2 + 1];
    const int he = H + 2 * ext, we = W + 2 * ext;
    const int px = min(max(x + (mvx >> 2) + ext, 0), we - 1);
    const int py = min(max(y + (mvy >> 2) + ext, 0), he - 1);
    pred_y[t] = planes[(size_t)((mvy & 3) * 4 + (mvx & 3)) * he * we + py * we + px];
    return;
  }
  t -= nl;
  const bool is_cr = t >= nc;
  if (is_cr) t -= nc;
  const int y = t / wc, x = t % wc;
  const int mb = (y >> 3) * wmb + (x >> 3);
  const int q = ((y >> 2) & 1) * 2 + ((x >> 2) & 1);
  const int mvx = mv[(mb * 4 + q) * 2], mvy = mv[(mb * 4 + q) * 2 + 1];
  const int hp = H / 2 + 2 * ext_c + 2, wp = wc + 2 * ext_c + 2;
  const int cx = min(max(x + (mvx >> 3) + ext_c + 1, 0), wp - 2);
  const int cy = min(max(y + (mvy >> 3) + ext_c + 1, 0), hp - 2);
  const int fx = mvx & 7, fy = mvy & 7;
  const uint8_t* p = (is_cr ? cr_pad : cb_pad) + cy * wp + cx;
  const int v = ((8 - fx) * (8 - fy) * p[0] + fx * (8 - fy) * p[1] +
                 (8 - fx) * fy * p[wp] + fx * fy * p[wp + 1] + 32) >> 6;
  (is_cr ? pred_cr : pred_cb)[t] = v;
}

}  // namespace

// planes (16, H + 2 ext, W + 2 ext) and cb_pad / cr_pad
// (H/2 + 2 ext_c + 2, W/2 + 2 ext_c + 2) uint8; mv (nmb, 4, 2) int32
// quadrant-major qpel MVs; pred_y (H, W), pred_cb / pred_cr (H/2, W/2)
// int32 out. Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int mc_bulk(const uint8_t* planes, const uint8_t* cb_pad,
                       const uint8_t* cr_pad, const int32_t* mv,
                       int32_t* pred_y, int32_t* pred_cb, int32_t* pred_cr,
                       int W, int H, int ext, int ext_c, cudaStream_t stream) {
  const int n = W * H + 2 * (W / 2) * (H / 2);
  const int threads = 256;
  mc_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      planes, cb_pad, cr_pad, mv, W, H, ext, ext_c, pred_y, pred_cb, pred_cr);
  return (int)cudaGetLastError();
}
