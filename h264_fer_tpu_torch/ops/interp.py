"""16-phase interpolated reference planes and padded chroma (torch).

The counterpart of h264_fer_tpu/ops/interp.interpolated_planes_jax and
pad_chroma_jax (interp.py:24-154; the reference's FillInterpolatedRefFrame,
moestimation.cpp:74-173, via FillInterpolSubMBPart, mocomp.cpp:80-107): one
plane per fractional position frac = fy*4 + fx, each covering the frame
edge-extended by `ext` samples, so that any MV within ±ext full pel reads
inside it. The centre phase j is the horizontal 6-tap over the already
clipped vertical half-pel values, as the reference chains its Bordered
intermediates (mocomp.cpp:66-71).

The arithmetic is int32; every plane value lies in 0..255, so the planes
are returned as uint8 (a quarter of the bytes for the kernels that read
them). Elementwise work only, in plain PyTorch, as the reference computes
it outside any Pallas kernel.
"""

from __future__ import annotations

import torch


def _edge_pad(x, n: int):
    """x (any dtype) with its edge rows and columns replicated n times on
    every side."""
    h, w = x.shape
    rows = torch.arange(-n, h + n, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-n, w + n, device=x.device).clamp(0, w - 1)
    return x[rows][:, cols]


def _tap6_h(p):
    """Horizontal 6-tap at x + 1/2; the output is 5 columns narrower."""
    return ((p[:, 0:-5] - 5 * p[:, 1:-4] + 20 * p[:, 2:-3] + 20 * p[:, 3:-2]
             - 5 * p[:, 4:-1] + p[:, 5:] + 16) >> 5).clamp(0, 255)


def _tap6_v(p):
    return ((p[0:-5] - 5 * p[1:-4] + 20 * p[2:-3] + 20 * p[3:-2]
             - 5 * p[4:-1] + p[5:] + 16) >> 5).clamp(0, 255)


def _avg(a, b):
    return (a + b + 1) >> 1


def interpolated_planes(ref, ext: int = 0):
    """(16, H + 2 ext, W + 2 ext) uint8 planes of the (H, W) reference
    plane `ref` (any integer dtype): planes[frac][ext + y][ext + x] is the
    prediction sample of integer position (x, y) at that frac."""
    h, w = ref.shape
    pad = ext + 4  # ext for the MV range, 3 taps, 1 for the x+1 / y+1 averages
    P = _edge_pad(ref.to(torch.int32), pad)
    he, we = h + 2 * ext, w + 2 * ext
    o = pad - ext  # row / column of extended-grid position 0 in P

    def full(x0, y0):
        return P[o + y0: o + y0 + he, o + x0: o + x0 + we]

    b = _tap6_h(P[o: o + he, o - 2: o + we + 3])  # half-pel at x + 1/2
    hv = _tap6_v(P[o - 2: o + he + 3, o: o + we])  # half-pel at y + 1/2
    s = _tap6_h(P[o - 1: o + he + 1, o - 2: o + we + 3])[2: 2 + he]  # b at y+1
    m = _tap6_v(P[o - 2: o + he + 3, o - 1: o + we + 1])[:, 2: 2 + we]  # h at x+1
    j = _tap6_h(_tap6_v(P[o - 2: o + he + 3, o - 2: o + we + 3]))[:, :we]
    g, gx1, gy1 = full(0, 0), full(1, 0), full(0, 1)
    planes = [g, _avg(g, b), b, _avg(b, gx1),
              _avg(g, hv), _avg(b, hv), _avg(b, j), _avg(b, m),
              hv, _avg(hv, j), j, _avg(j, m),
              _avg(hv, gy1), _avg(hv, s), _avg(j, s), _avg(s, m)]
    return torch.stack([p.to(torch.uint8) for p in planes])


def pad_chroma(ref_c, ext_c: int):
    """The chroma plane edge-padded by ext_c + 1 on every side, for the
    bilinear MC window reads (pad_chroma_jax); keeps the dtype."""
    return _edge_pad(ref_c, ext_c + 1)
