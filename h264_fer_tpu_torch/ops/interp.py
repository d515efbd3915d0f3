"""16-phase interpolated reference planes and padded chroma (torch).

The counterpart of h264_fer_tpu/ops/interp.interpolated_planes_jax,
interpolated_planes_banded_jax and pad_chroma_jax (interp.py:24-154; the
reference's FillInterpolatedRefFrame,
moestimation.cpp:74-173, via FillInterpolSubMBPart, mocomp.cpp:80-107): one
plane per fractional position frac = fy*4 + fx, each covering the frame
edge-extended by `ext` samples, so that any MV within ±ext full pel reads
inside it. The centre phase j is the horizontal 6-tap over the already
clipped vertical half-pel values, as the reference chains its Bordered
intermediates (mocomp.cpp:66-71). The banded forms serve an MB-row band of
a frame (parallel/tile_p.py) whose rows above and below are real rows of
its neighbours: they pad only horizontally and give the frame forms' row
window of the band bit for bit.

The arithmetic is int32; every plane value lies in 0..255, so the planes
are returned as uint8 (a quarter of the bytes for the kernels that read
them). interpolated_planes and interpolated_planes_banded dispatch on the
reference's device: a CPU tensor goes to their plain twins
(interpolated_planes_plain, interpolated_planes_banded_plain, elementwise
PyTorch, as the reference computes the planes outside any Pallas kernel),
a CUDA tensor to K13 (kernels/interp.py, one launch), and any other device
raises. The padded chroma stays plain PyTorch on every device.
mc_macroblock_from_planes is the decoder's host-side (numpy) MC of one MB
from these planes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.interp import interp_planes
from .device import on_card


def edge_pad(x, n: int, rows: bool = True):
    """x (any dtype) with its edge columns, and unless `rows` is False its
    edge rows, replicated n times on every side."""
    h, w = x.shape
    cols = torch.arange(-n, w + n, device=x.device).clamp(0, w - 1)
    if rows:
        x = x[torch.arange(-n, h + n, device=x.device).clamp(0, h - 1)]
    return x[:, cols]


def _tap6_h(p):
    """Horizontal 6-tap at x + 1/2; the output is 5 columns narrower."""
    return ((p[:, 0:-5] - 5 * p[:, 1:-4] + 20 * p[:, 2:-3] + 20 * p[:, 3:-2]
             - 5 * p[:, 4:-1] + p[:, 5:] + 16) >> 5).clamp(0, 255)


def _tap6_v(p):
    return ((p[0:-5] - 5 * p[1:-4] + 20 * p[2:-3] + 20 * p[3:-2]
             - 5 * p[4:-1] + p[5:] + 16) >> 5).clamp(0, 255)


def _avg(a, b):
    return (a + b + 1) >> 1


def _planes(P, h: int, w: int, ext: int):
    """The 16 planes of an (h, w) plane whose samples P holds with a margin
    of ext + 4 on every side."""
    he, we = h + 2 * ext, w + 2 * ext
    o = 4  # row / column of extended-grid position 0 in P

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


def interpolated_planes(ref, ext: int = 0):
    """(16, H + 2 ext, W + 2 ext) uint8 planes of the (H, W) reference
    plane `ref`: planes[frac][ext + y][ext + x] is the prediction sample of
    integer position (x, y) at that frac. K13 for a uint8 CUDA plane, the
    plain twin for a CPU one."""
    if on_card(ref):
        return interp_planes(ref, ext)
    return interpolated_planes_plain(ref, ext)


def interpolated_planes_banded(ref_v, ext: int = 0):
    """The planes of an MB-row band, (16, hb + 2 ext, W + 2 ext) uint8, from
    ref_v (hb + 2 (ext + 4), W): the band's reference rows with ext + 4 rows
    of the band above and of the band below around them (at a frame edge,
    the band's edge row repeated); the row window of
    interpolated_planes(frame, ext) that covers the band
    (interpolated_planes_banded_jax). K13 for a uint8 CUDA plane, the
    plain twin for a CPU one."""
    if on_card(ref_v):
        return interp_planes(ref_v, ext, band=True)
    return interpolated_planes_banded_plain(ref_v, ext)


def interpolated_planes_plain(ref, ext: int = 0):
    """interpolated_planes in elementwise torch, on any device; ref of any
    integer dtype."""
    h, w = ref.shape
    # ext for the MV range, 3 taps, 1 for the x+1 / y+1 averages
    return _planes(edge_pad(ref.to(torch.int32), ext + 4), h, w, ext)


def interpolated_planes_banded_plain(ref_v, ext: int = 0):
    """interpolated_planes_banded in elementwise torch, on any device: pads
    only horizontally, so the planes are the row window of the frame
    planes that covers the band."""
    pad = ext + 4
    hv, w = ref_v.shape
    return _planes(edge_pad(ref_v.to(torch.int32), pad, rows=False), hv - 2 * pad, w, ext)


def pad_chroma(ref_c, ext_c: int):
    """The chroma plane edge-padded by ext_c + 1 on every side, for the
    bilinear MC window reads (pad_chroma_jax); keeps the dtype."""
    return edge_pad(ref_c, ext_c + 1)


def pad_chroma_banded(ref_cv, ext_c: int):
    """pad_chroma of an MB-row band's chroma rows ref_cv, which hold ext_c + 1
    rows of the bands above and below around the band's own: padded only
    horizontally (the reference's band program, tile_p.py:128-133), the row
    window of pad_chroma(frame, ext_c) that covers the band."""
    return edge_pad(ref_cv, ext_c + 1, rows=False)


def mc_macroblock_from_planes(planes, cb_pad, cr_pad, mb_x: int, mb_y: int, mv,
                              ext: int, ext_c: int):
    """Whole-MB MC of the decoder's Python form from precomputed planes
    (h264_fer_tpu/ops/interp.mc_macroblock_from_planes, interp.py:157),
    host side: equal to ops/mc.mc_macroblock wherever every MV lies within
    ±(ext - 1) full pel.

    planes: interpolated_planes(ref_y, ext) as a numpy array; cb_pad /
    cr_pad: pad_chroma(ref_c, ext_c) as numpy int32, ext_c >= ext // 2 + 1.
    mv: (4, 4, 2) quadrant-major quarter-pel MVs, uniform within each
    quadrant (the decoder's sub-8x8 collapse). Returns (pred_l 16x16,
    pred_cb 8x8, pred_cr 8x8) int32."""
    pred_l = np.empty((16, 16), np.int32)
    pred_cb = np.empty((8, 8), np.int32)
    pred_cr = np.empty((8, 8), np.int32)
    x0, y0 = mb_x * 16, mb_y * 16
    for q in range(4):
        ox, oy = (q & 1) * 8, (q >> 1) * 8
        mvx, mvy = int(mv[q, 0, 0]), int(mv[q, 0, 1])
        frac = (mvy & 3) * 4 + (mvx & 3)
        px = x0 + ox + (mvx >> 2) + ext
        py = y0 + oy + (mvy >> 2) + ext
        pred_l[oy: oy + 8, ox: ox + 8] = planes[frac][py: py + 8, px: px + 8]
        cx = (x0 + ox) // 2 + (mvx >> 3) + ext_c + 1
        cy = (y0 + oy) // 2 + (mvy >> 3) + ext_c + 1
        fx, fy = mvx & 7, mvy & 7
        for cplane, out in ((cb_pad, pred_cb), (cr_pad, pred_cr)):
            a = cplane[cy: cy + 5, cx: cx + 5]
            out[oy // 2: oy // 2 + 4, ox // 2: ox // 2 + 4] = (
                (8 - fx) * (8 - fy) * a[:4, :4] + fx * (8 - fy) * a[:4, 1:]
                + (8 - fx) * fy * a[1:, :4] + fx * fy * a[1:, 1:] + 32) >> 6
    return pred_l, pred_cb, pred_cr
