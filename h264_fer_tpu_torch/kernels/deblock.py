"""In-loop deblocking filter (K8) and its boundary strengths.

`deblock_frame` is the wrapper of the CUDA kernel csrc/deblock.cu, which
replaces the XLA loop deblock_frame_device_impl
(h264_fer_tpu/kernels/deblock_tpu.py:204, fori_loop at :289). On a CUDA
tensor it launches the kernel (one launch per frame: a persistent grid
takes the MBs in knight order and starts each as soon as its left, top,
top-right and top-left neighbours are filtered, kernels/dataflow.py) or
raises; on a CPU tensor it runs `deblock_frame_plain`, the same function
in plain PyTorch, one step per knight wave d = 2r + c: gather every MB's
20x20 luma and 12x12 Cb / Cr windows, filter the 4 vertical and then the
4 horizontal edges, scatter the windows back. Both equal the norm's per-MB
raster order (8.7), which the JAX package's host filter
codec/loopfilter.deblock_frame runs.

`bs_maps` is _bs_maps (deblock_tpu.py:45-102): every edge's bS from the
syntax state before filtering.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.deblock import ALPHA, BETA, TC0
from ..ops.device import const
from ..ops.tables import RASTER_TO_LUMA_BLOCK
from . import build, dataflow
from .wavefront_i4x4 import knight_waves

I32 = torch.int32

# MV quadrant of each raster 4x4 block (loopfilter._blk_mv)
_RASTER_Q = np.array([(b // 8) * 2 + (b % 4) // 2 for b in range(16)], dtype=np.int64)


def _edge_table():
    """The 32 (p block, q block, edge kind) of an MB's edges, raster blocks:
    vertical edge (xblk, yblk) at index 4 xblk + yblk, then horizontal edge
    (yblk, xblk) at 16 + 4 yblk + xblk. kind 1: the MB's left edge, 2: its
    top edge (p in the neighbour MB), 0: inside the MB."""
    p, q, kind = [], [], []
    for xblk in range(4):
        for yblk in range(4):
            q.append(yblk * 4 + xblk)
            p.append(yblk * 4 + 3 if xblk == 0 else q[-1] - 1)
            kind.append(1 if xblk == 0 else 0)
    for yblk in range(4):
        for xblk in range(4):
            q.append(yblk * 4 + xblk)
            p.append(12 + xblk if yblk == 0 else q[-1] - 4)
            kind.append(2 if yblk == 0 else 0)
    return np.array(p), np.array(q), np.array(kind)


_P_BLK, _Q_BLK, _KIND = _edge_table()


def bs_maps(mb_intra, nz_luma, mv, wmb: int, hmb: int):
    """bS of every edge: (bs_v (nmb, 4 xblk, 4 yblk), bs_h (nmb, 4 yblk,
    4 xblk)) int32, for the vertical edge at luma x = 16 mbx + 4 xblk and
    the horizontal edge at y = 16 mby + 4 yblk. mb_intra (nmb,) bool;
    nz_luma (nmb, 16) bool, Z-scan blocks; mv (nmb, 4, 2) int32, the
    quadrant MVs. Frame edges get 0."""
    dev = mb_intra.device
    nmb = wmb * hmb
    mb = torch.arange(nmb, device=dev)[:, None]
    kind = const(_KIND, dev)
    p_mb = torch.where(kind == 1, (mb - 1).clamp(min=0),
                       torch.where(kind == 2, (mb - wmb).clamp(min=0), mb))
    pb, qb = const(_P_BLK, dev), const(_Q_BLK, dev)
    nz = nz_luma[:, const(RASTER_TO_LUMA_BLOCK, dev).long()]  # raster blocks
    mvq = mv[:, const(_RASTER_Q, dev)]                          # (nmb, 16, 2)
    mv_far = ((mvq[p_mb, pb] - mvq[:, qb]).abs() >= 4).any(dim=-1)
    bs = torch.where(mb_intra[p_mb] | mb_intra[:, None], torch.where(kind > 0, 4, 3),
                     torch.where(nz[p_mb, pb] | nz[:, qb], 2, mv_far.to(I32)))
    frame_edge = (((kind == 1) & (mb % wmb == 0)) | ((kind == 2) & (mb < wmb)))
    bs = torch.where(frame_edge, 0, bs).to(I32)
    return bs[:, :16].reshape(nmb, 4, 4), bs[:, 16:].reshape(nmb, 4, 4)


def _edge_params(qp: int):
    """(alpha, beta, tc0 of bS 1..3) at indexA = indexB = qp (0..51)."""
    idx = int(np.clip(qp, 0, 51))
    return int(ALPHA[idx]), int(BETA[idx]), TC0[:, idx]


def _filters(qp: int, qpc: int) -> bool:
    """False when no edge can change at these QPs: alpha or beta is 0 for
    both the luma and the chroma QP (deblock_tpu.py:221-223)."""
    return any(a > 0 and b > 0 for a, b, _ in (_edge_params(qp), _edge_params(qpc)))


def _filter_lines(s, bs, alpha: int, beta: int, tc0_tab, chroma: bool):
    """One edge for a batch of lines (_filter_lines, deblock_tpu.py:109-177),
    both sides at once. s: (2, ..., 4) int32, the p side then the q side,
    index 0 nearest the edge; bs (...) int32 0..4; tc0_tab: the 3 tc0 values
    of bS 1..3. Returns the new samples 0..2 of both sides, (2, ..., 3):
    sample 3 is read, never written."""
    a0, a1, a2, a3 = s.unbind(-1)  # this side's samples
    b0, b1 = a0.flip(0), a1.flip(0)  # the other side's
    gap = (a0[0] - a0[1]).abs()  # |p0 - q0|
    filt = (gap < alpha) & ((a1 - a0).abs() < beta).all(0)
    near = (a2 - a0).abs() < beta  # ap < beta, aq < beta
    tc0 = tc0_tab[(bs.clamp(1, 3) - 1).long()]
    tc = tc0 + 1 if chroma else tc0 + near.sum(0, dtype=I32)
    nfilt = filt & (bs > 0) & (bs < 4)  # the normal filter, bS 1..3
    sfilt = filt & (bs == 4)
    delta = torch.clamp(((a0[1] - a0[0]) * 4 + (a1[0] - a1[1]) + 4) >> 3, -tc, tc)
    out0 = torch.where(nfilt, (a0 + torch.stack([delta, -delta])).clamp(0, 255), a0)
    out0 = torch.where(sfilt, (a1 * 2 + a0 + b1 + 2) >> 2, out0)
    if chroma:
        return torch.stack([out0, a1, a2], -1)
    avg = (a0[0] + a0[1] + 1) >> 1
    out1 = torch.where(nfilt & near, a1 + torch.clamp((a2 + avg - a1 * 2) >> 1, -tc0, tc0), a1)
    strong = sfilt & (gap < (alpha >> 2) + 2) & near
    return torch.stack([
        torch.where(strong, (a2 + 2 * a1 + 2 * a0 + 2 * b0 + b1 + 4) >> 3, out0),
        torch.where(strong, (a2 + a1 + a0 + b0 + 2) >> 2, out1),
        torch.where(strong, (2 * a3 + 3 * a2 + a1 + a0 + b0 + 4) >> 3, a2)], -1)


def _edge(win, x: int, bs4, params, chroma: bool) -> None:
    """Filter, in place, the vertical edge at column x of the windows win
    (..., 4 + n, 4 + n) (a transposed view filters a horizontal edge): its n
    lines are rows 4.., line i taking bs4[..., i // (n / 4)]."""
    n = win.shape[-1] - 4
    sides = torch.stack([win[..., 4:, x - 4: x].flip(-1), win[..., 4:, x: x + 4]])
    new = _filter_lines(sides, bs4.repeat_interleave(n // 4, dim=-1), *params, chroma)
    win[..., 4:, x - 3: x] = new[0].flip(-1)
    win[..., 4:, x: x + 3] = new[1]


def deblock_frame_plain(y, cb, cr, mb_intra, nz_luma, mv, qp: int, qpc: int):
    """Plain PyTorch K8: uint8 planes (H, W), (H/2, W/2) and the syntax state
    (bs_maps's) → the filtered uint8 planes. One step per knight wave."""
    if not _filters(qp, qpc):
        return y, cb, cr
    h, w = y.shape
    hmb, wmb = h // 16, w // 16
    dev = y.device
    bs_v, bs_h = bs_maps(mb_intra, nz_luma, mv, wmb, hmb)
    ly, lc = ((a, b, const(tc0, dev)) for a, b, tc0 in (_edge_params(qp), _edge_params(qpc)))
    # 4 samples of padding above and left: window (r, c) starts at (16 r, 16 c)
    yp = F.pad(y.to(I32), (4, 0, 4, 0))
    cp = F.pad(torch.stack([cb, cr]).to(I32), (4, 0, 4, 0))
    a20, a12 = torch.arange(20, device=dev), torch.arange(12, device=dev)
    for r, c, mb in knight_waves(hmb, wmb, dev):
        iy, ix = (16 * r)[:, None, None] + a20[:, None], (16 * c)[:, None, None] + a20
        jy, jx = (8 * r)[:, None, None] + a12[:, None], (8 * c)[:, None, None] + a12
        gy, gc = yp[iy, ix], cp[:, jy, jx]  # (k, 20, 20), (2, k, 12, 12)
        v, hz = bs_v[mb], bs_h[mb]
        for e in range(4):
            _edge(gy, 4 + 4 * e, v[:, e], ly, False)
            if e % 2 == 0:  # chroma edges at luma offsets 0 and 8
                _edge(gc, 4 + 2 * e, v[:, e], lc, True)
        for e in range(4):
            _edge(gy.transpose(-1, -2), 4 + 4 * e, hz[:, e], ly, False)
            if e % 2 == 0:
                _edge(gc.transpose(-1, -2), 4 + 2 * e, hz[:, e], lc, True)
        yp[iy, ix] = gy
        cp[:, jy, jx] = gc
    u8 = torch.uint8
    return yp[4:, 4:].to(u8), cp[0, 4:, 4:].to(u8), cp[1, 4:, 4:].to(u8)


def deblock_frame(y, cb, cr, mb_intra, nz_luma, mv, qp: int, qpc: int, *, blocks=None):
    """K8: filter a reconstructed frame. y (H, W), cb / cr (H/2, W/2) uint8;
    mb_intra (nmb,) bool, nz_luma (nmb, 16) bool (Z-scan blocks), mv
    (nmb, 4, 2) int32 quadrant MVs; qp / qpc the luma and chroma QP.
    Returns the filtered uint8 planes (the inputs themselves when nothing
    can change at these QPs). CUDA tensors go to the kernel, CPU tensors
    to deblock_frame_plain. blocks: the kernel's grid size (None: as many
    blocks as fit on the card at once); any size gives the same result."""
    grid = dataflow.check_blocks(blocks)
    if y.device.type == "cpu":
        return deblock_frame_plain(y, cb, cr, mb_intra, nz_luma, mv, qp, qpc)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    h, w = y.shape
    if h % 16 or w % 16:
        raise ValueError(f"frame {w}x{h} is not a whole number of MBs")
    hmb, wmb = h // 16, w // 16
    nmb = hmb * wmb
    dev = y.device
    for name, t, shape, dtype in (
            ("y", y, (h, w), torch.uint8), ("cb", cb, (h // 2, w // 2), torch.uint8),
            ("cr", cr, (h // 2, w // 2), torch.uint8),
            ("mb_intra", mb_intra, (nmb,), torch.bool),
            ("nz_luma", nz_luma, (nmb, 16), torch.bool), ("mv", mv, (nmb, 4, 2), I32)):
        build.check_tensor(name, t, shape, dtype, dev)
    if not _filters(qp, qpc):
        return y, cb, cr
    tab = np.array([v for a, b, tc0 in (_edge_params(qp), _edge_params(qpc))
                    for v in (a, b, *tc0)], dtype=np.int32)
    # the kernel filters in place and moves its rows in 16- and 8-byte words:
    # fresh copies are aligned
    out = (y.clone(), cb.clone(), cr.clone())
    order, sched = dataflow.schedule(dataflow.knight_order(wmb, hmb), dev)
    build.launch(deblock_frame, "deblock", "deblock_frame",
                 (*out, mb_intra, nz_luma, mv, order, sched, wmb, hmb, tab, grid), dev)
    return out


# kernel launches so far, as counted by the C entry point (one per accepted
# launch, one per filtered frame)
deblock_frame.launches = 0
