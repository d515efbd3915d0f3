"""All-Intra_4x4 luma reconstruction wavefront (K4x4) and its levels.

`i4x4_luma` is the wrapper of the CUDA kernel csrc/wavefront_i4x4.cu,
which replaces the Pallas kernel _i4_kernel_body
(h264_fer_tpu/kernels/wavefront_pallas.py:551, via pallas_i4x4_luma at
:753, with the levels that i4x4_levels_from_recon at :822 rebuilds). On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
`i4x4_luma_plain`, the same function in plain PyTorch.

A 4x4 block reads its left, top, top-left and top-right neighbours, so an
MB waits on all four neighbour MBs (the kAllFour set of
csrc/mb_dataflow.cuh: block 5 reads the top-right MB's row 15). The plain
twin runs MB knight waves d = 2r + c, under which the MB above-right is on
an earlier wave, so one wave's MBs are independent. The kernel is one
launch per frame: a persistent grid of one-warp blocks takes the MBs by
ticket in the same knight order (kernels/dataflow.py) and codes each in 10
diagonal steps of its 4x4 blocks, waiting before a step only for the
neighbour edge samples that step reads. A neighbour publishes its edge in
4-sample slots, each with its flag in one 64-bit word, as its blocks
finish; so an MB trails its left neighbour by ~4 block steps, not by a
whole MB (csrc/wavefront_i4x4.cu has the rules). Inside an MB the 16
blocks run in Z-scan order (the kernel's steps give the same result).
`i4x4_mb_code` is that per-MB step, written once for the plain K4x4 and
the plain K6 (kernels/wavefront_mixed.py); the kernels share its CUDA
form, csrc/intra4x4.cuh.
"""

from __future__ import annotations

import torch

from ..ops import intra, transform
from ..ops.device import const
from ..ops.tables import INTRA4X4_SCAN_ORDER_XY
from ..ops.tiles import from_mbs, to_mbs
from . import build, dataflow
from .wavefront_i16 import qtab

I32 = torch.int32
_BXY = [(int(x), int(y)) for x, y in INTRA4X4_SCAN_ORDER_XY]
# the Intra4x4 prediction of every (mode, sample), packed for the CUDA body
# (csrc/intra4x4.cuh); K4x4 and K6 pass it to their kernels
PRED4_TABLE = intra.packed_mode_table()


def knight_waves(hmb: int, wmb: int, dev):
    """(r, c, mb) of each non-empty MB knight wave d = 2r + c, in order:
    rows r0 = max(0, ceil((d - wmb + 1) / 2)) .. min(hmb - 1, d // 2)."""
    for d in range(2 * (hmb - 1) + wmb):
        r0, r1 = max(0, (d - wmb + 2) // 2), min(hmb - 1, d // 2)
        if r1 >= r0:
            r = torch.arange(r0, r1 + 1, device=dev)
            yield r, d - 2 * r, r * wmb + d - 2 * r


def mb_neighbours(rec, r, c):
    """The reconstructed samples MBs (r, c) read from their neighbours in
    the recon grid rec (hmb, wmb, 16, 16), -1 where unavailable: lcol (n,
    16) the left MB's column 15, trow (n, 16) the top MB's row 15, corner
    (n,), and tr4 (n, 4) the first samples of the top-right MB's row 15,
    valid where tr_ok; with the flags top_ok and tr_ok (n,) bool."""
    wmb = rec.shape[1]
    left_ok, top_ok = c > 0, r > 0
    tr_ok = top_ok & (c + 1 < wmb)
    rm1, cm1 = (r - 1).clamp(min=0), (c - 1).clamp(min=0)
    return {
        "lcol": torch.where(left_ok[:, None], rec[r, cm1, :, 15], -1),
        "trow": torch.where(top_ok[:, None], rec[rm1, c, 15, :], -1),
        "corner": torch.where(left_ok & top_ok, rec[rm1, cm1, 15, 15], -1),
        "tr4": rec[rm1, (c + 1).clamp(max=wmb - 1), 15, 0:4],
        "top_ok": top_ok, "tr_ok": tr_ok,
    }


def i4x4_mb_code(src, modes, nb, qp: int):
    """Code n MBs as Intra_4x4, their 16 blocks in Z-scan order. src (n,
    16, 16) and modes (n, 16) int32, nb their mb_neighbours. Returns
    (recon (n, 16, 16), levels (n, 16, 16) zig-zag lists per block).

    Each block's 13 neighbour samples follow _fetch_p13 (intra.cpp:294-378,
    wavefront_mixed.py:200-234): -1 where unavailable; the above-right
    samples replicate the last top sample for blocks 3 and 11 and the MB's
    right column below its top row, come from the top-right MB for block 5
    (or replicate where it is unavailable), and are all -1 on the frame's
    top edge."""
    n = src.shape[0]
    work = src.clone()
    levels = torch.zeros((n, 16, 16), dtype=I32, device=src.device)
    lcol, trow = nb["lcol"], nb["trow"]
    for z, (bx, by) in enumerate(_BXY):
        l4 = work[:, by:by + 4, bx - 1] if bx > 0 else lcol[:, by:by + 4]
        t4 = work[:, by - 1, bx:bx + 4] if by > 0 else trow[:, bx:bx + 4]
        if bx > 0 and by > 0:
            cn = work[:, by - 1, bx - 1]
        elif by > 0:
            cn = lcol[:, by - 1]
        elif bx > 0:
            cn = trow[:, bx - 1]
        else:
            cn = nb["corner"]
        last = t4[:, 3:4].expand(n, 4)
        if z in (3, 11) or (bx == 12 and by > 0):
            ar = last
        elif by > 0:
            ar = work[:, by - 1, bx + 4:bx + 8]
        elif bx == 12:  # block 5: the top-right MB's row 15
            ar = torch.where(nb["tr_ok"][:, None], nb["tr4"], last)
        else:
            ar = trow[:, bx + 4:bx + 8]
        if by == 0:
            ar = torch.where(nb["top_ok"][:, None], ar, -1)
        pred = intra.predict_4x4_by_mode(
            torch.cat([cn[:, None], l4, t4, ar], dim=-1), modes[:, z])
        q = transform.quantize_residual(transform.forward_transform_4x4(
            src[:, by:by + 4, bx:bx + 4] - pred), qp, False)
        levels[:, z] = transform.zigzag_scan(q)
        work[:, by:by + 4, bx:bx + 4] = (
            pred + transform.inverse_residual(q, qp, False)).clamp(0, 255)
    return work, levels


def i4x4_luma_plain(y, modes, qp: int):
    """Plain PyTorch K4x4: y (H, W) uint8, modes (nmb, 16) int32 Z-scan
    Intra4x4 modes → (recon (H, W) uint8, levels (nmb, 16, 16) int32)."""
    h, w = y.shape
    hmb, wmb = h // 16, w // 16
    src = to_mbs(y.to(I32), 16).reshape(hmb, wmb, 16, 16)
    rec = torch.zeros_like(src)
    levels = torch.zeros((hmb * wmb, 16, 16), dtype=I32, device=y.device)
    for r, c, mb in knight_waves(hmb, wmb, y.device):
        rec[r, c], levels[mb] = i4x4_mb_code(
            src[r, c], modes[mb], mb_neighbours(rec, r, c), qp)
    return from_mbs(rec.reshape(-1, 16, 16), hmb, wmb).to(torch.uint8), levels


def scratch(nmb: int, device):
    """The kernel's zeroed scratch, one allocation and one fill: 8 int64
    edge slots per MB, then the dataflow scratch of nmb + 1 int32 (ready
    flags and the ticket counter; only the counter is used)."""
    return torch.zeros(8 * nmb + (nmb + 2) // 2, dtype=torch.int64, device=device)


def i4x4_luma(y, modes, qp: int, *, blocks=None):
    """K4x4: (recon, levels) of an all-Intra_4x4 frame, the tuple of
    pallas_i4x4_luma with the recon as uint8. y (H, W) uint8, modes
    (nmb, 16) int32. CUDA tensors go to the kernel (one launch per frame),
    CPU tensors to i4x4_luma_plain. blocks: the kernel's grid size (None:
    as many blocks as fit on the card at once); any size gives the same
    result."""
    grid = dataflow.check_blocks(blocks)
    if y.device.type == "cpu":
        return i4x4_luma_plain(y, modes, qp)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    h, w = y.shape
    if h % 16 or w % 16:
        raise ValueError(f"frame {w}x{h} is not a whole number of MBs")
    hmb, wmb = h // 16, w // 16
    build.check_tensor("y", y, (h, w), torch.uint8, y.device)
    build.check_tensor("modes", modes, (hmb * wmb, 16), I32, y.device)
    if y.data_ptr() % 16:
        raise ValueError("y: the kernel copies it in 16-byte chunks")
    rec = torch.empty_like(y)
    levels = torch.empty((hmb * wmb, 16, 16), dtype=I32, device=y.device)
    build.launch(i4x4_luma, "wavefront_i4x4", "wavefront_i4x4_frame",
                 (y, modes, const(PRED4_TABLE, y.device), rec, levels,
                  scratch(hmb * wmb, y.device),
                  const(dataflow.knight_order(wmb, hmb), y.device), wmb, hmb, qp,
                  qtab(qp), grid), y.device)
    return rec, levels


# kernel launches so far, as counted by the C entry point (one per accepted
# launch, one per frame)
i4x4_luma.launches = 0
