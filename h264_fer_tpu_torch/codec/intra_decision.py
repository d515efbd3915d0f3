"""Whole-frame intra mode decision on the source frame (torch).

The counterpart of h264_fer_tpu/codec/tpu_intra.intra_mode_decision_impl
with modes_only=True: for every MB, the SATD (Σ|quantized transformed
residual| at the real QP, intra.cpp:819) of each of the 4 Intra16x16 modes,
and for every 4x4 block each of the 9 Intra4x4 modes, predicted from the
SOURCE neighbours with availability gating, and the first mode of least
SATD. `intra16_mode_decision` is its I16 half (i16_only=True), all that the
all-I16 and IPPP paths need. Both take a uint8 or int32 source plane and
`top_row`, the int32 source row above the plane (the last source row of
the MB-row band above, parallel/tile.py), or None where the plane's top is
the frame's.

Each dispatches on the plane's device: a CPU tensor goes to its plain
twin (`intra16_mode_decision_plain`, `intra_mode_decision_plain`, the
eager torch chain), a CUDA tensor to K11 (kernels/mode_decision.py, one
launch), and any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import mode_decision
from ..ops import intra, transform
from ..ops.device import const, on_card
from ..ops.tables import RASTER_TO_LUMA_BLOCK
from ..ops.tiles import mb_blocks, neighbours, to_mbs

_BIG = 1 << 30
# the neighbour each Intra4x4 mode needs (tpu_intra.py:183-185): top,
# left, none or corner, for V H DC DDL DDR VR HD VL HU
_GATE4 = "tlntccctl"
_Z_OF_RASTER = np.argsort(RASTER_TO_LUMA_BLOCK).astype(np.int64)


def _satd(diff_blocks, qp: int):
    q = transform.quantize_residual(
        transform.forward_transform_4x4(diff_blocks), qp, False)
    return q.abs().sum(dim=(-1, -2), dtype=torch.int32)


def _first_min(cost):
    """(index, value) of the first least entry along dim 0, written out so
    that ties resolve the same way on every device (the reference's
    jnp.argmin order)."""
    best = cost[0]
    idx = torch.zeros_like(best)
    for m in range(1, cost.shape[0]):
        better = cost[m] < best
        best = torch.where(better, cost[m], best)
        idx = torch.where(better, m, idx)
    return idx, best


def intra16_mode_decision(y, qp: int, top_row=None):
    """y: (H, W) uint8 or int32 source luma; top_row: None, or the (W,)
    int32 source row above it. Returns (mode16 (nmb,) int32, satd16 (nmb,)
    int32 of the chosen mode): K11's I16 form for CUDA tensors, the plain
    twin for CPU ones."""
    if on_card(y):
        return mode_decision.i16_decision(y, qp, top_row)
    return intra16_mode_decision_plain(y, qp, top_row)


def intra_mode_decision(y, qp: int, top_row=None):
    """The full decision. y: (H, W) uint8 or int32 source luma; top_row: as
    intra16_mode_decision's. Returns dict: mode16 (nmb,), satd16 (nmb,),
    mode4 (nmb, 16) Z-scan, satd4 (nmb,) (the sum of the 16 chosen blocks'
    SATD), all int32: K11's full form for CUDA tensors, the plain twin for
    CPU ones."""
    if on_card(y):
        return mode_decision.full_decision(y, qp, top_row)
    return intra_mode_decision_plain(y, qp, top_row)


def intra16_mode_decision_plain(y, qp: int, top_row=None):
    """intra16_mode_decision in eager torch, on any device; y is taken as
    int32 first (uint8 arithmetic would wrap)."""
    y = y.to(torch.int32)
    p33 = neighbours(y, 16, top_row)
    preds = intra.predict_16x16_all_modes(p33)  # (4, nmb, 16, 16)
    satd = _satd(mb_blocks(to_mbs(y, 16)[None] - preds), qp).sum(
        dim=-1, dtype=torch.int32)  # (4, nmb)
    gate = torch.stack([
        torch.where(p33[:, 17] != -1, 0, _BIG),  # V: top
        torch.where(p33[:, 1] != -1, 0, _BIG),   # H: left
        torch.zeros_like(satd[2]),               # DC
        torch.where(p33[:, 0] != -1, 0, _BIG),   # Plane: corner
    ]).to(torch.int32)
    return _first_min(satd + gate)


def _p13_source(y, top_row=None):
    """(nmb, 16, 13) Intra4x4 neighbour samples of every block of every MB
    (Z-scan order) from the source plane, -1 outside the frame (top_row:
    None, or the source row above the plane, read in its place). The
    above-right samples are replaced by the last top sample where the
    reference has none yet (intra.cpp:345-370): at the frame's right
    edge, in the MB's right column below its top row, and for blocks 3
    and 11."""
    h, w = y.shape
    hb, wb = h // 4, w // 4
    yp = torch.nn.functional.pad(y, (1, 4, 1, 0), value=-1)
    if top_row is not None:
        yp[0, 1:w + 1] = top_row
    corner = yp[0:h:4, 0:w:4]  # (hb, wb)
    left = yp[1:h + 1, 0:w:4].reshape(hb, 4, wb).transpose(1, 2)
    trow = yp[0:h:4, 1:w + 5].reshape(hb, wb + 1, 4)
    top, ar = trow[:, :wb], trow[:, 1:]
    dev = y.device
    bx = torch.arange(wb, device=dev) % 4
    by = torch.arange(hb, device=dev) % 4
    z = const(RASTER_TO_LUMA_BLOCK, dev)[(4 * by[:, None] + bx[None, :]).long()]
    repl = ((4 * torch.arange(wb, device=dev) + 4 >= w)[None, :]
            | ((bx == 3)[None, :] & (by > 0)[:, None]) | (z == 3) | (z == 11))
    ar = torch.where(repl[..., None], top[..., 3:4].expand_as(ar), ar)
    p13 = torch.cat([corner[..., None], left, top, ar], dim=-1)  # (hb, wb, 13)
    p13 = (p13.reshape(h // 16, 4, w // 16, 4, 13).permute(0, 2, 1, 3, 4)
           .reshape(-1, 16, 13))
    return p13[:, const(_Z_OF_RASTER, dev)]


def intra_mode_decision_plain(y, qp: int, top_row=None):
    """intra_mode_decision in eager torch, on any device; y is taken as
    int32 first."""
    y = y.to(torch.int32)
    mode16, satd16 = intra16_mode_decision_plain(y, qp, top_row)
    p13 = _p13_source(y, top_row)
    preds = intra.predict_4x4_all_modes(p13)  # (9, nmb, 16, 4, 4)
    satd = _satd(mb_blocks(to_mbs(y, 16))[None] - preds, qp)  # (9, nmb, 16)
    ok = {"t": p13[..., 5] != -1, "l": p13[..., 1] != -1,
          "c": p13[..., 0] != -1, "n": torch.ones_like(p13[..., 0], dtype=torch.bool)}
    gate = torch.stack([torch.where(ok[g], 0, _BIG) for g in _GATE4]).to(torch.int32)
    mode4, best4 = _first_min(satd + gate)
    return {"mode16": mode16.to(torch.int32), "satd16": satd16,
            "mode4": mode4.to(torch.int32),
            "satd4": best4.sum(dim=-1, dtype=torch.int32)}
