"""Whole-frame Intra16x16 mode decision on the source frame (torch).

The counterpart of h264_fer_tpu/codec/tpu_intra.intra_mode_decision_impl
with i16_only=True: for every MB, the SATD (Σ|quantized transformed
residual| at the real QP, intra.cpp:819) of each of the 4 Intra16x16 modes
predicted from the SOURCE neighbours, with availability gating, and the
first mode of least SATD.
"""

from __future__ import annotations

import torch

from ..ops import intra, transform
from ..ops.tiles import mb_blocks, neighbours, to_mbs

_BIG = 1 << 30


def intra16_mode_decision(y, qp: int):
    """y: (H, W) int32 source luma. Returns (mode16 (nmb,) int32,
    satd16 (nmb,) int32 of the chosen mode)."""
    p33 = neighbours(y, 16)
    preds = intra.predict_16x16_all_modes(p33)  # (4, nmb, 16, 16)
    diffs = mb_blocks(to_mbs(y, 16)[None] - preds)  # (4, nmb, 16, 4, 4)
    q = transform.quantize_residual(
        transform.forward_transform_4x4(diffs), qp, False)
    satd = q.abs().sum(dim=(-1, -2, -3), dtype=torch.int32)  # (4, nmb)

    top_ok = p33[:, 17] != -1
    left_ok = p33[:, 1] != -1
    corner_ok = p33[:, 0] != -1
    gate = torch.stack([
        torch.where(top_ok, 0, _BIG),
        torch.where(left_ok, 0, _BIG),
        torch.zeros_like(satd[2]),
        torch.where(corner_ok, 0, _BIG),
    ]).to(torch.int32)
    cost = satd + gate
    # first index of the least cost, written out so that ties resolve the
    # same way on every device (the reference's jnp.argmin order)
    best = cost[0]
    mode = torch.zeros_like(best)
    for m in range(1, 4):
        better = cost[m] < best
        best = torch.where(better, cost[m], best)
        mode = torch.where(better, m, mode)
    return mode, best
