"""Intra prediction: 4 Intra_16x16 luma modes and 4 chroma modes (torch).

The PyTorch counterpart of the 16x16 and chroma parts of
h264_fer_tpu/ops/intra.py (norm 8.3.3 / 8.3.4; reference intra.cpp:426-533,
:568-687). Batched over leading dims, int32.

Neighbour-sample layout (value -1 = unavailable):
  16x16:  p[..., 0] = corner; p[..., 1:17] = left; p[..., 17:33] = top
  chroma: p[..., 0] = corner; p[..., 1:9] = left;  p[..., 9:17] = top
"""

from __future__ import annotations

import numpy as np
import torch

# Intra16x16 modes: 0 V, 1 H, 2 DC, 3 Plane.
I16_VERTICAL = 0
I16_HORIZONTAL = 1
I16_DC = 2
I16_PLANE = 3

# Chroma modes: 0 DC, 1 H, 2 V, 3 Plane.
CHROMA_DC = 0
CHROMA_HORIZONTAL = 1
CHROMA_VERTICAL = 2
CHROMA_PLANE = 3

# Encoder's Intra16x16-mode → chroma-mode pairing (intra.cpp:16).
INTRA16_TO_CHROMA_MODE = np.array([2, 1, 0, 3], dtype=np.int32)


def _plane(corner, left, top, n: int, scale: int):
    """Plane prediction of an n x n block (n = 16 luma, 8 chroma).

    H = Σ (i+1)·(top[n/2+i] − top[n/2−2−i]), with the corner standing in
    for top[-1] at the last i; V likewise on the left column."""
    half = n // 2
    hsum = 0
    vsum = 0
    for i in range(half):
        tm = corner if i == half - 1 else top[..., half - 2 - i]
        lm = corner if i == half - 1 else left[..., half - 2 - i]
        hsum = hsum + (i + 1) * (top[..., half + i] - tm)
        vsum = vsum + (i + 1) * (left[..., half + i] - lm)
    a = (left[..., n - 1] + top[..., n - 1]) * 16
    b = (scale * hsum + 32) >> 6
    c = (scale * vsum + 32) >> 6
    xs = torch.arange(n, dtype=torch.int32, device=left.device) - (half - 1)
    plane = (a[..., None, None] + b[..., None, None] * xs[None, :]
             + c[..., None, None] * xs[:, None] + 16) >> 5
    return plane.clamp(0, 255)


def predict_16x16(p, mode: int):
    """Predict a 16x16 luma MB. p: (..., 33) int32 → (..., 16, 16)."""
    corner = p[..., 0]
    left = p[..., 1:17]
    top = p[..., 17:33]
    shape = p.shape[:-1] + (16, 16)
    if mode == I16_VERTICAL:
        return top[..., None, :].expand(shape)
    if mode == I16_HORIZONTAL:
        return left[..., :, None].expand(shape)
    if mode == I16_DC:
        sum_top = top.sum(dim=-1, dtype=torch.int32)
        sum_left = left.sum(dim=-1, dtype=torch.int32)
        dc = torch.where(
            corner != -1, (sum_top + sum_left + 16) >> 5,
            torch.where(left[..., 0] != -1, (sum_left + 8) >> 4,
                        torch.where(top[..., 0] != -1, (sum_top + 8) >> 4,
                                    128)))
        return dc[..., None, None].expand(shape)
    if mode == I16_PLANE:
        return _plane(corner, left, top, 16, 5)
    raise ValueError(f"bad intra 16x16 mode {mode}")


def predict_16x16_all_modes(p):
    """(4, ..., 16, 16): every Intra16x16 mode."""
    return torch.stack([predict_16x16(p, m) for m in range(4)], dim=0)


def predict_chroma(p, mode: int):
    """Predict an 8x8 chroma MB. p: (..., 17) int32 → (..., 8, 8)."""
    corner = p[..., 0]
    left = p[..., 1:9]
    top = p[..., 9:17]
    shape = p.shape[:-1] + (8, 8)
    if mode == CHROMA_HORIZONTAL:
        return left[..., :, None].expand(shape)
    if mode == CHROMA_VERTICAL:
        return top[..., None, :].expand(shape)
    if mode == CHROMA_DC:
        quads = []
        for blk in range(4):
            x0 = (blk & 1) << 2
            y0 = (blk >> 1) << 2
            sum_x = top[..., x0 : x0 + 4].sum(dim=-1, dtype=torch.int32)
            sum_y = left[..., y0 : y0 + 4].sum(dim=-1, dtype=torch.int32)
            left_ok = left[..., y0] != -1
            top_ok = top[..., x0] != -1
            both = (sum_x + sum_y + 4) >> 3
            lonly = (sum_y + 2) >> 2
            tonly = (sum_x + 2) >> 2
            if blk in (0, 3):  # prefer both, then left, then top
                r = torch.where(left_ok & top_ok, both,
                                torch.where(left_ok, lonly,
                                            torch.where(top_ok, tonly, 128)))
            elif blk == 1:  # top-right: prefer top
                r = torch.where(top_ok, tonly,
                                torch.where(left_ok, lonly, 128))
            else:  # bottom-left: prefer left
                r = torch.where(left_ok, lonly,
                                torch.where(top_ok, tonly, 128))
            quads.append(r)
        q = torch.stack(quads, dim=-1).reshape(p.shape[:-1] + (2, 2))
        return q.repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)
    if mode == CHROMA_PLANE:
        return _plane(corner, left, top, 8, 34)
    raise ValueError(f"bad chroma mode {mode}")


def predict_chroma_all_modes(p):
    """(4, ..., 8, 8): every chroma mode."""
    return torch.stack([predict_chroma(p, m) for m in range(4)], dim=0)
