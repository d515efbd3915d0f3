"""Intra prediction: 9 Intra_4x4 modes, 4 Intra_16x16 luma modes and 4
chroma modes (torch).

The PyTorch counterpart of h264_fer_tpu/ops/intra.py (norm 8.3.1.2 /
8.3.3 / 8.3.4; reference intra.cpp:140-292, :426-533, :568-687). Batched
over leading dims, int32.

Neighbour-sample layout (value -1 = unavailable):
  4x4:    p[..., 0] = corner; p[..., 1:5] = left column y = 0..3;
          p[..., 5:13] = top row x = 0..7 (the last 4 are above-right)
  16x16:  p[..., 0] = corner; p[..., 1:17] = left; p[..., 17:33] = top
  chroma: p[..., 0] = corner; p[..., 1:9] = left;  p[..., 9:17] = top
"""

from __future__ import annotations

import numpy as np
import torch

from .device import const

# Intra4x4 modes: 0 V, 1 H, 2 DC, 3 DDL, 4 DDR, 5 VR, 6 HD, 7 VL, 8 HU.
I4X4_VERTICAL = 0
I4X4_HORIZONTAL = 1
I4X4_DC = 2
I4X4_DIAG_DOWN_LEFT = 3
I4X4_DIAG_DOWN_RIGHT = 4
I4X4_VERTICAL_RIGHT = 5
I4X4_HORIZONTAL_DOWN = 6
I4X4_VERTICAL_LEFT = 7
I4X4_HORIZONTAL_UP = 8

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


def _p4(p, x: int, y: int):
    """Sample p(x, y) of a 4x4 block's neighbours: x == -1 is the left
    column p[y + 1], so (x, y) = (-1, -1) is the corner p[0], which the
    directional index arithmetic also reaches; otherwise the top row
    p[x + 5]."""
    return p[..., y + 1] if x == -1 else p[..., x + 5]


def _cell4(P, mode: int, x: int, y: int):
    """The prediction of sample (x, y) in a directional Intra4x4 mode
    (3..8), with P(x, y) the neighbour sample accessor. A doubled sample
    is written as a multiplication: the unavailable samples are -1."""
    def f3(a, b, c):
        return (a + 2 * b + c + 2) >> 2

    def f2(a, b):
        return (a + b + 1) >> 1

    if mode == I4X4_DIAG_DOWN_LEFT:
        if x == 3 and y == 3:
            return (P(6, -1) + 3 * P(7, -1) + 2) >> 2
        return f3(P(x + y, -1), P(x + y + 1, -1), P(x + y + 2, -1))
    if mode == I4X4_DIAG_DOWN_RIGHT:
        if x > y:
            return f3(P(x - y - 2, -1), P(x - y - 1, -1), P(x - y, -1))
        if x < y:
            return f3(P(-1, y - x - 2), P(-1, y - x - 1), P(-1, y - x))
        return f3(P(0, -1), P(-1, -1), P(-1, 0))
    if mode == I4X4_VERTICAL_RIGHT:
        z = 2 * x - y
        if z in (0, 2, 4, 6):
            return f2(P(x - (y >> 1) - 1, -1), P(x - (y >> 1), -1))
        if z in (1, 3, 5):
            return f3(P(x - (y >> 1) - 2, -1), P(x - (y >> 1) - 1, -1),
                      P(x - (y >> 1), -1))
        if z == -1:
            return f3(P(-1, 0), P(-1, -1), P(0, -1))
        return f3(P(-1, y - 1), P(-1, y - 2), P(-1, y - 3))
    if mode == I4X4_HORIZONTAL_DOWN:
        z = 2 * y - x
        if z in (0, 2, 4, 6):
            return f2(P(-1, y - (x >> 1) - 1), P(-1, y - (x >> 1)))
        if z in (1, 3, 5):
            return f3(P(-1, y - (x >> 1) - 2), P(-1, y - (x >> 1) - 1),
                      P(-1, y - (x >> 1)))
        if z == -1:
            return f3(P(-1, 0), P(-1, -1), P(0, -1))
        return f3(P(x - 1, -1), P(x - 2, -1), P(x - 3, -1))
    if mode == I4X4_VERTICAL_LEFT:
        if y in (0, 2):
            return f2(P(x + (y >> 1), -1), P(x + (y >> 1) + 1, -1))
        return f3(P(x + (y >> 1), -1), P(x + (y >> 1) + 1, -1),
                  P(x + (y >> 1) + 2, -1))
    if mode == I4X4_HORIZONTAL_UP:
        z = x + 2 * y
        if z in (0, 2, 4):
            return f2(P(-1, y + (x >> 1)), P(-1, y + (x >> 1) + 1))
        if z in (1, 3):
            return f3(P(-1, y + (x >> 1)), P(-1, y + (x >> 1) + 1),
                      P(-1, y + (x >> 1) + 2))
        if z == 5:
            return (P(-1, 2) + 3 * P(-1, 3) + 2) >> 2
        return P(-1, 3)
    raise ValueError(f"bad intra 4x4 mode {mode}")


def predict_4x4(p, mode: int):
    """Predict a 4x4 luma block. p: (..., 13) int32 → (..., 4, 4). DC
    reads availability from the -1 samples, as intra.cpp:164-181 does."""
    def P(x, y):
        return _p4(p, x, y)

    shape = p.shape[:-1] + (4, 4)
    if mode == I4X4_VERTICAL:
        return p[..., None, 5:9].expand(shape)
    if mode == I4X4_HORIZONTAL:
        return p[..., 1:5, None].expand(shape)
    if mode == I4X4_DC:
        top4 = p[..., 5:9].sum(dim=-1, dtype=torch.int32)
        left4 = p[..., 1:5].sum(dim=-1, dtype=torch.int32)
        dc = torch.where(
            p[..., 0] != -1, (top4 + left4 + 4) >> 3,
            torch.where(p[..., 1] != -1, (left4 + 2) >> 2,
                        torch.where(p[..., 5] != -1, (top4 + 2) >> 2, 128)))
        return dc[..., None, None].expand(shape)
    rows = [torch.stack([_cell4(P, mode, x, y) for x in range(4)], dim=-1)
            for y in range(4)]
    return torch.stack(rows, dim=-2)


def predict_4x4_all_modes(p):
    """(9, ..., 4, 4): every Intra4x4 mode."""
    return torch.stack([predict_4x4(p, m) for m in range(9)], dim=0)


class _Sum:
    """Weighted neighbour samples plus a constant, then a right shift: what
    _cell4 computes, recorded when it runs on _Sum samples."""

    def __init__(self, w, c=0, shift=0):
        self.w, self.c, self.shift = w, c, shift

    def __add__(self, o):
        if isinstance(o, int):
            return _Sum(self.w, self.c + o)
        w = dict(self.w)
        for i, v in o.w.items():
            w[i] = w.get(i, 0) + v
        return _Sum(w, self.c + o.c)

    def __rmul__(self, k: int):
        return _Sum({i: k * v for i, v in self.w.items()}, k * self.c)

    def __rshift__(self, s: int):
        return _Sum(self.w, self.c, s)


def _mode_tables():
    """Per mode (9) and sample (16): the indices and weights of 3 samples of
    p, the rounding constant and the shift, so that the prediction is
    (sum(w * p[i]) + c) >> s; zero for DC, which predict_4x4_by_mode
    computes apart."""
    idx = np.zeros((9, 16, 3), np.int64)
    w, c, sh = np.zeros((9, 16, 3), np.int32), np.zeros((9, 16), np.int32), np.zeros((9, 16), np.int32)

    def P(x, y):
        return _Sum({y + 1 if x == -1 else x + 5: 1})

    for m in range(9):
        for y in range(4):
            for x in range(4):
                if m == I4X4_DC:
                    continue
                f = (P(x, -1) if m == I4X4_VERTICAL else P(-1, y)
                     if m == I4X4_HORIZONTAL else _cell4(P, m, x, y))
                k = 4 * y + x
                for j, (i, v) in enumerate(sorted(f.w.items())):
                    idx[m, k, j], w[m, k, j] = i, v
                c[m, k], sh[m, k] = f.c, f.shift
    return idx, w, c, sh


_IDX4, _W4, _C4, _SH4 = _mode_tables()


def packed_mode_table() -> np.ndarray:
    """_mode_tables as one int32 per (mode, sample 4y + x), 9 x 16, for the
    CUDA Intra_4x4 body (csrc/intra4x4.cuh, pred4_packed): the three
    sample indices of p in bits 0-3, 4-7, 8-11, their weights in bits
    12-13, 14-15, 16-17, the rounding constant in 18-19 and the shift in
    20-21. Zero for DC."""
    i, w = _IDX4.astype(np.int64), _W4.astype(np.int64)
    packed = (i[..., 0] | i[..., 1] << 4 | i[..., 2] << 8 | w[..., 0] << 12
              | w[..., 1] << 14 | w[..., 2] << 16 | _C4.astype(np.int64) << 18
              | _SH4.astype(np.int64) << 20)
    return packed.reshape(-1).astype(np.int32)


def predict_4x4_by_mode(p, mode):
    """Predict each 4x4 block in its own mode: p (n, 13), mode (n,) int →
    (n, 4, 4); equal to predict_4x4_all_modes gathered at `mode`, without
    computing the other 8 modes."""
    n, dev = p.shape[0], p.device
    m = mode.long()
    samples = p.gather(1, const(_IDX4, dev)[m].reshape(n, 48)).reshape(n, 16, 3)
    v = ((samples * const(_W4, dev)[m]).sum(dim=-1, dtype=torch.int32)
         + const(_C4, dev)[m]) >> const(_SH4, dev)[m]
    dc = predict_4x4(p, I4X4_DC)[..., 0, 0]
    return torch.where((m == I4X4_DC)[:, None], dc[:, None], v).reshape(n, 4, 4)


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
