"""Inter motion compensation: quarter-pel luma (6-tap), eighth-pel chroma.

Bit-exact re-derivation of the reference's MC (mocomp.cpp): per 4x4 luma
block, fetch a 9x9 edge-clamped window at the integer part of the MV,
interpolate the fractional position with the (1,-5,20,20,-5,1) half-pel
filter plus bilinear quarter-pel averaging (mocomp.cpp:39-78); chroma uses
a 3x3 window and 1/8-pel bilinear (mocomp.cpp:176-195).

A copy of h264_fer_tpu/ops/mc.py, host side (NumPy). The decoder's Python
form takes it for MVs beyond the extent of its interpolated planes
(ops/interp.mc_macroblock_from_planes).
"""

from __future__ import annotations

import numpy as np


def _clip_idx(idx, size):
    return np.clip(idx, 0, size - 1)


def fetch_window(plane: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Edge-clamped (h, w) window with top-left at (x0, y0)
    (reference FillTemp_4x4_refPart, mocomp.cpp:11-36)."""
    H, W = plane.shape
    ys = _clip_idx(np.arange(y0, y0 + h), H)
    xs = _clip_idx(np.arange(x0, x0 + w), W)
    return plane[np.ix_(ys, xs)].astype(np.int32)


def _tap6(e, f, g, h, i, j):
    return np.clip((e - 5 * f + 20 * g + 20 * h - 5 * i + j + 16) >> 5, 0, 255)


def _middle(a, b):
    return (a + b + 1) >> 1


def interpolate_luma_block(win: np.ndarray, frac: int) -> np.ndarray:
    """Interpolate a 4x4 luma block at fractional position frac = fy*4+fx.

    `win` is the 9x9 window whose [2, 2] element is the integer-pel origin.
    Vectorized equivalent of L_MC_frac_interpol (mocomp.cpp:50-78) applied
    to all 16 output pixels at once.
    """
    # p(x, y) for the 4x4 output grid = win[2+y+dy, 2+x+dx]
    def p(dx, dy):
        return win[2 + dy : 6 + dy, 2 + dx : 6 + dx]

    fx, fy = frac & 3, frac >> 2
    if frac == 0:
        return p(0, 0)
    b = _tap6(p(-2, 0), p(-1, 0), p(0, 0), p(1, 0), p(2, 0), p(3, 0))
    if frac == 1:
        return _middle(p(0, 0), b)
    if frac == 2:
        return b
    if frac == 3:
        return _middle(b, p(1, 0))
    h = _tap6(p(0, -2), p(0, -1), p(0, 0), p(0, 1), p(0, 2), p(0, 3))
    if frac == 4:
        return _middle(p(0, 0), h)
    if frac == 8:
        return h
    if frac == 12:
        return _middle(h, p(0, 1))
    if frac == 5:
        return _middle(b, h)
    m = _tap6(p(1, -2), p(1, -1), p(1, 0), p(1, 1), p(1, 2), p(1, 3))
    if frac == 7:
        return _middle(b, m)
    s = _tap6(p(-2, 1), p(-1, 1), p(0, 1), p(1, 1), p(2, 1), p(3, 1))
    if frac == 13:
        return _middle(h, s)
    if frac == 15:
        return _middle(s, m)
    # center positions need the 2D-filtered 'j' from intermediate columns
    cc = _tap6(p(-2, -2), p(-2, -1), p(-2, 0), p(-2, 1), p(-2, 2), p(-2, 3))
    dd = _tap6(p(-1, -2), p(-1, -1), p(-1, 0), p(-1, 1), p(-1, 2), p(-1, 3))
    ee = _tap6(p(2, -2), p(2, -1), p(2, 0), p(2, 1), p(2, 2), p(2, 3))
    ff = _tap6(p(3, -2), p(3, -1), p(3, 0), p(3, 1), p(3, 2), p(3, 3))
    j = _tap6(cc, dd, h, m, ee, ff)
    if frac == 10:
        return j
    if frac == 6:
        return _middle(b, j)
    if frac == 9:
        return _middle(h, j)
    if frac == 14:
        return _middle(j, s)
    if frac == 11:
        return _middle(j, m)
    raise ValueError(f"bad frac {frac}")


def interpolate_chroma_block(win: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """2x2 chroma block, 1/8-pel bilinear (mocomp.cpp:176-195).

    `win` is the 3x3 chroma window with [0, 0] at the integer origin.
    """
    a = win[0:2, 0:2]
    b = win[0:2, 1:3]
    c = win[1:3, 0:2]
    d = win[1:3, 1:3]
    return (
        (8 - fx) * (8 - fy) * a
        + fx * (8 - fy) * b
        + (8 - fx) * fy * c
        + fx * fy * d
        + 32
    ) >> 6


def mc_block_4x4(
    ref_y: np.ndarray,
    ref_cb: np.ndarray,
    ref_cr: np.ndarray,
    x_al: int,
    y_al: int,
    mvx: int,
    mvy: int,
):
    """MC for one 4x4 luma block + its 2x2 chroma blocks
    (reference MotionCompensateSubMBPart, mocomp.cpp:152-195).

    (x_al, y_al) is the block's absolute luma position. mv in quarter-pel.
    Returns (luma4x4, cb2x2, cr2x2) int32.
    """
    lx = x_al + (mvx >> 2) - 2
    ly = y_al + (mvy >> 2) - 2
    win = fetch_window(ref_y, lx, ly, 9, 9)
    frac = (mvy & 3) * 4 + (mvx & 3)
    luma = interpolate_luma_block(win, frac)

    cx = x_al // 2 + (mvx >> 3)
    cy = y_al // 2 + (mvy >> 3)
    fx, fy = mvx & 7, mvy & 7
    cb = interpolate_chroma_block(fetch_window(ref_cb, cx, cy, 3, 3), fx, fy)
    cr = interpolate_chroma_block(fetch_window(ref_cr, cx, cy, 3, 3), fx, fy)
    return luma, cb, cr


def mc_macroblock(
    ref_y: np.ndarray,
    ref_cb: np.ndarray,
    ref_cr: np.ndarray,
    mb_x: int,
    mb_y: int,
    mv: np.ndarray,
):
    """MC for a full MB (reference Decode, mocomp.cpp:200-208).

    mv: (4, 4, 2) int32 — [subMbIdx(8x8 quadrant), subMbPartIdx(4x4), (x, y)]
    in quarter-pel units. Returns (pred_l 16x16, pred_cb 8x8, pred_cr 8x8).
    """
    pred_l = np.zeros((16, 16), np.int32)
    pred_cb = np.zeros((8, 8), np.int32)
    pred_cr = np.zeros((8, 8), np.int32)
    for sub in range(4):
        for part in range(4):
            org_y = ((sub & 2) << 2) + ((part & 2) << 1)
            org_x = ((sub & 1) << 3) + ((part & 1) << 2)
            mvx, mvy = int(mv[sub, part, 0]), int(mv[sub, part, 1])
            luma, cb, cr = mc_block_4x4(
                ref_y, ref_cb, ref_cr, mb_x * 16 + org_x, mb_y * 16 + org_y, mvx, mvy
            )
            pred_l[org_y : org_y + 4, org_x : org_x + 4] = luma
            pred_cb[org_y // 2 : org_y // 2 + 2, org_x // 2 : org_x // 2 + 2] = cb
            pred_cr[org_y // 2 : org_y // 2 + 2, org_x // 2 : org_x // 2 + 2] = cr
    return pred_l, pred_cb, pred_cr
