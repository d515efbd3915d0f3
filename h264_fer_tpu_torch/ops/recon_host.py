"""Intra prediction and inverse transforms of one macroblock, host side (numpy).

The decoder's Python form and the host per-MB encoder reconstruct MB by
MB, and block by block in Intra_4x4, as the reference does; a PyTorch call
per 4x4 block costs more than the block's arithmetic. These are the numpy
paths of h264_fer_tpu/ops/intra.py (predict_4x4, predict_16x16,
predict_chroma) and h264_fer_tpu/ops/transform.py (inverse_residual,
inverse_dc_luma, inverse_dc_chroma, zigzag_unscan), int32 with arithmetic
shifts, the reference's neighbour-sample fetches (fetch_p13, fetch_p33,
fetch_p17) and the residual of a whole MB from its levels. The directional
Intra_4x4 modes read the port's own per-sample tables
(ops/intra._mode_tables), from which the CUDA Intra_4x4 body also takes
them. tests/test_torch_decoder.py holds every function equal to the
port's PyTorch version and to the JAX package's numpy one.
"""

from __future__ import annotations

import numpy as np

from .intra import _C4, _IDX4, _SH4, _W4, CHROMA_DC, CHROMA_HORIZONTAL, CHROMA_VERTICAL
from .intra import I4X4_DC, I16_DC, I16_HORIZONTAL, I16_VERTICAL
from .tables import INTRA4X4_SCAN_ORDER_XY, INV_ZIGZAG_FLAT, LEVEL_SCALE, LUMA_NBR
from .transform import _HAD2, _HAD4

_H4 = np.array(_HAD4, np.int32)
_H2 = np.array(_HAD2, np.int32)
_BLK_XY = INTRA4X4_SCAN_ORDER_XY  # (16, 2) x, y of each Z-scan 4x4 block


def fetch_p13(y: np.ndarray, x0: int, y0: int, blk: int) -> np.ndarray:
    """The 13 neighbour samples of Z-scan block `blk` of the MB at (x0, y0)
    in plane y (FetchPredictionSamplesIntra4x4, intra.cpp:294-378): corner,
    left 4, top 4, top-right 4, -1 where unavailable. The top-right repeats
    the last top sample at the frame's right edge, in the MB's right column
    below its top row, and for blocks 3 and 11."""
    bx, by = int(_BLK_XY[blk, 0]), int(_BLK_XY[blk, 1])
    x, yy = x0 + bx, y0 + by
    p = np.full(13, -1, np.int32)
    if x > 0 and yy > 0:
        p[0] = y[yy - 1, x - 1]
    if x > 0:
        p[1:5] = y[yy: yy + 4, x - 1]
    if yy > 0:
        p[5:9] = y[yy - 1, x: x + 4]
        if x + 4 >= y.shape[1] or (bx == 12 and by > 0) or blk in (3, 11):
            p[9:13] = y[yy - 1, x + 3]
        else:
            p[9:13] = y[yy - 1, x + 4: x + 8]
    return p


def fetch_p33(y: np.ndarray, x0: int, y0: int) -> np.ndarray:
    """The 33 neighbour samples of the 16x16 MB at (x0, y0): corner, left
    16, top 16, -1 where unavailable."""
    p = np.full(33, -1, np.int32)
    if x0 > 0 and y0 > 0:
        p[0] = y[y0 - 1, x0 - 1]
    if x0 > 0:
        p[1:17] = y[y0: y0 + 16, x0 - 1]
    if y0 > 0:
        p[17:33] = y[y0 - 1, x0: x0 + 16]
    return p


def fetch_p17(plane: np.ndarray, cx: int, cy: int) -> np.ndarray:
    """The 17 neighbour samples of the 8x8 chroma MB at (cx, cy)."""
    p = np.full(17, -1, np.int32)
    if cx > 0 and cy > 0:
        p[0] = plane[cy - 1, cx - 1]
    if cx > 0:
        p[1:9] = plane[cy: cy + 8, cx - 1]
    if cy > 0:
        p[9:17] = plane[cy - 1, cx: cx + 8]
    return p


def intra4x4_pred_mode(i4x4_mode, mb_i4x4, wmb: int, curr: int, blk: int,
                       constrained: bool = False) -> int:
    """The predicted Intra_4x4 mode of block `blk` of MB `curr`
    (getIntra4x4PredMode, intra.cpp:77-135): the lesser of the left and top
    blocks' modes, 2 (DC) for a neighbour MB not coded Intra_4x4, and 2 when
    either neighbour is outside the frame (or with constrained intra
    prediction). i4x4_mode (nmb, 16) and mb_i4x4 (nmb,) per MB."""
    a_same, a_blk, b_same, b_blk = LUMA_NBR[blk]
    mode_a = mode_b = None
    if a_same:
        mode_a = int(i4x4_mode[curr, a_blk])
    elif curr % wmb != 0:
        mode_a = int(i4x4_mode[curr - 1, a_blk]) if mb_i4x4[curr - 1] else 2
    if b_same:
        mode_b = int(i4x4_mode[curr, b_blk])
    elif curr >= wmb:
        mode_b = int(i4x4_mode[curr - wmb, b_blk]) if mb_i4x4[curr - wmb] else 2
    if mode_a is None or mode_b is None or constrained:
        return 2
    return min(mode_a, mode_b)


def mb_of_blocks(blocks: np.ndarray) -> np.ndarray:
    """The (16, 16) MB of (16, 4, 4) Z-scan blocks."""
    out = np.empty((16, 16), np.int32)
    for blk in range(16):
        bx, by = int(_BLK_XY[blk, 0]), int(_BLK_XY[blk, 1])
        out[by: by + 4, bx: bx + 4] = blocks[blk]
    return out


def _dc(total_both: int, total_a: int, total_b: int, both: bool, a_ok: bool,
        b_ok: bool, shift: int) -> int:
    """DC of a block whose two edges hold n = 1 << (shift - 1) samples each:
    both edges, else edge a, else edge b, else 128."""
    if both:
        return (total_both + (1 << (shift - 1))) >> shift
    if a_ok:
        return (total_a + (1 << (shift - 2))) >> (shift - 1)
    if b_ok:
        return (total_b + (1 << (shift - 2))) >> (shift - 1)
    return 128


def predict_4x4(p: np.ndarray, mode: int) -> np.ndarray:
    """Predict a 4x4 luma block: p (13,) int32 neighbours (ops/intra.py's
    layout, -1 = unavailable) → (4, 4) int32. DC reads availability from
    the -1 samples (intra.cpp:164-181)."""
    if mode == I4X4_DC:
        left, top = int(p[1:5].sum()), int(p[5:9].sum())
        v = _dc(left + top, left, top, p[0] != -1, p[1] != -1, p[5] != -1, 3)
        return np.full((4, 4), v, np.int32)
    s = p[_IDX4[mode]]  # (16, 3) weighted samples of each prediction sample
    return (((s * _W4[mode]).sum(-1, dtype=np.int32) + _C4[mode]) >> _SH4[mode]).reshape(4, 4)


def _plane(corner, left, top, n: int, scale: int) -> np.ndarray:
    """Plane prediction of an n x n block (n = 16 luma, 8 chroma)."""
    half = n // 2
    i = np.arange(half)
    w = (i + 1).astype(np.int32)
    tfull = np.concatenate([[corner], top]).astype(np.int32)  # x index + 1
    lfull = np.concatenate([[corner], left]).astype(np.int32)
    hsum = int((w * (tfull[half + 1: n + 1] - tfull[half - 1 - i])).sum())
    vsum = int((w * (lfull[half + 1: n + 1] - lfull[half - 1 - i])).sum())
    a = (int(left[n - 1]) + int(top[n - 1])) << 4
    b = (scale * hsum + 32) >> 6
    c = (scale * vsum + 32) >> 6
    xs = np.arange(n, dtype=np.int32) - (half - 1)
    return np.clip((a + b * xs[None, :] + c * xs[:, None] + 16) >> 5, 0, 255).astype(np.int32)


def predict_16x16(p: np.ndarray, mode: int) -> np.ndarray:
    """Predict a 16x16 luma MB: p (33,) int32 → (16, 16) int32."""
    corner, left, top = p[0], p[1:17], p[17:33]
    if mode == I16_VERTICAL:
        return np.broadcast_to(top[None, :], (16, 16))
    if mode == I16_HORIZONTAL:
        return np.broadcast_to(left[:, None], (16, 16))
    if mode == I16_DC:
        sl, st = int(left.sum()), int(top.sum())
        v = _dc(sl + st, sl, st, corner != -1, left[0] != -1, top[0] != -1, 5)
        return np.full((16, 16), v, np.int32)
    return _plane(corner, left, top, 16, 5)


def predict_chroma(p: np.ndarray, mode: int) -> np.ndarray:
    """Predict an 8x8 chroma MB: p (17,) int32 → (8, 8) int32."""
    corner, left, top = p[0], p[1:9], p[9:17]
    if mode == CHROMA_HORIZONTAL:
        return np.broadcast_to(left[:, None], (8, 8))
    if mode == CHROMA_VERTICAL:
        return np.broadcast_to(top[None, :], (8, 8))
    if mode == CHROMA_DC:
        out = np.empty((8, 8), np.int32)
        for blk in range(4):
            x0, y0 = (blk & 1) << 2, (blk >> 1) << 2
            sx, sy = int(top[x0: x0 + 4].sum()), int(left[y0: y0 + 4].sum())
            l_ok, t_ok = left[y0] != -1, top[x0] != -1
            if blk == 1:  # top-right: prefer top
                v = _dc(0, sx, sy, False, t_ok, l_ok, 3)
            elif blk == 2:  # bottom-left: prefer left
                v = _dc(0, sy, sx, False, l_ok, t_ok, 3)
            else:  # corner blocks: both, then left, then top
                v = _dc(sx + sy, sy, sx, l_ok and t_ok, l_ok, t_ok, 3)
            out[y0: y0 + 4, x0: x0 + 4] = v
        return out
    return _plane(corner, left, top, 8, 34)


def zigzag_unscan(lst: np.ndarray) -> np.ndarray:
    """(..., 16) zig-zag lists → (..., 4, 4) blocks (transformInverseScan)."""
    return lst[..., INV_ZIGZAG_FLAT].reshape(lst.shape[:-1] + (4, 4))


def _scale_residual(c: np.ndarray, qp: int, dc_bypass: bool) -> np.ndarray:
    """scaleResidualBlock (scaleTransform.cpp:308-340)."""
    ls = LEVEL_SCALE[qp % 6]
    if qp >= 24:
        d = (c * ls) << (qp // 6 - 4)
    else:
        d = (c * ls + (1 << (3 - qp // 6))) >> (4 - qp // 6)
    if dc_bypass:
        d[..., 0, 0] = c[..., 0, 0]
    return d


def _inverse_transform_4x4(d: np.ndarray) -> np.ndarray:
    """inverseTransform4x4 (scaleTransform.cpp:101-150): row butterfly,
    column butterfly, then (h + 32) >> 6."""
    d0, d1, d2, d3 = (d[..., :, k] for k in range(4))
    e0, e1, e2, e3 = d0 + d2, d0 - d2, (d1 >> 1) - d3, d1 + (d3 >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    f0, f1, f2, f3 = (f[..., k, :] for k in range(4))
    g0, g1, g2, g3 = f0 + f2, f0 - f2, (f1 >> 1) - f3, f1 + (f3 >> 1)
    return (np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=-2) + 32) >> 6


def inverse_residual(c: np.ndarray, qp: int, dc_bypass: bool) -> np.ndarray:
    """Dequantize and inverse-transform (..., 4, 4) int32 level blocks."""
    return _inverse_transform_4x4(_scale_residual(c, qp, dc_bypass))


def inverse_dc_luma(c: np.ndarray, qp: int) -> np.ndarray:
    """InverseDCLumaIntra: H·c·H^T, then scaleLumaDCIntra (4, 4) int32."""
    f = _H4 @ c @ _H4.T
    ls = int(LEVEL_SCALE[qp % 6, 0, 0])
    if qp >= 36:
        return (f * ls) << (qp // 6 - 6)
    return (f * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def inverse_dc_chroma(c: np.ndarray, qp: int) -> np.ndarray:
    """InverseDCChroma: H2·c·H2, then ((f·LS) << qP//6) >> 5, (..., 2, 2)."""
    f = _H2 @ c @ _H2
    return ((f * int(LEVEL_SCALE[qp % 6, 0, 0])) << (qp // 6)) >> 5


def luma_residual(levels: np.ndarray, qp: int) -> np.ndarray:
    """The (16, 16) residual of an MB's 16 Z-scan 4x4 level lists (16, 16)."""
    return mb_of_blocks(inverse_residual(zigzag_unscan(levels), qp, False))


def i16_luma_residual(i16dc: np.ndarray, ac: np.ndarray, qp: int) -> np.ndarray:
    """The (16, 16) residual of an Intra_16x16 MB (8.5.2,
    inttransform.cpp:157-208): its DC list (16,) through the inverse
    Hadamard, and its 16 AC lists (16, 15), the 16 blocks at once."""
    dcv = inverse_dc_luma(zigzag_unscan(i16dc), qp)
    lists = np.empty((16, 16), np.int32)
    lists[:, 0] = dcv[_BLK_XY[:, 1] >> 2, _BLK_XY[:, 0] >> 2]
    lists[:, 1:] = ac
    return mb_of_blocks(inverse_residual(zigzag_unscan(lists), qp, True))


def chroma_residual(dc: np.ndarray, ac: np.ndarray, qpc: int) -> np.ndarray:
    """The (2, 8, 8) Cb and Cr residual of an MB (transformDecodingChroma,
    inttransform.cpp:237-321) from its DC (2, 4) and AC (2, 4, 15) levels."""
    dcv = inverse_dc_chroma(dc.reshape(2, 2, 2), qpc)
    lists = np.empty((2, 4, 16), np.int32)
    lists[:, :, 0] = dcv.reshape(2, 4)
    lists[:, :, 1:] = ac
    res = inverse_residual(zigzag_unscan(lists), qpc, True)
    return res.reshape(2, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4).reshape(2, 8, 8)
