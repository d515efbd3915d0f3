"""Intra prediction and inverse transforms of one macroblock, host side (numpy).

The decoder's Python form reconstructs MB by MB, and block by block in
Intra_4x4, as the reference does; a PyTorch call per 4x4 block costs more
than the block's arithmetic. These are the numpy paths of
h264_fer_tpu/ops/intra.py (predict_4x4, predict_16x16, predict_chroma) and
h264_fer_tpu/ops/transform.py (inverse_residual, inverse_dc_luma,
inverse_dc_chroma, zigzag_unscan), int32 with arithmetic shifts. The
directional Intra_4x4 modes read the port's own per-sample tables
(ops/intra._mode_tables), from which the CUDA Intra_4x4 body also takes
them. tests/test_torch_decoder.py holds every function equal to the
port's PyTorch version and to the JAX package's numpy one.
"""

from __future__ import annotations

import numpy as np

from .intra import _C4, _IDX4, _SH4, _W4, CHROMA_DC, CHROMA_HORIZONTAL, CHROMA_VERTICAL
from .intra import I4X4_DC, I16_DC, I16_HORIZONTAL, I16_VERTICAL
from .tables import INV_ZIGZAG_FLAT, LEVEL_SCALE
from .transform import _HAD2, _HAD4

_H4 = np.array(_HAD4, np.int32)
_H2 = np.array(_HAD2, np.int32)


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
