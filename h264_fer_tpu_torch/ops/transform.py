"""Batched integer 4x4 DCT / Hadamard transforms and quantization (torch).

The PyTorch counterpart of h264_fer_tpu/ops/transform.py, which re-derives
the reference's integer transform pipeline bit for bit:
  - forward core transform + quant:  quantizationTransform.cpp:41-282
  - inverse scale + transform:       scaleTransform.cpp:101-445
  - chroma QP map:                   inttransform.cpp:8-14

Every function is batched over leading dims: (..., 4, 4) int32 tensors
(or (..., 2, 2) for chroma DC) on any device. The 4x4 products are
broadcast integer products and sums, because integer matmul is not
available on CUDA. `>>` on int32 is an
arithmetic shift, as in the reference's g++ build.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import const
from .tables import INV_ZIGZAG_FLAT, LEVEL_QUANTIZE, LEVEL_SCALE, QPI_TO_QPC, ZIGZAG_FLAT

# Forward core transform weights (quantizationTransform.cpp:41-100): the
# reference computes h = (r << 6) - 32 for nonzero r, then
# f = (W·h + 512) >> 10 and d = (f·W^T + 512) >> 10.
_FWD_W = ((256, 256, 256, 256), (416, 208, -208, -416),
          (256, -256, -256, 256), (208, -416, 416, -208))
# 4x4 / 2x2 Hadamard (quantizationTransform.cpp:105-178,
# scaleTransform.cpp:154-260).
_HAD4 = ((1, 1, 1, 1), (1, 1, -1, -1), (1, -1, -1, 1), (1, -1, 1, -1))
_HAD2 = ((1, 1), (1, -1))


def _left(m, x):
    """m @ x for a constant int matrix m over the last two dims of x, as
    one broadcast product and sum (integer matmul is not available on
    CUDA)."""
    mt = const(np.array(m, np.int32), x.device)
    return (mt[:, :, None] * x[..., None, :, :]).sum(dim=-2, dtype=torch.int32)


def _right_t(x, m):
    """x @ m^T for a constant int matrix m over the last two dims of x."""
    mt = const(np.array(m, np.int32), x.device)
    return (x[..., :, None, :] * mt).sum(dim=-1, dtype=torch.int32)


def _table(table, qp: int, like: torch.Tensor) -> torch.Tensor:
    return const(table[qp % 6], like.device)


def forward_transform_4x4(r):
    """Forward scaled 4x4 integer DCT. r: (..., 4, 4) int32 residual.

    Reference: forwardTransform4x4, quantizationTransform.cpp:41-100.
    """
    h = torch.where(r == 0, 0, r * 64 - 32)
    f = (_left(_FWD_W, h) + 512) >> 10
    return (_right_t(f, _FWD_W) + 512) >> 10


def forward_hadamard_dc_luma(f):
    """(H·f·H^T + 8) >> 4 (forwardTransformDCLumaIntra)."""
    return (_right_t(_left(_HAD4, f), _HAD4) + 8) >> 4


def forward_hadamard_dc_chroma(f):
    """(H2·f·H2 + 2) >> 2 (forwardTransformDCChroma)."""
    return (_right_t(_left(_HAD2, f), _HAD2) + 2) >> 2


def quantize_residual(d, qp: int, dc_bypass: bool):
    """Quantize a transformed 4x4 block (quantisationResidualBlock,
    quantizationTransform.cpp:183-223). With `dc_bypass` the DC passes
    through unquantized for the dedicated DC path."""
    lq = _table(LEVEL_QUANTIZE, qp, d)
    if qp < 24:
        qbits = 4 - qp // 6
        adjust = 1 << (3 - qp // 6)
        c = (((d << qbits) - adjust) * lq + 16384) >> 15
    else:
        c = ((d >> (qp // 6 - 4)) * lq + 16384) >> 15
    if dc_bypass:
        c = set_dc(c, d[..., 0, 0])
    return c


def quantize_dc_luma(f, qp: int):
    """quantisationLumaDCIntra, quantizationTransform.cpp:227-260."""
    lq = int(LEVEL_QUANTIZE[qp % 6, 0, 0])
    if qp >= 36:
        return ((f >> (qp // 6 - 6)) * lq + 16384) >> 15
    adjust = 1 << (5 - qp // 6)
    return (((f << (6 - qp // 6)) - adjust) * lq + 16384) >> 15


def quantize_dc_chroma(f, qp: int):
    """quantisationChromaDC, quantizationTransform.cpp:264-282."""
    lq = int(LEVEL_QUANTIZE[qp % 6, 0, 0])
    return (((f << 5) >> (qp // 6)) * lq + 16384) >> 15


def scale_residual(c, qp: int, dc_bypass: bool):
    """Dequantize a 4x4 block (scaleResidualBlock, scaleTransform.cpp:308-340)."""
    ls = _table(LEVEL_SCALE, qp, c)
    if qp >= 24:
        d = (c * ls) << (qp // 6 - 4)
    else:
        d = (c * ls + (1 << (3 - qp // 6))) >> (4 - qp // 6)
    if dc_bypass:
        d = set_dc(d, c[..., 0, 0])
    return d


def scale_dc_luma(f, qp: int):
    """scaleLumaDCIntra, scaleTransform.cpp:344-404."""
    ls = int(LEVEL_SCALE[qp % 6, 0, 0])
    if qp >= 36:
        return (f * ls) << (qp // 6 - 6)
    return (f * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def scale_dc_chroma(f, qp: int):
    """((f·LS) << qP//6) >> 5 (scaleChromaDC, scaleTransform.cpp:408-445)."""
    ls = int(LEVEL_SCALE[qp % 6, 0, 0])
    return ((f * ls) << (qp // 6)) >> 5


def inverse_transform_4x4(d):
    """Inverse 4x4 core transform (norm 8.5.12.2; inverseTransform4x4,
    scaleTransform.cpp:101-150): row butterfly, column butterfly, then
    (h + 32) >> 6."""
    d0, d1, d2, d3 = (d[..., :, k] for k in range(4))
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    f0, f1, f2, f3 = (f[..., k, :] for k in range(4))
    g0, g1 = f0 + f2, f0 - f2
    g2, g3 = (f1 >> 1) - f3, f1 + (f3 >> 1)
    h = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=-2)
    return (h + 32) >> 6


def inverse_hadamard_dc_luma(c):
    """H·c·H^T, no rounding (inverseTransformDCLumaIntraFast)."""
    return _right_t(_left(_HAD4, c), _HAD4)


def inverse_hadamard_dc_chroma(c):
    """H2·c·H2 (transformDCChromaFast)."""
    return _right_t(_left(_HAD2, c), _HAD2)


def inverse_residual(c, qp: int, dc_bypass: bool):
    return inverse_transform_4x4(scale_residual(c, qp, dc_bypass))


def forward_dc_luma(dc, qp: int):
    return quantize_dc_luma(forward_hadamard_dc_luma(dc), qp)


def inverse_dc_luma(c, qp: int):
    return scale_dc_luma(inverse_hadamard_dc_luma(c), qp)


def forward_dc_chroma(dc, qp: int):
    return quantize_dc_chroma(forward_hadamard_dc_chroma(dc), qp)


def inverse_dc_chroma(c, qp: int):
    return scale_dc_chroma(inverse_hadamard_dc_chroma(c), qp)


def chroma_qp(qp_y: int, chroma_qp_index_offset: int = 0) -> int:
    """Map luma QP to chroma QP (norm Table 8-15)."""
    return int(QPI_TO_QPC[min(51, max(0, qp_y + chroma_qp_index_offset))])


def zigzag_scan(c):
    """(..., 4, 4) blocks → (..., 16) zig-zag lists (transformScan)."""
    flat = c.reshape(c.shape[:-2] + (16,))
    return flat[..., const(ZIGZAG_FLAT.astype("int64"), c.device)]


def zigzag_unscan(lst):
    """(..., 16) zig-zag lists → (..., 4, 4) blocks (transformInverseScan,
    scaleTransform.cpp:454-462)."""
    flat = lst[..., const(INV_ZIGZAG_FLAT.astype("int64"), lst.device)]
    return flat.reshape(lst.shape[:-1] + (4, 4))


def set_dc(a, value):
    """Copy of (..., N, N) blocks `a` with [..., 0, 0] replaced by value."""
    out = a.clone()
    out[..., 0, 0] = value
    return out
