"""Forward transforms and quantisation of one macroblock, host side (numpy).

The host per-MB encoder (codec/encoder_host.py) codes MB by MB, and block
by block in Intra_4x4, as the reference does; a PyTorch call per 4x4 block
costs more than the block's arithmetic. These are the numpy paths of
h264_fer_tpu/ops/transform.py's forward half (forward_transform_4x4, the
DC Hadamards, quantize_residual, quantize_dc_luma / _chroma,
forward_residual, forward_dc_luma / _chroma, zigzag_scan), int32 with
arithmetic shifts; ops/recon_host.py holds the inverse half and the intra
predictors. tests/test_torch_host_encoder.py holds every function equal
to the JAX package's on random input.
"""

from __future__ import annotations

import numpy as np

from .tables import LEVEL_QUANTIZE, ZIGZAG_FLAT
from .transform import _FWD_W, _HAD2, _HAD4

_W = np.array(_FWD_W, np.int32)
_H4 = np.array(_HAD4, np.int32)
_H2 = np.array(_HAD2, np.int32)


def forward_transform_4x4(r: np.ndarray) -> np.ndarray:
    """Forward scaled 4x4 integer DCT of (..., 4, 4) int32 residuals
    (forwardTransform4x4, quantizationTransform.cpp:41-100)."""
    h = np.where(r == 0, 0, (r << 6) - 32).astype(np.int32)
    f = (_W @ h + 512) >> 10
    return (f @ _W.T + 512) >> 10


def forward_hadamard_dc_luma(f: np.ndarray) -> np.ndarray:
    """(H·f·H^T + 8) >> 4 (forwardTransformDCLumaIntra)."""
    return (_H4 @ f @ _H4.T + 8) >> 4


def forward_hadamard_dc_chroma(f: np.ndarray) -> np.ndarray:
    """(H2·f·H2 + 2) >> 2 (forwardTransformDCChroma)."""
    return (_H2 @ f @ _H2 + 2) >> 2


def quantize_residual(d: np.ndarray, qp: int, dc_bypass: bool) -> np.ndarray:
    """Quantise transformed (..., 4, 4) blocks (quantisationResidualBlock,
    quantizationTransform.cpp:183-223). With `dc_bypass` the DC passes
    through unquantised for the dedicated DC path."""
    lq = LEVEL_QUANTIZE[qp % 6]
    if qp < 24:
        qbits = 4 - qp // 6
        adjust = 1 << (3 - qp // 6)
        c = (((d << qbits) - adjust) * lq + 16384) >> 15
    else:
        c = ((d >> (qp // 6 - 4)) * lq + 16384) >> 15
    if dc_bypass:
        c = c.copy()
        c[..., 0, 0] = d[..., 0, 0]
    return c


def quantize_dc_luma(f: np.ndarray, qp: int) -> np.ndarray:
    """quantisationLumaDCIntra, quantizationTransform.cpp:227-260."""
    lq = int(LEVEL_QUANTIZE[qp % 6, 0, 0])
    if qp >= 36:
        return ((f >> (qp // 6 - 6)) * lq + 16384) >> 15
    adjust = 1 << (5 - qp // 6)
    return (((f << (6 - qp // 6)) - adjust) * lq + 16384) >> 15


def quantize_dc_chroma(f: np.ndarray, qp: int) -> np.ndarray:
    """quantisationChromaDC, quantizationTransform.cpp:264-282."""
    lq = int(LEVEL_QUANTIZE[qp % 6, 0, 0])
    return (((f << 5) >> (qp // 6)) * lq + 16384) >> 15


def forward_residual(r: np.ndarray, qp: int, dc_bypass: bool) -> np.ndarray:
    """Forward transform and quantise (forwardResidual)."""
    return quantize_residual(forward_transform_4x4(r), qp, dc_bypass)


def forward_dc_luma(dc: np.ndarray, qp: int) -> np.ndarray:
    """forwardDCLumaIntra, quantizationTransform.cpp:293-300."""
    return quantize_dc_luma(forward_hadamard_dc_luma(dc), qp)


def forward_dc_chroma(dc: np.ndarray, qp: int) -> np.ndarray:
    """forwardDCChroma, quantizationTransform.cpp:302-308."""
    return quantize_dc_chroma(forward_hadamard_dc_chroma(dc), qp)


def zigzag_scan(c: np.ndarray) -> np.ndarray:
    """(..., 4, 4) blocks → (..., 16) zig-zag lists (transformScan)."""
    return c.reshape(c.shape[:-2] + (16,))[..., ZIGZAG_FLAT]
