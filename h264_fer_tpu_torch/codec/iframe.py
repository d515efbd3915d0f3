"""All-Intra16x16 frame encode on one device: modes → K1 recon → levels →
slice entropy.

The counterpart of h264_fer_tpu/codec/tpu_iframe.device_i16_frame_impl with
deblock=False (the in-loop filter is not ported yet). Every stage runs on
the device of the input planes and none reads a value back, so a caller
can queue many frames before it reads the first payload.
"""

from __future__ import annotations

import torch

from ..kernels.wavefront_i16 import i16_frame
from ..ops.device import const
from ..ops.intra import INTRA16_TO_CHROMA_MODE
from .entropy import i16_slice_entropy
from .intra_decision import intra16_mode_decision


def device_i16_frame(y, cb, cr, qp: int, qpc: int):
    """Encode one frame. y (H, W), cb/cr (H/2, W/2) uint8 tensors on one
    device. Returns dict: recon_y/recon_cb/recon_cr (uint8), nz_luma
    (nmb, 16) bool, and the i16_slice_entropy outputs (words, nbits,
    mb_type, cbp_luma, cbp_chroma, tc_luma, tc_chroma).
    """
    h, w = y.shape
    wmb, hmb = w // 16, h // 16
    m16, _ = intra16_mode_decision(y.to(torch.int32), qp)
    m16 = m16.to(torch.int32)
    cmode = const(INTRA16_TO_CHROMA_MODE, y.device)[m16.long()]
    ry, i16dc, ac, rcb, rcr, cdc, cac = i16_frame(y, cb, cr, m16, cmode, qp, qpc)
    ent = i16_slice_entropy(m16, cmode, i16dc, ac, cdc, cac, wmb=wmb, hmb=hmb)
    return {
        "recon_y": ry,
        "recon_cb": rcb,
        "recon_cr": rcr,
        "nz_luma": (ac != 0).any(dim=2) | (i16dc != 0).any(dim=1)[:, None],
        **ent,
    }
