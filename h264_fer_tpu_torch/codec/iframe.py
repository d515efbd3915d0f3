"""I-frame encode on one device: all-Intra16x16 (modes → K1t recon and
levels → slice entropy) and mixed I4x4/I16 (modes → K7 chroma → K6
arbitration → slice entropy), each optionally followed by the in-loop
filter (K8) on its reconstruction.

The counterparts of h264_fer_tpu/codec/tpu_iframe.device_i16_frame_impl
and device_mixed_frame_impl. Every stage runs on the device of the input
planes and none reads a value back, so a caller can queue many frames
before it reads the first payload.
"""

from __future__ import annotations

import torch

from ..kernels.deblock import deblock_frame
from ..kernels.wavefront_i16 import chroma_frame, i16_frame
from ..kernels.wavefront_mixed import mixed_luma
from ..ops.device import const
from ..ops.intra import INTRA16_TO_CHROMA_MODE
from .entropy import chroma_setup, i16_slice_entropy, mixed_slice_entropy
from .intra_decision import intra16_mode_decision, intra_mode_decision


def deblock_intra(out, qp: int, qpc: int):
    """The frame dict `out` with its recon planes filtered as an all-intra
    frame (tpu_iframe._deblock_intra): every MB intra, the frame's nz_luma,
    zero MVs. Intra prediction read the unfiltered samples, so the filter
    runs once on the finished frame."""
    nmb = out["nz_luma"].shape[0]
    dev = out["nz_luma"].device
    planes = deblock_frame(out["recon_y"], out["recon_cb"], out["recon_cr"],
                           torch.ones(nmb, dtype=torch.bool, device=dev),
                           out["nz_luma"],
                           torch.zeros((nmb, 4, 2), dtype=torch.int32, device=dev),
                           qp, qpc)
    return {**out, **dict(zip(("recon_y", "recon_cb", "recon_cr"), planes))}


def device_i16_frame(y, cb, cr, qp: int, qpc: int, deblock: bool = False):
    """Encode one frame. y (H, W), cb/cr (H/2, W/2) uint8 tensors on one
    device. Returns dict: recon_y/recon_cb/recon_cr (uint8, filtered when
    `deblock`), nz_luma (nmb, 16) bool, and the i16_slice_entropy outputs
    (words, nbits, mb_type, cbp_luma, cbp_chroma, tc_luma, tc_chroma). The
    payload does not depend on `deblock`: the caller signals the filter in
    its PPS and slice headers."""
    h, w = y.shape
    wmb, hmb = w // 16, h // 16
    m16, _ = intra16_mode_decision(y, qp)
    cmode = const(INTRA16_TO_CHROMA_MODE, y.device)[m16.long()]
    ry, i16dc, ac, rcb, rcr, cdc, cac = i16_frame(y, cb, cr, m16, cmode, qp, qpc)
    ent = i16_slice_entropy(m16, cmode, i16dc, ac, cdc, cac, wmb=wmb, hmb=hmb)
    out = {
        "recon_y": ry,
        "recon_cb": rcb,
        "recon_cr": rcr,
        "nz_luma": (ac != 0).any(dim=2) | (i16dc != 0).any(dim=1)[:, None],
        **ent,
    }
    return deblock_intra(out, qp, qpc) if deblock else out


def device_mixed_frame(y, cb, cr, qp: int, qpc: int, deblock: bool = False):
    """Encode one frame with the exact I4x4-vs-I16 choice per MB. y (H, W),
    cb/cr (H/2, W/2) uint8 tensors on one device. Returns dict:
    recon_y/recon_cb/recon_cr (uint8, filtered when `deblock`), choice4
    (nmb,) bool, i4x4_mode (nmb, 16), and the mixed_slice_entropy outputs
    (words, nbits, mb_type, cbp_luma, cbp_chroma, tc_luma, tc_chroma,
    nz_luma)."""
    h, w = y.shape
    wmb, hmb = w // 16, h // 16
    dec = intra_mode_decision(y, qp)
    m16, mode4 = dec["mode16"], dec["mode4"]
    cmode = const(INTRA16_TO_CHROMA_MODE, y.device)[m16.long()]
    rcb, rcr, cdc, cac = chroma_frame(cb, cr, cmode, qpc)
    ch = chroma_setup(cdc, cac, wmb, hmb)
    mx = mixed_luma(y, m16, mode4, cmode, ch["cbp_chroma"], ch["bits"], qp)
    ent = mixed_slice_entropy(
        mx["choice4"], m16, cmode, mx["i16dc"], mx["i16ac"], mx["lv4"],
        mx["prev_flags"], mx["rem_modes"], mx["cbp_luma"], mx["tc_luma"],
        cdc, cac, wmb=wmb, hmb=hmb, chroma=ch)
    out = {
        "recon_y": mx["recon_y"],
        "recon_cb": rcb,
        "recon_cr": rcr,
        "choice4": mx["choice4"],
        "i4x4_mode": mode4,
        **ent,
    }
    return deblock_intra(out, qp, qpc) if deblock else out
