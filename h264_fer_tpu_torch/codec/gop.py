"""Whole-GOP device encode: the IDR, then the chain of P frames.

The counterpart of h264_fer_tpu/codec/tpu_gop.device_gop_ippp_impl
(tpu_gop.py:34-144): frame 0 through the device I16 frame, every later
frame through the device P frame, chained by the codec's cross-frame state,
the reconstructed reference planes (a DPB of depth 1) and the previous
frame's final MVs (the temporal refinement centres). The reference's
lax.scan is a Python loop here; the state stays on the device and nothing
is read back, so a whole GOP is queued without a host sync, and
parallel/gop_device.GopIpppEncoder captures it as one CUDA graph per GOP
length and lane (codec/program.py).
"""

from __future__ import annotations

import torch

from .iframe import device_i16_frame
from .pframe import device_p_frame


def trailing_skip_drop(skip, nbits, trail_bits, hdr_bits: int, last_coded=None,
                       base: int = 0):
    """(nmb,) bool: the MBs of a P frame's trailing skip run that decoders
    never read (encoder._encode_slice). When everything after the last
    coded MB fits in the last byte of the RBSP, a decoder stops before the
    trailing mb_skip_run, and those MBs keep the previous frame's samples
    and MVs. hdr_bits: the bit count of the frame's slice header.

    For an MB-row band of the frame (the reference's band program,
    tile_p.py:192-205): skip the band's MBs, nbits and trail_bits the
    frame's totals over every band, last_coded the frame's last coded MB
    (-1: none; None: found in `skip`, the whole frame's) and base the index
    of the band's first MB in the frame."""
    nmb = skip.shape[0]
    idx = torch.arange(nmb, device=skip.device) + base
    if last_coded is None:
        last_coded = torch.where(~skip, idx, -1).amax()
    total = hdr_bits + nbits
    rbsp_bytes = (total + 8) >> 3  # with the rbsp stop bit
    drop = ((trail_bits > 0) & (last_coded >= 0)
            & (((total - trail_bits) >> 3) >= rbsp_bytes - 1))
    return (idx > last_coded) & drop


def restore_dropped(keep, ref, out):
    """(y, cb, cr, mv) of P frame `out` (device_p_frame's dict) with the MBs
    `keep` ((nmb,) bool, trailing_skip_drop's) taken from ref, the previous
    frame's (y, cb, cr, mv): what decoders hold after the frame."""
    ref_y, ref_cb, ref_cr, prev_mv = ref
    wmb = ref_y.shape[1] // 16
    hmb = keep.shape[0] // wmb
    keep_px = keep.reshape(hmb, 1, wmb, 1).expand(hmb, 16, wmb, 16).reshape(16 * hmb, 16 * wmb)
    keep_c = keep_px[::2, ::2]
    return (torch.where(keep_px, ref_y, out["recon_y"]),
            torch.where(keep_c, ref_cb, out["recon_cb"]),
            torch.where(keep_c, ref_cr, out["recon_cr"]),
            torch.where(keep[:, None, None], prev_mv, out["mv"]))


def next_reference(ref, out, hdr_bits: int):
    """The state the next P frame reads after P frame `out` (device_p_frame's
    dict): (ref_y, ref_cb, ref_cr, prev_mv), where ref is this frame's
    (ref_y, ref_cb, ref_cr, prev_mv); the MBs a decoder never reads
    (trailing_skip_drop) keep ref's samples and MVs."""
    keep = trailing_skip_drop(out["skip"], out["nbits"], out["trail_bits"], hdr_bits)
    return restore_dropped(keep, ref, out)


def device_gop_ippp(ys, cbs, crs, p_hdr_bits, window: int, qp: int, qpc: int,
                    cfg_maxdiff: int, prefilter: bool):
    """Encode one GOP on the device of its planes.

    ys / cbs / crs: sequences of uint8 planes, frame 0 the IDR; p_hdr_bits:
    the slice-header bit count of each P frame (host ints, GopIpppEncoder's
    precomputed headers). Returns dict: frames, one dict per frame (words,
    nbits, and recon: the frame's reference planes as decoders hold them,
    after the trailing-skip drop), and recon_y / recon_cb / recon_cr and
    mv, the final reference planes and MVs."""
    i_out = device_i16_frame(ys[0], cbs[0], crs[0], qp, qpc)
    nmb = i_out["mb_type"].shape[0]
    ref = (i_out["recon_y"], i_out["recon_cb"], i_out["recon_cr"],
           torch.zeros((nmb, 4, 2), dtype=torch.int32, device=ys[0].device))
    frames = [{"words": i_out["words"], "nbits": i_out["nbits"], "recon": ref[:3]}]
    for y, cb, cr, hdr_bits in zip(ys[1:], cbs[1:], crs[1:], p_hdr_bits):
        out = device_p_frame(y, cb, cr, *ref, window, qp, qpc, cfg_maxdiff,
                             prefilter)
        ref = next_reference(ref, out, int(hdr_bits))
        frames.append({"words": out["words"], "nbits": out["nbits"], "recon": ref[:3]})
    return {"frames": frames, "recon_y": ref[0], "recon_cb": ref[1],
            "recon_cr": ref[2], "mv": ref[3]}
