"""Device P-frame encode: interpolated planes (K13) → ME maps (K2, K3) →
decision wavefront (K4) → MC (K5) → residual and recon (K12) → whole-slice
CAVLC (K10).

The counterpart of h264_fer_tpu/codec/tpu_pframe.py (device_p_frame_impl
and its bulk stages); the in-loop filter runs after it, in the session
encoder (codec/encoder.py). Everything that does not depend
on the in-frame MV-prediction chain is whole-frame batched work; the chain
itself runs in the K4 wavefront, which reads only the precomputed maps and
the planes. No stage reads a value back to the host, so a caller can queue
many frames before it reads the first payload.

The distortion metric follows the QP as the host encoder's does: SAD below
QP 36, SSD from 36, 2*SSD from 45, with lambda 1, 2, 3 (me_params).
"""

from __future__ import annotations

import torch

from ..kernels.mc import mc_bulk
from ..kernels.me_int import integer_score_map
from ..kernels.me_qpel import qpel_refine_maps
from ..kernels.residual_p import residual_recon
from ..kernels.wavefront_p import pframe_decide
from ..ops import transform
from ..ops.device import on_card
from ..ops.interp import interpolated_planes, pad_chroma
from ..ops.tiles import (blocks_mb, blocks_to_mbq, chroma_blocks, chroma_mb, from_mbs,
                         mb_blocks, to_mbs)
from .entropy import p_slice_entropy

I32 = torch.int32


def me_params(qp: int) -> tuple[int, int]:
    """(metric_id, lambda): 0 = SAD / 1, 1 = SSD / 2, 2 = 2*SSD / 3."""
    if qp >= 45:
        return 2, 3
    if qp >= 36:
        return 1, 2
    return 0, 1


def adaptive_maxdiff(src_y, wmb: int, hmb: int, cfg_maxdiff: int):
    """(nmb,) int32 per-MB MAXDIFF (moestimation.cpp:407-419): the mean
    absolute deviation from the MB mean, at least 3; or the configured
    constant when cfg_maxdiff != -1."""
    nmb = wmb * hmb
    if cfg_maxdiff != -1:
        return torch.full((nmb,), cfg_maxdiff, dtype=I32, device=src_y.device)
    mb = to_mbs(src_y.to(I32), 16).reshape(nmb, 256)
    mean = mb.sum(dim=1, dtype=I32) >> 8
    mad = (mb - mean[:, None]).abs().sum(dim=1, dtype=I32) >> 8
    return mad.clamp(min=3)


def _mbq_to_blocks(x, wmb: int, hmb: int):
    """Inverse of blocks_to_mbq."""
    tail = x.shape[2:]
    x = x.reshape(hmb, wmb, 2, 2, *tail).transpose(1, 2)
    return x.reshape(hmb * 2 * wmb * 2, *tail).contiguous()


def me_centres(best, prev_mv, wmb: int, hmb: int, window: int):
    """The two qpel refinement centres of every 8x8 block.

    best (nb,) each block's first least shift index in K2's map (raster
    block order; K2 writes it beside the map); prev_mv (nmb, 4, 2) the
    previous frame's final MVs. Returns (c1 (nb, 2), the pure-distortion
    integer argmin as a qpel MV; c2_blk (nb, 2) and c2 (nmb, 4, 2), prev_mv
    clamped to ±(lim - 3), lim = 4 ext - 4, so every window stays in the
    planes; q2ok (nmb, 4), whether the unclamped prev_mv was inside that
    range)."""
    S = 2 * window + 1
    lim = 4 * (window + 2) - 4
    k = best.to(I32)
    c1 = (torch.stack([k % S - window, k // S - window], dim=-1) * 4).to(I32)
    prev = prev_mv.to(I32)
    q2ok = (prev.abs() <= lim - 3).all(dim=-1)
    c2 = prev.clamp(-(lim - 3), lim - 3)
    return c1, _mbq_to_blocks(c2, wmb, hmb), c2, q2ok


def pframe_maps(src_y, planes, prev_mv, wmb: int, hmb: int, window: int,
                qp: int):
    """All bulk ME maps for the decision wavefront, in MB-quadrant layout.

    src_y (H, W); planes interpolated_planes(ref_y, window + 2); prev_mv
    (nmb, 4, 2), zeros after an IDR. Returns dict: int_map (nmb, 4, S^2),
    c1mv, c2mv (nmb, 4, 2), q1map, q2map (nmb, 4, 49), q2ok (nmb, 4),
    metric_id, lam, ext."""
    ext = window + 2
    metric_id, lam = me_params(qp)
    # K2: the map in MB-quadrant order and the argmin, one launch
    im, best = integer_score_map(src_y, planes[0], ext, window, metric_id, p_frame=True)
    c1, c2_blk, c2, q2ok = me_centres(best, prev_mv, wmb, hmb, window)
    q1, q2 = qpel_refine_maps(src_y, planes, c1, c2_blk, ext, metric_id)
    return {
        "int_map": im.view(wmb * hmb, 4, -1),
        "c1mv": blocks_to_mbq(c1, wmb, hmb),
        "q1map": blocks_to_mbq(q1, wmb, hmb),
        "c2mv": c2,
        "q2map": blocks_to_mbq(q2, wmb, hmb),
        "q2ok": q2ok,
        "metric_id": metric_id,
        "lam": lam,
        "ext": ext,
    }


def _mb_pixels(x, wmb: int, hmb: int, n: int):
    """(nmb,) per-MB values → (hmb * n, wmb * n) per-sample plane."""
    return x.reshape(hmb, wmb).repeat_interleave(n, 0).repeat_interleave(n, 1)


def pframe_residual_recon(src_y, src_cb, src_cr, pred_y, pred_cb, pred_cr,
                          skip, maxdiff, wmb: int, hmb: int, qp: int,
                          qpc: int, prefilter: bool):
    """Residual transform and quant plus reconstruction of a decided P frame
    or MB-row band (quantizationTransform.cpp:349-486,
    inttransform.cpp:133-321), with the MAXDIFF source prefilter
    (moestimation.cpp:570-584) when `prefilter`.

    Returns (levels dict: luma (nmb, 16, 16) Z-scan zig-zag lists, cdc
    (2, nmb, 4), cac (2, nmb, 4, 15); recon_y, recon_cb, recon_cr int32).
    Skipped MBs get zero levels and recon = pred. K12 for CUDA planes
    (sources uint8, predictions int32), the plain twin for CPU ones."""
    args = (src_y, src_cb, src_cr, pred_y, pred_cb, pred_cr, skip, maxdiff, wmb, hmb,
            qp, qpc, prefilter)
    if on_card(src_y):
        return residual_recon(*args)
    return pframe_residual_recon_plain(*args)


def pframe_residual_recon_plain(src_y, src_cb, src_cr, pred_y, pred_cb, pred_cr,
                                skip, maxdiff, wmb: int, hmb: int, qp: int,
                                qpc: int, prefilter: bool):
    """pframe_residual_recon in eager torch, on any device; planes of any
    integer dtype."""
    src_y, src_cb, src_cr = (p.to(I32) for p in (src_y, src_cb, src_cr))
    nmb = wmb * hmb
    skip_px = _mb_pixels(skip, wmb, hmb, 16)
    if prefilter:
        md_px = _mb_pixels(maxdiff, wmb, hmb, 16)
        src_y = torch.where(((src_y - pred_y).abs() < md_px) & ~skip_px,
                            pred_y, src_y)
        md_c, sk_c = md_px[::2, ::2], skip_px[::2, ::2]
        src_cb = torch.where(((src_cb - pred_cb).abs() <= md_c) & ~sk_c,
                             pred_cb, src_cb)
        src_cr = torch.where(((src_cr - pred_cr).abs() <= md_c) & ~sk_c,
                             pred_cr, src_cr)

    # luma: 16 Z-scan 4x4 blocks per MB, inter quant (no DC bypass)
    diff = mb_blocks(to_mbs(src_y - pred_y, 16))
    q = transform.quantize_residual(transform.forward_transform_4x4(diff), qp, False)
    luma = torch.where(skip[:, None, None], 0, transform.zigzag_scan(q))

    # chroma: 4 raster blocks per MB and plane, 2x2 DC Hadamard
    cdc, cac = [], []
    for src_c, pred_c in ((src_cb, pred_cb), (src_cr, pred_cr)):
        dcq = transform.quantize_residual(transform.forward_transform_4x4(
            chroma_blocks(to_mbs(src_c - pred_c, 8))), qpc, True)
        cdc.append(transform.forward_dc_chroma(
            dcq[:, :, 0, 0].reshape(nmb, 2, 2), qpc).reshape(nmb, 4))
        cac.append(transform.zigzag_scan(dcq)[:, :, 1:])
    cdc = torch.where(skip[None, :, None], 0, torch.stack(cdc))
    cac = torch.where(skip[None, :, None, None], 0, torch.stack(cac))

    res_y = transform.inverse_residual(transform.zigzag_unscan(luma), qp, False)
    recon_y = (pred_y + from_mbs(blocks_mb(res_y), hmb, wmb)).clamp(0, 255)
    recon_c = []
    for ci, pred_c in enumerate((pred_cb, pred_cr)):
        dcv = transform.inverse_dc_chroma(cdc[ci].reshape(nmb, 2, 2), qpc)
        full = torch.cat([dcv.reshape(nmb, 4, 1), cac[ci]], dim=-1)
        res = transform.inverse_residual(transform.zigzag_unscan(full), qpc, True)
        recon_c.append((pred_c + from_mbs(chroma_mb(res), hmb, wmb)).clamp(0, 255))
    levels = {"luma": luma, "cdc": cdc, "cac": cac}
    return levels, recon_y, recon_c[0], recon_c[1]


def device_p_frame(src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr, prev_mv,
                   window: int, qp: int, qpc: int, cfg_maxdiff: int,
                   prefilter: bool):
    """Encode one P frame on the device of its planes.

    Source and reference planes uint8 (H, W), (H/2, W/2); prev_mv
    (nmb, 4, 2) int32, the previous frame's final MVs (zeros after an IDR);
    window: the search range in full pel (window_size // 2). Returns dict:
    recon_y / recon_cb / recon_cr (uint8), skip, raw_type, mv, and the
    p_slice_entropy outputs (words, nbits, trail_bits, ...)."""
    h, w = src_y.shape
    wmb, hmb = w // 16, h // 16
    ext = window + 2
    ext_c = ext // 2 + 1
    planes = interpolated_planes(ref_y, ext)
    maps = pframe_maps(src_y, planes, prev_mv, wmb, hmb, window, qp)
    maxdiff = adaptive_maxdiff(src_y, wmb, hmb, cfg_maxdiff)
    dec = pframe_decide(
        src_y, planes, maps["int_map"], maps["c1mv"], maps["q1map"],
        maps["c2mv"], maps["q2map"], maps["q2ok"], maxdiff, wmb, hmb,
        window, ext, maps["metric_id"], maps["lam"])
    pred = mc_bulk(planes, pad_chroma(ref_cb, ext_c), pad_chroma(ref_cr, ext_c),
                   dec["mv"], ext, ext_c, wmb, hmb)
    levels, ry, rcb, rcr = pframe_residual_recon(
        src_y, src_cb, src_cr, *pred, dec["skip"], maxdiff, wmb, hmb, qp,
        qpc, prefilter)
    ent = p_slice_entropy(dec["skip"], dec["mb_type"], dec["mvd"],
                          levels["luma"], levels["cdc"], levels["cac"],
                          wmb=wmb, hmb=hmb)
    u8 = torch.uint8
    return {"recon_y": ry.to(u8), "recon_cb": rcb.to(u8), "recon_cr": rcr.to(u8),
            "skip": dec["skip"], "raw_type": dec["mb_type"], "mv": dec["mv"],
            **ent}
