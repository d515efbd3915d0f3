"""Whole-slice CAVLC for an all-Intra16x16 frame (torch).

The counterpart of h264_fer_tpu/codec/tpu_entropy.i16_slice_entropy_impl
(reference per-MB writer rbsp_encoding.cpp:175-305 + residual.cpp:374-666):
in an all-I16 frame every macroblock_layer symbol is a function of the
finished level arrays, and the nC context needs only the final TotalCoeff
of the left and top MBs, known in bulk. So no wavefront is needed: the
symbols of all MBs are computed at once (ops/cavlc_bulk.py) and packed
into the slice payload on the device.
"""

from __future__ import annotations

import torch

from ..ops.cavlc_bulk import block_symbols_bulk, finalize_symbols, nc_to_ctx, pack_symbols, ue_code
from ..ops.tables import INTRA4X4_SCAN_ORDER_XY, RASTER_TO_LUMA_BLOCK

I32 = torch.int32

# Z-scan luma block geometry (copied from h264_fer_tpu/codec/decoder.py:77-104)
_BLK_XY = INTRA4X4_SCAN_ORDER_XY  # (16, 2): x, y pixel offsets
_RASTER_TO_Z = RASTER_TO_LUMA_BLOCK  # raster index -> Z index


def _z_of_raster(bx: int, by: int) -> int:
    return int(_RASTER_TO_Z[by * 4 + bx])


def _luma_blk_neighbors(blk: int):
    """(A_same_mb, A_blk, B_same_mb, B_blk) for Z-scan block `blk`
    (reference subMBNeighbours + derivation, residual.cpp:251-294)."""
    bx = int(_BLK_XY[blk, 0]) // 4
    by = int(_BLK_XY[blk, 1]) // 4
    a_same = bx > 0
    a_blk = _z_of_raster((bx - 1) % 4, by)
    b_same = by > 0
    b_blk = _z_of_raster(bx, (by - 1) % 4)
    return a_same, a_blk, b_same, b_blk


def _chroma_blk_neighbors(blk: int):
    bx, by = blk % 2, blk // 2
    a_same = bx > 0
    a_blk = by * 2 + (bx - 1) % 2
    b_same = by > 0
    b_blk = ((by - 1) % 2) * 2 + bx
    return a_same, a_blk, b_same, b_blk


_LUMA_NBR = [_luma_blk_neighbors(b) for b in range(16)]
_CHROMA_NBR = [_chroma_blk_neighbors(b) for b in range(4)]


def _shift_left_top(x, wmb: int, dim: int):
    """The left-MB and top-MB copies of per-MB `x` along `dim` (raster MB
    order); values at the frame edge are don't-cares, masked by the caller."""
    left = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, x.shape[dim] - 1)], dim)
    top = torch.cat([x.narrow(dim, 0, wmb),
                     x.narrow(dim, 0, x.shape[dim] - wmb)], dim)
    return left, top


def _nc(a_ok, b_ok, nA, nB):
    return torch.where(a_ok & b_ok, (nA + nB + 1) >> 1,
                       torch.where(a_ok, nA, torch.where(b_ok, nB, 0)))


def _nc_luma_grid(tc, cbp, wmb: int, hmb: int):
    """(nmb, 16) per-block luma nC (residual.cpp:251-294 derivation with the
    allNeighbouringZero CBP gating); tc (nmb, 16), cbp (nmb,)."""
    nmb = wmb * hmb
    mb = torch.arange(nmb, device=tc.device)
    left_edge = mb % wmb == 0
    top_edge = mb < wmb
    always = torch.ones(nmb, dtype=torch.bool, device=tc.device)
    tc_L, tc_T = _shift_left_top(tc, wmb, 0)
    cbp_L, cbp_T = _shift_left_top(cbp, wmb, 0)
    cols = []
    for a_same, a_blk, b_same, b_blk in _LUMA_NBR:
        tca, cbpa = (tc, cbp) if a_same else (tc_L, cbp_L)
        tcb, cbpb = (tc, cbp) if b_same else (tc_T, cbp_T)
        nA = torch.where((cbpa >> (a_blk // 4)) & 1 != 0, tca[:, a_blk], 0)
        nB = torch.where((cbpb >> (b_blk // 4)) & 1 != 0, tcb[:, b_blk], 0)
        a_ok = always if a_same else ~left_edge
        b_ok = always if b_same else ~top_edge
        cols.append(_nc(a_ok, b_ok, nA, nB))
    return torch.stack(cols, dim=-1)


def _nc_chroma_grid(tc_c, cbp_c, wmb: int, hmb: int):
    """(2, nmb, 4) chroma AC nC (cbp_chroma & 2 gating)."""
    nmb = wmb * hmb
    mb = torch.arange(nmb, device=tc_c.device)
    left_edge = mb % wmb == 0
    top_edge = mb < wmb
    always = torch.ones(nmb, dtype=torch.bool, device=tc_c.device)
    tc_L, tc_T = _shift_left_top(tc_c, wmb, 1)
    cbp_L, cbp_T = _shift_left_top(cbp_c, wmb, 0)
    cols = []
    for a_same, a_blk, b_same, b_blk in _CHROMA_NBR:
        tca, cbpa = (tc_c, cbp_c) if a_same else (tc_L, cbp_L)
        tcb, cbpb = (tc_c, cbp_c) if b_same else (tc_T, cbp_T)
        nA = torch.where((cbpa & 2) != 0, tca[:, :, a_blk], 0)
        nB = torch.where((cbpb & 2) != 0, tcb[:, :, b_blk], 0)
        a_ok = always if a_same else ~left_edge
        b_ok = always if b_same else ~top_edge
        cols.append(_nc(a_ok[None], b_ok[None], nA, nB))
    return torch.stack(cols, dim=-1)


def i16_slice_entropy(mode16, cmode, i16dc, i16ac, cdc, cac,
                      wmb: int, hmb: int):
    """Whole-slice macroblock_layer bits of an all-I16 frame.

    mode16/cmode (nmb,), i16dc (nmb, 16), i16ac (nmb, 16, 15), cdc
    (2, nmb, 4), cac (2, nmb, 4, 15), int32. Returns dict: words (int64,
    MSB of words[0] = first payload bit), nbits (0-d int64), mb_type,
    cbp_luma, cbp_chroma (nmb,), tc_luma (nmb, 16), tc_chroma (2, nmb, 4).
    """
    nmb = wmb * hmb
    # CBP (setCodedBlockPattern, rbsp_encoding.cpp:21-105)
    cbp_l = torch.where(i16ac.reshape(nmb, -1).any(dim=-1), 15, 0).to(I32)
    has_cdc = cdc.reshape(2, nmb, -1).ne(0).any(dim=-1).any(dim=0)
    has_cac = cac.reshape(2, nmb, -1).ne(0).any(dim=-1).any(dim=0)
    cbp_c = torch.where(has_cac, 2, torch.where(has_cdc, 1, 0)).to(I32)
    mb_type = (1 + mode16 + 4 * cbp_c + torch.where(cbp_l == 15, 12, 0)).to(I32)

    dc_blk = block_symbols_bulk(i16dc, 16)  # (nmb, ·)
    ac_blk = block_symbols_bulk(i16ac, 15)  # (nmb, 16, ·)
    cdc_blk = block_symbols_bulk(cdc, 4)  # (2, nmb, ·)
    cac_blk = block_symbols_bulk(cac, 15)  # (2, nmb, 4, ·)

    # final TC state: the DC block's tc at block 0 when the AC blocks are
    # not coded, zeros elsewhere
    dc_only = torch.zeros((nmb, 16), dtype=I32, device=i16dc.device)
    dc_only[:, 0] = dc_blk["tc"]
    tc_luma = torch.where((cbp_l == 15)[:, None], ac_blk["tc"], dc_only)
    tc_chroma = torch.where((cbp_c == 2)[None, :, None], cac_blk["tc"], 0).to(I32)

    nc_l = _nc_luma_grid(tc_luma, cbp_l, wmb, hmb)
    nc_c = _nc_chroma_grid(tc_chroma, cbp_c, wmb, hmb)
    # coeff_token contexts; the DC block uses the nC of luma block 0
    dc_vals, dc_lens = finalize_symbols(dc_blk, nc_to_ctx(nc_l[:, 0]))
    ac_vals, ac_lens = finalize_symbols(ac_blk, nc_to_ctx(nc_l))
    cdc_vals, cdc_lens = finalize_symbols(
        cdc_blk, torch.full((2, nmb), 4, dtype=I32, device=cdc.device))
    cac_vals, cac_lens = finalize_symbols(cac_blk, nc_to_ctx(nc_c))

    ac_lens = torch.where((cbp_l == 15)[:, None, None], ac_lens, 0)
    cdc_lens = torch.where((cbp_c > 0)[None, :, None], cdc_lens, 0)
    cac_lens = torch.where((cbp_c == 2)[None, :, None, None], cac_lens, 0)

    # header: ue(mb_type), ue(chroma mode), se(0) mb_qp_delta (one '1' bit)
    h0v, h0l = ue_code(mb_type)
    h1v, h1l = ue_code(cmode)
    one = torch.ones(nmb, dtype=I32, device=mode16.device)
    # per-MB stream in macroblock_layer order:
    # header, I16DC, 16 x AC, 2 x chroma DC, 2 x 4 chroma AC
    vals = torch.cat([
        torch.stack([h0v, h1v, one], dim=-1).to(I32), dc_vals,
        ac_vals.reshape(nmb, -1),
        cdc_vals.transpose(0, 1).reshape(nmb, -1),
        cac_vals.transpose(0, 1).reshape(nmb, -1),
    ], dim=-1)
    lens = torch.cat([
        torch.stack([h0l, h1l, one], dim=-1).to(I32), dc_lens,
        ac_lens.reshape(nmb, -1),
        cdc_lens.transpose(0, 1).reshape(nmb, -1),
        cac_lens.transpose(0, 1).reshape(nmb, -1),
    ], dim=-1)
    words, nbits = pack_symbols(vals.reshape(-1), lens.reshape(-1))
    return {
        "words": words,
        "nbits": nbits,
        "mb_type": mb_type,
        "cbp_luma": cbp_l,
        "cbp_chroma": cbp_c,
        "tc_luma": tc_luma,
        "tc_chroma": tc_chroma,
    }
