"""Whole-slice CAVLC for all-Intra16x16, mixed I4x4/I16 and P frames (torch).

The counterpart of h264_fer_tpu/codec/tpu_entropy.py: i16_slice_entropy_impl,
mixed_slice_entropy_impl, p_slice_entropy_impl and chroma_setup (reference per-MB writer
rbsp_encoding.cpp:175-305 + residual.cpp:374-666). Once a frame's levels
and per-MB decisions are final, every macroblock_layer symbol is a function
of them, and the nC context needs only the final TotalCoeff of the left and
top MBs, known in bulk. So no wavefront is needed: the symbols of all MBs
are computed at once (ops/cavlc_bulk.py) and packed into the slice payload
on the device.

The public functions i16_slice_entropy, mixed_slice_entropy,
p_slice_entropy and chroma_setup dispatch on the device of their tensors:
a CPU tensor goes to the plain twin (the *_plain functions below, the
op-for-op translation the CPU tests hold to JAX), a CUDA tensor to the hand
kernel K10 (kernels/cavlc_slice.py, csrc/cavlc_slice.cu), which launches
or raises; any other device raises.

For an MB-row band of a frame (parallel/tile.py, parallel/tile_p.py),
chroma_setup and the three slice entropies take `top_ctx`, the final
TotalCoeff and CBP state of the MB row above the band, which its first row
reads in its nC contexts (None: the band's top is the frame's); the intra
ones `valid`, which gates the padded MBs of an uneven band to zero bits,
and p_slice_entropy `run_lead`, the mb_skip_run chain across bands.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import cavlc_slice
from ..ops.cavlc_bulk import (
    block_symbols_bulk,
    finalize_symbols,
    nc_to_ctx,
    pack_symbols,
    se_code,
    ue_code,
)
from ..ops.device import const, on_card
from ..ops.tables import CBP_TO_CODENUM_INTER, CBP_TO_CODENUM_INTRA, CHROMA_NBR, LUMA_NBR

I32 = torch.int32

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


def _top_halo(x_T, halo, wmb: int, dim: int):
    """x_T, the top-MB copy of a per-MB array along `dim`, with its first MB
    row (the don't-cares above the first row) replaced by `halo`."""
    return torch.cat([halo, x_T.narrow(dim, wmb, x_T.shape[dim] - wmb)], dim)


def _nc_luma_grid(tc, cbp, wmb: int, hmb: int, top=None):
    """(nmb, 16) per-block luma nC (residual.cpp:251-294 derivation with the
    allNeighbouringZero CBP gating); tc (nmb, 16), cbp (nmb,). top: None,
    or (tc (wmb, 16), cbp (wmb,)) of the MB row above the first row."""
    nmb = wmb * hmb
    mb = torch.arange(nmb, device=tc.device)
    left_edge = mb % wmb == 0
    top_edge = mb < wmb
    always = torch.ones(nmb, dtype=torch.bool, device=tc.device)
    tc_L, tc_T = _shift_left_top(tc, wmb, 0)
    cbp_L, cbp_T = _shift_left_top(cbp, wmb, 0)
    if top is not None:
        tc_T, cbp_T = _top_halo(tc_T, top[0], wmb, 0), _top_halo(cbp_T, top[1], wmb, 0)
        top_edge = ~always  # the first row's top neighbours are the halo's
    cols = []
    for a_same, a_blk, b_same, b_blk in LUMA_NBR:
        tca, cbpa = (tc, cbp) if a_same else (tc_L, cbp_L)
        tcb, cbpb = (tc, cbp) if b_same else (tc_T, cbp_T)
        nA = torch.where((cbpa >> (a_blk // 4)) & 1 != 0, tca[:, a_blk], 0)
        nB = torch.where((cbpb >> (b_blk // 4)) & 1 != 0, tcb[:, b_blk], 0)
        a_ok = always if a_same else ~left_edge
        b_ok = always if b_same else ~top_edge
        cols.append(_nc(a_ok, b_ok, nA, nB))
    return torch.stack(cols, dim=-1)


def _nc_chroma_grid(tc_c, cbp_c, wmb: int, hmb: int, top=None):
    """(2, nmb, 4) chroma AC nC (cbp_chroma & 2 gating). top: None, or
    (tc_c (2, wmb, 4), cbp_c (wmb,)) of the MB row above the first row."""
    nmb = wmb * hmb
    mb = torch.arange(nmb, device=tc_c.device)
    left_edge = mb % wmb == 0
    top_edge = mb < wmb
    always = torch.ones(nmb, dtype=torch.bool, device=tc_c.device)
    tc_L, tc_T = _shift_left_top(tc_c, wmb, 1)
    cbp_L, cbp_T = _shift_left_top(cbp_c, wmb, 0)
    if top is not None:
        tc_T, cbp_T = _top_halo(tc_T, top[0], wmb, 1), _top_halo(cbp_T, top[1], wmb, 0)
        top_edge = ~always  # the first row's top neighbours are the halo's
    cols = []
    for a_same, a_blk, b_same, b_blk in CHROMA_NBR:
        tca, cbpa = (tc_c, cbp_c) if a_same else (tc_L, cbp_L)
        tcb, cbpb = (tc_c, cbp_c) if b_same else (tc_T, cbp_T)
        nA = torch.where((cbpa & 2) != 0, tca[:, :, a_blk], 0)
        nB = torch.where((cbpb & 2) != 0, tcb[:, :, b_blk], 0)
        a_ok = always if a_same else ~left_edge
        b_ok = always if b_same else ~top_edge
        cols.append(_nc(a_ok[None], b_ok[None], nA, nB))
    return torch.stack(cols, dim=-1)


def chroma_setup_plain(cdc, cac, wmb: int, hmb: int, top_ctx=None):
    """Chroma side of a slice's entropy, the same for every MB type:
    cbp_chroma (nmb,), the final chroma TC state tc_chroma (2, nmb, 4), each
    MB's chroma residual bits (nmb,), and the gated symbol streams cdc_vals
    / cdc_lens (2, nmb, ·) and cac_vals / cac_lens (2, nmb, 4, ·). cdc
    (2, nmb, 4), cac (2, nmb, 4, 15) int32. top_ctx: None, or the chroma
    state (tc_chroma (2, wmb, 4), cbp_chroma (wmb,)) of the MB row above."""
    nmb = wmb * hmb
    has_cdc = cdc.reshape(2, nmb, -1).ne(0).any(dim=-1).any(dim=0)
    has_cac = cac.reshape(2, nmb, -1).ne(0).any(dim=-1).any(dim=0)
    cbp_c = torch.where(has_cac, 2, torch.where(has_cdc, 1, 0)).to(I32)
    cac_blk = block_symbols_bulk(cac, 15)  # (2, nmb, 4, ·)
    tc_chroma = torch.where((cbp_c == 2)[None, :, None], cac_blk["tc"], 0).to(I32)
    return {"cbp_chroma": cbp_c, "tc_chroma": tc_chroma,
            **_chroma_streams(cdc, cac_blk, cbp_c, tc_chroma, wmb, hmb, top_ctx)}


def _chroma_streams(cdc, cac_blk, cbp_c, tc_chroma, wmb: int, hmb: int, top_ctx):
    """The chroma setup's bits (nmb,) and gated symbol streams (cdc_vals,
    cdc_lens, cac_vals, cac_lens) for the chroma state cbp_c (nmb,),
    tc_chroma (2, nmb, 4); cac_blk: block_symbols_bulk of cac."""
    nmb = wmb * hmb
    cdc_blk = block_symbols_bulk(cdc, 4)  # (2, nmb, ·)
    nc_c = _nc_chroma_grid(tc_chroma, cbp_c, wmb, hmb, top_ctx)
    cdc_vals, cdc_lens = finalize_symbols(
        cdc_blk, torch.full((2, nmb), 4, dtype=I32, device=cdc.device))
    cac_vals, cac_lens = finalize_symbols(cac_blk, nc_to_ctx(nc_c))
    cdc_lens = torch.where((cbp_c > 0)[None, :, None], cdc_lens, 0)
    cac_lens = torch.where((cbp_c == 2)[None, :, None, None], cac_lens, 0)
    return {
        "bits": (cdc_lens.sum(dim=(0, 2), dtype=I32)
                 + cac_lens.sum(dim=(0, 2, 3), dtype=I32)),
        "cdc_vals": cdc_vals,
        "cdc_lens": cdc_lens,
        "cac_vals": cac_vals,
        "cac_lens": cac_lens,
    }


def _chroma_symbols(ch, nmb: int):
    """Per-MB (vals, lens) of chroma_setup's streams in macroblock_layer
    order: 2 x chroma DC, then 2 x 4 chroma AC."""
    return tuple(torch.cat([ch[f"cdc_{k}"].transpose(0, 1).reshape(nmb, -1),
                            ch[f"cac_{k}"].transpose(0, 1).reshape(nmb, -1)],
                           dim=-1) for k in ("vals", "lens"))


def _pack(vals, lens, valid):
    """pack_symbols of per-MB (nmb, ·) symbol streams, the MBs where `valid`
    (nmb,) bool is False written with no bits (None: every MB)."""
    if valid is not None:
        lens = torch.where(valid[:, None], lens, 0)
    return pack_symbols(vals.reshape(-1), lens.reshape(-1).to(I32))


def i16_slice_entropy_plain(mode16, cmode, i16dc, i16ac, cdc, cac,
                            wmb: int, hmb: int, top_ctx=None, valid=None):
    """Whole-slice macroblock_layer bits of an all-I16 frame.

    mode16/cmode (nmb,), i16dc (nmb, 16), i16ac (nmb, 16, 15), cdc
    (2, nmb, 4), cac (2, nmb, 4, 15), int32. Returns dict: words (int64,
    MSB of words[0] = first payload bit), nbits (0-d int64), mb_type,
    cbp_luma, cbp_chroma (nmb,), tc_luma (nmb, 16), tc_chroma (2, nmb, 4).
    For an MB-row band: top_ctx, None or the final state (tc_luma (wmb, 16),
    cbp_luma (wmb,), tc_chroma (2, wmb, 4), cbp_chroma (wmb,)) of the MB row
    above it, as this function returns it for that row; valid, None or
    (nmb,) bool, False at the padded MBs of an uneven band, which are
    written with no bits.
    """
    nmb = wmb * hmb
    # CBP (setCodedBlockPattern, rbsp_encoding.cpp:21-105)
    cbp_l = torch.where(i16ac.reshape(nmb, -1).any(dim=-1), 15, 0).to(I32)
    ch = chroma_setup_plain(cdc, cac, wmb, hmb, None if top_ctx is None else top_ctx[2:])
    cbp_c = ch["cbp_chroma"]
    mb_type = (1 + mode16 + 4 * cbp_c + torch.where(cbp_l == 15, 12, 0)).to(I32)

    dc_blk = block_symbols_bulk(i16dc, 16)  # (nmb, ·)
    ac_blk = block_symbols_bulk(i16ac, 15)  # (nmb, 16, ·)

    # final TC state: the DC block's tc at block 0 when the AC blocks are
    # not coded, zeros elsewhere
    dc_only = torch.zeros((nmb, 16), dtype=I32, device=i16dc.device)
    dc_only[:, 0] = dc_blk["tc"]
    tc_luma = torch.where((cbp_l == 15)[:, None], ac_blk["tc"], dc_only)

    nc_l = _nc_luma_grid(tc_luma, cbp_l, wmb, hmb, None if top_ctx is None else top_ctx[:2])
    # coeff_token contexts; the DC block uses the nC of luma block 0
    dc_vals, dc_lens = finalize_symbols(dc_blk, nc_to_ctx(nc_l[:, 0]))
    ac_vals, ac_lens = finalize_symbols(ac_blk, nc_to_ctx(nc_l))
    ac_lens = torch.where((cbp_l == 15)[:, None, None], ac_lens, 0)
    c_vals, c_lens = _chroma_symbols(ch, nmb)

    # header: ue(mb_type), ue(chroma mode), se(0) mb_qp_delta (one '1' bit)
    h0v, h0l = ue_code(mb_type)
    h1v, h1l = ue_code(cmode)
    one = torch.ones(nmb, dtype=I32, device=mode16.device)
    # per-MB stream in macroblock_layer order:
    # header, I16DC, 16 x AC, 2 x chroma DC, 2 x 4 chroma AC
    vals = torch.cat([torch.stack([h0v, h1v, one], dim=-1).to(I32), dc_vals,
                      ac_vals.reshape(nmb, -1), c_vals], dim=-1)
    lens = torch.cat([torch.stack([h0l, h1l, one], dim=-1).to(I32), dc_lens,
                      ac_lens.reshape(nmb, -1), c_lens], dim=-1)
    words, nbits = _pack(vals, lens, valid)
    return {
        "words": words,
        "nbits": nbits,
        "mb_type": mb_type,
        "cbp_luma": cbp_l,
        "cbp_chroma": cbp_c,
        "tc_luma": tc_luma,
        "tc_chroma": ch["tc_chroma"],
    }


def mixed_slice_entropy_plain(choice4, mode16, cmode, i16dc, i16ac, lv4, prev_flags,
                              rem_modes, cbp_luma, tc_luma, cdc, cac,
                              wmb: int, hmb: int, top_ctx=None, valid=None, *, chroma=None):
    """Whole-slice macroblock_layer bits of a mixed I4x4/I16 frame.

    choice4 (nmb,) bool, prev_flags (nmb, 16) bool, rem_modes (nmb, 16),
    cbp_luma (nmb,) and tc_luma (nmb, 16) come from the arbitration
    wavefront (K6); the level arrays hold both candidates' levels, and
    choice4 selects the winner's. mode16/cmode (nmb,), cdc (2, nmb, 4),
    cac (2, nmb, 4, 15), int32. chroma (required; ValueError when None):
    the frame's chroma setup (chroma_setup of the same cdc, cac and
    top_ctx, computed once a frame), whose cbp_chroma and tc_chroma this
    reads; only the chroma symbols are computed here. Returns the dict of
    i16_slice_entropy plus nz_luma (nmb, 16) bool, cbp_chroma and tc_chroma
    the setup's. top_ctx, valid: as i16_slice_entropy's.
    """
    nmb = wmb * hmb
    dev = choice4.device
    if chroma is None:
        raise ValueError("chroma: the mixed slice entropy takes the slice's chroma setup "
                         "(chroma_setup of the same cdc, cac and top_ctx)")
    cbp_c, tc_c = chroma["cbp_chroma"], chroma["tc_chroma"]
    ch = _chroma_streams(cdc, block_symbols_bulk(cac, 15), cbp_c, tc_c, wmb, hmb,
                         None if top_ctx is None else top_ctx[2:])
    mb_type = torch.where(choice4, 0, 1 + mode16 + 4 * cbp_c
                          + torch.where(cbp_luma == 15, 12, 0)).to(I32)

    # luma blocks: both candidates' symbols, the winner's selected per MB
    dc_blk = block_symbols_bulk(i16dc, 16)
    ac_blk = block_symbols_bulk(i16ac, 15)
    l4_blk = block_symbols_bulk(lv4, 16)
    nc_l = _nc_luma_grid(tc_luma, cbp_luma, wmb, hmb,
                         None if top_ctx is None else top_ctx[:2])
    dc_vals, dc_lens = finalize_symbols(dc_blk, nc_to_ctx(nc_l[:, 0]))
    ac_vals, ac_lens = finalize_symbols(ac_blk, nc_to_ctx(nc_l))
    l4_vals, l4_lens = finalize_symbols(l4_blk, nc_to_ctx(nc_l))
    dc_lens = torch.where(choice4[:, None], 0, dc_lens)
    # for an I16 winner cbp_luma is 0 or 15, so this is its AC gate
    quad_gate = ((cbp_luma[:, None] >> (torch.arange(16, device=dev) // 4)) & 1) != 0
    ac_lens = torch.where((~choice4[:, None] & quad_gate)[..., None], ac_lens, 0)
    l4_lens = torch.where((choice4[:, None] & quad_gate)[..., None], l4_lens, 0)
    # the AC streams (maxNumCoeff 15) padded to the I4 width (16) to merge
    pad = l4_vals.shape[-1] - ac_vals.shape[-1]
    ac_vals = torch.nn.functional.pad(ac_vals, (0, pad))
    ac_lens = torch.nn.functional.pad(ac_lens, (0, pad))
    luma_vals = torch.where(choice4[:, None, None], l4_vals, ac_vals)
    luma_lens = torch.where(choice4[:, None, None], l4_lens, ac_lens)
    c_vals, c_lens = _chroma_symbols(ch, nmb)

    # header: ue(mb_type); for I4x4 the 16 prediction-mode symbols (the
    # flag 1 in 1 bit, or the flag 0 and the 3-bit rem_mode fused into 4
    # bits); ue(chroma mode); ue(CBP code) for I4x4 only; se(0)
    # mb_qp_delta when a residual follows
    h0v, h0l = ue_code(mb_type)
    pm_vals = torch.where(prev_flags, 1, rem_modes).to(I32)
    pm_lens = torch.where(prev_flags, 1, 4).to(I32) * choice4[:, None].to(I32)
    h1v, h1l = ue_code(cmode)
    cbp_code = const(CBP_TO_CODENUM_INTRA, dev)[
        ((cbp_c << 4) | torch.where(choice4, cbp_luma, 0)).long()]
    h2v, h2l = ue_code(cbp_code)
    h2l = torch.where(choice4, h2l, 0)
    qdl = (~choice4 | (cbp_luma > 0) | (cbp_c > 0)).to(I32)
    one = torch.ones(nmb, dtype=I32, device=dev)
    vals = torch.cat([h0v[:, None].to(I32), pm_vals,
                      torch.stack([h1v, h2v, one], dim=-1).to(I32), dc_vals,
                      luma_vals.reshape(nmb, -1), c_vals], dim=-1)
    lens = torch.cat([h0l[:, None], pm_lens,
                      torch.stack([h1l, h2l, qdl], dim=-1).to(I32), dc_lens,
                      luma_lens.reshape(nmb, -1), c_lens], dim=-1)
    words, nbits = _pack(vals, lens, valid)
    nz_luma = torch.where(choice4[:, None], lv4.ne(0).any(dim=-1),
                          i16ac.ne(0).any(dim=2) | i16dc.ne(0).any(dim=1)[:, None])
    return {
        "words": words,
        "nbits": nbits,
        "mb_type": mb_type,
        "cbp_luma": cbp_luma,
        "cbp_chroma": cbp_c,
        "tc_luma": tc_luma,
        "tc_chroma": tc_c,
        "nz_luma": nz_luma,
    }


_NUM_PARTS = np.array([1, 2, 2, 4, 4], np.int32)  # per P mb_type 0..4


def p_slice_entropy_plain(skip, mb_type, mvd, luma_levels, cdc, cac,
                          wmb: int, hmb: int, top_ctx=None, run_lead=None):
    """Whole-slice macroblock_layer bits of a P frame (the inter syntax of
    rbsp_encoding.cpp:179-299).

    skip (nmb,) bool; mb_type (nmb,) raw inter type 0..4 (ignored at skip
    MBs); mvd (nmb, 4, 2) per-partition mvds; luma_levels (nmb, 16, 16)
    Z-scan zig-zag lists; cdc (2, nmb, 4); cac (2, nmb, 4, 15); levels are
    zero at skip MBs. Each coded MB writes ue(mb_skip_run), ue(mb_type),
    four sub_mb_types for P_8x8, se(mvd) per partition, the inter CBP, and
    the CBP-gated residual with neighbour-TotalCoeff nC (a skip MB counts
    as tc = 0 through its CBP). A run of skips at the end of the slice is
    written as one more ue(mb_skip_run).

    Returns dict: words, nbits (as i16_slice_entropy), trail_bits (0-d
    int32, the length of that trailing run symbol, 0 when the slice ends on
    a coded MB), cbp_luma, cbp_chroma, tc_luma, tc_chroma, nz_luma.

    For an MB-row band (p_slice_entropy_impl's band contract,
    tpu_entropy.py:321-330): top_ctx as i16_slice_entropy's; run_lead, None
    for a whole slice, else the skipped MBs between the previous coded MB
    of the bands above and the band (an int or a 0-d tensor, the
    reference's lead_extra), added to the run of the band's first coded MB.
    A band writes no trailing run (trail_bits 0): the slice's one trailing
    mb_skip_run is its last symbol, which the caller writes after the last
    band (where the reference's band holding the last coded MB writes it,
    emit_trailing, no other symbol follows)."""
    nmb = wmb * hmb
    dev = skip.device
    coded = ~skip
    idx = torch.arange(nmb, dtype=I32, device=dev)

    # mb_skip_run before each coded MB: distance to the previous coded MB
    marks = torch.where(coded, idx, -1)
    inc = torch.cummax(marks, dim=0).values
    prev = torch.cat([torch.full((1,), -1, dtype=I32, device=dev), inc[:-1]])
    run = idx - prev - 1
    trail_run = nmb - 1 - inc[-1]
    if run_lead is not None:
        first_coded = torch.where(coded, idx, nmb).amin()
        run = (run + torch.where(idx == first_coded, run_lead, 0)).to(I32)

    # CBP from the levels (setCodedBlockPattern)
    quad_any = luma_levels.reshape(nmb, 4, 64).ne(0).any(dim=-1)  # Z-scan quads
    cbp_l = (quad_any.to(I32) << torch.arange(4, dtype=I32, device=dev)).sum(
        dim=-1, dtype=I32)
    ch = chroma_setup_plain(cdc, cac, wmb, hmb, None if top_ctx is None else top_ctx[2:])
    cbp_c = ch["cbp_chroma"]

    # luma residual: 16 blocks of maxNumCoeff 16, coded where their quad is
    lv_blk = block_symbols_bulk(luma_levels, 16)
    quad_gate = quad_any.repeat_interleave(4, dim=1)  # (nmb, 16)
    tc_luma = torch.where(quad_gate, lv_blk["tc"], 0).to(I32)
    nc_l = _nc_luma_grid(tc_luma, cbp_l, wmb, hmb, None if top_ctx is None else top_ctx[:2])
    lv_vals, lv_lens = finalize_symbols(lv_blk, nc_to_ctx(nc_l))
    lv_lens = torch.where(quad_gate[..., None], lv_lens, 0)
    c_vals, c_lens = _chroma_symbols(ch, nmb)

    # header symbols
    h_run_v, h_run_l = ue_code(run)
    h_t_v, h_t_l = ue_code(mb_type)
    sub_v = torch.ones((nmb, 4), dtype=I32, device=dev)
    sub_l = torch.where((mb_type >= 3)[:, None], 1, 0).to(I32).expand(nmb, 4)
    nparts = const(_NUM_PARTS, dev)[mb_type.clamp(0, 4).long()]
    mvd_v, mvd_l = se_code(mvd.reshape(nmb, 8))
    part_ok = torch.arange(4, device=dev)[None] < nparts[:, None]
    mvd_l = mvd_l * part_ok.repeat_interleave(2, dim=1).to(I32)
    cbp_code = const(CBP_TO_CODENUM_INTER, dev)[((cbp_c << 4) | cbp_l).long()]
    h_c_v, h_c_l = ue_code(cbp_code)
    qdl = ((cbp_l > 0) | (cbp_c > 0)).to(I32)  # se(0) mb_qp_delta

    one = torch.ones((nmb, 1), dtype=I32, device=dev)
    vals = torch.cat([h_run_v[:, None], h_t_v[:, None], sub_v, mvd_v.to(I32),
                      h_c_v[:, None], one, lv_vals.reshape(nmb, -1), c_vals],
                     dim=-1)
    lens = torch.cat([h_run_l[:, None], h_t_l[:, None], sub_l, mvd_l,
                      h_c_l[:, None], qdl[:, None], lv_lens.reshape(nmb, -1),
                      c_lens], dim=-1)
    lens = torch.where(coded[:, None], lens, 0)

    # the trailing skip run, written when the slice ends on skips
    t_v, t_l = ue_code(trail_run)
    t_l = torch.where(trail_run > 0, t_l, 0).to(I32)
    if run_lead is not None:  # a band: no trailing run
        t_l = torch.zeros_like(t_l)
    words, nbits = pack_symbols(
        torch.cat([vals.reshape(-1), t_v.reshape(1).to(I32)]),
        torch.cat([lens.reshape(-1).to(I32), t_l.reshape(1)]))
    return {
        "words": words,
        "nbits": nbits,
        "trail_bits": t_l,
        "cbp_luma": cbp_l,
        "cbp_chroma": cbp_c,
        "tc_luma": tc_luma,
        "tc_chroma": ch["tc_chroma"],
        "nz_luma": luma_levels.ne(0).any(dim=-1),
    }


CHROMA_KEYS = ("cbp_chroma", "tc_chroma", "bits")


def chroma_setup(cdc, cac, wmb: int, hmb: int, top_ctx=None):
    """chroma_setup_plain's cbp_chroma (nmb,), tc_chroma (2, nmb, 4) and
    bits (nmb,) (CHROMA_KEYS; its symbol streams stay inside the plain
    chain). CUDA tensors go to K10, CPU tensors to the plain twin."""
    if on_card(cdc):
        return cavlc_slice.chroma_entropy(cdc, cac, wmb, hmb, top_ctx)
    ch = chroma_setup_plain(cdc, cac, wmb, hmb, top_ctx)
    return {k: ch[k] for k in CHROMA_KEYS}


def i16_slice_entropy(mode16, cmode, i16dc, i16ac, cdc, cac,
                      wmb: int, hmb: int, top_ctx=None, valid=None):
    """i16_slice_entropy_plain's function: CUDA tensors go to K10, CPU
    tensors to the plain twin."""
    args = (mode16, cmode, i16dc, i16ac, cdc, cac, wmb, hmb, top_ctx, valid)
    if on_card(mode16):
        return cavlc_slice.i16_entropy(*args)
    return i16_slice_entropy_plain(*args)


def mixed_slice_entropy(choice4, mode16, cmode, i16dc, i16ac, lv4, prev_flags,
                        rem_modes, cbp_luma, tc_luma, cdc, cac,
                        wmb: int, hmb: int, top_ctx=None, valid=None, *, chroma=None):
    """mixed_slice_entropy_plain's function: CUDA tensors go to K10, CPU
    tensors to the plain twin. chroma: the frame's chroma_setup output for
    the same cdc, cac and top_ctx, required by both (ValueError without
    it), which read its cbp_chroma and tc_chroma."""
    args = (choice4, mode16, cmode, i16dc, i16ac, lv4, prev_flags, rem_modes, cbp_luma,
            tc_luma, cdc, cac, wmb, hmb, top_ctx, valid)
    if on_card(choice4):
        return cavlc_slice.mixed_entropy(*args, chroma=chroma)
    return mixed_slice_entropy_plain(*args, chroma=chroma)


def p_slice_entropy(skip, mb_type, mvd, luma_levels, cdc, cac,
                    wmb: int, hmb: int, top_ctx=None, run_lead=None):
    """p_slice_entropy_plain's function: CUDA tensors go to K10 (a tensor
    run_lead is read on the card), CPU tensors to the plain twin."""
    args = (skip, mb_type, mvd, luma_levels, cdc, cac, wmb, hmb, top_ctx, run_lead)
    if on_card(skip):
        return cavlc_slice.p_entropy(*args)
    return p_slice_entropy_plain(*args)
