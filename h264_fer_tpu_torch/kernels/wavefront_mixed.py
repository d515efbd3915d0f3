"""Mixed I-frame arbitration wavefront (K6): the exact Intra_4x4-vs-
Intra_16x16 choice per MB by coded bit size.

`mixed_luma` is the wrapper of the CUDA kernel csrc/wavefront_mixed.cu,
the device form of the XLA loop wavefront_mixed_luma_impl
(h264_fer_tpu/kernels/wavefront_mixed.py:54, fori_loop at :411), which no
Pallas kernel replaced. On a CUDA tensor it launches the kernel (one
launch per frame: a persistent grid that takes the MBs in knight order and
starts each as soon as its neighbours are done, kernels/dataflow.py) or
raises; on a CPU tensor it runs `mixed_luma_plain`, that loop without its
band= branch in plain PyTorch.

The reference decides per MB by the exact bit cost of the fully coded MB
(intra.cpp:1088-1107 with coded_mb_size, rbsp_encoding.cpp:330-488), a
decision chained three ways: the winner's reconstruction feeds its
neighbours' prediction, its TotalCoeff their nC contexts, and its class
(I4x4 or I16) their most-probable-mode derivation. Both versions run MB
knight waves d = 2r + c; each MB codes the I16 candidate, the I4x4
candidate (kernels/wavefront_i4x4.i4x4_mb_code), the CAVLC sizes of both,
and keeps the strictly smaller. Chroma does not depend on the choice: the
caller passes each MB's cbp_chroma and exact chroma residual bits.

`mixed_luma_band` (K6-band) is K6 over one MB-row band of a frame, the
device form of the loop's band= form with m4_halo= (wavefront_mixed.py:
74-404): its `top` is the band above's last MB row as K6 left it (recon
row 15, classes, TotalCoeffs, CBP) and that row's pre-decided Intra4x4
modes, which the band's first row reads as its top neighbours (the C entry
point wavefront_mixed_band, with the halo copied one MB row before the
band in the kernel's state arrays; launches counted on
mixed_luma_band.launches). Its plain twin is `mixed_luma_plain(top=top)`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cavlc_bulk import block_symbols_bulk, nc_to_ctx, ue_bits
from ..ops.cavlc_tables import COEFF_TOKEN_LEN, RUN_BEFORE_LEN, TOTAL_ZEROS_LEN
from ..ops.device import const
from ..ops.tables import CBP_TO_CODENUM_INTRA, LUMA_NBR
from ..ops.tiles import from_mbs, to_mbs
from . import build, dataflow
from .wavefront_i4x4 import PRED4_TABLE, i4x4_mb_code, knight_waves, mb_neighbours
from .wavefront_i16 import _i16_luma_code, qtab

I32 = torch.int32
KEYS = ("recon_y", "choice4", "i16dc", "i16ac", "lv4", "prev_flags",
        "rem_modes", "cbp_luma", "tc_luma")
# the kernel's length tables, one int32 buffer: coeff_token [ctx][tc][t1],
# total_zeros [tc - 1][zeros], run_before [zeros_left - 1][run], and the
# intra CBP code numbers
TABLES = np.concatenate([COEFF_TOKEN_LEN.reshape(-1), TOTAL_ZEROS_LEN.reshape(-1),
                         RUN_BEFORE_LEN.reshape(-1), CBP_TO_CODENUM_INTRA]).astype(np.int32)


def _gated(tc, cbp, blk: int):
    """TotalCoeff of block blk, 0 where its 8x8 quadrant is not coded
    (residual.cpp allNeighbouringZero)."""
    return torch.where((cbp >> (blk // 4)) & 1 != 0, tc[:, blk], 0)


def _nc(tc_own, cbp_own, left, top, left_ok, top_ok):
    """(n, 16) luma nC of every block of n MBs, with their own TCs and CBP
    and the (tc, cbp) state of the left and top MBs."""
    cols = []
    for a_same, a_blk, b_same, b_blk in LUMA_NBR:
        nA = _gated(tc_own, cbp_own, a_blk) if a_same else _gated(*left, a_blk)
        nB = _gated(tc_own, cbp_own, b_blk) if b_same else _gated(*top, b_blk)
        a_ok = torch.ones_like(left_ok) if a_same else left_ok
        b_ok = torch.ones_like(top_ok) if b_same else top_ok
        cols.append(torch.where(a_ok & b_ok, (nA + nB + 1) >> 1,
                                torch.where(a_ok, nA, torch.where(b_ok, nB, 0))))
    return torch.stack(cols, dim=-1)


def _bits(blk, nc):
    """Coded bits of blocks given their nC: coeff_token + the rest."""
    ct = blk["ct_len"].gather(-1, nc_to_ctx(nc).long()[..., None])[..., 0]
    return ct + blk["rest_bits"]


def mixed_luma_plain(y, mode16, mode4, cmode, cbp_c, chroma_bits, qp: int,
                     top=None):
    """Plain PyTorch K6. y (H, W) uint8 source; mode16, cmode, cbp_c,
    chroma_bits (nmb,) and mode4 (nmb, 16) int32. Returns the dict of
    wavefront_mixed_luma_impl (KEYS): recon_y (H, W) uint8, choice4 (nmb,)
    bool, i16dc (nmb, 16), i16ac (nmb, 16, 15), lv4 (nmb, 16, 16),
    prev_flags (nmb, 16) bool, rem_modes (nmb, 16), cbp_luma (nmb,),
    tc_luma (nmb, 16). top: None, or the halo of the MB-row band above
    (mixed_luma_band's), which then stands as a coded MB row 0 above the
    frame: the waves skip it and the outputs leave it out."""
    h, w = y.shape
    wmb = w // 16
    r0 = int(top is not None)  # MB rows of state above the band
    hmb = h // 16 + r0
    nmb = hmb * wmb
    dev = y.device

    def ext(x):  # x with r0 MB rows of zeros, or the halo, before it
        return torch.cat([x.new_zeros((r0 * wmb, *x.shape[1:])), x])

    mode16, cmode, cbp_c, chroma_bits = map(ext, (mode16, cmode, cbp_c, chroma_bits))
    src = ext(to_mbs(y.to(I32), 16)).reshape(hmb, wmb, 16, 16)
    rec = torch.zeros_like(src)
    # per-MB state and outputs, by raster MB index
    choice = torch.zeros(nmb, dtype=torch.bool, device=dev)
    tcl = torch.zeros((nmb, 16), dtype=I32, device=dev)
    cbpl = torch.zeros(nmb, dtype=I32, device=dev)
    if top is not None:
        rec[0, :, 15] = top["recon"].to(I32).reshape(wmb, 16)
        choice[:wmb], tcl[:wmb], cbpl[:wmb] = top["choice4"], top["tc_luma"], top["cbp_luma"]
        mode4 = torch.cat([top["mode4"], mode4])
    out = {"i16dc": torch.zeros((nmb, 16), dtype=I32, device=dev),
           "i16ac": torch.zeros((nmb, 16, 15), dtype=I32, device=dev),
           "lv4": torch.zeros((nmb, 16, 16), dtype=I32, device=dev),
           "prev_flags": torch.zeros((nmb, 16), dtype=torch.bool, device=dev),
           "rem_modes": torch.zeros((nmb, 16), dtype=I32, device=dev)}
    cbp_tab = const(CBP_TO_CODENUM_INTRA, dev)
    quad = torch.arange(16, device=dev) // 4
    maxc = const(np.array([16] + [15] * 16 + [16] * 16, np.int32), dev)
    for r, c, mb in knight_waves(hmb, wmb, dev):
        if r0:  # the halo row is coded already
            keep = r >= r0
            r, c, mb = r[keep], c[keep], mb[keep]
        n = mb.shape[0]
        if n == 0:
            continue
        nb = mb_neighbours(rec, r, c)
        left_ok, top_ok = c > 0, r > 0
        mb_l = torch.where(left_ok, mb - 1, mb)  # clamped: masked below
        mb_t = torch.where(top_ok, mb - wmb, mb)

        # I16 candidate
        m16 = mode16[mb]
        p33 = torch.cat([nb["corner"][:, None], nb["lcol"], nb["trow"]], dim=-1)
        recon16, i16dc, i16ac = _i16_luma_code(src[r, c], p33, m16, qp)

        # I4x4 candidate and its prediction-mode syntax (MPM,
        # setIntra4x4PredMode intra.cpp:878-942): a neighbour that is
        # I16 or absent gives mode 2; either absent makes both 2
        m4 = mode4[mb]
        recon4, lv4 = i4x4_mb_code(src[r, c], m4, nb, qp)
        i4_left = choice[mb_l] & left_ok
        i4_top = choice[mb_t] & top_ok
        pf, rm = [], []
        for z, (a_same, a_blk, b_same, b_blk) in enumerate(LUMA_NBR):
            mode_a = m4[:, a_blk] if a_same else torch.where(
                i4_left, mode4[mb_l, a_blk], 2)
            mode_b = m4[:, b_blk] if b_same else torch.where(
                i4_top, mode4[mb_t, b_blk], 2)
            ok = ((torch.ones_like(left_ok) if a_same else left_ok)
                  & (torch.ones_like(top_ok) if b_same else top_ok))
            mpm = torch.where(ok, torch.minimum(mode_a, mode_b), 2)
            pf.append(m4[:, z] == mpm)
            rm.append(torch.where(m4[:, z] < mpm, m4[:, z], m4[:, z] - 1))
        pf, rm = torch.stack(pf, dim=-1), torch.stack(rm, dim=-1).to(I32)

        # exact bit sizes (coded_mb_size)
        cbp16 = torch.where(i16ac.reshape(n, -1).ne(0).any(dim=-1), 15, 0).to(I32)
        quad_nz = lv4.ne(0).any(dim=-1).reshape(n, 4, 4).any(dim=-1)
        cbp4 = (quad_nz.to(I32) << torch.arange(4, device=dev)).sum(dim=-1, dtype=I32)
        # the 33 blocks of both candidates in one batch: the I16 DC block,
        # 16 AC blocks (maxNumCoeff 15, padded to 16) and 16 I4 blocks
        blk = block_symbols_bulk(
            torch.cat([i16dc[:, None], torch.nn.functional.pad(i16ac, (0, 1)), lv4], 1),
            maxc, sizes_only=True)
        dc_blk, ac_blk, l4_blk = ({k: v[:, s] for k, v in blk.items()}
                                  for s in (0, slice(1, 17), slice(17, 33)))
        # nC of both candidates in one batch of 2n MBs
        nc16, nc4 = _nc(torch.cat([ac_blk["tc"], l4_blk["tc"]]),
                        torch.cat([cbp16, cbp4]),
                        (tcl[mb_l].repeat(2, 1), cbpl[mb_l].repeat(2)),
                        (tcl[mb_t].repeat(2, 1), cbpl[mb_t].repeat(2)),
                        left_ok.repeat(2), top_ok.repeat(2)).split(n)
        quad_gate = ((cbp4[:, None] >> quad) & 1) != 0
        ac_sum = _bits(ac_blk, nc16).sum(dim=-1, dtype=I32)
        l4_sum = torch.where(quad_gate, _bits(l4_blk, nc4), 0).sum(dim=-1, dtype=I32)
        cm, cbpc, cbits = cmode[mb], cbp_c[mb], chroma_bits[mb]
        size16 = (ue_bits(1 + m16 + 4 * cbpc + torch.where(cbp16 == 15, 12, 0))
                  + ue_bits(cm) + 1 + _bits(dc_blk, nc16[:, 0])
                  + torch.where(cbp16 == 15, ac_sum, 0) + cbits)
        resid4 = (cbp4 > 0) | (cbpc > 0)
        size4 = (1 + torch.where(pf, 1, 4).sum(dim=-1, dtype=I32) + ue_bits(cm)
                 + ue_bits(cbp_tab[((cbpc << 4) | cbp4).long()])
                 + torch.where(resid4, 1 + l4_sum + cbits, 0))
        ch = size4 < size16  # intra.cpp:1088: strict

        # state: an I16 MB without AC keeps the DC block's TotalCoeff in
        # slot 0 of its TC state (wavefront_mixed.py:348-351)
        dc_state = torch.zeros_like(ac_blk["tc"])
        dc_state[:, 0] = dc_blk["tc"]
        tc16 = torch.where((cbp16 == 15)[:, None], ac_blk["tc"], dc_state)
        tc4 = torch.where(quad_gate, l4_blk["tc"], 0)
        rec[r, c] = torch.where(ch[:, None, None], recon4, recon16)
        choice[mb] = ch
        tcl[mb] = torch.where(ch[:, None], tc4, tc16).to(I32)
        cbpl[mb] = torch.where(ch, cbp4, cbp16)
        for key, val in (("i16dc", i16dc), ("i16ac", i16ac), ("lv4", lv4),
                         ("prev_flags", pf), ("rem_modes", rm)):
            out[key][mb] = val
    recon = from_mbs(rec[r0:].reshape(-1, 16, 16), hmb - r0, wmb).to(torch.uint8)
    state = {"choice4": choice, **out, "cbp_luma": cbpl, "tc_luma": tcl}
    return {"recon_y": recon, **{k: v[r0 * wmb:] for k, v in state.items()}}


# the halo of mixed_luma_band: the band above's last MB row, (shape per
# MB, dtype), by key
TOP_KEYS = {"recon": ((16,), torch.uint8), "choice4": ((), torch.bool),
            "tc_luma": ((16,), I32), "cbp_luma": ((), I32), "mode4": ((16,), I32)}


def _check_top(top, wmb: int, device) -> dict:
    """The halo dict `top` of mixed_luma_band, each entry as (wmb, ...) by
    TOP_KEYS (recon may come as its (wmb * 16,) sample row); raises
    ValueError for a missing key, a wrong shape, dtype or device."""
    out = {}
    for key, (shape, dtype) in TOP_KEYS.items():
        if key not in top:
            raise ValueError(f"top: no {key!r}")
        row = top[key]
        if row.numel() == wmb * int(np.prod(shape)):
            row = row.reshape(wmb, *shape)
        build.check_tensor(f"top {key}", row, (wmb, *shape), dtype, device)
        out[key] = row
    return out


def _launch(wrapper, symbol, args, qp: int, grid: int, band: bool, top=None):
    """One launch of csrc/wavefront_mixed.cu's entry point `symbol` on the
    CUDA tensors args (y, mode16, mode4, cmode, cbp_c, chroma_bits); returns
    the output dict (KEYS). band: the band entry point, whose state arrays
    (recon, choice4, tc_luma, cbp_luma, and a copy of mode4) hold one MB
    row before the band, filled from the halo `top` unless it is None."""
    y, mode16, mode4, cmode, cbp_c, chroma_bits = args
    h, w = y.shape
    if h % 16 or w % 16:
        raise ValueError(f"frame {w}x{h} is not a whole number of MBs")
    dev = y.device
    hmb, wmb = h // 16, w // 16
    nmb = hmb * wmb
    for name, t, shape, dtype in (
            ("y", y, (h, w), torch.uint8), ("mode16", mode16, (nmb,), I32),
            ("mode4", mode4, (nmb, 16), I32), ("cmode", cmode, (nmb,), I32),
            ("cbp_c", cbp_c, (nmb,), I32),
            ("chroma_bits", chroma_bits, (nmb,), I32)):
        build.check_tensor(name, t, shape, dtype, dev)
    if y.data_ptr() % 16:
        raise ValueError("y: the kernel copies it in 16-byte chunks")
    pre = wmb if band else 0  # MBs of halo state before the band's
    bufs = {"recon": torch.empty((h + int(band), w), dtype=torch.uint8, device=dev),
            "choice4": torch.empty(pre + nmb, dtype=torch.bool, device=dev),
            "cbp_luma": torch.empty(pre + nmb, dtype=I32, device=dev),
            "tc_luma": torch.empty((pre + nmb, 16), dtype=I32, device=dev)}
    if band:
        bufs["mode4"] = torch.empty((pre + nmb, 16), dtype=I32, device=dev)
        bufs["mode4"][pre:] = mode4
        mode4 = bufs["mode4"][pre:]
        if top is not None:
            for key, row in _check_top(top, wmb, dev).items():
                dst = bufs[key][0] if key == "recon" else bufs[key][:pre]
                dst.copy_(row.reshape(dst.shape))
    out = {"recon_y": bufs["recon"][int(band):],
           "choice4": bufs["choice4"][pre:],
           "i16dc": torch.empty((nmb, 16), dtype=I32, device=dev),
           "i16ac": torch.empty((nmb, 16, 15), dtype=I32, device=dev),
           "lv4": torch.empty((nmb, 16, 16), dtype=I32, device=dev),
           "prev_flags": torch.empty((nmb, 16), dtype=torch.bool, device=dev),
           "rem_modes": torch.empty((nmb, 16), dtype=I32, device=dev),
           "cbp_luma": bufs["cbp_luma"][pre:],
           "tc_luma": bufs["tc_luma"][pre:]}
    order, sched = dataflow.schedule(dataflow.knight_order(wmb, hmb), dev)
    build.launch(wrapper, "wavefront_mixed", symbol,
                 (y, mode16, mode4, cmode, cbp_c, chroma_bits, const(TABLES, dev),
                  const(PRED4_TABLE, dev), *(out[k] for k in KEYS), order, sched, wmb,
                  hmb, *((int(top is not None),) if band else ()), qp, qtab(qp), grid),
                 dev)
    return out


def _kernel(y) -> bool:
    """False for a CPU tensor (the plain twin runs), True for a CUDA one;
    raises for any other device."""
    if y.device.type == "cpu":
        return False
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    return True


def mixed_luma(y, mode16, mode4, cmode, cbp_c, chroma_bits, qp: int, *,
               blocks=None):
    """K6: mixed_luma_plain's function. CUDA tensors (y uint8, the rest
    int32, contiguous) go to the kernel (one launch per frame), CPU tensors
    to the plain version. blocks: the kernel's grid size (None: as many
    blocks as fit on the card at once); any size gives the same result."""
    args = (y, mode16, mode4, cmode, cbp_c, chroma_bits)
    grid = dataflow.check_blocks(blocks)
    if not _kernel(y):
        return mixed_luma_plain(*args, qp)
    return _launch(mixed_luma, "wavefront_mixed_frame", args, qp, grid, band=False)


# kernel launches so far, as counted by the C entry point (one per accepted
# launch, one per frame)
mixed_luma.launches = 0


def mixed_luma_band(y, mode16, mode4, cmode, cbp_c, chroma_bits, qp: int, top=None, *,
                    blocks=None):
    """K6-band: mixed_luma over one MB-row band. top: None for a band with
    no MB row above it, else the band above's last MB row on the band's
    device, a dict (TOP_KEYS) of recon (wmb * 16,) uint8 (its sample row
    15), choice4 (wmb,) bool, tc_luma (wmb, 16) and cbp_luma (wmb,) int32 as
    K6 left them, and mode4 (wmb, 16) int32, its pre-decided Intra4x4
    modes. CUDA tensors go to the kernel (wavefront_mixed_band, one launch,
    counted on mixed_luma_band.launches), CPU tensors to
    mixed_luma_plain(top=top). blocks: as mixed_luma's."""
    args = (y, mode16, mode4, cmode, cbp_c, chroma_bits)
    grid = dataflow.check_blocks(blocks)
    if top is not None:
        _check_top(top, y.shape[1] // 16, y.device)
    if not _kernel(y):
        return mixed_luma_plain(*args, qp, top)
    return _launch(mixed_luma_band, "wavefront_mixed_band", args, qp, grid, band=True,
                   top=top)


mixed_luma_band.launches = 0
