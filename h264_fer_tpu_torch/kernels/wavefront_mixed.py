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


def mixed_luma_plain(y, mode16, mode4, cmode, cbp_c, chroma_bits, qp: int):
    """Plain PyTorch K6. y (H, W) uint8 source; mode16, cmode, cbp_c,
    chroma_bits (nmb,) and mode4 (nmb, 16) int32. Returns the dict of
    wavefront_mixed_luma_impl (KEYS): recon_y (H, W) uint8, choice4 (nmb,)
    bool, i16dc (nmb, 16), i16ac (nmb, 16, 15), lv4 (nmb, 16, 16),
    prev_flags (nmb, 16) bool, rem_modes (nmb, 16), cbp_luma (nmb,),
    tc_luma (nmb, 16)."""
    h, w = y.shape
    hmb, wmb = h // 16, w // 16
    nmb = hmb * wmb
    dev = y.device
    src = to_mbs(y.to(I32), 16).reshape(hmb, wmb, 16, 16)
    rec = torch.zeros_like(src)
    # per-MB state and outputs, by raster MB index
    choice = torch.zeros(nmb, dtype=torch.bool, device=dev)
    tcl = torch.zeros((nmb, 16), dtype=I32, device=dev)
    cbpl = torch.zeros(nmb, dtype=I32, device=dev)
    out = {"i16dc": torch.zeros((nmb, 16), dtype=I32, device=dev),
           "i16ac": torch.zeros((nmb, 16, 15), dtype=I32, device=dev),
           "lv4": torch.zeros((nmb, 16, 16), dtype=I32, device=dev),
           "prev_flags": torch.zeros((nmb, 16), dtype=torch.bool, device=dev),
           "rem_modes": torch.zeros((nmb, 16), dtype=I32, device=dev)}
    cbp_tab = const(CBP_TO_CODENUM_INTRA, dev)
    quad = torch.arange(16, device=dev) // 4
    maxc = const(np.array([16] + [15] * 16 + [16] * 16, np.int32), dev)
    for r, c, mb in knight_waves(hmb, wmb, dev):
        n = mb.shape[0]
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
    return {"recon_y": from_mbs(rec.reshape(-1, 16, 16), hmb, wmb).to(torch.uint8),
            "choice4": choice, **out, "cbp_luma": cbpl, "tc_luma": tcl}


def mixed_luma(y, mode16, mode4, cmode, cbp_c, chroma_bits, qp: int, *,
               blocks=None):
    """K6: mixed_luma_plain's function. CUDA tensors (y uint8, the rest
    int32, contiguous) go to the kernel (one launch per frame), CPU tensors
    to the plain version. blocks: the kernel's grid size (None: as many
    blocks as fit on the card at once); any size gives the same result."""
    args = (y, mode16, mode4, cmode, cbp_c, chroma_bits)
    grid = dataflow.check_blocks(blocks)
    if y.device.type == "cpu":
        return mixed_luma_plain(*args, qp)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
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
    out = {"recon_y": torch.empty_like(y),
           "choice4": torch.empty(nmb, dtype=torch.bool, device=dev),
           "i16dc": torch.empty((nmb, 16), dtype=I32, device=dev),
           "i16ac": torch.empty((nmb, 16, 15), dtype=I32, device=dev),
           "lv4": torch.empty((nmb, 16, 16), dtype=I32, device=dev),
           "prev_flags": torch.empty((nmb, 16), dtype=torch.bool, device=dev),
           "rem_modes": torch.empty((nmb, 16), dtype=I32, device=dev),
           "cbp_luma": torch.empty(nmb, dtype=I32, device=dev),
           "tc_luma": torch.empty((nmb, 16), dtype=I32, device=dev)}
    order, sched = dataflow.schedule(dataflow.knight_order(wmb, hmb), dev)
    build.launch(mixed_luma, "wavefront_mixed", "wavefront_mixed_frame",
                 (*args, const(TABLES, dev), const(PRED4_TABLE, dev),
                  *(out[k] for k in KEYS), order,
                  sched, wmb, hmb, qp, qtab(qp), grid), dev)
    return out


# kernel launches so far, as counted by the C entry point (one per accepted
# launch, one per frame)
mixed_luma.launches = 0
