"""The host per-MB encoder: the reference encoder's exact path, frame by frame.

The counterpart of h264_fer_tpu/codec/encoder.Encoder with tpu_iframe and
tpu_pframe off: the I and P branches of its _encode_slice and the per-MB
work they call.

- Intra MBs take the reference CPU mode decision exactly (SATD per mode
  with the availability gates, the early exit at SATD 0, then the
  coded_mb_size bit cost arbitrating Intra_4x4 against Intra_16x16;
  rbsp_encoding.cpp:330-488, intra.cpp:949-1110), so an I frame writes the
  C++ reference encoder's bytes. With device modes (the port's
  codec/intra_decision.intra_mode_decision on the card, the JAX
  TpuIntraPipeline's role) the SATD searches are skipped and the bit-cost
  arbitration runs on those modes.
- Inter MBs keep the reference's decision structure (adaptive MAXDIFF,
  the P_Skip exact-pixels test, a full integer search per 8x8 quadrant
  plus quarter-pel refinement around two centres, the unify trial, the
  partition merge, mvd against the spec predictor, the MAXDIFF source
  prefilter below QP 36; moestimation.cpp:392-585). With me="topk" (the
  CLI's --tpu-me) the integer search per quadrant re-ranks the device's
  top-16 SAD candidates of its block instead (ops/me.py: K2, then K9, once
  per P frame, read back once), as the JAX encoder does with its
  TpuMePipeline.
- After the slice, the trailing-skip drop (decoders never read a trailing
  skip run that fits in the last RBSP byte) and, with cfg.deblock, the
  in-loop filter K8 (kernels/deblock.deblock_frame) on the encoder's
  device, before the frame becomes the reference.

CAVLC is bit-serial and every MB reads its coded neighbours, so the loop
is host work in numpy (ops/encode_host.py, ops/recon_host.py), as in the
reference. Integer widths follow the reference: uint8 samples are cast to
int32 before any arithmetic, the SSD tiers square int64 differences, and
the search and unify costs compare as float64.
"""

from __future__ import annotations

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from ..bitstream.bitio import BitWriter
from ..bitstream.expgolomb import ue_code, write_se, write_ue
from ..kernels.deblock import deblock_frame
from ..ops import cavlc, encode_host, mc, recon_host
from ..ops import tables as T
from ..ops.device import upload
from ..ops.interp import interpolated_planes, mc_macroblock_from_planes, pad_chroma
from ..ops.intra import INTRA16_TO_CHROMA_MODE
from ..ops.me import candidates
from . import mvpred
from .mvpred import MB_SKIP

# Z-scan luma block geometry: (16, 2) x, y sample offsets in the MB
_BLK_XY = T.INTRA4X4_SCAN_ORDER_XY
# availability gates of the mode trials (intra.cpp:983-989, 1021-1031)
_I16_GATE = {0: "top", 1: "left", 3: "corner"}
_I4_GATE = {0: "top", 1: "left", 3: "top", 4: "corner", 5: "corner",
            6: "corner", 7: "top", 8: "left"}
# the quarter-pel refinement's 49 offsets around a centre, (dy, dx) raster
_QPEL_DY, _QPEL_DX = (a.ravel() for a in np.mgrid[-3:4, -3:4])
_AR8 = np.arange(8)
# the per-MB syntax state a trailing-skip drop restores (tc_chroma beside
# it: its MB axis is the second)
_MB_STATE = ("mb_type", "mb_intra", "mb_i4x4", "mv", "tc_luma", "cbp_luma", "cbp_chroma",
             "nz_luma")
# the stats' MB classes (DohvatiStatistiku): P_L0_16x16, 16x8, 8x16, P_8x8,
# P_8x8ref0, P_Skip, intra
SKIP_CLASS, INTRA_CLASS = 5, 6
# integer candidates per 8x8 block from the device search (me="topk"), as
# the JAX TpuMePipeline's default
ME_TOPK = 16


def i16_mb_type(pred_mode: int, cbp_chroma: int, cbp_luma15: bool) -> int:
    """I-slice mb_type (1..24) of an Intra_16x16 MB (norm Table 7-11)."""
    return 1 + pred_mode + 4 * cbp_chroma + (12 if cbp_luma15 else 0)


def _blocks_of(mb16: np.ndarray) -> np.ndarray:
    """(16, 4, 4) Z-scan 4x4 blocks of a 16x16 MB."""
    return np.stack([mb16[by: by + 4, bx: bx + 4] for bx, by in _BLK_XY])


def _chroma_blocks(diff8: np.ndarray) -> np.ndarray:
    """(2, 4, 4, 4) raster 4x4 blocks of the (2, 8, 8) Cb and Cr MBs."""
    return diff8.reshape(2, 2, 4, 2, 4).transpose(0, 1, 3, 2, 4).reshape(2, 4, 4, 4)


def _cbp_from_levels(i16: bool, luma_ac, chroma_dc, chroma_ac):
    """setCodedBlockPattern (rbsp_encoding.cpp:21-105)."""
    cbp_luma = 0
    for i8 in range(4):
        if luma_ac[i8 * 4: i8 * 4 + 4].any():
            cbp_luma |= 1 << i8
    if i16 and cbp_luma:
        cbp_luma = 15
    cbp_chroma = 0
    if chroma_dc.any():
        cbp_chroma |= 1
    if chroma_ac.any():
        cbp_chroma |= 2
    if cbp_chroma == 3:
        cbp_chroma = 2
    return cbp_luma, cbp_chroma


class HostEncoder:
    """The per-MB state and slice loop of one session's host frames.

    The state arrays keep the JAX encoder's names and shapes, the state
    protocol codec/mvpred.py reads: mb_type (raw slice mb_type, MB_SKIP for
    P_Skip), mb_intra, mb_i4x4, tc_luma (nmb, 16), tc_chroma (2, nmb, 4),
    cbp_luma, cbp_chroma, i4x4_mode (nmb, 16), mv (nmb, 4, 4, 2) quadrant-
    major quarter-pel MVs, prev_mv (the previous frame's, the temporal
    refinement centres) and nz_luma (nmb, 16). y, cb and cr are the working
    planes (int32: the source, overwritten MB by MB by the reconstruction);
    ref_y, ref_cb and ref_cr the reference frame as decoders hold it.
    me: "full" (the host's own integer search) or "topk" (the device's
    candidates, searched per P frame)."""

    def __init__(self, width: int, height: int, cfg, qpc: int, device,
                 me: str = "full") -> None:
        self.cfg = cfg
        self.device = device
        self.me = me
        self.w, self.h = width, height
        self.wmb, self.hmb = width // 16, height // 16
        self.nmb = self.wmb * self.hmb
        self.qpy, self.qpc = cfg.qp, qpc
        nmb = self.nmb
        self.mb_type = np.zeros(nmb, np.int32)
        self.mb_intra = np.zeros(nmb, bool)
        self.mb_i4x4 = np.zeros(nmb, bool)
        self.tc_luma = np.zeros((nmb, 16), np.int32)
        self.tc_chroma = np.zeros((2, nmb, 4), np.int32)
        self.cbp_luma = np.zeros(nmb, np.int32)
        self.cbp_chroma = np.zeros(nmb, np.int32)
        self.i4x4_mode = np.zeros((nmb, 16), np.int32)
        self.mv = np.zeros((nmb, 4, 4, 2), np.int32)
        self.prev_mv = np.zeros((nmb, 4, 4, 2), np.int32)
        self.nz_luma = np.zeros((nmb, 16), bool)
        self.y = self.cb = self.cr = None
        self.ref_y = self.ref_cb = self.ref_cr = None
        self._modes = None
        self._me_cands = None

    # ------------------------------------------------------------------
    # Frames

    def encode_slice(self, w: BitWriter, is_idr: bool, y, cb, cr, modes=None) -> bytes:
        """Code one frame's macroblock layer after the slice header that `w`
        holds, then the trailing-skip drop, the filter and the reference
        copy. y, cb, cr: uint8 numpy planes. modes: None (the host mode
        decision) or the device's (mode16 (nmb,), mode4 (nmb, 16)) numpy
        modes of this IDR. Returns the slice's RBSP."""
        if is_idr:
            # no MV leaks across an IDR, not even through the drop
            self.mv[:] = 0
            self.prev_mv[:] = 0
        self._modes = modes
        self._me_cands = None
        if not is_idr:
            planes = self._interp_planes()
            if self.me == "topk":
                self._me_cands = self._search_candidates(y, planes[0])
        self.y = y.astype(np.int32)
        self.cb = cb.astype(np.int32)
        self.cr = cr.astype(np.int32)
        # the previous frame's MB state, for the trailing-skip drop
        prev_state = {k: getattr(self, k).copy() for k in _MB_STATE + ("tc_chroma",)}
        mb_skip_run = 0
        pos_after_last_coded = 0
        for curr in range(self.nmb):
            if is_idr:
                self._intra_encode_mb(w, curr)
            else:
                res = self._inter_encode_mb(curr)
                if res is None:  # P_Skip
                    mb_skip_run += 1
                    continue
                write_ue(w, mb_skip_run)
                mb_skip_run = 0
                self._write_inter_mb(w, curr, *res)
            pos_after_last_coded = w.bit_position
        if mb_skip_run > 0:
            write_ue(w, mb_skip_run)
        w.rbsp_trailing_bits()
        rbsp = w.getvalue()
        # The reference decoder's more_rbsp_data is a byte-count
        # approximation (rbsp_IO.cpp:193): when everything after the last
        # coded MB fits in the final RBSP byte, the trailing skip run is
        # never read and those MBs keep the previous frame's samples and MB
        # state. The reconstruction mirrors what every decoder does.
        if (mb_skip_run > 0 and pos_after_last_coded > 0
                and pos_after_last_coded // 8 >= len(rbsp) - 1):
            self._drop_tail_skips(self.nmb - mb_skip_run, prev_state)
        if self.cfg.deblock:
            self._filter()
        self.prev_mv = np.zeros_like(self.mv) if is_idr else self.mv.copy()
        self.ref_y, self.ref_cb, self.ref_cr = self.y.copy(), self.cb.copy(), self.cr.copy()
        return rbsp

    def load_device_idr(self, out) -> None:
        """Take over the state of a device I frame (codec/iframe's dict:
        recon planes, already filtered under cfg.deblock, and its syntax
        state) for the host P frames after it (encoder._materialize)."""
        def host(key, dtype):
            return out[key].cpu().numpy().astype(dtype)

        self.y, self.cb, self.cr = (host(k, np.int32) for k in ("recon_y", "recon_cb", "recon_cr"))
        self.mb_type[:] = host("mb_type", np.int32)
        self.mb_intra[:] = True
        if "choice4" in out:  # mixed frame
            self.mb_i4x4[:] = host("choice4", bool)
            self.i4x4_mode[:] = host("i4x4_mode", np.int32)
        else:
            self.mb_i4x4[:] = False
        self.cbp_luma[:] = host("cbp_luma", np.int32)
        self.cbp_chroma[:] = host("cbp_chroma", np.int32)
        self.tc_luma[:] = host("tc_luma", np.int32)
        self.tc_chroma[:] = host("tc_chroma", np.int32)
        self.nz_luma[:] = host("nz_luma", bool)
        self.mv[:] = 0
        self.prev_mv[:] = 0
        self.ref_y, self.ref_cb, self.ref_cr = self.y.copy(), self.cb.copy(), self.cr.copy()

    def mb_class(self) -> np.ndarray:
        """(nmb,) int32 stats class of every MB of the last frame (0..6)."""
        return np.where(self.mb_intra, INTRA_CLASS,
                        np.where(self.mb_type == MB_SKIP, SKIP_CLASS,
                                 np.minimum(self.mb_type, 4))).astype(np.int32)

    def _interp_planes(self):
        """The 16 interpolated phases of the reference for the quarter-pel
        search and MC (FillInterpolatedRefFrame, moestimation.cpp:74-173),
        computed on the encoder's device, and the padded chroma. Returns the
        planes as they lie on the device."""
        self._interp_ext = self.cfg.window_size // 2 + 2
        self._interp_extc = self._interp_ext // 2 + 1
        planes = interpolated_planes(upload(self.ref_y, self.device), self._interp_ext)
        self._interp = planes.cpu().numpy()
        self._interp_cb, self._interp_cr = (
            pad_chroma(torch.from_numpy(p), self._interp_extc).numpy()
            for p in (self.ref_cb, self.ref_cr))
        return planes

    def _search_candidates(self, y, plane0):
        """The device's top-ME_TOPK integer candidates of every 8x8 block of
        the frame y as handed in (before the MAXDIFF prefilter), SAD at
        every QP, over ±window_size // 2 against plane 0 of the reference's
        interpolated planes on the device (ops/me.candidates: K2, then K9).
        Read back once: (sads, mvx, mvy) numpy int32, each (nb, ME_TOPK)."""
        src = upload(y, self.device)
        cands = candidates(src, plane0, self._interp_ext, self.cfg.window_size // 2, ME_TOPK)
        sads, mvx, mvy = torch.stack(cands).cpu().numpy()
        return sads, mvx, mvy

    def _filter(self) -> None:
        """The in-loop filter on the finished frame (norm 8.7; intra
        prediction read the unfiltered samples): K8 on the encoder's device
        from the frame's MB state, the quadrant MVs as
        codec/loopfilter._blk_mv reads them."""
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        planes = deblock_frame(*(up(p.astype(np.uint8)) for p in (self.y, self.cb, self.cr)),
                               up(self.mb_intra), up(self.nz_luma), up(self.mv[:, :, 0]),
                               self.qpy, self.qpc)
        self.y, self.cb, self.cr = (p.cpu().numpy().astype(np.int32) for p in planes)

    def _drop_tail_skips(self, first: int, prev_state) -> None:
        """MBs first.. take back the previous frame's samples and MB state."""
        for k in _MB_STATE:
            getattr(self, k)[first:] = prev_state[k][first:]
        self.tc_chroma[:, first:] = prev_state["tc_chroma"][:, first:]
        for mb in range(first, self.nmb):
            x0, y0 = (mb % self.wmb) * 16, (mb // self.wmb) * 16
            self.y[y0: y0 + 16, x0: x0 + 16] = self.ref_y[y0: y0 + 16, x0: x0 + 16]
            cx0, cy0 = x0 // 2, y0 // 2
            self.cb[cy0: cy0 + 8, cx0: cx0 + 8] = self.ref_cb[cy0: cy0 + 8, cx0: cx0 + 8]
            self.cr[cy0: cy0 + 8, cx0: cx0 + 8] = self.ref_cr[cy0: cy0 + 8, cx0: cx0 + 8]

    # ------------------------------------------------------------------
    # nC with the encoder's CBP gating (residual.cpp:87-106 allNeighbouringZero)

    def _nc_pair(self, curr, nbr, luma: bool, c: int) -> int:
        a_same, a_blk, b_same, b_blk = nbr

        def n_of(addr, blk):
            if int(self.mb_type[addr]) == MB_SKIP:
                return 0
            if luma:
                if (int(self.cbp_luma[addr]) & (1 << (blk // 4))) == 0:
                    return 0
                return int(self.tc_luma[addr, blk])
            if (int(self.cbp_chroma[addr]) & 2) == 0:
                return 0
            return int(self.tc_chroma[c, addr, blk])

        nA = nB = None
        if a_same:
            nA = n_of(curr, a_blk)
        elif curr % self.wmb != 0:
            nA = n_of(curr - 1, a_blk)
        if b_same:
            nB = n_of(curr, b_blk)
        elif curr >= self.wmb:
            nB = n_of(curr - self.wmb, b_blk)
        if nA is not None and nB is not None:
            return (nA + nB + 1) >> 1
        if nA is not None:
            return nA
        if nB is not None:
            return nB
        return 0

    def _nc_luma(self, curr: int, blk: int) -> int:
        return self._nc_pair(curr, T.LUMA_NBR[blk], True, -1)

    def _nc_chroma(self, curr: int, c: int, blk: int) -> int:
        return self._nc_pair(curr, T.CHROMA_NBR[blk], False, c)

    # ------------------------------------------------------------------
    # Whole-MB forward transform and quantisation (quantizationTransform,
    # quantizationTransform.cpp:349-486): level arrays

    def _quantize_mb_luma_i16(self, src16, pred16):
        q = encode_host.quantize_residual(
            encode_host.forward_transform_4x4(_blocks_of(src16 - pred16)), self.qpy, True)
        # DC in raster order of the MB's 4x4 blocks
        dc = np.zeros((4, 4), np.int32)
        dc[_BLK_XY[:, 1] // 4, _BLK_XY[:, 0] // 4] = q[:, 0, 0]
        i16dc = encode_host.zigzag_scan(encode_host.forward_dc_luma(dc, self.qpy))
        return i16dc, encode_host.zigzag_scan(q)[:, 1:]

    def _quantize_mb_luma_4x4(self, src16, pred16):
        return encode_host.zigzag_scan(
            encode_host.forward_residual(_blocks_of(src16 - pred16), self.qpy, False))

    def _quantize_mb_chroma(self, src_cb, src_cr, pred_cb, pred_cr):
        """(DC (2, 4), AC (2, 4, 15)) levels of Cb and Cr."""
        diff = np.stack([src_cb - pred_cb, src_cr - pred_cr])
        q = encode_host.forward_residual(_chroma_blocks(diff), self.qpc, True)
        dc = encode_host.forward_dc_chroma(q[:, :, 0, 0].reshape(2, 2, 2), self.qpc)
        return dc.reshape(2, 4), encode_host.zigzag_scan(q)[..., 1:]

    # ------------------------------------------------------------------
    # Reconstruction (the decoder's arithmetic, into the working planes)

    def _reconstruct_luma(self, curr, pred16, residual):
        x0, y0 = (curr % self.wmb) * 16, (curr // self.wmb) * 16
        self.y[y0: y0 + 16, x0: x0 + 16] = np.clip(pred16 + residual, 0, 255)

    def _reconstruct_chroma(self, curr, pred_cb, pred_cr, chroma_dc, chroma_ac):
        x0, y0 = (curr % self.wmb) * 8, (curr // self.wmb) * 8
        res = recon_host.chroma_residual(chroma_dc, chroma_ac, self.qpc)
        self.cb[y0: y0 + 8, x0: x0 + 8] = np.clip(pred_cb + res[0], 0, 255)
        self.cr[y0: y0 + 8, x0: x0 + 8] = np.clip(pred_cr + res[1], 0, 255)

    # ------------------------------------------------------------------
    # Intra (intraPredictionEncoding, intra.cpp:949-1110)

    def _fetch_p13(self, curr, blk):
        return recon_host.fetch_p13(self.y, (curr % self.wmb) * 16, (curr // self.wmb) * 16, blk)

    def _satd(self, src, pred):
        """SATD = Σ|quantised transformed difference| (satdLuma4x4,
        intra.cpp:819-850) of (..., 4, 4) blocks."""
        q = encode_host.forward_residual(src - pred, self.qpy, False)
        return np.abs(q).sum(axis=(-2, -1))

    def _mb_src(self, curr):
        x0, y0 = (curr % self.wmb) * 16, (curr // self.wmb) * 16
        return self.y[y0: y0 + 16, x0: x0 + 16].copy()

    def _mb_src_chroma(self, curr):
        x0, y0 = (curr % self.wmb) * 8, (curr // self.wmb) * 8
        return (self.cb[y0: y0 + 8, x0: x0 + 8].copy(),
                self.cr[y0: y0 + 8, x0: x0 + 8].copy())

    def _intra_mode_decision(self, curr):
        """The exact decision. Returns (i16_mode or -1, chroma_mode, pred16,
        pred_cb, pred_cr, i16dc, i16ac, luma_levels, cdc, cac, prev_flags,
        rem_modes) and leaves the working frame reconstructed for the
        Intra_4x4 candidate when it wins, else restored to the source."""
        src16 = self._mb_src(curr)
        src_cb, src_cr = self._mb_src_chroma(curr)

        # --- Intra_16x16 candidate ---
        x0, y0 = (curr % self.wmb) * 16, (curr // self.wmb) * 16
        p33 = recon_host.fetch_p33(self.y, x0, y0)
        if self._modes is not None:
            best16 = int(self._modes[0][curr])
        else:
            # the first mode of least SATD among the available ones: the
            # reference's trial loop, its SATDs in one batch
            gate = {"top": p33[17] != -1, "left": p33[1] != -1, "corner": p33[0] != -1}
            cands = [m for m in range(4) if gate.get(_I16_GATE.get(m), True)]
            preds = np.stack([_blocks_of(recon_host.predict_16x16(p33, m)) for m in cands])
            satd = self._satd(_blocks_of(src16)[None], preds).sum(axis=1)
            best16 = cands[int(np.argmin(satd))]
        pred16 = recon_host.predict_16x16(p33, best16)
        chroma_mode = int(INTRA16_TO_CHROMA_MODE[best16])
        pred_cb, pred_cr = (
            recon_host.predict_chroma(recon_host.fetch_p17(plane, x0 // 2, y0 // 2), chroma_mode)
            for plane in (self.cb, self.cr))

        # levels and bit cost of the I16 candidate (coded_mb_size)
        i16dc, i16ac = self._quantize_mb_luma_i16(src16, pred16)
        cdc, cac = self._quantize_mb_chroma(src_cb, src_cr, pred_cb, pred_cr)
        cbp_l16, cbp_c16 = _cbp_from_levels(True, i16ac, cdc, cac)
        size16 = self._mb_bit_size(curr, i16_mb_type(best16, cbp_c16, cbp_l16 == 15), True,
                                   None, chroma_mode, i16dc, i16ac, None, cdc, cac,
                                   cbp_l16, cbp_c16)

        # --- Intra_4x4 candidate: per-block mode trial on source neighbours ---
        self.mb_type[curr] = 0
        self.mb_intra[curr] = True
        self.mb_i4x4[curr] = True
        if self._modes is not None:
            modes = self._modes[1][curr].astype(np.int32)
        else:
            # per block, the first mode of least SATD among the available
            # ones (the trial loop's early exit at SATD 0 keeps that mode
            # too). The trial predicts from the working frame, in which
            # this MB still holds the source, so the 16 blocks' trials are
            # independent: one SATD batch for the MB
            p13 = [self._fetch_p13(curr, blk) for blk in range(16)]
            preds = np.zeros((16, 9, 4, 4), np.int32)
            avail = np.zeros((16, 9), bool)
            for blk, p in enumerate(p13):
                gate = {"top": p[5] != -1, "left": p[1] != -1, "corner": p[0] != -1}
                for m in range(9):
                    if gate.get(_I4_GATE.get(m), True):
                        avail[blk, m] = True
                        preds[blk, m] = recon_host.predict_4x4(p, m)
            satd = self._satd(_blocks_of(src16)[:, None], preds)
            modes = np.argmin(np.where(avail, satd, np.iinfo(np.int64).max), axis=1)
            modes = modes.astype(np.int32)
        self.i4x4_mode[curr] = modes

        # reconstruct the 4x4 candidate in place, on reconstructed neighbours
        prev_flags = [False] * 16
        rem_modes = [0] * 16
        luma_levels = np.zeros((16, 16), np.int32)
        pred4_full = np.zeros((16, 16), np.int32)
        for blk in range(16):
            # the predicted mode; constrained_intra_pred_flag is 0
            mpm = recon_host.intra4x4_pred_mode(self.i4x4_mode, self.mb_i4x4, self.wmb, curr, blk)
            mode = int(modes[blk])
            if mode == mpm:
                prev_flags[blk] = True
            else:
                rem_modes[blk] = mode if mode < mpm else mode - 1
            pred = recon_host.predict_4x4(self._fetch_p13(curr, blk), mode)
            bx, by = int(_BLK_XY[blk, 0]), int(_BLK_XY[blk, 1])
            pred4_full[by: by + 4, bx: bx + 4] = pred
            q = encode_host.forward_residual(src16[by: by + 4, bx: bx + 4] - pred,
                                             self.qpy, False)
            luma_levels[blk] = encode_host.zigzag_scan(q)
            res = recon_host.inverse_residual(q, self.qpy, False)
            self.y[y0 + by: y0 + by + 4, x0 + bx: x0 + bx + 4] = np.clip(pred + res, 0, 255)

        cbp_l4, cbp_c4 = _cbp_from_levels(False, luma_levels, cdc, cac)
        size4 = self._mb_bit_size(curr, 0, False, prev_flags, chroma_mode, None, None,
                                  luma_levels, cdc, cac, cbp_l4, cbp_c4)
        if size4 < size16:
            return (-1, chroma_mode, pred4_full, pred_cb, pred_cr,
                    None, None, luma_levels, cdc, cac, prev_flags, rem_modes)
        self.y[y0: y0 + 16, x0: x0 + 16] = src16  # Intra_16x16 wins
        return (best16, chroma_mode, pred16, pred_cb, pred_cr,
                i16dc, i16ac, None, cdc, cac, None, None)

    def _mb_bit_size(self, curr, mb_type, i16, prev_flags, chroma_mode,
                     i16dc, i16ac, luma_levels, cdc, cac, cbp_l, cbp_c) -> int:
        """coded_mb_size of an intra MB (rbsp_encoding.cpp:330-488). Like the
        reference, the CAVLC size pass updates this MB's CBP and TotalCoeff
        state, which the in-MB nC chain reads."""
        total = ue_code(mb_type)[1]
        if not i16:
            total += sum(1 if flag else 4 for flag in prev_flags)
        total += ue_code(chroma_mode)[1]
        if not i16:
            total += ue_code(int(T.CBP_TO_CODENUM_INTRA[(cbp_c << 4) | cbp_l]))[1]
        if cbp_l > 0 or cbp_c > 0 or i16:
            total += 1  # mb_qp_delta = 0
            total += self._residual_bits(curr, i16, i16dc, i16ac, luma_levels, cdc, cac,
                                         cbp_l, cbp_c)
        return total

    def _residual_bits(self, curr, i16, i16dc, i16ac, luma_levels, cdc, cac,
                       cbp_l, cbp_c, writer=None) -> int:
        """residual_write / residual_block_cavlc_size with the TotalCoeff
        state updates; writes the bits with `writer`, and returns their
        count either way."""
        self.cbp_luma[curr] = cbp_l  # the in-MB nC gating reads the CBP
        self.cbp_chroma[curr] = cbp_c
        total = 0

        def emit(levels, nc, maxc):
            nonlocal total
            syms, tc = cavlc.block_symbols(levels.tolist(), nc, maxc)
            total += sum(n for _, n in syms)
            if writer is not None:
                for v, n in syms:
                    writer.write(v, n)
            return tc

        if i16:
            self.tc_luma[curr, 0] = emit(i16dc, self._nc_luma(curr, 0), 16)
        for i8 in range(4):
            if cbp_l & (1 << i8):
                for blk in range(i8 * 4, i8 * 4 + 4):
                    if i16:
                        tc = emit(i16ac[blk], self._nc_luma(curr, blk), 15)
                    else:
                        tc = emit(luma_levels[blk], self._nc_luma(curr, blk), 16)
                    self.tc_luma[curr, blk] = tc
        if cbp_c & 3:
            for c in range(2):
                emit(cdc[c], -1, 4)
        if cbp_c & 2:
            for c in range(2):
                for blk in range(4):
                    self.tc_chroma[c, curr, blk] = emit(cac[c, blk],
                                                        self._nc_chroma(curr, c, blk), 15)
        return total

    def _intra_encode_mb(self, w: BitWriter, curr: int) -> None:
        (i16_mode, chroma_mode, pred16, pred_cb, pred_cr, i16dc, i16ac,
         luma_levels, cdc, cac, prev_flags, rem_modes) = self._intra_mode_decision(curr)
        # I slices only: the P frames' decision never picks an intra MB
        self.mb_intra[curr] = True
        if i16_mode == -1:
            self.mb_type[curr] = 0
            self.mb_i4x4[curr] = True
            cbp_l, cbp_c = _cbp_from_levels(False, luma_levels, cdc, cac)
            write_ue(w, 0)
            for blk in range(16):
                w.write_flag(prev_flags[blk])
                if not prev_flags[blk]:
                    w.write(rem_modes[blk], 3)
            write_ue(w, chroma_mode)
            write_ue(w, int(T.CBP_TO_CODENUM_INTRA[(cbp_c << 4) | cbp_l]))
            if cbp_l > 0 or cbp_c > 0:
                write_se(w, 0)  # mb_qp_delta
                self._residual_bits(curr, False, None, None, luma_levels, cdc, cac,
                                    cbp_l, cbp_c, writer=w)
            else:
                self.cbp_luma[curr] = cbp_l
                self.cbp_chroma[curr] = cbp_c
            self.nz_luma[curr] = luma_levels.any(axis=1)
        else:
            cbp_l, cbp_c = _cbp_from_levels(True, i16ac, cdc, cac)
            raw_type = i16_mb_type(i16_mode, cbp_c, cbp_l == 15)
            self.mb_type[curr] = raw_type
            self.mb_i4x4[curr] = False
            write_ue(w, raw_type)
            write_ue(w, chroma_mode)
            write_se(w, 0)  # mb_qp_delta (always present for Intra_16x16)
            self._residual_bits(curr, True, i16dc, i16ac, None, cdc, cac, cbp_l, cbp_c,
                                writer=w)
            self.nz_luma[curr] = i16ac.any(axis=1) | i16dc.any()
            self._reconstruct_luma(curr, pred16,
                                   recon_host.i16_luma_residual(i16dc, i16ac, self.qpy))
        self._reconstruct_chroma(curr, pred_cb, pred_cr, cdc, cac)

    # ------------------------------------------------------------------
    # Inter (interEncoding structure, moestimation.cpp:392-585; the search
    # is a full integer search plus quarter-pel refinement)

    def _inter_encode_mb(self, curr: int):
        """None for P_Skip, else (mb_type, num_parts, mvds, pred_l, pred_cb,
        pred_cr, luma_levels, cdc, cac, cbp_l, cbp_c) for _write_inter_mb."""
        cfg = self.cfg
        x0, y0 = (curr % self.wmb) * 16, (curr // self.wmb) * 16
        src16 = self._mb_src(curr)
        src_cb, src_cr = self._mb_src_chroma(curr)

        # P_Skip trial (moestimation.cpp:402-425)
        self.mb_type[curr] = MB_SKIP
        self.mb_intra[curr] = False
        self.mb_i4x4[curr] = False
        skip_mv = mvpred.derive_skip_mv(self, curr)
        self.mv[curr, :, :, 0] = skip_mv[0]
        self.mv[curr, :, :, 1] = skip_mv[1]
        pred_l, pred_cb, pred_cr = self._mc_mb(curr)
        if cfg.maxdiff == -1:
            mean = int(src16.sum()) // 256
            maxdiff = max(3, int(np.abs(src16 - mean).sum()) // 256)
        else:
            maxdiff = cfg.maxdiff
        if int((np.abs(src16 - pred_l) <= maxdiff).sum()) == 256:
            # skip: the reconstruction is the prediction (transformDecodingP_Skip)
            self.tc_luma[curr] = 0
            self.tc_chroma[:, curr] = 0
            self.nz_luma[curr] = False
            self.y[y0: y0 + 16, x0: x0 + 16] = np.clip(pred_l, 0, 255)
            cx0, cy0 = x0 // 2, y0 // 2
            self.cb[cy0: cy0 + 8, cx0: cx0 + 8] = np.clip(pred_cb, 0, 255)
            self.cr[cy0: cy0 + 8, cx0: cx0 + 8] = np.clip(pred_cr, 0, 255)
            return None

        part_mv, part_sad = self._search_mb(curr, src16)
        part_mv = self._maybe_unify(curr, src16, part_mv, part_sad)

        # merge into mb_type (moestimation.cpp:529-551)
        mvx, mvy = part_mv[:, 0], part_mv[:, 1]
        if (mvx == mvx[0]).all() and (mvy == mvy[0]).all():
            mb_type = 0
        elif mvx[0] == mvx[1] and mvy[0] == mvy[1] and mvx[2] == mvx[3] and mvy[2] == mvy[3]:
            mb_type = 1
            part_mv = part_mv[[0, 2, 2, 3]]
        elif mvx[0] == mvx[2] and mvy[0] == mvy[2] and mvx[1] == mvx[3] and mvy[1] == mvy[3]:
            mb_type = 2
            part_mv = part_mv[[0, 1, 1, 3]]
        else:
            mb_type = 4  # P_8x8ref0 (the reference's choice)
        num_parts = [1, 2, 2, 4, 4][mb_type]

        # mvd against the spec predictor, earlier partitions in place
        self.mb_type[curr] = mb_type
        mvds = np.zeros((4, 2), np.int32)
        final = np.zeros((4, 2), np.int32)
        for p in range(num_parts):
            px, py = mvpred.predict_mv_luma(self, curr, mb_type, num_parts, p, [0, 0, 0, 0])
            final[p] = part_mv[p]
            mvds[p, 0] = int(part_mv[p, 0]) - px
            mvds[p, 1] = int(part_mv[p, 1]) - py
            mvpred.store_part_mvs(self, curr, mb_type, num_parts, final, p)
        mvpred.store_part_mvs(self, curr, mb_type, num_parts, final, num_parts - 1)
        mvpred.fan_out(self, curr)

        pred_l, pred_cb, pred_cr = self._mc_mb(curr)

        # the lossy MAXDIFF source prefilter (moestimation.cpp:570-584), off
        # from QP 36, where it costs PSNR
        if cfg.lossy_prefilter and self.qpy < 36:
            src16 = np.where(np.abs(src16 - pred_l) < maxdiff, pred_l, src16)
            self.y[y0: y0 + 16, x0: x0 + 16] = src16
            src_cb = np.where(np.abs(src_cb - pred_cb) <= maxdiff, pred_cb, src_cb)
            src_cr = np.where(np.abs(src_cr - pred_cr) <= maxdiff, pred_cr, src_cr)
            cx0, cy0 = x0 // 2, y0 // 2
            self.cb[cy0: cy0 + 8, cx0: cx0 + 8] = src_cb
            self.cr[cy0: cy0 + 8, cx0: cx0 + 8] = src_cr

        luma_levels = self._quantize_mb_luma_4x4(src16, pred_l)
        cdc, cac = self._quantize_mb_chroma(src_cb, src_cr, pred_cb, pred_cr)
        cbp_l, cbp_c = _cbp_from_levels(False, luma_levels, cdc, cac)
        return (mb_type, num_parts, mvds, pred_l, pred_cb, pred_cr,
                luma_levels, cdc, cac, cbp_l, cbp_c)

    def _mc_mb(self, curr):
        """Whole-MB MC from the interpolated planes when the MVs lie in their
        range, else per window (the same samples either way)."""
        mv = self.mv[curr]
        if np.abs(mv).max() <= self._interp_ext * 4 - 4:
            return mc_macroblock_from_planes(
                self._interp, self._interp_cb, self._interp_cr, curr % self.wmb,
                curr // self.wmb, mv, self._interp_ext, self._interp_extc)
        return mc.mc_macroblock(self.ref_y, self.ref_cb, self.ref_cr,
                                curr % self.wmb, curr // self.wmb, mv)

    def _me_metric(self, d):
        """ME distortion: |d| below QP 36, d² from QP 36 and 2 d² from QP 45
        (squared in int64)."""
        if self.qpy >= 36:
            d = d.astype(np.int64)
            return (2 * d * d) if self.qpy >= 45 else (d * d)
        return np.abs(d)

    @property
    def _me_lambda(self) -> int:
        """The |mv - mvp| weight matching the metric's scale."""
        if self.qpy >= 45:
            return 3
        return 2 if self.qpy >= 36 else 1

    def _search_mb(self, curr, src16):
        """Full search per 8x8 quadrant over ±window/2 integer positions,
        cost = distortion + λ·|mv − mvp| (the spec predictor with earlier
        quadrants' choices in place), then with cfg.qpel the quarter-pel
        refinement around two centres: the pure-distortion integer argmin
        and the previous frame's co-located MV. Ties keep the first
        candidate in (dy, dx) raster order. With the device's candidates
        (me="topk") the integer search is their re-ranking by SAD + λ·|mv −
        mvp| (the first least), and centre 1 is their first, the first least
        SAD. Returns ((4, 2) quarter-pel MVs, (4,) float64 costs)."""
        cfg = self.cfg
        W = cfg.window_size // 2
        x0, y0 = (curr % self.wmb) * 16, (curr // self.wmb) * 16
        out = np.zeros((4, 2), np.int32)
        lam = self._me_lambda
        self.mb_type[curr] = 4
        sad_out = np.zeros(4, np.float64)
        sh = np.arange(-W, W + 1) * 4
        pad = W + (4 if cfg.qpel else 0)
        for q in range(4):
            bx, by = (q & 1) * 8, (q >> 1) * 8
            sb = src16[by: by + 8, bx: bx + 8]
            ax, ay = x0 + bx, y0 + by
            mvpx, mvpy = mvpred.predict_mv_luma(self, curr, 4, 4, q, [0, 0, 0, 0])
            if self._me_cands is None:
                win = mc.fetch_window(self.ref_y, ax - pad, ay - pad, 8 + 2 * pad, 8 + 2 * pad)
                cands = sliding_window_view(win, (8, 8))[pad - W: pad + W + 1,
                                                         pad - W: pad + W + 1]
                sads = self._me_metric(cands - sb).sum(axis=(2, 3))
                scores = sads + lam * (np.abs(sh[:, None] - mvpy) + np.abs(sh[None, :] - mvpx))
                iy, ix = np.unravel_index(np.argmin(scores), scores.shape)
                best_mv = ((int(ix) - W) * 4, (int(iy) - W) * 4)
                best_score = float(scores[iy, ix])
                # qpel centre 1: the pure-distortion argmin (independent of
                # the mvp)
                sy, sx = np.unravel_index(np.argmin(sads), sads.shape)
                centre = ((int(sx) - W) * 4, (int(sy) - W) * 4)
            else:
                # the device's candidates of this block, re-ranked with the
                # |mv - mvp| cost (the JAX encoder's _search_mb); slot 0 is
                # the first least SAD, the qpel centre 1
                bi = (ay // 8) * (self.w // 8) + ax // 8
                sads_k, mvx_k, mvy_k = (c[bi] for c in self._me_cands)
                scores = sads_k + lam * (np.abs(mvx_k - mvpx) + np.abs(mvy_k - mvpy))
                j = int(np.argmin(scores))
                best_mv = (int(mvx_k[j]), int(mvy_k[j]))
                best_score = float(scores[j])
                centre = (int(mvx_k[0]), int(mvy_k[0]))
            if cfg.qpel:
                # centre 2: the previous frame's co-located MV, where its
                # whole window lies inside the interpolated planes
                ext = self._interp_ext
                lim = ext * 4 - 4
                centers = [centre]
                p2x, p2y = (int(v) for v in self.prev_mv[curr, q, 0])
                if abs(p2x) <= lim - 3 and abs(p2y) <= lim - 3:
                    centers.append((p2x, p2y))
                # the 49 offsets of each centre in (dy, dx) raster order, all
                # windows gathered from the phase planes at once; the first
                # least cost wins if it beats the integer search's
                mvx = (np.array([c[0] for c in centers])[:, None] + _QPEL_DX).ravel()
                mvy = (np.array([c[1] for c in centers])[:, None] + _QPEL_DY).ravel()
                py = (ay + (mvy >> 2) + ext)[:, None, None] + _AR8[:, None]
                px = (ax + (mvx >> 2) + ext)[:, None, None] + _AR8
                preds = self._interp[((mvy & 3) * 4 + (mvx & 3))[:, None, None], py, px]
                cost = (self._me_metric(preds - sb).sum(axis=(1, 2))
                        + lam * (np.abs(mvx - mvpx) + np.abs(mvy - mvpy))).astype(np.float64)
                k = int(np.argmin(cost))
                if cost[k] < best_score:
                    best_score, best_mv = float(cost[k]), (int(mvx[k]), int(mvy[k]))
            out[q] = best_mv
            sad_out[q] = best_score
            # this quadrant's choice is the next quadrant's predictor input
            mvpred.store_part_mvs(self, curr, 4, 4, out, q)
        return out, sad_out

    def _maybe_unify(self, curr, src16, part_mv, part_sad):
        """Try each quadrant's vector as the one 16x16 MV: unify when one
        covers the MB more cheaply than the split (Σ 8x8 cost against the
        16x16 distortion + λ·|mv − mvp|). Candidates in quadrant order, the
        first of equal vectors kept."""
        if all((part_mv[q] == part_mv[0]).all() for q in range(1, 4)):
            return part_mv
        x0, y0 = (curr % self.wmb) * 16, (curr // self.wmb) * 16
        ext = self._interp_ext
        lim = ext * 4 - 4
        self.mb_type[curr] = 0  # the predictor under P_L0_16x16
        mvp = mvpred.predict_mv_luma(self, curr, 0, 1, 0, None)
        lam = self._me_lambda
        best_u, best_cost = None, float(part_sad.sum())
        for u in dict.fromkeys(tuple(int(v) for v in part_mv[q]) for q in range(4)):
            mvx, mvy = u
            if abs(mvx) > lim or abs(mvy) > lim:
                continue
            frac = (mvy & 3) * 4 + (mvx & 3)
            px = x0 + (mvx >> 2) + ext
            py = y0 + (mvy >> 2) + ext
            pred = self._interp[frac][py: py + 16, px: px + 16]
            cost = (float(self._me_metric(pred - src16).sum())
                    + lam * (abs(mvx - mvp[0]) + abs(mvy - mvp[1])))
            if cost < best_cost:
                best_cost, best_u = cost, u
        if best_u is not None:
            part_mv = part_mv.copy()
            part_mv[:] = best_u
        self.mb_type[curr] = 4
        return part_mv

    def _write_inter_mb(self, w, curr, mb_type, num_parts, mvds, pred_l, pred_cb, pred_cr,
                        luma_levels, cdc, cac, cbp_l, cbp_c) -> None:
        write_ue(w, mb_type)
        if mb_type in (3, 4):
            for _ in range(4):
                write_ue(w, 0)  # sub_mb_type P_L0_8x8 (both P_8x8 kinds)
        for p in range(4 if mb_type in (3, 4) else num_parts):
            write_se(w, int(mvds[p, 0]))
            write_se(w, int(mvds[p, 1]))
        write_ue(w, int(T.CBP_TO_CODENUM_INTER[(cbp_c << 4) | cbp_l]))
        if cbp_l > 0 or cbp_c > 0:
            write_se(w, 0)  # mb_qp_delta
            self._residual_bits(curr, False, None, None, luma_levels, cdc, cac, cbp_l, cbp_c,
                                writer=w)
        else:
            self.cbp_luma[curr] = cbp_l
            self.cbp_chroma[curr] = cbp_c
            self.tc_luma[curr] = 0
            self.tc_chroma[:, curr] = 0
        self.nz_luma[curr] = luma_levels.any(axis=1)
        self._reconstruct_luma(curr, pred_l, recon_host.luma_residual(luma_levels, self.qpy))
        self._reconstruct_chroma(curr, pred_cb, pred_cr, cdc, cac)
