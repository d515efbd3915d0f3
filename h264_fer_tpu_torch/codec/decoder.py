"""H.264 Baseline decoder: host parse and reconstruction, the in-loop
filter (K8) on the card.

The counterpart of h264_fer_tpu/codec/decoder.py, a bit-exact
re-implementation of the reference decoder's behavior
(rbsp_decoding.cpp:17-367), including its deliberate deviations from the
norm where they affect output:

- `more_rbsp_data` is the byte-count approximation (rbsp_IO.cpp:193).
- mb_qp_delta is a *persistent* variable: the QPy update runs for skipped
  and residual-free MBs using the stale value (rbsp_decoding.cpp:111,322).
- Sub-8x8 partition MVs are collapsed to the 8x8 partition MV after
  prediction (mode_pred.cpp DeriveMVs:470-482 copies [i][0] over [i][j]).
- The half-pel filter chains clipped intermediates for the center positions
  (mocomp.cpp Tap6Filter on already-Bordered values).
- Non-skip MBs without residual re-apply the last parsed chroma AC levels
  (the reference's stale ChromaACLevel) unless the slice is decoded in the
  spec-correct mode: a slice that signals the filter under deblock=True,
  or every slice under spec_mode=True.
- No deblocking by default (the reference has none); with deblock=True the
  filter runs where the stream signals it.

CAVLC is bit-serial and every MB's prediction reads its reconstructed
neighbours, so the slice loop is host work, as in the reference: native
C++ by default (native/decoder_native.cpp, built by g++ on first use), or
the Python form below (native=False), its semantic reference. The filter
is the port's K8 (kernels/deblock.deblock_frame): on the card for
device="cuda", its plain PyTorch twin for device="cpu".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream import nal as nal_mod
from ..bitstream.bitio import BitReader
from ..bitstream.expgolomb import read_se, read_te, read_ue
from ..bitstream.params import I_SLICE, P_SLICE, PPS, SPS, SliceHeader
from ..kernels.deblock import deblock_frame
from ..ops import cavlc, mc, recon_host
from ..ops import tables as T
from ..ops.device import DEFAULT_DEVICE, resolve_device
from ..ops.interp import interpolated_planes, mc_macroblock_from_planes, pad_chroma
from ..ops.transform import chroma_qp
from . import mvpred

MB_SKIP = -2
# full-pel extent of the Python form's interpolated planes (decoder.py:193)
# and of its padded chroma
INTERP_EXT = 40
INTERP_EXT_C = INTERP_EXT // 2 + 1


@dataclass
class MbClass:
    is_intra: bool
    is_i4x4: bool = False
    is_i16x16: bool = False
    i16_mode: int = 0
    cbp_luma_fixed: int | None = None  # for I16x16
    cbp_chroma_fixed: int | None = None
    num_parts: int = 1
    part_w: int = 16
    part_h: int = 16


def classify_mb(mb_type: int, slice_type: int) -> MbClass:
    """Decode raw mb_type per norm Tables 7-11/7-13 (h264_globals.cpp:25-132)."""
    if slice_type % 5 == P_SLICE:
        if mb_type < 5:
            widths = [(1, 16, 16), (2, 16, 8), (2, 8, 16), (4, 8, 8), (4, 8, 8)]
            n, w, h = widths[mb_type]
            return MbClass(False, num_parts=n, part_w=w, part_h=h)
        i_type = mb_type - 5
    else:
        i_type = mb_type
    if i_type == 0:
        return MbClass(True, is_i4x4=True)
    if i_type == 25:
        raise NotImplementedError("I_PCM not supported (matches reference)")
    n = i_type - 1
    return MbClass(True, is_i16x16=True, i16_mode=n % 4,
                   cbp_chroma_fixed=(n // 4) % 3, cbp_luma_fixed=15 if n >= 12 else 0)


# Z-scan luma block geometry
_BLK_XY = T.INTRA4X4_SCAN_ORDER_XY  # (16, 2): x, y pixel offsets


class Decoder:
    """Stateful session decoder mirroring the reference's global state.

    deblock: apply the in-loop filter where the stream signals it (default
    False: the reference decoder's behavior; it has no filter). device: where
    the filter runs (CUDA by default; raises when no card is visible).
    native: the C++ slice loop (default), or False for the Python form.
    spec_mode: decode every slice in the spec-correct mode, where a residual-
    free MB has zero chroma AC levels, as the encoders reconstruct it; by
    default only slices that are filtered get it."""

    def __init__(self, deblock: bool = False, *, device=DEFAULT_DEVICE,
                 native: bool = True, spec_mode: bool = False) -> None:
        self.device = resolve_device(device)
        self.deblock = deblock
        self.spec_mode = spec_mode
        self._lib = None
        if native:
            from ..native import load

            self._lib = load()
        self.sps: SPS | None = None
        self.pps: PPS | None = None
        self.mb_qp_delta = 0  # persistent across MBs/frames (reference quirk)
        self.frame_count = 0

    # -- frame geometry ----------------------------------------------------
    def _alloc(self) -> None:
        sps = self.sps
        self.wmb = sps.pic_width_in_mbs
        self.hmb = sps.pic_height_in_map_units
        self.nmb = self.wmb * self.hmb
        w, h = self.wmb * 16, self.hmb * 16
        self.y = np.zeros((h, w), np.int32)
        self.cb = np.zeros((h // 2, w // 2), np.int32)
        self.cr = np.zeros((h // 2, w // 2), np.int32)
        self.ref_y = None  # DPB depth 1 (ref_frames.cpp:14)
        self.ref_cb = None
        self.ref_cr = None
        # Persistent chroma-AC state replicating the reference quirk:
        # clear_residual_structures (residual.cpp:28-49) zeroes every level
        # array EXCEPT ChromaACLevel, so non-skip CBP==0 macroblocks re-apply
        # the stale chroma AC residual of the last residual-carrying MB
        # (P_Skip passes local zero arrays, transformDecodingP_Skip,
        # inttransform.cpp:215-229, and is unaffected).
        self.stale_chroma_ac = np.zeros((2, 4, 15), np.int32)
        self.mb_type = np.zeros(self.nmb, np.int32)  # raw slice mb_type / MB_SKIP
        self.mb_intra = np.zeros(self.nmb, bool)
        self.mb_i4x4 = np.zeros(self.nmb, bool)
        self.tc_luma = np.zeros((self.nmb, 16), np.int32)
        self.tc_chroma = np.zeros((2, self.nmb, 4), np.int32)
        self.i4x4_mode = np.zeros((self.nmb, 16), np.int32)
        self.mv = np.zeros((self.nmb, 4, 4, 2), np.int32)
        self.num_parts = np.ones(self.nmb, np.int32)

    # -- public API --------------------------------------------------------
    def decode_annexb(self, data: bytes):
        """Yield (y, cb, cr) uint8 numpy frames of an Annex-B stream."""
        for u in nal_mod.iter_nal_units(data):
            fr = self.decode_nal(u)
            if fr is not None:
                yield fr

    def decode_nal(self, u: nal_mod.NalUnit):
        if u.nal_unit_type == nal_mod.NAL_SPS:
            self.sps = SPS.parse(BitReader(u.rbsp))
            self._alloc()
            return None
        if u.nal_unit_type == nal_mod.NAL_PPS:
            self.pps = PPS.parse(BitReader(u.rbsp))
            return None
        if u.nal_unit_type in (nal_mod.NAL_IDR, nal_mod.NAL_NOT_IDR):
            return self._decode_slice(u)
        return None  # SEI etc: ignored like the reference

    # -- slice decode ------------------------------------------------------
    def _filtered(self, shd) -> bool:
        return bool(self.deblock and self.pps.deblocking_filter_control_present_flag
                    and shd.disable_deblocking_filter_idc != 1)

    def _decode_slice(self, u: nal_mod.NalUnit):
        self.frame_count += 1
        r = BitReader(u.rbsp)
        shd = SliceHeader.parse(r, self.sps, self.pps, u.nal_unit_type, u.nal_ref_idc)
        self.shd = shd
        # Spec-correct mode for deblock-signaled slices we filter: such
        # streams cannot come from the reference (it has no filter), so the
        # stale-ChromaACLevel quirk must NOT apply (the producing encoder
        # reconstructs with clean zero levels).
        self._spec_mode = self.spec_mode or self._filtered(shd)
        slice_type = shd.slice_type
        self.qpy = shd.slice_qp_y(self.pps)

        if self._lib is not None:
            from ..native import decode_slice_native

            self.qpy = decode_slice_native(self._lib, self, u.rbsp, r.bit_position,
                                           shd, self._spec_mode)
            return self._finish_frame(shd)

        self._interp = None
        if slice_type % 5 != I_SLICE:
            if self.ref_y is None:
                raise ValueError("P slice without reference frame")
            # the 16 interpolated phases of the reference, once per frame,
            # and the padded chroma: MVs beyond them take the window path
            self._interp = interpolated_planes(torch.from_numpy(self.ref_y),
                                               INTERP_EXT).numpy()
            self._interp_cb = pad_chroma(torch.from_numpy(self.ref_cb), INTERP_EXT_C).numpy()
            self._interp_cr = pad_chroma(torch.from_numpy(self.ref_cr), INTERP_EXT_C).numpy()

        curr = 0
        more_data = True
        while more_data and curr < self.nmb:
            if slice_type % 5 != I_SLICE:
                skip_run = read_ue(r)
                for _ in range(skip_run):
                    if curr >= self.nmb:
                        break
                    self._decode_skip_mb(curr)
                    curr += 1
                if curr != 0 or skip_run > 0:
                    more_data = r.more_rbsp_data()
            if more_data:
                self._decode_mb(r, curr, slice_type)
                more_data = r.more_rbsp_data()
                curr += 1

        return self._finish_frame(shd)

    def _finish_frame(self, shd):
        """Filter the frame where the slice signals it (K8 on the decoder's
        state: intra flags, nz_luma = tc_luma > 0, the quadrant MVs, the QPy
        after the slice's last MB), make it the reference (DPB depth 1,
        ref_frames.cpp:17-35,93-183) and return it as uint8 planes."""
        planes = (self.y.astype(np.uint8), self.cb.astype(np.uint8),
                  self.cr.astype(np.uint8))  # reconstruction is clipped to 0..255
        if self._filtered(shd):
            dev = self.device

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            self.nz_luma = self.tc_luma > 0
            self.qpc = chroma_qp(self.qpy, self.pps.chroma_qp_index_offset)
            out = deblock_frame(*(up(p) for p in planes), up(self.mb_intra),
                                up(self.nz_luma), up(self.mv[:, :, 0]), self.qpy, self.qpc)
            planes = tuple(p.cpu().numpy() for p in out)
            self.y, self.cb, self.cr = (p.astype(np.int32) for p in planes)
        self.ref_y = self.y.copy()
        self.ref_cb = self.cb.copy()
        self.ref_cr = self.cr.copy()
        return planes

    def _mc_mb(self, curr: int):
        mv = self.mv[curr]
        mb_x, mb_y = curr % self.wmb, curr // self.wmb
        if np.abs(mv).max() <= INTERP_EXT * 4 - 4:
            return mc_macroblock_from_planes(
                self._interp, self._interp_cb, self._interp_cr, mb_x, mb_y, mv,
                INTERP_EXT, INTERP_EXT_C)
        return mc.mc_macroblock(self.ref_y, self.ref_cb, self.ref_cr, mb_x, mb_y, mv)

    # -- P_Skip ------------------------------------------------------------
    def _decode_skip_mb(self, curr: int) -> None:
        self.mb_type[curr] = MB_SKIP
        self.mb_intra[curr] = False
        self.mb_i4x4[curr] = False
        self.num_parts[curr] = 1
        self.tc_luma[curr] = 0
        self.tc_chroma[:, curr] = 0
        mv = mvpred.derive_skip_mv(self, curr)  # mode_pred.cpp:381-406
        self.mv[curr, :, :, 0] = mv[0]
        self.mv[curr, :, :, 1] = mv[1]
        pred_l, pred_cb, pred_cr = self._mc_mb(curr)
        # QPy update with (possibly stale) mb_qp_delta (rbsp_decoding.cpp:111)
        self.qpy = (self.qpy + self.mb_qp_delta + 52) % 52
        self._reconstruct_inter(curr, pred_l, pred_cb, pred_cr,
                                luma_levels=np.zeros((16, 16), np.int32),
                                chroma_dc=np.zeros((2, 4), np.int32),
                                chroma_ac=np.zeros((2, 4, 15), np.int32), cbp_luma=0)

    # -- full MB -----------------------------------------------------------
    def _decode_mb(self, r: BitReader, curr: int, slice_type: int) -> None:
        mb_type = read_ue(r)
        if mb_type > 31 or (slice_type % 5 == I_SLICE and mb_type > 24):
            raise ValueError(f"bad mb_type {mb_type} at MB {curr}")
        cls = classify_mb(mb_type, slice_type)
        self.mb_type[curr] = mb_type
        self.mb_intra[curr] = cls.is_intra
        self.mb_i4x4[curr] = cls.is_i4x4
        self.num_parts[curr] = cls.num_parts

        sub_mb_type = [0] * 4
        mvd = np.zeros((4, 4, 2), np.int32)
        prev_mode_flag = [False] * 16
        rem_mode = [0] * 16
        chroma_mode = 0

        if (not cls.is_intra) and cls.num_parts == 4:
            # sub_mb_pred (rbsp_decoding.cpp:145-176)
            for p in range(4):
                sub_mb_type[p] = read_ue(r)
            for p in range(4):
                if self.shd.num_ref_idx_active_override_flag > 0 and mb_type != 4:
                    read_te(r, self.pps.num_ref_idx_l0_active)  # ref_idx, ignored
            for p in range(4):
                for sp in range(int(T.SUB_MB_NUM_PARTS[sub_mb_type[p]])):
                    mvd[p, sp, 0] = read_se(r)
                    mvd[p, sp, 1] = read_se(r)
        elif cls.is_intra:
            if cls.is_i4x4:
                for b in range(16):
                    prev_mode_flag[b] = bool(r.read_bit())
                    if not prev_mode_flag[b]:
                        rem_mode[b] = r.read(3)
            chroma_mode = read_ue(r)
            if chroma_mode > 3:
                raise ValueError(f"bad intra_chroma_pred_mode {chroma_mode}")
        else:
            for p in range(cls.num_parts):
                if self.shd.num_ref_idx_l0_active_minus1 > 0:
                    read_te(r, self.pps.num_ref_idx_l0_active)
            for p in range(cls.num_parts):
                mvd[p, 0, 0] = read_se(r)
                mvd[p, 0, 1] = read_se(r)

        # CBP (rbsp_decoding.cpp:240-296)
        if not cls.is_i16x16:
            code_num = read_ue(r)
            if code_num > 47:
                raise ValueError(f"bad coded_block_pattern codeNum {code_num}")
            table = T.CODENUM_TO_CBP_INTRA if cls.is_i4x4 else T.CODENUM_TO_CBP_INTER
            cbp = int(table[code_num])
            cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        else:
            cbp_luma, cbp_chroma = cls.cbp_luma_fixed, cls.cbp_chroma_fixed

        # residual
        i16dc = np.zeros(16, np.int32)
        luma_levels = np.zeros((16, 16), np.int32)  # AC lists for i16, else full
        chroma_dc = np.zeros((2, 4), np.int32)
        if cbp_luma > 0 or cbp_chroma > 0 or cls.is_i16x16:
            self.mb_qp_delta = read_se(r)
            if not (-27 < self.mb_qp_delta < 26):
                raise ValueError(f"bad mb_qp_delta {self.mb_qp_delta}")
            self._parse_residual(r, curr, cls, cbp_luma, cbp_chroma, i16dc, luma_levels,
                                 chroma_dc, self.stale_chroma_ac)
        else:
            # clear_residual_structures: chroma AC stays STALE (see _alloc),
            # except in the spec-correct mode, where absent residual means
            # zero levels
            self.tc_luma[curr] = 0
            self.tc_chroma[:, curr] = 0
            if self._spec_mode:
                self.stale_chroma_ac[:] = 0
        chroma_ac = self.stale_chroma_ac

        self.qpy = (self.qpy + self.mb_qp_delta + 52) % 52

        # prediction + reconstruction
        if cls.is_intra:
            self._reconstruct_intra(curr, cls, prev_mode_flag, rem_mode, chroma_mode,
                                    i16dc, luma_levels, chroma_dc, chroma_ac)
        else:
            self._derive_inter_mv(curr, mb_type, cls, sub_mb_type, mvd)
            pred_l, pred_cb, pred_cr = self._mc_mb(curr)
            self._reconstruct_inter(curr, pred_l, pred_cb, pred_cr, luma_levels,
                                    chroma_dc, chroma_ac, cbp_luma)

    # -- residual parsing (residual.cpp:959-1066) --------------------------
    def _parse_residual(self, r, curr, cls, cbp_luma, cbp_chroma, i16dc,
                        luma_levels, chroma_dc, chroma_ac) -> None:
        block = cavlc.decode_residual_block
        if cls.is_i16x16:
            levels, tc = block(r, self._nc_luma(curr, 0), 0, 15, 16)
            i16dc[:] = levels
            self.tc_luma[curr, 0] = tc
        for i8 in range(4):
            for i4 in range(4):
                blk = i8 * 4 + i4
                if cbp_luma & (1 << i8):
                    if cls.is_i16x16:
                        levels, tc = block(r, self._nc_luma(curr, blk), 0, 14, 15)
                        luma_levels[blk, :15] = levels
                    else:
                        levels, tc = block(r, self._nc_luma(curr, blk), 0, 15, 16)
                        luma_levels[blk] = levels
                    self.tc_luma[curr, blk] = tc
                else:
                    self.tc_luma[curr, blk] = 0
        for c in range(2):
            if cbp_chroma & 3:
                levels, _ = block(r, -1, 0, 3, 4)
                chroma_dc[c] = levels
        for c in range(2):
            for blk in range(4):
                if cbp_chroma & 2:
                    levels, tc = block(r, self._nc_chroma(curr, c, blk), 0, 14, 15)
                    chroma_ac[c, blk] = levels
                    self.tc_chroma[c, curr, blk] = tc
                else:
                    chroma_ac[c, blk] = 0  # residual() zeroes parsed-path AC
                    self.tc_chroma[c, curr, blk] = 0

    # -- nC derivation (residual.cpp:1090-1185) ----------------------------
    def _nc_pair(self, curr, nbr, tc_arr) -> int:
        a_same, a_blk, b_same, b_blk = nbr
        nA = nB = None
        if a_same:
            nA = int(tc_arr[curr, a_blk])
        elif curr % self.wmb != 0:
            nA = int(tc_arr[curr - 1, a_blk])
        if b_same:
            nB = int(tc_arr[curr, b_blk])
        elif curr >= self.wmb:
            nB = int(tc_arr[curr - self.wmb, b_blk])
        if nA is not None and nB is not None:
            return (nA + nB + 1) >> 1
        if nA is not None:
            return nA
        if nB is not None:
            return nB
        return 0

    def _nc_luma(self, curr: int, blk: int) -> int:
        return self._nc_pair(curr, T.LUMA_NBR[blk], self.tc_luma)

    def _nc_chroma(self, curr: int, c: int, blk: int) -> int:
        return self._nc_pair(curr, T.CHROMA_NBR[blk], self.tc_chroma[c])

    # -- MV derivation (codec/mvpred.py) -------------------------------------
    def _derive_inter_mv(self, curr, mb_type, cls, sub_mb_type, mvd) -> None:
        """PredictMV + DeriveMVs for non-skip inter MBs
        (mode_pred.cpp:408-483). Sub-8x8 MVs collapse to the 8x8 MV
        (reference quirk)."""
        part_mv = np.zeros((4, 2), np.int32)
        for p in range(cls.num_parts):
            px, py = mvpred.predict_mv_luma(self, curr, mb_type, cls.num_parts, p,
                                            sub_mb_type)
            part_mv[p, 0] = px + int(mvd[p, 0, 0])
            part_mv[p, 1] = py + int(mvd[p, 0, 1])
            # store incrementally: later partitions may reference earlier ones
            mvpred.store_part_mvs(self, curr, mb_type, cls.num_parts, part_mv, p)
        mvpred.store_part_mvs(self, curr, mb_type, cls.num_parts, part_mv,
                              cls.num_parts - 1)
        mvpred.fan_out(self, curr)

    # -- reconstruction ----------------------------------------------------
    def _mb_origin(self, curr: int):
        return (curr % self.wmb) * 16, (curr // self.wmb) * 16

    def _reconstruct_inter(self, curr, pred_l, pred_cb, pred_cr, luma_levels,
                           chroma_dc, chroma_ac, cbp_luma) -> None:
        """Inter luma: per-4x4 inverse residual + clip (8.5.1); chroma per
        8.5.4. All-zero levels (P_Skip and residual-less MBs) short-circuit
        to the prediction, which MC has clipped already."""
        x0, y0 = self._mb_origin(curr)
        if cbp_luma == 0 or not luma_levels.any():
            out = pred_l
        else:
            out = np.clip(pred_l + recon_host.luma_residual(luma_levels, self.qpy), 0, 255)
        self.y[y0: y0 + 16, x0: x0 + 16] = out
        self._reconstruct_chroma(curr, pred_cb, pred_cr, chroma_dc, chroma_ac)

    def _reconstruct_chroma(self, curr, pred_cb, pred_cr, chroma_dc, chroma_ac) -> None:
        """transformDecodingChroma (inttransform.cpp:237-321), both channels
        and their 4 blocks at once."""
        x0, y0 = self._mb_origin(curr)
        ys, xs = slice(y0 // 2, y0 // 2 + 8), slice(x0 // 2, x0 // 2 + 8)
        if not (chroma_dc.any() or chroma_ac.any()):
            self.cb[ys, xs] = pred_cb
            self.cr[ys, xs] = pred_cr
            return
        qpc = chroma_qp(self.qpy, self.pps.chroma_qp_index_offset)
        res = recon_host.chroma_residual(chroma_dc, chroma_ac, qpc)
        self.cb[ys, xs] = np.clip(pred_cb + res[0], 0, 255)
        self.cr[ys, xs] = np.clip(pred_cr + res[1], 0, 255)

    def _reconstruct_intra(self, curr, cls, prev_mode_flag, rem_mode, chroma_mode,
                           i16dc, luma_levels, chroma_dc, chroma_ac) -> None:
        x0, y0 = self._mb_origin(curr)
        qpy = self.qpy
        if cls.is_i4x4:
            # the residuals do not depend on the neighbours: one batched
            # inverse transform for all 16 blocks; only predict + add
            # interleave per block (intra.cpp:770-797)
            res16 = recon_host.inverse_residual(recon_host.zigzag_unscan(luma_levels),
                                                qpy, False)
            for blk in range(16):
                mode = self._derive_i4x4_mode(curr, blk, prev_mode_flag[blk], rem_mode[blk])
                self.i4x4_mode[curr, blk] = mode
                pred = recon_host.predict_4x4(recon_host.fetch_p13(self.y, x0, y0, blk), mode)
                bx, by = int(_BLK_XY[blk, 0]), int(_BLK_XY[blk, 1])
                self.y[y0 + by: y0 + by + 4, x0 + bx: x0 + bx + 4] = \
                    np.clip(pred + res16[blk], 0, 255)
        else:
            pred = recon_host.predict_16x16(recon_host.fetch_p33(self.y, x0, y0), cls.i16_mode)
            res = recon_host.i16_luma_residual(i16dc, luma_levels[:, :15], qpy)
            self.y[y0: y0 + 16, x0: x0 + 16] = np.clip(pred + res, 0, 255)

        self._reconstruct_chroma(curr, *(
            recon_host.predict_chroma(recon_host.fetch_p17(plane, x0 // 2, y0 // 2), chroma_mode)
            for plane in (self.cb, self.cr)), chroma_dc, chroma_ac)

    def _derive_i4x4_mode(self, curr, blk, prev_flag, rem) -> int:
        """getIntra4x4PredMode (intra.cpp:77-135)."""
        pred_mode = recon_host.intra4x4_pred_mode(
            self.i4x4_mode, self.mb_i4x4, self.wmb, curr, blk,
            self.pps.constrained_intra_pred_flag)
        if prev_flag:
            return pred_mode
        return rem if rem < pred_mode else rem + 1
