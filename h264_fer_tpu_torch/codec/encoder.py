"""Session encoder: one frame in, one Annex-B slice NAL out, with the
in-loop filter on I and P frames.

The counterpart of h264_fer_tpu/codec/encoder.Encoder in its fully-device
configuration (tpu_pipeline set, tpu_iframe True or "mixed",
tpu_pframe=True): every IDR through codec.iframe (K1t or the mixed frame),
every P frame through codec.pframe.device_p_frame, then the trailing-skip
drop (codec.gop) and, with cfg.deblock, the filter K8 on the whole frame.
It keeps the reference's session logic: the IDR choice (intra_every, and
the scene cut by frame SAD against the reconstruction or, with
scene_cut_source, against the previous source frame), the idr_pic_id /
frame_num / POC state machine of the slice headers, and per-frame stats.

The reference planes and the per-MB state later frames read (the class of
each MB for the stats and the filter's intra test, its coded-block flags
and quadrant MVs) stay on the device. The host reads one payload per frame
(its size and stats, then its used words); with the scene cut on, it also
reads one SAD per frame before choosing the frame type.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..bitstream import nal as nal_mod
from ..bitstream.bitio import BitWriter
from ..bitstream.params import I_SLICE, P_SLICE, PPS, SPS, SliceHeader, parameter_sets
from ..kernels.deblock import deblock_frame
from ..ops import transform
from ..ops.cavlc_bulk import words_to_bytes
from ..ops.device import DEFAULT_DEVICE, resolve_device, upload
from .gop import restore_dropped, trailing_skip_drop
from .iframe import device_i16_frame, device_mixed_frame
from .pframe import device_p_frame

# the stats' MB classes (DohvatiStatistiku): P_L0_16x16, 16x8, 8x16, P_8x8,
# P_8x8ref0, P_Skip, intra
SKIP_CLASS, INTRA_CLASS = 5, 6


@dataclass
class EncoderConfig:
    """The encoder's options, as h264_fer_tpu/codec/encoder.EncoderConfig
    less its `qpel`: the device P frame always refines to quarter pel, as
    the reference's device P frame does whatever `qpel` says."""

    qp: int = 28
    intra_every: int = 100  # forced IDR period (frames)
    window_size: int = 16  # ME search window (full width, +-window_size // 2)
    maxdiff: int = -1  # tolerated error; -1 = per-MB adaptive
    lossy_prefilter: bool = True  # MAXDIFF source prefilter (below QP 36)
    scene_cut_idr: bool = True  # IDR where the frame SAD exceeds 16 per sample
    scene_cut_source: bool = False  # scene-cut SAD against the previous
    # source frame instead of the reconstructed reference
    deblock: bool = False  # in-loop deblocking filter


class Encoder:
    """Session encoder on one device (CUDA by default).

    iframe: "i16" (all-Intra16x16 IDRs) or "mixed" (the exact I4x4-vs-I16
    choice per MB). encode_frame takes uint8 numpy planes y (H, W), cb and
    cr (H/2, W/2) and returns the frame's slice NAL."""

    def __init__(self, width: int, height: int, cfg: EncoderConfig,
                 iframe: str = "i16", device=DEFAULT_DEVICE) -> None:
        if width % 16 or height % 16:
            raise ValueError(f"frame {width}x{height} is not a whole number of MBs")
        if not 0 <= cfg.qp <= 51:
            raise ValueError(f"qp must be in 0..51, got {cfg.qp}")
        if iframe not in ("i16", "mixed"):
            raise ValueError(f"iframe={iframe!r}: 'i16' or 'mixed'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self._iframe = device_mixed_frame if iframe == "mixed" else device_i16_frame
        self.w, self.h = width, height
        self.wmb, self.hmb = width // 16, height // 16
        self.nmb = self.wmb * self.hmb
        self.sps = SPS(pic_width_in_mbs=self.wmb, pic_height_in_map_units=self.hmb)
        self.pps = PPS(pic_init_qp=14 + cfg.qp,
                       deblocking_filter_control_present_flag=int(cfg.deblock))
        self.qpy = cfg.qp
        self.qpc = transform.chroma_qp(self.qpy, self.pps.chroma_qp_index_offset)
        # slice-header state (encoder._encode_slice)
        self.frame_num = 0
        self.idr_pic_id = 0
        self.poc_lsb = 0
        self.first_frame = True
        self.curr_frame_count = 0
        self.stats = []  # per frame: bytes, ms, idr, mb_types
        # on the device: the reference planes (the last frame as decoders
        # hold it, filtered), the previous source luma, and per MB its class
        # (0..6), coded-block flags (Z-scan) and quadrant MVs
        self._ref = None
        self._prev_src = None
        self._mb_class = self._nz = self._mv = None

    def headers(self) -> bytes:
        return parameter_sets(self.sps, self.pps)

    def encode_sequence(self, frames) -> bytes:
        out = bytearray(self.headers())
        for y, cb, cr in frames:
            out += self.encode_frame(y, cb, cr)
        return bytes(out)

    def reconstructed(self):
        """The last frame's reconstruction as the decoder holds it (after
        the trailing-skip drop and the filter): uint8 numpy planes."""
        return tuple(p.cpu().numpy() for p in self._ref)

    def _is_idr(self, y) -> bool:
        """selectNALUnitType (encoder._select_nal_unit_type): the first frame
        and every intra_every-th are IDRs; so is a frame whose luma SAD
        against the reference (or the previous source frame) exceeds 16 per
        sample. The SAD is summed in int64 on the device."""
        if self._ref is None or self.curr_frame_count % self.cfg.intra_every == 0:
            return True
        if not self.cfg.scene_cut_idr:
            return False
        ref = self._prev_src if self.cfg.scene_cut_source else self._ref[0]
        sad = (y.to(torch.int64) - ref.to(torch.int64)).abs().sum()
        return int(sad) > (self.nmb << 12)

    def _slice_header(self, is_idr: bool) -> BitWriter:
        """The slice header of the next frame, written: the reference's
        state machine (rbsp_encoding.cpp:139-173)."""
        if is_idr:
            if self.first_frame:
                self.first_frame = False
                self.idr_pic_id = 0
            elif self.frame_num == 0:  # an IDR right after an IDR
                self.idr_pic_id += 1
            else:
                self.idr_pic_id = 0
            self.frame_num = 0
            self.poc_lsb = 0
        else:
            self.frame_num += 1
            self.poc_lsb += 2
        shd = SliceHeader(
            slice_type=I_SLICE if is_idr else P_SLICE,
            frame_num=self.frame_num & (self.sps.max_frame_num - 1),
            idr_pic_id=self.idr_pic_id,
            pic_order_cnt_lsb=self.poc_lsb & ((1 << self.sps.log2_max_pic_order_cnt_lsb) - 1),
            slice_qp_delta=-14,
            disable_deblocking_filter_idc=0 if self.cfg.deblock else 1)
        w = BitWriter()
        shd.write(w, self.sps, self.pps, nal_mod.NAL_IDR if is_idr else nal_mod.NAL_NOT_IDR, 1)
        return w

    def _idr(self, y, cb, cr):
        """Code an IDR; returns its payload dict."""
        out = self._iframe(y, cb, cr, self.qpy, self.qpc, deblock=self.cfg.deblock)
        self._ref = (out["recon_y"], out["recon_cb"], out["recon_cr"])
        self._mb_class = torch.full((self.nmb,), INTRA_CLASS, dtype=torch.int32,
                                    device=self.device)
        self._nz = out["nz_luma"]
        self._mv = torch.zeros((self.nmb, 4, 2), dtype=torch.int32, device=self.device)
        return out

    def _p_frame(self, y, cb, cr, hdr_bits: int):
        """Code a P frame (encoder._device_pframe_encode_full): the device P
        frame, then the trailing-skip drop, which restores the previous
        frame's (filtered) samples and its MB state at the MBs decoders never
        read, then the filter on the whole frame, which reads that restored
        state. Returns its payload dict."""
        cfg = self.cfg
        out = device_p_frame(y, cb, cr, *self._ref, self._mv, cfg.window_size // 2,
                             self.qpy, self.qpc, cfg.maxdiff,
                             bool(cfg.lossy_prefilter and self.qpy < 36))
        keep = trailing_skip_drop(out["skip"], out["nbits"], out["trail_bits"], hdr_bits)
        ry, rcb, rcr, self._mv = restore_dropped(keep, (*self._ref, self._mv), out)
        mb_class = torch.where(out["skip"], SKIP_CLASS, out["raw_type"].clamp(max=4))
        self._mb_class = torch.where(keep, self._mb_class, mb_class).to(torch.int32)
        self._nz = torch.where(keep[:, None], self._nz, out["nz_luma"])
        if cfg.deblock:
            ry, rcb, rcr = deblock_frame(ry, rcb, rcr, self._mb_class == INTRA_CLASS,
                                         self._nz, self._mv, self.qpy, self.qpc)
        self._ref = (ry, rcb, rcr)
        return out

    def encode_frame(self, y, cb, cr) -> bytes:
        """Encode one frame (uint8 numpy planes); returns its slice NAL."""
        t0 = time.time()
        y, cb, cr = (upload(p, self.device) for p in (y, cb, cr))
        is_idr = self._is_idr(y)
        self._prev_src = y
        self.curr_frame_count += 1
        w = self._slice_header(is_idr)
        if is_idr:
            out = self._idr(y, cb, cr)
        else:
            out = self._p_frame(y, cb, cr, w.bit_position)
        # one transfer for the payload size and the MB-class histogram, one
        # for the payload's used words
        head = torch.cat([out["nbits"].reshape(1).to(torch.int64),
                          torch.bincount(self._mb_class, minlength=7).to(torch.int64)])
        nbits, *mb_types = (int(v) for v in head.cpu())
        words = out["words"][: (nbits + 63) // 64].cpu().numpy()
        w.append_bits(words_to_bytes(words, nbits), nbits)
        w.rbsp_trailing_bits()
        nal = nal_mod.write_nal_unit(
            1, nal_mod.NAL_IDR if is_idr else nal_mod.NAL_NOT_IDR, w.getvalue())
        self.stats.append({"bytes": len(nal), "ms": (time.time() - t0) * 1000.0,
                           "idr": is_idr, "mb_types": mb_types})
        return nal
