"""Session encoder: one frame in, one Annex-B slice NAL out, with the
in-loop filter on I and P frames.

The counterpart of h264_fer_tpu/codec/encoder.Encoder. Each frame type
runs on the host or on the device, as the JAX encoder's flags choose:

- I frames: iframe="i16" or "mixed" (tpu_iframe True or "mixed") through
  codec.iframe (K1t, or the mixed frame's K7 and K6), or iframe="host"
  (both off) through the host per-MB encoder codec.encoder_host, the
  reference's exact decision, whose modes come from the device
  (codec.intra_decision, on the card) with device_modes=True
  (tpu_pipeline without tpu_iframe).
- P frames: pframe="device" (tpu_pframe=True) through
  codec.pframe.device_p_frame, then the trailing-skip drop (codec.gop)
  and, with cfg.deblock, the filter K8 on the whole frame; or
  pframe="host" (tpu_pframe off) through codec.encoder_host, which drops
  and filters (K8) in the same order. me="topk" (tpu_me, the CLI's
  --tpu-me) gives the host P frames' integer search the device's top-16
  SAD candidates per 8x8 block (ops/me.py, K2 and K9), over
  ±window_size // 2. Device P frames never read them: their bytes are the
  same either way, so they search none.

It keeps the reference's session logic: the IDR choice (intra_every, and
the scene cut by frame SAD against the reconstruction or, with
scene_cut_source, against the previous source frame), the idr_pic_id /
frame_num / POC state machine of the slice headers, and per-frame stats.

The reference frame and the per-MB state later frames read live where the
P frames run. With device P frames they stay on the device (the planes,
and per MB its class for the stats and the filter's intra test, its
coded-block flags and quadrant MVs), in static tensors that two device
programs (codec/program.py) update in place: the IDR with its filter, and
the P frame with the trailing-skip drop, the state updates and the filter;
on a card each is one CUDA graph, replayed once a frame. Between replays
the host reads one payload per frame (its size and stats, then its used
words) and, with the scene cut on, one SAD. A host I frame uploads its
reconstruction and state into those tensors for the device P frame after
it. With host P frames they stay in the HostEncoder's numpy
arrays, and a device I frame hands its reconstruction and syntax state to
the host (the JAX encoder's _materialize).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream import nal as nal_mod
from ..bitstream.bitio import BitWriter
from ..bitstream.params import I_SLICE, P_SLICE, PPS, SPS, SliceHeader, parameter_sets
from ..kernels.deblock import deblock_frame
from ..ops import transform
from ..ops.cavlc_bulk import words_to_bytes
from ..ops.device import DEFAULT_DEVICE, resolve_device, upload, upload_into
from .encoder_host import INTRA_CLASS, SKIP_CLASS, HostEncoder
from .gop import restore_dropped, trailing_skip_drop
from .iframe import device_i16_frame, device_mixed_frame
from .intra_decision import intra_mode_decision
from .pframe import device_p_frame
from .program import DeviceProgram, fill, planes, program

_DEVICE_IFRAMES = {"i16": device_i16_frame, "mixed": device_mixed_frame}


def _head(nbits, mb_class):
    """(8,) int64: the payload's bit count, then the MB-class histogram
    (classes 0..6), as one tensor for one read-back."""
    classes = torch.arange(7, dtype=torch.int32, device=mb_class.device)
    hist = (mb_class[:, None] == classes).sum(dim=0)
    return torch.cat([nbits.reshape(1).to(torch.int64), hist.to(torch.int64)])


@dataclass
class EncoderConfig:
    """The encoder's options, as h264_fer_tpu/codec/encoder.EncoderConfig.
    `qpel` holds for host P frames only: the device P frame always refines
    to quarter pel, as the reference's device P frame does."""

    qp: int = 28
    intra_every: int = 100  # forced IDR period (frames)
    window_size: int = 16  # ME search window (full width, +-window_size // 2)
    maxdiff: int = -1  # tolerated error; -1 = per-MB adaptive
    lossy_prefilter: bool = True  # MAXDIFF source prefilter (below QP 36)
    scene_cut_idr: bool = True  # IDR where the frame SAD exceeds 16 per sample
    scene_cut_source: bool = False  # scene-cut SAD against the previous
    # source frame instead of the reconstructed reference
    qpel: bool = True  # quarter-pel refinement of the host P frame's search
    deblock: bool = False  # in-loop deblocking filter


class Encoder:
    """Session encoder on one device (CUDA by default).

    iframe: "i16" (all-Intra16x16 device IDRs), "mixed" (device IDRs with
    the exact I4x4-vs-I16 choice per MB) or "host" (the host per-MB
    encoder). pframe: "device" or "host". device_modes: with iframe="host",
    the Intra16x16 and Intra4x4 modes come from the device's decision,
    read back once per IDR, and only the bit-cost arbitration runs per MB.
    me: "full" (the host P frames' own integer search) or "topk" (the
    device's candidates; JAX's TpuMePipeline(window=window_size // 2)).
    encode_frame takes uint8 numpy
    planes y (H, W), cb and cr (H/2, W/2) and returns the frame's slice
    NAL."""

    def __init__(self, width: int, height: int, cfg: EncoderConfig,
                 iframe: str = "i16", pframe: str = "device",
                 device_modes: bool = False, me: str = "full",
                 device=DEFAULT_DEVICE) -> None:
        if width % 16 or height % 16:
            raise ValueError(f"frame {width}x{height} is not a whole number of MBs")
        if not 0 <= cfg.qp <= 51:
            raise ValueError(f"qp must be in 0..51, got {cfg.qp}")
        if iframe not in ("i16", "mixed", "host"):
            raise ValueError(f"iframe={iframe!r}: 'i16', 'mixed' or 'host'")
        if pframe not in ("device", "host"):
            raise ValueError(f"pframe={pframe!r}: 'device' or 'host'")
        if me not in ("full", "topk"):
            raise ValueError(f"me={me!r}: 'full' or 'topk'")
        if device_modes and iframe != "host":
            raise ValueError("device_modes feeds host I frames; device I frames "
                             "decide their own modes")
        self.device = resolve_device(device)
        self.cfg = cfg
        self._iframe = _DEVICE_IFRAMES.get(iframe)  # None: host I frames
        self._pframe_host = pframe == "host"
        self._device_modes = device_modes
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
        # the host frames' per-MB encoder and state
        self.host = (HostEncoder(width, height, cfg, self.qpc, self.device, me)
                     if iframe == "host" or self._pframe_host else None)
        # with device frames, on the device: the programs' input slots (the
        # frame's planes) and state, updated in place: the reference planes
        # (the last frame as decoders hold it, filtered), and per MB its
        # class (0..6), coded-block flags (Z-scan) and quadrant MVs; and the
        # previous source luma
        self._programs = {}  # static key → DeviceProgram
        self._slots = None
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
        if self._pframe_host:
            return tuple(p.astype(np.uint8) for p in
                         (self.host.ref_y, self.host.ref_cb, self.host.ref_cr))
        # a copy: the device programs update the state in place
        return tuple(p.to("cpu", copy=True).numpy() for p in self._ref)

    def _is_idr(self, y) -> bool:
        """selectNALUnitType (encoder._select_nal_unit_type): the first frame
        and every intra_every-th are IDRs; so is a frame whose luma SAD
        against the reference (or the previous source frame) exceeds 16 per
        sample. The SAD is summed in int64 where the reference lives: y is
        the numpy plane with host P frames, else its copy on the device."""
        if self.curr_frame_count % self.cfg.intra_every == 0:
            return True
        if not self.cfg.scene_cut_idr:
            return False
        if self._pframe_host:
            ref = self._prev_src if self.cfg.scene_cut_source else self.host.ref_y
            return int(np.abs(y.astype(np.int64) - ref).sum()) > (self.nmb << 12)
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

    def _state(self) -> dict:
        """The device programs' slots, made on first use: the frame's
        planes y, cb, cr and the state ref_y, ref_cb, ref_cr, mv, mb_class,
        nz, which self._ref, _mv, _mb_class and _nz name."""
        if self._slots is None:
            dev, nmb = self.device, self.nmb
            self._slots = {
                "y": planes((self.h, self.w), dev),
                "cb": planes((self.h // 2, self.w // 2), dev),
                "cr": planes((self.h // 2, self.w // 2), dev),
                "ref_y": planes((self.h, self.w), dev),
                "ref_cb": planes((self.h // 2, self.w // 2), dev),
                "ref_cr": planes((self.h // 2, self.w // 2), dev),
                "mv": torch.zeros((nmb, 4, 2), dtype=torch.int32, device=dev),
                "mb_class": torch.zeros(nmb, dtype=torch.int32, device=dev),
                "nz": torch.zeros((nmb, 16), dtype=torch.bool, device=dev)}
            st = self._slots
            self._ref = (st["ref_y"], st["ref_cb"], st["ref_cr"])
            self._mv, self._mb_class, self._nz = st["mv"], st["mb_class"], st["nz"]
        return self._slots

    def _idr_program(self) -> DeviceProgram:
        """The IDR program: the device I frame (filtered under cfg.deblock)
        into the state, every MB intra, zero MVs. Outputs: the frame
        function's, and head (nbits, then the MB-class histogram), all
        static (read before the next frame)."""
        frame, qp, qpc, deblock = self._iframe, self.qpy, self.qpc, self.cfg.deblock

        def body(y, cb, cr, ref_y, ref_cb, ref_cr, mv, mb_class, nz):
            out = frame(y, cb, cr, qp, qpc, deblock=deblock)
            fill((ref_y, ref_cb, ref_cr, nz),
                 (out["recon_y"], out["recon_cb"], out["recon_cr"], out["nz_luma"]))
            mb_class.fill_(INTRA_CLASS)
            mv.zero_()
            return {**out, "head": _head(out["nbits"], mb_class)}

        key = ("idr", frame.__name__, self.w, self.h, qp, deblock, self.device)
        return program(self._programs, key,
                       lambda: DeviceProgram(body, self._state()))

    def _p_program(self, hdr_bits: int) -> DeviceProgram:
        """The P frame program (encoder._device_pframe_encode_full): the
        device P frame, then the trailing-skip drop, which restores the
        previous frame's (filtered) samples and its MB state at the MBs
        decoders never read, then the filter on the whole frame, which reads
        that restored state; the state updated in place. hdr_bits: the
        slice header's bit count, baked in. Outputs: words, nbits, head, all
        static."""
        cfg = self.cfg
        window, qp, qpc = cfg.window_size // 2, self.qpy, self.qpc
        maxdiff, prefilter = cfg.maxdiff, bool(cfg.lossy_prefilter and qp < 36)
        deblock = cfg.deblock

        def body(y, cb, cr, ref_y, ref_cb, ref_cr, mv, mb_class, nz):
            out = device_p_frame(y, cb, cr, ref_y, ref_cb, ref_cr, mv, window, qp, qpc,
                                 maxdiff, prefilter)
            keep = trailing_skip_drop(out["skip"], out["nbits"], out["trail_bits"], hdr_bits)
            ry, rcb, rcr, new_mv = restore_dropped(keep, (ref_y, ref_cb, ref_cr, mv), out)
            cls = torch.where(out["skip"], SKIP_CLASS, out["raw_type"].clamp(max=4))
            new_cls = torch.where(keep, mb_class, cls).to(torch.int32)
            new_nz = torch.where(keep[:, None], nz, out["nz_luma"])
            if deblock:
                ry, rcb, rcr = deblock_frame(ry, rcb, rcr, new_cls == INTRA_CLASS, new_nz,
                                             new_mv, qp, qpc)
            fill((ref_y, ref_cb, ref_cr, mv, mb_class, nz),
                 (ry, rcb, rcr, new_mv, new_cls, new_nz))
            return {"words": out["words"], "nbits": out["nbits"],
                    "head": _head(out["nbits"], mb_class)}

        key = ("p", self.w, self.h, qp, window, maxdiff, prefilter, deblock, hdr_bits,
               self.device)
        return program(self._programs, key,
                       lambda: DeviceProgram(body, self._state()))

    def _host_frame(self, w: BitWriter, is_idr: bool, src, y_dev):
        """Code a frame on the host (encoder_host); returns (RBSP, the MB-class
        histogram). With device_modes, an IDR's modes come from the device's
        decision on y_dev (one read-back). With device P frames after it,
        its reconstruction and MB state go to the device."""
        h = self.host
        modes = None
        if is_idr and self._device_modes:
            dec = intra_mode_decision(y_dev, self.qpy)
            both = torch.cat([dec["mode16"][:, None], dec["mode4"]], dim=1).cpu().numpy()
            modes = (both[:, 0], both[:, 1:])
        rbsp = h.encode_slice(w, is_idr, *src, modes)
        mb_class = h.mb_class()
        if not self._pframe_host:
            # into the state tensors, in place: the programs hold their addresses
            st = self._state()
            for name, p in zip(("ref_y", "ref_cb", "ref_cr"), (h.ref_y, h.ref_cb, h.ref_cr)):
                upload_into(st[name], p)
            fill((st["mb_class"], st["nz"], st["mv"]),
                 (torch.from_numpy(mb_class), torch.from_numpy(h.nz_luma),
                  torch.from_numpy(np.ascontiguousarray(h.mv[:, :, 0]))))
        return rbsp, np.bincount(mb_class, minlength=7).tolist()

    def _device_frame(self, w: BitWriter, is_idr: bool, y, cb, cr):
        """Code a frame on the device; returns (RBSP, the MB-class
        histogram). One transfer for the payload size and the histogram, one
        for the payload's used words. With host P frames after an IDR, its
        reconstruction and syntax state go to the host."""
        prog = self._idr_program() if is_idr else self._p_program(w.bit_position)
        out = prog(y=y, cb=cb, cr=cr)
        nbits, *mb_types = (int(v) for v in out["head"].cpu())
        words = out["words"][: (nbits + 63) // 64].cpu().numpy()
        w.append_bits(words_to_bytes(words, nbits), nbits)
        w.rbsp_trailing_bits()
        if self._pframe_host:
            self.host.load_device_idr(out)
        return w.getvalue(), mb_types

    def encode_frame(self, y, cb, cr) -> bytes:
        """Encode one frame (uint8 numpy planes); returns its slice NAL."""
        t0 = time.time()
        src = (y, cb, cr)
        dev_src = None if self._pframe_host else tuple(upload(p, self.device) for p in src)
        is_idr = self._is_idr(y if self._pframe_host else dev_src[0])
        self._prev_src = y if self._pframe_host else dev_src[0]
        self.curr_frame_count += 1
        w = self._slice_header(is_idr)
        on_host = self._iframe is None if is_idr else self._pframe_host
        if on_host:
            y_dev = None
            if is_idr and self._device_modes:
                y_dev = dev_src[0] if dev_src else upload(y, self.device)
            rbsp, mb_types = self._host_frame(w, is_idr, src, y_dev)
        else:
            if dev_src is None:
                dev_src = tuple(upload(p, self.device) for p in src)
            rbsp, mb_types = self._device_frame(w, is_idr, *dev_src)
        nal = nal_mod.write_nal_unit(
            1, nal_mod.NAL_IDR if is_idr else nal_mod.NAL_NOT_IDR, rbsp)
        self.stats.append({"bytes": len(nal), "ms": (time.time() - t0) * 1000.0,
                           "idr": is_idr, "mb_types": mb_types})
        return nal
