"""Sequence encoders on one device: frames in, Annex-B bytes out.

The counterparts of the single-device branches of
h264_fer_tpu/parallel/gop_device.GopIntraEncoder (mode "i16" or "mixed") and
GopIpppEncoder. Every frame is uploaded (pinned host buffer, non-blocking
copy) and its device program queued before any payload is read back; the
host then reads all payload sizes in one transfer and the used words of all
payloads in a second one, and writes SPS/PPS once and one NAL per frame
with the serial encoder's slice-header sequence, so the stream is
byte-identical to the reference's. Payload buffers are sized for the worst
case, so there are no capacity tiers and no retries.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream import nal as nal_mod
from ..bitstream.bitio import BitWriter
from ..bitstream.params import I_SLICE, P_SLICE, PPS, SPS, SliceHeader, parameter_sets
from ..codec.gop import device_gop_ippp
from ..codec.iframe import device_i16_frame, device_mixed_frame
from ..ops import transform
from ..ops.cavlc_bulk import words_to_bytes
from ..ops.device import DEFAULT_DEVICE, resolve_device, upload


def _one_device(device, devices) -> torch.device:
    if devices is not None:
        if len(devices) != 1:
            raise NotImplementedError("multi-device encoding is not ported yet")
        device = devices[0]
    return resolve_device(device)


def read_payloads(payloads):
    """[(words (int64 numpy), nbits)] of slice payloads: dicts holding the
    `words` and `nbits` of an entropy stage, on one device. Two transfers:
    every size, then every payload's used words."""
    nbits = [int(n) for n in torch.stack([p["nbits"] for p in payloads]).cpu()]
    counts = [(n + 63) // 64 for n in nbits]
    flat = torch.cat([p["words"][:c] for p, c in zip(payloads, counts)])
    words = np.split(flat.cpu().numpy(), np.cumsum(counts)[:-1])
    return list(zip(words, nbits))


class _Stream:
    """SPS / PPS and NAL writing shared by the sequence encoders."""

    sps: SPS
    pps: PPS
    deblock = False

    def headers(self) -> bytes:
        return parameter_sets(self.sps, self.pps)

    def _idr_nal(self, words: np.ndarray, nbits: int, idr_pic_id: int) -> bytes:
        shd = SliceHeader(slice_type=I_SLICE, frame_num=0, idr_pic_id=idr_pic_id,
                          pic_order_cnt_lsb=0, slice_qp_delta=-14,
                          disable_deblocking_filter_idc=0 if self.deblock else 1)
        w = BitWriter()
        shd.write(w, self.sps, self.pps, nal_mod.NAL_IDR, 1)
        w.append_bits(words_to_bytes(words, nbits), nbits)
        w.rbsp_trailing_bits()
        return nal_mod.write_nal_unit(1, nal_mod.NAL_IDR, w.getvalue())


class GopIntraEncoder(_Stream):
    """All-intra sequence encoder on one device (CUDA by default).

    mode: "i16" (every MB Intra16x16) or "mixed" (the exact
    I4x4-vs-I16 bit-cost choice per MB, device_mixed_frame). deblock: signal
    the in-loop filter in the PPS and every slice header, as the JAX
    GopIntraEncoder does; the payloads do not depend on it and no output
    reads the filtered planes, so the filter itself does not run."""

    def __init__(self, width: int, height: int, qp: int, mode: str = "i16",
                 device=DEFAULT_DEVICE, deblock: bool = False,
                 devices=None) -> None:
        if width % 16 or height % 16:
            raise ValueError(f"frame {width}x{height} is not a whole number of MBs")
        if mode not in ("i16", "mixed"):
            raise ValueError(f"mode={mode!r}: 'i16' or 'mixed'")
        self.device = _one_device(device, devices)
        self.deblock = bool(deblock)
        self._frame = device_mixed_frame if mode == "mixed" else device_i16_frame
        self.w, self.h, self.qp = width, height, qp
        self.wmb, self.hmb = width // 16, height // 16
        self.qpc = transform.chroma_qp(qp, 0)
        self.sps = SPS(pic_width_in_mbs=self.wmb,
                       pic_height_in_map_units=self.hmb)
        self.pps = PPS(pic_init_qp=14 + qp,
                       deblocking_filter_control_present_flag=int(self.deblock))

    def _queue(self, frames):
        """Queue every frame's device program; returns the payloads (on the
        device, nothing read back)."""
        outs = []
        for f in frames:
            y, cb, cr = (upload(p, self.device) for p in f)
            out = self._frame(y, cb, cr, self.qp, self.qpc)
            outs.append({"words": out["words"], "nbits": out["nbits"]})
        return outs

    def stitch(self, payloads, idr_base: int = 0) -> bytes:
        """The Annex-B stream of frames whose slice payloads are `payloads`
        (dicts holding the `words` and `nbits` of a slice entropy stage, on
        any device). idr_base: idr_pic_id of the first frame."""
        out = bytearray(self.headers())
        for i, (words, nbits) in enumerate(read_payloads(payloads)):
            out += self._idr_nal(words, nbits, idr_base + i)
        return bytes(out)

    def encode_sequence(self, frames, idr_base: int = 0) -> bytes:
        """frames: list of (y, cb, cr) uint8 numpy planes. Returns the full
        Annex-B stream. idr_base: idr_pic_id of frames[0]."""
        return self.stitch(self._queue(frames), idr_base)


class GopIpppEncoder(_Stream):
    """IPPP sequence encoder on one device (CUDA by default).

    The sequence splits into IDR-delimited GOPs of gop_len frames (or, with
    scene_cut_source, also at every source-frame SAD cut); each GOP is one
    device_gop_ippp program: the IDR, then the chain of P frames. The stream
    is that of the serial Encoder(intra_every=gop_len, window_size,
    maxdiff, lossy_prefilter) with deblock=False. window_size: the full
    search width (a search of +-window_size // 2 full pel); maxdiff: the
    tolerated error, -1 for the adaptive per-MB MAXDIFF; lossy_prefilter:
    the MAXDIFF source prefilter, which runs below QP 36 only.
    """

    def __init__(self, width: int, height: int, qp: int, gop_len: int,
                 window_size: int = 16, maxdiff: int = -1,
                 lossy_prefilter: bool = True, device=DEFAULT_DEVICE,
                 devices=None, scene_cut_source: bool = False) -> None:
        if width % 16 or height % 16:
            raise ValueError(f"frame {width}x{height} is not a whole number of MBs")
        if gop_len < 2:
            raise ValueError("gop_len < 2: use GopIntraEncoder for all-intra")
        self.device = _one_device(device, devices)
        self.scene_cut_source = bool(scene_cut_source)
        self.w, self.h, self.qp, self.T = width, height, qp, gop_len
        self.wmb, self.hmb = width // 16, height // 16
        self.nmb = self.wmb * self.hmb
        self.qpc = transform.chroma_qp(qp, 0)
        self.window = window_size // 2
        self.maxdiff = maxdiff
        self.prefilter = bool(lossy_prefilter and qp < 36)
        self.sps = SPS(pic_width_in_mbs=self.wmb,
                       pic_height_in_map_units=self.hmb)
        self.pps = PPS(pic_init_qp=14 + qp)
        self._set_hdrs(gop_len)

    def _set_hdrs(self, T: int) -> None:
        """The P slice headers of a GOP of T frames, as (bytes, bit count):
        frame_num and POC are fixed by the frame's place in the GOP, so the
        headers, and the bit counts the trailing-skip drop needs, are known
        before any frame is encoded; no GOP is longer than gop_len, so the
        headers of one gop_len GOP serve every call."""
        self._p_hdrs = []
        for j in range(1, T):
            shd = SliceHeader(
                slice_type=P_SLICE, frame_num=j & (self.sps.max_frame_num - 1),
                idr_pic_id=0,
                pic_order_cnt_lsb=(2 * j) & (
                    (1 << self.sps.log2_max_pic_order_cnt_lsb) - 1),
                slice_qp_delta=-14, disable_deblocking_filter_idc=1)
            w = BitWriter()
            shd.write(w, self.sps, self.pps, nal_mod.NAL_NOT_IDR, 1)
            bits = w.bit_position
            if bits % 8:  # zero-pad for storage; append_bits replays `bits`
                w.write(0, 8 - bits % 8)
            self._p_hdrs.append((w.getvalue(), bits))

    @property
    def hdr_bits(self) -> list:
        """The bit count of each P slice header of a GOP, in frame order."""
        return [bits for _, bits in self._p_hdrs]

    def _gop_lengths(self, frames) -> list:
        """Frames per GOP: gop_len-frame chunks; with scene_cut_source, also
        a new IDR wherever the source luma SAD to the previous frame exceeds
        nmb << 12 (the serial encoder's scene_cut_source rule; the period
        counts absolute frames, as encoder._select_nal_unit_type does)."""
        b = len(frames)
        if not self.scene_cut_source:
            return [min(self.T, b - s) for s in range(0, b, self.T)]
        thr = self.nmb << 12
        lens, cur = [], 0
        for i in range(1, b):
            sad = int(np.abs(np.asarray(frames[i][0], np.int64)
                             - np.asarray(frames[i - 1][0], np.int64)).sum())
            if i % self.T == 0 or sad > thr:
                lens.append(i - cur)
                cur = i
        lens.append(b - cur)
        return lens

    def _queue(self, frames, lens):
        """Queue every GOP's device program; returns the payloads of all
        frames in order (on the device, nothing read back)."""
        payloads = []
        start = 0
        for n in lens:
            ys, cbs, crs = ([upload(f[k], self.device) for f in frames[start: start + n]]
                            for k in range(3))
            payloads += device_gop_ippp(ys, cbs, crs, self.hdr_bits[: n - 1],
                                        self.window, self.qp, self.qpc,
                                        self.maxdiff, self.prefilter)["frames"]
            start += n
        return payloads

    def stitch(self, payloads, lens) -> bytes:
        """The Annex-B stream of GOPs of `lens` frames whose slice payloads,
        in frame order, are `payloads` (dicts holding `words` and `nbits`,
        on any device)."""
        read = iter(read_payloads(payloads))
        out = bytearray(self.headers())
        idr_id = 0
        for g, n in enumerate(lens):
            # idr_pic_id (encoder._encode_slice): 0 on the first IDR and
            # after P frames, +1 after an IDR (a GOP of one frame)
            idr_id = idr_id + 1 if g > 0 and lens[g - 1] == 1 else 0
            out += self._idr_nal(*next(read), idr_id)
            for j in range(1, n):
                hdr, bits = self._p_hdrs[j - 1]
                words, nbits = next(read)
                w = BitWriter()
                w.append_bits(hdr, bits)
                w.append_bits(words_to_bytes(words, nbits), nbits)
                w.rbsp_trailing_bits()
                out += nal_mod.write_nal_unit(1, nal_mod.NAL_NOT_IDR, w.getvalue())
        return bytes(out)

    def encode_sequence(self, frames) -> bytes:
        """frames: list of (y, cb, cr) uint8 numpy planes. Returns the full
        Annex-B stream."""
        lens = self._gop_lengths(frames)
        return self.stitch(self._queue(frames, lens), lens)
