"""All-intra sequence encoder on one device: frames in, Annex-B bytes out.

The counterpart of the single-device, mode="i16" branch of
h264_fer_tpu/parallel/gop_device.GopIntraEncoder. IDR frames are
independent, so every frame is uploaded (pinned host buffer, non-blocking
copy) and its device program queued before any payload is read back; the
host then reads all payload sizes in one transfer, each payload's used
words, and writes SPS/PPS once and one IDR NAL per frame with the serial
encoder's slice-header sequence (idr_pic_id = frame index), so the stream
is byte-identical to the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream import nal as nal_mod
from ..bitstream.bitio import BitWriter
from ..bitstream.params import I_SLICE, PPS, SPS, SliceHeader
from ..codec.iframe import device_i16_frame
from ..ops import transform
from ..ops.cavlc_bulk import words_to_bytes
from ..ops.device import DEFAULT_DEVICE, resolve_device


class GopIntraEncoder:
    """All-Intra16x16 sequence encoder on one device (CUDA by default)."""

    def __init__(self, width: int, height: int, qp: int, mode: str = "i16",
                 device=DEFAULT_DEVICE, deblock: bool = False,
                 devices=None) -> None:
        if width % 16 or height % 16:
            raise ValueError(f"frame {width}x{height} is not a whole number of MBs")
        if mode != "i16":
            raise NotImplementedError(f"mode={mode!r}: only 'i16' is ported")
        if deblock:
            raise NotImplementedError("deblocking is not ported yet")
        if devices is not None:
            if len(devices) != 1:
                raise NotImplementedError("multi-device encoding is not ported yet")
            device = devices[0]
        self.device = resolve_device(device)
        self.w, self.h, self.qp = width, height, qp
        self.wmb, self.hmb = width // 16, height // 16
        self.qpc = transform.chroma_qp(qp, 0)
        self.sps = SPS(pic_width_in_mbs=self.wmb,
                       pic_height_in_map_units=self.hmb)
        self.pps = PPS(pic_init_qp=14 + qp,
                       deblocking_filter_control_present_flag=0)

    def headers(self) -> bytes:
        w = BitWriter()
        self.sps.write(w)
        w.rbsp_trailing_bits()
        out = nal_mod.write_nal_unit(1, nal_mod.NAL_SPS, w.getvalue())
        w = BitWriter()
        self.pps.write(w)
        w.rbsp_trailing_bits()
        return out + nal_mod.write_nal_unit(1, nal_mod.NAL_PPS, w.getvalue())

    def _upload(self, plane) -> torch.Tensor:
        plane = np.asarray(plane, dtype=np.uint8)
        host = torch.empty(plane.shape, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        host.numpy()[...] = plane
        return host.to(self.device, non_blocking=True)

    def _queue(self, frames):
        """Queue every frame's device program; returns the payloads (on the
        device, nothing read back)."""
        outs = []
        for f in frames:
            y, cb, cr = (self._upload(p) for p in f)
            out = device_i16_frame(y, cb, cr, self.qp, self.qpc)
            outs.append({"words": out["words"], "nbits": out["nbits"]})
        return outs

    def stitch(self, payloads, idr_base: int = 0) -> bytes:
        """The Annex-B stream of frames whose slice payloads are `payloads`:
        dicts holding the `words` and `nbits` of i16_slice_entropy, on any
        device. Reads all sizes in one transfer, then only each payload's
        used words. idr_base: idr_pic_id of the first frame."""
        nbits = torch.stack([o["nbits"] for o in payloads]).cpu().numpy()
        out = bytearray(self.headers())
        for i, (o, nb) in enumerate(zip(payloads, nbits)):
            words = o["words"][: (int(nb) + 63) // 64].cpu().numpy()
            out += self._stitch_nal(words, int(nb), idr_base + i)
        return bytes(out)

    def encode_sequence(self, frames, idr_base: int = 0) -> bytes:
        """frames: list of (y, cb, cr) uint8 numpy planes. Returns the full
        Annex-B stream. idr_base: idr_pic_id of frames[0]."""
        return self.stitch(self._queue(frames), idr_base)

    def _stitch_nal(self, frame_words: np.ndarray, nbits: int,
                    idr_pic_id: int) -> bytes:
        shd = SliceHeader(
            slice_type=I_SLICE,
            frame_num=0,
            idr_pic_id=idr_pic_id,
            pic_order_cnt_lsb=0,
            slice_qp_delta=-14,
            disable_deblocking_filter_idc=1,
        )
        w = BitWriter()
        shd.write(w, self.sps, self.pps, nal_mod.NAL_IDR, 1)
        w.append_bits(words_to_bytes(frame_words, nbits), nbits)
        w.rbsp_trailing_bits()
        return nal_mod.write_nal_unit(1, nal_mod.NAL_IDR, w.getvalue())
