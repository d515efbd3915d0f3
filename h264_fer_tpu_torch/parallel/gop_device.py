"""Sequence encoders over a list of devices: frames in, Annex-B bytes out.

The counterparts of h264_fer_tpu/parallel/gop_device.GopIntraEncoder (mode
"i16" or "mixed"), GopIpppEncoder and measure_scaling. As the reference's
encoders take a list of JAX devices, these take `devices`, a list of
devices that this one process drives. An entry may appear more than once:
each entry is a lane (`Lane`), on a card a CUDA stream of its own, so
["cuda:0"] * 2 runs two shares on one card and ["cpu"] * n is what the CPU
tests pass. IDR frames (all-intra) and GOPs (IPPP) are independent, so
they split into contiguous shares, one per lane. Every lane uploads its
frames (pinned host buffer, non-blocking copy) straight into the input
slots of its device program (codec/program.py: on a card one CUDA graph
per frame kind or GOP length and lane, captured on first use) and replays
it on its stream, for every frame or GOP before any payload is read back;
the program copies each payload out of its static outputs. The host then
reads each lane's payloads (every size in one transfer, the used words of
all payloads in a second one) and writes SPS/PPS once and one NAL per frame
in the serial order, with the serial encoder's slice-header sequence, so
the stream is byte-identical to the one-device stream and to the
reference's. The reference pads a batch to a multiple of its device count
and encodes the padding; shares of unequal size need no padding here.
Payload buffers are sized for the worst case, so there are no capacity
tiers and no retries.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..bitstream import nal as nal_mod
from ..bitstream.bitio import BitWriter
from ..bitstream.params import I_SLICE, P_SLICE, PPS, SPS, SliceHeader, parameter_sets
from ..codec.gop import device_gop_ippp
from ..codec.iframe import device_i16_frame, device_mixed_frame
from ..codec.program import DeviceProgram, planes, program
from ..ops import transform
from ..ops.cavlc_bulk import words_to_bytes
from ..ops.device import DEFAULT_DEVICE, resolve_devices, upload_into


class Lane:
    """One entry of a device list: its device, on a card a CUDA stream of
    its own, on which the work queued under `queue()` runs, and its device
    programs (one instance per key and lane)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.programs = {}  # static key → DeviceProgram

    def queue(self):
        """Context in which work goes to the lane's stream (and its card is
        the current device); on the CPU, a no-op."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def record(self):
        """An event after the work queued on the lane so far (None on the
        CPU)."""
        if self.stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event

    def wait(self, event) -> None:
        """Order the lane's later work after `event`, another lane's record
        (which may be on another card)."""
        if event is not None:
            self.stream.wait_event(event)


def shares(n: int, k: int) -> list:
    """n items in k contiguous ranges, in order, whose sizes differ by at
    most one (the first ones larger); a range is empty when k > n."""
    base, rem = divmod(n, k)
    bounds = np.cumsum([0] + [base + (i < rem) for i in range(k)])
    return [range(bounds[i], bounds[i + 1]) for i in range(k)]


def interleave(share_lists):
    """(lane index, item) pairs taking each lane's next item in turn, so that
    every lane has work queued early."""
    for j in range(max((len(s) for s in share_lists), default=0)):
        for i, s in enumerate(share_lists):
            if j < len(s):
                yield i, s[j]


def read_payloads(payloads):
    """[(words (int64 numpy), nbits)] of slice payloads: dicts holding the
    `words` and `nbits` of an entropy stage, on one device, queued on the
    current stream. Two transfers: every size, then every payload's used
    words."""
    if not payloads:
        return []
    nbits = [int(n) for n in torch.stack([p["nbits"] for p in payloads]).cpu()]
    counts = [(n + 63) // 64 for n in nbits]
    flat = torch.cat([p["words"][:c] for p, c in zip(payloads, counts)])
    words = np.split(flat.cpu().numpy(), np.cumsum(counts)[:-1])
    return list(zip(words, nbits))


def read_lanes(lane_list, payloads_by_lane) -> list:
    """read_payloads of each lane's payloads on its own stream: one list of
    lists of (words, nbits), in lane order."""
    out = []
    for lane, payloads in zip(lane_list, payloads_by_lane):
        with lane.queue():
            out.append(read_payloads(payloads))
    return out


class _Stream:
    """SPS / PPS and NAL writing shared by the sequence encoders."""

    sps: SPS
    pps: PPS
    deblock = False

    def headers(self) -> bytes:
        return parameter_sets(self.sps, self.pps)

    def _idr_nal(self, parts, idr_pic_id: int) -> bytes:
        """The IDR NAL of a slice whose payload is `parts`, [(words,
        nbits)] spliced in order at bit granularity (one part per MB-row
        band, or one for the whole frame)."""
        shd = SliceHeader(slice_type=I_SLICE, frame_num=0, idr_pic_id=idr_pic_id,
                          pic_order_cnt_lsb=0, slice_qp_delta=-14,
                          disable_deblocking_filter_idc=0 if self.deblock else 1)
        w = BitWriter()
        shd.write(w, self.sps, self.pps, nal_mod.NAL_IDR, 1)
        for words, nbits in parts:
            w.append_bits(words_to_bytes(words, nbits), nbits)
        w.rbsp_trailing_bits()
        return nal_mod.write_nal_unit(1, nal_mod.NAL_IDR, w.getvalue())

    def _p_nal(self, parts, j: int) -> bytes:
        """The NAL of the P slice at place j of its GOP (self._p_hdrs[j - 1]
        its header) whose payload is `parts`, as _idr_nal's."""
        hdr, bits = self._p_hdrs[j - 1]
        w = BitWriter()
        w.append_bits(hdr, bits)
        for words, nbits in parts:
            w.append_bits(words_to_bytes(words, nbits), nbits)
        w.rbsp_trailing_bits()
        return nal_mod.write_nal_unit(1, nal_mod.NAL_NOT_IDR, w.getvalue())


def _check_size(width: int, height: int) -> None:
    if width % 16 or height % 16:
        raise ValueError(f"frame {width}x{height} is not a whole number of MBs")


class GopIntraEncoder(_Stream):
    """All-intra sequence encoder over a list of devices (one CUDA device by
    default).

    mode: "i16" (every MB Intra16x16) or "mixed" (the exact I4x4-vs-I16
    bit-cost choice per MB, device_mixed_frame). deblock: signal the in-loop
    filter in the PPS and every slice header, as the JAX GopIntraEncoder
    does; the payloads do not depend on it and no output reads the filtered
    planes, so the filter itself does not run. devices: a list of devices
    (repeats allowed), each encoding a contiguous share of the frames; None
    means [device]."""

    def __init__(self, width: int, height: int, qp: int, mode: str = "i16",
                 device=DEFAULT_DEVICE, deblock: bool = False,
                 devices=None) -> None:
        _check_size(width, height)
        if mode not in ("i16", "mixed"):
            raise ValueError(f"mode={mode!r}: 'i16' or 'mixed'")
        self.devices = resolve_devices([device] if devices is None else devices)
        self.device = self.devices[0]
        self.lanes = [Lane(d) for d in self.devices]
        self.deblock = bool(deblock)
        self.mode = mode
        self._frame = device_mixed_frame if mode == "mixed" else device_i16_frame
        self.recon = []
        self.w, self.h, self.qp = width, height, qp
        self.wmb, self.hmb = width // 16, height // 16
        self.qpc = transform.chroma_qp(qp, 0)
        self.sps = SPS(pic_width_in_mbs=self.wmb,
                       pic_height_in_map_units=self.hmb)
        self.pps = PPS(pic_init_qp=14 + qp,
                       deblocking_filter_control_present_flag=int(self.deblock))

    def _program(self, lane: Lane) -> DeviceProgram:
        """The lane's frame program (device_i16_frame or
        device_mixed_frame): input slots y, cb, cr; every output of the
        frame function, the payload copied out per call."""
        def make():
            frame, qp, qpc = self._frame, self.qp, self.qpc
            slots = {"y": planes((self.h, self.w), lane.device),
                     "cb": planes((self.h // 2, self.w // 2), lane.device),
                     "cr": planes((self.h // 2, self.w // 2), lane.device)}
            return DeviceProgram(lambda y, cb, cr: frame(y, cb, cr, qp, qpc), slots,
                                 ("words", "nbits"))

        key = (self.mode, self.w, self.h, self.qp, lane.device)
        return program(lane.programs, key, make)

    def _queue(self, frames, keep_recon: bool = False):
        """Queue every frame's device program, each lane its share, on its
        own stream: the planes uploaded into its input slots, then one
        replay. Returns each lane's payloads (on its device, nothing read
        back); with keep_recon, each frame's recon planes go to
        self.recon in frame order."""
        split = shares(len(frames), len(self.lanes))
        out = [[] for _ in self.lanes]
        recon = [None] * len(frames)
        for i, f in interleave(split):
            lane = self.lanes[i]
            with lane.queue():
                prog = self._program(lane)
                for name, plane in zip(("y", "cb", "cr"), frames[f]):
                    upload_into(prog.slots[name], plane)
                res = prog(keep=prog.keep + (_RECON if keep_recon else ()))
            out[i].append({"words": res["words"], "nbits": res["nbits"]})
            recon[f] = tuple(res[k] for k in _RECON)
        self.recon = recon if keep_recon else []
        return out

    def _write(self, read, idr_base: int) -> bytes:
        out = bytearray(self.headers())
        for i, (words, nbits) in enumerate(read):
            out += self._idr_nal([(words, nbits)], idr_base + i)
        return bytes(out)

    def stitch(self, payloads, idr_base: int = 0) -> bytes:
        """The Annex-B stream of frames whose slice payloads are `payloads`
        (dicts holding the `words` and `nbits` of a slice entropy stage, on
        one device, queued on the current stream). idr_base: idr_pic_id of
        the first frame."""
        return self._write(read_payloads(payloads), idr_base)

    def encode_sequence(self, frames, idr_base: int = 0, keep_recon: bool = False) -> bytes:
        """frames: list of (y, cb, cr) uint8 numpy planes. Returns the full
        Annex-B stream. idr_base: idr_pic_id of frames[0] (a span of a
        longer sequence, parallel/dist.py). keep_recon: keep each frame's
        recon planes (device tensors) in self.recon."""
        read = read_lanes(self.lanes, self._queue(frames, keep_recon))
        return self._write([p for lane in read for p in lane], idr_base)


class GopIpppEncoder(_Stream):
    """IPPP sequence encoder over a list of devices (one CUDA device by
    default).

    The sequence splits into IDR-delimited GOPs of gop_len frames (or, with
    scene_cut_source, also at every source-frame SAD cut); each GOP is one
    device_gop_ippp program: the IDR, then the chain of P frames. GOPs are
    independent, so with several devices (repeats allowed) each encodes a
    contiguous share of them. The stream is that of the serial
    Encoder(intra_every=gop_len, window_size, maxdiff, lossy_prefilter) with
    deblock=False. window_size: the full search width (a search of
    +-window_size // 2 full pel); maxdiff: the tolerated error, -1 for the
    adaptive per-MB MAXDIFF; lossy_prefilter: the MAXDIFF source prefilter,
    which runs below QP 36 only. Each lane keeps the programs of its
    GOP_PROGRAMS most recently used GOP lengths.
    """

    def __init__(self, width: int, height: int, qp: int, gop_len: int,
                 window_size: int = 16, maxdiff: int = -1,
                 lossy_prefilter: bool = True, device=DEFAULT_DEVICE,
                 devices=None, scene_cut_source: bool = False) -> None:
        _check_size(width, height)
        if gop_len < 2:
            raise ValueError("gop_len < 2: use GopIntraEncoder for all-intra")
        self.devices = resolve_devices([device] if devices is None else devices)
        self.device = self.devices[0]
        self.lanes = [Lane(d) for d in self.devices]
        self.scene_cut_source = bool(scene_cut_source)
        self.recon = []
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

    def _program(self, lane: Lane, n: int) -> DeviceProgram:
        """The lane's program of a GOP of n frames (device_gop_ippp, the P
        slice headers' bit counts baked in per place): input slots ys, cbs,
        crs, (n, H, W) and (n, H/2, W/2) uint8, frame 0 the IDR. Outputs:
        words (a list of n payloads) and nbits ((n,)), copied out per call;
        recon, the n frames' reference planes as decoders hold them (3n
        planes); recon_y / recon_cb / recon_cr and mv, the final reference
        state."""
        hdr_bits = tuple(self.hdr_bits[: n - 1])
        window, qp, qpc, maxdiff, prefilter = (self.window, self.qp, self.qpc, self.maxdiff,
                                               self.prefilter)

        def body(ys, cbs, crs):
            out = device_gop_ippp(ys.unbind(0), cbs.unbind(0), crs.unbind(0), hdr_bits,
                                  window, qp, qpc, maxdiff, prefilter)
            frames = out["frames"]
            return {"words": [f["words"] for f in frames],
                    "nbits": torch.stack([f["nbits"] for f in frames]),
                    "recon": [p for f in frames for p in f["recon"]],
                    **{k: out[k] for k in ("recon_y", "recon_cb", "recon_cr", "mv")}}

        def make():
            dev = lane.device
            slots = {"ys": planes((self.h, self.w), dev, n),
                     "cbs": planes((self.h // 2, self.w // 2), dev, n),
                     "crs": planes((self.h // 2, self.w // 2), dev, n)}
            return DeviceProgram(body, slots, ("words", "nbits"))

        key = ("ippp", self.w, self.h, self.qp, self.window, self.maxdiff, self.prefilter,
               n, hdr_bits, lane.device)
        return program(lane.programs, key, make, GOP_PROGRAMS)

    def _queue(self, frames, lens, keep_recon: bool = False):
        """Queue every GOP's device program, each lane a contiguous share of
        the GOPs on its own stream: the GOP's planes uploaded into its input
        slots, then one replay. Returns each lane's payloads of all its
        frames in order (on its device, nothing read back); with
        keep_recon, each frame's reference planes go to self.recon in frame
        order."""
        starts = np.cumsum([0] + lens[:-1])
        out = [[] for _ in self.lanes]
        recon = [None] * len(lens)
        for i, g in interleave(shares(len(lens), len(self.lanes))):
            lane, s, n = self.lanes[i], int(starts[g]), lens[g]
            with lane.queue():
                prog = self._program(lane, n)
                for k, name in enumerate(("ys", "cbs", "crs")):
                    upload_into(prog.slots[name], [f[k] for f in frames[s: s + n]])
                res = prog(keep=prog.keep + (("recon",) if keep_recon else ()))
            out[i] += [{"words": w, "nbits": res["nbits"][j]}
                       for j, w in enumerate(res["words"])]
            if keep_recon:
                recon[g] = [tuple(res["recon"][3 * j: 3 * j + 3]) for j in range(n)]
        self.recon = [r for gop in recon for r in gop] if keep_recon else []
        return out

    def _write(self, read, lens) -> bytes:
        """The stream of GOPs of `lens` frames; read: each frame's payload
        parts [(words, nbits)] (one per frame, or one per MB-row band), in
        frame order."""
        read = iter(read)
        out = bytearray(self.headers())
        idr_id = 0
        for g, n in enumerate(lens):
            # idr_pic_id (encoder._encode_slice): 0 on the first IDR and
            # after P frames, +1 after an IDR (a GOP of one frame)
            idr_id = idr_id + 1 if g > 0 and lens[g - 1] == 1 else 0
            out += self._idr_nal(next(read), idr_id)
            for j in range(1, n):
                out += self._p_nal(next(read), j)
        return bytes(out)

    def stitch(self, payloads, lens) -> bytes:
        """The Annex-B stream of GOPs of `lens` frames whose slice payloads,
        in frame order, are `payloads` (dicts holding `words` and `nbits`,
        on one device, queued on the current stream)."""
        return self._write([[p] for p in read_payloads(payloads)], lens)

    def encode_sequence(self, frames, keep_recon: bool = False) -> bytes:
        """frames: list of (y, cb, cr) uint8 numpy planes. Returns the full
        Annex-B stream. keep_recon: keep each frame's reference planes as
        decoders hold them (device tensors) in self.recon."""
        lens = self._gop_lengths(frames)
        read = read_lanes(self.lanes, self._queue(frames, lens, keep_recon))
        return self._write([[p] for lane in read for p in lane], lens)


_RECON = ("recon_y", "recon_cb", "recon_cr")
# the GOP programs a lane of GopIpppEncoder keeps, one per GOP length (a
# short last GOP and scene cuts make lengths 1..gop_len): every length of
# GOPs of up to 8 frames; past them a new length drops the least recently
# used program, its graph and the memory pool of its outputs
GOP_PROGRAMS = 8


def scaling_frames(width: int, height: int, n_frames: int):
    """The frames measure_scaling encodes (the reference's content: stripes
    plus noise from seed 3)."""
    rng = np.random.default_rng(3)
    frames = []
    yy, xx = np.mgrid[0:height, 0:width]
    for i in range(n_frames):
        y = (((xx // 6 + yy // 4 + 5 * i) % 220)
             + rng.integers(0, 10, (height, width))).astype(np.uint8)
        cb = rng.integers(90, 150, (height // 2, width // 2)).astype(np.uint8)
        cr = rng.integers(90, 150, (height // 2, width // 2)).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def measure_scaling(width: int, height: int, qp: int, n_frames: int = 8,
                    device_counts=(1, 2, 4, 8), mode: str = "i16",
                    reps: int = 2, devices=None) -> dict:
    """Frames/s of GopIntraEncoder's end-to-end encode (host clock around
    encode_sequence, which returns the stream) at several device counts:
    {n: best of `reps` runs after a warm-up}. devices: the device list
    (None: every visible card); count n uses its first n entries, and a
    count beyond the list is skipped. Entries that repeat one card measure
    how far lanes overlap on it; only distinct cards add device work."""
    frames = scaling_frames(width, height, n_frames)
    avail = resolve_devices(devices)
    fps = {}
    for n in device_counts:
        if n > len(avail):
            continue
        enc = GopIntraEncoder(width, height, qp, mode=mode, devices=avail[:n])
        enc.encode_sequence(frames)  # warm-up
        best = 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            enc.encode_sequence(frames)
            best = max(best, n_frames / (time.perf_counter() - t0))
        fps[n] = best
    return fps
