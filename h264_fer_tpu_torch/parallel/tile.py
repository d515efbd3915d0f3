"""MB-row band parallelism: each frame's intra encode split into bands of
MB rows over a list of devices.

The counterpart of h264_fer_tpu/parallel/tile.py: TileIntraEncoder and
GopTileIntraEncoder, mode "i16" or "mixed" (the P-frame form:
parallel/tile_p.py). Each entry of `devices` (repeats allowed,
as in parallel/gop_device.py) is a lane that encodes one band of every
frame: n_tile bands of hloc = ceil(hmb / n_tile) MB rows, the frame padded
below with edge-replicated rows to n_tile * hloc; the padded MBs are coded,
written with no bits, and cut from the recon.

Three dependencies of an intra frame cross a band edge:
- the mode decision reads the source row above the band: known up front,
  it is uploaded with the band (top_row);
- the wavefronts (K1t-band for i16; K7-band and K6-band for mixed) read
  the band above's final last MB row: its recon samples and, for K6, its
  classes, TotalCoeffs, CBP and pre-decided Intra4x4 modes;
- the entropy's nC contexts read that row's final TotalCoeff and CBP
  (top_ctx).
The reference runs the bands of one frame as one global wavefront and sends
the newly reconstructed bottom-row segment to the band below on every wave
(ppermute). Here no launch waits on another: band t encodes frame f once
band t-1 has finished frame f, when the whole halo exists. The halo (one
sample row per plane and one MB row of state) then crosses once, copied to
band t's device on band t's stream after an event of band t-1's stream; no
host sync is needed per band. Every band queues its frames before any
payload is read back, so band t works on frame f while band t-1 works on
frame f+1. Each MB reads the same data as on one device, so the bits do not
change. Band outputs stay referenced until every lane has been read back,
so no buffer that another lane's stream reads is reused under it.

A band's slice payload holds its MBs in raster order, so the host splices
the band payloads in band order at bit granularity into one slice per
frame: the stream is byte-identical to the one-device stream of
parallel/gop_device.GopIntraEncoder.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream.params import PPS, SPS
from ..codec.entropy import chroma_setup, i16_slice_entropy, mixed_slice_entropy
from ..codec.intra_decision import intra16_mode_decision, intra_mode_decision
from ..kernels.wavefront_i16 import chroma_band, i16_band
from ..kernels.wavefront_mixed import TOP_KEYS, mixed_luma_band
from ..ops import transform
from ..ops.device import const, resolve_devices, upload
from ..ops.intra import INTRA16_TO_CHROMA_MODE
from .gop_device import Lane, _check_size, _Stream, interleave, read_lanes, shares

I32 = torch.int32


def _ctx(halo):
    """The entropy's top_ctx from a band halo (None: no band above)."""
    if halo is None:
        return None
    return tuple(halo[k] for k in ("tc_luma", "cbp_luma", "tc_chroma", "cbp_chroma"))


def _last_row_state(ent, wmb: int) -> dict:
    """The final TotalCoeff / CBP state of a band's last MB row, from its
    slice entropy's outputs: the next band's nC top context (the values
    the reference's _band_state_last_row and _chroma_state_last_row
    rebuild from the levels)."""
    return {"tc_luma": ent["tc_luma"][-wmb:], "cbp_luma": ent["cbp_luma"][-wmb:],
            "tc_chroma": ent["tc_chroma"][:, -wmb:], "cbp_chroma": ent["cbp_chroma"][-wmb:]}


def _decide_i16(y, top_row, qp: int) -> dict:
    m16, _ = intra16_mode_decision(y, qp, top_row)
    return {"mode16": m16}


def _code_i16(y, cb, cr, dec, halo, valid, qp: int, qpc: int) -> dict:
    """One band of an all-I16 frame after its mode decision (the
    reference's _make_band): K1t-band, then the slice entropy with the
    band above's nC context."""
    wmb, hloc = y.shape[1] // 16, y.shape[0] // 16
    m16 = dec["mode16"]
    cmode = const(INTRA16_TO_CHROMA_MODE, y.device)[m16.long()]
    top = None if halo is None else (halo["recon"], halo["cb"], halo["cr"])
    ry, i16dc, ac, rcb, rcr, cdc, cac = i16_band(y, cb, cr, m16, cmode, qp, qpc, top)
    ent = i16_slice_entropy(m16, cmode, i16dc, ac, cdc, cac, wmb=wmb, hmb=hloc,
                            top_ctx=_ctx(halo), valid=valid)
    return {"words": ent["words"], "nbits": ent["nbits"], "recon": (ry, rcb, rcr),
            "halo": {"recon": ry[-1], "cb": rcb[-1], "cr": rcr[-1],
                     **_last_row_state(ent, wmb)}}


def _decide_mixed(y, top_row, qp: int) -> dict:
    return intra_mode_decision(y, qp, top_row)


def _code_mixed(y, cb, cr, dec, halo, valid, qp: int, qpc: int) -> dict:
    """One band of a mixed I frame after its mode decision (the reference's
    _make_band_mixed): K7-band, the chroma entropy setup with the band
    above's chroma nC context, K6-band with the band above's last MB row
    and its pre-decided Intra4x4 modes, then the slice entropy."""
    wmb, hloc = y.shape[1] // 16, y.shape[0] // 16
    m16, mode4 = dec["mode16"], dec["mode4"]
    cmode = const(INTRA16_TO_CHROMA_MODE, y.device)[m16.long()]
    rcb, rcr, cdc, cac = chroma_band(cb, cr, cmode, qpc,
                                     None if halo is None else (halo["cb"], halo["cr"]))
    ch = chroma_setup(cdc, cac, wmb, hloc, None if halo is None else _ctx(halo)[2:])
    mx = mixed_luma_band(y, m16, mode4, cmode, ch["cbp_chroma"], ch["bits"], qp,
                         None if halo is None else {k: halo[k] for k in TOP_KEYS})
    ent = mixed_slice_entropy(
        mx["choice4"], m16, cmode, mx["i16dc"], mx["i16ac"], mx["lv4"],
        mx["prev_flags"], mx["rem_modes"], mx["cbp_luma"], mx["tc_luma"],
        cdc, cac, wmb=wmb, hmb=hloc, top_ctx=_ctx(halo), valid=valid, chroma=ch)
    return {"words": ent["words"], "nbits": ent["nbits"],
            "recon": (mx["recon_y"], rcb, rcr),
            "halo": {"recon": mx["recon_y"][-1], "cb": rcb[-1], "cr": rcr[-1],
                     "choice4": mx["choice4"][-wmb:], "mode4": mode4[-wmb:],
                     **_last_row_state(ent, wmb)}}


MODES = {"i16": (_decide_i16, _code_i16), "mixed": (_decide_mixed, _code_mixed)}


def _pad_rows(p: np.ndarray, rows: int) -> np.ndarray:
    """p with its last row repeated to `rows` rows."""
    p = np.asarray(p, np.uint8)
    pad = rows - p.shape[0]
    return p if pad == 0 else np.concatenate([p, np.repeat(p[-1:], pad, axis=0)])


class _Bands(_Stream):
    """What TileIntraEncoder and GopTileIntraEncoder share: the band split,
    the per-band pipeline and the stitch."""

    def _setup(self, width: int, height: int, qp: int, n_tile: int, mode: str) -> None:
        _check_size(width, height)
        if mode not in MODES:
            raise ValueError(f"mode={mode!r}: 'i16' or 'mixed'")
        self.w, self.h, self.qp, self.mode = width, height, qp, mode
        self.wmb, self.hmb = width // 16, height // 16
        self.qpc = transform.chroma_qp(qp, 0)
        self.n_tile = n_tile
        # an uneven split pads the frame to n_tile * hloc MB rows
        self.hloc = -(-self.hmb // n_tile)
        self.hmb_pad = self.hloc * n_tile
        self.sps = SPS(pic_width_in_mbs=self.wmb, pic_height_in_map_units=self.hmb)
        self.pps = PPS(pic_init_qp=14 + qp)

    def _queue_frame(self, frame, band_lanes) -> list:
        """Queue one frame's bands, band t on band_lanes[t]; returns each
        band's outputs (words, nbits, recon, halo), nothing read back."""
        decide, code = MODES[self.mode]
        hl = self.hloc
        y, cb, cr = (_pad_rows(p, self.hmb_pad * n) for p, n in zip(frame, (16, 8, 8)))
        outs, halo, event = [], None, None
        for t, lane in enumerate(band_lanes):
            r0 = t * hl
            with lane.queue():
                dev = lane.device
                # the band's source rows, and the source row above it
                ysrc = upload(y[max(16 * r0 - 1, 0): 16 * (r0 + hl)], dev)
                top_row = ysrc[0].to(I32) if t else None
                yb = ysrc[1:] if t else ysrc
                cbb, crb = (upload(p[8 * r0: 8 * (r0 + hl)], dev) for p in (cb, cr))
                valid = None
                if r0 + hl > self.hmb:  # a band with padded MB rows
                    rows = torch.arange(self.wmb * hl, device=dev) // self.wmb
                    valid = rows + r0 < self.hmb
                dec = decide(yb, top_row, self.qp)  # needs no halo
                lane.wait(event)  # the band above has finished this frame
                if halo is not None:
                    halo = {k: v.to(dev, non_blocking=True) for k, v in halo.items()}
                out = code(yb, cbb, crb, dec, halo, valid, self.qp, self.qpc)
                event = lane.record()
            outs.append(out)
            halo = out["halo"]
        return outs

    def _run(self, frames, groups, keep_recon: bool):
        """Encode `frames` with groups[g] (a list of n_tile lanes) taking the
        g-th contiguous share; returns each frame's band payloads [(words,
        nbits)], and sets self.recon when keep_recon."""
        split = shares(len(frames), len(groups))
        queued = [[] for _ in groups]  # per group: its frames' band outputs
        for g, f in interleave(split):
            queued[g].append(self._queue_frame(frames[f], groups[g]))
        # read back band by band: lane t of group g holds band t of its frames
        per_frame = []
        for band_lanes, outs in zip(groups, queued):
            by_band = read_lanes(band_lanes, [[o[t] for o in outs]
                                              for t in range(self.n_tile)])
            per_frame += [[by_band[t][j] for t in range(self.n_tile)]
                          for j in range(len(outs))]
        if keep_recon:
            self.recon = []
            for band_lanes, outs in zip(groups, queued):
                for o in outs:
                    self.recon.append(self._read_recon(band_lanes, o))
        return per_frame

    def _read_recon(self, band_lanes, outs):
        """A frame's recon planes (y, cb, cr) as uint8 numpy, its bands
        joined and the padded rows cut."""
        planes = [[], [], []]
        for lane, out in zip(band_lanes, outs):
            with lane.queue():
                for k in range(3):
                    planes[k].append(out["recon"][k].cpu().numpy())
        return tuple(np.concatenate(p)[: (self.h if k == 0 else self.h // 2)]
                     for k, p in enumerate(planes))


class TileIntraEncoder(_Bands):
    """All-intra encoder with each frame's encode split into MB-row bands
    over `devices` (one band per entry; None: every visible card). mode:
    "i16" or "mixed", as GopIntraEncoder's. Streams are byte-identical to
    GopIntraEncoder's on one device; idr_pic_id counts frames over the
    encoder's life, as the reference's does."""

    def __init__(self, width: int, height: int, qp: int, devices=None,
                 mode: str = "i16") -> None:
        self.devices = resolve_devices(devices)
        self._setup(width, height, qp, len(self.devices), mode)
        self.lanes = [Lane(d) for d in self.devices]
        self.idr_pic_id = -1
        self.recon = None

    def encode_sequence(self, frames, keep_recon: bool = False) -> bytes:
        """frames: list of (y, cb, cr) uint8 numpy planes. Returns SPS, PPS
        and one IDR per frame. keep_recon: also read back every frame's
        recon planes into self.recon, a list of (y, cb, cr) numpy."""
        out = bytearray(self.headers())
        for parts in self._run(frames, [self.lanes], keep_recon):
            self.idr_pic_id += 1
            out += self._idr_nal(parts, self.idr_pic_id)
        return bytes(out)

    def encode_frame(self, y, cb, cr) -> bytes:
        """One frame's IDR NAL; self.recon is then its recon planes."""
        nal = self.encode_sequence([(y, cb, cr)], keep_recon=True)[len(self.headers()):]
        self.recon = self.recon[0]
        return nal


class GopTileIntraEncoder(_Bands):
    """All-intra encoder over an (n_gop, n_tile) grid of devices: the first
    n_gop * n_tile entries of `devices` (repeats allowed; None: every
    visible card), row g encoding the g-th contiguous share of the frames,
    each frame in n_tile MB-row bands across the row. The stream is stitched
    frame-major, band-minor, with idr_pic_id the frame's index, and is
    byte-identical to GopIntraEncoder's on one device."""

    def __init__(self, width: int, height: int, qp: int, n_gop: int, n_tile: int,
                 devices=None, mode: str = "i16") -> None:
        devs = resolve_devices(devices)
        if len(devs) < n_gop * n_tile:
            raise ValueError(f"{len(devs)} devices for a ({n_gop}, {n_tile}) grid")
        self.devices = devs[: n_gop * n_tile]
        self._setup(width, height, qp, n_tile, mode)
        self.n_gop = n_gop
        lane_list = [Lane(d) for d in self.devices]
        self.groups = [lane_list[g * n_tile: (g + 1) * n_tile] for g in range(n_gop)]
        self.recon = None

    def encode_sequence(self, frames, keep_recon: bool = False) -> bytes:
        """frames: list of (y, cb, cr) uint8 numpy planes. Returns the
        Annex-B stream. keep_recon: as TileIntraEncoder's."""
        out = bytearray(self.headers())
        for i, parts in enumerate(self._run(frames, self.groups, keep_recon)):
            out += self._idr_nal(parts, i)
        return bytes(out)
