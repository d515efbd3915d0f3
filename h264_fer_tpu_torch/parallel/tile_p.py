"""MB-row band parallelism for P frames: IPPP sequences whose every frame is
encoded in bands of MB rows over a list of devices.

The counterpart of h264_fer_tpu/parallel/tile_p.py: TileIpppEncoder and
GopTileIpppEncoder. Each entry of `devices` (repeats allowed, as in
parallel/gop_device.py) is a lane that encodes one band of every frame:
n_tile bands of hloc = hmb / n_tile MB rows (an even split, as the
reference's). The IDR of each GOP is parallel/tile.py's all-I16 band
(K1t-band); each P frame runs, per band, the device P frame's stages
(codec/pframe.py) over the band's rows, K4-band in place of K4.

Four dependencies of a P frame cross a band edge:
- the reference windows: ME and MC read the previous frame's final
  reference ext + 4 luma and ext_c + 1 chroma rows beyond the band, above
  *and below* (at the frame's edges, the band's own edge row repeated).
  The band builds its interpolated planes from them
  (ops/interp.interpolated_planes_banded), the frame planes' row window.
  This is new against the intra bands: band t's frame f also waits on band
  t+1's frame f-1 reference, after its trailing-skip drop. No cycle
  arises, since f-1 < f;
- the MV-prediction chain: K4-band's row 0 reads the final MVs and types
  of the band above's last MB row;
- the CAVLC nC context: the entropy's top_ctx, the band above's last-row
  TotalCoeff and CBP, taken from its slice entropy's outputs;
- the mb_skip_run chain and the trailing-skip drop, global to the frame.
  A band's leading run counts from the previous coded MB anywhere above
  (run_lead): each band hands down, with its halo, the last coded MB
  index and the payload bits of the bands so far. No band payload holds
  the trailing run: it is the slice's last symbol before the RBSP stop
  bit, so the last band writes ue(trail_total) as one more payload part,
  which the host appends after the bands (the bits are the same as when
  the band holding the frame's last coded MB writes it, as the reference
  does). The last band then has the frame's bit count, trailing run
  included, and its last coded MB: the drop's inputs (codec/gop
  .trailing_skip_drop), one row of three scalars that every band copies
  after an event of the last band's stream to apply the drop to its own
  reference. That is the one all-band reduction of a frame; it needs no
  host sync.
The reference sends the MV halo on every wave of one global wavefront.
Here no launch waits on another: band t codes frame f once band t-1 has
coded frame f (the MV, nC and skip-run halos, one copy each), its
interpolation, ME maps and MAXDIFF queued before that wait, since they
need only the reference windows. Halos are copied on the consumer's lane
after an event of the producer's. Every GOP is a chain of frame steps;
GopTileIpppEncoder's groups of lanes take contiguous shares of the GOPs,
their steps queued in turn, and every lane queues all its frames before
any payload is read back. Each MB reads the same data as on one device,
so the stream is byte-identical to parallel/gop_device.GopIpppEncoder's.
Band outputs and halos stay referenced until every lane has been read
back, so no buffer that another lane's stream reads is reused under it.
"""

from __future__ import annotations

import torch

from ..codec.entropy import p_slice_entropy
from ..codec.gop import restore_dropped, trailing_skip_drop
from ..codec.pframe import adaptive_maxdiff, pframe_maps, pframe_residual_recon
from ..kernels.mc import mc_bulk
from ..kernels.wavefront_p import MB_SKIP, pframe_decide_band
from ..ops.cavlc_bulk import pack_symbols, ue_code
from ..ops.device import resolve_devices, upload
from ..ops.interp import interpolated_planes_banded, pad_chroma_banded
from .gop_device import GopIpppEncoder, interleave, read_lanes, shares
from .tile import _Bands, _ctx, _last_row_state

I32 = torch.int32


def _window(own, above, below, vh: int, dev):
    """(rows + 2 vh, W): a band's reference plane `own` between vh rows of
    `above` (the band above's plane: its last rows) and of `below` (its
    first rows), copied to `dev`; None at a frame edge, where the band's
    own edge row is repeated (the reference's _vhalo_exchange)."""
    top = (own[:1].expand(vh, -1) if above is None
           else above[-vh:].to(dev, non_blocking=True))
    bot = (own[-1:].expand(vh, -1) if below is None
           else below[:vh].to(dev, non_blocking=True))
    return torch.cat([top, own, bot])


class _PBands(_Bands, GopIpppEncoder):
    """What TileIpppEncoder and GopTileIpppEncoder share: the band split,
    GopIpppEncoder's GOPs and slice headers, the per-band P step and the
    stitch."""

    def _psetup(self, width: int, height: int, qp: int, gop_len: int, devices,
                window_size: int, maxdiff: int, lossy_prefilter: bool, n_tile: int) -> None:
        GopIpppEncoder.__init__(self, width, height, qp, gop_len, window_size, maxdiff,
                                lossy_prefilter, devices=devices)
        self._setup(width, height, qp, n_tile, "i16")
        if self.hmb % n_tile:
            raise ValueError(f"{self.hmb} MB rows do not split evenly into {n_tile} bands "
                             "(P-frame bands need an even split)")
        if 16 * self.hloc < self.window + 6:  # ext + 4 rows of the neighbours' reference
            raise ValueError(f"bands of {self.hloc} MB rows are shorter than the "
                             f"reference window's {self.window + 6} rows above and below")
        self.recon = None

    def _queue_p(self, frame, band_lanes, state, hdr_bits: int) -> list:
        """Queue one P frame's bands, band t on band_lanes[t], against the
        bands' references `state` (per band: ref (y, cb, cr, mv) and the
        event after which it is final), which it replaces by the frame's.
        Returns each band's outputs (words, nbits, recon, and what other
        lanes read), then the trailing run's payload; nothing read back."""
        hl, wmb = self.hloc, self.wmb
        nmbl = wmb * hl
        ext = self.window + 2
        ext_c = ext // 2 + 1
        n = len(band_lanes)
        outs, above, event = [], None, None
        for t, lane in enumerate(band_lanes):
            r0 = t * hl
            nbr = [state[t - 1] if t else None, state[t + 1] if t + 1 < n else None]
            with lane.queue():
                dev = lane.device
                ys, cbs, crs = (upload(p[k * r0: k * (r0 + hl)], dev)
                                for p, k in zip(frame, (16, 8, 8)))
                for s in nbr:  # frame f-1's final reference of the neighbours
                    if s is not None:
                        lane.wait(s["event"])
                own = state[t]["ref"]
                win = [_window(own[k], *(None if s is None else s["ref"][k] for s in nbr),
                               vh, dev) for k, vh in ((0, ext + 4), (1, ext_c + 1),
                                                      (2, ext_c + 1))]
                planes = interpolated_planes_banded(win[0], ext)
                cb_pad, cr_pad = (pad_chroma_banded(c, ext_c) for c in win[1:])
                maps = pframe_maps(ys, planes, own[3], wmb, hl, self.window, self.qp)
                maxdiff = adaptive_maxdiff(ys, wmb, hl, self.maxdiff)
                lane.wait(event)  # the band above has coded this frame
                halo = (None if above is None
                        else {k: v.to(dev, non_blocking=True) for k, v in above.items()})
                dec = pframe_decide_band(
                    ys, planes, maps["int_map"], maps["c1mv"], maps["q1map"], maps["c2mv"],
                    maps["q2map"], maps["q2ok"], maxdiff, wmb, hl, self.window, ext,
                    maps["metric_id"], maps["lam"],
                    None if halo is None else (halo["mv"], halo["t"]))
                pred = mc_bulk(planes, cb_pad, cr_pad, dec["mv"], ext, ext_c, wmb, hl)
                levels, ry, rcb, rcr = pframe_residual_recon(
                    ys, cbs, crs, *pred, dec["skip"], maxdiff, wmb, hl, self.qp, self.qpc,
                    self.prefilter)
                base = t * nmbl
                # the last coded MB above the band (-1: none) and the bits so far
                prev_last, bits = (-1, 0) if halo is None else halo["run"]
                ent = p_slice_entropy(
                    dec["skip"], dec["mb_type"], dec["mvd"], levels["luma"], levels["cdc"],
                    levels["cac"], wmb=wmb, hmb=hl, top_ctx=_ctx(halo),
                    run_lead=base - prev_last - 1)
                idx = torch.arange(base, base + nmbl, device=dev)
                last = torch.where(dec["skip"], -1, idx).amax()
                if halo is not None:
                    last = torch.maximum(last, prev_last)
                above = {"mv": dec["mv"][-wmb:],
                         "t": torch.where(dec["skip"][-wmb:], MB_SKIP,
                                          dec["mb_type"][-wmb:]).to(I32),
                         "run": torch.stack([last, ent["nbits"] + bits]),
                         **_last_row_state(ent, wmb)}
                # on the lane's stream, which orders it after the recon
                u8 = torch.uint8
                recon = {"recon_y": ry.to(u8), "recon_cb": rcb.to(u8), "recon_cr": rcr.to(u8)}
                event = lane.record()
            outs.append({"words": ent["words"], "nbits": ent["nbits"], "halo": above,
                         "skip": dec["skip"], "out": {**recon, "mv": dec["mv"]}})
        # the frame's trailing run and the drop's inputs, on the last lane
        with band_lanes[-1].queue():
            last, bits = above["run"]
            trail = self.nmb - 1 - last  # the frame's MB count when none is coded
            t_v, t_l = ue_code(trail.reshape(1))
            words, t_bits = pack_symbols(t_v.to(I32), torch.where(trail > 0, t_l, 0))
            drop_in = torch.stack([bits + t_bits, t_bits, last])
            event = band_lanes[-1].record()
        for t, lane in enumerate(band_lanes):
            with lane.queue():
                lane.wait(event)
                total_bits, trail_bits, frame_last = drop_in.to(lane.device, non_blocking=True)
                o = outs[t]
                keep = trailing_skip_drop(o["skip"], total_bits, trail_bits, hdr_bits,
                                          last_coded=frame_last, base=t * nmbl)
                ref = restore_dropped(keep, state[t]["ref"], o.pop("out"))
                o["recon"] = ref[:3]
                # the old reference stays referenced: other lanes may still read it
                o["old_ref"] = state[t]["ref"]
                state[t] = {"ref": ref, "event": lane.record()}
        return outs + [{"words": words, "nbits": t_bits, "drop_in": drop_in}]

    def _queue_gop(self, frames, band_lanes):
        """Queue one GOP (frames[0] its IDR) in bands on band_lanes: a
        generator that queues one frame per step and yields its parts, a
        list of (band, outputs) in payload order."""
        outs = self._queue_frame(frames[0], band_lanes)  # K1t-band
        state = []
        for lane, o in zip(band_lanes, outs):
            with lane.queue():
                mv0 = torch.zeros((self.wmb * self.hloc, 4, 2), dtype=I32, device=lane.device)
                state.append({"ref": (*o["recon"], mv0), "event": lane.record()})
        yield list(enumerate(outs))
        for frame, hdr_bits in zip(frames[1:], self.hdr_bits):
            parts = self._queue_p(frame, band_lanes, state, hdr_bits)
            yield list(enumerate(parts[:-1])) + [(len(band_lanes) - 1, parts[-1])]

    def _run(self, frames, groups, keep_recon: bool) -> bytes:
        """Encode `frames` with groups[g] (a list of n_tile lanes) taking the
        g-th contiguous share of the GOPs; returns the stream, and sets
        self.recon when keep_recon (each frame's final reference planes,
        what a decoder holds after it, as uint8 numpy (y, cb, cr))."""
        lens = self._gop_lengths(frames)
        starts = [sum(lens[:g]) for g in range(len(lens))]
        split = shares(len(lens), len(groups))

        def steps(g):
            for k in split[g]:
                yield from self._queue_gop(frames[starts[k]: starts[k] + lens[k]], groups[g])

        # queue the groups' frame steps in turn: frame order within a group
        queued = [[] for _ in groups]
        gens = [steps(g) for g in range(len(groups))]
        for g, _ in interleave([range(sum(lens[k] for k in s)) for s in split]):
            queued[g].append(next(gens[g]))
        per_frame = []
        for band_lanes, group in zip(groups, queued):
            by_lane = [[o for fr in group for t, o in fr if t == b]
                       for b in range(len(band_lanes))]
            read = [iter(r) for r in read_lanes(band_lanes, by_lane)]
            per_frame += [[next(read[t]) for t, _ in fr] for fr in group]
        if keep_recon:
            self.recon = [self._read_recon(band_lanes, [o for _, o in fr[: self.n_tile]])
                          for band_lanes, group in zip(groups, queued) for fr in group]
        return self._write(per_frame, lens)


class TileIpppEncoder(_PBands):
    """IPPP sequence encoder with every frame's encode split into MB-row
    bands over `devices` (one band per entry; None: every visible card;
    the MB rows must split evenly). gop_len, window_size, maxdiff and
    lossy_prefilter as GopIpppEncoder's. Streams are byte-identical to
    GopIpppEncoder's on one device (deblock off, no scene cuts)."""

    def __init__(self, width: int, height: int, qp: int, gop_len: int,
                 window_size: int = 16, maxdiff: int = -1, lossy_prefilter: bool = True,
                 devices=None) -> None:
        devs = resolve_devices(devices)
        self._psetup(width, height, qp, gop_len, devs, window_size, maxdiff,
                     lossy_prefilter, len(devs))

    def encode_sequence(self, frames, keep_recon: bool = False) -> bytes:
        """frames: list of (y, cb, cr) uint8 numpy planes. Returns the
        Annex-B stream. keep_recon: also read back every frame's final
        reference planes into self.recon, a list of (y, cb, cr) numpy."""
        return self._run(frames, [self.lanes], keep_recon)


class GopTileIpppEncoder(_PBands):
    """IPPP encoder over an (n_gop, n_tile) grid of devices: the first
    n_gop * n_tile entries of `devices` (repeats allowed; None: every
    visible card), row g encoding the g-th contiguous share of the GOPs,
    each frame in n_tile MB-row bands across the row. A short last GOP
    needs no padding. Byte-identical to GopIpppEncoder's stream on one
    device."""

    def __init__(self, width: int, height: int, qp: int, gop_len: int, n_gop: int,
                 n_tile: int, window_size: int = 16, maxdiff: int = -1,
                 lossy_prefilter: bool = True, devices=None) -> None:
        devs = resolve_devices(devices)
        if len(devs) < n_gop * n_tile:
            raise ValueError(f"{len(devs)} devices for a ({n_gop}, {n_tile}) grid")
        self._psetup(width, height, qp, gop_len, devs[: n_gop * n_tile], window_size,
                     maxdiff, lossy_prefilter, n_tile)
        self.n_gop = n_gop
        self.groups = [self.lanes[g * n_tile: (g + 1) * n_tile] for g in range(n_gop)]

    def encode_sequence(self, frames, keep_recon: bool = False) -> bytes:
        """frames: list of (y, cb, cr) uint8 numpy planes. Returns the
        Annex-B stream. keep_recon: as TileIpppEncoder's."""
        return self._run(frames, self.groups, keep_recon)
