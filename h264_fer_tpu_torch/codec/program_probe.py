"""Probe the device programs (codec/program.py) on the card, from the root
of a checkout (it takes chip_smoke.py's content, timers and profiler):

    python3 -m h264_fer_tpu_torch.codec.program_probe
    python3 -m h264_fer_tpu_torch.codec.program_probe --cards

Without --cards, on cuda:0 at 1920x1088, QP 28, two probes:
- eager stages around captures: chip_smoke.stage_times (K11, K1t and K10
  of one frame, CUDA events at the host's pace), K1t's queued time
  (chip_smoke.cuda_ms behind a spin) and chip_smoke.band_stage_times
  (band 1 of 4, i16 and mixed), three rounds at each step of: before any
  capture; after chip_smoke.k1_phase (phase 2: K1 and K1t against their
  plain twins); after the device synchronise, torch.cuda.empty_cache and
  the pinned host cache's flush that a capture's entry makes; after an
  all-intra program's capture and 3 encodes of 8 frames through it; after
  the plain chain of those frames (chip_smoke.plain_chain); after a QCIF
  program's capture and encode on the card; after a QCIF encode on the
  CPU (chip_smoke.py's phase 3 makes these before its stage times); after
  a torch.profiler session over the 1080p encoder issuing its launches
  eagerly (the profiler is not run over graph replays: its CUPTI tracing
  crashed chip_smoke.py in CUDAGraph.replay); after an encode issuing its
  launches eagerly. Prints each step's medians (with host ms
  of an i16_frame wrapper call), then the objects the garbage collector
  tracks and the ms of a full collection.
- a scene-cut IPPP sequence: GopIpppEncoder(gop_len=8,
  scene_cut_source=True) on 28 frames whose content flips at frames 5,
  11, 14, 21 and 23, so that its GOPs take five lengths: host ms of a
  first encode (a capture per new length), of a second, and of the eager
  launches, the captures each made, the lane's programs (at most
  parallel/gop_device.GOP_PROGRAMS), the card memory they reserve
  (torch.cuda.memory_reserved before and after), and the streams equal.
With --cards (a machine of two cards or more): GopIntraEncoder (i16 and
mixed) and GopIpppEncoder on cuda:0..n-1, twice each, and a session
Encoder on each card, all through their programs, each stream against
the one-card stream of cuda:0.
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import statistics
import sys
import time

import numpy as np


def _medians(rounds: list) -> dict:
    return {k: statistics.median(r[k] for r in rounds) for k in rounds[0]}


def _fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in d.items())


def stage_step(torch, cs, dev, frame, label: str) -> None:
    """Three rounds of the eager stage times; one line of medians."""
    from h264_fer_tpu_torch.codec.intra_decision import intra16_mode_decision
    from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_frame
    from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    qpc = chroma_qp(cs.QP)
    y, cb, cr = (torch.from_numpy(p).to(dev) for p in frame)
    m16 = intra16_mode_decision(y, cs.QP)[0]
    cm = torch.from_numpy(INTRA16_TO_CHROMA_MODE).to(dev)[m16.long()]
    rounds, bands = [], []
    for _ in range(3):
        r = dict(cs.stage_times(torch, dev, frame))
        r["k1t_queued"] = cs.cuda_ms(torch, lambda: i16_frame(y, cb, cr, m16, cm, cs.QP, qpc),
                                     5, queued=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            i16_frame(y, cb, cr, m16, cm, cs.QP, qpc)
        r["k1t_host_call"] = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
        rounds.append(r)
        band = cs.band_stage_times(torch, dev, frame)
        bands.append({f"{mode}_{k}": v for mode, t in band.items() for k, v in t.items()})
    objects = len(gc.get_objects())
    t0 = time.perf_counter()
    gc.collect()
    gc_ms = (time.perf_counter() - t0) * 1e3
    print(f"stages [{label}]: {_fmt(_medians(rounds))}; then {objects} objects tracked by "
          f"the collector, a full collection {gc_ms:.1f} ms", flush=True)
    print(f"band stages [{label}]: {_fmt(_medians(bands))}", flush=True)


def stages_probe(torch, cs, dev, name: str) -> None:
    from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder

    frames = cs.content(cs.N_FRAMES, cs.W, cs.H)
    stage_step(torch, cs, dev, frames[0], "before any capture")
    cs.k1_phase(torch, dev, np.random.default_rng(cs.SEED))
    stage_step(torch, cs, dev, frames[0], "after chip_smoke.py's phase 2 (k1_phase)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch._C._host_emptyCache()
    stage_step(torch, cs, dev, frames[0], "after a capture's cache flushes, no capture")
    enc = GopIntraEncoder(cs.W, cs.H, cs.QP, device=dev)
    for _ in range(3):
        enc.encode_sequence(frames)
    stage_step(torch, cs, dev, frames[0], "after an all-intra capture and 3 encodes")
    kept = cs.plain_chain(torch, dev, enc, frames)  # phase 3 keeps it for the decode gate
    stage_step(torch, cs, dev, frames[0], "after the plain chain of those frames")
    qcif = cs.qcif_clip(10)
    GopIntraEncoder(176, 144, cs.QP, device=dev).encode_sequence(qcif)
    stage_step(torch, cs, dev, frames[0], "after a QCIF program's capture on the card")
    GopIntraEncoder(176, 144, cs.QP, device="cpu").encode_sequence(qcif)
    stage_step(torch, cs, dev, frames[0], "after a QCIF encode on the CPU")
    with cs.eager_programs():
        eager = GopIntraEncoder(cs.W, cs.H, cs.QP, device=dev)
        cs.device_busy(torch, lambda: eager.encode_sequence(frames[:2]))
    stage_step(torch, cs, dev, frames[0], "after a torch.profiler session")
    with cs.eager_programs():
        GopIntraEncoder(cs.W, cs.H, cs.QP, device=dev).encode_sequence(frames)
    stage_step(torch, cs, dev, frames[0], "after an eager encode")
    del kept
    print(f"(stage ms: CUDA events; k1t_host_call: host ms a call of the i16_frame wrapper, "
          f"20 calls queued) on {name}", flush=True)


def scene_cut_frames(cs, cuts=(5, 11, 14, 21, 23), n: int = 28) -> list:
    """cs.content frames whose luma flips (255 - y) at each cut."""
    flip = np.cumsum(np.isin(np.arange(n), cuts)) % 2
    return [(255 - y if f else y, cb, cr)
            for (y, cb, cr), f in zip(cs.content(n, cs.W, cs.H), flip)]


def scene_cut_probe(torch, cs, dev, name: str) -> None:
    from h264_fer_tpu_torch.codec.program import DeviceProgram
    from h264_fer_tpu_torch.parallel.gop_device import GOP_PROGRAMS, GopIpppEncoder

    frames = scene_cut_frames(cs)
    captures = []
    capture = DeviceProgram._capture

    def counted(self):
        capture(self)
        captures.append(self.capture_ms)

    def make():
        return GopIpppEncoder(cs.W, cs.H, cs.QP, gop_len=cs.GOP_LEN, device=dev,
                              scene_cut_source=True)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    enc = make()
    lens = enc._gop_lengths(frames)
    DeviceProgram._capture = counted
    try:
        runs = []
        for _ in range(2):
            n0 = len(captures)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream = enc.encode_sequence(frames)
            runs.append(((time.perf_counter() - t0) * 1e3, len(captures) - n0, stream))
    finally:
        DeviceProgram._capture = capture
    torch.cuda.synchronize()
    held = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
    with cs.eager_programs():
        make().encode_sequence(frames[:2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = make().encode_sequence(frames)
        eager_ms = (time.perf_counter() - t0) * 1e3
    if any(r[2] != eager for r in runs):
        raise AssertionError("scene-cut IPPP: a program stream != the eager stream")
    kept = len(enc.lanes[0].programs)
    if kept > GOP_PROGRAMS:
        raise AssertionError(f"scene-cut IPPP: the lane keeps {kept} programs")
    print(f"scene-cut IPPP (GopIpppEncoder gop_len {cs.GOP_LEN}, scene_cut_source, "
          f"{len(frames)} frames {cs.W}x{cs.H} QP{cs.QP}, GOP lengths {lens}): first encode "
          f"{runs[0][0]:.1f} ms ({runs[0][1]} captures, "
          f"{', '.join(f'{c:.1f}' for c in captures[:runs[0][1]])} ms), second "
          f"{runs[1][0]:.1f} ms ({runs[1][1]} captures), eager launches {eager_ms:.1f} ms; "
          f"the lane keeps {kept} programs (at most {GOP_PROGRAMS}), {held:.0f} MiB more "
          f"reserved on the card; streams equal, "
          f"{len(eager)} bytes, on {name}", flush=True)


def cards_probe(torch, cs, name: str) -> None:
    from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
    from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder, GopIpppEncoder

    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"--cards needs two cards or more; this machine has {n}")
    cards = [f"cuda:{i}" for i in range(n)]
    intra, ippp = cs.content(2 * n, cs.W, cs.H), cs.content(4 * n, cs.W, cs.H)
    for label, make, fs in (
            ("GopIntraEncoder i16", lambda d: GopIntraEncoder(cs.W, cs.H, cs.QP, devices=d),
             intra),
            ("GopIntraEncoder mixed",
             lambda d: GopIntraEncoder(cs.W, cs.H, cs.QP, mode="mixed", devices=d), intra),
            ("GopIpppEncoder", lambda d: GopIpppEncoder(cs.W, cs.H, cs.QP, gop_len=4,
                                                        devices=d), ippp)):
        one = make(cards[:1]).encode_sequence(fs)
        enc = make(cards)
        for rep in range(2):
            if enc.encode_sequence(fs) != one:
                raise AssertionError(f"{label} on {n} cards, run {rep + 1}: stream != one card's")
        for lane in enc.lanes:
            for prog in lane.programs.values():
                if prog.cuda_graph is None or prog.device != lane.device:
                    raise AssertionError(f"{label}: a program of {lane.device} is not its graph")
        print(f"{label} on cuda:0..{n - 1} (a lane a card, programs replayed twice): streams "
              f"== one card's, {len(fs)} frames {cs.W}x{cs.H}, on {name}", flush=True)
    cfg = EncoderConfig(qp=cs.QP, intra_every=4, deblock=True)
    one = Encoder(cs.W, cs.H, cfg, device=cards[0]).encode_sequence(ippp[:8])
    for card in cards[1:]:
        if Encoder(cs.W, cs.H, cfg, device=card).encode_sequence(ippp[:8]) != one:
            raise AssertionError(f"session Encoder on {card}: stream != cuda:0's")
    print(f"session Encoder (IDR every 4, deblock, 8 frames) on each of cuda:1..{n - 1}: "
          f"stream == cuda:0's, on {name}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", action="store_true")
    args = ap.parse_args()
    faulthandler.enable()
    sys.path.insert(0, ".")
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("program_probe: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.build_all()
    name = cs.card()
    print(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.cards:
        cards_probe(torch, cs, name)
    else:
        dev = torch.device("cuda:0")
        stages_probe(torch, cs, dev, name)
        scene_cut_probe(torch, cs, dev, name)
    print(f"program_probe done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
