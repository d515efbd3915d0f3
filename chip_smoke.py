#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. print the card's name and power limit; build the CUDA kernel from
     h264_fer_tpu_torch/kernels/csrc (nvcc, sm_90a) and print the build time
     and the ptxas report;
  2. hold the K1 wavefront kernel against its plain PyTorch version on the
     card: bit-exact recon at 1920x1088 for QP 8, 28 and 46 on structured
     content made from a seed, plus two small grids (wide and tall); time
     both with CUDA events;
  3. drive the main path: GopIntraEncoder encodes 8 frames at 1920x1088,
     QP 28, on the card with the launch counts set to 0 just before; the
     stream must equal, byte for byte, the stream of the plain chain (mode
     decision, plain K1, levels, entropy) on the card, and parse back into
     SPS, PPS and 8 IDR slices; a QCIF stream from the card must equal the
     CPU path's (the path the CPU tests hold against the JAX reference).
     Prints e2e fps, device frame fps and the per-stage device times;
  4. print the kernels line and, last, {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

W, H, QP, N_FRAMES = 1920, 1088, 28, 8
E2E_REPS = 5
CHECK_QPS = (8, 28, 46)
SEED = 7
# H100 SXM at 700 W: HBM3 rate (data sheet), and the int32 rate of the CUDA
# cores (H100 whitepaper: 132 SMs x 64 int32 lanes x 1.98 GHz boost); K1's
# work is int32.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def content(n: int, w: int, h: int, seed: int = SEED):
    """Structured frames (gradients + texture, as bench.py's), from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = (((xx // 7 + yy // 5 + 3 * i) % 200)
             + rng.integers(0, 12, (h, w))).astype(np.uint8)
        cb = rng.integers(100, 140, (h // 2, w // 2)).astype(np.uint8)
        cr = rng.integers(100, 140, (h // 2, w // 2)).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() in ms over `reps` calls after one warm-up,
    timed with CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_pixel_ops(qp: int) -> float:
    """int32 operations per reconstructed sample that K1's function needs
    at this QP, in its minimal form, outside prediction and the DC path."""
    # ((d << s) - adj) * lq + 2^14 >> 15, or (d >> s) * lq + 2^14 >> 15
    quant = 5 if qp < 24 else 4
    # (c * ls + rnd) >> s, or (c * ls) << s
    dequant = 3 if qp < 24 else 2
    return (1 + 3          # residual; the reference's h = d ? 64 d - 32 : 0
            + 2 * 22 / 4   # forward core transform: per pass and 4 outputs, 4
                           # butterfly adds, 2 x (add, scale, +512, >>10),
                           # 2 x (2 mul, add, +512, >>10)
            + 15 / 16 * (quant + dequant)  # the 15 AC coefficients of 16
            + 2 * 10 / 4   # inverse core transform: per pass and 4 outputs,
                           # 4 adds, 2 shifts, 4 adds
            + 5)           # +32, >>6, +pred, clip (min, max)


def k1_ops(qp: int, qpc: int, m16: np.ndarray, cm: np.ndarray) -> float:
    """int32 operations K1's function needs for one frame in these modes:
    butterflies for every transform, each value computed once."""
    nmb = m16.size
    luma_dc = 16 * (2 * 2 + 2 + (5 if qp < 36 else 4)  # 4x4 Hadamard, round,
                    + 2 * 2 + (3 if qp < 36 else 2))   # quant; inverse, scale
    chroma_dc = 4 * (2 + 2 + 5 + 2 + 3)  # 2x2 Hadamard, round, quant, inverse, scale
    # prediction: V and H copy; DC sums its 32 (chroma 2 x 8) samples;
    # Plane needs its gradients per MB and an add, a shift and a clip per sample
    luma_pred = (np.count_nonzero(m16 == 2) * 36
                 + np.count_nonzero(m16 == 3) * (54 + 4 * 256))
    chroma_pred = 2 * (np.count_nonzero(cm == 0) * 22
                       + np.count_nonzero(cm == 3) * (30 + 4 * 64))
    return (nmb * (256 * k1_pixel_ops(qp) + luma_dc
                   + 2 * 64 * k1_pixel_ops(qpc) + 2 * chroma_dc)
            + luma_pred + chroma_pred)


def k1_bound(w: int, h: int, qp: int, qpc: int, m16, cm):
    """(bound_ms, bound_by) of one K1 frame: each input byte read once
    (uint8 planes, int32 modes), each output byte written once, against the
    int32 operations its function needs in these modes."""
    nmb = (w // 16) * (h // 16)
    pixels = w * h * 3 // 2
    nbytes = 2 * pixels + 2 * 4 * nmb
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = k1_ops(qp, qpc, m16, cm) / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def check_k1(torch, dev, name, frame, qp, modes=None):
    """K1 kernel vs plain on one frame, in the decided modes or in the given
    (mode16, chroma mode) arrays; returns (max_abs_err, ms, plain_ms,
    bound_ms, bound_by)."""
    from h264_fer_tpu_torch.codec.intra_decision import intra16_mode_decision
    from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_recon, i16_recon_plain
    from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    y, cb, cr = (torch.from_numpy(p).to(dev) for p in frame)
    if modes is None:
        m16 = intra16_mode_decision(y.to(torch.int32), qp)[0].to(torch.int32)
        cm = torch.from_numpy(INTRA16_TO_CHROMA_MODE).to(dev)[m16.long()]
    else:
        m16, cm = (torch.from_numpy(m).to(dev) for m in modes)
    qpc = chroma_qp(qp)
    got = i16_recon(y, cb, cr, m16, cm, qp, qpc)
    want = i16_recon_plain(y, cb, cr, m16, cm, qp, qpc)
    torch.cuda.synchronize()
    err = max(int((g.int() - r.int()).abs().max()) for g, r in zip(got, want))
    ms = cuda_ms(torch, lambda: i16_recon(y, cb, cr, m16, cm, qp, qpc), 20)
    plain_ms = cuda_ms(torch, lambda: i16_recon_plain(y, cb, cr, m16, cm, qp, qpc), 2)
    print(f"K1 {name} qp{qp}: max_abs_err {err} (tolerance 0), kernel {ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms per frame", flush=True)
    if err != 0:
        raise AssertionError(f"K1 kernel != plain at {name} qp{qp}")
    h, w = y.shape
    bound = k1_bound(w, h, qp, qpc, m16.cpu().numpy(), cm.cpu().numpy())
    return err, ms, plain_ms, *bound


def parse_stream(stream: bytes, n_frames: int, w: int, h: int, qp: int):
    """Read back SPS, PPS and the IDR slice headers with the port's parsers."""
    from h264_fer_tpu_torch.bitstream import nal
    from h264_fer_tpu_torch.bitstream.bitio import BitReader
    from h264_fer_tpu_torch.bitstream.params import I_SLICE, PPS, SPS, SliceHeader

    units = list(nal.iter_nal_units(stream))
    types = [u.nal_unit_type for u in units]
    if types != [nal.NAL_SPS, nal.NAL_PPS] + [nal.NAL_IDR] * n_frames:
        raise AssertionError(f"NAL sequence {types}")
    sps = SPS.parse(BitReader(units[0].rbsp))
    pps = PPS.parse(BitReader(units[1].rbsp))
    if (sps.width, sps.height) != (w, h) or pps.pic_init_qp != 14 + qp:
        raise AssertionError(f"SPS {sps.width}x{sps.height} PPS qp {pps.pic_init_qp}")
    for i, u in enumerate(units[2:]):
        sh = SliceHeader.parse(BitReader(u.rbsp), sps, pps, u.nal_unit_type,
                               u.nal_ref_idc)
        if (sh.slice_type != I_SLICE or sh.idr_pic_id != i
                or sh.slice_qp_y(pps) != qp):
            raise AssertionError(f"slice {i}: {sh}")


def plain_chain_stream(torch, dev, enc, frames) -> bytes:
    """The stream of the oracle chain on the card: mode decision, plain K1,
    levels and entropy per frame, stitched by the encoder."""
    from h264_fer_tpu_torch.codec.entropy import i16_slice_entropy
    from h264_fer_tpu_torch.codec.intra_decision import intra16_mode_decision
    from h264_fer_tpu_torch.kernels.wavefront_i16 import (i16_levels_from_recon,
                                                          i16_recon_plain)
    from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE

    payloads = []
    for frame in frames:
        y, cb, cr = (torch.tensor(p, device=dev) for p in frame)
        m16 = intra16_mode_decision(y.to(torch.int32), enc.qp)[0].to(torch.int32)
        cm = torch.from_numpy(INTRA16_TO_CHROMA_MODE).to(dev)[m16.long()]
        rec = i16_recon_plain(y, cb, cr, m16, cm, enc.qp, enc.qpc)
        lv = i16_levels_from_recon(y, cb, cr, *rec, m16, cm, enc.qp, enc.qpc)
        payloads.append(i16_slice_entropy(m16, cm, *lv, wmb=enc.wmb, hmb=enc.hmb))
    return enc.stitch(payloads)


def stage_times(torch, dev, frame):
    """Device ms of each stage of one 1080p frame, CUDA events."""
    from h264_fer_tpu_torch.codec.entropy import i16_slice_entropy
    from h264_fer_tpu_torch.codec.intra_decision import intra16_mode_decision
    from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_levels_from_recon, i16_recon
    from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    qpc = chroma_qp(QP)
    y, cb, cr = (torch.from_numpy(p).to(dev) for p in frame)
    yi = y.to(torch.int32)
    m16 = intra16_mode_decision(yi, QP)[0].to(torch.int32)
    cm = torch.from_numpy(INTRA16_TO_CHROMA_MODE).to(dev)[m16.long()]
    rec = i16_recon(y, cb, cr, m16, cm, QP, qpc)
    lv = i16_levels_from_recon(y, cb, cr, *rec, m16, cm, QP, qpc)
    return {
        "mode_decision": cuda_ms(torch, lambda: intra16_mode_decision(yi, QP), 5),
        "k1_recon": cuda_ms(torch, lambda: i16_recon(y, cb, cr, m16, cm, QP, qpc), 5),
        "levels": cuda_ms(torch, lambda: i16_levels_from_recon(
            y, cb, cr, *rec, m16, cm, QP, qpc), 5),
        "entropy": cuda_ms(torch, lambda: i16_slice_entropy(
            m16, cm, *lv, wmb=W // 16, hmb=H // 16), 5),
    }


def device_busy(torch, fn):
    """Profile one call of fn(): (wall ms, summed kernel ms, the largest
    kernels as (name, ms, count)). Kernel time 0 means the profiler saw
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return wall * 1e3, busy, [(e.key, e.self_device_time_total / 1e3, e.count)
                              for e in top]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from h264_fer_tpu_torch.kernels import build
    from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_recon
    from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder

    dev = torch.device("cuda")
    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib, log = build.compile_source("wavefront_i16")
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"--- nvcc wavefront_i16 ---\n{log.strip()}", flush=True)

    # ---- 2. K1 kernel vs plain ----------------------------------------------
    small = [("176x144", 176, 144), ("80x176", 80, 176)]
    for label, w, h in small:
        check_k1(torch, dev, label, content(1, w, h)[0], QP)
    # every mode at every MB, the frame edges included, where the -1
    # neighbours of V, H and Plane enter the prediction
    rng = np.random.default_rng(SEED)
    for qp in (0, 51):
        modes = tuple(rng.integers(0, 4, 99).astype(np.int32) for _ in range(2))
        check_k1(torch, dev, "176x144 random modes", content(1, 176, 144)[0],
                 qp, modes)
    k1 = {}
    frame = content(1, W, H)[0]
    for qp in CHECK_QPS:
        k1[qp] = check_k1(torch, dev, f"{W}x{H}", frame, qp)
    print(f"K1 checks done on {name}", flush=True)

    # ---- 3. main path ----------------------------------------------------------
    frames = content(N_FRAMES, W, H)
    enc = GopIntraEncoder(W, H, QP, device=dev)
    enc.encode_sequence(frames[:2])  # warm-up: allocator, library load
    torch.cuda.synchronize()
    i16_recon.launches = 0
    t0 = time.perf_counter()
    stream = enc.encode_sequence(frames)
    e2e_s = [time.perf_counter() - t0]
    launches = i16_recon.launches  # counted by the kernel's C launch loop
    ndiag = W // 16 + H // 16 - 1
    if launches != N_FRAMES * ndiag:
        raise AssertionError(f"K1 launched {launches} times, "
                             f"expected {N_FRAMES * ndiag}")
    if stream != plain_chain_stream(torch, dev, enc, frames):
        raise AssertionError("kernel-path stream != plain-chain stream")
    parse_stream(stream, N_FRAMES, W, H, QP)
    qcif = content(3, 176, 144)
    s_gpu = GopIntraEncoder(176, 144, QP, device=dev).encode_sequence(qcif)
    s_cpu = GopIntraEncoder(176, 144, QP, device="cpu").encode_sequence(qcif)
    if s_gpu != s_cpu:
        raise AssertionError("QCIF stream on the card != CPU path stream")
    for _ in range(E2E_REPS - 1):
        t0 = time.perf_counter()
        enc.encode_sequence(frames)
        e2e_s.append(time.perf_counter() - t0)
    fps = sorted(N_FRAMES / t for t in e2e_s)
    print(f"main path: {N_FRAMES} frames {W}x{H} QP{QP}, {len(stream)} bytes, "
          f"== plain chain, parses; e2e fps median {fps[len(fps) // 2]:.2f} "
          f"(runs {', '.join(f'{v:.2f}' for v in fps)}) on {name}", flush=True)

    from h264_fer_tpu_torch.codec.iframe import device_i16_frame
    from h264_fer_tpu_torch.ops.transform import chroma_qp

    dframes = [tuple(torch.from_numpy(p).to(dev) for p in f) for f in frames]
    qpc = chroma_qp(QP)

    def all_frames():
        for f in dframes:
            device_i16_frame(*f, QP, qpc)

    frame_ms = sorted(cuda_ms(torch, all_frames, 1) / N_FRAMES for _ in range(3))
    print(f"device frame: median {frame_ms[1]:.2f} ms "
          f"({1e3 / frame_ms[1]:.2f} fps; runs "
          f"{', '.join(f'{v:.2f}' for v in frame_ms)} ms) on {name}", flush=True)
    stages = stage_times(torch, dev, frames[0])
    print("stages (device ms, one frame): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f" on {name}", flush=True)
    wall, busy, top = device_busy(torch, lambda: enc.encode_sequence(frames[:2]))
    if busy > 0:
        print(f"profiled 2-frame encode: wall {wall:.1f} ms, kernels "
              f"{busy:.1f} ms, device busy {100 * busy / wall:.1f} % on {name}")
        for key, ms_k, count in top:
            print(f"  {ms_k:8.3f} ms  {count:6d} x  {key[:90]}")
    else:
        print("device busy share: not measured (the profiler saw no device time)")

    # ---- 4. result --------------------------------------------------------
    _, ms, plain_ms, bound_ms, bound_by = k1[QP]
    print(name)
    print(json.dumps({"kernels": [{
        "name": "wavefront_i16",
        "route": "cuda",
        "source": "h264_fer_tpu_torch/kernels/csrc/wavefront_i16.cu",
        "replaces": "h264_fer_tpu/kernels/wavefront_pallas.py:890",
        "launches": launches,
        "max_abs_err": max(k1[q][0] for q in CHECK_QPS),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
