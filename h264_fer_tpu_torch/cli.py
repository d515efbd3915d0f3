"""Command-line interface of the port.

    python -m h264_fer_tpu_torch encode in.y4m out.264 [options]
    python -m h264_fer_tpu_torch decode in.264 out.y4m [--deblock] [--fps N]
    python -m h264_fer_tpu_torch psnr ref.y4m test.y4m

encode takes the JAX package's CLI flags (h264_fer_tpu/cli.py) with its
defaults, so one command line writes the same bytes in both packages. It
runs the session Encoder (codec/encoder.py): by default every frame on the
host, the reference encoder's exact per-MB path (codec/encoder_host.py),
with the in-loop filter K8 on the card under --deblock. --tpu-iframe [i16
or mixed] moves the I frames to the device, --tpu-pframe the P frames,
and --tpu-modes (or --tpu-pframe, or --tpu-iframe off) gives host I frames
the device's intra mode decision. --tpu-me gives host P frames the
device's top-16 integer candidates per 8x8 block (ops/me.py). --device cpu
runs all of it on the CPU (the kernels' plain PyTorch twins).
--gop-devices N runs the sequence encoders instead
(parallel/gop_device.py) over N devices: all-intra when --intra-every is
1 (mixed with --tpu-iframe mixed), else fixed GOPs of --intra-every frames
(--deblock is ignored there, as in the JAX CLI). --tile-devices N runs
parallel/tile.TileIntraEncoder (all-I16) when --intra-every is 1, else
parallel/tile_p.TileIpppEncoder (GOPs of --intra-every frames, with
--window-size, --maxdiff and --no-prefilter), each frame in N MB-row
bands. Both ignore --tpu-me, as the JAX CLI does. The N devices are the
first N cards (fewer where fewer exist), or N entries of "cpu" with
--device cpu. Per-frame statistics (bytes, ms, MB-type histogram) print
with --stats.

decode runs codec/decoder.Decoder: the slice loop on the host (native C++),
and with --deblock the in-loop filter K8 on the card (or its plain twin
with --device cpu) where the stream signals it.
"""

from __future__ import annotations

import argparse
import sys
import time


def _read_frames(args, rd):
    for i, frame in enumerate(rd):
        if args.start_frame and i + 1 < args.start_frame:
            continue
        yield frame
        if args.end_frame and i + 1 >= args.end_frame:
            break


def _devices(device: str, n: int) -> list:
    """The CLI's device list: n entries of "cpu" under --device cpu, else
    the first n cards (fewer where fewer exist, as jax.devices()[:n])."""
    import torch

    from .ops.device import resolve_device

    if resolve_device(device).type == "cpu":
        return ["cpu"] * n
    return [f"cuda:{i}" for i in range(min(n, torch.cuda.device_count()))]


def _cmd_encode(args) -> int:
    from .codec.encoder import Encoder, EncoderConfig
    from .vio.y4m import Y4MReader

    rd = Y4MReader(args.input)
    if args.gop_devices or args.tile_devices:
        from .parallel.gop_device import GopIntraEncoder, GopIpppEncoder
        from .parallel.tile import TileIntraEncoder
        from .parallel.tile_p import TileIpppEncoder

        devices = _devices(args.device, args.tile_devices or args.gop_devices)
        frames = list(_read_frames(args, rd))
        t0 = time.time()
        if args.tile_devices and args.intra_every > 1:
            enc = TileIpppEncoder(
                rd.width, rd.height, args.qp, gop_len=args.intra_every,
                window_size=args.window_size, maxdiff=args.maxdiff,
                lossy_prefilter=not args.no_prefilter, devices=devices)
        elif args.tile_devices:
            enc = TileIntraEncoder(rd.width, rd.height, args.qp, devices=devices)
        elif args.intra_every == 1:
            enc = GopIntraEncoder(rd.width, rd.height, args.qp,
                                  mode="mixed" if args.tpu_iframe == "mixed" else "i16",
                                  devices=devices)
        else:
            enc = GopIpppEncoder(
                rd.width, rd.height, args.qp, gop_len=args.intra_every,
                window_size=args.window_size, maxdiff=args.maxdiff,
                lossy_prefilter=not args.no_prefilter, devices=devices)
        stream = enc.encode_sequence(frames)
        dt = time.time() - t0
        with open(args.output, "wb") as f:
            f.write(stream)
        n = len(frames)
        print(f"{n} frames {rd.width}x{rd.height} -> {len(stream)} bytes "
              f"in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps) [{type(enc).__name__}]")
        return 0

    cfg = EncoderConfig(
        qp=args.qp,
        intra_every=args.intra_every,
        window_size=args.window_size,
        maxdiff=args.maxdiff,
        lossy_prefilter=not args.no_prefilter,
        scene_cut_idr=not args.no_scene_cut,
        deblock=args.deblock,
    )
    # the JAX CLI's choice: host frames unless a --tpu-* flag moves them;
    # any of --tpu-modes / --tpu-iframe / --tpu-pframe builds its device
    # mode decision, which host I frames then take
    iframe = {None: "host", "off": "host"}.get(args.tpu_iframe, args.tpu_iframe)
    enc = Encoder(rd.width, rd.height, cfg, iframe=iframe,
                  pframe="device" if args.tpu_pframe else "host",
                  device_modes=iframe == "host" and bool(
                      args.tpu_modes or args.tpu_iframe or args.tpu_pframe),
                  me="topk" if args.tpu_me else "full", device=args.device)
    t0 = time.time()
    n = 0
    with open(args.output, "wb") as f:
        f.write(enc.headers())
        for frame in _read_frames(args, rd):
            f.write(enc.encode_frame(*frame))
            n += 1
    dt = time.time() - t0
    total = sum(s["bytes"] for s in enc.stats)
    print(
        f"{n} frames {rd.width}x{rd.height} -> {total} bytes "
        f"({total * 8 * rd.header.fps_num / max(1, n) / rd.header.fps_den / 1000:.1f} kbit/s) "
        f"in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps)"
    )
    if args.stats:
        print(f"{'frame':>5} {'type':>4} {'bytes':>7} {'ms':>8}  mb types "
              "[16x16 16x8 8x16 8x8 8x8r0 skip intra]")
        for i, s in enumerate(enc.stats):
            print(f"{i:>5} {'IDR' if s['idr'] else 'P':>4} {s['bytes']:>7} "
                  f"{s['ms']:>8.1f}  {s['mb_types']}")
    return 0


def _cmd_decode(args) -> int:
    from .codec.decoder import Decoder
    from .vio.y4m import Y4MWriter

    with open(args.input, "rb") as f:
        data = f.read()
    dec = Decoder(deblock=args.deblock, device=args.device)
    t0 = time.time()
    wtr = None
    n = 0
    for y, cb, cr in dec.decode_annexb(data):
        if wtr is None:
            wtr = Y4MWriter(args.output, y.shape[1], y.shape[0], args.fps, 1)
        wtr.write_frame(y, cb, cr)
        n += 1
    if wtr:
        wtr.close()
    dt = time.time() - t0
    print(f"{n} frames decoded in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps)")
    return 0


def _cmd_psnr(args) -> int:
    import numpy as np

    from .vio.y4m import Y4MReader, psnr

    a = list(Y4MReader(args.ref, crop_to_mb=False))
    b = list(Y4MReader(args.test, crop_to_mb=False))
    names = ("Y", "Cb", "Cr")
    for k in range(3):
        vals = [psnr(x[k], y[k]) for x, y in zip(a, b)]
        print(f"{names[k]}: mean {np.mean(vals):.2f} dB  min {np.min(vals):.2f}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="h264_fer_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode", help="encode Y4M to Annex-B .264")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--qp", type=int, default=28)
    e.add_argument("--intra-every", type=int, default=100)
    e.add_argument("--window-size", type=int, default=16)
    e.add_argument("--maxdiff", type=int, default=-1)
    e.add_argument("--start-frame", type=int, default=0)
    e.add_argument("--end-frame", type=int, default=0)
    e.add_argument("--no-prefilter", action="store_true")
    e.add_argument("--no-scene-cut", action="store_true")
    e.add_argument("--deblock", action="store_true", help="in-loop deblocking filter")
    e.add_argument("--tpu-modes", action="store_true",
                   help="intra mode pre-decision on the device for host I frames")
    e.add_argument("--tpu-me", action="store_true",
                   help="integer motion search candidates on the device for "
                        "host P frames (top 16 SAD per 8x8 block)")
    e.add_argument("--tpu-iframe", nargs="?", const="i16",
                   choices=["off", "i16", "mixed"], default=None,
                   help="device I frames: i16 (Intra_16x16 only) or mixed (the "
                        "exact I4x4-vs-I16 choice per MB)")
    e.add_argument("--tpu-pframe", action="store_true",
                   help="device P frames (ME maps, decision wavefront, MC and "
                        "recon, slice entropy)")
    e.add_argument("--gop-devices", type=int, default=0, metavar="N",
                   help="the sequence encoders on N devices (all-intra or "
                        "fixed-GOP IPPP; scene cut off)")
    e.add_argument("--tile-devices", type=int, default=0, metavar="N",
                   help="each frame in MB-row bands over N devices (all-intra, "
                        "or fixed-GOP IPPP; scene cut off)")
    e.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    e.add_argument("--stats", action="store_true")
    e.set_defaults(fn=_cmd_encode)

    d = sub.add_parser("decode", help="decode Annex-B .264 to Y4M")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--deblock", action="store_true",
                   help="apply the loop filter when the stream signals it")
    d.add_argument("--fps", type=int, default=24)
    d.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    d.set_defaults(fn=_cmd_decode)

    q = sub.add_parser("psnr", help="PSNR between two Y4M files")
    q.add_argument("ref")
    q.add_argument("test")
    q.set_defaults(fn=_cmd_psnr)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
