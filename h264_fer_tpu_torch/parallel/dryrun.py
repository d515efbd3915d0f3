"""End-to-end dry run of the multi-device encoders: the counterpart of the
reference's dryrun_multichip (__graft_entry__.py:30-146).

    python -m h264_fer_tpu_torch.parallel.dryrun [N] [--device cpu | --cards]

runs over N entries of one device (default 4 of "cuda:0"; with --device cpu,
N of "cpu"), or with --cards over cuda:0..N-1, N distinct cards, where the
band halos cross cards:
  1. GopTileIntraEncoder, all-I16, over a (gop, tile) grid with an uneven
     band split and an odd frame count;
  2. mixed I frames, GopIntraEncoder over the list, and TileIntraEncoder
     over 2 entries with an uneven split;
  3. GopIpppEncoder GOPs over 2 entries with an uneven GOP count;
  4. banded IPPP, GopTileIpppEncoder over the (gop, tile) grid, where the
     P frames' reference windows, MV chain, nC and skip-run halos cross
     the band edges (run when the grid has more than one band).
Every stream must equal the one-device stream of the same frames and decode
through the port's Decoder to one picture per frame.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def content(w: int, h: int, n: int):
    """The reference dry run's frames: stripes plus noise from seed 1."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = (((xx // 3 + yy // 2 + 5 * i) % 210) + rng.integers(0, 8, (h, w))).astype(np.uint8)
        cb = rng.integers(90, 150, (h // 2, w // 2)).astype(np.uint8)
        cr = rng.integers(90, 150, (h // 2, w // 2)).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def grid(n: int) -> tuple:
    """(n_gop, n_tile) of n devices, preferring a 2-D grid (the
    reference's factoring)."""
    n_tile = next((t for t in (4, 2) if n % t == 0 and n > t), 1)
    return n // n_tile, n_tile


def dryrun_multichip(devices, log=print) -> None:
    """Run parts 1-4 over `devices` (a device list, repeats allowed);
    raises AssertionError on the first stream that differs from its
    one-device stream or does not decode."""
    from ..codec.decoder import Decoder
    from ..ops.device import resolve_devices
    from .gop_device import GopIntraEncoder, GopIpppEncoder
    from .tile import GopTileIntraEncoder, TileIntraEncoder
    from .tile_p import GopTileIpppEncoder

    devices = resolve_devices(devices)
    one = devices[:1]
    n_gop, n_tile = grid(len(devices))
    dec = Decoder(device=devices[0])

    def check(stream, want, frames, what):
        """Raise unless `stream` equals `want` and decodes to one picture
        per frame."""
        if stream != want:
            raise AssertionError(f"{what} stream != one-device stream")
        if len(list(dec.decode_annexb(stream))) != len(frames):
            raise AssertionError(f"{what} stream does not decode")

    # 1. (gop, tile) all-I16; 2 * n_tile + 1 MB rows never divide n_tile > 1
    w, h = 64, 16 * (2 * n_tile + 1)
    frames = content(w, h, 2 * n_gop + 1)
    stream = GopTileIntraEncoder(w, h, 30, n_gop, n_tile, devices).encode_sequence(frames)
    check(stream, GopIntraEncoder(w, h, 30, devices=one).encode_sequence(frames), frames,
          "(gop, tile)")
    log(f"dryrun 1/4 OK: (gop={n_gop}, tile={n_tile}) uneven bands (hmb={h // 16}), "
        f"{len(frames)} frames, {len(stream)} bytes")

    # 2. mixed I frames over the list, then in 2 uneven bands (hmb = 3)
    w, h = 64, 32
    frames = content(w, h, len(devices) + 1)
    mixed = GopIntraEncoder(w, h, 26, mode="mixed", devices=devices).encode_sequence(frames)
    check(mixed, GopIntraEncoder(w, h, 26, mode="mixed", devices=one).encode_sequence(frames),
          frames, "mixed")
    mframes = content(64, 48, 2)
    two = devices[:2] if len(devices) > 1 else devices * 2
    tiled = TileIntraEncoder(64, 48, 26, devices=two, mode="mixed").encode_sequence(mframes)
    check(tiled, GopIntraEncoder(64, 48, 26, mode="mixed", devices=one).encode_sequence(
        mframes), mframes, "mixed banded")
    log(f"dryrun 2/4 OK: mixed I frames x{len(frames)} over {len(devices)} devices "
        f"+ mixed in 2 uneven bands, {len(mixed)} bytes")

    # 3. IPPP GOPs over 2 entries, the last GOP short
    w, h, gop_len = 64, 32, 3
    frames = content(w, h, 2 * gop_len + 1)
    ippp = GopIpppEncoder(w, h, 28, gop_len=gop_len, devices=two).encode_sequence(frames)
    check(ippp, GopIpppEncoder(w, h, 28, gop_len=gop_len, devices=one).encode_sequence(frames),
          frames, "IPPP")
    log(f"dryrun 3/4 OK: IPPP GOPs (T={gop_len}) over 2 devices, {len(frames)} frames, "
        f"{len(ippp)} bytes")

    # 4. banded IPPP over the (gop, tile) grid, two MB rows per band
    if n_tile == 1:
        log("dryrun 4/4 skipped: a grid of one band")
        return
    w, h = 64, 16 * 2 * n_tile
    frames = content(w, h, gop_len * n_gop)
    banded = GopTileIpppEncoder(w, h, 28, gop_len, n_gop, n_tile,
                                devices=devices).encode_sequence(frames)
    check(banded, GopIpppEncoder(w, h, 28, gop_len=gop_len, devices=one).encode_sequence(
        frames), frames, "banded IPPP")
    log(f"dryrun 4/4 OK: (gop={n_gop}, tile={n_tile}) banded IPPP, {len(frames)} frames, "
        f"{len(banded)} bytes")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--cards", action="store_true", help="cuda:0..N-1, N distinct cards")
    args = p.parse_args(argv)
    dryrun_multichip([f"cuda:{i}" for i in range(args.n)] if args.cards
                     else [args.device] * args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
