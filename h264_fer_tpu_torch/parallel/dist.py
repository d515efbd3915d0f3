"""Multi-process GOP spans: the counterpart of h264_fer_tpu/parallel/dist.py.

IDR-delimited GOPs are independent (the encoder zeroes its MV state at an
IDR), so across processes the sequence splits into contiguous spans of
GOPs. Every process encodes its span with the sequence encoders of
parallel/gop_device.py on its own devices, and process 0 gathers the
compressed payloads and writes the one stream: the only data that crosses
processes is the stream's bytes, over torch.distributed's gloo backend (as
the reference gathers them with multihost_utils.process_allgather).

Environment contract (the reference's):
  H264_COORD_ADDR   "host:port" of process 0's rendezvous; its presence
                    enables the multi-process setup
  H264_NUM_PROCS    the number of processes
  H264_PROC_ID      this process's index (0-based)
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def maybe_init_distributed() -> tuple:
    """Join the process group the environment describes (gloo,
    tcp://H264_COORD_ADDR) unless it is joined already. Returns (process
    index, process count); (0, 1) when H264_COORD_ADDR is not set."""
    addr = os.environ.get("H264_COORD_ADDR")
    if not addr:
        return 0, 1
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                                world_size=int(os.environ.get("H264_NUM_PROCS", "1")),
                                rank=int(os.environ.get("H264_PROC_ID", "0")))
    return dist.get_rank(), dist.get_world_size()


def gop_spans(n_frames: int, gop_len: int, n_procs: int) -> list:
    """Each process's contiguous (start_frame, end_frame), balanced by GOP
    count: GOPs are the unit, so every span starts on an IDR and no
    prediction state crosses spans."""
    n_gops = -(-n_frames // gop_len)
    base, rem = divmod(n_gops, n_procs)
    spans, g0 = [], 0
    for p in range(n_procs):
        g1 = g0 + base + (1 if p < rem else 0)
        spans.append((min(g0 * gop_len, n_frames), min(g1 * gop_len, n_frames)))
        g0 = g1
    return spans


def _local_devices() -> list:
    """Every card this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def encode_multihost(frames, width: int, height: int, qp: int, gop_len: int = 1,
                     mode: str = "i16", devices=None):
    """Encode `frames` with their GOPs split across the processes of the
    default process group (one process when none is initialised).

    Each process encodes its span on `devices` (default: every card it
    sees) with GopIntraEncoder (gop_len <= 1; idr_pic_id runs on across
    spans, idr_base = the span's first frame) or GopIpppEncoder(gop_len).
    Process 0 gathers the length-prefixed payloads in process order and
    returns the stream with one SPS/PPS; the others return None. One
    process returns its stream, the plain sequence encode."""
    from .gop_device import GopIntraEncoder, GopIpppEncoder

    multi = dist.is_available() and dist.is_initialized()
    pid, nproc = (dist.get_rank(), dist.get_world_size()) if multi else (0, 1)
    lo, hi = gop_spans(len(frames), max(gop_len, 1), nproc)[pid]
    devices = _local_devices() if devices is None else devices
    if gop_len <= 1:
        enc = GopIntraEncoder(width, height, qp, mode=mode, devices=devices)
        local = enc.encode_sequence(frames[lo:hi], idr_base=lo) if hi > lo else b""
    else:
        enc = GopIpppEncoder(width, height, qp, gop_len=gop_len, devices=devices)
        local = enc.encode_sequence(frames[lo:hi]) if hi > lo else b""
    # each span's stream without its SPS/PPS; process 0 writes them once
    hdr = enc.headers()
    body = local[len(hdr):]
    if nproc == 1:
        return hdr + body
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(nproc)]
    dist.all_gather(lens, torch.tensor([len(body)], dtype=torch.int64))
    maxlen = max(int(n) for n in lens)
    buf = torch.zeros(maxlen, dtype=torch.uint8)
    buf[: len(body)] = torch.from_numpy(np.frombuffer(body, np.uint8).copy())
    bufs = [torch.zeros(maxlen, dtype=torch.uint8) for _ in range(nproc)]
    dist.all_gather(bufs, buf)
    if pid != 0:
        return None
    return hdr + b"".join(bytes(b[: int(n)].numpy()) for b, n in zip(bufs, lens))


def main(argv=None) -> int:
    """One process of a multi-process encode:

        H264_COORD_ADDR=127.0.0.1:PORT H264_NUM_PROCS=2 H264_PROC_ID=I \\
            python -m h264_fer_tpu_torch.parallel.dist OUT GOP_LEN \\
            [--size 64x32] [--frames 5] [--qp 30] [--device cuda|cpu]

    encodes gop_device.scaling_frames of the size (made from a seed, the
    same in every process) with encode_multihost on every card this
    process sees (--device cpu: on the CPU); process 0 writes the stream
    to OUT."""
    import argparse

    from .gop_device import scaling_frames

    p = argparse.ArgumentParser(prog="h264_fer_tpu_torch.parallel.dist")
    p.add_argument("out")
    p.add_argument("gop_len", type=int)
    p.add_argument("--size", default="64x32")
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--qp", type=int, default=30)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    w, h = (int(v) for v in args.size.split("x"))
    pid, nproc = maybe_init_distributed()
    stream = encode_multihost(scaling_frames(w, h, args.frames), w, h, args.qp,
                              gop_len=args.gop_len,
                              devices=["cpu"] if args.device == "cpu" else None)
    if pid == 0:
        with open(args.out, "wb") as f:
            f.write(stream)
    if nproc > 1:
        dist.barrier()
        dist.destroy_process_group()
    print(f"process {pid} of {nproc} done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
