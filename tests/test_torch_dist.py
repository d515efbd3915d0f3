"""The port's multi-process GOP spans (parallel/dist.py): two localhost CPU
processes under torch.distributed (gloo) encode their spans and process 0
gathers the payloads; the stitched stream must equal, byte for byte, the
single-process encode, as tests/test_dist_multiprocess.py holds the JAX
package's. gop_spans against the JAX function over a grid of sizes."""

import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from h264_fer_tpu.parallel.dist import gop_spans as jax_gop_spans
from h264_fer_tpu_torch.parallel import dist
from h264_fer_tpu_torch.parallel.gop_device import (
    GopIntraEncoder,
    GopIpppEncoder,
    scaling_frames,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("gop_len", [1, 2])
def test_two_process_encode_matches_single(tmp_path, gop_len):
    out, port = tmp_path / "proc0.264", _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, H264_COORD_ADDR=f"127.0.0.1:{port}", H264_NUM_PROCS="2",
                   H264_PROC_ID=str(pid), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "h264_fer_tpu_torch.parallel.dist", str(out), str(gop_len),
             "--device", "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        try:
            log, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"process failed:\n{log[-2000:]}"
    frames = scaling_frames(64, 32, 5)
    if gop_len == 1:
        enc = GopIntraEncoder(64, 32, 30, device="cpu")
    else:
        enc = GopIpppEncoder(64, 32, 30, gop_len=gop_len, device="cpu")
    assert out.read_bytes() == enc.encode_sequence(frames)


def test_single_process_and_spans():
    """Without a process group, encode_multihost is the plain encode; the
    spans are the reference's."""
    frames = scaling_frames(32, 32, 3)
    assert (dist.encode_multihost(frames, 32, 32, 30, devices=["cpu", "cpu"])
            == GopIntraEncoder(32, 32, 30, device="cpu").encode_sequence(frames))
    env = {k: v for k, v in os.environ.items() if k != "H264_COORD_ADDR"}
    assert subprocess.run([sys.executable, "-c",
                           "from h264_fer_tpu_torch.parallel.dist import "
                           "maybe_init_distributed as m; assert m() == (0, 1)"],
                          cwd=ROOT, env=env, timeout=120).returncode == 0
    for n in (0, 1, 5, 7, 16, 33):
        for g in (1, 2, 3, 8):
            for p in (1, 2, 3, 5):
                assert dist.gop_spans(n, g, p) == jax_gop_spans(n, g, p), (n, g, p)
