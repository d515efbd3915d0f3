"""The session Encoder's ME options and the CLI against the JAX package:
with deblock off, window_size=8, maxdiff=6 and lossy_prefilter=False at
QP 28 the port's stream equals the JAX Encoder's (fully-device
configuration) byte for byte; GopIpppEncoder takes the same options; the
CLI's encode writes the port Encoder's bytes and its psnr prints the JAX
CLI's values."""

import numpy as np
import pytest
import torch

from h264_fer_tpu import cli as jax_cli
from h264_fer_tpu.codec.encoder import Encoder as JaxEncoder
from h264_fer_tpu.codec.encoder import EncoderConfig as JaxEncoderConfig
from h264_fer_tpu.codec.tpu_intra import TpuIntraPipeline
from h264_fer_tpu.vio.y4m import Y4MReader
from h264_fer_tpu_torch import cli
from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder, GopIpppEncoder
from h264_fer_tpu_torch.parallel.tile_p import TileIpppEncoder

torch.set_num_threads(1)

W, H = 176, 144
CFG = dict(qp=28, intra_every=4, window_size=8, maxdiff=6, lossy_prefilter=False)
ARGS = ["--qp", "28", "--intra-every", "4", "--window-size", "8", "--maxdiff", "6",
        "--no-prefilter", "--device", "cpu"]


@pytest.fixture(scope="module")
def clip_path(fixtures_dir):
    return str(fixtures_dir / "clip_qcif_10f.y4m")


@pytest.fixture(scope="module")
def clip(clip_path):
    return list(Y4MReader(clip_path))


@pytest.fixture(scope="module")
def streams(clip):
    """(JAX Encoder stream, its stats, port Encoder stream)."""
    ref = JaxEncoder(W, H, JaxEncoderConfig(**CFG), tpu_pipeline=TpuIntraPipeline(W, H, 28),
                     tpu_iframe=True, tpu_pframe=True)
    return (ref.encode_sequence(clip), ref.stats,
            Encoder(W, H, EncoderConfig(**CFG), device="cpu").encode_sequence(clip))


def test_session_options_stream_byte_identical_to_jax(streams):
    ref, stats, got = streams
    assert got == ref
    assert [s["idr"] for s in stats] == [i % 4 == 0 for i in range(10)]  # no scene cut


def test_gop_ippp_encoder_options_equal_session(clip, streams):
    """With no scene cut in the clip, the fixed-GOP encoder with the same
    options writes the session's stream (the JAX GopIpppEncoder's
    contract)."""
    enc = GopIpppEncoder(W, H, 28, gop_len=4, window_size=8, maxdiff=6,
                         lossy_prefilter=False, device="cpu")
    assert (enc.window, enc.maxdiff, enc.prefilter) == (4, 6, False)
    assert enc.encode_sequence(clip) == streams[2]


def test_cli_encode_writes_encoder_bytes(clip_path, streams, tmp_path, capsys):
    out = tmp_path / "s.264"
    assert cli.main(["encode", clip_path, str(out), *ARGS, "--tpu-iframe", "--tpu-pframe",
                     "--stats"]) == 0
    assert out.read_bytes() == streams[0]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"10 frames {W}x{H} -> ")
    assert len(lines) == 12  # summary, table head, one row per frame
    gop = tmp_path / "g.264"
    assert cli.main(["encode", clip_path, str(gop), *ARGS, "--gop-devices", "1"]) == 0
    assert gop.read_bytes() == streams[0]


def test_cli_encode_ranges_and_all_intra(clip, clip_path, tmp_path):
    out = tmp_path / "s.264"
    args = ["--qp", "30", "--deblock", "--tpu-iframe", "mixed", "--tpu-pframe",
            "--start-frame", "3", "--end-frame", "5", "--device", "cpu"]
    assert cli.main(["encode", clip_path, str(out), *args]) == 0
    enc = Encoder(W, H, EncoderConfig(qp=30, deblock=True), iframe="mixed", device="cpu")
    assert out.read_bytes() == enc.encode_sequence(clip[2:5])
    assert cli.main(["encode", clip_path, str(out), "--intra-every", "1",
                     "--gop-devices", "1", "--end-frame", "2", "--device", "cpu"]) == 0
    assert out.read_bytes() == GopIntraEncoder(W, H, 28, device="cpu").encode_sequence(clip[:2])
    # --tile-devices N with P frames writes TileIpppEncoder's bytes (GOPs of
    # --intra-every frames, 100 by default: on 2 frames one GOP either way,
    # the same bytes), and ignores --tpu-me as the JAX CLI does
    want = TileIpppEncoder(W, H, 28, gop_len=8, devices=["cpu"] * 3).encode_sequence(clip[:2])
    for extra in (["--tile-devices", "1"], ["--tile-devices", "3", "--intra-every", "8"],
                  ["--tile-devices", "3", "--intra-every", "8", "--tpu-me"]):
        assert cli.main(["encode", clip_path, str(out), "--device", "cpu", "--end-frame", "2",
                         *extra]) == 0
        assert out.read_bytes() == want, extra
    # --tpu-me: host P frames on the device's top-16 candidates (the JAX
    # Encoder's tpu_me; tests/test_torch_host_encoder.py holds the stream)
    assert cli.main(["encode", clip_path, str(out), "--device", "cpu", "--end-frame", "3",
                     "--tpu-me"]) == 0
    enc = Encoder(W, H, EncoderConfig(), iframe="host", pframe="host", me="topk", device="cpu")
    assert out.read_bytes() == enc.encode_sequence(clip[:3])
    assert out.read_bytes() != Encoder(W, H, EncoderConfig(), iframe="host", pframe="host",
                                       device="cpu").encode_sequence(clip[:3])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["encode", clip_path, str(out)])


def test_chip_smoke_plain_session_chain(clip):
    """The oracle chain chip_smoke.py holds the session's kernel path
    against (the Encoder with every kernel swapped for its plain twin) and
    its stream parser, on the CPU: the chain gives the encoder's own stream,
    and the patches are undone after it."""
    import chip_smoke
    from h264_fer_tpu_torch.codec import encoder, iframe, pframe
    from h264_fer_tpu_torch.kernels.deblock import deblock_frame

    cfg = EncoderConfig(qp=30, intra_every=4, deblock=True)
    enc = Encoder(W, H, cfg, device="cpu")
    stream = enc.encode_sequence(clip[:5])
    plain = chip_smoke.plain_session_stream(torch, torch.device("cpu"), cfg, clip[:3],
                                            (deblock_frame,))
    assert stream.startswith(plain) and len(plain) < len(stream)
    chip_smoke.parse_session_stream(stream, enc.stats, W, H, 30)
    assert (iframe.deblock_frame, encoder.deblock_frame) == (deblock_frame, deblock_frame)
    assert pframe.pframe_decide.__name__ == "pframe_decide"


def test_cli_psnr_prints_jax_values(clip, clip_path, tmp_path, capsys):
    test = tmp_path / "t.y4m"
    rng = np.random.default_rng(4)
    with open(test, "wb") as f:
        f.write(b"YUV4MPEG2 W176 H144 F25:1 Ip A1:1 C420jpeg\n")
        for frame in clip[:3]:
            f.write(b"FRAME\n")
            for p in frame:
                f.write(np.clip(p.astype(np.int32) + rng.integers(-3, 4, p.shape),
                                0, 255).astype(np.uint8).tobytes())
    assert cli.main(["psnr", clip_path, str(test)]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["psnr", clip_path, str(test)]) == 0
    assert got == capsys.readouterr().out
    assert got.startswith("Y: mean ")
