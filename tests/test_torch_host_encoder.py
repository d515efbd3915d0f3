"""The host per-MB encoder (codec/encoder_host.py) against the JAX package's
host Encoder (tpu_* off) and the C++ reference encoder's bytes, on the CPU.

The JAX host path is numpy, so no JAX program compiles here; where the JAX
Encoder takes device modes, a stand-in for its TpuIntraPipeline feeds it
the port's intra_mode_decision; where it takes the device's ME candidates
(--tpu-me), its own TpuMePipeline computes them (a small JAX compile).
Covered: the CAVLC writing half and the
numpy forward transforms on random input; the all-intra stream (the C++
reference's prefix); the IPPP streams at QP 28 and 40, with the filter
(K8's plain twin against codec/loopfilter), without qpel and with the
search options; the device's top-K ME candidates (QP 28, QP 40, periodic
IDRs with the filter); the per-MB state chain frame by frame;
device_modes; the hand-offs between host and device frames; the CLI's default encode
against the JAX CLI's; and chip_smoke.py's committed digests."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from h264_fer_tpu import cli as jax_cli
from h264_fer_tpu.bitstream.bitio import BitWriter as JaxBitWriter
from h264_fer_tpu.codec.encoder import Encoder as JaxEncoder
from h264_fer_tpu.codec.encoder import EncoderConfig as JaxEncoderConfig
from h264_fer_tpu.ops.me import TpuMePipeline
from h264_fer_tpu.ops import cavlc as jax_cavlc
from h264_fer_tpu.ops import transform as jax_transform
from h264_fer_tpu.vio.y4m import Y4MReader
from h264_fer_tpu_torch import cli
from h264_fer_tpu_torch.bitstream.bitio import BitWriter
from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
from h264_fer_tpu_torch.codec.intra_decision import intra_mode_decision
from h264_fer_tpu_torch.ops import cavlc, encode_host

torch.set_num_threads(1)

W, H = 176, 144
HOST = dict(iframe="host", pframe="host", device="cpu")
STATE = ("y", "mb_type", "mb_intra", "mv", "tc_luma", "tc_chroma", "cbp_luma",
         "cbp_chroma", "nz_luma")


class PortModes:
    """Stands in for the JAX TpuIntraPipeline (its __call__ and
    modes_to_host): the port's intra_mode_decision on the CPU, so that the
    JAX host Encoder takes the port's device modes without a JAX compile."""

    def __init__(self, qp: int) -> None:
        self.qp = qp

    def __call__(self, y):
        return intra_mode_decision(torch.from_numpy(y), self.qp)

    def modes_to_host(self, out):
        return tuple(out[k].numpy() for k in ("mode16", "mode4", "satd16", "satd4"))


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:chip_smoke.N_HOST_QCIF]


def _jax_encoder(cfg: dict, device_modes: bool = False, me: str = "full"):
    """The JAX Encoder with host frames; device_modes feeds it the port's
    modes, me="topk" its TpuMePipeline (the JAX CLI's --tpu-me)."""
    window = cfg.get("window_size", 16) // 2
    return JaxEncoder(W, H, JaxEncoderConfig(**cfg),
                      tpu_pipeline=PortModes(cfg["qp"]) if device_modes else None,
                      tpu_me=TpuMePipeline(window=window) if me == "topk" else None)


@pytest.fixture(scope="module")
def jax_runs(clip):
    """name → (stream, last reconstruction) of the JAX host Encoder for
    chip_smoke.host_qcif_streams's cases."""
    cases = {"intra_qp28": ({"qp": 28, "intra_every": 1}, {}), **chip_smoke.HOST_QCIF}
    out = {}
    for name, (cfg, kw) in cases.items():
        enc = _jax_encoder(cfg, **kw)
        out[name] = (enc.encode_sequence(clip[:3] if name == "intra_qp28" else clip),
                     enc.reconstructed())
    return out


@pytest.fixture(scope="module")
def port_runs():
    """chip_smoke.py's host QCIF streams, built on the CPU."""
    return chip_smoke.host_qcif_streams("cpu")


# ---------------------------------------------------------------------------
# CAVLC writing half and forward transforms


@pytest.mark.parametrize("suffix_len", range(7))
def test_level_codes_match_jax(suffix_len):
    for code in range(0, 1 << 13, 3):
        assert cavlc.encode_level_code(code, suffix_len) == \
            jax_cavlc.encode_level_code(code, suffix_len)
    for level in range(-300, 301):
        if level:
            for first in (False, True):
                assert cavlc._level_to_code(level, first) == \
                    jax_cavlc._level_to_code(level, first)


# (nC, maxNumCoeff): every nC range (0-1, 2-3, 4-7, >= 8, chroma DC -1) and
# maxNumCoeff 4 (chroma DC), 15 (AC) and 16 (4x4)
@pytest.mark.parametrize("nc,maxc", [(0, 16), (1, 15), (2, 16), (3, 15), (4, 16), (7, 15),
                                     (8, 16), (13, 15), (-1, 4)])
def test_block_symbols_match_jax(nc, maxc):
    rng = np.random.default_rng(100 + 7 * nc + maxc)
    for trial in range(300):
        density = rng.random()
        scale = (1, 3, 40, 3000)[trial % 4]  # trailing ones, small, escapes
        levels = np.where(rng.random(maxc) < density,
                          rng.integers(-scale, scale + 1, maxc), 0)
        if trial % 5 == 0:  # sparse tails of +-1: long runs, the escape zeros
            levels = np.where(rng.random(maxc) < 0.2, rng.choice([-1, 1], maxc), 0)
        lv = levels.tolist()
        assert cavlc.block_symbols(lv, nc, maxc) == jax_cavlc.block_symbols(lv, nc, maxc)
        assert cavlc.size_residual_block(lv, nc, maxc) == \
            jax_cavlc.size_residual_block(lv, nc, maxc)
        w, jw = BitWriter(), JaxBitWriter()
        assert cavlc.write_residual_block(w, lv, nc, maxc) == \
            jax_cavlc.write_residual_block(jw, lv, nc, maxc)
        assert w.bit_position == jw.bit_position
        w.rbsp_trailing_bits()
        jw.rbsp_trailing_bits()
        assert w.getvalue() == jw.getvalue()


@pytest.mark.parametrize("qp", [0, 11, 23, 24, 28, 35, 36, 45, 51])
def test_forward_transforms_match_jax(qp):
    rng = np.random.default_rng(qp)
    r = rng.integers(-255, 256, (64, 4, 4)).astype(np.int32)
    r[::5] = 0
    d = encode_host.forward_transform_4x4(r)
    np.testing.assert_array_equal(d, jax_transform.forward_transform_4x4(r))
    for bypass in (False, True):
        np.testing.assert_array_equal(encode_host.quantize_residual(d, qp, bypass),
                                      jax_transform.quantize_residual(d, qp, bypass))
        np.testing.assert_array_equal(encode_host.forward_residual(r, qp, bypass),
                                      jax_transform.forward_residual(r, qp, bypass))
    dc4 = d[:16, 0, 0].reshape(4, 4)
    dc2 = d[:4, 0, 0].reshape(2, 2)
    for ours, ref, x in ((encode_host.forward_hadamard_dc_luma,
                          jax_transform.forward_hadamard_dc_luma, dc4),
                         (encode_host.forward_hadamard_dc_chroma,
                          jax_transform.forward_hadamard_dc_chroma, dc2)):
        np.testing.assert_array_equal(ours(x), ref(x))
    for ours, ref, x in ((encode_host.quantize_dc_luma, jax_transform.quantize_dc_luma, dc4),
                         (encode_host.quantize_dc_chroma, jax_transform.quantize_dc_chroma, dc2),
                         (encode_host.forward_dc_luma, jax_transform.forward_dc_luma, dc4),
                         (encode_host.forward_dc_chroma, jax_transform.forward_dc_chroma, dc2)):
        np.testing.assert_array_equal(ours(x, qp), ref(x, qp))
    np.testing.assert_array_equal(encode_host.zigzag_scan(d), jax_transform.zigzag_scan(d))


# ---------------------------------------------------------------------------
# Streams


def test_all_intra_stream_is_cpp_reference_prefix(fixtures_dir, port_runs, jax_runs):
    """All-intra QP 28: the port's host stream is the C++ reference
    encoder's first 3 frames, and its reconstruction the JAX Encoder's."""
    stream, recon = port_runs["intra_qp28"]
    ref = (fixtures_dir / "ref_qcif_intra_qp28.264").read_bytes()
    assert stream == ref[: len(stream)] and len(stream) > 1000
    assert stream == jax_runs["intra_qp28"][0]
    for a, b in zip(recon, jax_runs["intra_qp28"][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(chip_smoke.HOST_QCIF))
def test_host_stream_equals_jax(name, port_runs, jax_runs):
    """IPPP on 5 frames: QP 28 (SAD tier), QP 40 (SSD tier), QP 28 with the
    filter (plain K8 on the host state against codec/loopfilter), with
    device modes, and with the device's ME candidates (QP 28, QP 40, and
    an IDR every 3 frames with the filter): the port's stream and last
    reconstruction are the JAX host Encoder's."""
    stream, recon = port_runs[name]
    assert stream == jax_runs[name][0]
    for a, b in zip(recon, jax_runs[name][1]):
        np.testing.assert_array_equal(a, b)


def test_chip_smoke_digests_are_jax_streams(jax_runs):
    """chip_smoke.py holds the card's host QCIF streams to these digests."""
    for name in chip_smoke.HOST_QCIF:
        assert hashlib.sha256(jax_runs[name][0]).hexdigest() == chip_smoke.HOST_DIGESTS[name]


@pytest.mark.parametrize("cfg", [
    {"qp": 28, "qpel": False},
    {"qp": 28, "window_size": 8, "maxdiff": 6, "lossy_prefilter": False},
], ids=["no-qpel", "window8-maxdiff6-no-prefilter"])
def test_host_options_equal_jax(clip, cfg):
    assert Encoder(W, H, EncoderConfig(**cfg), **HOST).encode_sequence(clip) == \
        _jax_encoder(cfg).encode_sequence(clip)


def test_host_state_chain_matches_jax(clip):
    """The per-MB state after every frame (it feeds later frames and the
    filter) is the JAX Encoder's, at QP 34 with the filter on."""
    cfg = {"qp": 34, "deblock": True}
    ref = _jax_encoder(cfg)
    port = Encoder(W, H, EncoderConfig(**cfg), **HOST)
    for i, f in enumerate(clip[:4]):
        assert port.encode_frame(*f) == ref.encode_frame(*f), f"frame {i}"
        for key in STATE:
            np.testing.assert_array_equal(getattr(port.host, key), getattr(ref, key),
                                          err_msg=f"frame {i} {key}")
    assert port.stats[-1]["mb_types"] == ref.stats[-1]["mb_types"]


def test_handoff_host_i_then_device_p(clip, jax_runs):
    """Host I frames, device P frames: the JAX host stream (the JAX device P
    frame writes the host P frame's bytes, test_tpu_pframe.py)."""
    port = Encoder(W, H, EncoderConfig(qp=28), iframe="host", pframe="device", device="cpu")
    assert port.encode_sequence(clip) == jax_runs["qp28"][0]


def test_handoff_device_mixed_i_then_host_p(clip, jax_runs):
    """Device mixed I frames, host P frames: the JAX host stream fed the same
    modes (the mixed frame's arbitration is the host's exact one)."""
    port = Encoder(W, H, EncoderConfig(qp=28), iframe="mixed", pframe="host", device="cpu")
    assert port.encode_sequence(clip) == jax_runs["qp28_device_modes"][0]


def test_handoff_device_mixed_i_then_host_p_with_candidates(clip):
    """Device mixed I frames, host P frames on the device's ME candidates:
    the JAX host stream fed the same modes and its own candidates."""
    port = Encoder(W, H, EncoderConfig(qp=28), iframe="mixed", pframe="host", me="topk",
                   device="cpu")
    assert port.encode_sequence(clip) == \
        _jax_encoder({"qp": 28}, device_modes=True, me="topk").encode_sequence(clip)


def test_frame_choices_are_validated():
    with pytest.raises(ValueError):
        Encoder(W, H, EncoderConfig(), iframe="i16", device_modes=True, device="cpu")
    with pytest.raises(ValueError):
        Encoder(W, H, EncoderConfig(), pframe="cpu", device="cpu")
    with pytest.raises(ValueError):
        Encoder(W, H, EncoderConfig(), me="tpu", device="cpu")


@pytest.mark.parametrize("extra", [[], ["--deblock"]], ids=["plain", "deblock"])
def test_cli_default_encode_writes_jax_cli_bytes(fixtures_dir, tmp_path, extra):
    """The same command line, less --device, writes the same bytes in both
    packages: the host path."""
    src = str(fixtures_dir / "clip_qcif_10f.y4m")
    ours, ref = tmp_path / "port.264", tmp_path / "jax.264"
    args = ["--end-frame", "4", *extra]
    assert cli.main(["encode", src, str(ours), *args, "--device", "cpu"]) == 0
    assert jax_cli.main(["encode", src, str(ref), *args]) == 0
    assert ours.read_bytes() == ref.read_bytes()
