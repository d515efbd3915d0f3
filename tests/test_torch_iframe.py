"""The port's all-I16 frame and sequence encode against the JAX package:
the same recon, payload and per-MB state for a frame, a byte-identical
Annex-B stream for the QCIF clip, and a stream the JAX decoder decodes to
the port's reconstruction. chip_smoke.DEVICE_DIGESTS["all-intra"] is the
JAX stream's SHA-256 at QP 28."""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h264_fer_tpu.bitstream import nal as jax_nal
from h264_fer_tpu.codec.decoder import Decoder
from h264_fer_tpu.codec.tpu_iframe import device_i16_frame as jax_frame
from h264_fer_tpu.ops.cavlc_jax import words_to_bytes as jax_words_to_bytes
from h264_fer_tpu.parallel.gop_device import GopIntraEncoder as JaxGopIntraEncoder
from h264_fer_tpu.vio.y4m import Y4MReader
from h264_fer_tpu_torch.bitstream import nal
from h264_fer_tpu_torch.bitstream.bitio import BitReader
from h264_fer_tpu_torch.bitstream.params import SliceHeader
from h264_fer_tpu_torch.codec.iframe import device_i16_frame
from h264_fer_tpu_torch.ops.cavlc_bulk import words_to_bytes
from h264_fer_tpu_torch.ops.transform import chroma_qp
from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder

torch.set_num_threads(1)

W, H = 176, 144


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))


@pytest.fixture(scope="module")
def port_streams(clip):
    """{qp: the port GopIntraEncoder's stream of the clip}, encoded once for
    the stream and decoder tests."""
    return {qp: GopIntraEncoder(W, H, qp, device="cpu").encode_sequence(clip)
            for qp in (8, 28, 46)}


@pytest.fixture(scope="module")
def jax_streams(clip):
    """jax_streams(qp): the JAX GopIntraEncoder's stream of the clip,
    encoded once per QP for the stream and digest tests."""
    cache = {}

    def get(qp):
        if qp not in cache:
            cache[qp] = JaxGopIntraEncoder(W, H, qp, devices=jax.devices()[:1]
                                           ).encode_sequence(clip)
        return cache[qp]
    return get


def _port_frame(frame, qp):
    return device_i16_frame(*(torch.from_numpy(np.array(p)) for p in frame),
                            qp, chroma_qp(qp))


def test_device_i16_frame_matches_jax(clip):
    qp = 28
    nmb = (W // 16) * (H // 16)
    # the capacity tier and the static kwargs, deblock included, that
    # GopIntraEncoder dispatches first: a jit caches on the kwargs as
    # passed, so the QP 28 stream test reuses this compile
    ref = jax_frame(*(jnp.asarray(p) for p in clip[0]), wmb=W // 16,
                    hmb=H // 16, qp=qp, qpc=chroma_qp(qp), nw=nmb * 24, cap=8,
                    deblock=False)
    assert bool(ref["pack_ok"])
    got = _port_frame(clip[0], qp)
    for key in ("recon_y", "recon_cb", "recon_cr", "mb_type", "cbp_luma",
                "cbp_chroma", "tc_luma", "tc_chroma", "nz_luma"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    nbits = int(ref["nbits"])
    assert int(got["nbits"]) == nbits
    assert (words_to_bytes(got["words"].numpy(), nbits)
            == jax_words_to_bytes(np.asarray(ref["words"]), nbits))


@pytest.mark.parametrize("qp", [8, 28, 46])
def test_gop_stream_byte_identical_to_jax(port_streams, jax_streams, qp):
    assert port_streams[qp] == jax_streams(qp)


def test_device_digest_is_the_jax_stream(jax_streams):
    """chip_smoke.py holds the card's QCIF all-intra stream to this digest."""
    import chip_smoke

    assert chip_smoke.DEVICE_DIGESTS["all-intra"] == hashlib.sha256(jax_streams(28)).hexdigest()


@pytest.mark.parametrize("qp", [8, 28, 46])
def test_jax_decoder_reproduces_port_recon(clip, port_streams, qp):
    stream = port_streams[qp]
    decoded = list(Decoder().decode_annexb(stream))
    assert len(decoded) == len(clip)
    for i, (frame, dec) in enumerate(zip(clip, decoded)):
        out = _port_frame(frame, qp)
        for k, key in enumerate(("recon_y", "recon_cb", "recon_cr")):
            np.testing.assert_array_equal(dec[k], out[key].numpy(),
                                          err_msg=f"frame {i} {key}")


def test_gop_encoder_idr_base_and_limits(clip):
    enc = GopIntraEncoder(W, H, 28, device="cpu")
    ref = JaxGopIntraEncoder(W, H, 28, devices=jax.devices()[:1])
    assert enc.headers() == ref.headers()
    assert (enc.encode_sequence(clip[:2], idr_base=5)
            == ref.encode_sequence(clip[:2], idr_base=5))
    # deblock=True signals the filter in the PPS and every slice header (its
    # stream against JAX's: tests/test_torch_encoder.py)
    enc = GopIntraEncoder(W, H, 28, device="cpu", deblock=True)
    assert enc.headers() == JaxGopIntraEncoder(W, H, 28, devices=jax.devices()[:1],
                                               deblock=True).headers()
    units = list(nal.iter_nal_units(enc.encode_sequence(clip[:2])))[2:]
    assert [SliceHeader.parse(BitReader(u.rbsp), enc.sps, enc.pps, u.nal_unit_type,
                              u.nal_ref_idc).disable_deblocking_filter_idc
            for u in units] == [0, 0]
    # a device list may repeat an entry, but not mix CPU and CUDA, and not be
    # empty (its streams: tests/test_torch_tile.py)
    for devices in (["cpu", "cuda"], []):
        with pytest.raises(ValueError):
            GopIntraEncoder(W, H, 28, device="cpu", devices=devices)
    with pytest.raises(ValueError):
        GopIntraEncoder(W, H, 28, mode="i4x4", device="cpu")


def test_emulation_prevention_matches_jax():
    rng = np.random.default_rng(9)
    for n in (0, 1, 2, 3, 7, 500):
        for density in (0.3, 0.7, 0.95):
            raw = np.where(rng.random(n) < density, 0,
                           rng.integers(0, 5, n)).astype(np.uint8).tobytes()
            ebsp = nal.insert_emulation_prevention(raw)
            assert ebsp == jax_nal.insert_emulation_prevention(raw)
            assert nal.remove_emulation_prevention(ebsp) == \
                jax_nal.remove_emulation_prevention(ebsp)
    stream = GopIntraEncoder(64, 32, 40, device="cpu").encode_sequence(
        [(np.zeros((32, 64), np.uint8), np.zeros((16, 32), np.uint8),
          np.zeros((16, 32), np.uint8))] * 2)
    assert list(map(repr, nal.iter_nal_units(stream))) == \
        list(map(repr, jax_nal.iter_nal_units(stream)))


def test_stitched_plain_chain_equals_encoder_stream(clip):
    """The oracle chain that chip_smoke.py holds the kernel path against
    (mode decision, plain K1, levels, entropy per frame, stitched by the
    encoder) gives the encoder's own stream."""
    import chip_smoke

    enc = GopIntraEncoder(W, H, 28, device="cpu")
    assert (chip_smoke.plain_chain_stream(torch, torch.device("cpu"), enc, clip[:2])
            == enc.encode_sequence(clip[:2]))
