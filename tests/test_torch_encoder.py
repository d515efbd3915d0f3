"""The port's session Encoder with the in-loop filter against the JAX
package's Encoder in its fully-device configuration (tpu_pipeline,
tpu_iframe=True, tpu_pframe=True), on the QCIF clip at QP 30 with
intra_every=4 and deblock on: the same stream byte for byte, the same
per-frame stats, scene cuts (by the SAD against the reconstruction or the
previous source frame) with the JAX idr_pic_id sequence, and a
reconstruction the JAX decoder (filter on) reproduces frame by frame. GopIntraEncoder(deblock=True) shares the JAX
I-frame compile of this geometry and QP. chip_smoke.DEVICE_DIGESTS["session"]
is the JAX session stream's SHA-256."""

import hashlib

import numpy as np
import pytest
import torch

import jax

from h264_fer_tpu.codec.decoder import Decoder
from h264_fer_tpu.codec.encoder import Encoder as JaxEncoder
from h264_fer_tpu.codec.encoder import EncoderConfig as JaxEncoderConfig
from h264_fer_tpu.codec.tpu_intra import TpuIntraPipeline
from h264_fer_tpu.parallel.gop_device import GopIntraEncoder as JaxGopIntraEncoder
from h264_fer_tpu.vio.y4m import Y4MReader
from h264_fer_tpu_torch.bitstream import nal
from h264_fer_tpu_torch.bitstream.bitio import BitReader
from h264_fer_tpu_torch.bitstream.params import SliceHeader
from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder

torch.set_num_threads(1)

W, H = 176, 144
CFG = dict(qp=30, intra_every=4, deblock=True)
STATS = ("bytes", "idr", "mb_types")


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))


def _jax_encoder(**cfg):
    return JaxEncoder(W, H, JaxEncoderConfig(**cfg), tpu_pipeline=TpuIntraPipeline(W, H, cfg["qp"]),
                      tpu_iframe=True, tpu_pframe=True)


def _encode(enc, frames):
    """(stream, reconstruction after each frame) of a session encoder."""
    out, recons = bytearray(enc.headers()), []
    for f in frames:
        out += enc.encode_frame(*f)
        recons.append(enc.reconstructed())
    return bytes(out), recons


@pytest.fixture(scope="module")
def sessions(clip):
    """(JAX encoder, its stream, port encoder, its stream and recons)."""
    ref = _jax_encoder(**CFG)
    ref_stream = ref.encode_sequence(clip)
    port = Encoder(W, H, EncoderConfig(**CFG), device="cpu")
    return ref, ref_stream, port, *_encode(port, clip)


def _idr_pic_ids(stream, enc):
    return [SliceHeader.parse(BitReader(u.rbsp), enc.sps, enc.pps, u.nal_unit_type,
                              u.nal_ref_idc).idr_pic_id
            for u in nal.iter_nal_units(stream) if u.nal_unit_type == nal.NAL_IDR]


def test_deblocked_session_stream_byte_identical_to_jax(sessions):
    _, ref_stream, _, stream, _ = sessions
    assert stream == ref_stream


def test_device_digest_is_the_jax_stream(sessions):
    """chip_smoke.py holds the card's QCIF session stream to this digest."""
    import chip_smoke

    assert chip_smoke.DEVICE_DIGESTS["session"] == hashlib.sha256(sessions[1]).hexdigest()


def test_stats_match_jax(sessions):
    ref, _, port, _, _ = sessions
    assert [[s[k] for k in STATS] for s in port.stats] == \
        [[s[k] for k in STATS] for s in ref.stats]
    # intra MBs in a P frame are MBs of a trailing skip run that decoders
    # never read, restored from the IDR before the frame was filtered
    assert any(s["mb_types"][6] for s in port.stats if not s["idr"])


def test_jax_decoder_reproduces_port_recon(sessions):
    _, _, port, stream, recons = sessions
    decoded = list(Decoder(deblock=True).decode_annexb(stream))
    assert len(decoded) == len(recons)
    for i, (dec, rec) in enumerate(zip(decoded, recons)):
        for k in range(3):
            np.testing.assert_array_equal(dec[k], rec[k], err_msg=f"frame {i} plane {k}")


@pytest.mark.parametrize("source", [False, True])
def test_scene_cut_matches_jax(clip, source):
    """Inverted frames cut the scene, by the SAD against the reconstruction
    or, with scene_cut_source, against the previous source frame: frame 1
    right after the first IDR (idr_pic_id 1), frame 3 back after a P frame
    (0), then the period at frame 4 right after that IDR (1)."""
    frames = [clip[0], *(tuple(255 - p for p in f) for f in clip[1:3]), clip[3], clip[4]]
    ref = _jax_encoder(**CFG, scene_cut_source=source)
    port = Encoder(W, H, EncoderConfig(**CFG, scene_cut_source=source), device="cpu")
    stream = port.encode_sequence(frames)
    assert stream == ref.encode_sequence(frames)
    assert [s["idr"] for s in port.stats] == [True, True, False, True, True]
    assert _idr_pic_ids(stream, port) == [0, 1, 0, 1]


def test_gop_intra_encoder_deblock_matches_jax(clip):
    ref = JaxGopIntraEncoder(W, H, CFG["qp"], devices=jax.devices()[:1], deblock=True)
    port = GopIntraEncoder(W, H, CFG["qp"], device="cpu", deblock=True)
    assert port.headers() == ref.headers()
    assert port.encode_sequence(clip[:3], idr_base=2) == \
        ref.encode_sequence(clip[:3], idr_base=2)


def test_encoder_limits():
    with pytest.raises(ValueError):
        Encoder(W, H, EncoderConfig(qp=52), device="cpu")
    with pytest.raises(ValueError):
        Encoder(W, H + 8, EncoderConfig(), device="cpu")
    with pytest.raises(ValueError):
        Encoder(W, H, EncoderConfig(), iframe="i4x4", device="cpu")
    for deblock in (False, True):
        port = Encoder(W, H, EncoderConfig(deblock=deblock), device="cpu")
        ref = _jax_encoder(qp=28, deblock=deblock)
        assert port.headers() == ref.headers()
