"""The port's whole-GOP IPPP encoder against the JAX package: a stream
byte-identical to the JAX GopIpppEncoder on one device, on the QCIF clip at
QP 28 (SAD tier, MAXDIFF prefilter on) and QP 40 (SSD tier, prefilter
off), which the JAX decoder decodes to the port's final reconstruction of
each GOP (tests/test_torch_ippp_gops.py: the same GOP split under
scene_cut_source, with the idr_pic_id sequence a one-frame GOP gives, the
plain chain and the encoder's limits). The P-frame band encoders
(TileIpppEncoder in 3 bands of 3 MB rows, GopTileIpppEncoder over a
(2, 3) grid) write the same JAX stream, two GOPs, the last one short, and
chip_smoke.TILE_P_DIGESTS are its SHA-256 (and DEVICE_DIGESTS["IPPP"] at
QP 28)."""

import hashlib

import numpy as np
import pytest
import torch

import jax

from h264_fer_tpu.codec.decoder import Decoder
from h264_fer_tpu.parallel.gop_device import GopIpppEncoder as JaxGopIpppEncoder
from h264_fer_tpu.vio.y4m import Y4MReader
from h264_fer_tpu_torch.codec.gop import device_gop_ippp
from h264_fer_tpu_torch.parallel.gop_device import GopIpppEncoder
from h264_fer_tpu_torch.parallel.tile_p import GopTileIpppEncoder, TileIpppEncoder

torch.set_num_threads(1)

W, H, GOP = 176, 144, 4
QPS = [28, 40]


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))


@pytest.fixture(scope="module")
def streams(clip):
    """{qp: (JAX stream, port stream)} of the first 6 frames: two GOPs."""
    return {qp: (JaxGopIpppEncoder(W, H, qp, gop_len=GOP, devices=jax.devices()[:1]
                                   ).encode_sequence(clip[:6]),
                 GopIpppEncoder(W, H, qp, gop_len=GOP, device="cpu"
                                ).encode_sequence(clip[:6]))
            for qp in QPS}


@pytest.mark.parametrize("qp", QPS)
def test_gop_ippp_stream_byte_identical_to_jax(streams, qp):
    ref, got = streams[qp]
    assert got == ref


@pytest.mark.parametrize("qp", QPS)
def test_tile_ippp_stream_byte_identical_to_jax(clip, streams, qp):
    """Every frame in 3 MB-row bands: the reference windows, MV chain, nC
    and skip-run contexts and the trailing-skip drop cross the band edges."""
    enc = TileIpppEncoder(W, H, qp, gop_len=GOP, devices=["cpu"] * 3)
    assert enc.encode_sequence(clip[:6]) == streams[qp][0]


def test_gop_tile_ippp_stream_byte_identical_to_jax(clip, streams):
    enc = GopTileIpppEncoder(W, H, 28, gop_len=GOP, n_gop=2, n_tile=3, devices=["cpu"] * 6)
    assert enc.encode_sequence(clip[:6]) == streams[28][0]


def test_tile_p_digests_are_the_jax_streams(streams):
    """chip_smoke.py holds the card's QCIF band streams to these digests."""
    import chip_smoke

    assert chip_smoke.TILE_P_DIGESTS == {
        f"qp{qp}": hashlib.sha256(streams[qp][0]).hexdigest() for qp in QPS}


def test_device_digest_is_the_jax_stream(streams):
    """chip_smoke.py holds the card's one-device QCIF IPPP stream (QP 28)
    to this digest."""
    import chip_smoke

    assert chip_smoke.DEVICE_DIGESTS["IPPP"] == hashlib.sha256(streams[28][0]).hexdigest()


class _SpecDecoder(Decoder):
    """The JAX decoder in its spec-correct mode. By default it replicates
    the reference decoder's stale-ChromaACLevel quirk (decoder.py:134-140),
    which re-applies an earlier MB's chroma AC at coded MBs whose chroma CBP
    is 0 and so departs from the encoder's own reconstruction in chroma;
    the encoders (JAX and port alike) reconstruct with zero levels there."""

    _spec_mode = property(lambda self: True, lambda self, value: None)


@pytest.mark.parametrize("qp", QPS)
def test_jax_decoder_reproduces_port_final_recon(clip, streams, qp):
    stream = streams[qp][1]
    decoded = list(_SpecDecoder().decode_annexb(stream))
    quirk = list(Decoder().decode_annexb(stream))
    assert len(decoded) == len(quirk) == 6
    enc = GopIpppEncoder(W, H, qp, gop_len=GOP, device="cpu")
    for start, n in ((0, 4), (4, 2)):
        planes = [[torch.from_numpy(np.array(f[k])) for f in clip[start: start + n]]
                  for k in range(3)]
        out = device_gop_ippp(*planes, enc.hdr_bits[: n - 1], enc.window, qp,
                              enc.qpc, enc.maxdiff, enc.prefilter)
        last = start + n - 1
        for k, key in enumerate(("recon_y", "recon_cb", "recon_cr")):
            np.testing.assert_array_equal(decoded[last][k], out[key].numpy(),
                                          err_msg=f"frame {last} {key}")
        # the quirk touches chroma only
        np.testing.assert_array_equal(quirk[last][0], out["recon_y"].numpy())
