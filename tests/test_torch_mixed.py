"""The port's mixed I4x4/I16 I frame against the JAX package, exactly
(tolerance 0): device_mixed_frame against the JAX device_mixed_frame, the
GopIntraEncoder(mode="mixed") stream byte for byte against the JAX
encoder's on the QCIF clip at QP 12 and 28, and the JAX Decoder
reproducing the port's recon. (K6 and the mixed slice entropy alone:
tests/test_torch_wavefront_mixed.py.)

The JAX compiles dominate this file's time (~40 s per QP): the frame test
uses the capacity tier the JAX GopIntraEncoder dispatches first, so the
stream test reuses its compile. chip_smoke.DEVICE_DIGESTS["mixed"] is the
JAX stream's SHA-256 at QP 28."""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h264_fer_tpu.codec.decoder import Decoder
from h264_fer_tpu.codec.tpu_iframe import device_mixed_frame as jax_frame
from h264_fer_tpu.ops.cavlc_jax import words_to_bytes as jax_words_to_bytes
from h264_fer_tpu.parallel.gop_device import GopIntraEncoder as JaxGopIntraEncoder
from h264_fer_tpu.vio.y4m import Y4MReader
from h264_fer_tpu_torch.codec.iframe import device_mixed_frame
from h264_fer_tpu_torch.ops.cavlc_bulk import words_to_bytes
from h264_fer_tpu_torch.ops.transform import chroma_qp
from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder

torch.set_num_threads(1)

W, H = 176, 144
N_FRAMES = 2
ENTROPY_KEYS = ("mb_type", "cbp_luma", "cbp_chroma", "tc_luma", "tc_chroma",
                "nz_luma")


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return [tuple(np.array(p) for p in f) for f in
            list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:N_FRAMES]]


@pytest.fixture(scope="module")
def streams(clip):
    """{qp: (JAX stream, port stream)} of the clip's first frames."""
    return {qp: (JaxGopIntraEncoder(W, H, qp, mode="mixed",
                                    devices=jax.devices()[:1]).encode_sequence(clip),
                 GopIntraEncoder(W, H, qp, mode="mixed", device="cpu")
                 .encode_sequence(clip))
            for qp in (12, 28)}


def test_device_mixed_frame_matches_jax(clip):
    qp = 12
    nmb = (W // 16) * (H // 16)
    # the capacity tier JAX's GopIntraEncoder dispatches first: one compile
    want = jax_frame(*(jnp.asarray(p) for p in clip[0]), wmb=W // 16, hmb=H // 16,
                     qp=qp, qpc=chroma_qp(qp), nw=nmb * 24, cap=8, deblock=False)
    assert bool(want["pack_ok"])
    got = device_mixed_frame(*(torch.from_numpy(p) for p in clip[0]), qp, chroma_qp(qp))
    for key in ("recon_y", "recon_cb", "recon_cr", "choice4", "i4x4_mode",
                *ENTROPY_KEYS):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    # both MB classes occur (the JAX test finds 6 I4x4 MBs of 99)
    assert 0 < int(got["choice4"].sum()) < nmb
    nbits = int(want["nbits"])
    assert int(got["nbits"]) == nbits
    assert (words_to_bytes(got["words"].numpy(), nbits)
            == jax_words_to_bytes(np.asarray(want["words"]), nbits))


@pytest.mark.parametrize("qp", [12, 28])
def test_gop_stream_byte_identical_to_jax(streams, qp):
    want, got = streams[qp]
    assert got == want


def test_device_digest_is_the_jax_stream(streams):
    """chip_smoke.py holds the card's QCIF mixed stream to this digest."""
    import chip_smoke

    assert chip_smoke.DEVICE_DIGESTS["mixed"] == hashlib.sha256(streams[28][0]).hexdigest()


def test_jax_decoder_reproduces_port_recon(streams, clip):
    decoded = list(Decoder().decode_annexb(streams[12][1]))
    assert len(decoded) == len(clip)
    for i, (frame, dec) in enumerate(zip(clip, decoded)):
        out = device_mixed_frame(*(torch.from_numpy(p) for p in frame), 12,
                                 chroma_qp(12))
        for k, key in enumerate(("recon_y", "recon_cb", "recon_cr")):
            np.testing.assert_array_equal(dec[k], out[key].numpy(),
                                          err_msg=f"frame {i} {key}")


def test_chip_smoke_plain_chain_equals_encoder_stream(clip):
    """The oracle chain that chip_smoke.py holds the mixed path against
    (plain K7 and K6 between the port's other stages) gives the encoder's
    own stream."""
    import chip_smoke

    enc = GopIntraEncoder(W, H, 28, mode="mixed", device="cpu")
    payload = chip_smoke.plain_mixed_payload(torch, torch.device("cpu"), enc, clip[0])
    assert enc.stitch([payload]) == enc.encode_sequence(clip[:1])
