"""The port's session Encoder with mixed I frames (the exact I4x4-vs-I16
choice per MB) and the in-loop filter against the JAX Encoder with
tpu_iframe="mixed" and tpu_pframe=True: 3 QCIF frames (an IDR and two P
frames) at QP 30, byte-identical, with the same stats, and a
reconstruction the JAX decoder (filter on) reproduces."""

import numpy as np
import torch

from h264_fer_tpu.codec.decoder import Decoder
from h264_fer_tpu.codec.encoder import Encoder as JaxEncoder
from h264_fer_tpu.codec.encoder import EncoderConfig as JaxEncoderConfig
from h264_fer_tpu.codec.tpu_intra import TpuIntraPipeline
from h264_fer_tpu.vio.y4m import Y4MReader
from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig

torch.set_num_threads(1)

W, H = 176, 144


def test_mixed_deblocked_session_matches_jax(fixtures_dir):
    clip = list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:3]
    cfg = dict(qp=30, deblock=True)
    ref = JaxEncoder(W, H, JaxEncoderConfig(**cfg), tpu_pipeline=TpuIntraPipeline(W, H, 30),
                     tpu_iframe="mixed", tpu_pframe=True)
    port = Encoder(W, H, EncoderConfig(**cfg), iframe="mixed", device="cpu")
    stream, recons = bytearray(port.headers()), []
    for f in clip:
        stream += port.encode_frame(*f)
        recons.append(port.reconstructed())
    assert bytes(stream) == ref.encode_sequence(clip)
    assert [[s[k] for k in ("bytes", "idr", "mb_types")] for s in port.stats] == \
        [[s[k] for k in ("bytes", "idr", "mb_types")] for s in ref.stats]
    decoded = list(Decoder(deblock=True).decode_annexb(bytes(stream)))
    for i, (dec, rec) in enumerate(zip(decoded, recons)):
        for k in range(3):
            np.testing.assert_array_equal(dec[k], rec[k], err_msg=f"frame {i} plane {k}")
    assert len(decoded) == 3
