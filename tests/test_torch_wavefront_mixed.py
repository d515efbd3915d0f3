"""The port's K6 (the mixed I frame's arbitration wavefront) and mixed
slice entropy against the JAX package, exactly (tolerance 0): the plain K6
on every output against wavefront_mixed_luma, on QCIF and on a tall grid,
and the port's mixed_slice_entropy against the JAX function on the same
K6 outputs. The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py; here the wrapper must route CPU tensors to the
plain code.

The JAX compiles dominate this file's time (~40 s per geometry), so each
case is computed once."""

import numpy as np
import pytest
import torch

import chip_smoke

import jax.numpy as jnp

from h264_fer_tpu.codec.tpu_entropy import chroma_setup as jax_chroma_setup
from h264_fer_tpu.codec.tpu_entropy import mixed_slice_entropy as jax_entropy
from h264_fer_tpu.codec.tpu_intra import intra_mode_decision as jax_decision
from h264_fer_tpu.kernels.wavefront import wavefront_chroma
from h264_fer_tpu.kernels.wavefront_mixed import wavefront_mixed_luma
from h264_fer_tpu.ops.cavlc_jax import words_to_bytes as jax_words_to_bytes
from h264_fer_tpu.ops.intra import INTRA16_TO_CHROMA_MODE
from h264_fer_tpu.vio.y4m import Y4MReader
from h264_fer_tpu_torch.codec.entropy import chroma_setup, mixed_slice_entropy
from h264_fer_tpu_torch.kernels.wavefront_mixed import KEYS, mixed_luma, mixed_luma_plain
from h264_fer_tpu_torch.ops.cavlc_bulk import words_to_bytes
from h264_fer_tpu_torch.ops.transform import chroma_qp

torch.set_num_threads(1)

W, H = 176, 144
K6_ARGS = ("mode16", "mode4", "cmode", "cbp_c", "chroma_bits")
ENTROPY_KEYS = ("mb_type", "cbp_luma", "cbp_chroma", "tc_luma", "tc_chroma",
                "nz_luma")


def _k6_case(frame, qp):
    """JAX decision, chroma and chroma setup, then wavefront_mixed_luma and
    the port's K6 wrapper (on the CPU: the plain K6) on the same inputs.
    Returns (JAX inputs, port inputs, JAX outputs, port outputs)."""
    y, cb, cr = frame
    h, w = y.shape
    wmb, hmb = w // 16, h // 16
    dec = jax_decision(jnp.asarray(y, jnp.int32), wmb=wmb, hmb=hmb, qp=qp,
                       modes_only=True)
    cm = jnp.asarray(INTRA16_TO_CHROMA_MODE)[dec["mode16"]]
    _, _, cdc, cac = wavefront_chroma(jnp.asarray(cb, jnp.int32),
                                      jnp.asarray(cr, jnp.int32), cm, wmb=wmb,
                                      hmb=hmb, qp=chroma_qp(qp))
    ch = jax_chroma_setup(cdc, cac, wmb, hmb)
    ins = {"mode16": dec["mode16"], "mode4": dec["mode4"], "cmode": cm,
           "cbp_c": ch["cbp_chroma"], "chroma_bits": ch["bits"],
           "cdc": cdc, "cac": cac}
    want = wavefront_mixed_luma(jnp.asarray(y, jnp.int32),
                                *(ins[k] for k in K6_ARGS), wmb=wmb, hmb=hmb, qp=qp)
    port = {"y": torch.from_numpy(y),
            **{k: torch.from_numpy(np.array(v, np.int32)) for k, v in ins.items()}}
    got = mixed_luma(port["y"], *(port[k] for k in K6_ARGS), qp)
    return ins, port, want, got


@pytest.fixture(scope="module")
def qcif_k6(fixtures_dir):
    frame = next(iter(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m"))))
    return _k6_case(tuple(np.array(p) for p in frame), 12)


@pytest.mark.parametrize("case", ["qcif_qp12", "tall_64x208_qp30"])
def test_plain_k6_matches_jax(case, qcif_k6):
    _, _, want, got = qcif_k6 if case == "qcif_qp12" else _k6_case(chip_smoke.tall_frame(), 30)
    assert set(got) == set(KEYS)
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=f"{key} {case}")
    n4 = int(got["choice4"].sum())
    assert 0 < n4 < got["choice4"].numel()  # the arbitration runs both ways


def test_mixed_slice_entropy_matches_jax(qcif_k6):
    ins, port, want_k6, got_k6 = qcif_k6
    want = jax_entropy(want_k6["choice4"], ins["mode16"], ins["cmode"],
                       *(want_k6[k] for k in KEYS[2:]), ins["cdc"], ins["cac"],
                       wmb=W // 16, hmb=H // 16)
    ch = chroma_setup(port["cdc"], port["cac"], W // 16, H // 16)
    got = mixed_slice_entropy(got_k6["choice4"], port["mode16"], port["cmode"],
                              *(got_k6[k] for k in KEYS[2:]), port["cdc"],
                              port["cac"], wmb=W // 16, hmb=H // 16, chroma=ch)
    for key in ENTROPY_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    nbits = int(want["nbits"])
    assert int(got["nbits"]) == nbits
    assert (words_to_bytes(got["words"].numpy(), nbits)
            == jax_words_to_bytes(np.asarray(want["words"]), nbits))
    # the chroma bits K6 was given are the port's chroma setup's too
    assert torch.equal(ch["bits"], port["chroma_bits"])
    assert torch.equal(ch["cbp_chroma"], port["cbp_c"])


def test_wrapper_routes_cpu_to_plain_without_launch(qcif_k6):
    _, port, _, got = qcif_k6
    before = mixed_luma.launches
    plain = mixed_luma_plain(port["y"], *(port[k] for k in K6_ARGS), 12)
    assert mixed_luma.launches == before
    for key in KEYS:
        assert torch.equal(plain[key], got[key]), key
