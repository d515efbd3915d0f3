"""The port's Intra_4x4 pieces against the JAX package, exactly (tolerance
0): Intra4x4 prediction, the full intra mode decision and the plain K7 (the
chroma wavefront) against wavefront_chroma_impl; the plain K4x4 against the
Pallas kernel is in tests/test_torch_i4x4_k4x4.py.

The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py; here the wrappers must route CPU tensors to the
plain code."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h264_fer_tpu.codec.tpu_intra import intra_mode_decision as jax_decision
from h264_fer_tpu.kernels.wavefront import wavefront_chroma
from h264_fer_tpu.ops import intra as jax_intra
from h264_fer_tpu.ops.transform import chroma_qp
from h264_fer_tpu_torch.codec.intra_decision import intra_mode_decision
from h264_fer_tpu_torch.kernels.wavefront_i4x4 import i4x4_luma, i4x4_luma_plain
from h264_fer_tpu_torch.kernels.wavefront_i16 import (chroma_frame, chroma_frame_plain,
                                                      chroma_recon, chroma_recon_plain)
from h264_fer_tpu_torch.ops import intra

torch.set_num_threads(1)

GRIDS = [(176, 144), (80, 176)]  # wide and tall


def _luma(rng, w, h):
    """Random samples with a flat band, where SATDs tie."""
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    y[:, : w // 4] = 128
    return y


def test_predict_4x4_all_modes_matches_jax():
    rng = np.random.default_rng(2)
    p = rng.integers(0, 256, (4000, 13)).astype(np.int32)
    # unavailable samples in the patterns the encoder makes: no corner, no
    # left column, no top row (and so no above-right), no above-right
    p[rng.random(4000) < 0.3, 0] = -1
    p[rng.random(4000) < 0.2, 1:5] = -1
    p[rng.random(4000) < 0.2, 5:13] = -1
    p[rng.random(4000) < 0.2, 9:13] = -1
    want = jax_intra.predict_4x4_all_modes(p)
    got = intra.predict_4x4_all_modes(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)
    # one mode per block, from the tabulated modes
    m = rng.integers(0, 9, 4000)
    by_mode = intra.predict_4x4_by_mode(torch.from_numpy(p), torch.from_numpy(m))
    np.testing.assert_array_equal(by_mode.numpy(), want[m, np.arange(4000)])


@pytest.mark.parametrize("wh", GRIDS)
@pytest.mark.parametrize("qp", [12, 40])
def test_mode_decision_matches_jax(wh, qp):
    w, h = wh
    y = _luma(np.random.default_rng(qp), w, h)
    want = jax_decision(jnp.asarray(y), wmb=w // 16, hmb=h // 16, qp=qp,
                        modes_only=True)
    got = intra_mode_decision(torch.from_numpy(y), qp)
    for key in ("mode16", "satd16", "mode4", "satd4"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=f"{key} {w}x{h} qp{qp}")


@pytest.mark.parametrize("wh", GRIDS)
@pytest.mark.parametrize("qp", [12, 46])
def test_plain_k7_matches_wavefront_chroma(wh, qp):
    """Random chroma modes, so that every mode meets the frame edges."""
    w, h = wh
    rng = np.random.default_rng(qp + w)
    cb, cr = (rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
              for _ in range(2))
    cm = rng.integers(0, 4, (w // 16) * (h // 16)).astype(np.int32)
    qpc = chroma_qp(qp)
    want = wavefront_chroma(jnp.asarray(cb, jnp.int32), jnp.asarray(cr, jnp.int32),
                            jnp.asarray(cm), wmb=w // 16, hmb=h // 16, qp=qpc)
    got = chroma_frame(torch.from_numpy(cb), torch.from_numpy(cr),
                       torch.from_numpy(cm), qpc)
    for name, g, r in zip(("cb", "cr", "dc", "ac"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=f"{name} {w}x{h} qp{qp}")


def test_wrappers_route_cpu_to_plain_without_launch():
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.integers(0, 256, (32, 48)).astype(np.uint8))
    m4 = torch.from_numpy(rng.integers(0, 9, (6, 16)).astype(np.int32))
    cb, cr = (torch.from_numpy(rng.integers(0, 256, (16, 24)).astype(np.uint8))
              for _ in range(2))
    cm = torch.tensor([0, 1, 2, 3, 0, 3], dtype=torch.int32)
    before = (i4x4_luma.launches, chroma_frame.launches)
    for got, want in ((i4x4_luma(y, m4, 30), i4x4_luma_plain(y, m4, 30)),
                      (chroma_recon(cb, cr, cm, 30), chroma_recon_plain(cb, cr, cm, 30)),
                      (chroma_frame(cb, cr, cm, 30), chroma_frame_plain(cb, cr, cm, 30))):
        for g, r in zip(got, want):
            assert torch.equal(g, r)
    assert got[0].dtype == torch.uint8
    assert (i4x4_luma.launches, chroma_frame.launches) == before
