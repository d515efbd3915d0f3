"""The plain PyTorch K1 wavefront plus levels equals the JAX package's I16
wavefront pallas_i16_frame_fast, run in interpret mode on the CPU (as
tests/test_pallas_wavefront.py runs it), exactly; K1t's plain twin against
pallas_i16_frame is in tests/test_torch_wavefront_k1t.py.

The CUDA kernels themselves are held against the plain versions on the card
by chip_smoke.py; here the wrappers must route CPU tensors to the plain
code."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h264_fer_tpu.kernels.wavefront import wavefront_i16_frame
from h264_fer_tpu.kernels.wavefront_pallas import pallas_i16_frame_fast
from h264_fer_tpu.ops.intra import INTRA16_TO_CHROMA_MODE
from h264_fer_tpu.ops.transform import chroma_qp
from h264_fer_tpu_torch.codec.intra_decision import intra16_mode_decision_plain
from h264_fer_tpu_torch.kernels.wavefront_i16 import (i16_frame, i16_frame_plain, i16_recon,
                                                      i16_recon_plain)

torch.set_num_threads(1)

NAMES = ("recon_y", "i16dc", "ac", "recon_cb", "recon_cr", "cdc", "cac")


def _planes(rng, w, h):
    return (rng.integers(0, 256, (h, w)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))


def _port(planes, m16, cm, qp):
    t = [torch.from_numpy(p) for p in planes]
    return i16_frame(*t, torch.from_numpy(m16), torch.from_numpy(cm),
                     qp, chroma_qp(qp))


def _decided_modes(y, qp):
    """(mode16, chroma mode) int32 of the I16 mode decision of luma y: the
    port's plain decision, which tests/test_torch_mode_decision.py (the I16
    form) and tests/test_torch_i4x4.py (the full form) hold equal to the
    JAX intra_mode_decision, so no JAX decision is compiled here for each
    QP and grid."""
    m16 = intra16_mode_decision_plain(torch.from_numpy(y), qp)[0].numpy()
    return m16, np.asarray(INTRA16_TO_CHROMA_MODE, np.int32)[m16]


def _compare(ref, got, what):
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=f"{name} {what}")


@pytest.mark.parametrize("wh", [(176, 144), (80, 176)])  # wide and tall grids
@pytest.mark.parametrize("qp", [10, 40])
def test_plain_k1_and_levels_match_pallas_fast(wh, qp):
    w, h = wh
    planes = _planes(np.random.default_rng(13), w, h)
    y32 = jnp.asarray(planes[0], jnp.int32)
    m16, cm = _decided_modes(planes[0], qp)
    ref = pallas_i16_frame_fast(
        y32, *(jnp.asarray(p, jnp.int32) for p in planes[1:]), jnp.asarray(m16),
        jnp.asarray(cm), wmb=w // 16, hmb=h // 16, qp=qp, qpc=chroma_qp(qp))
    got = _port(planes, m16, cm, qp)
    _compare(ref, got, f"{w}x{h} qp{qp}")


@pytest.mark.parametrize("qp", [0, 27, 51])
def test_plain_k1_any_modes(qp):
    """Modes not chosen by the decision (V/H/Plane on frame edges, where
    the -1 neighbours enter the prediction) still match the reference
    wavefront, kernels/wavefront.wavefront_i16_frame."""
    w, h = 64, 48
    rng = np.random.default_rng(100 + qp)
    planes = _planes(rng, w, h)
    m16 = rng.integers(0, 4, (w // 16) * (h // 16)).astype(np.int32)
    cm = rng.integers(0, 4, m16.shape).astype(np.int32)
    ref = wavefront_i16_frame(
        *(jnp.asarray(p, jnp.int32) for p in planes), jnp.asarray(m16),
        jnp.asarray(cm), wmb=w // 16, hmb=h // 16, qp=qp, qpc=chroma_qp(qp))
    _compare(ref, _port(planes, m16, cm, qp), f"random modes qp{qp}")


def test_wrapper_routes_cpu_to_plain_without_launch():
    planes = [torch.from_numpy(p) for p in _planes(np.random.default_rng(5), 48, 32)]
    m16 = torch.tensor([2, 1, 1, 0, 3, 0], dtype=torch.int32)
    cm = torch.tensor([0, 1, 1, 2, 3, 2], dtype=torch.int32)
    before = i16_recon.launches, i16_frame.launches
    got = i16_recon(*planes, m16, cm, 30, chroma_qp(30))
    want = i16_recon_plain(*planes, m16, cm, 30, chroma_qp(30))
    for g, r in zip(got, want):
        assert g.dtype == torch.uint8 and torch.equal(g, r)
    got = i16_frame(*planes, m16, cm, 30, chroma_qp(30))
    want = i16_frame_plain(*planes, m16, cm, 30, chroma_qp(30))
    assert (i16_recon.launches, i16_frame.launches) == before
    for g, r in zip(got, want):
        assert torch.equal(g, r)
