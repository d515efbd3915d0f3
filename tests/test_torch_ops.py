"""The port's transform, quantisation, DC and prediction ops equal the numpy
path of h264_fer_tpu.ops.transform and .intra, exactly, at every QP and in
every prediction mode."""

import numpy as np
import pytest
import torch

from h264_fer_tpu.ops import intra as jintra
from h264_fer_tpu.ops import transform as jtf
from h264_fer_tpu_torch.ops import intra, transform

torch.set_num_threads(1)


def _eq(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


def _blocks(rng, lo, hi, shape=(40, 4, 4)):
    return rng.integers(lo, hi, shape).astype(np.int32)


def test_forward_inverse_transforms():
    rng = np.random.default_rng(0)
    r = _blocks(rng, -255, 256)
    r[0] = 0
    _eq(transform.forward_transform_4x4(torch.from_numpy(r)),
        jtf.forward_transform_4x4(r), "forward_transform_4x4")
    c = _blocks(rng, -3000, 3000)
    _eq(transform.inverse_transform_4x4(torch.from_numpy(c)),
        jtf.inverse_transform_4x4(c), "inverse_transform_4x4")
    dc = _blocks(rng, -20000, 20000)
    for name in ("forward_hadamard_dc_luma", "inverse_hadamard_dc_luma"):
        _eq(getattr(transform, name)(torch.from_numpy(dc)),
            getattr(jtf, name)(dc), name)
    dc2 = _blocks(rng, -20000, 20000, (40, 2, 2))
    for name in ("forward_hadamard_dc_chroma", "inverse_hadamard_dc_chroma"):
        _eq(getattr(transform, name)(torch.from_numpy(dc2)),
            getattr(jtf, name)(dc2), name)


@pytest.mark.parametrize("qp", range(52))
def test_quant_and_scale_every_qp(qp):
    rng = np.random.default_rng(qp)
    d = jtf.forward_transform_4x4(_blocks(rng, -255, 256))
    td = torch.from_numpy(d)
    for bypass in (False, True):
        q = jtf.quantize_residual(d, qp, bypass)
        _eq(transform.quantize_residual(td, qp, bypass), q,
            f"quantize_residual bypass={bypass}")
        _eq(transform.scale_residual(torch.from_numpy(q), qp, bypass),
            jtf.scale_residual(q, qp, bypass), f"scale_residual bypass={bypass}")
        _eq(transform.inverse_residual(torch.from_numpy(q), qp, bypass),
            jtf.inverse_residual(q, qp, bypass), "inverse_residual")
    dc = _blocks(rng, -4000, 4000)
    _eq(transform.forward_dc_luma(torch.from_numpy(dc), qp),
        jtf.forward_dc_luma(dc, qp), "forward_dc_luma")
    qdc = _blocks(rng, -500, 500)
    _eq(transform.inverse_dc_luma(torch.from_numpy(qdc), qp),
        jtf.inverse_dc_luma(qdc, qp), "inverse_dc_luma")
    dc2 = _blocks(rng, -4000, 4000, (40, 2, 2))
    _eq(transform.forward_dc_chroma(torch.from_numpy(dc2), qp),
        jtf.forward_dc_chroma(dc2, qp), "forward_dc_chroma")
    qdc2 = _blocks(rng, -500, 500, (40, 2, 2))
    _eq(transform.inverse_dc_chroma(torch.from_numpy(qdc2), qp),
        jtf.inverse_dc_chroma(qdc2, qp), "inverse_dc_chroma")
    assert transform.chroma_qp(qp) == jtf.chroma_qp(qp)
    assert transform.chroma_qp(qp, 3) == jtf.chroma_qp(qp, 3)


def test_zigzag_scan():
    c = _blocks(np.random.default_rng(1), -50, 50)
    _eq(transform.zigzag_scan(torch.from_numpy(c)), jtf.zigzag_scan(c),
        "zigzag_scan")
    lst = c.reshape(-1, 16)
    _eq(transform.zigzag_unscan(torch.from_numpy(lst)), jtf.zigzag_unscan(lst),
        "zigzag_unscan")


def test_mb_tiling_round_trips():
    """to_mbs / from_mbs and the chroma 4x4 block split are inverses, and
    the chroma blocks are raster blocks of each 8x8 MB."""
    from h264_fer_tpu_torch.ops import tiles

    plane = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (48, 80)))
    assert torch.equal(tiles.from_mbs(tiles.to_mbs(plane, 16), 3, 5), plane)
    mbs = tiles.to_mbs(plane[:24, :40], 8)
    blocks = tiles.chroma_blocks(mbs)
    assert torch.equal(blocks[:, 1], mbs[:, :4, 4:])
    assert torch.equal(blocks[:, 2], mbs[:, 4:, :4])
    assert torch.equal(tiles.chroma_mb(blocks), mbs)


def _neighbours(rng, n, size):
    """Random corner/left/top samples with every availability pattern:
    MB k has its left side unavailable when k & 1, its top when k & 2."""
    p = rng.integers(0, 256, (n, 2 * size + 1)).astype(np.int32)
    k = np.arange(n)
    left_off, top_off = (k & 1) == 1, (k & 2) == 2
    p[left_off, 1 : size + 1] = -1
    p[top_off, size + 1 :] = -1
    p[left_off | top_off, 0] = -1
    return p


@pytest.mark.parametrize("mode", range(4))
def test_predict_16x16(mode):
    p = _neighbours(np.random.default_rng(mode), 64, 16)
    _eq(intra.predict_16x16(torch.from_numpy(p), mode),
        jintra.predict_16x16(p, mode), f"predict_16x16 mode {mode}")


@pytest.mark.parametrize("mode", range(4))
def test_predict_chroma(mode):
    p = _neighbours(np.random.default_rng(10 + mode), 64, 8)
    _eq(intra.predict_chroma(torch.from_numpy(p), mode),
        jintra.predict_chroma(p, mode), f"predict_chroma mode {mode}")


def test_all_modes_and_chroma_pairing():
    p = _neighbours(np.random.default_rng(3), 16, 16)
    _eq(intra.predict_16x16_all_modes(torch.from_numpy(p)),
        jintra.predict_16x16_all_modes(p), "predict_16x16_all_modes")
    pc = _neighbours(np.random.default_rng(4), 16, 8)
    _eq(intra.predict_chroma_all_modes(torch.from_numpy(pc)),
        jintra.predict_chroma_all_modes(pc), "predict_chroma_all_modes")
    np.testing.assert_array_equal(intra.INTRA16_TO_CHROMA_MODE,
                                  jintra.INTRA16_TO_CHROMA_MODE)
