"""The port's MB-row band encoders against the JAX package's, exactly: the
TileIntraEncoder streams, all-I16 over 3 bands and mixed over 2 uneven
bands, on 3 frames of the QCIF clip at QP 28, byte for byte against the
JAX TileIntraEncoder's (JAX on 3 and 2 of its virtual CPU devices), and
chip_smoke.TILE_DIGESTS, which the card's streams are held to, recomputed
from the JAX streams; the band halo's nC state against the reference's
_band_state_last_row and _chroma_state_last_row.

The JAX compiles of the two encoders take most of this file's time (about
a minute here)."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke

import jax
import jax.numpy as jnp

from h264_fer_tpu.parallel.tile import TileIntraEncoder as JaxTileIntraEncoder
from h264_fer_tpu.parallel.tile import _band_state_last_row, _chroma_state_last_row
from h264_fer_tpu.vio.y4m import Y4MReader
from h264_fer_tpu_torch.codec.entropy import chroma_setup, i16_slice_entropy
from h264_fer_tpu_torch.codec.intra_decision import intra16_mode_decision
from h264_fer_tpu_torch.kernels.wavefront_i16 import i16_band
from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE
from h264_fer_tpu_torch.ops.transform import chroma_qp
from h264_fer_tpu_torch.parallel.tile import _last_row_state

torch.set_num_threads(1)

W, H, QP = 176, 144, chip_smoke.QP
WMB = W // 16


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / chip_smoke.HOST_CLIP.split("/")[-1])))[
        :chip_smoke.N_TILE_QCIF]


@pytest.fixture(scope="module")
def jax_streams(clip):
    return {name: JaxTileIntraEncoder(W, H, QP, devices=jax.devices()[:n],
                                      mode=mode).encode_sequence(clip)
            for name, (mode, n) in chip_smoke.TILE_QCIF.items()}


def test_tile_streams_equal_jax(jax_streams):
    assert chip_smoke.tile_qcif_streams("cpu") == jax_streams


def test_chip_smoke_tile_digests_are_jax_streams(jax_streams):
    """chip_smoke.py holds the card's QCIF band streams to these digests."""
    assert {name: hashlib.sha256(s).hexdigest() for name, s in jax_streams.items()} \
        == chip_smoke.TILE_DIGESTS


def test_halo_state_equals_reference_last_row(clip):
    """The nC state a band hands the band below (the last MB row of its
    slice entropy's outputs) is what the reference rebuilds from the
    band's levels."""
    hloc = 3
    y, cb, cr = (torch.from_numpy(np.array(p[: hloc * s])) for p, s in zip(clip[0], (16, 8, 8)))
    m16 = intra16_mode_decision(y.to(torch.int32), QP)[0].to(torch.int32)
    cmode = torch.from_numpy(INTRA16_TO_CHROMA_MODE)[m16.long()].to(torch.int32)
    _, i16dc, ac, _, _, cdc, cac = i16_band(y, cb, cr, m16, cmode, QP, chroma_qp(QP))
    state = _last_row_state(i16_slice_entropy(m16, cmode, i16dc, ac, cdc, cac, WMB, hloc), WMB)
    want = _band_state_last_row(*(jnp.asarray(t.numpy()) for t in (i16dc, ac, cdc, cac)),
                                WMB, hloc)
    for key, ref in zip(("tc_luma", "cbp_luma", "tc_chroma", "cbp_chroma"), want):
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(ref), err_msg=key)
    ch = chroma_setup(cdc, cac, WMB, hloc)
    tc_c, cbp_c = _chroma_state_last_row(jnp.asarray(cdc.numpy()), jnp.asarray(cac.numpy()),
                                         WMB, hloc)
    np.testing.assert_array_equal(ch["tc_chroma"][:, -WMB:].numpy(), np.asarray(tc_c))
    np.testing.assert_array_equal(ch["cbp_chroma"][-WMB:].numpy(), np.asarray(cbp_c))
