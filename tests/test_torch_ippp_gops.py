"""GopIpppEncoder's GOP split and stream set-up against the JAX package:
under scene_cut_source the same GOP lengths and the idr_pic_id sequence a
one-frame GOP gives; the oracle chain chip_smoke.py holds the card to
writes the encoder's own stream; the encoder's limits, SPS, PPS and P
slice headers. Split from tests/test_torch_ippp.py, whose module fixture
builds the two JAX whole-GOP streams, so that each file holds at most ten
tests."""

import pytest
import torch

import jax

from h264_fer_tpu.parallel.gop_device import GopIpppEncoder as JaxGopIpppEncoder
from h264_fer_tpu.vio.y4m import Y4MReader
from h264_fer_tpu_torch.bitstream import nal
from h264_fer_tpu_torch.bitstream.bitio import BitReader
from h264_fer_tpu_torch.bitstream.params import SliceHeader
from h264_fer_tpu_torch.parallel.gop_device import GopIpppEncoder

torch.set_num_threads(1)

W, H, GOP = 176, 144, 4


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))


def test_scene_cut_gops_match_jax(clip):
    """A scene cut at frame 3 and the period at frame 4 give GOPs of 3, 1
    and 4 frames: a one-frame GOP, after which the IDR's idr_pic_id is 1
    (encoder._encode_slice), as the port's stream shows."""
    frames = list(clip[:3]) + [tuple(255 - p for p in f) for f in clip[3:8]]
    port = GopIpppEncoder(W, H, 28, gop_len=GOP, device="cpu", scene_cut_source=True)
    ref = JaxGopIpppEncoder(W, H, 28, gop_len=GOP, devices=jax.devices()[:1],
                            scene_cut_source=True)
    assert port._gop_lengths(frames) == ref._gop_lengths(frames) == [3, 1, 4]
    assert port._gop_lengths(clip) == ref._gop_lengths(clip)
    units = list(nal.iter_nal_units(port.encode_sequence(frames)))[2:]
    sps, pps = port.sps, port.pps
    idr_ids = [SliceHeader.parse(BitReader(u.rbsp), sps, pps, u.nal_unit_type,
                                 u.nal_ref_idc).idr_pic_id
               for u in units if u.nal_unit_type == nal.NAL_IDR]
    assert idr_ids == [0, 0, 1]


def test_plain_chain_equals_encoder_stream(clip):
    """The oracle chain that chip_smoke.py holds the kernel path against
    (plain K1 and plain K2-K5, stitched by the encoder) gives the encoder's
    own stream."""
    import chip_smoke

    enc = GopIpppEncoder(W, H, 28, gop_len=GOP, device="cpu")
    assert (chip_smoke.plain_ippp_stream(torch, torch.device("cpu"), enc, clip[:GOP])
            == enc.encode_sequence(clip[:GOP]))


def test_encoder_limits():
    for devices in (["cpu", "cuda"], []):  # streams: tests/test_torch_tile.py
        with pytest.raises(ValueError):
            GopIpppEncoder(W, H, 28, gop_len=GOP, devices=devices)
    with pytest.raises(ValueError):
        GopIpppEncoder(W, H, 28, gop_len=1, device="cpu")
    enc = GopIpppEncoder(W, H, 28, gop_len=GOP, device="cpu")
    ref = JaxGopIpppEncoder(W, H, 28, gop_len=GOP, devices=jax.devices()[:1])
    assert enc.headers() == ref.headers()
    assert enc._p_hdrs == ref._p_hdrs
