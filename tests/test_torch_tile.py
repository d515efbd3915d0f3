"""The port's multi-device encoders on the CPU, exactly (tolerance 0, streams
by bytes): the band forms of K1t, K7 and K6 (their plain twins, through the
band wrappers), the mode decision's source halo and the entropy's cross-band
context, each run band by band with its halo, against the full-frame
outputs, for 3, 9, 2 and 4 bands on QCIF's 9 MB rows (2 and 4 uneven); the
streams of TileIntraEncoder, GopTileIntraEncoder and GopIntraEncoder /
GopIpppEncoder over several entries of "cpu" against the port's one-device
streams, the band recon against the port's Decoder; the CLI's
--gop-devices / --tile-devices (with P frames too); the device-list rules;
the dry run, parts 1-4. (The
streams against the JAX TileIntraEncoder's: tests/test_torch_tile_jax.py;
the multi-process encode: tests/test_torch_dist.py.)"""

import numpy as np
import pytest
import torch

from h264_fer_tpu_torch import cli
from h264_fer_tpu_torch.bitstream.bitio import BitWriter
from h264_fer_tpu_torch.codec.decoder import Decoder
from h264_fer_tpu_torch.codec.entropy import (
    chroma_setup,
    i16_slice_entropy,
    mixed_slice_entropy,
)
from h264_fer_tpu_torch.codec.intra_decision import intra_mode_decision
from h264_fer_tpu_torch.kernels.wavefront_i16 import (
    chroma_band,
    chroma_frame_plain,
    i16_band,
    i16_frame_plain,
)
from h264_fer_tpu_torch.kernels.wavefront_mixed import KEYS, mixed_luma_band, mixed_luma_plain
from h264_fer_tpu_torch.ops.cavlc_bulk import words_to_bytes
from h264_fer_tpu_torch.ops.device import resolve_devices
from h264_fer_tpu_torch.ops.intra import INTRA16_TO_CHROMA_MODE
from h264_fer_tpu_torch.ops.transform import chroma_qp
from h264_fer_tpu_torch.parallel import dryrun, gop_device
from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder, GopIpppEncoder
from h264_fer_tpu_torch.parallel.tile import GopTileIntraEncoder, TileIntraEncoder
from h264_fer_tpu_torch.vio.y4m import Y4MReader

torch.set_num_threads(1)

W, H, QP = 176, 144, 28
WMB, HMB = W // 16, H // 16
QPC = chroma_qp(QP)
N_TILES = [3, 9, 2, 4]  # 2 and 4 do not divide QCIF's 9 MB rows
QP_MIXED = 12  # both classes win on the clip's first frame


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))


def padded(frame, n: int):
    """The frame's planes as tensors, padded below with edge-replicated rows
    to n bands of ceil(9 / n) MB rows, and that band height."""
    hloc = -(-HMB // n)
    out = []
    for p, s in zip(frame, (16, 8, 8)):
        p = np.asarray(p)
        out.append(torch.from_numpy(np.concatenate(
            [p, np.repeat(p[-1:], n * hloc * s - p.shape[0], axis=0)])))
    return out, hloc


def rows(x, t: int, hloc: int, per_mb: int = 1, dim: int = 0):
    """Band t's part of x: MB rows [t * hloc, (t + 1) * hloc) of a plane
    (per_mb samples per MB row) or of a per-MB array (per_mb = WMB)."""
    return x.narrow(dim, t * hloc * per_mb, hloc * per_mb)


def cat_equal(bands, full, dim: int = 0):
    torch.testing.assert_close(torch.cat(bands, dim), full, rtol=0, atol=0)


@pytest.mark.parametrize("n", N_TILES)
def test_k1t_band_equals_full_frame(clip, n):
    (y, cb, cr), hloc = padded(clip[0], n)
    dec = intra_mode_decision(y.to(torch.int32), QP)
    m16 = dec["mode16"]
    cmode = torch.from_numpy(INTRA16_TO_CHROMA_MODE)[m16.long()].to(torch.int32)
    full = i16_frame_plain(y, cb, cr, m16, cmode, QP, QPC)
    outs, top = [], None
    for t in range(n):
        out = i16_band(rows(y, t, hloc, 16), rows(cb, t, hloc, 8), rows(cr, t, hloc, 8),
                       rows(m16, t, hloc, WMB), rows(cmode, t, hloc, WMB), QP, QPC, top)
        outs.append(out)
        top = (out[0][-1], out[3][-1], out[4][-1])
    for k, dim in enumerate((0, 0, 0, 0, 0, 1, 1)):  # ry, i16dc, ac, rcb, rcr, cdc, cac
        cat_equal([o[k] for o in outs], full[k], dim)


@pytest.mark.parametrize("n", N_TILES)
def test_k7_band_equals_full_frame(clip, n):
    (_, cb, cr), hloc = padded(clip[1], n)
    cmode = torch.from_numpy(np.random.default_rng(n).integers(0, 4, n * hloc * WMB)
                             .astype(np.int32))
    full = chroma_frame_plain(cb, cr, cmode, QPC)
    outs, top = [], None
    for t in range(n):
        outs.append(chroma_band(rows(cb, t, hloc, 8), rows(cr, t, hloc, 8),
                                rows(cmode, t, hloc, WMB), QPC, top))
        top = (outs[-1][0][-1], outs[-1][1][-1])
    for k, dim in enumerate((0, 0, 1, 1)):
        cat_equal([o[k] for o in outs], full[k], dim)


def mixed_inputs(y, cb, cr, qp: int):
    dec = intra_mode_decision(y.to(torch.int32), qp)
    cmode = torch.from_numpy(INTRA16_TO_CHROMA_MODE)[dec["mode16"].long()].to(torch.int32)
    _, _, cdc, cac = chroma_frame_plain(cb, cr, cmode, chroma_qp(qp))
    return dec, cmode, cdc, cac


@pytest.mark.parametrize("n", N_TILES)
def test_k6_band_equals_full_frame(clip, n):
    (y, cb, cr), hloc = padded(clip[0], n)
    dec, cmode, cdc, cac = mixed_inputs(y, cb, cr, QP_MIXED)
    ch = chroma_setup(cdc, cac, WMB, n * hloc)
    args = (dec["mode16"], dec["mode4"], cmode, ch["cbp_chroma"], ch["bits"])
    full = mixed_luma_plain(y, *args, QP_MIXED)
    assert 0 < int(full["choice4"].sum()) < n * hloc * WMB  # both classes win
    outs, top = [], None
    for t in range(n):
        out = mixed_luma_band(rows(y, t, hloc, 16), *(rows(a, t, hloc, WMB) for a in args),
                              QP_MIXED, top)
        outs.append(out)
        top = {"recon": out["recon_y"][-1], "choice4": out["choice4"][-WMB:],
               "tc_luma": out["tc_luma"][-WMB:], "cbp_luma": out["cbp_luma"][-WMB:],
               "mode4": rows(dec["mode4"], t, hloc, WMB)[-WMB:]}
    for key in KEYS:
        cat_equal([o[key] for o in outs], full[key])


@pytest.mark.parametrize("n", N_TILES)
def test_mode_decision_top_row_equals_full_frame(clip, n):
    y = torch.from_numpy(np.array(clip[2][0])).to(torch.int32)
    hloc = -(-HMB // n)
    full = intra_mode_decision(y, QP)
    bands = []
    for t in range(n):
        r0, r1 = t * hloc, min((t + 1) * hloc, HMB)
        if r0 < r1:
            bands.append(intra_mode_decision(y[16 * r0: 16 * r1], QP,
                                             y[16 * r0 - 1] if t else None))
    for key in full:
        cat_equal([b[key] for b in bands], full[key])


def splice(parts) -> tuple:
    w = BitWriter()
    for words, nbits in parts:
        w.append_bits(words_to_bytes(words.numpy(), int(nbits)), int(nbits))
    n = w.bit_position
    if n % 8:  # zero-pad the last byte
        w.write(0, 8 - n % 8)
    return n, w.getvalue()


def payload(ent) -> tuple:
    return splice([(ent["words"], ent["nbits"])])


def last_row_ctx(ent):
    return (ent["tc_luma"][-WMB:], ent["cbp_luma"][-WMB:], ent["tc_chroma"][:, -WMB:],
            ent["cbp_chroma"][-WMB:])


@pytest.mark.parametrize("n", N_TILES)
def test_band_entropy_spliced_equals_full_frame(clip, n):
    """i16 and mixed slice entropy per band, with the band above's nC
    context (top_ctx) and the padded MBs gated (valid), spliced at bit
    granularity: the full frame's payload."""
    (y, cb, cr), hloc = padded(clip[0], n)
    real = HMB * WMB
    dec, cmode, cdc, cac = mixed_inputs(y, cb, cr, QP_MIXED)
    m16 = dec["mode16"]
    _, i16dc, ac, _, _, cdc16, cac16 = i16_frame_plain(y, cb, cr, m16, cmode, QP, QPC)
    ch = chroma_setup(cdc, cac, WMB, n * hloc)
    mx = mixed_luma_plain(y, m16, dec["mode4"], cmode, ch["cbp_chroma"], ch["bits"],
                          QP_MIXED)
    i16_args = (m16, cmode, i16dc, ac, cdc16, cac16)
    mixed_args = (mx["choice4"], m16, cmode, mx["i16dc"], mx["i16ac"], mx["lv4"],
                  mx["prev_flags"], mx["rem_modes"], mx["cbp_luma"], mx["tc_luma"], cdc, cac)
    for fn, args in ((i16_slice_entropy, i16_args), (mixed_slice_entropy, mixed_args)):
        chroma = {len(args) - 2, len(args) - 1}

        def setup(a, hmb, ctx):
            """The mixed entropy's chroma setup of the levels `a` hold."""
            if fn is not mixed_slice_entropy:
                return {}
            return {"chroma": chroma_setup(a[-2], a[-1], WMB, hmb,
                                           None if ctx is None else ctx[2:])}

        cut = [a[:, :real] if i in chroma else a[:real] for i, a in enumerate(args)]
        want = payload(fn(*cut, wmb=WMB, hmb=HMB, **setup(cut, HMB, None)))
        parts, ctx = [], None
        for t in range(n):
            band = [rows(a, t, hloc, WMB, 1 if i in chroma else 0) for i, a in enumerate(args)]
            valid = torch.arange(hloc * WMB) // WMB + t * hloc < HMB
            ent = fn(*band, wmb=WMB, hmb=hloc, top_ctx=ctx,
                     valid=None if bool(valid.all()) else valid, **setup(band, hloc, ctx))
            parts.append((ent["words"], ent["nbits"]))
            ctx = last_row_ctx(ent)
        assert splice(parts) == want, fn.__name__


@pytest.mark.parametrize("mode, n", [("i16", 3), ("i16", 9), ("i16", 2), ("i16", 4),
                                     ("mixed", 3), ("mixed", 2)])
def test_tile_stream_equals_one_device_stream(clip, mode, n):
    frames = clip[:2]
    want = GopIntraEncoder(W, H, QP, mode=mode, device="cpu").encode_sequence(frames)
    enc = TileIntraEncoder(W, H, QP, devices=["cpu"] * n, mode=mode)
    assert (enc.n_tile, enc.hloc, enc.hmb_pad) == (n, -(-HMB // n), n * -(-HMB // n))
    assert enc.encode_sequence(frames, keep_recon=True) == want
    decoded = list(Decoder(device="cpu").decode_annexb(want))
    assert len(enc.recon) == len(decoded) == len(frames)
    for got, ref in zip(enc.recon, decoded):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_tile_idr_pic_id_counts_frames(clip):
    """TileIntraEncoder counts idr_pic_id over its life (the reference's
    per-frame counter), GopIntraEncoder from idr_base: both give the serial
    stream."""
    enc = TileIntraEncoder(W, H, QP, devices=["cpu"] * 3)
    ref = GopIntraEncoder(W, H, QP, device="cpu")
    hdr = len(ref.headers())
    assert enc.encode_sequence(clip[:2]) == ref.encode_sequence(clip[:2])
    assert enc.encode_frame(*clip[2]) == ref.encode_sequence(clip[2:3], idr_base=2)[hdr:]
    assert enc.encode_sequence(clip[3:5])[hdr:] == ref.encode_sequence(clip[3:5],
                                                                       idr_base=3)[hdr:]
    assert len(enc.recon) == 3 and enc.recon[0].shape == (H, W)


@pytest.mark.parametrize("mode, n_gop, n_tile", [("i16", 2, 3), ("i16", 2, 9), ("i16", 4, 1),
                                                 ("mixed", 2, 3)])
def test_gop_tile_stream_equals_one_device_stream(clip, mode, n_gop, n_tile):
    frames = clip[:3]  # an odd count: the gop rows' shares differ
    want = GopIntraEncoder(W, H, QP, mode=mode, device="cpu").encode_sequence(frames)
    enc = GopTileIntraEncoder(W, H, QP, n_gop, n_tile, devices=["cpu"] * (n_gop * n_tile + 1),
                              mode=mode)
    assert len(enc.devices) == n_gop * n_tile
    assert enc.encode_sequence(frames, keep_recon=True) == want
    decoded = list(Decoder(device="cpu").decode_annexb(want))
    for got, ref in zip(enc.recon, decoded):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        GopTileIntraEncoder(W, H, QP, n_gop, n_tile, devices=["cpu"] * (n_gop * n_tile - 1))


@pytest.mark.parametrize("mode, n", [("i16", 2), ("i16", 3)])
def test_gop_intra_over_devices_equals_one_device(clip, mode, n):
    """(mixed frames over a device list: the dry run's part 2, below)"""
    frames = clip[:4]
    one = GopIntraEncoder(W, H, QP, mode=mode, device="cpu")
    many = GopIntraEncoder(W, H, QP, mode=mode, devices=["cpu"] * n)
    assert len(many.lanes) == n
    assert many.encode_sequence(frames, idr_base=4) == one.encode_sequence(frames, idr_base=4)


def scene_cut_clip(clip):
    """5 frames with cuts at frames 2 and 3 (frame 2 flipped and inverted)."""
    frames = [tuple(np.asarray(p) for p in f) for f in clip[:5]]
    frames[2] = tuple(np.ascontiguousarray(255 - p[::-1]) for p in frames[2])
    return frames


@pytest.mark.parametrize("n, scene_cut", [(3, False), (2, True)])
def test_gop_ippp_over_devices_equals_one_device(clip, n, scene_cut):
    frames = scene_cut_clip(clip) if scene_cut else clip[:5]
    kw = {"gop_len": 3, "scene_cut_source": scene_cut}
    one = GopIpppEncoder(W, H, QP, device="cpu", **kw)
    assert one._gop_lengths(frames) == ([2, 1, 2] if scene_cut else [3, 2])
    assert (GopIpppEncoder(W, H, QP, devices=["cpu"] * n, **kw).encode_sequence(frames)
            == one.encode_sequence(frames))


def test_cli_multi_device_writes_encoder_bytes(clip, fixtures_dir, tmp_path):
    src, out = str(fixtures_dir / "clip_qcif_10f.y4m"), tmp_path / "s.264"
    cases = [
        (["--gop-devices", "2", "--intra-every", "1"],
         GopIntraEncoder(W, H, QP, device="cpu")),
        (["--gop-devices", "2", "--intra-every", "2"],
         GopIpppEncoder(W, H, QP, gop_len=2, device="cpu")),
        (["--tile-devices", "3", "--intra-every", "1"],
         GopIntraEncoder(W, H, QP, device="cpu")),
    ]
    wants = []
    for args, enc in cases:
        assert cli.main(["encode", src, str(out), "--end-frame", "2", "--device", "cpu",
                         *args]) == 0, args
        wants.append(enc.encode_sequence(clip[:2]))
        assert out.read_bytes() == wants[-1], args
    # with P frames, TileIpppEncoder's bytes: on 2 frames one GOP, the
    # one-device IPPP stream above (the band streams against the JAX
    # GopIpppEncoder's: tests/test_torch_ippp.py)
    assert cli.main(["encode", src, str(out), "--end-frame", "2", "--device", "cpu",
                     "--tile-devices", "3", "--intra-every", "8"]) == 0
    assert out.read_bytes() == wants[1]


def test_device_lists():
    assert resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    for bad in ([], ["cpu", "cuda"], ["cuda:0", "cpu"]):
        with pytest.raises(ValueError):
            resolve_devices(bad)
    if not torch.cuda.is_available():
        for bad in (None, ["cuda"], ["cuda:0", "cuda:0"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                resolve_devices(bad)
        with pytest.raises(RuntimeError, match="CUDA"):
            TileIntraEncoder(W, H, QP)
        with pytest.raises(RuntimeError, match="CUDA"):
            GopTileIntraEncoder(W, H, QP, 2, 2)
    lane = gop_device.Lane(torch.device("cpu"))
    assert lane.stream is None and lane.record() is None
    with lane.queue():
        lane.wait(None)
    assert [list(r) for r in gop_device.shares(7, 3)] == [[0, 1, 2], [3, 4], [5, 6]]
    assert [list(r) for r in gop_device.shares(2, 3)] == [[0], [1], []]
    assert list(gop_device.interleave([range(0, 2), range(2, 3)])) == [(0, 0), (1, 2), (0, 1)]


def test_dryrun_and_scaling_on_cpu():
    lines = []
    dryrun.dryrun_multichip(["cpu"] * 4, log=lines.append)
    assert [line[:13] for line in lines] == ["dryrun 1/4 OK", "dryrun 2/4 OK",
                                             "dryrun 3/4 OK", "dryrun 4/4 OK"]
    assert dryrun.grid(4) == (2, 2) and dryrun.grid(8) == (2, 4) and dryrun.grid(3) == (3, 1)
    fps = gop_device.measure_scaling(32, 32, 30, n_frames=2, device_counts=(1, 2, 4),
                                     reps=1, devices=["cpu"] * 2)
    assert sorted(fps) == [1, 2] and all(v > 0 for v in fps.values())


def test_band_wrappers_refuse_bad_halos(clip):
    """A halo row of the wrong width or dtype, or a K6 halo without a key,
    is refused before any plain or kernel code runs."""
    (y, cb, cr), hloc = padded(clip[0], 3)
    nmb = hloc * WMB
    y, cb, cr = y[: 16 * hloc], cb[: 8 * hloc], cr[: 8 * hloc]
    modes = torch.zeros(nmb, dtype=torch.int32)
    with pytest.raises(ValueError, match="top"):
        i16_band(y, cb, cr, modes, modes, QP, QPC, (y[0], cb[0]))
    with pytest.raises(ValueError, match="top"):
        i16_band(y, cb, cr, modes, modes, QP, QPC, (y[0], cb[0], cr[0, :8]))
    with pytest.raises(ValueError, match="top"):
        chroma_band(cb, cr, modes, QPC, (cb[0].to(torch.int32), cr[0]))
    top = {"recon": y[0], "choice4": torch.zeros(WMB, dtype=torch.bool),
           "tc_luma": torch.zeros((WMB, 16), dtype=torch.int32),
           "cbp_luma": torch.zeros(WMB, dtype=torch.int32)}
    args = (y, modes, torch.zeros((nmb, 16), dtype=torch.int32), modes, modes, modes, QP)
    with pytest.raises(ValueError, match="mode4"):
        mixed_luma_band(*args, top)
    with pytest.raises(ValueError, match="top"):
        mixed_luma_band(*args, {**top, "mode4": torch.zeros((WMB, 15), dtype=torch.int32)})
