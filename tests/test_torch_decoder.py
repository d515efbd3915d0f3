"""The port's Decoder (codec/decoder.py) against the reference decoder's
goldens and the JAX package's Decoder, exactly (tolerance 0).

- The three reference-encoder fixture streams decode to their golden YUV
  byte for byte, in the native and the Python form (as
  tests/test_decoder.py holds the JAX Decoder), and the drugi.264 frames to
  their md5s where that stream is mounted.
- On the port's own QCIF streams of its four encode paths (all-intra,
  IPPP, mixed I4x4/I16, the session encoder with the in-loop filter), the
  port's Decoder and the JAX Decoder agree after every slice: planes, the
  per-MB state (mb_type, tc_luma, tc_chroma, mv, i4x4_mode) and the final
  QPy, with the filter on and off, in the default and the spec-correct
  mode, in both forms. The filter's path runs the plain K8 on the CPU.
- The decoder's numpy helpers (ops/recon_host.py, the MC of ops/mc.py and
  ops/interp.py, classify_mb) equal the JAX package's numpy functions and
  the port's PyTorch ones on seeded random inputs.
- The CLI's decode writes the JAX CLI's Y4M bytes; Y4MWriter, write_yuv
  and read_yuv equal the JAX ones.

The JAX Decoder is numpy and C++: nothing here compiles JAX.
"""

import hashlib

import numpy as np
import pytest
import torch

from h264_fer_tpu import cli as jax_cli
from h264_fer_tpu.codec import decoder as jax_decoder
from h264_fer_tpu.ops import intra as jax_intra
from h264_fer_tpu.ops import mc as jax_mc
from h264_fer_tpu.ops import transform as jax_transform
from h264_fer_tpu.ops.interp import interpolated_planes as jax_planes
from h264_fer_tpu.vio import y4m as jax_y4m
from h264_fer_tpu_torch import cli
from h264_fer_tpu_torch.bitstream import nal
from h264_fer_tpu_torch.codec.decoder import Decoder, classify_mb
from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
from h264_fer_tpu_torch.ops import intra, mc, recon_host, transform
from h264_fer_tpu_torch.ops.interp import interpolated_planes, mc_macroblock_from_planes, pad_chroma
from h264_fer_tpu_torch.parallel.gop_device import GopIntraEncoder, GopIpppEncoder
from h264_fer_tpu_torch.vio import y4m
from test_decoder import DRUGI

torch.set_num_threads(1)

W, H = 176, 144
FIXTURES = ["ref_qcif_intra_qp28", "ref_qcif_ippp_qp28", "ref_qcif_ippp_qp20"]
STATE = ("mb_type", "tc_luma", "tc_chroma", "mv", "i4x4_mode", "qpy")
FORMS = {"native": True, "python": False}


class _JaxSpecDecoder(jax_decoder.Decoder):
    """The JAX Decoder in its spec-correct mode on every slice (as
    tests/test_torch_ippp.py reaches it)."""

    _spec_mode = property(lambda self: True, lambda self, value: None)


def jax_decoder_for(deblock: bool, spec: bool):
    return (_JaxSpecDecoder if spec else jax_decoder.Decoder)(deblock=deblock)


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return [tuple(np.array(p) for p in f)
            for f in list(y4m.Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:5]]


def port_streams(clip, qp: int = 28) -> dict:
    """QCIF streams of the port's four encode paths, on the CPU. The
    all-intra and mixed streams signal the filter (their payloads do not
    depend on it); the session stream filters every frame."""
    return {
        "all-intra": GopIntraEncoder(W, H, qp, deblock=True, device="cpu")
        .encode_sequence(clip[:3]),
        "IPPP": GopIpppEncoder(W, H, qp, gop_len=3, device="cpu").encode_sequence(clip[:4]),
        "mixed": GopIntraEncoder(W, H, qp, mode="mixed", deblock=True, device="cpu")
        .encode_sequence(clip[:2]),
        "session": Encoder(W, H, EncoderConfig(qp=qp, intra_every=3, deblock=True),
                           device="cpu").encode_sequence(clip[:5]),
    }


@pytest.fixture(scope="module")
def streams(clip):
    return port_streams(clip)


def assert_same_decode(stream: bytes, ours, ref, label: str) -> int:
    """Feed `stream` NAL by NAL to the port's decoder `ours` and the JAX
    decoder `ref`; after every slice the frames and the per-MB state must
    be equal. Returns the number of frames."""
    n = 0
    for u in nal.iter_nal_units(stream):
        got, want = ours.decode_nal(u), ref.decode_nal(u)
        assert (got is None) == (want is None)
        if got is None:
            continue
        for k, name in enumerate(("y", "cb", "cr")):
            assert got[k].dtype == np.uint8
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} frame {n} {name}")
        for key in STATE:
            np.testing.assert_array_equal(getattr(ours, key), getattr(ref, key),
                                          err_msg=f"{label} frame {n} {key}")
        n += 1
    return n


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", FIXTURES)
def test_reference_stream_bit_exact(fixtures_dir, name, form):
    data = (fixtures_dir / f"{name}.264").read_bytes()
    golden = jax_y4m.read_yuv(str(fixtures_dir / f"{name}.golden.yuv"), W, H)
    frames = list(Decoder(device="cpu", native=FORMS[form]).decode_annexb(data))
    assert len(frames) == len(golden) == 10
    for i, (f, g) in enumerate(zip(frames, golden)):
        for k, plane in enumerate("y cb cr".split()):
            np.testing.assert_array_equal(f[k], g[k], err_msg=f"{name} frame {i} {plane}")


@pytest.mark.skipif(not DRUGI.exists(), reason="reference stream not mounted")
def test_drugi_x264_stream_bit_exact(fixtures_dir):
    """The first frames of the x264 stream against the reference decoder's
    md5s, frame 0 also against its stored golden bytes."""
    hashes = (fixtures_dir / "drugi_frames.md5").read_text().split()
    golden0 = (fixtures_dir / "drugi_frame0.golden.yuv").read_bytes()
    for i, f in enumerate(Decoder(device="cpu").decode_annexb(DRUGI.read_bytes())):
        raw = f[0].tobytes() + f[1].tobytes() + f[2].tobytes()
        if i == 0:
            assert raw == golden0
        assert hashlib.md5(raw).hexdigest() == hashes[i], f"frame {i}"
        if i + 1 >= 6:
            break


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("spec", [False, True], ids=["default", "spec"])
@pytest.mark.parametrize("deblock", [False, True], ids=["nofilter", "filter"])
@pytest.mark.parametrize("path", ["all-intra", "IPPP", "mixed", "session"])
def test_port_streams_decode_as_jax(streams, path, deblock, spec, form):
    ours = Decoder(deblock=deblock, device="cpu", native=FORMS[form], spec_mode=spec)
    n = assert_same_decode(streams[path], ours, jax_decoder_for(deblock, spec), path)
    assert n == {"all-intra": 3, "IPPP": 4, "mixed": 2, "session": 5}[path]


def test_filtered_session_decode_is_the_encoder_reconstruction(clip):
    """The session stream with the filter decodes (filter on) to the
    encoder's reference planes, frame by frame; without the filter it
    does not."""
    enc = Encoder(W, H, EncoderConfig(qp=30, intra_every=3, deblock=True), device="cpu")
    stream, recon = enc.headers(), []
    for f in clip[:4]:
        stream += enc.encode_frame(*f)
        recon.append(enc.reconstructed())
    for deblock in (True, False):
        frames = list(Decoder(deblock=deblock, device="cpu").decode_annexb(stream))
        same = [all(np.array_equal(a, b) for a, b in zip(f, r)) for f, r in zip(frames, recon)]
        assert same == [deblock] * 4


# ---------------------------------------------------------------------------
# numpy helpers of the Python form


def _neighbours(rng, n: int, shape):
    """Random neighbour samples with some unavailable (-1) runs."""
    p = rng.integers(0, 256, shape).astype(np.int32)
    p[rng.random(shape[0]) < 0.3, :1] = -1
    return p


@pytest.mark.parametrize("mode", range(9))
def test_predict_4x4_equals_jax_and_torch(mode):
    rng = np.random.default_rng(mode)
    p = _neighbours(rng, 13, (64, 13))
    p[::4, 1:5] = -1  # left unavailable
    p[1::4, 5:13] = -1  # top unavailable
    want = jax_intra.predict_4x4(p, mode)
    torch_pred = intra.predict_4x4(torch.from_numpy(p), mode).numpy()
    for i in range(len(p)):
        got = recon_host.predict_4x4(p[i], mode)
        np.testing.assert_array_equal(got, want[i])
        np.testing.assert_array_equal(got, torch_pred[i])


@pytest.mark.parametrize("mode", range(4))
def test_predict_16x16_and_chroma_equal_jax_and_torch(mode):
    rng = np.random.default_rng(10 + mode)
    for fn, jfn, tfn, n in ((recon_host.predict_16x16, jax_intra.predict_16x16,
                             intra.predict_16x16, 33),
                            (recon_host.predict_chroma, jax_intra.predict_chroma,
                             intra.predict_chroma, 17)):
        p = _neighbours(rng, n, (48, n))
        half = (n - 1) // 2
        p[::3, 1: 1 + half] = -1
        p[1::3, 1 + half:] = -1
        want, tw = jfn(p, mode), tfn(torch.from_numpy(p), mode).numpy()
        for i in range(len(p)):
            np.testing.assert_array_equal(fn(p[i], mode), want[i])
            np.testing.assert_array_equal(fn(p[i], mode), tw[i])


@pytest.mark.parametrize("qp", [0, 12, 23, 24, 35, 36, 51])
def test_inverse_transforms_equal_jax_and_torch(qp):
    rng = np.random.default_rng(qp)
    lv = rng.integers(-40, 41, (8, 16)).astype(np.int32)
    blocks = recon_host.zigzag_unscan(lv)
    np.testing.assert_array_equal(blocks, jax_transform.zigzag_unscan(lv))
    for bypass in (False, True):
        got = recon_host.inverse_residual(blocks, qp, bypass)
        np.testing.assert_array_equal(got, jax_transform.inverse_residual(blocks, qp, bypass))
        np.testing.assert_array_equal(
            got, transform.inverse_residual(torch.from_numpy(blocks), qp, bypass).numpy())
    dc = rng.integers(-200, 201, (4, 4)).astype(np.int32)
    np.testing.assert_array_equal(recon_host.inverse_dc_luma(dc, qp),
                                  jax_transform.inverse_dc_luma(dc, qp))
    cdc = rng.integers(-200, 201, (2, 2, 2)).astype(np.int32)
    np.testing.assert_array_equal(recon_host.inverse_dc_chroma(cdc, qp),
                                  jax_transform.inverse_dc_chroma(cdc, qp))


@pytest.mark.parametrize("slice_type", [0, 2], ids=["P", "I"])
def test_classify_mb_equals_jax(slice_type):
    for mb_type in range(30 if slice_type == 0 else 25):
        got, want = classify_mb(mb_type, slice_type), jax_decoder.classify_mb(mb_type, slice_type)
        assert got.__dict__ == want.__dict__
    with pytest.raises(NotImplementedError):
        classify_mb(30 if slice_type == 0 else 25, slice_type)


def test_mc_equals_jax():
    """The window MC (ops/mc.py) and the MC from interpolated planes equal
    the JAX window MC at every fractional phase, the planes' MVs within
    their extent, the window's beyond it."""
    rng = np.random.default_rng(5)
    ref = [rng.integers(0, 256, s).astype(np.int32) for s in ((48, 64), (24, 32), (24, 32))]
    ext, extc = 8, 5
    planes = interpolated_planes(torch.from_numpy(ref[0]), ext).numpy()
    np.testing.assert_array_equal(planes, jax_planes(ref[0], ext))
    pads = [pad_chroma(torch.from_numpy(c), extc).numpy() for c in ref[1:]]
    for i in range(40):
        mv = np.zeros((4, 4, 2), np.int32)
        lim = 4 * ext - 4 if i < 30 else 200
        mv[:, :] = rng.integers(-lim, lim + 1, (4, 1, 2))
        mbx, mby = rng.integers(0, 4), rng.integers(0, 3)
        want = jax_mc.mc_macroblock(*ref, mbx, mby, mv)
        for got in ([mc.mc_macroblock(*ref, mbx, mby, mv)]
                    + ([mc_macroblock_from_planes(planes, *pads, mbx, mby, mv, ext, extc)]
                       if i < 30 else [])):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# CLI decode and Y4M output


@pytest.mark.parametrize("deblock", [False, True], ids=["nofilter", "filter"])
@pytest.mark.parametrize("source", ["fixture", "session"])
def test_cli_decode_writes_the_jax_cli_bytes(tmp_path, fixtures_dir, streams, source, deblock):
    src = tmp_path / "in.264"
    if source == "fixture":
        src.write_bytes((fixtures_dir / "ref_qcif_ippp_qp28.264").read_bytes())
    else:
        src.write_bytes(streams["session"])
    flags = ["--deblock"] if deblock else []
    ours, ref = tmp_path / "ours.y4m", tmp_path / "ref.y4m"
    assert cli.main(["decode", str(src), str(ours), "--fps", "30", "--device", "cpu", *flags]) == 0
    assert jax_cli.main(["decode", str(src), str(ref), "--fps", "30", *flags]) == 0
    assert ours.read_bytes() == ref.read_bytes()
    assert ours.read_bytes().startswith(b"YUV4MPEG2 C420jpeg W176 H144 F30:1")


def test_y4m_writer_and_raw_yuv_equal_jax(tmp_path, clip):
    for mod, name in ((y4m, "ours"), (jax_y4m, "ref")):
        w = mod.Y4MWriter(str(tmp_path / f"{name}.y4m"), W, H, 25, 2)
        for f in clip[:2]:
            w.write_frame(*f)
        w.close()
        mod.write_yuv(str(tmp_path / f"{name}.yuv"), clip[:2])
    for ext in ("y4m", "yuv"):
        assert (tmp_path / f"ours.{ext}").read_bytes() == (tmp_path / f"ref.{ext}").read_bytes()
    ours, ref = (mod.read_yuv(str(tmp_path / "ours.yuv"), W, H) for mod in (y4m, jax_y4m))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        for x, y_ in zip(a, b):
            np.testing.assert_array_equal(x, y_)
    read_back = list(y4m.Y4MReader(str(tmp_path / "ours.y4m"), crop_to_mb=False))
    for a, b in zip(read_back, clip[:2]):
        for x, y_ in zip(a, b):
            np.testing.assert_array_equal(x, y_)
