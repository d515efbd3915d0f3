"""The port's native slice decoder (native/decoder_native.cpp, built by g++)
against the decoder's Python form, and the Python form's parts against the
JAX package's, exactly (tolerance 0), with numpy only.

- Decoder(native=True) and Decoder(native=False) give the same planes and
  per-MB state after every slice on the fixture streams and on session
  streams of the port at several QPs, IDR periods and with the filter (as
  tests/test_native_decoder.py holds the JAX forms), the Python form on a
  few frames.
- A missing or failing g++ raises, from the build and from Decoder(): there
  is no fallback to the Python form.
- decode_residual_block (every nC context, 16 / 15 / 4 coefficients, large
  levels and escapes) and decode_level_code equal the JAX ones and the
  native block decoder on seeded random blocks written by the JAX writer;
  the native predictions equal ops/recon_host.py's.
- Every codec/mvpred.py function equals the JAX one on seeded random
  neighbourhoods with every P mb_type, sub_mb_type, intra and skip
  neighbour: the 16x8, 8x16 and sub-8x8 cases that no stored stream
  carries.
"""

import copy
import stat
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from h264_fer_tpu.bitstream.bitio import BitReader as JaxBitReader
from h264_fer_tpu.bitstream.bitio import BitWriter as JaxBitWriter
from h264_fer_tpu.codec import mvpred as jax_mvpred
from h264_fer_tpu.ops import cavlc as jax_cavlc
from h264_fer_tpu_torch import native
from h264_fer_tpu_torch.bitstream import nal
from h264_fer_tpu_torch.bitstream.bitio import BitReader
from h264_fer_tpu_torch.codec import mvpred
from h264_fer_tpu_torch.codec.decoder import MB_SKIP, Decoder
from h264_fer_tpu_torch.codec.encoder import Encoder, EncoderConfig
from h264_fer_tpu_torch.kernels import build
from h264_fer_tpu_torch.ops import cavlc, recon_host
from h264_fer_tpu_torch.vio.y4m import Y4MReader

torch.set_num_threads(1)

W, H = 176, 144
STATE = ("mb_type", "mb_intra", "mb_i4x4", "tc_luma", "tc_chroma", "mv", "i4x4_mode",
         "num_parts", "stale_chroma_ac", "mb_qp_delta", "qpy")


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return [tuple(np.array(p) for p in f)
            for f in list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:4]]


def assert_forms_agree(stream: bytes, n_frames: int, deblock: bool = False) -> None:
    """The native and the Python form decode the first n_frames of stream
    to the same frames and per-MB state."""
    nat = Decoder(deblock=deblock, device="cpu")
    py = Decoder(deblock=deblock, device="cpu", native=False)
    n = 0
    for u in nal.iter_nal_units(stream):
        a, b = nat.decode_nal(u), py.decode_nal(u)
        if a is None:
            assert b is None
            continue
        for k in range(3):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"frame {n} plane {k}")
        for key in STATE:
            np.testing.assert_array_equal(getattr(nat, key), getattr(py, key),
                                          err_msg=f"frame {n} {key}")
        n += 1
        if n == n_frames:
            return
    raise AssertionError(f"{n} frames, expected {n_frames}")


@pytest.mark.parametrize("name", ["ref_qcif_intra_qp28", "ref_qcif_ippp_qp28",
                                  "ref_qcif_ippp_qp20"])
def test_native_equals_python_on_fixtures(fixtures_dir, name):
    assert_forms_agree((fixtures_dir / f"{name}.264").read_bytes(), 4)


@pytest.mark.parametrize(
    "qp,intra_every,deblock,iframe",
    [(28, 1, False, "i16"), (28, 100, False, "i16"), (12, 100, False, "i16"),
     (40, 3, False, "i16"), (28, 100, True, "i16"), (24, 2, True, "mixed")])
def test_native_equals_python_on_session_streams(clip, qp, intra_every, deblock, iframe):
    n = 3 if iframe == "mixed" else 4
    enc = Encoder(W, H, EncoderConfig(qp=qp, intra_every=intra_every, deblock=deblock),
                  iframe=iframe, device="cpu")
    assert_forms_agree(enc.encode_sequence(clip[:n]), n, deblock=deblock)


FAKE_GXX = "#!/bin/sh\necho 'error: broken toolchain'\nexit 1\n"


@pytest.fixture
def fresh_native(tmp_path, monkeypatch):
    """No native library loaded or cached."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


def test_failing_gxx_raises(fresh_native, monkeypatch):
    gxx = fresh_native / "g++"
    gxx.write_text(FAKE_GXX)
    gxx.chmod(gxx.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "gxx", lambda: str(gxx))
    with pytest.raises(RuntimeError, match="broken toolchain"):
        native.load()
    with pytest.raises(RuntimeError, match="broken toolchain"):
        Decoder(device="cpu")
    assert native._lib is None
    assert list((fresh_native / "_build").iterdir()) == []  # no partial library


def test_missing_gxx_raises(fresh_native, monkeypatch):
    monkeypatch.setenv("PATH", str(fresh_native))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.gxx()
    with pytest.raises(RuntimeError, match="not found"):
        Decoder(device="cpu")
    assert Decoder(device="cpu", native=False)._lib is None  # asked for, not a fallback


def test_native_library_is_cached_by_hash(fresh_native):
    lib = native.load()
    assert native.load() is lib
    built = list((fresh_native / "_build").iterdir())
    assert len(built) == 1 and built[0].name.startswith("libdecoder_native-")
    assert build.compile_host_source(native.SOURCE) == (built[0], "")  # up to date


# ---------------------------------------------------------------------------
# CAVLC


def _random_block(rng, max_num_coeff: int):
    """Levels of one block in scan order: sparse, mostly small, sometimes
    trailing ones, sometimes large (escape codes)."""
    lv = np.zeros(max_num_coeff, np.int64)
    nz = rng.random(max_num_coeff) < rng.choice([0.0, 0.1, 0.4, 0.9, 1.0])
    mag = np.where(rng.random(max_num_coeff) < 0.1, rng.integers(16, 2000, max_num_coeff),
                   rng.integers(1, 4, max_num_coeff))
    lv[nz] = (mag * rng.choice([-1, 1], max_num_coeff))[nz]
    return [int(v) for v in lv]


@pytest.mark.parametrize("nc,max_num_coeff", [(-1, 4), (0, 16), (1, 15), (2, 16), (3, 15),
                                              (5, 16), (7, 15), (8, 16), (16, 15)])
def test_decode_residual_block_equals_jax_and_native(nc, max_num_coeff):
    rng = np.random.default_rng(100 + 17 * nc + max_num_coeff)
    blocks = [_random_block(rng, max_num_coeff) for _ in range(300)]
    w = JaxBitWriter()
    for b in blocks:
        jax_cavlc.write_residual_block(w, b, nc, max_num_coeff)
    w.rbsp_trailing_bits()
    data = w.getvalue()
    r, jr = BitReader(data), JaxBitReader(data)
    lib = native.load()
    buf = np.frombuffer(data, np.uint8)
    for b in blocks:
        pos = r.bit_position
        got = cavlc.decode_residual_block(r, nc, 0, max_num_coeff - 1, max_num_coeff)
        want = jax_cavlc.decode_residual_block(jr, nc, 0, max_num_coeff - 1, max_num_coeff)
        assert got == want and got[0] == b and r.bit_position == jr.bit_position
        out = np.zeros(16, np.int32)
        res = lib.dec_block_test(buf, len(data), pos, nc, max_num_coeff, out)
        assert (res >> 8, res & 255) == (r.bit_position, got[1])
        assert out[:max_num_coeff].tolist() == b


def test_invalid_coeff_token_raises():
    # 15 zero bits: no coeff_token of context 0 starts so
    with pytest.raises(ValueError, match="invalid VLC"):
        cavlc.decode_residual_block(BitReader(b"\x00\x01\xff"), 0, 0, 15, 16)


@pytest.mark.parametrize("suffix_len", range(7))
def test_decode_level_code_equals_jax(suffix_len):
    rng = np.random.default_rng(suffix_len)
    hi = (15 << suffix_len) + 4096 + (15 if suffix_len == 0 else 0)
    codes = np.concatenate([np.arange(0, 64), rng.integers(0, hi, 200)])
    w = JaxBitWriter()
    for code in codes:
        prefix, ssize, suffix = jax_cavlc.encode_level_code(int(code), suffix_len)
        w.write(1, prefix + 1)
        if ssize:
            w.write(suffix, ssize)
    w.rbsp_trailing_bits()
    r, jr = BitReader(w.getvalue()), JaxBitReader(w.getvalue())
    for code in codes:
        got = cavlc.decode_level_code(r, suffix_len)
        assert got == jax_cavlc.decode_level_code(jr, suffix_len) == code
        assert r.bit_position == jr.bit_position
    assert cavlc.nc_context(-1) == 4
    assert [cavlc.nc_context(n) for n in range(17)] == [jax_cavlc.nc_context(n)
                                                        for n in range(17)]


@pytest.mark.parametrize("kind,n", [("4x4", 13), ("16x16", 33), ("chroma", 17)])
def test_native_prediction_equals_host(kind, n):
    lib = native.load()
    hook, fn, modes = {"4x4": (lib.pred4_test, recon_host.predict_4x4, 9),
                       "16x16": (lib.pred16_test, recon_host.predict_16x16, 4),
                       "chroma": (lib.predc_test, recon_host.predict_chroma, 4)}[kind]
    rng = np.random.default_rng(n)
    for i in range(60):
        p = rng.integers(0, 256, n).astype(np.int32)
        if i % 3 == 0:
            p[0] = -1
            p[1: 1 + (n - 1) // 2] = -1
        elif i % 3 == 1:
            p[0] = -1
            p[1 + (n - 1) // 2:] = -1
        for mode in range(modes):
            out = np.zeros({"4x4": 16, "16x16": 256, "chroma": 64}[kind], np.int32)
            hook(p, mode, out)
            np.testing.assert_array_equal(out, np.asarray(fn(p, mode)).reshape(-1))


# ---------------------------------------------------------------------------
# MV prediction


def _random_state(rng, wmb: int, hmb: int):
    nmb = wmb * hmb
    mb_type = rng.choice([MB_SKIP, 0, 1, 2, 3, 4], nmb)
    mb_intra = rng.random(nmb) < 0.15
    mv = rng.integers(-40, 41, (nmb, 4, 4, 2)).astype(np.int32)
    mv[rng.random((nmb, 4)) < 0.2] = 0  # zero MVs: the P_Skip zero test
    return SimpleNamespace(wmb=wmb, mb_type=mb_type.astype(np.int32), mb_intra=mb_intra, mv=mv)


@pytest.mark.parametrize("wmb,hmb", [(5, 4), (1, 3), (3, 1)])
def test_mvpred_equals_jax(wmb, hmb):
    rng = np.random.default_rng(wmb * 10 + hmb)
    for trial in range(6):
        st = _random_state(rng, wmb, hmb)
        for curr in range(wmb * hmb):
            for xn, yn in ((-1, 0), (0, -1), (16, -1), (8, -1), (-1, -1), (-1, 8), (4, 4),
                           (16, 0), (0, 16), (20, -1)):
                loc = mvpred.locate_neighbor(st, curr, xn, yn)
                assert loc == jax_mvpred.locate_neighbor(st, curr, xn, yn)
                if loc is not None:
                    addr, xw, yw = loc
                    pidx = mvpred.part_idx_of(st, addr, xw, yw)
                    assert pidx == jax_mvpred.part_idx_of(st, addr, xw, yw)
                    assert mvpred.neighbor_mv(st, addr, pidx) == \
                        jax_mvpred.neighbor_mv(st, addr, pidx)
            assert mvpred.derive_skip_mv(st, curr) == jax_mvpred.derive_skip_mv(st, curr)
            for mb_type, parts in ((0, 1), (1, 2), (2, 2), (3, 4), (4, 4)):
                sub = [int(s) for s in rng.integers(0, 4, 4)]
                for p in range(parts):
                    got = mvpred.predict_mv_luma(st, curr, mb_type, parts, p, sub)
                    assert got == jax_mvpred.predict_mv_luma(st, curr, mb_type, parts, p, sub)
                    if mb_type != 3:
                        continue
                    assert mvpred.predict_mv_luma(st, curr, mb_type, parts, p, None) == \
                        jax_mvpred.predict_mv_luma(st, curr, mb_type, parts, p, None)
                part_mv = rng.integers(-64, 65, (4, 2)).astype(np.int32)
                for upto in range(parts):
                    ours, ref = copy.deepcopy(st), copy.deepcopy(st)
                    mvpred.store_part_mvs(ours, curr, mb_type, parts, part_mv, upto)
                    jax_mvpred.store_part_mvs(ref, curr, mb_type, parts, part_mv, upto)
                    mvpred.fan_out(ours, curr)
                    jax_mvpred.fan_out(ref, curr)
                    np.testing.assert_array_equal(ours.mv, ref.mv)
