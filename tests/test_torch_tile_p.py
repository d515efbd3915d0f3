"""The P-frame band encoders' parts on the CPU, exactly (tolerance 0), each
held against its JAX counterpart or the frame form's rows, on QCIF's 9 MB
rows in 3 bands: the banded interpolated planes and chroma pad (real halo
rows, and the top and bottom bands' repeated edge rows) against the JAX
interpolated_planes_banded_jax and the frame planes' row window; the plain
K4-band with the band above's last MB row as its halo against the plain
K4's rows; the band's nC halo state against the JAX _p_last_row_state; the
band payloads of p_slice_entropy with both contexts, spliced with the
trailing run, against the one-band payload; the band form of the
trailing-skip drop; the encoders' argument checks. Eager JAX on small
arrays, no JAX compile (the streams against the JAX GopIpppEncoder's:
tests/test_torch_ippp.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h264_fer_tpu.ops.interp import interpolated_planes_banded_jax
from h264_fer_tpu.parallel.tile_p import _p_last_row_state
from h264_fer_tpu_torch.codec.entropy import p_slice_entropy
from h264_fer_tpu_torch.codec.gop import trailing_skip_drop
from h264_fer_tpu_torch.kernels.wavefront_p import (MB_SKIP, pframe_decide_band,
                                                    pframe_decide_plain)
from h264_fer_tpu_torch.ops.cavlc_bulk import words_to_bytes
from h264_fer_tpu_torch.ops.interp import (interpolated_planes, interpolated_planes_banded,
                                           pad_chroma, pad_chroma_banded)
from h264_fer_tpu_torch.parallel.tile import _ctx, _last_row_state
from h264_fer_tpu_torch.parallel.tile_p import GopTileIpppEncoder, TileIpppEncoder, _window
from h264_fer_tpu_torch.vio.y4m import Y4MReader

torch.set_num_threads(1)

W, H, QP, WINDOW = 176, 144, 28, 8
WMB, HMB = W // 16, H // 16
NMB = WMB * HMB
N_TILE, HL = 3, 3  # 3 bands of 3 MB rows
NMBL = WMB * HL
EXT = WINDOW + 2
EXT_C = EXT // 2 + 1
CPU = torch.device("cpu")
DECIDE = ("skip", "mb_type", "mv", "mvd")


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return [tuple(torch.from_numpy(np.array(p)) for p in f)
            for f in list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:2]]


@pytest.fixture(scope="module")
def p_frame(clip):
    """Frame 1 predicted from frame 0 by device_p_frame's stages with the
    plain twins, previous MVs random up to beyond the search limit: (the
    K4 arguments, the plain K4's decision, the levels)."""
    import chip_smoke

    lim = 4 * EXT - 4
    prev = torch.from_numpy(np.random.default_rng(3).integers(
        -lim - 4, lim + 5, (NMB, 4, 2)).astype(np.int32))
    _, args, outs = chip_smoke.p_frame_stages(torch, chip_smoke.p_kernels(plain=True),
                                              clip[1], (*clip[0], prev), QP)
    return args["wavefront_p"], outs["wavefront_p"], outs["residual_recon"][0]


def bands(x, rows: int):
    """The N_TILE bands of plane x (`rows` sample rows per MB row)."""
    return [x[rows * HL * t: rows * HL * (t + 1)] for t in range(N_TILE)]


def neighbours(xs, t):
    return xs[t - 1] if t else None, xs[t + 1] if t + 1 < N_TILE else None


def test_banded_planes_are_the_frame_planes_rows(clip):
    ref_y, ref_cb, _ = clip[0]
    frame_planes = interpolated_planes(ref_y, EXT)
    frame_cb = pad_chroma(ref_cb, EXT_C)
    ys, cbs = bands(ref_y, 16), bands(ref_cb, 8)
    for t in range(N_TILE):  # band 0 and band 2 repeat the frame's edge rows
        ref_v = _window(ys[t], *neighbours(ys, t), EXT + 4, CPU)
        got = interpolated_planes_banded(ref_v, EXT)
        rows = slice(16 * HL * t, 16 * HL * (t + 1) + 2 * EXT)
        assert torch.equal(got, frame_planes[:, rows]), t
        ref = np.asarray(interpolated_planes_banded_jax(jnp.asarray(ref_v.numpy()), EXT))
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"band {t}")
        cb_v = _window(cbs[t], *neighbours(cbs, t), EXT_C + 1, CPU)
        crow = slice(8 * HL * t, 8 * HL * (t + 1) + 2 * EXT_C + 2)
        assert torch.equal(pad_chroma_banded(cb_v, EXT_C), frame_cb[crow]), t


def test_plain_k4_band_equals_the_frame_rows(p_frame):
    (y, planes, *maps), full, _ = p_frame
    metric_id, lam = maps[-2:]
    for t in range(N_TILE):
        mbs = slice(NMBL * t, NMBL * (t + 1))
        args = (bands(y, 16)[t], planes[:, 16 * HL * t: 16 * HL * (t + 1) + 2 * EXT],
                *(m[mbs] for m in maps[:7]), WMB, HL, WINDOW, EXT, metric_id, lam)
        top = None
        if t:
            row = slice(NMBL * t - WMB, NMBL * t)
            top = (full["mv"][row], torch.where(full["skip"][row], MB_SKIP,
                                                full["mb_type"][row]).to(torch.int32))
        got = pframe_decide_band(*args, top)
        for k in DECIDE:
            assert torch.equal(got[k], full[k][mbs]), (t, k)
        if t:  # the halo is read: without it band t's decisions differ
            alone = pframe_decide_plain(*args)
            assert any(not torch.equal(alone[k], got[k]) for k in DECIDE)
    with pytest.raises(ValueError):
        pframe_decide_band(*args, (top[0][:-1], top[1]))
    with pytest.raises(ValueError):
        pframe_decide_band(*args, (top[0], top[1].to(torch.int64)))


def band_inputs(dec, levels, t: int, force_skip=(0, 0)):
    """The entropy inputs of band t (the whole frame for t None), the MBs
    force_skip[0] to force_skip[1] - 1 turned to skips (no levels, no
    mvd)."""
    skip = dec["skip"].clone()
    skip[force_skip[0]: force_skip[1]] = True
    z = lambda x, m: torch.where(m, 0, x)  # noqa: E731
    full = (skip, dec["mb_type"], z(dec["mvd"], skip[:, None, None]),
            z(levels["luma"], skip[:, None, None]), z(levels["cdc"], skip[None, :, None]),
            z(levels["cac"], skip[None, :, None, None]))
    if t is None:
        return full
    mbs = slice(NMBL * t, NMBL * (t + 1))
    return tuple(x[:, mbs] if x.shape[0] == 2 else x[mbs] for x in full)


def bits(words, nbits) -> np.ndarray:
    nbits = int(nbits)
    return np.unpackbits(np.frombuffer(words_to_bytes(np.asarray(words), nbits),
                                       np.uint8))[:nbits]


def ue_bits(v: int) -> np.ndarray:
    code = v + 1
    n = code.bit_length()
    return np.array([0] * (n - 1) + [int(c) for c in bin(code)[2:]], np.uint8)


@pytest.mark.parametrize("force_skip", [(0, 0), (NMB - NMBL, NMB), (0, NMBL), (0, NMB),
                                        (NMB - 5, NMB)],
                         ids=["decided", "last-band-skipped", "first-band-skipped",
                              "all-skipped", "tail-skipped"])
def test_band_payloads_splice_to_the_frame_payload(p_frame, force_skip):
    """Band by band as TileIpppEncoder writes them (top_ctx, lead_extra, no
    trailing run), then ue(trail_total): the one-band payload, bit for bit;
    and the band form of the trailing-skip drop is the frame form's rows."""
    dec, levels = p_frame[1:]
    whole = p_slice_entropy(*band_inputs(dec, levels, None, force_skip), wmb=WMB, hmb=HMB)
    parts, halo, last = [], None, -1
    for t in range(N_TILE):
        inp = band_inputs(dec, levels, t, force_skip)
        ent = p_slice_entropy(*inp, wmb=WMB, hmb=HL, top_ctx=_ctx(halo),
                              run_lead=NMBL * t - last - 1)
        assert int(ent["trail_bits"]) == 0
        parts.append(bits(ent["words"], ent["nbits"]))
        coded = np.flatnonzero(~inp[0].numpy())
        last = NMBL * t + int(coded[-1]) if coded.size else last
        halo = _last_row_state(ent, WMB)
    trail = NMB - 1 - last
    parts.append(ue_bits(trail) if trail else np.zeros(0, np.uint8))
    spliced = np.concatenate(parts)
    np.testing.assert_array_equal(spliced, bits(whole["words"], whole["nbits"]))
    assert len(parts[-1]) == int(whole["trail_bits"])
    skip = band_inputs(dec, levels, None, force_skip)[0]
    dropped = 0
    for hdr_bits in range(40, 48):  # every alignment of the slice's end
        want = trailing_skip_drop(skip, whole["nbits"], whole["trail_bits"], hdr_bits)
        dropped += int(want.any())
        total = torch.tensor(len(spliced))
        for t in range(N_TILE):
            got = trailing_skip_drop(skip[NMBL * t: NMBL * (t + 1)], total,
                                     torch.tensor(len(parts[-1])), hdr_bits,
                                     last_coded=torch.tensor(last), base=NMBL * t)
            assert torch.equal(got, want[NMBL * t: NMBL * (t + 1)]), (hdr_bits, t)
    if force_skip == (NMB - 5, NMB):  # a short trailing run: dropped at some alignments
        assert 0 < dropped < 8


def test_band_nc_halo_state_matches_jax(p_frame):
    """Band 0's nC halo state, taken from its slice entropy's outputs,
    against the JAX _p_last_row_state (built from the levels)."""
    dec, levels = p_frame[1:]
    b0 = band_inputs(dec, levels, 0)
    halo = _last_row_state(p_slice_entropy(*b0, wmb=WMB, hmb=HL), WMB)
    ref_halo = _p_last_row_state(*(jnp.asarray(x.numpy()) for x in b0[3:]), WMB, HL)
    assert len(_ctx(halo)) == len(ref_halo) == 4
    for got, want in zip(_ctx(halo), ref_halo):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encoder_limits():
    with pytest.raises(ValueError, match="evenly"):  # QCIF's 9 MB rows in 2 bands
        TileIpppEncoder(W, H, QP, gop_len=4, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="evenly"):
        GopTileIpppEncoder(W, H, QP, 4, 2, 4, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        GopTileIpppEncoder(W, H, QP, 4, 2, 3, devices=["cpu"] * 5)
    with pytest.raises(ValueError):
        TileIpppEncoder(W, H, QP, gop_len=1, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="shorter"):  # one MB row, a search of +-16
        TileIpppEncoder(W, H, QP, gop_len=4, window_size=32, devices=["cpu"] * 9)
    TileIpppEncoder(W, H, QP, gop_len=4, window_size=16, devices=["cpu"] * 9)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TileIpppEncoder(W, H, QP, gop_len=4)
