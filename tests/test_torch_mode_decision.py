"""The port's Intra16x16 mode decision equals
intra_mode_decision(..., i16_only=True) of the JAX package; K11, the
decision's CUDA kernel, is modelled in numpy against the plain twins, and
its dispatchers and wrapper are held to their routes and refusals."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h264_fer_tpu.codec.tpu_intra import intra_mode_decision
from h264_fer_tpu_torch.codec.intra_decision import (intra16_mode_decision,
                                                     intra16_mode_decision_plain,
                                                     intra_mode_decision as port_decision,
                                                     intra_mode_decision_plain)
from h264_fer_tpu_torch.kernels import build, mode_decision, wavefront_i16
from h264_fer_tpu_torch.ops import intra

torch.set_num_threads(1)


def _check(y, qp):
    h, w = y.shape
    ref = intra_mode_decision(jnp.asarray(y), wmb=w // 16, hmb=h // 16,
                              qp=qp, i16_only=True)
    mode, satd = intra16_mode_decision(torch.from_numpy(y), qp)
    np.testing.assert_array_equal(mode.numpy(), np.asarray(ref["mode16"]))
    np.testing.assert_array_equal(satd.numpy(), np.asarray(ref["satd16"]))
    return mode.numpy()


@pytest.mark.parametrize("wh", [(176, 144), (80, 176)])
@pytest.mark.parametrize("qp", [4, 28, 45])
def test_mode16_matches_jax(wh, qp):
    w, h = wh
    rng = np.random.default_rng(qp)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 3 + yy * 2) % 256 + rng.integers(0, 40, (h, w))).astype(np.int32)
    y = np.clip(y, 0, 255)
    modes = _check(y, qp)
    assert len(set(modes.tolist())) > 1  # the content exercises several modes


def test_equal_satd_takes_first_mode():
    """A flat frame gives every available mode the same SATD: the decision
    must take the first available one, as jnp.argmin does."""
    y = np.full((48, 64), 77, np.int32)
    modes = _check(y, 28).reshape(3, 4)
    assert modes[0, 0] == 2  # no neighbour: only DC is ungated
    assert (modes[0, 1:] == 1).all()  # top row: H is the first available
    assert (modes[1:] == 0).all()  # V is first wherever the top exists


# --- K11 (kernels/mode_decision.py, csrc/mode_decision.cu) -------------------

PRED4 = intra.packed_mode_table()
GATE4 = (0, 1, 2, 0, 3, 3, 3, 0, 1)  # mode_decision.cu kGate4: top, left, none, corner
UNREAD = 10 ** 6  # ext cells the kernel leaves unwritten


def _fwd_step(i, v0, v1, v2, v3):
    """intra_common.cuh fwd_step."""
    s, d, s2, d2 = v0 + v3, v0 - v3, v1 + v2, v1 - v2
    even = 256 * (s - s2 if i & 2 else s + s2)
    odd = 208 * (d - 2 * d2 if i & 2 else 2 * d + d2)
    return ((odd if i & 1 else even) + 512) >> 10


def _block_satd(d, qp, lq):
    """mode_decision.cu block_satd on int32 arrays d[k] (k = 4 y + x), with
    int32 wrap-around as on the card."""
    a = [np.where(v == 0, 0, v * 64 - 32).astype(np.int32) for v in d]
    f = [None] * 16
    for x in range(4):
        for i in range(4):
            f[4 * i + x] = _fwd_step(i, a[x], a[4 + x], a[8 + x], a[12 + x])
    total = 0
    for y in range(4):
        for j in range(4):
            coef = _fwd_step(j, *f[4 * y: 4 * y + 4])
            lqv = np.int32(lq[0 if not (y | j) & 1 else 1 if y & j & 1 else 2])  # pat
            if qp < 24:
                q = ((coef * np.int32(1 << (4 - qp // 6)) - np.int32(1 << (3 - qp // 6)))
                     * lqv + 16384) >> 15
            else:
                q = ((coef >> (qp // 6 - 4)) * lqv + 16384) >> 15
            total = total + np.abs(q)
    return total.astype(np.int32)


def _taps(code, rep):
    """intra4x4.cuh pack_taps."""
    taps = ((code >> 12) & 0x3FF) << 21
    for k in range(3):
        idx = (code >> (4 * k)) & 15
        row = idx if 1 <= idx <= 4 else 0
        col = 0 if idx < 5 else (4 if rep and idx >= 9 else idx - 4)
        taps |= (row * 21 + col) << (7 * k)
    return taps


def _k11_model(y, qp, top_row=None):
    """A numpy model of K11 (csrc/mode_decision.cu), its threads vectorised
    over the MBs: the staged ext cells (rows 1-16, columns 17-20 left
    unwritten), each (mode, block) thread's prediction from them (the
    Intra16x16 predictor's parameters; Intra4x4's packed taps with the
    replica rule) and SATD, the gates and the first-min scans. Returns the
    full form's dict."""
    h, w = y.shape
    wmb, hmb = w // 16, h // 16
    nmb = wmb * hmb
    lq = wavefront_i16.qtab(qp)[:3]
    y = y.astype(np.int32)
    above = np.full((hmb, w + 4), -1, np.int32)
    above[1:, :w] = y[15:h - 1:16]
    if top_row is not None:
        above[0, :w] = top_row
    ext = np.full((hmb, wmb, 17, 21), UNREAD, np.int32)
    ext[:, :, 0, 1:] = np.stack([above[:, 16 * c: 16 * c + 20] for c in range(wmb)], 1)
    ext[:, :, 0, 0] = -1
    ext[:, 1:, 0, 0] = above[:, 15:w - 1:16]
    tiles = y.reshape(hmb, 16, wmb, 16).transpose(0, 2, 1, 3)
    ext[:, :, 1:, 1:17] = tiles
    ext[:, :, 1:, 0] = -1
    ext[:, 1:, 1:, 0] = tiles[:, :-1, :, 15]
    ext = ext.reshape(nmb, 17, 21)
    last_col = (np.arange(nmb) % wmb) == wmb - 1
    flat = ext.reshape(nmb, -1)
    top, left, corner = ext[:, 0, 1:17], ext[:, 1:, 0], ext[:, 0, 0]
    # Intra16x16: i16_params, then 4 x 16 (mode, block) threads
    st, sl = top.sum(1), left.sum(1)
    hg = sum((i + 1) * (top[:, 8 + i] - (corner if i == 7 else top[:, 6 - i])) for i in range(8))
    vg = sum((i + 1) * (left[:, 8 + i] - (corner if i == 7 else left[:, 6 - i])) for i in range(8))
    dcv = np.where(corner != -1, (st + sl + 16) >> 5, np.where(
        left[:, 0] != -1, (sl + 8) >> 4, np.where(top[:, 0] != -1, (st + 8) >> 4, 128)))
    pa, pb, pc = (left[:, 15] + top[:, 15]) * 16, (5 * hg + 32) >> 6, (5 * vg + 32) >> 6
    zxy = [(4 * (((z >> 2) & 1) * 2 + (z & 1)), 4 * (((z >> 3) & 1) * 2 + ((z >> 1) & 1)))
           for z in range(16)]
    d16 = []  # per (mode, block) thread: the residual, (16 samples, nmb)
    for m in range(4):
        for bx, by in zxy:
            X, Y = bx + np.arange(16) % 4, by + np.arange(16) // 4
            pred = (top[:, X], left[:, Y], dcv[:, None], np.clip(
                (pa[:, None] + pb[:, None] * (X - 7) + pc[:, None] * (Y - 7) + 16) >> 5,
                0, 255))[m]
            d16.append((ext[:, 1 + Y, 1 + X] - pred).T)
    satd16 = _block_satd(np.stack(d16, 1), qp, lq).reshape(4, 16, nmb)
    sum16 = satd16.sum(1, dtype=np.int32)
    gate16 = np.stack([np.where(top[:, 0] != -1, 0, 1 << 30), np.where(left[:, 0] != -1, 0, 1 << 30),
                       np.zeros(nmb, np.int64), np.where(corner != -1, 0, 1 << 30)])
    cost16 = sum16 + gate16
    mode16 = np.zeros(nmb, np.int32)
    best16 = cost16[0].copy()
    for m in range(1, 4):
        better = cost16[m] < best16
        best16, mode16 = np.where(better, cost16[m], best16), np.where(better, m, mode16)
    # Intra4x4: 9 x 16 (mode, block) threads
    mode4, best4 = np.zeros((nmb, 16), np.int32), np.zeros((nmb, 16), np.int64)
    for z, (bx, by) in enumerate(zxy):
        base = by * 21 + bx  # the block's corner cell e[0]

        def e(off):
            return flat[:, base + off]

        top4, left4 = e(1) + e(2) + e(3) + e(4), e(21) + e(42) + e(63) + e(84)
        dc = np.where(e(0) != -1, (top4 + left4 + 4) >> 3, np.where(
            e(21) != -1, (left4 + 2) >> 2, np.where(e(1) != -1, (top4 + 2) >> 2, 128)))
        rep = (z in (3, 11)) | ((bx == 12) & ((by > 0) | last_col))
        src = e(np.array([(1 + (k >> 2)) * 21 + 1 + (k & 3) for k in range(16)]))
        d4, gates = [], []
        for m in range(9):
            preds = []
            for r in (False, True):
                tp = np.array([_taps(int(PRED4[16 * m + k]), r) for k in range(16)])
                tab3 = (((tp >> 27) & 3) + ((tp >> 21) & 3) * e(tp & 127)
                        + ((tp >> 23) & 3) * e((tp >> 7) & 127)
                        + ((tp >> 25) & 3) * e((tp >> 14) & 127))
                preds.append(tab3 >> ((tp >> 29) & 3))
            pred = dc[:, None] if m == 2 else np.where(rep[:, None], preds[1], preds[0])
            d4.append((src - pred).T)
            g = GATE4[m]
            ok = True if g == 2 else (e(1) if g == 0 else e(21) if g == 1 else e(0)) != -1
            gates.append(np.broadcast_to(np.where(ok, 0, 1 << 30), (nmb,)))
        costs = _block_satd(np.stack(d4, 1), qp, lq) + np.stack(gates)
        best = costs[0].astype(np.int64)
        for m in range(1, 9):
            better = costs[m] < best
            best, mode4[:, z] = np.where(better, costs[m], best), np.where(better, m, mode4[:, z])
        best4[:, z] = best
    return {"mode16": mode16, "satd16": best16.astype(np.int32), "mode4": mode4,
            "satd4": best4.sum(1).astype(np.int32)}


def _frames():
    """(label, y (H, W) uint8, top_row or None, qp): the K11 phase's kinds of
    input at small sizes: content, random, flat (every mode ties), stripes,
    band rows with a real top_row and with one holding -1 entries, and the
    grids 16x16, 80x176, 16x144 and 176x16."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:48, 0:64]
    content = ((xx * 3 + yy * 2) % 256 + rng.integers(0, 40, (48, 64))).clip(0, 255)
    band = rng.integers(0, 256, (64, 48))
    holes = band[15].astype(np.int32)
    holes[rng.random(48) < 0.4] = -1
    holes[:16] = -1
    out = [("content", content, None, 4), ("random", rng.integers(0, 256, (32, 48)), None, 28),
           ("stripes", (xx // 2 % 2 * 255)[:32], None, 46),
           ("band, real top_row", band[16:], band[15], 28),
           ("band, top_row with -1", band[16:], holes, 8)]
    out += [(f"flat {v}", np.full((32, 48), v), None, 28) for v in (0, 128, 255)]
    out += [(f"{w}x{h}", rng.integers(0, 256, (h, w)), None, qp)
            for (w, h), qp in (((16, 16), 51), ((80, 176), 0), ((16, 144), 12), ((176, 16), 34))]
    return [(label, y.astype(np.uint8), None if t is None else torch.from_numpy(
        np.asarray(t, np.int32)), qp) for label, y, t, qp in out]


def test_k11_model_equals_the_twin():
    """The numpy model of the kernel's threads equals the plain twins on
    every kind of input the chip phase holds K11 to (both forms: the I16
    form writes the full form's mode16 and satd16)."""
    for label, y, top_row, qp in _frames():
        want = intra_mode_decision_plain(torch.from_numpy(y), qp, top_row)
        got = _k11_model(y, qp, None if top_row is None else top_row.numpy())
        for key in want:
            np.testing.assert_array_equal(got[key], want[key].numpy(), err_msg=f"{label} {key}")
        m16, s16 = intra16_mode_decision_plain(torch.from_numpy(y), qp, top_row)
        assert torch.equal(m16, want["mode16"]) and torch.equal(s16, want["satd16"]), label


def test_cpu_tensors_route_to_the_plain_twins(monkeypatch):
    """A CPU plane takes the plain twin of each form, launching nothing,
    uint8 and int32 alike; a meta plane raises."""
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("K11 launched"))
    launches = (mode_decision.i16_decision.launches, mode_decision.full_decision.launches)
    for label, y, top_row, qp in _frames()[:5]:
        y8 = torch.from_numpy(y)
        want = intra_mode_decision_plain(y8.to(torch.int32), qp, top_row)
        for plane in (y8, y8.to(torch.int32)):
            got = port_decision(plane, qp, top_row)
            assert list(got) == list(want)
            assert all(torch.equal(got[k], want[k]) for k in want), label
            m16, s16 = intra16_mode_decision(plane, qp, top_row)
            assert torch.equal(m16, want["mode16"]) and torch.equal(s16, want["satd16"]), label
    assert (mode_decision.i16_decision.launches,
            mode_decision.full_decision.launches) == launches
    for fn in (intra16_mode_decision, port_decision):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.zeros((16, 16), dtype=torch.uint8, device="meta"), 28)


def test_k11_wrapper_refuses_bad_arguments_before_any_build(monkeypatch):
    """A wrong shape, dtype, layout, qp or top_row raises ValueError before
    any build or launch, and so does a CPU plane."""
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("K11 built"))
    y = torch.zeros((32, 48), dtype=torch.uint8)
    row = torch.zeros(48, dtype=torch.int32)
    bad = [(torch.zeros((2, 32, 48), dtype=torch.uint8), 28, None),
           (torch.zeros((24, 48), dtype=torch.uint8), 28, None),
           (torch.zeros((32, 40), dtype=torch.uint8), 28, None),
           (torch.zeros((0, 48), dtype=torch.uint8), 28, None),
           (y.to(torch.int64), 28, None), (y.to(torch.float32), 28, None),
           (torch.zeros((48, 32), dtype=torch.uint8).t(), 28, None),
           (y, -1, None), (y, 52, None),
           (y, 28, row[:32]), (y, 28, row.to(torch.uint8)), (y, 28, row.to("meta")),
           (y, 28, torch.zeros((1, 48), dtype=torch.int32)), (y, 28, row)]
    for fn in (mode_decision.i16_decision, mode_decision.full_decision):
        for args in bad:
            with pytest.raises(ValueError):
                fn(*args)


def test_k11_wrapper_launch_arguments(monkeypatch):
    """With the device test and the launch stubbed, so that CPU tensors get
    as far as the launch: one call of the C entry point with one argument
    for each of its parameters before the stream, the plane as uint8 or
    int32, the prediction table in the full form only, and outputs that are
    views of the one buffer it writes, in the C comment's order."""
    calls = []
    monkeypatch.setattr(mode_decision, "_cuda", lambda y: None)
    monkeypatch.setattr(build, "launch", lambda *a: calls.append(a))
    source = (build.CSRC / "mode_decision.cu").read_text()
    sig = source[source.index('extern "C" int mode_decision('):]
    params = [p.split()[-1].lstrip("*") for p in sig[sig.index("(") + 1: sig.index(")")]
              .split(",")]
    assert params[-2:] == ["stream", "launched"]
    for full, dtype in ((False, torch.uint8), (False, torch.int32), (True, torch.uint8),
                        (True, torch.int32)):
        wrapper = mode_decision.full_decision if full else mode_decision.i16_decision
        y = torch.zeros((32, 48), dtype=dtype)
        row = torch.zeros(48, dtype=torch.int32)
        out = wrapper(y, 30, row)
        (fn, name, symbol, args, dev) = calls.pop()
        assert (fn, name, symbol, dev) == (wrapper, "mode_decision", "mode_decision", y.device)
        assert len(args) == len(params) - 2
        named = dict(zip(params, args))
        assert named["y"] is y and named["is_u8"] == (dtype == torch.uint8)
        assert named["top_row"] is row
        assert (named["wmb"], named["hmb"], named["qp"]) == (3, 2, 30)
        np.testing.assert_array_equal(named["qtab"][:3], wavefront_i16.qtab(30)[:3])
        buf = named["out"]
        parts = ((out["mode16"], out["satd16"], out["satd4"], out["mode4"]) if full
                 else out)
        assert buf.numel() == (19 if full else 2) * 6
        assert [t.data_ptr() for t in parts] == [buf.data_ptr() + 4 * 6 * k
                                                 for k in range(len(parts))]
        if full:
            np.testing.assert_array_equal(named["pred4"].numpy(), PRED4)
            assert list(out) == ["mode16", "satd16", "mode4", "satd4"]
            assert out["mode4"].shape == (6, 16)
        else:
            assert named["pred4"] is None
