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
GATE4 = (0, 1, 2, 0, 3, 3, 3, 0, 1)  # mode_decision.cu gate4: top, left, none, corner
KWARPS = 4  # mode_decision.cu: warps a block, two MBs a warp


def _kernel_table() -> np.ndarray:
    """kPred4, the Intra4x4 table compiled into csrc/mode_decision.cu."""
    text = (build.CSRC / "mode_decision.cu").read_text()
    body = text[text.index("kPred4[144] = {") + len("kPred4[144] = {"):]
    return np.array([int(v, 16) for v in body[:body.index("}")].split(",")], np.int64)


def _fwd_step(i, v0, v1, v2, v3):
    """intra_common.cuh fwd_step."""
    s, d, s2, d2 = v0 + v3, v0 - v3, v1 + v2, v1 - v2
    even = 256 * (s - s2 if i & 2 else s + s2)
    odd = 208 * (d - 2 * d2 if i & 2 else 2 * d + d2)
    return ((odd if i & 1 else even) + 512) >> 10


def _quant(qp, lq):
    """mode_decision.cu make_quant: (s, mul[3], add[3])."""
    if qp < 24:
        return 0, [v * (1 << (4 - qp // 6)) for v in lq], [16384 - (1 << (3 - qp // 6)) * v
                                                             for v in lq]
    return qp // 6 - 4, list(lq), [16384] * 3


def _block_satd(d, q):
    """mode_decision.cu block_satd on int32 arrays d[k] (k = 4 y + x), with
    int32 wrap-around as on the card."""
    s, mul, add = q
    a = [np.where(v == 0, 0, v * 64 - 32).astype(np.int32) for v in d]
    f = [None] * 16
    for x in range(4):
        for i in range(4):
            f[4 * i + x] = _fwd_step(i, a[x], a[4 + x], a[8 + x], a[12 + x])
    total = np.int32(0)
    for y in range(4):
        for j in range(4):
            k = 0 if not (y | j) & 1 else 1 if y & j & 1 else 2  # pat
            v = (((_fwd_step(j, *f[4 * y: 4 * y + 4]) >> s) * np.int32(mul[k]))
                 + np.int32(add[k])) >> 15
            total = total + np.abs(v).astype(np.int32)
    return total.astype(np.int32)


def _k11_model(y, qp, top_row=None, full=True):
    """A numpy model of K11 (csrc/mode_decision.cu), lane by lane over the
    grid's warps (a half-warp an MB in raster order, a half past the last MB
    scoring it again and writing nothing; a lane a raster 4x4 block): each
    lane's 16 source and 13 neighbour samples, the Intra16x16 sums by xor
    shuffles within the half-warp and the MB's top and left by shuffles, the
    modes' predictions (Intra4x4 from kPred4's three taps) and SATDs, the
    gates and first-min choices, and the writes into the kernel's one
    buffer, each int exactly once. Returns the twin's dict of the form."""
    h, w = y.shape
    wmb, hmb = w // 16, h // 16
    nmb = wmb * hmb
    q = _quant(qp, wavefront_i16.qtab(qp)[:3])
    pairs = -(-nmb // (2 * KWARPS)) * KWARPS
    pair = np.arange(pairs)[:, None]
    pair = pair[2 * pair[:, 0] < nmb]  # the warps past the last MB return
    lane = np.arange(32)[None, :]
    hh, base = lane & 15, lane & 16
    live = 2 * pair + (lane >> 4) < nmb
    mb = np.where(live, 2 * pair + (lane >> 4), nmb - 1)
    c = mb % wmb
    i, j = hh & 3, hh >> 2
    bx, by = 16 * c + 4 * i, 16 * (mb // wmb) + 4 * j
    plane = y.astype(np.int32)
    row = None if top_row is None else np.asarray(top_row, np.int32)

    def sample(x, yy):
        inside = (x >= 0) & (x < w)
        v = np.where(inside & (yy >= 0), plane[np.clip(yy, 0, h - 1), np.clip(x, 0, w - 1)], -1)
        if row is not None:
            v = np.where(inside & (yy < 0), row[np.clip(x, 0, w - 1)], v)
        return v

    def shfl(v, src):
        return np.take_along_axis(v, np.broadcast_to(src, v.shape), axis=1)

    def half_sum(v):
        for off in (8, 4, 2, 1):
            v = v + shfl(v, lane ^ off)
        return v

    src = [plane[by + (k >> 2), bx + (k & 3)] for k in range(16)]
    p = [sample(bx - 1, by - 1)] + [sample(bx - 1, by + k) for k in range(4)] + \
        [sample(bx + k, by - 1) for k in range(4)]
    top = [shfl(p[5 + k], base + i) for k in range(4)]
    left = [shfl(p[1 + k], base + 4 * j) for k in range(4)]
    corner, top0, left0 = (shfl(p[k], base) for k in (0, 5, 1))
    top15, left15 = shfl(p[8], base + 3), shfl(p[4], base + 12)
    st = half_sum(sum(np.where(j == 0, p[5 + k], 0) for k in range(4)))
    sl = half_sum(sum(np.where(i == 0, p[1 + k], 0) for k in range(4)))
    hg = half_sum(sum(np.where(j == 0, (4 * i + k - 7) * p[5 + k], 0) for k in range(4)))
    vg = half_sum(sum(np.where(i == 0, (4 * j + k - 7) * p[1 + k], 0) for k in range(4)))
    hg, vg = hg - 8 * corner, vg - 8 * corner
    dc16 = np.where(corner != -1, (st + sl + 16) >> 5, np.where(
        left0 != -1, (sl + 8) >> 4, np.where(top0 != -1, (st + 8) >> 4, 128)))
    pa, pb, pc = (left15 + top15) * 16, (5 * hg + 32) >> 6, (5 * vg + 32) >> 6
    sum16 = []
    for m in range(4):
        d = []
        for k in range(16):
            x, yy = k & 3, k >> 2
            pred = (top[x], left[yy], dc16, np.clip(
                (pa + pb * (4 * i + x - 7) + pc * (4 * j + yy - 7) + 16) >> 5, 0, 255))[m]
            d.append(src[k] - pred)
        sum16.append(half_sum(_block_satd(d, q)))
    gate16 = [np.where(top0 != -1, 0, 1 << 30), np.where(left0 != -1, 0, 1 << 30), 0,
              np.where(corner != -1, 0, 1 << 30)]
    best16, mode16 = sum16[0] + gate16[0], np.zeros_like(mb)
    for m in range(1, 4):
        better = sum16[m] + gate16[m] < best16
        best16, mode16 = np.where(better, sum16[m] + gate16[m], best16), np.where(better, m, mode16)
    out = np.zeros((19 if full else 2) * nmb, np.int64)
    writes = np.zeros_like(out)

    def write(at, v, where):
        np.add.at(writes, at[where], 1)
        out[at[where]] = v[where]

    first = live & (hh == 0)
    write(mb, mode16, first)
    write(nmb + mb, best16, first)
    if full:
        z = ((j >> 1) << 3) | ((i >> 1) << 2) | ((j & 1) << 1) | (i & 1)
        rep = (z == 3) | (z == 11) | ((i == 3) & ((j > 0) | (c + 1 == wmb)))
        p += [np.where(rep, p[8], sample(bx + 4 + k, by - 1)) for k in range(4)]
        top4, left4 = sum(p[5:9]), sum(p[1:5])
        dc = np.where(p[0] != -1, (top4 + left4 + 4) >> 3, np.where(
            p[1] != -1, (left4 + 2) >> 2, np.where(p[5] != -1, (top4 + 2) >> 2, 128)))
        table = _kernel_table()
        best4 = mode4 = None
        for m in range(9):
            d = []
            for k in range(16):
                t = int(table[16 * m + k])
                pred = dc if m == 2 else (((t >> 12) & 3) * p[t & 15] + ((t >> 14) & 3)
                                          * p[(t >> 4) & 15] + ((t >> 16) & 3) * p[(t >> 8) & 15]
                                          + ((t >> 18) & 3)) >> ((t >> 20) & 3)
                d.append(src[k] - pred)
            g = GATE4[m]
            ok = True if g == 2 else (p[5] if g == 0 else p[1] if g == 1 else p[0]) != -1
            cost = _block_satd(d, q) + np.where(ok, 0, 1 << 30)
            if m == 0:
                best4, mode4 = cost, np.zeros_like(mb)
            else:
                better = cost < best4
                best4, mode4 = np.where(better, cost, best4), np.where(better, m, mode4)
        write(3 * nmb + 16 * mb + z, mode4, live)
        write(2 * nmb + mb, half_sum(best4), first)
    assert (writes == 1).all()
    out = out.astype(np.int32)
    got = {"mode16": out[:nmb], "satd16": out[nmb: 2 * nmb]}
    if full:
        got.update(mode4=out[3 * nmb:].reshape(nmb, 16), satd4=out[2 * nmb: 3 * nmb])
    return got


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
    """The numpy model of the kernel's lanes equals the plain twins on every
    kind of input the chip phase holds K11 to, in both forms (the I16 form
    writes the full form's mode16 and satd16), on grids whose MB count is
    not a multiple of a block's 8 MBs and whose warps straddle MB-row ends
    (48 x 32, 80 x 176, 16 x 144, 176 x 16, 176 x 144); and the Intra4x4
    table compiled into the kernel is ops/intra's."""
    np.testing.assert_array_equal(_kernel_table(), PRED4)
    for label, y, top_row, qp in _frames():
        want = intra_mode_decision_plain(torch.from_numpy(y), qp, top_row)
        row = None if top_row is None else top_row.numpy()
        got = _k11_model(y, qp, row)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key].numpy(), err_msg=f"{label} {key}")
        m16, s16 = intra16_mode_decision_plain(torch.from_numpy(y), qp, top_row)
        assert torch.equal(m16, want["mode16"]) and torch.equal(s16, want["satd16"]), label
        got16 = _k11_model(y, qp, row, full=False)
        np.testing.assert_array_equal(got16["mode16"], m16.numpy(), err_msg=label)
        np.testing.assert_array_equal(got16["satd16"], s16.numpy(), err_msg=label)


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
    int32, the form's flag, and outputs that are views of the one buffer it
    writes, in the C comment's order."""
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
        assert named["full"] == int(full)
        if full:
            assert list(out) == ["mode16", "satd16", "mode4", "satd4"]
            assert out["mode4"].shape == (6, 16)
