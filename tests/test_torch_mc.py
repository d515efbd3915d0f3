"""K5's thread mapping (csrc/mc.cu) modelled in numpy on the CPU.

The kernel runs one thread per quadrant row: a luma thread makes the 8
samples of one row of an 8x8 quadrant from one phase plane, a chroma
thread the 4 of one row of a 4x4 quadrant of Cb or Cr from 5 samples in
each of two rows. It reads the samples as aligned 32-bit words, each word
index taken from the absolute byte offset in its buffer (the rows are not
word-aligned: a luma row is W + 2 ext bytes, a chroma row W/2 + 2 ext_c +
2), funnel-shifted into place, with the third luma word's index clamped
to the buffer's last word. Here, on QCIF, 64x208, 16x144 and 176x16 at
windows 8 and 7 (so that rows at every 2-byte alignment occur) with
random MVs over the caller's whole range, negatives and every quarter- and
eighth-pel phase included: the model equals mc_bulk_plain, every output
sample is written once, and no row takes the byte path; with MVs beyond
the range it equals the per-sample clamping the kernel keeps and reads
nothing outside its buffers. The word loads give a buffer's bytes at every
alignment, up to its last whole word, for every buffer length mod 4. On
the kernel's route the wrapper refuses misaligned bases; it sends CPU
tensors to the plain twin without a launch. No JAX: the plain twin is held to the JAX reference by
tests/test_torch_pframe.py, the kernel to the plain twin on the card by
chip_smoke.py.

The helpers copy the kernel's index arithmetic and name the lines of
csrc/mc.cu they copy: an edit to one of those lines must be made to its
copy here too. These tests model the design; only chip_smoke.py's K5
checks guard the compiled kernel.
"""

import numpy as np
import pytest
import torch

from h264_fer_tpu_torch.kernels import mc

torch.set_num_threads(1)

STRIP, ROWS = 32, 8  # csrc/mc.cu kStrip, kRows: the block is (32, 8)


def _words(buf):
    """The whole little-endian uint32 words of a uint8 buffer: len // 4 of
    them (a partial last word is not a word the kernel may load)."""
    n = buf.size // 4 * 4
    return (buf[:n].reshape(-1, 4).astype(np.uint64)
            << (8 * np.arange(4, dtype=np.uint64))).sum(-1)


def _byte(w, i):
    return ((w >> np.uint64(8 * i)) & 0xFF).astype(np.int64)


def funnelshift_r(lo, hi, sh):
    """__funnelshift_r of uint64 arrays holding 32-bit words (shift mod 32)."""
    return ((hi << np.uint64(32) | lo) >> (sh & 31).astype(np.uint64)) & 0xFFFFFFFF


def _word(words, k):
    assert (k >= 0).all() and (k < words.size).all(), "a word load outside the buffer"
    return words[k]


def load8(words, b):
    """csrc/mc.cu:63 load8: bytes [b, b + 8) as (x, y) from the words b / 4,
    b / 4 + 1 and, clamped to the last word, b / 4 + 2."""
    k, sh = b >> 2, 8 * (b & 3)
    w0, w1 = _word(words, k), _word(words, k + 1)
    w2 = _word(words, np.minimum(k + 2, words.size - 1))
    return funnelshift_r(w0, w1, sh), funnelshift_r(w1, w2, sh)


def load5(words, b):
    """csrc/mc.cu:73 load5: bytes [b, b + 4) in x and byte b + 4 in y."""
    k, sh = b >> 2, 8 * (b & 3)
    w0, w1 = _word(words, k), _word(words, k + 1)
    return funnelshift_r(w0, w1, sh), (w1 >> sh.astype(np.uint64)) & 0xFF


def _threads(wmb, hmb):
    """Every live thread of the launch (csrc/mc.cu:176 grid and block,
    :87-90): quadrant column qc, MB row, part (0, 1 luma
    rows 0-7 / 8-15, 2 Cb, 3 Cr) and threadIdx.y, as flat arrays."""
    gx = (2 * wmb + STRIP - 1) // STRIP
    bx, by, ty, tx = np.meshgrid(np.arange(gx), np.arange(4 * hmb), np.arange(ROWS),
                                 np.arange(STRIP), indexing="ij")
    qc = (bx * STRIP + tx).ravel()
    live = qc < 2 * wmb
    by, ty = by.ravel()[live], ty.ravel()[live]
    return qc[live], by >> 2, by & 3, ty


def mc_model(planes, cb_pad, cr_pad, mv, ext, ext_c, wmb, hmb):
    """csrc/mc.cu mc_kernel, every thread at once on numpy arrays. Returns
    (pred_y, pred_cb, pred_cr) int64, the number of writes of each output
    sample, and the number of rows that took the byte path."""
    W, H = 16 * wmb, 16 * hmb
    preds = [np.zeros((H, W), np.int64), np.zeros((H // 2, W // 2), np.int64),
             np.zeros((H // 2, W // 2), np.int64)]
    writes = [np.zeros(p.shape, np.int64) for p in preds]
    qc, mbr, part, ty = _threads(wmb, hmb)
    mb = mbr * wmb + (qc >> 1)
    slow = 0

    # ---- luma (csrc/mc.cu:92-115) ----------------------------------------
    lu = part < 2
    q = 2 * part[lu] + (qc[lu] & 1)
    vx, vy = mv[mb[lu], q, 0].astype(np.int64), mv[mb[lu], q, 1].astype(np.int64)
    he, we = H + 2 * ext, W + 2 * ext
    y = 16 * mbr[lu] + 8 * part[lu] + ty[lu]
    x0 = 8 * qc[lu]
    py = np.clip(y + (vy >> 2) + ext, 0, he - 1)
    px = x0 + (vx >> 2) + ext
    row = (((vy & 3) * 4 + (vx & 3)) * he + py) * we
    flat = planes.reshape(-1)
    words = _words(flat)
    fast = (px >= 0) & (px + 8 <= we) & (row + px + 8 <= 4 * words.size)
    s = np.empty((y.size, 8), np.int64)
    lo, hi = load8(words, (row + px)[fast])
    s[fast] = np.stack([_byte(lo, i) for i in range(4)] + [_byte(hi, i) for i in range(4)], -1)
    cols = np.clip(px[~fast, None] + np.arange(8), 0, we - 1)
    s[~fast] = flat[row[~fast, None] + cols]
    slow += int((~fast).sum())
    xs = x0[:, None] + np.arange(8)
    preds[0][y[:, None], xs] = s
    np.add.at(writes[0], (y[:, None], xs), 1)

    # ---- chroma (csrc/mc.cu:117-161) -------------------------------------
    for k, pad in ((2, cb_pad), (3, cr_pad)):
        ch = part == k
        q = 2 * (ty[ch] >> 2) + (qc[ch] & 1)
        vx, vy = mv[mb[ch], q, 0].astype(np.int64), mv[mb[ch], q, 1].astype(np.int64)
        hp, wp = H // 2 + 2 * ext_c + 2, W // 2 + 2 * ext_c + 2
        y = 8 * mbr[ch] + ty[ch]
        x0 = 4 * qc[ch]
        cy = np.clip(y + (vy >> 3) + ext_c + 1, 0, hp - 2)
        cx = x0 + (vx >> 3) + ext_c + 1
        fx, fy = vx & 7, vy & 7
        b = cy * wp + cx
        flat = pad.reshape(-1)
        words = _words(flat)
        fast = (cx >= 0) & (cx + 5 <= wp) & (b + wp + 5 <= 4 * words.size)
        t0, t1, a0, a1 = (np.empty((y.size, 4), np.int64) for _ in range(4))
        r0, r1 = load5(words, b[fast]), load5(words, b[fast] + wp)
        row0 = np.stack([_byte(r0[0], i) for i in range(4)] + [_byte(r0[1], 0)], -1)
        row1 = np.stack([_byte(r1[0], i) for i in range(4)] + [_byte(r1[1], 0)], -1)
        t0[fast], a0[fast], t1[fast], a1[fast] = row0[:, :4], row0[:, 1:], row1[:, :4], row1[:, 1:]
        o = cy[~fast, None] * wp + np.clip(cx[~fast, None] + np.arange(4), 0, wp - 2)
        t0[~fast], a0[~fast], t1[~fast], a1[~fast] = flat[o], flat[o + 1], flat[o + wp], flat[o + wp + 1]
        slow += int((~fast).sum())
        fx, fy = fx[:, None], fy[:, None]
        out = ((8 - fx) * (8 - fy) * t0 + fx * (8 - fy) * a0 + (8 - fx) * fy * t1
               + fx * fy * a1 + 32) >> 6
        xs = x0[:, None] + np.arange(4)
        preds[k - 1][y[:, None], xs] = out
        np.add.at(writes[k - 1], (y[:, None], xs), 1)
    return preds, writes, slow


def clamped_reference(planes, cb_pad, cr_pad, mv, ext, ext_c, wmb, hmb):
    """The per-sample read clamping the kernel keeps for MVs outside the
    caller's range: each luma sample's position clamped into its phase
    plane, each chroma tap origin into [0, wp - 2] x [0, hp - 2]."""
    W, H = 16 * wmb, 16 * hmb
    _, he, we = planes.shape
    hp, wp = cb_pad.shape
    y, x = np.mgrid[:H, :W]
    mb, q = (y >> 4) * wmb + (x >> 4), ((y >> 3) & 1) * 2 + ((x >> 3) & 1)
    vx, vy = mv[mb, q, 0].astype(np.int64), mv[mb, q, 1].astype(np.int64)
    luma = planes[(vy & 3) * 4 + (vx & 3), np.clip(y + (vy >> 2) + ext, 0, he - 1),
                  np.clip(x + (vx >> 2) + ext, 0, we - 1)].astype(np.int64)
    y, x = np.mgrid[:H // 2, :W // 2]
    mb, q = (y >> 3) * wmb + (x >> 3), ((y >> 2) & 1) * 2 + ((x >> 2) & 1)
    vx, vy = mv[mb, q, 0].astype(np.int64), mv[mb, q, 1].astype(np.int64)
    cx = np.clip(x + (vx >> 3) + ext_c + 1, 0, wp - 2)
    cy = np.clip(y + (vy >> 3) + ext_c + 1, 0, hp - 2)
    fx, fy = vx & 7, vy & 7
    out = [luma]
    for pad in (cb_pad, cr_pad):
        p = pad.astype(np.int64)
        out.append(((8 - fx) * (8 - fy) * p[cy, cx] + fx * (8 - fy) * p[cy, cx + 1]
                    + (8 - fx) * fy * p[cy + 1, cx] + fx * fy * p[cy + 1, cx + 1] + 32) >> 6)
    return out


def _inputs(w, h, window, seed, over=0):
    """Random phase planes and padded chroma of a w x h frame at `window`
    (ext = window + 2, ext_c = ext // 2 + 1, as codec/pframe.py), and random
    quadrant MVs over +-(lim + over), lim = 4 ext - 4, the first MB's four
    quadrants at the corners of that range."""
    rng = np.random.default_rng(seed)
    wmb, hmb = w // 16, h // 16
    ext = window + 2
    ext_c = ext // 2 + 1
    lim = 4 * ext - 4 + over
    planes = rng.integers(0, 256, (16, h + 2 * ext, w + 2 * ext)).astype(np.uint8)
    cshape = (h // 2 + 2 * ext_c + 2, w // 2 + 2 * ext_c + 2)
    cb, cr = (rng.integers(0, 256, cshape).astype(np.uint8) for _ in range(2))
    mv = rng.integers(-lim, lim + 1, (wmb * hmb, 4, 2)).astype(np.int32)
    mv[0] = ((-lim, -lim), (lim, lim), (-lim, lim), (lim, -lim))
    return planes, cb, cr, mv, ext, ext_c, wmb, hmb


GEOMS = [(176, 144), (64, 208), (16, 144), (176, 16)]


@pytest.mark.parametrize("window", [8, 7])
@pytest.mark.parametrize("wh", GEOMS, ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_k5_model_equals_plain_twin(wh, window):
    w, h = wh
    planes, cb, cr, mv, *geo = _inputs(w, h, window, w + h + window)
    ext, ext_c = geo[0], geo[1]
    assert {(w + 2 * ext) % 4, (w // 2 + 2 * ext_c + 2) % 4} == {0, 2}  # both alignments
    got, writes, slow = mc_model(planes, cb, cr, mv, *geo)
    want = mc.mc_bulk_plain(*(torch.from_numpy(a) for a in (planes, cb, cr, mv)), *geo)
    for g, r, n in zip(got, want, writes):
        np.testing.assert_array_equal(g, r.numpy())
        assert (n == 1).all()  # every output sample written once
    assert slow == 0  # within the caller's range no row needs the clamp


def test_k5_model_sees_every_phase():
    """The QCIF cases above reach all 16 quarter-pel and 64 eighth-pel
    phases, negative MVs and both signs of every shift."""
    for window in (8, 7):
        mv = _inputs(176, 144, window, 176 + 144 + window)[3].reshape(-1, 2).astype(np.int64)
        assert len({(x & 3, y & 3) for x, y in mv}) == 16
        assert len({(x & 7, y & 7) for x, y in mv}) == 64
        assert (mv < 0).any() and ((mv >> 2) < 0).any() and ((mv >> 3) < 0).any()


@pytest.mark.parametrize("wh", [(176, 144), (16, 144)], ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_k5_model_clamps_outside_the_range(wh):
    """MVs up to 40 quarter-pels beyond the caller's range: the rows that
    leave the planes take the byte path with per-sample clamping, which
    gives the kernel's clamped samples, and no load leaves a buffer (the
    model's loads assert it)."""
    w, h = wh
    inputs = _inputs(w, h, 8, w + h, over=40)
    got, writes, slow = mc_model(*inputs)
    assert slow > 0
    for g, r, n in zip(got, clamped_reference(*inputs), writes):
        np.testing.assert_array_equal(g, r)
        assert (n == 1).all()


@pytest.mark.parametrize("tail", [0, 1, 2, 3])
def test_word_loads_at_every_alignment(tail):
    """load8 and load5 on a buffer of 4m + tail bytes give its bytes at
    every start b whose read ends within the last whole word (the only
    reads the kernel sends to them), at all four byte alignments; load8's
    clamped third word is needed only where b is word-aligned, so the clamp
    never drops a wanted byte. A read that reaches into a partial last word
    fails the kernel's word condition (b + 8 <= 4 whole words) and takes
    the byte path: the clamped words could not give its bytes."""
    rng = np.random.default_rng(tail)
    buf = rng.integers(0, 256, 64 + tail).astype(np.uint8)
    words = _words(buf)
    end = 4 * words.size
    b = np.arange(0, end - 7)
    lo, hi = load8(words, b)
    got = np.stack([_byte(lo, i) for i in range(4)] + [_byte(hi, i) for i in range(4)], -1)
    np.testing.assert_array_equal(got, buf[b[:, None] + np.arange(8)])
    assert set(b[(b >> 2) + 2 > words.size - 1] & 3) == {0}
    assert {int(x) & 3 for x in b} == {0, 1, 2, 3}
    b = np.arange(0, end - 4)
    lo, hi = load5(words, b)
    got = np.stack([_byte(lo, i) for i in range(4)] + [hi.astype(np.int64)], -1)
    np.testing.assert_array_equal(got, buf[b[:, None] + np.arange(5)])
    b = np.arange(end - 7, end + tail - 7)  # the 8-byte reads ending in the partial word
    assert (b + 8 > end).all()
    if tail:
        lo, hi = load8(words, b)
        got = np.stack([_byte(lo, i) for i in range(4)] + [_byte(hi, i) for i in range(4)], -1)
        assert (got != buf[b[:, None] + np.arange(8)]).any()


class _OnCard:
    """A CPU tensor's base, seen by mc_bulk as a CUDA tensor's (its shape
    checks stubbed out), to reach the kernel's route without a card."""

    def __init__(self, t):
        self.t, self.device = t, torch.device("cuda")

    def data_ptr(self):
        return self.t.data_ptr()


def test_mc_bulk_refuses_misaligned_bases_and_routes_cpu_to_plain(monkeypatch):
    """The kernel's route refuses each misaligned base before any build or
    launch; CPU tensors, aligned or not, go to the plain twin (which reads
    no words) without a launch."""
    planes, cb, cr, mv, *geo = _inputs(32, 32, 8, 3)
    args = [torch.from_numpy(a) for a in (planes, cb, cr, mv)]
    before = mc.mc_bulk.launches
    want = mc.mc_bulk_plain(*args, *geo)
    got = mc.mc_bulk(*args, *geo)
    assert all(torch.equal(g, r) for g, r in zip(got, want))
    monkeypatch.setattr(mc.build, "check_tensor", lambda *a: None)
    monkeypatch.setattr(mc.build, "function", None)  # any build would fail
    for i, shift in ((0, 1), (1, 2), (2, 3), (3, 1)):  # planes, cb_pad, cr_pad, mv
        t = args[i]
        buf = torch.zeros(t.numel() + shift, dtype=t.dtype)
        moved = buf[shift:].view(t.shape)
        moved.copy_(t)
        assert moved.data_ptr() % (8 if i == 3 else 4)
        bad = list(args)
        bad[i] = moved
        got = mc.mc_bulk(*bad, *geo)  # on the CPU: the plain twin
        assert all(torch.equal(g, r) for g, r in zip(got, want))
        with pytest.raises(ValueError, match="aligned"):
            mc.mc_bulk(*map(_OnCard, bad), *geo)
        with pytest.raises(ValueError, match="aligned"):
            mc.check_aligned(*bad)
    mc.check_aligned(*args)
    assert mc.mc_bulk.launches == before
