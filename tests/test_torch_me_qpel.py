"""K3's staged design (csrc/me_qpel.cu) modelled in numpy on the CPU.

The kernel scores the 49 quarter-pel offsets around a block's centre from
16 phase tiles of 9x9 samples that it stages in shared memory, and does the
arithmetic in packed bytes. Here, at QCIF and on edge grids: every window
lies inside its phase's tile; scoring from the tiles equals
qpel_refine_map_plain for the centres the P path gives K3 (integer argmins,
previous MVs clamped to the search limit, and any quarter-pel centre in
range) in all three metrics; with centres far outside the planes, where
the kernel clamps each window's origin, the tiles still hold every clamped
window; the tile rows the kernel builds from three aligned words with
funnel shifts are the plane's bytes at any alignment; and the packed-byte
arithmetic (__vabsdiffu4, __dp4a) equals the scalar SAD and SSD. No JAX:
the plain twin is held to the JAX reference by tests/test_torch_pframe.py,
the kernel to the plain twin on the card by chip_smoke.py.

The helpers copy the kernel's index arithmetic and name the lines of
csrc/me_qpel.cu they copy: an edit to one of those lines must be made to
its copy here too. These tests model the design; only chip_smoke.py's K3
checks guard the compiled kernel.
"""

import numpy as np
import pytest
import torch

from h264_fer_tpu_torch.codec.pframe import me_centres
from h264_fer_tpu_torch.kernels.me_qpel import qpel_refine_map_plain
from h264_fer_tpu_torch.ops.interp import interpolated_planes

torch.set_num_threads(1)

WINDOW = 8
EXT = WINDOW + 2
LIM = 4 * EXT - 4
TILE = 9


def tile_origin(o, n):
    """csrc/me_qpel.cu:58 tile_origin: clamp(o, 0, n - 9)."""
    return np.clip(o, 0, n - TILE)


def first_window(c, f, b0, ext):
    """csrc/me_qpel.cu:65 first_window: the integer origin of the first
    window of phase f around centre c along one axis."""
    mv = c - 3 + ((f - (c - 3)) & 3)
    return b0 + (mv >> 2) + ext


def stage_tiles(planes, c, bx0, by0, ext):
    """The kernel's 16 tiles of every block around its centre c (nb, 2)
    (csrc/me_qpel.cu:86-98): (tiles (nb, 16, 9, 9), tx (nb, 16),
    ty (nb, 16))."""
    _, he, we = planes.shape
    nb = c.shape[0]
    ii = np.arange(TILE)
    tiles = np.empty((nb, 16, TILE, TILE), np.int64)
    tx = np.empty((nb, 16), np.int64)
    ty = np.empty((nb, 16), np.int64)
    for ph in range(16):
        tx[:, ph] = tile_origin(first_window(c[:, 0], ph & 3, bx0, ext), we)
        ty[:, ph] = tile_origin(first_window(c[:, 1], ph >> 2, by0, ext), he)
        tiles[:, ph] = planes[ph, (ty[:, ph, None] + ii)[:, :, None],
                              (tx[:, ph, None] + ii)[:, None, :]]
    return tiles, tx, ty


def metric(d, metric_id):
    if metric_id == 0:
        return np.abs(d)
    return (2 if metric_id == 2 else 1) * d * d


def windows(planes, c, bx0, by0, ext):
    """Per offset k: (phase, window origin x, y) as the kernel clamps it
    (csrc/me_qpel.cu:110-115)."""
    _, he, we = planes.shape
    for k in range(49):
        mvx, mvy = c[:, 0] + k % 7 - 3, c[:, 1] + k // 7 - 3
        yield (k, (mvy & 3) * 4 + (mvx & 3), np.clip(bx0 + (mvx >> 2) + ext, 0, we - 8),
               np.clip(by0 + (mvy >> 2) + ext, 0, he - 8))


def score_from_tiles(planes, src, c, ext, metric_id):
    """(nb, 49) map scored from the staged tiles only; asserts that every
    window lies inside its phase's tile."""
    h, w = src.shape
    wb = w // 8
    nb = (h // 8) * wb
    b = np.arange(nb)
    bx0, by0 = (b % wb) * 8, (b // wb) * 8
    blk = src.reshape(h // 8, 8, wb, 8).transpose(0, 2, 1, 3).reshape(nb, 8, 8)
    tiles, tx, ty = stage_tiles(planes, c, bx0, by0, ext)
    ii = np.arange(8)
    out = np.empty((nb, 49), np.int64)
    for k, ph, px, py in windows(planes, c, bx0, by0, ext):
        sx, sy = px - tx[b, ph], py - ty[b, ph]
        assert ((sx >= 0) & (sx <= 1) & (sy >= 0) & (sy <= 1)).all(), k
        win = tiles[b[:, None, None], ph[:, None, None], (sy[:, None] + ii)[:, :, None],
                    (sx[:, None] + ii)[:, None, :]]
        out[:, k] = metric(win - blk, metric_id).sum(axis=(1, 2))
    return out


def score_direct(planes, src, c, ext, metric_id):
    """(nb, 49) map read straight from the planes at the kernel's clamped
    window origins."""
    h, w = src.shape
    wb = w // 8
    nb = (h // 8) * wb
    b = np.arange(nb)
    bx0, by0 = (b % wb) * 8, (b // wb) * 8
    blk = src.reshape(h // 8, 8, wb, 8).transpose(0, 2, 1, 3).reshape(nb, 8, 8)
    ii = np.arange(8)
    out = np.empty((nb, 49), np.int64)
    for k, ph, px, py in windows(planes, c, bx0, by0, ext):
        win = planes[ph[:, None, None], (py[:, None] + ii)[:, :, None],
                     (px[:, None] + ii)[:, None, :]]
        out[:, k] = metric(win - blk, metric_id).sum(axis=(1, 2))
    return out


def _content(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ref = ((xx * 3 + yy * 5) % 200 + rng.integers(0, 40, (h, w))).astype(np.uint8)
    src = np.clip(np.roll(ref, (1, 2), (0, 1)).astype(np.int64)
                  + rng.integers(-9, 10, (h, w)), 0, 255).astype(np.uint8)
    return ref, src, rng


@pytest.mark.parametrize("metric_id", [0, 1, 2])
def test_k3_tiles_score_as_the_plain_twin(metric_id):
    """QCIF: the P path's centres (c1 integer argmins of a random map; c2
    random previous MVs up to beyond the limit, clamped by me_centres to
    ±(LIM - 3), so negative, off multiples of 4 and at the clamp) and random
    quarter-pel centres anywhere in that range, scored from the tiles, equal
    qpel_refine_map_plain."""
    w, h = 176, 144
    ref, src, rng = _content(w, h, 11 + metric_id)
    planes = interpolated_planes(torch.from_numpy(ref), EXT)
    wmb, hmb = w // 16, h // 16
    nb = (w // 8) * (h // 8)
    im = torch.from_numpy(rng.integers(0, 1000, (nb, (2 * WINDOW + 1) ** 2)))
    prev = torch.from_numpy(rng.integers(-LIM - 9, LIM + 10, (wmb * hmb, 4, 2))
                            .astype(np.int32))
    c1, c2, _, _ = me_centres(im, prev, wmb, hmb, WINDOW)
    assert (c2.abs() == LIM - 3).any() and (c2 % 4 != 0).any() and (c2 < 0).any()
    c3 = torch.from_numpy(rng.integers(-(LIM - 3), LIM - 2, (nb, 2)).astype(np.int32))
    src_t = torch.from_numpy(src)
    for c in (c1, c2, c3):
        want = qpel_refine_map_plain(src_t, planes, c, EXT, metric_id).numpy()
        got = score_from_tiles(planes.numpy().astype(np.int64), src.astype(np.int64),
                               c.numpy().astype(np.int64), EXT, metric_id)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,h,ext", [(176, 144, EXT), (16, 144, EXT), (64, 208, EXT),
                                     (16, 16, 0)])
def test_k3_tiles_hold_clamped_windows(w, h, ext):
    """Centres far outside the planes, where the kernel clamps each window's
    origin to [0, n - 8]: the tiles (origin clamped to [0, n - 9]) still hold
    every window, and scoring from them equals reading the planes."""
    rng = np.random.default_rng(w + h + ext)
    nb = (w // 8) * (h // 8)
    planes = rng.integers(0, 256, (16, h + 2 * ext, w + 2 * ext))
    src = rng.integers(0, 256, (h, w))
    for span in (4 * ext + 8, 400):
        c = rng.integers(-span, span + 1, (nb, 2))
        np.testing.assert_array_equal(score_from_tiles(planes, src, c, ext, 1),
                                      score_direct(planes, src, c, ext, 1))


def _bytes(words):
    """Little-endian bytes of uint32 words: (..., 4) int64."""
    return (words[..., None] >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF


def _words(b):
    """uint32 words of little-endian bytes (..., 4)."""
    return (b.astype(np.uint64) << (8 * np.arange(4, dtype=np.uint64))).sum(-1)


def vabsdiffu4(a, b):
    return _words(np.abs(_bytes(a).astype(np.int64) - _bytes(b).astype(np.int64)))


def dp4a(a, b, c):
    return (_bytes(a) * _bytes(b)).sum(-1) + c


def funnelshift_r(lo, hi, s, clamp=False):
    """__funnelshift_r (shift taken mod 32) or __funnelshift_rc (clamped
    to 32) of uint64 arrays holding 32-bit words."""
    s = np.minimum(s, 32) if clamp else s & 31
    return ((hi << np.uint64(32) | lo) >> s.astype(np.uint64)) & 0xFFFFFFFF


@pytest.mark.parametrize("metric_id", [0, 1, 2])
def test_packed_bytes_equal_scalar_metric(metric_id):
    """The kernel's per-row arithmetic (csrc/me_qpel.cu:119-130):
    __vabsdiffu4 of two window words against the source, summed by __dp4a
    with 0x01010101 (SAD) or with itself (SSD), doubled for 2*SSD, equals
    the scalar metric over 8x8 blocks of random bytes, blocks of only 0 and
    255 included."""
    rng = np.random.default_rng(metric_id)
    n = 500
    win = rng.integers(0, 256, (n, 8, 8))
    src = rng.integers(0, 256, (n, 8, 8))
    win[:50], src[:50] = 255, 0
    win[50:100], src[50:100] = 0, 255
    win[100:150] = rng.choice([0, 255], (50, 8, 8))
    src[100:150] = rng.choice([0, 255], (50, 8, 8))
    ww = _words(win.reshape(n, 16, 4))
    sw = _words(src.reshape(n, 16, 4))
    acc = np.zeros(n, np.int64)
    for j in range(16):
        d = vabsdiffu4(ww[:, j], sw[:, j])
        acc = dp4a(d, np.full(n, 0x01010101, np.uint64) if metric_id == 0 else d, acc)
    got = 2 * acc if metric_id == 2 else acc
    want = metric(win - src, metric_id).sum(axis=(1, 2))
    np.testing.assert_array_equal(got, want)
    assert want.max() < 2 ** 31  # 64 x 255^2 x 2: no int32 overflow


def test_tile_rows_from_aligned_words():
    """A tile row as the kernel stages it (csrc/me_qpel.cu:91-97): the
    three aligned words around its first sample, funnel-shifted by the
    sample's byte offset (and by one byte more for the second window), give
    the row's samples [0, 8) and [1, 9), at every alignment."""
    rng = np.random.default_rng(1)
    buf = rng.integers(0, 256, 4096)
    words = _words(buf.reshape(-1, 4))
    addr = rng.integers(0, buf.size - 12, 2000)
    w0, w1, w2 = (words[addr // 4 + i] for i in range(3))
    sh = 8 * (addr % 4)
    for first, s, clamp in ((0, sh, False), (1, sh + 8, True)):
        lo = funnelshift_r(w0, w1, s, clamp)
        hi = funnelshift_r(w1, w2, s, clamp)
        got = np.concatenate([_bytes(lo), _bytes(hi)], axis=-1)
        want = buf[(addr + first)[:, None] + np.arange(8)]
        np.testing.assert_array_equal(got, want)
