"""The one-launch dataflow schedules (kernels/dataflow.py,
csrc/mb_dataflow.cuh) of K4, K6, K4x4, K8 and K1 / K1t / K7, and the
diagonal schedule of the Intra_4x4 MB body (csrc/intra4x4.cuh), on the CPU.

K4, K6, K4x4 and K8 hand out MBs by ticket in `knight_order` and make each
wait for its left, top, top-right and top-left neighbours; K1, K1t and K7
hand them out in `diagonal_order` and wait on left, top and top-left only.
Here: each order is a permutation in which every waited neighbour comes
first, it is the order of the waves the plain twins iterate over, and a
grid of any size finishes under it. Coded MB by MB in random orders that
respect the wait set, K8 (in a per-MB Python form of the kernel), the
plain K4x4, the plain K1 and the plain K7 with its levels give the plain
twins' outputs; K8 and K4x4 run before their top-right neighbour do not,
and no MB with an earlier ticket writes into the samples K8 loads before
its wait. K4x4's kernel waits per 4x4-block step, not per MB: a model of
it at the step level (each MB steps once its neighbours have finished the
steps the progress rule asks for, reading their edges only through the
slots they publish) equals the plain K4x4, the rule's waits on the left,
top and top-right MBs are each needed, and its wait on the top-left is
implied by the top's. Coding an MB's 4x4 blocks as the
kernel does (10 steps t = i + 2j, two blocks at once, each sample predicted
from three cells through the packed Intra4x4 table) gives i4x4_mb_code's
result. The kernels themselves are held against the plain twins on the card
by chip_smoke.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from h264_fer_tpu_torch.kernels import deblock, dataflow, wavefront_i16, wavefront_mixed, wavefront_p
from h264_fer_tpu_torch.kernels.wavefront_i4x4 import (i4x4_luma, i4x4_luma_plain,
                                                       i4x4_mb_code, knight_waves,
                                                       mb_neighbours)
from h264_fer_tpu_torch.ops import intra, transform
from h264_fer_tpu_torch.ops.transform import chroma_qp

torch.set_num_threads(1)

GRIDS = [(1, 1), (1, 9), (11, 1), (4, 13), (11, 9), (120, 68)]  # (wmb, hmb)
NEIGHBOURS = ((0, -1), (-1, 0), (-1, 1), (-1, -1))  # left, top, top-right, top-left
I16_NEIGHBOURS = ((0, -1), (-1, 0), (-1, -1))  # left, top, top-left


def _ids(grid):
    return f"{grid[0]}x{grid[1]}"


def _deps(wmb, hmb, mb, neighbours=NEIGHBOURS):
    """Raster indices of the existing neighbours MB mb waits on."""
    r, c = divmod(mb, wmb)
    return [(r + dr) * wmb + c + dc for dr, dc in neighbours
            if r + dr >= 0 and 0 <= c + dc < wmb]


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_knight_order_is_a_permutation(grid):
    wmb, hmb = grid
    order = dataflow.knight_order(wmb, hmb)
    assert order.dtype == np.int32 and order.shape == (wmb * hmb,)
    np.testing.assert_array_equal(np.sort(order), np.arange(wmb * hmb))
    assert not order.flags.writeable  # cached: callers share it


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_every_waited_neighbour_has_an_earlier_ticket(grid):
    wmb, hmb = grid
    order = dataflow.knight_order(wmb, hmb)
    ticket = np.empty_like(order)
    ticket[order] = np.arange(order.size)
    for mb in range(wmb * hmb):
        for n in _deps(wmb, hmb, mb):
            assert ticket[n] < ticket[mb], (mb, n)


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_order_is_the_plain_k6_waves(grid, monkeypatch):
    """The waves mixed_luma_plain asks knight_waves for, concatenated (the
    generator is recorded and the loop body skipped)."""
    wmb, hmb = grid
    waves = []

    def recorded(*args):
        waves.extend(mb.tolist() for _, _, mb in knight_waves(*args))
        return iter(())

    monkeypatch.setattr(wavefront_mixed, "knight_waves", recorded)
    nmb = wmb * hmb
    zeros = torch.zeros(nmb, dtype=torch.int32)
    wavefront_mixed.mixed_luma_plain(
        torch.zeros((16 * hmb, 16 * wmb), dtype=torch.uint8), zeros,
        torch.zeros((nmb, 16), dtype=torch.int32), zeros, zeros, zeros, 28)
    assert [mb for wave in waves for mb in wave] == dataflow.knight_order(wmb, hmb).tolist()


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_order_is_the_plain_k4_waves(grid, monkeypatch):
    """The MBs pframe_decide_plain decides on each of its diagonals,
    recorded where it builds its per-diagonal context, concatenated."""
    wmb, hmb = grid
    waves = []

    class Recorded(wavefront_p._Ctx):
        def __init__(self, mvq, mbt, rs, cs, valid, wmb, hmb):
            super().__init__(mvq, mbt, rs, cs, valid, wmb, hmb)
            wave = (rs * wmb + cs)[valid].tolist()
            if wave and (not waves or waves[-1] != wave):
                waves.append(wave)

    monkeypatch.setattr(wavefront_p, "_Ctx", Recorded)
    nmb, ext = wmb * hmb, 1  # window 0: candidate MVs within +-3 qpel
    h, w = 16 * hmb, 16 * wmb
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
    wavefront_p.pframe_decide_plain(
        torch.zeros((h, w), dtype=torch.uint8),
        torch.zeros((16, h + 2 * ext, w + 2 * ext), dtype=torch.uint8),
        z(nmb, 4, 1), z(nmb, 4, 2), z(nmb, 4, 49), z(nmb, 4, 2), z(nmb, 4, 49),
        torch.ones((nmb, 4), dtype=torch.bool), torch.full((nmb,), -1, dtype=torch.int32),
        wmb, hmb, 0, ext, 0, 4)
    assert [mb for wave in waves for mb in wave] == dataflow.knight_order(wmb, hmb).tolist()


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_diagonal_order_is_a_permutation(grid):
    wmb, hmb = grid
    order = dataflow.diagonal_order(wmb, hmb)
    assert order.dtype == np.int32 and order.shape == (wmb * hmb,)
    np.testing.assert_array_equal(np.sort(order), np.arange(wmb * hmb))
    assert not order.flags.writeable
    ticket = np.empty_like(order)
    ticket[order] = np.arange(order.size)
    for mb in range(wmb * hmb):
        for n in _deps(wmb, hmb, mb, I16_NEIGHBOURS):
            assert ticket[n] < ticket[mb], (mb, n)


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_diagonal_order_is_the_plain_k1_waves(grid, monkeypatch):
    """The diagonals i16_recon_plain asks _diagonals for, concatenated (the
    generator is recorded and the loop body skipped)."""
    wmb, hmb = grid
    waves = []
    inner = wavefront_i16._diagonals

    def recorded(*args):
        waves.extend(mb.tolist() for _, _, mb in inner(*args))
        return iter(())

    monkeypatch.setattr(wavefront_i16, "_diagonals", recorded)
    nmb = wmb * hmb
    y = torch.zeros((16 * hmb, 16 * wmb), dtype=torch.uint8)
    c = torch.zeros((8 * hmb, 8 * wmb), dtype=torch.uint8)
    zeros = torch.zeros(nmb, dtype=torch.int32)
    wavefront_i16.i16_recon_plain(y, c, c, zeros, zeros, 28, 28)
    assert [mb for wave in waves for mb in wave] == dataflow.diagonal_order(wmb, hmb).tolist()


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_order_is_the_plain_k8_waves(grid, monkeypatch):
    """The knight waves deblock_frame_plain iterates over, concatenated."""
    wmb, hmb = grid
    waves = []

    def recorded(*args):
        waves.extend(mb.tolist() for _, _, mb in knight_waves(*args))
        return iter(())

    monkeypatch.setattr(deblock, "knight_waves", recorded)
    nmb = wmb * hmb
    y = torch.zeros((16 * hmb, 16 * wmb), dtype=torch.uint8)
    c = torch.zeros((8 * hmb, 8 * wmb), dtype=torch.uint8)
    deblock.deblock_frame_plain(y, c, c, torch.ones(nmb, dtype=torch.bool),
                                torch.zeros((nmb, 16), dtype=torch.bool),
                                torch.zeros((nmb, 4, 2), dtype=torch.int32), 30, 30)
    assert [mb for wave in waves for mb in wave] == dataflow.knight_order(wmb, hmb).tolist()


def _play(wmb, hmb, order, blocks, neighbours, take=None, finish=None, seed=None):
    """The persistent grid as a game: `blocks` blocks (None: one per MB)
    hold a ticket each, taking the next one in `order` when they finish; at
    every turn one block whose MB has all its neighbours done, chosen at
    random, finishes it. Fails if no block can move before every MB is
    done: a deadlock. take(mb) / finish(mb), where given, run when a block
    takes MB mb's ticket (its work before the wait) and when it finishes
    the MB (its work after the wait)."""
    nmb = wmb * hmb
    order = order.tolist()
    rng = np.random.default_rng(blocks if seed is None else seed)
    take = take or (lambda mb: None)
    finish = finish or (lambda mb: None)
    waits = [len(_deps(wmb, hmb, mb, neighbours)) for mb in range(nmb)]
    waiters = [[] for _ in range(nmb)]
    for mb in range(nmb):
        for n in _deps(wmb, hmb, mb, neighbours):
            waiters[n].append(mb)
    held = set(order[:nmb if blocks is None else blocks])
    for mb in order[:len(held)]:
        take(mb)
    nxt = len(held)
    ready = [mb for mb in held if waits[mb] == 0]
    done = 0
    while held:
        assert ready, f"deadlock with {len(held)} blocks waiting"
        k = int(rng.integers(len(ready)))
        ready[k], ready[-1] = ready[-1], ready[k]
        mb = ready.pop()
        finish(mb)
        held.remove(mb)
        done += 1
        for w in waiters[mb]:
            waits[w] -= 1
            if waits[w] == 0 and w in held:
                ready.append(w)
        if nxt < nmb:
            new = order[nxt]
            nxt += 1
            held.add(new)
            take(new)
            if waits[new] == 0:
                ready.append(new)
    assert done == nmb


@pytest.mark.parametrize("blocks", [1, 3, 61, None])
@pytest.mark.parametrize("grid", [(11, 9), (120, 68)], ids=_ids)
def test_any_grid_size_finishes(grid, blocks):
    """The game of _play in knight order under the four-neighbour set (K4,
    K6, K8): no deadlock."""
    wmb, hmb = grid
    _play(wmb, hmb, dataflow.knight_order(wmb, hmb), blocks, NEIGHBOURS)


@pytest.mark.parametrize("blocks", [1, 3, 61, None])
@pytest.mark.parametrize("grid", [(11, 9), (120, 68)], ids=_ids)
def test_any_grid_size_finishes_in_diagonal_order(grid, blocks):
    """The same game in diagonal order under the I16 wait set (K1, K1t)."""
    wmb, hmb = grid
    _play(wmb, hmb, dataflow.diagonal_order(wmb, hmb), blocks, I16_NEIGHBOURS)


def test_blocks_argument():
    assert dataflow.check_blocks(None) == 0
    assert dataflow.check_blocks(3) == 3
    for bad in (0, -1, 1.5, "2"):
        with pytest.raises(ValueError):
            dataflow.check_blocks(bad)
    y = torch.zeros((16, 16), dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        wavefront_mixed.mixed_luma(y, one, torch.zeros((1, 16), dtype=torch.int32),
                                   one, one, one, 28, blocks=0)
    # on CPU tensors a valid grid size changes nothing: the plain twin runs
    got = wavefront_mixed.mixed_luma(y, one, torch.zeros((1, 16), dtype=torch.int32),
                                     one, one, one, 28, blocks=2)
    want = wavefront_mixed.mixed_luma_plain(y, one, torch.zeros((1, 16), dtype=torch.int32),
                                            one, one, one, 28)
    for key in wavefront_mixed.KEYS:
        assert torch.equal(got[key], want[key]), key


def test_blocks_argument_k1_k1t_k8():
    """K1, K1t, K7 (chroma_recon and chroma_frame) and K8 refuse a bad grid
    size on any device; on CPU tensors a valid one changes nothing: the
    plain twin runs."""
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.integers(0, 256, (32, 48)).astype(np.uint8))
    cb, cr = (torch.from_numpy(rng.integers(0, 256, (16, 24)).astype(np.uint8))
              for _ in range(2))
    modes = torch.from_numpy(rng.integers(0, 4, 6).astype(np.int32))
    state = (torch.from_numpy(rng.random(6) < 0.5), torch.from_numpy(rng.random((6, 16)) < 0.5),
             torch.from_numpy(rng.integers(-8, 9, (6, 4, 2)).astype(np.int32)))
    calls = [(wavefront_i16.i16_recon, wavefront_i16.i16_recon_plain, (y, cb, cr, modes, modes, 28, 28)),
             (wavefront_i16.i16_frame, wavefront_i16.i16_frame_plain, (y, cb, cr, modes, modes, 28, 28)),
             (wavefront_i16.chroma_recon, wavefront_i16.chroma_recon_plain, (cb, cr, modes, 28)),
             (wavefront_i16.chroma_frame, wavefront_i16.chroma_frame_plain, (cb, cr, modes, 28)),
             (deblock.deblock_frame, deblock.deblock_frame_plain, (y, cb, cr, *state, 36, 34))]
    for fn, plain, args in calls:
        for bad in (0, -2, 2.0, "3"):
            with pytest.raises(ValueError):
                fn(*args, blocks=bad)
        want = plain(*args)
        for blocks in (1, 3, None):
            got = fn(*args, blocks=blocks)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), fn.__name__


def _mb_frame(rng, w, h):
    """Planes of flat 8x8 patches with low noise, so that most edges pass
    the alpha / beta test, as int64 arrays."""
    base = rng.integers(40, 200, (h // 8, w // 8))
    y = np.kron(base, np.ones((8, 8), np.int64)) + rng.integers(-6, 7, (h, w))
    c = np.kron(base[::2, ::2], np.ones((8, 8), np.int64)) + rng.integers(-4, 5, (h // 2, w // 2))
    return [np.clip(p, 0, 255) for p in (y, c, 255 - c)]


def _inter_state(w, h, seed):
    """Planes and random P-frame state with every bS 0-4."""
    rng = np.random.default_rng(seed)
    nmb = (w // 16) * (h // 16)
    mv = rng.integers(-3, 4, (nmb, 1, 2)) * 2 + rng.integers(-2, 3, (nmb, 4, 2))
    return (_mb_frame(rng, w, h), rng.random(nmb) < 0.15, rng.random((nmb, 16)) < 0.3,
            mv.astype(np.int32))


def _filter_line(w, i, st, bs, tab, chroma):
    """The function of csrc/deblock.cu's filter_luma (chroma False) and
    filter_chroma (True), one edge line of the flat window w in place: q0
    at w[i], p_k at w[i - (k + 1) st], q_k at w[i + k st]."""
    if bs == 0:
        return
    alpha, beta, tc0s = tab
    p0, p1, p2, p3 = (w[i - k * st] for k in (1, 2, 3, 4))
    q0, q1, q2, q3 = (w[i + k * st] for k in (0, 1, 2, 3))
    if not (abs(p0 - q0) < alpha and abs(p1 - p0) < beta and abs(q1 - q0) < beta):
        return
    ap, aq = abs(p2 - p0) < beta, abs(q2 - q0) < beta
    if bs < 4:
        tc0 = tc0s[bs - 1]
        tc = tc0 + 1 if chroma else tc0 + ap + aq
        delta = min(max(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc), tc)
        w[i - st], w[i] = min(max(p0 + delta, 0), 255), min(max(q0 - delta, 0), 255)
        if not chroma:
            avg = (p0 + q0 + 1) >> 1
            if ap:
                w[i - 2 * st] = p1 + min(max((p2 + avg - p1 * 2) >> 1, -tc0), tc0)
            if aq:
                w[i + st] = q1 + min(max((q2 + avg - q1 * 2) >> 1, -tc0), tc0)
        return
    strong = not chroma and abs(p0 - q0) < (alpha >> 2) + 2
    if strong and ap:
        w[i - st] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
        w[i - 2 * st] = (p2 + p1 + p0 + q0 + 2) >> 2
        w[i - 3 * st] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    else:
        w[i - st] = (2 * p1 + p0 + q1 + 2) >> 2
    if strong and aq:
        w[i] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
        w[i + st] = (q2 + q1 + q0 + p0 + 2) >> 2
        w[i + 2 * st] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    else:
        w[i] = (2 * q1 + q0 + p1 + 2) >> 2


def _k8_writes(wmb, mb):
    """The samples csrc/deblock.cu writes back for MB mb, as (plane, y, x):
    its own MB, the top MB's bottom 3 luma rows and 1 chroma row, the left
    MB's right 3 luma columns and 1 chroma column."""
    r, c = divmod(mb, wmb)
    out = set()
    for p, n, k in ((0, 16, 3), (1, 8, 1), (2, 8, 1)):
        y0, x0 = n * r, n * c
        out |= {(p, y0 + i, x0 + j) for i in range(n) for j in range(n)}
        if r > 0:
            out |= {(p, y0 - 1 - i, x0 + j) for i in range(k) for j in range(n)}
        if c > 0:
            out |= {(p, y0 + i, x0 - 1 - j) for i in range(n) for j in range(k)}
    return out


def _own(wmb, mb):
    """MB mb's own luma and chroma samples, as (plane, y, x)."""
    r, c = divmod(mb, wmb)
    return {(p, n * r + i, n * c + j) for p, n in ((0, 16), (1, 8), (2, 8))
            for i in range(n) for j in range(n)}


class _K8PerMb:
    """csrc/deblock.cu one MB at a time, in Python, on int planes filtered in
    place: take(mb) is the work before the wait (the MB's own samples, which
    it keeps), finish(mb) the work after it (the strips its neighbours
    write, the 8 edge steps, the write-back). Checks that the filter
    changes no window sample the write-back leaves out."""

    def __init__(self, planes, state, qp):
        self.planes = [p.copy() for p in planes]
        h, w = planes[0].shape
        self.wmb = w // 16
        bs_v, bs_h = deblock.bs_maps(*(torch.from_numpy(a) for a in state), w // 16, h // 16)
        self.bs = np.stack([bs_v.numpy(), bs_h.numpy()], 1)  # (nmb, dir, edge, group)
        self.tabs = [(a, b, [int(t) for t in tc0])
                     for a, b, tc0 in (deblock._edge_params(qp), deblock._edge_params(chroma_qp(qp)))]
        self.own = {}

    def _window(self, p, mb, n):
        """(y, x) of the (n + 4)^2 window of plane p around MB mb, row-major."""
        r, c = divmod(mb, self.wmb)
        return [(n * r - 4 + i, n * c - 4 + j) for i in range(n + 4) for j in range(n + 4)]

    def take(self, mb):
        r, c = divmod(mb, self.wmb)
        self.own[mb] = [self.planes[p][n * r: n * r + n, n * c: n * c + n].copy()
                        for p, n in ((0, 16), (1, 8), (2, 8))]

    def finish(self, mb):
        wins = []
        for p, n in ((0, 16), (1, 8), (2, 8)):
            pos = self._window(p, mb, n)
            win = [int(self.planes[p][y, x]) if y >= 0 and x >= 0 else 0 for y, x in pos]
            own = self.own.pop(mb)[p] if p == 2 else self.own[mb][p]
            for i in range(n):  # the interior from what take() loaded
                win[(4 + i) * (n + 4) + 4: (4 + i) * (n + 4) + 4 + n] = own[i].tolist()
            wins.append((p, n, pos, win, list(win)))
        bs = self.bs[mb]
        for step in range(8):
            d, e = divmod(step, 4)
            for t in range(16):
                i = (4 + 4 * e) * 20 + 4 + t if d else (4 + t) * 20 + 4 + 4 * e
                _filter_line(wins[0][3], i, 20 if d else 1, int(bs[d, e, t >> 2]),
                             self.tabs[0], False)
            if e % 2 == 0:
                for k in (1, 2):
                    for j in range(8):
                        i = (4 + 2 * e) * 12 + 4 + j if d else (4 + j) * 12 + 4 + 2 * e
                        _filter_line(wins[k][3], i, 12 if d else 1, int(bs[d, e, j >> 1]),
                                     self.tabs[1], True)
        writes = _k8_writes(self.wmb, mb)
        for p, n, pos, win, loaded in wins:
            for (y, x), v, v0 in zip(pos, win, loaded):
                if (p, y, x) in writes:
                    self.planes[p][y, x] = v
                else:
                    assert v == v0, f"MB {mb} changed ({p}, {y}, {x}) outside its write-back"


K8_CASES = [((176, 144), 30), ((64, 208), 38), ((16, 144), 34), ((176, 16), 34)]


def _k8_ids(case):
    return f"{case[0][0]}x{case[0][1]}_qp{case[1]}"


def _k8_plain(planes, state, qp):
    got = deblock.deblock_frame_plain(
        *(torch.from_numpy(p.astype(np.uint8)) for p in planes),
        *(torch.from_numpy(a) for a in state), qp, chroma_qp(qp))
    return [g.numpy().astype(np.int64) for g in got]


@pytest.mark.parametrize("case", K8_CASES, ids=_k8_ids)
def test_k8_per_mb_in_any_order_the_wait_set_allows(case):
    """K8 MB by MB, each loading its own samples when it takes its ticket
    and the rest when its four neighbours are done, in the random orders
    the persistent grid can run (3 blocks, 16 blocks, one per MB; knight
    tickets), gives deblock_frame_plain's planes."""
    (w, h), qp = case
    planes, *state = _inter_state(w, h, w + h + qp)
    want = _k8_plain(planes, state, qp)
    assert any((p != q).any() for p, q in zip(planes, want))  # the filter is at work
    wmb, hmb = w // 16, h // 16
    for blocks in (3, 16, None):
        k8 = _K8PerMb(planes, state, qp)
        _play(wmb, hmb, dataflow.knight_order(wmb, hmb), blocks, NEIGHBOURS,
              k8.take, k8.finish, seed=qp)
        for p, q in zip(k8.planes, want):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("case", K8_CASES[:2], ids=_k8_ids)
def test_k8_before_its_top_right_neighbour_differs(case):
    """The mutant that shows the top-right wait is needed: MBs run one by one
    along each anti-diagonal from the bottom, so every MB (r, c) runs before
    (r - 1, c + 1), whose left edge writes the p samples of its top edge."""
    (w, h), qp = case
    planes, *state = _inter_state(w, h, w + h + qp)
    wmb, hmb = w // 16, h // 16
    r, c = np.divmod(np.arange(wmb * hmb), wmb)
    k8 = _K8PerMb(planes, state, qp)
    for mb in np.lexsort((-r, r + c)):
        k8.take(int(mb))
        k8.finish(int(mb))
    want = _k8_plain(planes, state, qp)
    assert any((p != q).any() for p, q in zip(k8.planes, want))


@pytest.mark.parametrize("grid", GRIDS[:5], ids=_ids)
def test_k8_prefetch_rule(grid):
    """What K8 loads before its wait, its own MB, no MB with an earlier
    knight ticket writes, and every other MB that writes into it waits on
    it: so the samples are final when the MB takes its ticket."""
    wmb, hmb = grid
    order = dataflow.knight_order(wmb, hmb)
    ticket = np.empty_like(order)
    ticket[order] = np.arange(order.size)
    owner = {}
    for mb in range(wmb * hmb):
        for s in _own(wmb, mb):
            owner[s] = mb
    for n in range(wmb * hmb):
        for m in {owner[s] for s in _k8_writes(wmb, n)} - {n}:
            assert ticket[m] < ticket[n], (n, m)
            assert m in _deps(wmb, hmb, n), (n, m)


@pytest.mark.parametrize("kernel,wh", [("K1", (176, 144)), ("K1", (64, 208)),
                                       ("K7", (176, 144)), ("K7", (64, 208))],
                         ids=["qcif", "64x208", "k7-qcif", "k7-64x208"])
def test_k1_per_mb_in_any_order_the_i16_wait_set_allows(kernel, wh):
    """The plain K1 (or, chroma only, K7 with its levels) coded MB by MB in
    orders that wait on left, top and top-left only, never on top-right
    (the persistent grid's random orders with 3 blocks and one per MB in
    diagonal tickets, and each diagonal from the bottom, every MB before
    its top-right neighbour), equals i16_recon_plain (chroma_frame_plain:
    recon and levels): the I16 wait set suffices for both kernels."""
    w, h = wh
    rng = np.random.default_rng(w + h)
    wmb, hmb = w // 16, h // 16
    nmb = wmb * hmb
    planes = [torch.from_numpy(p.astype(np.uint8)) for p in _mb_frame(rng, w, h)]
    modes, cmodes = (torch.from_numpy(rng.integers(0, 4, nmb).astype(np.int32))
                     for _ in range(2))
    qp, qpc = 28, chroma_qp(28)
    if kernel == "K1":
        want = wavefront_i16.i16_recon_plain(*planes, modes, cmodes, qp, qpc)
    else:
        want = wavefront_i16.chroma_frame_plain(*planes[1:], cmodes, qpc)
    ysrc = wavefront_i16.to_mbs(planes[0].to(torch.int32), 16)
    csrc = torch.stack([wavefront_i16.to_mbs(p.to(torch.int32), 8) for p in planes[1:]])
    r_, c_ = np.divmod(np.arange(nmb), wmb)
    orders = [None, 3, np.lexsort((-r_, r_ + c_))]
    for how in orders:
        ypad = wavefront_i16._recon_planes(1, h, w, "cpu")
        cpad = wavefront_i16._recon_planes(2, h // 2, w // 2, "cpu")
        cdc = torch.full((2, nmb, 4), -999, dtype=torch.int32)
        cac = torch.full((2, nmb, 4, 15), -999, dtype=torch.int32)

        def code(mb):
            r, c = (torch.tensor([v]) for v in divmod(mb, wmb))
            m = torch.tensor([mb])

            def chroma(p):
                rec, cdc[:, m], cac[:, m] = wavefront_i16._chroma_code(
                    csrc[:, m], p, cmodes[m], qpc)
                return rec

            if kernel == "K1":
                wavefront_i16._step(ypad, r, c, 16, lambda p: wavefront_i16._i16_luma_code(
                    ysrc[m], p[0], modes[m], qp)[0][None])
            wavefront_i16._step(cpad, r, c, 8, chroma)

        if isinstance(how, np.ndarray):
            for mb in how:
                code(int(mb))
        else:
            _play(wmb, hmb, dataflow.diagonal_order(wmb, hmb), how, I16_NEIGHBOURS,
                  finish=code, seed=7)
        got = ((ypad[0, 1:, 1:], cpad[0, 1:, 1:], cpad[1, 1:, 1:]) if kernel == "K1"
               else (cpad[0, 1:, 1:], cpad[1, 1:, 1:], cdc, cac))
        assert len(got) == len(want)
        for g, x in zip(got, want):
            assert torch.equal(g.to(x.dtype), x)


def _k4x4_per_mb(w, h, qp, run):
    """The plain K4x4 one MB at a time: random source and Intra4x4 modes of
    a w x h frame, each MB coded by i4x4_mb_code from the recon grid as it
    stands when `run` (given the per-MB coder) reaches it. Returns (the
    recon plane and levels, i4x4_luma_plain's)."""
    rng = np.random.default_rng(w * h + qp)
    wmb, hmb = w // 16, h // 16
    y = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.uint8))
    modes = torch.from_numpy(rng.integers(0, 9, (wmb * hmb, 16)).astype(np.int32))
    src = y.to(torch.int32).reshape(hmb, 16, wmb, 16).permute(0, 2, 1, 3)
    rec = torch.zeros((hmb, wmb, 16, 16), dtype=torch.int32)
    levels = torch.zeros((wmb * hmb, 16, 16), dtype=torch.int32)

    def code(mb):
        r, c = divmod(mb, wmb)
        rt, ct = torch.tensor([r]), torch.tensor([c])
        out, lv = i4x4_mb_code(src[r, c][None], modes[mb][None],
                               mb_neighbours(rec, rt, ct), qp)
        rec[r, c], levels[mb] = out[0], lv[0]

    run(code)
    got = rec.permute(0, 2, 1, 3).reshape(h, w).to(torch.uint8)
    return (got, levels), i4x4_luma_plain(y, modes, qp)


@pytest.mark.parametrize("wh", [(176, 144), (64, 208)], ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_k4x4_per_mb_in_any_order_the_wait_set_allows(wh):
    """The plain K4x4 coded MB by MB in the orders the persistent grid can
    run in knight tickets under the four-neighbour wait set (3 blocks; on
    64x208 also 1 block and one per MB), with random modes in every block,
    equals i4x4_luma_plain: recon and levels. _play also shows each grid
    size finishes."""
    w, h = wh
    wmb, hmb = w // 16, h // 16
    for blocks in (1, 3, None) if h > w else (3,):
        got, want = _k4x4_per_mb(w, h, 28, lambda code: _play(
            wmb, hmb, dataflow.knight_order(wmb, hmb), blocks, NEIGHBOURS,
            finish=code, seed=blocks or 0))
        for g, x in zip(got, want):
            assert torch.equal(g, x)


def test_k4x4_needs_the_top_right_wait():
    """The I16 wait set does not serve K4x4: coded along each anti-diagonal
    from the bottom, so every MB runs before its top-right neighbour (an
    order left, top and top-left allow), block 5 reads a row 15 that is not
    yet reconstructed, and the frame differs from i4x4_luma_plain."""
    w, h = 64, 208
    wmb, hmb = w // 16, h // 16
    r, c = np.divmod(np.arange(wmb * hmb), wmb)
    order = np.lexsort((-r, r + c))

    def run(code):
        for mb in order:
            code(int(mb))

    (rec, lv), (want_rec, want_lv) = _k4x4_per_mb(w, h, 28, run)
    assert not torch.equal(rec, want_rec)
    assert not torch.equal(lv, want_lv)


def test_blocks_argument_k4x4():
    """i4x4_luma refuses a bad grid size on any device; on CPU tensors a
    valid one changes nothing: the plain twin runs, with no launch."""
    rng = np.random.default_rng(6)
    y = torch.from_numpy(rng.integers(0, 256, (32, 48)).astype(np.uint8))
    modes = torch.from_numpy(rng.integers(0, 9, (6, 16)).astype(np.int32))
    for bad in (0, -2, 2.0, "3"):
        with pytest.raises(ValueError):
            i4x4_luma(y, modes, 30, blocks=bad)
    want = i4x4_luma_plain(y, modes, 30)
    before = i4x4_luma.launches
    for blocks in (1, 3, None):
        got = i4x4_luma(y, modes, 30, blocks=blocks)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert i4x4_luma.launches == before


_TABLE = torch.from_numpy(intra.packed_mode_table().astype(np.int64)).reshape(9, 16)


def _i4x4_step(ext, levels, t, src, modes, tr_ok, qp):
    """Step t of csrc/intra4x4.cuh on n MBs, in place: the blocks (i, j)
    with i + 2j = t coded from ext (n, 17, 21) as it stands before the step
    (row 0: corner, top row, top-right samples; column 0: left column; -1
    where unavailable), each sample predicted from three ext cells through
    packed_mode_table (DC from its 8 samples); their reconstruction goes
    into ext and their levels into levels (n, 16, 16)."""
    n = src.shape[0]
    coded = []
    for j in range(4):
        i = t - 2 * j
        if not 0 <= i <= 3:
            continue
        bx, by = 4 * i, 4 * j
        z = (j >> 1) * 8 + (i >> 1) * 4 + (j & 1) * 2 + (i & 1)
        e = ext[:, by:by + 5, :]  # e[:, 0, bx] is the block's corner
        m = modes[:, z].long()
        code = _TABLE[m]  # (n, 16)
        rep = (z in (3, 11)) | ((bx == 12) & ((by > 0) | ~tr_ok))
        acc = (code >> 18) & 3
        for k in range(3):
            idx = (code >> (4 * k)) & 15
            row = torch.where((idx >= 1) & (idx <= 4), idx, 0)
            col = torch.where(idx < 5, 0, torch.where(
                torch.as_tensor(rep).reshape(-1, 1) & (idx >= 9), 4, idx - 4))
            cell = e[torch.arange(n)[:, None], row, bx + col]
            acc = acc + ((code >> (12 + 2 * k)) & 3) * cell
        pred = acc >> ((code >> 20) & 3)
        top4 = e[:, 0, bx + 1:bx + 5].sum(-1)
        left4 = e[:, 1:5, bx].sum(-1)
        dc = torch.where(e[:, 0, bx] != -1, (top4 + left4 + 4) >> 3, torch.where(
            e[:, 1, bx] != -1, (left4 + 2) >> 2, torch.where(
                e[:, 0, bx + 1] != -1, (top4 + 2) >> 2, 128)))
        pred = torch.where((m == 2)[:, None], dc[:, None], pred)
        assert (pred.abs() < 999).all(), f"block ({i}, {j}) read an uncoded sample"
        pred = pred.to(torch.int32).reshape(n, 4, 4)
        q = transform.quantize_residual(transform.forward_transform_4x4(
            src[:, by:by + 4, bx:bx + 4] - pred), qp, False)
        levels[:, z] = transform.zigzag_scan(q)
        coded.append((bx, by, (pred + transform.inverse_residual(q, qp, False))
                      .clamp(0, 255)))
    assert len(coded) == (1 if t in (0, 1, 8, 9) else 2)
    for bx, by, rec in coded:
        ext[:, by + 1:by + 5, bx + 1:bx + 5] = rec


def _i4x4_in_steps(src, modes, nb, qp):
    """i4x4_mb_code's function as csrc/intra4x4.cuh computes it: the MB's
    reconstruction inside `ext`, coded in the 10 steps of _i4x4_step."""
    n = src.shape[0]
    ext = torch.full((n, 17, 21), -999, dtype=torch.int64)  # -999: not coded yet
    ext[:, 0, 0] = nb["corner"]
    ext[:, 0, 1:17] = nb["trow"]
    ext[:, 0, 17:21] = torch.where(nb["tr_ok"][:, None], nb["tr4"], -1)
    ext[:, 1:17, 0] = nb["lcol"]
    levels = torch.zeros((n, 16, 16), dtype=torch.int32)
    for t in range(10):
        _i4x4_step(ext, levels, t, src, modes, nb["tr_ok"], qp)
    return ext[:, 1:, 1:17].to(torch.int32), levels


@pytest.mark.parametrize("qp", [4, 28, 51])
def test_i4x4_diagonal_steps_match_zscan(qp):
    """Random MBs, modes and neighbour samples, with every availability
    pattern (frame edges, no top-right MB)."""
    rng = np.random.default_rng(qp)
    n = 64
    src = torch.from_numpy(rng.integers(0, 256, (n, 16, 16)).astype(np.int32))
    modes = torch.from_numpy(rng.integers(0, 9, (n, 16)).astype(np.int32))
    left_ok = torch.from_numpy(rng.random(n) < 0.7)
    top_ok = torch.from_numpy(rng.random(n) < 0.7)
    tr_ok = top_ok & torch.from_numpy(rng.random(n) < 0.7)
    rnd = lambda k: torch.from_numpy(rng.integers(0, 256, (n, k)).astype(np.int32))  # noqa: E731
    nb = {"lcol": torch.where(left_ok[:, None], rnd(16), -1),
          "trow": torch.where(top_ok[:, None], rnd(16), -1),
          "corner": torch.where(left_ok & top_ok, rnd(1)[:, 0], -1),
          "tr4": rnd(4), "top_ok": top_ok, "tr_ok": tr_ok}
    want_rec, want_lv = i4x4_mb_code(src, modes, nb, qp)
    got_rec, got_lv = _i4x4_in_steps(src, modes, nb, qp)
    assert torch.equal(got_rec, want_rec)
    assert torch.equal(got_lv, want_lv)


# K4x4's edge slots (csrc/wavefront_i4x4.cu): slot k < 4 holds the MB's
# column 15, rows 4k..4k+3, slot 4 + k its row 15, columns 4k..4k+3; the
# step after which each is published (_PUBLISH: EdgeHook::after); and what
# each step reads first (_READS: the kFrom, kSlot, kNeed and kCell
# arrays): (step, neighbour (dr, dc), slot, first ext cell: ("col", row)
# of column 0, ("row", col) of row 0, or ("corner",) for the top-left's
# byte 3). test_k4x4_slot_tables_match_the_kernel_source reads both out of
# the .cu.
_PUBLISH = {3: (0,), 5: (1,), 6: (4,), 7: (2, 5), 8: (6,), 9: (3, 7)}
_READS = [(0, (0, -1), 0, ("col", 1)), (0, (-1, 0), 4, ("row", 1)),
          (0, (-1, 0), 5, ("row", 5)), (0, (-1, -1), 7, ("corner",)),
          (1, (-1, 0), 6, ("row", 9)), (2, (0, -1), 1, ("col", 5)),
          (2, (-1, 0), 7, ("row", 13)), (3, (-1, 1), 4, ("row", 17)),
          (4, (0, -1), 2, ("col", 9)), (6, (0, -1), 3, ("col", 13))]
# the progress rule: before step t, how many steps each neighbour must
# have finished (the left edge for even t <= 6, the top row and its
# above-right samples for t <= 2, block 5's top-right samples at t = 3,
# the corner at t = 0)
_RULE = {(0, -1): {0: 4, 2: 6, 4: 8, 6: 10}, (-1, 0): {0: 8, 1: 9, 2: 10},
         (-1, 1): {3: 7}, (-1, -1): {0: 10}}


def _slot_cells(k):
    """The ext cells (row, col) slot k publishes, in byte order."""
    return [(1 + 4 * k + i, 16) if k < 4 else (16, 1 + 4 * (k - 4) + i) for i in range(4)]


def _k4x4_steps_model(w, h, qp, rule=_RULE, p=1.0, seed=0):
    """K4x4 at the step level: each MB codes its 10 steps (_i4x4_step),
    step t once its neighbours have finished the steps `rule` asks for;
    before it, it reads the slots _READS names from the scratch as they
    stand (zero where a slot is not yet published), and after it publishes
    the slots _PUBLISH names. In each round a random share p of the MBs
    that may step (at least one) take their step, all reads before any
    step, all publishes after. Returns (recon, levels, i4x4_luma_plain's)."""
    rng = np.random.default_rng(w * h + seed)
    wmb, hmb = w // 16, h // 16
    n = wmb * hmb
    y = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.uint8))
    modes = torch.from_numpy(rng.integers(0, 9, (n, 16)).astype(np.int32))
    src = y.to(torch.int32).reshape(hmb, 16, wmb, 16).permute(0, 2, 1, 3).reshape(n, 16, 16)
    r, c = np.divmod(np.arange(n), wmb)
    tr_ok = torch.from_numpy((r > 0) & (c + 1 < wmb))
    ext = torch.full((n, 17, 21), -999, dtype=torch.int64)
    ext[:, 0, :] = -1  # every neighbour sample unavailable until read
    ext[:, :, 0] = -1
    levels = torch.zeros((n, 16, 16), dtype=torch.int32)
    slots = np.zeros((n, 8, 4), np.int64)
    done = np.zeros(n, np.int64)

    def nbr(mb, d):
        rr, cc = r[mb] + d[0], c[mb] + d[1]
        return rr * wmb + cc if rr >= 0 and 0 <= cc < wmb else None

    # per neighbour: its raster index (-1 outside the frame) and the
    # progress it must have reached before each step 0..10
    waits = [(np.array([-1 if nbr(mb, d) is None else nbr(mb, d) for mb in range(n)]),
              np.array([need.get(t, 0) for t in range(11)])) for d, need in rule.items()]
    while (done < 10).any():
        ok = done < 10
        for idx, need in waits:
            ok &= (idx < 0) | (done[np.maximum(idx, 0)] >= need[done])
        ready = np.flatnonzero(ok).tolist()
        assert ready, "no MB can step: a deadlock"
        pick = [mb for mb in ready if rng.random() < p] or [ready[0]]
        for mb in pick:
            t = done[mb]
            for ts, d, k, cell in _READS:
                m = nbr(mb, d)
                if ts != t or m is None:
                    continue
                v = torch.from_numpy(slots[m, k])
                if cell[0] == "corner":
                    ext[mb, 0, 0] = v[3]
                elif cell[0] == "col":
                    ext[mb, cell[1]:cell[1] + 4, 0] = v
                else:
                    ext[mb, 0, cell[1]:cell[1] + 4] = v
        for t in sorted({int(done[mb]) for mb in pick}):
            mbs = torch.tensor([mb for mb in pick if done[mb] == t])
            e, lv = ext[mbs], levels[mbs]
            _i4x4_step(e, lv, t, src[mbs], modes[mbs], tr_ok[mbs], qp)
            ext[mbs], levels[mbs] = e, lv
            for k in _PUBLISH.get(t, ()):
                for mb in mbs.tolist():
                    slots[mb, k] = [int(ext[mb, a, b]) for a, b in _slot_cells(k)]
        done[pick] += 1
    rec = ext[:, 1:, 1:17].reshape(hmb, wmb, 16, 16).permute(0, 2, 1, 3).reshape(h, w)
    return rec.to(torch.uint8), levels, i4x4_luma_plain(y, modes, qp)


def test_k4x4_slot_reads_follow_the_rule():
    """The slots each step reads are published by the steps the progress
    rule waits for: slot s published after step p needs progress p + 1,
    and the rule asks for no more than the largest such need."""
    published = {k: t + 1 for t, ks in _PUBLISH.items() for k in ks}
    assert sorted(published) == list(range(8))
    for d, need in _RULE.items():
        for t, progress in need.items():
            reads = [published[k] for ts, dd, k, _ in _READS if ts == t and dd == d]
            assert reads and max(reads) == progress, (d, t)
    assert {(ts, dd) for ts, dd, _, _ in _READS} == {
        (t, d) for d, need in _RULE.items() for t in need}


def test_k4x4_slot_tables_match_the_kernel_source():
    """_READS and _PUBLISH are what csrc/wavefront_i4x4.cu does: its
    __constant__ kFrom / kSlot / kNeed / kCell arrays, the publish(who,
    slot) calls of EdgeHook::after per step, and the steps its
    EdgeHook::before skips as reading no new slot."""
    src = (Path(dataflow.__file__).parent / "csrc" / "wavefront_i4x4.cu").read_text()
    arrays = {name: [int(v) for v in body.split(",")] for name, body in re.findall(
        r"__constant__ int (k\w+)\[kReads\] = \{([^}]*)\};", src)}
    nbr = {0: (0, -1), 1: (-1, 0), 2: (-1, 1), 3: (-1, -1)}
    reads = []
    for frm, slot, need, cell in zip(*(arrays[k] for k in ("kFrom", "kSlot", "kNeed", "kCell"))):
        first = ("corner",) if frm == 3 else ("col" if frm == 0 else "row", cell)
        reads.append((need, nbr[frm], slot, first))
    assert reads == _READS
    after = src[src.index("void after(int t) const {"):]
    after = after[:after.index("\n  }\n")]
    published = {}
    for t, body in re.findall(r"if \(t == (\d+)\) (\{[^}]*\}|publish\([^;]*\);)", after):
        published[int(t)] = tuple(int(k) for k in re.findall(r"publish\(\d+, (\d+)\)", body))
    assert published == _PUBLISH
    skip = re.search(r"if \(t == (\d+) \|\| t > (\d+)\) return;", src)
    reading = {t for t, _, _, _ in _READS}
    assert {int(skip[1])} | set(range(int(skip[2]) + 1, 10)) == set(range(10)) - reading


@pytest.mark.parametrize("wh", [(176, 144), (64, 208), (16, 176), (176, 16)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_k4x4_step_model_equals_plain(wh):
    """MBs stepping under the progress rule, in random rounds, reading
    their neighbours' edges only through the slots: i4x4_luma_plain's
    recon and levels, random modes in every block."""
    w, h = wh
    rec, lv, (want_rec, want_lv) = _k4x4_steps_model(w, h, 28, p=0.6, seed=1)
    assert torch.equal(rec, want_rec)
    assert torch.equal(lv, want_lv)


@pytest.mark.parametrize("d", [(0, -1), (-1, 0), (-1, 1)], ids=["left", "top", "top-right"])
def test_k4x4_step_model_needs_each_wait(d):
    """Waiting one step less on the left, top or top-right MB reads a slot
    before it is published, and in some random rounds the frame differs
    from i4x4_luma_plain on QCIF or 64x208."""
    rule = {k: {t: v - (k == d) for t, v in need.items()} for k, need in _RULE.items()}
    for seed in range(4):
        for w, h in ((64, 208), (176, 144)):
            rec, lv, (want_rec, want_lv) = _k4x4_steps_model(w, h, 28, rule, 0.5, seed)
            if not (torch.equal(rec, want_rec) and torch.equal(lv, want_lv)):
                return
    raise AssertionError(f"the mutant that waits one step less on {d} went unseen")


def test_k4x4_top_left_wait_is_implied():
    """Waiting one step less on the top-left MB changes nothing, in any
    random rounds: the top MB
    waited at its step 6 for its left MB, the top-left, to finish, and the
    rule waits for the top MB's step 8. The kernel polls the top-left's
    slot all the same: it reads the slot with relaxed loads that no fence
    orders after the top MB's, so the poll is what makes the value visible
    to it."""
    rule = dict(_RULE)
    rule[(-1, -1)] = {0: 9}
    rec, lv, (want_rec, want_lv) = _k4x4_steps_model(64, 208, 28, rule, 0.5)
    assert torch.equal(rec, want_rec) and torch.equal(lv, want_lv)
