"""The one-launch dataflow schedule of K4 and K6 (kernels/dataflow.py,
csrc/mb_dataflow.cuh) and the diagonal schedule of the Intra_4x4 MB body
(csrc/intra4x4.cuh), on the CPU.

The kernels hand out MBs by ticket in `knight_order` and make each wait for
its left, top, top-right and top-left neighbours. Here: the order is a
permutation in which every such neighbour comes first, it is the order of
the waves the plain twins iterate over, a grid of any size finishes under
it, and coding an MB's 4x4 blocks as the kernel does (10 steps t = i + 2j,
two blocks at once, each sample predicted from three cells through the
packed Intra4x4 table) gives i4x4_mb_code's result. The kernels themselves are held
against the plain twins on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from h264_fer_tpu_torch.kernels import dataflow, wavefront_mixed, wavefront_p
from h264_fer_tpu_torch.kernels.wavefront_i4x4 import i4x4_mb_code, knight_waves
from h264_fer_tpu_torch.ops import intra, transform

torch.set_num_threads(1)

GRIDS = [(1, 1), (1, 9), (11, 1), (4, 13), (11, 9), (120, 68)]  # (wmb, hmb)
NEIGHBOURS = ((0, -1), (-1, 0), (-1, 1), (-1, -1))  # left, top, top-right, top-left


def _ids(grid):
    return f"{grid[0]}x{grid[1]}"


def _deps(wmb, hmb, mb):
    """Raster indices of the existing neighbours MB mb waits on."""
    r, c = divmod(mb, wmb)
    return [(r + dr) * wmb + c + dc for dr, dc in NEIGHBOURS
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


@pytest.mark.parametrize("blocks", [1, 3, 61, None])
@pytest.mark.parametrize("grid", [(11, 9), (120, 68)], ids=_ids)
def test_any_grid_size_finishes(grid, blocks):
    """The persistent grid as a game: `blocks` blocks (None: one per MB)
    hold a ticket each, taking the next one in order when they finish; at
    every turn one block whose MB has all its neighbours done, chosen at
    random, finishes it. Some block can always move until every MB is
    done: no deadlock."""
    wmb, hmb = grid
    nmb = wmb * hmb
    order = dataflow.knight_order(wmb, hmb).tolist()
    rng = np.random.default_rng(blocks)
    waits = [len(_deps(wmb, hmb, mb)) for mb in range(nmb)]
    waiters = [[] for _ in range(nmb)]
    for mb in range(nmb):
        for n in _deps(wmb, hmb, mb):
            waiters[n].append(mb)
    held = set(order[:nmb if blocks is None else blocks])
    nxt = len(held)
    ready = [mb for mb in held if waits[mb] == 0]
    done = 0
    while held:
        assert ready, f"deadlock with {len(held)} blocks waiting"
        k = int(rng.integers(len(ready)))
        ready[k], ready[-1] = ready[-1], ready[k]
        mb = ready.pop()
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
            if waits[new] == 0:
                ready.append(new)
    assert done == nmb


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


def _i4x4_in_steps(src, modes, nb, qp):
    """i4x4_mb_code's function as csrc/intra4x4.cuh computes it: the MB's
    reconstruction inside `ext` (row 0: corner, top row, top-right samples;
    column 0: left column; -1 where unavailable), step t coding the blocks
    (i, j) with i + 2j = t from ext as it stood before the step, each
    sample predicted from three ext cells through packed_mode_table (DC
    from its 8 samples)."""
    n = src.shape[0]
    table = torch.from_numpy(intra.packed_mode_table().astype(np.int64)).reshape(9, 16)
    ext = torch.full((n, 17, 21), -999, dtype=torch.int64)  # -999: not coded yet
    ext[:, 0, 0] = nb["corner"]
    ext[:, 0, 1:17] = nb["trow"]
    ext[:, 0, 17:21] = torch.where(nb["tr_ok"][:, None], nb["tr4"], -1)
    ext[:, 1:17, 0] = nb["lcol"]
    levels = torch.zeros((n, 16, 16), dtype=torch.int32)
    for t in range(10):
        coded = []
        for j in range(4):
            i = t - 2 * j
            if not 0 <= i <= 3:
                continue
            bx, by = 4 * i, 4 * j
            z = (j >> 1) * 8 + (i >> 1) * 4 + (j & 1) * 2 + (i & 1)
            e = ext[:, by:by + 5, :]  # e[:, 0, bx] is the block's corner
            m = modes[:, z].long()
            code = table[m]  # (n, 16)
            rep = (z in (3, 11)) | ((bx == 12) & ((by > 0) | ~nb["tr_ok"]))
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
