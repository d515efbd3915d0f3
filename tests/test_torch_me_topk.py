"""The device full search with top-K candidates (ops/me.py: K2 with metric 0,
then K9, kernels/me_topk.py) against h264_fer_tpu.ops.me.full_search_topk,
on the CPU: the same candidates in the same order, ties included, on
correlated, flat, periodic and tall content at window 8 / topk 16 and
window 4 / topk 4 (one JAX compile per frame size and setting); K9's plain
twin against a stable numpy argsort; a numpy model of the K9 kernel's warp
(the key form each row takes, each lane's sorting network, the pops of the
heads' warp minimum, the stores every 32 rounds; the re-read rounds of wide
maps) against the twin; the network against every 0-1 input; the 32-bit
keys' range limit; the interpolated planes' plane 0 against the padded
reference; the wrappers' refusals."""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from h264_fer_tpu.ops.me import TpuMePipeline as JaxTpuMePipeline
from h264_fer_tpu.ops.me import full_search_topk as jax_full_search_topk
from h264_fer_tpu_torch.kernels.me_int import integer_score_map
from h264_fer_tpu_torch.kernels.me_topk import topk_candidates, topk_candidates_plain
from h264_fer_tpu_torch.ops.interp import interpolated_planes
from h264_fer_tpu_torch.ops.me import TpuMePipeline, candidates, full_search_topk

torch.set_num_threads(1)

SETTINGS = [(8, 16), (4, 4)]  # (window, topk)


def _correlated(h, w, seed):
    """Random source, and a reference holding it shifted by (8, 8) (as
    tests/test_me.py builds it)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (h, w)).astype(np.int32)
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    ref[8:, 8:] = src[:-8, :-8]
    return src, ref


def _flat(h, w, seed):
    """Two flat planes: every shift of every block has the same SAD."""
    return np.full((h, w), 128, np.int32), np.full((h, w), 120 + seed % 5, np.int32)


def _periodic(h, w, seed):
    """A texture of period 4 in x and y and the same texture moved by one
    sample and lightly noised: many shifts tie."""
    yy, xx = np.mgrid[0:h, 0:w]
    tex = (xx % 4) * 40 + (yy % 4) * 20
    rng = np.random.default_rng(seed)
    ref = np.roll(tex, 1, axis=1) + (rng.random((h, w)) < 0.02)
    return tex.astype(np.int32), ref.astype(np.int32)


CONTENT = {"qcif-correlated": (144, 176, _correlated), "qcif-flat": (144, 176, _flat),
           "qcif-periodic": (144, 176, _periodic), "tall-64x208": (208, 64, _correlated)}


def _port(src, ref, window, topk):
    return [c.numpy() for c in full_search_topk(torch.from_numpy(src), torch.from_numpy(ref),
                                                window, topk)]


@pytest.mark.parametrize("window,topk", SETTINGS, ids=["w8-k16", "w4-k4"])
@pytest.mark.parametrize("case", list(CONTENT))
def test_full_search_topk_equals_jax(case, window, topk):
    h, w, make = CONTENT[case]
    src, ref = make(h, w, 11)
    want = [np.asarray(a) for a in jax_full_search_topk(src, ref, window=window, topk=topk)]
    got = _port(src, ref, window, topk)
    for name, g, x in zip(("sads", "mvx", "mvy"), got, want):
        assert g.dtype == np.int32 and g.shape == ((h // 8) * (w // 8), topk), name
        np.testing.assert_array_equal(g, x, err_msg=f"{case} {name}")
    if case == "qcif-flat":  # every SAD ties: the lowest shift indices in order
        s = 2 * window + 1
        np.testing.assert_array_equal(got[1][0], (np.arange(topk) % s - window) * 4)
        np.testing.assert_array_equal(got[2][0], (np.arange(topk) // s - window) * 4)


def test_session_wrapper_equals_jax():
    """TpuMePipeline's contract: numpy planes in (uint8 or int32), numpy
    int32 arrays out, equal to the JAX wrapper's."""
    src, ref = _correlated(144, 176, 5)
    want = JaxTpuMePipeline(window=8)(src, ref)
    got = TpuMePipeline(window=8, device="cpu")(src.astype(np.uint8), ref)
    for g, x in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.int32
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("window,topk,hi", [(0, 1, 3), (1, 9, 2), (4, 4, 3), (8, 16, 4),
                                            (8, 289, 2), (17, 40, 3)])
def test_plain_twin_is_a_stable_argsort(window, topk, hi):
    """Maps from a small value range (ties everywhere) and negative scores:
    the twin's candidates are numpy's stable argsort cut to topk, with the
    shifts as quarter-pel MVs."""
    s = 2 * window + 1
    rng = np.random.default_rng(window * 100 + topk)
    m = rng.integers(-hi, hi + 1, (37, s * s)).astype(np.int32)
    order = np.argsort(m, axis=1, kind="stable")[:, :topk]
    sads, mvx, mvy = (t.numpy() for t in topk_candidates(torch.from_numpy(m), window, topk))
    np.testing.assert_array_equal(sads, np.take_along_axis(m, order, axis=1))
    np.testing.assert_array_equal(mvx, (order % s - window) * 4)
    np.testing.assert_array_equal(mvy, (order // s - window) * 4)
    assert sads.dtype == mvx.dtype == mvy.dtype == np.int32


def _network(n: int):
    """csrc/me_topk.cu's sort_keys for n keys: Batcher's odd-even merge
    sort, the comparators (i, j), i < j, in the kernel's loop order."""
    out, lp = [], 0
    while (1 << lp) < n:
        p = 1 << lp
        for lk in range(lp, -1, -1):
            k = 1 << lk
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        out.append((i + j, i + j + k))
        lp += 1
    return out


def _key_form(score, idx, lo, hi, sbits):
    """The kernel's key form for a row of least score lo and largest hi:
    (32-bit?, keys of the (32, width) scores at shifts idx, the pad above
    every key, decode(key) -> (score, shift), the warp minimum of 32 lane
    keys)."""
    u64 = np.uint64
    if hi - lo <= 0xFFFFFFFF >> sbits:
        def decode(k):
            return lo + (int(k) >> sbits), int(k) & ((1 << sbits) - 1)

        return True, ((score - lo) << sbits | idx).astype(u64), u64(0xFFFFFFFF), decode, np.min

    def decode(k):  # the high half's sign bit flipped back, as an int32
        return int(np.uint32((int(k) >> 32) ^ 0x80000000).astype(np.int32)), int(k) & 0xFFFFFFFF

    def warp_min(keys):  # the high halves' minimum, then the low halves' of its lanes
        top = (keys >> u64(32)).min()
        return top << u64(32) | np.where(keys >> u64(32) == top, keys & u64(0xFFFFFFFF),
                                         u64(0xFFFFFFFF)).min()

    key = (((score & 0xFFFFFFFF) ^ 0x80000000).astype(u64) << u64(32)) | idx.astype(u64)
    return False, key, u64(0xFFFFFFFFFFFFFFFF), decode, warp_min


def _k9_warp_model(m: np.ndarray, window: int, topk: int, nk: int):
    """csrc/me_topk.cu's warp for each row of m, in numpy: lane l loads the
    scores of shifts l + 32 k (k < nk; nk 0 re-reads the row every round);
    the row's least and largest score choose the key form, 32 bits ((score
    - min) << sbits | shift) where the range fits in 32 - sbits bits, else
    64 ((score ^ 2^31) << 32 | shift, the warp minimum taken as the high
    halves', then the low halves' of the lanes holding it). Held keys: each
    lane sorts its keys by the kernel's network and keeps its least as its
    head, the rest and a pad in its list; round r takes the warp minimum of
    the heads and the one lane holding it takes its list's next key as its
    head. Re-read: round r takes the least key above the last winner.
    Round r's winner goes to won[r % 32]; every 32 rounds (and after the
    last) lane l decodes and stores won[l]. Returns ((3, nb, topk),
    {(row, slot): stores}, (nb,) 32-bit rows)."""
    nb, ss = m.shape
    s = 2 * window + 1
    sbits = (ss - 1).bit_length()
    out = np.zeros((3, nb, topk), np.int64)
    stores, narrow = collections.Counter(), np.zeros(nb, bool)
    width = nk if nk else (ss + 31) // 32
    idx = np.arange(32)[:, None] + 32 * np.arange(width)[None, :]  # (32, width)
    valid = idx < ss
    for b in range(nb):
        v = np.where(valid, m[b, np.minimum(idx, ss - 1)], 0).astype(np.int64)
        lo, hi = v[valid].min(), v[valid].max()  # the two reductions
        narrow[b], key, pad, decode, warp_min = _key_form(v, idx, lo, hi, sbits)
        key = np.where(valid, key, pad)
        if nk:
            for i, j in _network(nk):
                key[:, i], key[:, j] = (np.minimum(key[:, i], key[:, j]),
                                        np.maximum(key[:, i], key[:, j]))
            head, rest = key[:, 0].copy(), np.c_[key[:, 1:], np.full(32, pad)]
            taken = np.zeros(32, int)  # keys each lane took from its list
        last = np.uint64(0)
        for base in range(0, topk, 32):
            n = min(32, topk - base)
            won = [None] * 32
            for r in range(n):
                if nk:
                    won[r] = warp_min(head)
                    (lane,) = np.flatnonzero(head == won[r])  # unique keys: one lane
                    head[lane] = rest[lane, taken[lane]]
                    taken[lane] += 1
                else:
                    won[r] = warp_min(np.where(key >= last, key, pad).min(axis=1))
                    last = won[r] + np.uint64(1)
            for lane in range(n):
                sc, shift = decode(won[lane])
                out[:, b, base + lane] = sc, (shift % s - window) * 4, (shift // s - window) * 4
                stores[(b, base + lane)] += 1
    return out, stores, narrow


CASES = [(4, 4, 4), (8, 16, 10), (8, 40, 10), (8, 289, 10), (5, 7, 4), (16, 33, 36), (17, 16, 0),
         (0, 1, 4), (2, 25, 4), (8, 1, 10), (16, 16, 36), (17, 40, 0)]


def _k9_maps(window, rng):
    """Rows of wide and narrow value ranges, negative scores, the int32
    extremes and chip_smoke.k9_rows' adversarial rows."""
    ss = (2 * window + 1) ** 2
    return np.concatenate([rng.integers(0, 16321, (3, ss)), rng.integers(-2, 3, (3, ss)),
                           rng.choice([-2**31, 2**31 - 1, 0], (2, ss)),
                           chip_smoke.k9_rows(window, rng)]).astype(np.int32)


def _hold_model(window, topk, nk, seed):
    s = 2 * window + 1
    assert nk == 0 or (s * s + 31) // 32 <= nk  # the instance me_topk_select picks
    m = _k9_maps(window, np.random.default_rng(seed))
    got, stores, narrow = _k9_warp_model(m, window, topk, nk)
    want = topk_candidates_plain(torch.from_numpy(m), window, topk)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x.numpy())
    assert stores == {(b, k): 1 for b in range(len(m)) for k in range(topk)}
    np.testing.assert_array_equal(narrow, chip_smoke.k9_narrow_rows(m, window))
    assert narrow.all() if window == 0 else 0 < narrow.sum() < len(m)


@pytest.mark.parametrize("window,topk,nk", CASES)
def test_k9_warp_model_equals_plain(window, topk, nk):
    """The kernel's selection and stores, modelled in numpy with one warp
    per row, give the plain twin's candidates and write every slot once,
    on _k9_maps' rows (the 32-bit keys' range limit and a step above, rows
    of one value, the least scores in one lane's shifts among them); the
    model keys in 32 bits the rows chip_smoke.k9_narrow_rows names, and at
    every window but 0 rows take each form."""
    _hold_model(window, topk, nk, topk + nk)


@pytest.mark.parametrize("n,size", [(4, 5), (10, 32), (36, 268)])
def test_k9_network_sorts(n, size):
    """The kernel's network (its comparator count is the source's) sorts
    every 0-1 input of n keys (n <= 10) or random ones (n = 36: 0-1 inputs,
    permutations and keys with ties), which makes it a sorting network."""
    net = _network(n)
    assert len(net) == size and all(0 <= i < j < n for i, j in net)
    if n <= 10:
        keys = (np.arange(2**n)[:, None] >> np.arange(n)) & 1
    else:
        rng = np.random.default_rng(n)
        keys = np.concatenate([rng.integers(0, 2, (3000, n)), rng.integers(0, 5, (3000, n)),
                               np.argsort(rng.random((3000, n)), axis=1)])
    keys = keys.copy()
    for i, j in net:
        keys[:, i], keys[:, j] = (np.minimum(keys[:, i], keys[:, j]),
                                  np.maximum(keys[:, i], keys[:, j]))
    np.testing.assert_array_equal(keys, np.sort(keys, axis=1))


@pytest.mark.parametrize("window", [0, 4, 8, 16, 17])
def test_k9_key_form_limit(window):
    """chip_smoke.k9_narrow_rows: a row whose range is 2^(32 - sbits) - 1
    (sbits = ceil(log2(S*S))) packs into 32-bit keys, a step above does
    not, nor do the int32 extremes; rows of one value and SAD rows pack at
    any window."""
    ss = (2 * window + 1) ** 2
    lim = (1 << (32 - (ss - 1).bit_length())) - 1
    rows = [np.full(ss, -2**31), np.full(ss, 2**31 - 1), np.arange(ss) % 16321]
    if ss > 1:
        rows += [np.r_[-5, np.full(ss - 1, lim - 5)], np.r_[-5, np.full(ss - 1, lim - 4)],
                 np.r_[-2**31, np.full(ss - 1, 2**31 - 1)]]
    got = chip_smoke.k9_narrow_rows(np.stack(rows).astype(np.int32), window).tolist()
    assert got == [True] * 3 + ([True, False, False] if ss > 1 else [])
    assert window != 8 or lim == 2**23 - 1


@pytest.mark.parametrize("window,ext", [(8, 10), (8, 8), (4, 6)])
def test_plane0_reference_equals_padded_reference(window, ext):
    """The host P frame's route (plane 0 of its interpolated planes, edge-
    extended by window_size // 2 + 2) gives the padded reference's
    candidates; so does K2's map read from either."""
    src, ref = _correlated(144, 176, 3)
    src_t, ref_t = torch.from_numpy(src), torch.from_numpy(ref)
    plane0 = interpolated_planes(ref_t, ext)[0]
    via_planes = candidates(src_t.to(torch.uint8), plane0, ext, window, 16)
    for a, b in zip(via_planes, full_search_topk(src_t, ref_t, window, 16)):
        assert torch.equal(a, b)
    padded = torch.from_numpy(np.pad(ref, window, mode="edge"))
    assert torch.equal(integer_score_map(src_t, plane0, ext, window, 0),
                       integer_score_map(src_t, padded, window, window, 0))


def test_wrappers_refuse_bad_arguments():
    m = torch.zeros((4, 289), dtype=torch.int32)
    for topk in (0, 290):
        with pytest.raises(ValueError, match="topk"):
            topk_candidates(m, 8, topk)
    with pytest.raises(ValueError, match="score map"):
        topk_candidates(m, 4, 4)  # 289 columns are not window 4's 81
    with pytest.raises(ValueError, match="score map"):
        topk_candidates(m[0], 8, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        topk_candidates(m.to("meta"), 8, 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        full_search_topk(torch.zeros((20, 16), dtype=torch.int32),
                         torch.zeros((20, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        full_search_topk(torch.zeros((16, 16), dtype=torch.int32, device="meta"),
                         torch.zeros((16, 16), dtype=torch.int32, device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TpuMePipeline()
