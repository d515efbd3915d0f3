"""The device full search with top-K candidates (ops/me.py: K2 with metric 0,
then K9, kernels/me_topk.py) against h264_fer_tpu.ops.me.full_search_topk,
on the CPU: the same candidates in the same order, ties included, on
correlated, flat, periodic and tall content at window 8 / topk 16 and
window 4 / topk 4 (one JAX compile per frame size and setting); K9's plain
twin against a stable numpy argsort; a numpy model of the K9 kernel's warp
(keys in lanes, rounds of the least key not below the last winner, the
two-stage warp minimum, the stores every 32 rounds) against the twin; the
interpolated planes' plane 0 against the padded reference; the wrappers'
refusals."""

import numpy as np
import pytest
import torch

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


def _k9_warp_model(m: np.ndarray, window: int, topk: int, nk: int):
    """csrc/me_topk.cu's warp for each row of m, in numpy: lane l holds the
    keys of shifts l + 32 k (k < nk; nk 0 re-reads the row every round),
    key = (score ^ 2^31) << 32 | shift; round r takes the least key not
    below lo as the minimum of the high halves, then of the low halves of
    the lanes holding that high half; lane r % 32 keeps the result and the
    lanes store every 32 rounds. Returns (3, nb, topk) and the set of
    (row, slot) stores."""
    nb, ss = m.shape
    s = 2 * window + 1
    full = np.uint64(0xFFFFFFFFFFFFFFFF)
    out = np.zeros((3, nb, topk), np.int64)
    stored = set()
    lanes = np.arange(32)
    for b in range(nb):
        width = nk if nk else (ss + 31) // 32
        idx = lanes[:, None] + 32 * np.arange(width)[None, :]  # (32, width)
        score = m[b, np.minimum(idx, ss - 1)].astype(np.int64)
        key = (((score.astype(np.uint64) & np.uint64(0xFFFFFFFF)) ^ np.uint64(0x80000000))
               << np.uint64(32)) | idx.astype(np.uint64)
        key = np.where(idx < ss, key, full)
        lo = np.uint64(0)
        held = np.zeros((3, 32), np.int64)
        for r in range(topk):
            best = np.where(key >= lo, key, full).min(axis=1)  # lane-local, (32,)
            hi = (best >> np.uint64(32)).min()
            low = np.where(best >> np.uint64(32) == hi, best & np.uint64(0xFFFFFFFF),
                           np.uint64(0xFFFFFFFF)).min()
            lane, shift = r & 31, int(low)
            held[:, lane] = (np.int64(np.uint32(hi) ^ np.uint32(0x80000000)).astype(np.int32),
                             (shift % s - window) * 4, (shift // s - window) * 4)
            if lane == 31 or r == topk - 1:
                for ln in range(lane + 1):
                    out[:, b, (r & ~31) + ln] = held[:, ln]
                    stored.add((b, (r & ~31) + ln))
            lo = ((hi << np.uint64(32)) | low) + np.uint64(1)
    return out, stored


@pytest.mark.parametrize("window,topk,nk", [(4, 4, 4), (8, 16, 10), (8, 40, 10), (8, 289, 10),
                                            (5, 7, 4), (16, 33, 36), (17, 16, 0)])
def test_k9_warp_model_equals_plain(window, topk, nk):
    """The kernel's selection and stores, modelled in numpy, give the plain
    twin's candidates and write every slot once, on maps with wide and
    narrow value ranges, negative scores and the int32 extremes."""
    s = 2 * window + 1
    assert nk == 0 or (s * s + 31) // 32 <= nk  # the instance me_topk_select picks
    rng = np.random.default_rng(topk + nk)
    m = np.concatenate([rng.integers(0, 16321, (3, s * s)), rng.integers(-2, 3, (3, s * s)),
                        rng.choice([-2**31, 2**31 - 1, 0], (2, s * s))]).astype(np.int32)
    got, stored = _k9_warp_model(m, window, topk, nk)
    want = topk_candidates_plain(torch.from_numpy(m), window, topk)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x.numpy())
    assert stored == {(b, k) for b in range(len(m)) for k in range(topk)}


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
