"""K2 (the integer full search) without the card: a numpy model of the CUDA
kernel's tiles and threads (csrc/me_int.cu), held to integer_score_map_plain
in both forms (the block-order map; the P frame's map in MB-quadrant order
and argmin); the plain twin's P-frame form held to blocks_to_mbq and
argmin; the wrapper's routes, refusals and launch arguments against the C
entry point.

tests/test_torch_pframe.py holds integer_score_map_plain to the JAX
package (its XLA twin and the Pallas kernel in interpret mode); the kernel
is held to the plain twin on the card by chip_smoke.py. No JAX here."""

import numpy as np
import pytest
import torch

from h264_fer_tpu_torch.kernels import build, me_int
from h264_fer_tpu_torch.ops.interp import edge_pad
from h264_fer_tpu_torch.ops.tiles import blocks_to_mbq

torch.set_num_threads(1)

# csrc/me_int.cu: shift rows a thread keeps in flight, a tile's MB columns,
# threads a block along dx (two columns each), shared memory a block may
# have
KC, TILE_MBS, MAX_NX, SMEM = 17, 8, 9, 232448
U32, U64 = np.uint32, np.uint64
SHIFTS = np.array([0, 8, 16, 24], U32)


def _bytes(w):
    return ((w[..., None] >> SHIFTS) & U32(0xFF)).astype(np.int64)


def funnel(lo, hi, sh):
    """__funnelshift_rc(lo, hi, sh): the low word of (hi:lo) >> min(sh, 32)
    (__funnelshift_r where sh < 32)."""
    sh = np.minimum(np.asarray(sh), 32).astype(U64)
    return ((((hi.astype(U64) << U64(32)) | lo.astype(U64)) >> sh)
            & U64(0xFFFFFFFF)).astype(U32)


def sad4(a, b, acc):
    """vabsdiff4.u32.u32.u32.add: acc plus the 4 bytes' absolute differences."""
    return (acc + np.abs(_bytes(a) - _bytes(b)).sum(-1)).astype(U32)


def dp4a(a, b, acc):
    """__dp4a on unsigned words: acc plus the 4 bytes' products, mod 2^32."""
    return ((acc.astype(np.int64) + (_bytes(a) * _bytes(b)).sum(-1)) & 0xFFFFFFFF).astype(U32)


def geometry(w, h, ext, window):
    """The host side of the launch (launch_shape, layout_of): the widest
    tile tk whose shared memory fits (the map rows, two landed windows and
    sources, the aligned window), words an aligned window row pw and a
    landed one pwr, window rows, threads along dx, tiles and block size."""
    S = 2 * window + 1
    nx = min((S + 1) // 2, MAX_NX)
    rows = 16 + -(-S // KC) * KC - 1
    tk = TILE_MBS
    while True:
        pw = (16 * tk + S - 9) // 4 + 3
        pwr = (pw + 2) & ~1
        words = 4 * tk * S * S + 2 * (rows * pwr + 16 * 4 * tk) + rows * pw
        assert 2 * 4 * tk * nx <= rows * pwr  # the candidates fit in a landed window
        if 4 * words <= SMEM:
            break
        assert tk > 1
        tk //= 2
    wb, hb = w // 8, h // 8
    wmbc = (wb + 1) // 2
    return dict(S=S, nx=nx, rows=rows, tk=tk, pw=pw, pwr=pwr, tiles_x=-(-wmbc // tk),
                tiles_y=(hb + 1) // 2, threads=-(-4 * tk * nx // 32) * 32)


def slot_block(slot, k, mbq):
    """(qy, jx) of a tile slot: MB-quadrant or block-row order."""
    if mbq:
        q = slot & 3
        return q >> 1, 2 * (slot >> 2) + (q & 1)
    return slot // (2 * k), slot % (2 * k)


def block_argmin(cand):
    """A block's index from its nx threads' (least score, index) pairs
    (n, nx, 2), in thread order: the lower index on ties."""
    m = cand[:, 0].copy()
    for x in range(1, cand.shape[1]):
        c = cand[:, x]
        take = (c[:, 0] < m[:, 0]) | ((c[:, 0] == m[:, 0]) & (c[:, 1] < m[:, 1]))
        m[take] = c[take]
    return m[:, 1]


def k2_model(src, plane, ext, window, metric, mbq):
    """The kernel's launch in numpy, every CTA and thread at once: (map rows
    (nb, S*S) in the launch's order, the index (nb,)), asserting that every
    map entry and index is written exactly once and that no thread reads
    past its tile's staged window."""
    h, w = src.shape
    he, we = plane.shape
    g = geometry(w, h, ext, window)
    S, nx, tk, pw, rows = g["S"], g["nx"], g["tk"], g["pw"], g["rows"]
    S2 = S * S
    wb, hb = w // 8, h // 8
    wmbc = (wb + 1) // 2
    assert (he * we) % 4 == 0  # (H + 2 ext)(W + 2 ext): H and W are multiples of 8
    pwords = np.ascontiguousarray(plane).reshape(-1).view("<u4")
    swords = np.ascontiguousarray(src).reshape(-1).view("<u4")
    last = len(pwords) - 1
    # the tiles (MB row, first MB column, MB columns), whichever CTA of the
    # persistent grid takes each
    cta = np.arange(g["tiles_x"] * g["tiles_y"])[:, None]
    r, c0 = cta // g["tiles_x"], (cta % g["tiles_x"]) * tk
    k = np.minimum(tk, wmbc - c0)
    # the window lands as each row's aligned words from its first byte down
    # (clamped to the plane's last word, zeros past its last row), then is
    # funnel-shifted to the first byte
    pwr = g["pwr"]
    y0, x0 = 16 * r + ext - window, 16 * c0 + ext - window
    e = np.arange(rows * pwr)[None]
    gy = y0 + e // pwr
    raw = np.where(gy < he, pwords[np.minimum(((gy * we + x0) >> 2) + e % pwr, last)], 0)
    e = np.arange(rows * pw)[None]
    rr, wi = e // pw, e % pw
    a = ((y0 + rr) * we + x0) & 3
    s_ref = funnel(np.take_along_axis(raw, rr * pwr + wi, 1),
                   np.take_along_axis(raw, rr * pwr + wi + 1, 1), 8 * a)
    spw = 4 * tk
    e = np.arange(16 * spw)[None]
    gy, gx = 16 * r + e // spw, 16 * c0 + 4 * (e % spw)
    s_src = np.where((gy < h) & (gx < w),
                     swords[np.minimum((gy * w + gx) >> 2, len(swords) - 1)], 0).astype(U32)
    s_out = np.full((len(cta), 4 * tk * S2), -1, np.int64)
    # the threads (slot, xl) of each tile's valid blocks
    t = np.arange(g["threads"])[None]
    slot, xl = t // nx, t % nx
    qy, jx = slot_block(slot, k, mbq)
    keep = (slot < 4 * k) & (2 * c0 + jx < wb) & (2 * r + qy < hb)
    ci = np.broadcast_to(cta, keep.shape)[keep]
    slot, xl, qy, jx = (np.broadcast_to(v, keep.shape)[keep] for v in (slot, xl, qy, jx))
    sw = np.stack([s_src[ci, (qy * 8 + i) * spw + 2 * jx + p] for i in range(8) for p in (0, 1)])
    ssq = np.zeros(len(ci), U32)
    for j in range(16):
        ssq = dp4a(sw[j], sw[j], ssq)
    big = np.iinfo(np.int64).max
    best, bi = np.full(len(ci), big), np.full(len(ci), big)
    for dx0 in range(0, S, 2 * nx):  # the thread's column pairs dx, dx + 1
        dx = 2 * xl + dx0
        on = dx < S
        col = 8 * jx + dx
        fs = 8 * (col & 3)
        for cy in range(0, S, KC):
            base = (qy * 8 + cy) * pw + (col >> 2)
            acc = np.zeros((2, KC, len(ci)), U32)
            cum = [[np.zeros(len(ci), U32)] for _ in (0, 1)]
            for rrow in range(KC + 7):
                p = base + rrow * pw
                assert (p[on] + 2 < rows * pw).all()
                w0, w1, w2 = (s_ref[ci, np.minimum(p + q, rows * pw - 1)] for q in range(3))
                for c in (0, 1):  # column dx + c, a byte later; at shift 32: w1, w2
                    r0, r1 = funnel(w0, w1, fs + 8 * c), funnel(w1, w2, fs + 8 * c)
                    if metric:
                        cum[c].append(dp4a(r1, r1, dp4a(r0, r0, cum[c][-1])))
                    for i in range(max(0, rrow - KC + 1), min(8, rrow + 1)):
                        d = rrow - i
                        op = sad4 if metric == 0 else dp4a
                        acc[c, d] = op(r1, sw[2 * i + 1], op(r0, sw[2 * i], acc[c, d]))
                if rrow >= 7:
                    d = rrow - 7
                    for c in (0, 1):
                        v = acc[c, d].astype(np.int64)
                        if metric:
                            v = (ssq.astype(np.int64) + cum[c][rrow + 1] - cum[c][d]
                                 - 2 * v) & 0xFFFFFFFF
                            v = v * metric  # 2*SSD doubles
                        put = on & (cy + d < S) & (dx + c < S)
                        q = (cy + d) * S + dx + c
                        at = (ci[put], slot[put] * S2 + q[put])
                        assert (s_out[at] == -1).all()
                        s_out[at] = v[put]
                        take = put & ((v < best) | ((v == best) & (q < bi)))
                        best, bi = np.where(take, v, best), np.where(take, q, bi)
    # the argmin: a block's first least over its nx threads' candidates
    cand = np.full((len(cta), g["threads"], 2), big)
    cand[ci, slot * nx + xl] = np.stack([best, bi], -1)
    sl = np.arange(4 * tk)[None]
    qy, jx = slot_block(sl, k, mbq)
    bx, by = 2 * c0 + jx, 2 * r + qy
    ok = (sl < 4 * k) & (bx < wb) & (by < hb)
    idx = np.full(wb * hb, -1, np.int64)
    at = (by * wb + bx)[ok]
    assert len(np.unique(at)) == len(at) == wb * hb
    per_slot = cand[:, :4 * tk * nx].reshape(len(cta), 4 * tk, nx, 2)
    idx[at] = block_argmin(per_slot[ok])
    # the tile's rows, whole: one run a tile, or one a block row
    out = np.zeros(wb * hb * S2, np.int64)
    written = np.zeros(wb * hb * S2, np.int64)
    for n in range(len(cta)):
        rn, cn, kn = int(r[n, 0]), int(c0[n, 0]), int(k[n, 0])
        runs = ([(0, 4 * kn, 4 * (rn * wmbc + cn))] if mbq else
                [(q * 2 * kn, min(2 * kn, wb - 2 * cn), (2 * rn + q) * wb + 2 * cn)
                 for q in (0, 1) if 2 * rn + q < hb])
        for s0, m, g0 in runs:
            out[g0 * S2: (g0 + m) * S2] = s_out[n, s0 * S2: (s0 + m) * S2]
            written[g0 * S2: (g0 + m) * S2] += 1
    assert (written == 1).all()
    return out.reshape(wb * hb, S2), idx


def _frame(w, h, ext, seed, flat=False):
    """(src (h, w), plane0 (h + 2 ext, w + 2 ext)) uint8: src a moved,
    noisy copy of the reference, plane0 the reference edge-extended."""
    rng = np.random.default_rng(seed)
    if flat:
        ref = np.full((h, w), 77, np.uint8)
        return ref.copy(), edge_pad(torch.from_numpy(ref), ext).numpy()
    yy, xx = np.mgrid[0:h, 0:w]
    ref = ((xx * 3 + yy * 7) % 256 ^ rng.integers(0, 64, (h, w))).astype(np.uint8)
    src = np.clip(np.roll(ref, (2, -3), (0, 1)).astype(np.int64)
                  + rng.integers(-5, 6, (h, w)), 0, 255).astype(np.uint8)
    src[:8, :8] = 255  # extreme bytes against the plane's 0..255
    src[8:16, :8] = 0
    return src, edge_pad(torch.from_numpy(ref), ext).numpy()


# (w, h, ext, window, flat): QCIF (22 blocks a row: one tile and a tail of
# 3 MBs) at the P frame's ext 10; a band of 3 MB rows at window 7 / ext 9
# (plane pitch 194, 2 mod 4); full_search_topk's ext = window; window 0;
# a flat frame where every shift of every block ties; an odd block grid
# (5 x 3 blocks) in block order
CASES = {"qcif-ext10": (176, 144, 10, 8, False), "band-w7-ext9": (176, 48, 9, 7, False),
         "ext-eq-window": (176, 144, 8, 8, False), "window0": (48, 32, 2, 0, False),
         "flat-ties": (176, 48, 10, 8, True), "odd-grid": (40, 24, 6, 4, False)}


@pytest.mark.parametrize("case", list(CASES))
def test_k2_model_equals_the_plain_twin(case):
    """Every metric, in both row orders (MB-quadrant order where the grid is
    of whole MBs): the model's map rows equal the plain twin's in that
    order, and the model's index (which the kernel writes in either order)
    the plain twin's first least shift (flat: index 0 everywhere)."""
    w, h, ext, window, flat = CASES[case]
    src, plane = _frame(w, h, ext, list(CASES).index(case), flat)
    st, pt = torch.from_numpy(src), torch.from_numpy(plane)
    orders = (False, True) if w % 16 == 0 and h % 16 == 0 else (False,)
    for metric in (0, 1, 2):
        blk = me_int.integer_score_map_plain(st, pt, ext, window, metric)
        want_idx = blk.argmin(dim=1)
        for mbq in orders:
            want = (me_int.integer_score_map_plain(st, pt, ext, window, metric, True)[0]
                    if mbq else blk)
            got, idx = k2_model(src, plane, ext, window, metric, mbq)
            np.testing.assert_array_equal(got, want.numpy(), err_msg=f"{case} m{metric} {mbq}")
            np.testing.assert_array_equal(idx, want_idx.numpy())
    if flat:
        assert (want_idx == 0).all()


def test_staged_words_are_the_plane_bytes_at_every_alignment():
    """A staged reference row, aligned words funnel-shifted, holds the plane
    row's bytes from any first column (every value mod 4), up to the
    plane's last word; a thread's 8 bytes at column c, three staged words
    funnel-shifted by 8 (c & 3), are bytes c .. c + 7."""
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 256, 4 * 64, dtype=np.uint8)
    words = buf.view("<u4")
    for start in range(0, 4 * 64 - 8):
        a = start + 4 * np.arange((4 * 64 - start) // 4)
        got = funnel(words[np.minimum(a >> 2, 63)], words[np.minimum((a >> 2) + 1, 63)],
                     8 * (a & 3))
        want = buf[start: start + 4 * len(a)].view("<u4")
        n = len(a) - (1 if start % 4 else 0)  # the last word: clamped past the buffer
        np.testing.assert_array_equal(got[:n], want[:n])
    row = buf[:64].view("<u4")
    for c in range(64 - 12):
        w0, w1, w2 = (row[(c >> 2) + q: (c >> 2) + q + 1] for q in range(3))
        sh = np.array([8 * (c & 3)])
        got = np.concatenate([funnel(w0, w1, sh), funnel(w1, w2, sh)]).view(np.uint8)
        np.testing.assert_array_equal(got, buf[c: c + 8])


def test_packed_distortion_equals_the_scalar_sums():
    """vabsdiff4 with accumulate gives the SAD and the dp4a identity
    sum r^2 + sum s^2 - 2 sum r s the SSD of 8-sample rows, on random
    and extreme (0, 255) bytes, exactly; 64 rows of 255 against 0 fit."""
    rng = np.random.default_rng(9)
    r = rng.integers(0, 256, (4000, 8), dtype=np.uint8)
    s = rng.integers(0, 256, (4000, 8), dtype=np.uint8)
    r[:1000], s[:1000] = 255, 0
    rw, sw = r.view("<u4"), s.view("<u4")
    z = np.zeros(len(r), U32)
    sad = sad4(rw[:, 1], sw[:, 1], sad4(rw[:, 0], sw[:, 0], z))
    d = r.astype(np.int64) - s.astype(np.int64)
    np.testing.assert_array_equal(sad, np.abs(d).sum(1))
    cross = dp4a(rw[:, 1], sw[:, 1], dp4a(rw[:, 0], sw[:, 0], z)).astype(np.int64)
    rsq = dp4a(rw[:, 1], rw[:, 1], dp4a(rw[:, 0], rw[:, 0], z)).astype(np.int64)
    ssq = dp4a(sw[:, 1], sw[:, 1], dp4a(sw[:, 0], sw[:, 0], z)).astype(np.int64)
    np.testing.assert_array_equal(rsq + ssq - 2 * cross, (d * d).sum(1))
    assert 2 * 64 * 255 ** 2 < 2 ** 31 and 64 * 255 ** 2 * 2 < 2 ** 32


def test_plain_twin_composes_the_map_order_and_argmin():
    """integer_score_map_plain's P-frame form is the block-order map's rows
    through blocks_to_mbq and its argmin (dim 1), first index on ties: the
    glue the kernel's one launch replaces."""
    src, plane = _frame(96, 64, 10, 3)
    st, pt = torch.from_numpy(src), torch.from_numpy(plane)
    for metric in (0, 1, 2):
        blk = me_int.integer_score_map_plain(st, pt, 10, 8, metric)
        m, idx = me_int.integer_score_map_plain(st, pt, 10, 8, metric, p_frame=True)
        assert m.shape == blk.shape and m.is_contiguous() and idx.dtype == torch.int32
        assert torch.equal(m.view(24, 4, -1), blocks_to_mbq(blk, 6, 4))
        assert torch.equal(idx, blk.argmin(dim=1).to(torch.int32))
    tied = torch.zeros((6, 9), dtype=torch.int32)
    tied[:, 4] = -1
    tied[:, 7] = -1
    assert (tied.argmin(dim=1) == 4).all()  # torch.argmin's tie order, as the kernel's


def test_cpu_routes_to_the_plain_twin_and_the_wrapper_refuses(monkeypatch):
    """CPU tensors take the plain twin in every form, launching nothing; a
    tensor on another device raises; past the route, a wrong shape, dtype,
    layout, alignment, window or metric raises ValueError before any
    build, and a build that fails raises."""
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("a kernel launched"))
    src, plane = (torch.from_numpy(a) for a in _frame(48, 32, 4, 7))
    before = me_int.integer_score_map.launches
    assert torch.equal(me_int.integer_score_map(src, plane, 4, 3, 1),
                       me_int.integer_score_map_plain(src, plane, 4, 3, 1))
    for g, w_ in zip(me_int.integer_score_map(src, plane, 4, 3, 1, p_frame=True),
                     me_int.integer_score_map_plain(src, plane, 4, 3, 1, p_frame=True)):
        assert torch.equal(g, w_)
    assert me_int.integer_score_map.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        me_int.integer_score_map(src.to("meta"), plane.to("meta"), 4, 3, 0)
    monkeypatch.undo()
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("a kernel built"))
    odd = torch.zeros((24, 40), dtype=torch.uint8)
    shifted = torch.zeros(src.numel() + plane.numel() + 8, dtype=torch.uint8)
    src_off = shifted[1: 1 + src.numel()].view(src.shape)  # contiguous, 1 byte off
    plane_off = shifted[2: 2 + plane.numel()].view(plane.shape)
    for bad in [(src.to(torch.int32), plane, 4, 3, 0, False), (src, plane[:, 1:], 4, 3, 0, False),
                (src.t(), plane, 4, 3, 0, False), (src[None], plane, 4, 3, 0, False),
                (src, plane.to(torch.int16), 4, 3, 0, False), (src, plane, 4, 5, 0, False),
                (src, plane, 4, -1, 0, False), (src, plane, 4, 3, 3, False),
                (odd, torch.zeros((32, 48), dtype=torch.uint8), 4, 1, 0, True),
                (src_off, plane, 4, 3, 0, False), (src, plane_off, 4, 3, 0, False)]:
        with pytest.raises(ValueError):
            me_int.launch(*bad)
    monkeypatch.undo()

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(build, "nvcc", no_nvcc)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_bound", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        me_int.launch(src, plane, 4, 3, 0, True)


def test_launch_arguments_match_the_c_entry_point(monkeypatch):
    """With the launch stubbed, so that CPU tensors get as far as it: one
    argument for each C parameter before the stream, in order; the map
    (nb, S*S) and the index (nb,) int32, or a null index."""
    calls = []
    monkeypatch.setattr(build, "launch", lambda *a: calls.append(a))
    text = (build.CSRC / "me_int.cu").read_text()
    sig = text[text.index('extern "C" int me_int_score_map('):]
    params = [p.split()[-1].lstrip("*")
              for p in sig[sig.index("(") + 1: sig.index(")")].split(",")]
    assert params[-2:] == ["stream", "launched"]
    src, plane = (torch.from_numpy(a) for a in _frame(48, 32, 4, 7))
    for p_frame in (False, True):
        got = me_int.launch(src, plane, 4, 3, 2, p_frame)
        fn, name, symbol, args, dev = calls.pop()
        assert (fn, name, symbol, dev) == (me_int.integer_score_map, "me_int",
                                           "me_int_score_map", src.device)
        assert len(args) == len(params) - 2
        named = dict(zip(params, args))
        assert named["src"] is src and named["plane"] is plane
        out, idx = got if p_frame else (got, None)
        assert named["out"] is out and named["idx"] is idx
        assert out.shape == (24, 49) and out.dtype == torch.int32
        assert idx is None or (idx.shape == (24,) and idx.dtype == torch.int32)
        assert (named["W"], named["H"], named["ext"], named["window"], named["metric"],
                named["mbq"]) == (48, 32, 4, 3, 2, int(p_frame))
