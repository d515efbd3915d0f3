"""K12 (the P residual and recon) and K13 (the interpolated planes) without
the card: numpy models of the two CUDA kernels, held to the JAX package's
numpy planes (which compile nothing) and to the port's plain twins, and the
dispatchers and wrappers held to their routes, refusals and C signatures.

The kernels themselves are held to the plain twins on the card by
chip_smoke.py; tests/test_torch_pframe.py holds the twins to JAX."""

import numpy as np
import pytest
import torch

from h264_fer_tpu.ops.interp import _planes_impl_vext
from h264_fer_tpu.ops.interp import interpolated_planes as np_planes
from h264_fer_tpu_torch.codec import pframe
from h264_fer_tpu_torch.kernels import build, interp, residual_p
from h264_fer_tpu_torch.kernels.wavefront_i16 import qtab
from h264_fer_tpu_torch.ops import interp as ops_interp
from h264_fer_tpu_torch.ops.tables import ZIGZAG_FLAT
from h264_fer_tpu_torch.ops.transform import chroma_qp

torch.set_num_threads(1)

# ---- K13 -------------------------------------------------------------------
KSTRIP, KMAXWARPS = 120, 18  # csrc/interp.cu: a warp's strip, a block's warps
U32 = np.uint32
SHIFTS = np.array([0, 8, 16, 24], U32)


def _dp4a_us(a, taps: int, c):
    """dp4a.u32.s32: the bytes of the words a as unsigned samples times the
    bytes of `taps` as signed ints, plus c."""
    t = np.array([(taps >> int(k)) & 0xFF for k in SHIFTS], np.uint8).view(np.int8)
    return c + ((a[..., None] >> SHIFTS) & 0xFF).astype(np.int32) @ t.astype(np.int32)


def _pack(v):
    return (v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24).astype(U32)


def _tap6_h(w0, w1, w2):
    """interp.cu tap6_h: the clipped horizontal 6-tap of the positions x ..
    x + 3 whose samples x - 4 .. x + 7 are the bytes of w0, w1, w2."""
    v = [_dp4a_us(w1, 0x01FB1414, _dp4a_us(w0, 0xFB010000, 16)),
         _dp4a_us(w2, 0x00000001, _dp4a_us(w1, 0xFB1414FB, _dp4a_us(w0, 0x01000000, 16))),
         _dp4a_us(w2, 0x000001FB, _dp4a_us(w1, 0x1414FB01, 16)),
         _dp4a_us(w2, 0x0001FB14, _dp4a_us(w1, 0x14FB0100, 16))]
    return _pack([np.clip(x >> 5, 0, 255).astype(U32) for x in v])


def _tap6_v(r):
    """interp.cu tap6_v on uint32 words of two 16-bit lanes (rows r[0..5]),
    asserting that no lane carries or borrows."""
    lanes = [(w & 0xFFFF).astype(np.int64) for w in r], [(w >> 16).astype(np.int64) for w in r]
    for x in lanes:
        t = x[0] + x[5] + 20 * (x[2] + x[3]) + 2576 - 5 * (x[1] + x[4])
        assert (26 <= t).all() and (t <= 13286).all()
    t = (r[0] + r[5]) + U32(20) * (r[2] + r[3]) + (U32(0x0A100A10) - U32(5) * (r[1] + r[4]))
    v = (t >> U32(5)) & U32(0x07FF07FF)
    lo, hi = (np.clip(x, 80, 335) - 80 for x in (v & U32(0xFFFF), v >> U32(16)))
    return (lo | hi << U32(16)).astype(U32)


def _avg4(a, b):
    return (a | b) - (((a ^ b) & U32(0xFEFEFEFE)) >> U32(1))


def _funnel8(lo, hi):
    return ((lo >> U32(8)) | (hi << U32(24))).astype(U32)


def _k13_model(ref, ext: int, band: bool, grid: int = 7):
    """csrc/interp.cu's function on a grid of `grid` blocks (fewer where the
    planes have fewer rows), row by row as each block walks its rows,
    vectorised over the blocks, warps and lanes: each lane's packed
    reference word a row (the aligned words it reads where no column of the
    strip clamps, asserted inside the row), the SIMD vertical tap,
    dp4a.u32.s32 6-taps, the shuffles down (a lane past 31 keeps its own
    word), the byte averages and the stores of lanes 0-29 into the block's
    shared-memory row buffers (two, in turn); the carried bytes, the bulk
    copies (whole 32-byte sectors at addresses equal mod 32 in shared and
    global memory, the output's base taken as 32-byte aligned) and the
    bytes stored one by one, each output byte written once. Returns
    (planes, {shared-memory store width: count}); in the band form no row
    that feeds a stored position is clamped."""
    rows, w = ref.shape
    he, row_off = (rows - 8, 4) if band else (rows + 2 * ext, -ext)
    we = w + 2 * ext
    strips = -(-we // KSTRIP)
    assert strips <= KMAXWARPS and we >= 32
    plane = he * we
    stride = we + 63 + ((plane - (we + 63)) & 31)
    boff = (16 * stride + 31) & ~31
    grid = min(grid, he)
    yb = np.arange(grid) * he // grid
    ye = (np.arange(grid) + 1) * he // grid
    X0 = (np.arange(strips) * KSTRIP)[:, None]
    lane = np.arange(32)[None, :]
    x = X0 - 4 - ext + 4 * lane
    wide = (X0 - 4 - ext >= 0) & (X0 + 123 - ext <= w - 1) & (w % 4 == 0)
    X = np.broadcast_to(X0 + 4 * lane, x.shape)
    n = np.minimum(4, we - X)
    store = (lane < 30) & (n > 0)
    blk = np.arange(grid)[:, None, None]
    f16 = np.arange(16)[None, :, None]
    out = np.zeros(16 * plane, np.uint8)
    written = []
    stage = np.zeros((grid, 2 * boff), np.uint8)
    kinds = {32: 0, 16: 0, 8: 0}
    xa = x & ~3
    assert ((xa >= 0) & (xa + np.where(x & 3, 7, 3) <= w - 1) | ~wide).all()

    def row_word(Y):  # (grid,) rows → (grid, strips, 32) words
        ys = Y + row_off
        if band:  # rows past he + 2 feed no stored position
            assert ((0 <= ys) & (ys < rows) | (Y > he + 2)).all()
        y = np.clip(ys, 0, rows - 1)[:, None, None]
        return _pack([ref[y, np.clip(x + k, 0, w - 1)].astype(U32) for k in range(4)])

    def down(v, k):
        return np.where(lane + k < 32, np.take(v, np.minimum(lane[0] + k, 31), axis=-1), v)

    g = [row_word(yb - 2 + t) for t in range(6)]
    lo = [v & U32(0x00FF00FF) for v in g]
    hi = [(v >> U32(8)) & U32(0x00FF00FF) for v in g]
    c1, c2 = down(g[2], 1), down(g[2], 2)
    b = _tap6_h(g[2], c1, c2)
    ph_prev = np.zeros(grid, np.int64)
    for k in range(int((ye - yb).max())):
        Y = yb + k
        live = Y < ye
        buf = (k & 1) * boff
        ph = (Y * we) & 31
        ahead = row_word(Y + 4)
        vl, vh = _tap6_v(lo), _tap6_v(hi)
        hv0 = ((vl & 0xFF) | (vh & 0xFF) << 8 | ((vl >> 16) & 0xFF) << 16
               | ((vh >> 16) & 0xFF) << 24)
        hv1, hv2 = down(hv0, 1), down(hv0, 2)
        g1 = lo[3] | hi[3] << U32(8)
        n1, n2 = down(g1, 1), down(g1, 2)
        s = _tap6_h(g1, n1, n2)
        j, hv, m = _tap6_h(hv0, hv1, hv2), hv1, _funnel8(hv1, hv2)
        gg, gx1, gy1 = c1, _funnel8(c1, c2), n1
        p = np.stack([gg, _avg4(gg, b), b, _avg4(b, gx1), _avg4(gg, hv), _avg4(b, hv),
                      _avg4(b, j), _avg4(b, m), hv, _avg4(hv, j), j, _avg4(j, m),
                      _avg4(hv, gy1), _avg4(hv, s), _avg4(j, s), _avg4(s, m)], 1)
        # the stores of lanes 0-29 of the live blocks: (block, lane) pairs
        sel = live[:, None, None] & store[None]
        at = (buf + 32 + ph[:, None, None] + X)[sel]
        bb = np.broadcast_to(blk, sel.shape)[sel]
        nn = np.broadcast_to(n, sel.shape)[sel]
        wide4 = (nn == 4) & (at % 4 == 0) & (stride % 4 == 0)
        half = (nn == 4) & (at % 2 == 0) & (stride % 2 == 0) & ~wide4
        kinds[32] += 16 * int(wide4.sum())
        kinds[16] += 32 * int(half.sum())
        kinds[8] += 16 * int(np.where(wide4 | half, 0, nn).sum())
        idx = at[:, None, None] + (np.arange(16) * stride)[None, :, None] + np.arange(4)
        ok = np.broadcast_to((np.arange(4) < nn[:, None])[:, None, :], idx.shape)
        vals = (np.moveaxis(p, 1, -1)[sel][..., None] >> SHIFTS) & 0xFF
        stage[np.broadcast_to(bb[:, None, None], idx.shape)[ok], idx[ok]] = vals[ok]
        lo, hi = lo[1:] + [ahead & U32(0x00FF00FF)], hi[1:] + [(ahead >> U32(8)) & U32(0x00FF00FF)]
        c1, c2, b = n1, n2, s
        # each (block, plane) row: global [gs, gs + we), at `src` in shared memory
        first, last = (Y == yb)[:, None, None], (Y + 1 == ye)[:, None, None]
        gs = f16 * plane + Y[:, None, None] * we
        src = buf + f16 * stride + 32 + ph[:, None, None]
        assert ((src - gs) % 32 == 0).all()
        c = gs & 31
        q = np.arange(64)[None, None, :]
        carry = live[:, None, None] & ~first & (q < c)  # the bytes of the row before
        prev = (1 - (k & 1)) * boff + 32 + ph_prev[:, None, None] + we + f16 * stride
        rows_b = np.broadcast_to(blk, carry.shape)[carry]
        stage[rows_b, np.broadcast_to(src - c + q, carry.shape)[carry]] = \
            stage[rows_b, np.broadcast_to(prev - c + q, carry.shape)[carry]]
        lo_ = np.where(first, -(-gs // 32) * 32, gs // 32 * 32)
        hi_ = (gs + we) // 32 * 32
        qq = np.arange(we + 32)[None, None, :]
        bulk = live[:, None, None] & (lo_ + qq < hi_)
        head = np.where(first, np.minimum(we, -gs % 32), 0)
        tail = np.where(last, we - np.maximum(head, hi_ - gs), 0)
        one = live[:, None, None] & (qq < we) & ((qq < head) | (qq >= we - tail))
        for mask, gaddr, saddr in ((bulk, lo_ + qq, src + lo_ - gs + qq), (one, gs + qq, src + qq)):
            ga = np.broadcast_to(gaddr, mask.shape)[mask]
            out[ga] = stage[np.broadcast_to(blk, mask.shape)[mask],
                            np.broadcast_to(saddr, mask.shape)[mask]]
            written.append(ga)
        assert not (lo_ % 32).any() and not (hi_ % 32).any()
        ph_prev = ph
    assert (np.bincount(np.concatenate(written), minlength=out.size) == 1).all()
    return out.reshape(16, he, we), kinds


def _qcif_refs():
    """A seeded random QCIF luma plane and a 0/255 checkerboard of 2x2
    cells, where every 6-tap clips."""
    rng = np.random.default_rng(18)
    yy, xx = np.mgrid[0:144, 0:176]
    return {"random": rng.integers(0, 256, (144, 176)).astype(np.uint8),
            "checkerboard": np.where((yy // 2 + xx // 2) % 2, 255, 0).astype(np.uint8)}


@pytest.mark.parametrize("ext", [6, 10])
def test_k13_model_matches_the_numpy_planes(ext):
    """Frame form at ext and ext - 1 (rows of W + 2 ext = 0 and 2 mod 4
    bytes: 32-bit stores into shared memory only, then also 16-bit ones on
    every other row and bytes at the rows' ends): the model == the JAX
    package's numpy planes == the plain twin. Band form, bands of 3 MB rows
    of QCIF with real rows above and below (edge rows repeated at the
    frame's edges): the model == the JAX numpy band planes == the frame
    planes' rows == the plain band twin. Grids of 7, 3, 64 (a block a row)
    and 5 blocks split the rows unevenly, a row's last strip is ragged, and
    the random and checkerboard samples above 127 meet dp4a's unsigned
    side."""
    for e in (ext, ext - 1):
        pad = e + 4
        for label, ref in _qcif_refs().items():
            want = np_planes(ref.astype(np.int32), e)
            got, kinds = _k13_model(ref, e, band=False)
            np.testing.assert_array_equal(got, want, err_msg=f"{label} ext {e}")
            # rows of 2 mod 4 bytes: 16-bit stores, and bytes at each row's end
            assert kinds[32] and (kinds[16] > 0) == (kinds[8] > 0) == (e % 2 == 1), kinds
            np.testing.assert_array_equal(
                ops_interp.interpolated_planes_plain(torch.from_numpy(ref), e).numpy(), got)
            for t in range(3):
                r0, r1 = 48 * t, 48 * (t + 1)
                ref_v = ref[np.clip(np.arange(r0 - pad, r1 + pad), 0, 143)]
                band = _k13_model(ref_v, e, band=True, grid=(3, 64, 5)[t])[0]
                np.testing.assert_array_equal(band, got[:, r0: r1 + 2 * e],
                                              err_msg=f"{label} ext {e} band {t}")
                np.testing.assert_array_equal(band, _planes_impl_vext(ref_v, e, np))
                np.testing.assert_array_equal(
                    ops_interp.interpolated_planes_banded_plain(torch.from_numpy(ref_v), e)
                    .numpy(), band)


# ---- K12 -------------------------------------------------------------------
ZZ = ZIGZAG_FLAT.astype(np.int64)
PAT = np.array([[0 if not (i & 1) and not (j & 1) else 1 if i & 1 and j & 1 else 2
                 for j in range(4)] for i in range(4)])


def _fwd_step(i, v0, v1, v2, v3):
    s, d, s2, d2 = v0 + v3, v0 - v3, v1 + v2, v1 - v2
    even = 256 * (s - s2 if i & 2 else s + s2)
    odd = 208 * (d - 2 * d2 if i & 2 else 2 * d + d2)
    return ((odd if i & 1 else even) + 512) >> 10


def _inv_step(j, d0, d1, d2, d3):
    e0, e1, e2, e3 = d0 + d2, d0 - d2, (d1 >> 1) - d3, d1 + (d3 >> 1)
    u, v = (e0, e3) if j in (0, 3) else (e1, e2)
    return u + v if j < 2 else u - v


def _quant_ac(d, qp, lq):
    if qp < 24:
        return ((d * (1 << (4 - qp // 6)) - (1 << (3 - qp // 6))) * lq + 16384) >> 15
    return ((d >> (qp // 6 - 4)) * lq + 16384) >> 15


def _scale_ac(c, qp, ls):
    if qp >= 24:
        return c * ls * (1 << (qp // 6 - 4))
    return (c * ls + (1 << (3 - qp // 6))) >> (4 - qp // 6)


def _k12_model(src, pred, skip, maxdiff, wmb, hmb, qp, qpc, prefilter):
    """csrc/residual_p.cu's function, lane by lane over every MB's warp, in
    int32 as the kernel computes: lane z < 16 luma Z-scan block z, lanes
    16-23 the raster Cb and Cr blocks; the 2x2 chroma DCs over each plane's
    4 lanes; the writes at the kernel's offsets into its one output buffer
    (each int written exactly once), which the model returns."""
    nmb = wmb * hmb
    mb = np.arange(nmb)
    out = np.zeros(768 * nmb, np.int32)
    writes = np.zeros(768 * nmb, np.int32)
    tabs = {qp: qtab(qp), qpc: qtab(qpc)}
    bases = {"luma": 0, "cdc": 256 * nmb, "cac": 264 * nmb}
    recon_base = (384 * nmb, 640 * nmb, 704 * nmb)
    sk = skip[:, None, None]
    md = maxdiff[:, None, None]
    lanes = {}
    for lane in range(24):
        luma = lane < 16
        ci = 0 if luma else (1 if lane < 20 else 2)
        blk = lane if luma else lane & 3
        n = 16 if luma else 8
        bx = ((blk >> 2) & 1) * 2 + (blk & 1) if luma else blk & 1
        by = ((blk >> 3) & 1) * 2 + ((blk >> 1) & 1) if luma else blk >> 1
        ys = ((mb // wmb) * n + 4 * by)[:, None, None] + np.arange(4)[None, :, None]
        xs = ((mb % wmb) * n + 4 * bx)[:, None, None] + np.arange(4)[None, None, :]
        s, p = src[ci][ys, xs].astype(np.int32), pred[ci][ys, xs].astype(np.int32)
        if prefilter:
            close = np.abs(s - p) < md if luma else np.abs(s - p) <= md
            s = np.where(close & ~sk, p, s)
        r = s - p
        h = np.where(r == 0, 0, r * 64 - 32)
        f = np.stack([np.stack([_fwd_step(i, *(h[:, k, x] for k in range(4))) for x in range(4)],
                               -1) for i in range(4)], 1)
        c = np.stack([np.stack([_fwd_step(j, *(f[:, y, k] for k in range(4))) for j in range(4)],
                               -1) for y in range(4)], 1)
        q = np.where(sk, 0, _quant_ac(c, qp if luma else qpc,
                                      tabs[qp if luma else qpc][:3][PAT]))
        lanes[lane] = dict(luma=luma, ci=ci, blk=blk, ys=ys, xs=xs, p=p, c=c, q=q)
    for ci in (1, 2):  # the 2x2 DCs: shuffles within the plane's 4 lanes
        group = [lanes[12 + 4 * ci + k] for k in range(4)]
        dc = [L["c"][:, 0, 0] for L in group]
        lq0, ls0 = tabs[qpc][0], tabs[qpc][3]
        sign = lambda k, j: -1 if bin(k & j).count("1") & 1 else 1  # noqa: E731
        qdc = [np.where(skip, 0, ((((sum(sign(k, j) * dc[j] for j in range(4)) + 2) >> 2)
                                   * 32 >> (qpc // 6)) * lq0 + 16384) >> 15)
               for k in range(4)]
        for k, L in enumerate(group):
            L["qdc"] = qdc[k]
            L["dcv"] = (sum(sign(k, j) * qdc[j] for j in range(4)) * ls0
                        * (1 << (qpc // 6))) >> 5

    def write(at, values):
        out[at] = values
        writes[at] += 1

    for L in lanes.values():
        q, blk = L["q"].reshape(nmb, 16), L["blk"]
        if L["luma"]:
            write(bases["luma"] + (mb * 16 + blk)[:, None] * 16 + np.arange(16), q[:, ZZ])
        else:
            plane = (L["ci"] - 1) * nmb + mb
            write(bases["cdc"] + plane * 4 + blk, L["qdc"])
            write(bases["cac"] + (plane * 4 + blk)[:, None] * 15 + np.arange(15), q[:, ZZ[1:]])
        qq = qp if L["luma"] else qpc
        d = _scale_ac(L["q"], qq, tabs[qq][3:][PAT])
        if not L["luma"]:
            d[:, 0, 0] = L["dcv"]
        g = np.stack([np.stack([_inv_step(j, *(d[:, y, k] for k in range(4))) for j in range(4)],
                               -1) for y in range(4)], 1)
        res = (np.stack([np.stack([_inv_step(y, *(g[:, k, x] for k in range(4)))
                                   for x in range(4)], -1) for y in range(4)], 1) + 32) >> 6
        stride = (16 if L["luma"] else 8) * wmb
        write(recon_base[L["ci"]] + L["ys"] * stride + L["xs"], np.clip(L["p"] + res, 0, 255))
    assert (writes == 1).all()
    return out


def _k12_inputs(qp: int, case: str):
    """QCIF source and int32 prediction planes, skip and maxdiff: random
    content with MBs at the extreme residuals (prediction 0 against source
    255 and the reverse), MAXDIFF at 3 and 255 among random values, and
    every MB skipped ("all"), none ("none") or a random share."""
    rng = np.random.default_rng(qp)
    wmb, hmb = 11, 9
    nmb = wmb * hmb
    src = [rng.integers(0, 256, s).astype(np.uint8) for s in ((144, 176), (72, 88), (72, 88))]
    pred = [np.clip(s.astype(np.int32) + rng.integers(-12, 13, s.shape), 0, 255)
            .astype(np.int32) for s in src]
    for k, (a, b) in enumerate(((0, 255), (255, 0))):
        my, mx = divmod(7 * k + 3, wmb)
        for p, n in zip(range(3), (16, 8, 8)):
            src[p][n * my: n * (my + 1), n * mx: n * (mx + 1)] = b
            pred[p][n * my: n * (my + 1), n * mx: n * (mx + 1)] = a
    skip = {"all": np.ones(nmb, bool), "none": np.zeros(nmb, bool),
            "random": rng.random(nmb) < 0.3}[case]
    maxdiff = rng.integers(3, 40, nmb).astype(np.int32)
    maxdiff[::5], maxdiff[1::7] = 3, 255
    return src, pred, skip, maxdiff, wmb, hmb


@pytest.mark.parametrize("qp,prefilter", [(8, True), (20, False), (28, True), (28, False),
                                          (46, True), (51, False)])
def test_k12_model_matches_the_plain_twin(qp, prefilter):
    """The model's buffer, cut into csrc/residual_p.cu's parts, equals
    pframe_residual_recon_plain on QCIF at both quantiser branches (qp
    below and from 24), with some, every and no MB skipped."""
    qpc = chroma_qp(qp)
    for case in ("random", "all", "none"):
        src, pred, skip, maxdiff, wmb, hmb = _k12_inputs(qp, case)
        nmb = wmb * hmb
        got = _k12_model(src, pred, skip, maxdiff, wmb, hmb, qp, qpc, prefilter)
        levels, *recon = pframe.pframe_residual_recon_plain(
            *(torch.from_numpy(a) for a in (*src, *pred, skip, maxdiff)), wmb, hmb, qp, qpc,
            prefilter)
        want = [levels["luma"], levels["cdc"], levels["cac"], *recon]
        at = 0
        for (name, n), w in zip(residual_p.PARTS, want):
            np.testing.assert_array_equal(got[at: at + n * nmb].reshape(w.shape), w.numpy(),
                                          err_msg=f"qp {qp} {case} {name}")
            at += n * nmb
        if case == "all":
            assert not got[:384 * nmb].any()


def _k12_torch_args():
    """K12's arguments on QCIF at QP 28 with the prefilter, as CPU tensors
    that torch allocated (aligned as the kernel's word reads need)."""
    src, pred, skip, maxdiff, wmb, hmb = _k12_inputs(28, "random")
    return (*(torch.from_numpy(a).clone() for a in (*src, *pred, skip, maxdiff)), wmb, hmb,
            28, chroma_qp(28), True)


# ---- routes, refusals, launch arguments ------------------------------------
def test_cpu_tensors_route_to_the_plain_twins(monkeypatch):
    """CPU tensors take the plain twins through the dispatchers, launching
    nothing; a tensor on another device raises."""
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("a kernel launched"))
    launches = (residual_p.residual_recon.launches, interp.interp_planes.launches)
    args = _k12_torch_args()
    got, want = pframe.pframe_residual_recon(*args), pframe.pframe_residual_recon_plain(*args)
    assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    ref = torch.from_numpy(_qcif_refs()["random"])
    assert torch.equal(ops_interp.interpolated_planes(ref, 6),
                       ops_interp.interpolated_planes_plain(ref, 6))
    assert torch.equal(ops_interp.interpolated_planes_banded(ref[:76], 6),
                       ops_interp.interpolated_planes_banded_plain(ref[:76], 6))
    assert (residual_p.residual_recon.launches, interp.interp_planes.launches) == launches
    meta = torch.zeros((32, 48), dtype=torch.uint8, device="meta")
    for fn in (ops_interp.interpolated_planes, ops_interp.interpolated_planes_banded):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        pframe.pframe_residual_recon(meta, *args[1:])


def test_wrappers_refuse_before_any_build_and_a_failed_build_raises(monkeypatch):
    """A CPU tensor, a wrong shape, dtype, layout or QP raises ValueError
    before any build; past the checks, a build that fails (no nvcc) raises
    and nothing falls back to the plain twin."""
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("a kernel built"))
    args = _k12_torch_args()
    ref = torch.zeros((48, 64), dtype=torch.uint8)
    for bad in [args, (*args[:3], args[3].to(torch.int64), *args[4:]),
                (*args[:3], args[3][:, :64], *args[4:]), (*args[:8], 11, 8, *args[10:]),
                (*args[:10], 52, *args[11:])]:
        with pytest.raises(ValueError):
            residual_p.residual_recon(*bad)
    for bad in [(ref, 4), (ref.to(torch.int16), 4), (ref.to(torch.int32), 4), (ref.t(), 4),
                (ref[None], 4), (torch.zeros((16, interp.MAX_ROW - 7), dtype=torch.uint8), 4),
                (ref, -1), (ref[:16], 4, True)]:
        with pytest.raises(ValueError):
            interp.interp_planes(*bad)
    monkeypatch.undo()

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(build, "nvcc", no_nvcc)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_bound", {})
    for mod in (residual_p, interp):
        monkeypatch.setattr(mod, "_cuda", lambda t: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        residual_p.residual_recon(*args)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        interp.interp_planes(ref, 4)


def _c_params(source: str, symbol: str) -> list:
    text = (build.CSRC / source).read_text()
    sig = text[text.index(f'extern "C" int {symbol}('):]
    return [p.split()[-1].lstrip("*") for p in sig[sig.index("(") + 1: sig.index(")")]
            .split(",")]


def test_launch_arguments_match_the_c_entry_points(monkeypatch):
    """With the checks and the launch stubbed, so that CPU tensors get as far
    as the launch: one call of each C entry point with one argument for each
    of its parameters before the stream, in order; K12's outputs are the
    views of its one buffer at the C comment's offsets, K13's frame and band
    forms pass their grid height and row offset."""
    calls = []
    monkeypatch.setattr(build, "launch", lambda *a: calls.append(a))
    for mod in (residual_p, interp):
        monkeypatch.setattr(mod, "_cuda", lambda t: None)
    params = _c_params("residual_p.cu", "residual_p")
    assert params[-2:] == ["stream", "launched"]
    args = _k12_torch_args()
    levels, ry, rcb, rcr = residual_p.residual_recon(*args)
    fn, name, symbol, got, dev = calls.pop()
    assert (fn, name, symbol, dev) == (residual_p.residual_recon, "residual_p", "residual_p",
                                       args[0].device)
    assert len(got) == len(params) - 2
    named = dict(zip(params, got))
    for k, key in enumerate(("src_y", "src_cb", "src_cr", "pred_y", "pred_cb", "pred_cr",
                             "skip", "maxdiff")):
        assert named[key] is args[k]
    assert (named["wmb"], named["hmb"], named["qp"], named["qpc"], named["prefilter"]) == (
        11, 9, 28, chroma_qp(28), 1)
    np.testing.assert_array_equal(named["qtab"], qtab(28))
    np.testing.assert_array_equal(named["qtabc"], qtab(chroma_qp(28)))
    buf, nmb = named["out"], 99
    assert buf.numel() == 768 * nmb
    offsets = (0, 256, 264, 384, 640, 704)  # residual_p.cu's C comment
    parts = (levels["luma"], levels["cdc"], levels["cac"], ry, rcb, rcr)
    assert [t.data_ptr() for t in parts] == [buf.data_ptr() + 4 * o * nmb for o in offsets]
    assert [tuple(t.shape) for t in parts] == [(nmb, 16, 16), (2, nmb, 4), (2, nmb, 4, 15),
                                               (144, 176), (72, 88), (72, 88)]

    params = _c_params("interp.cu", "interp_planes")
    assert params[-2:] == ["stream", "launched"]
    for band in (False, True):
        ref = torch.zeros((64, 48), dtype=torch.uint8)
        out = interp.interp_planes(ref, 5, band=band)
        fn, name, symbol, got, dev = calls.pop()
        assert (fn, name, symbol) == (interp.interp_planes, "interp", "interp_planes")
        assert len(got) == len(params) - 2
        named = dict(zip(params, got))
        he = 56 if band else 74
        assert named["ref"] is ref and named["out"] is out
        assert (named["rows"], named["W"], named["ext"], named["row_off"], named["he"]) == (
            64, 48, 5, 4 if band else -5, he)
        assert out.shape == (16, he, 58) and out.dtype == torch.uint8
