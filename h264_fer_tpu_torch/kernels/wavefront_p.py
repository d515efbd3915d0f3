"""P-frame decision wavefront (K4): P_Skip, per-quadrant ME argmin, 16x16
unify, mb_type merge and mvd, MB by MB in knight order.

`pframe_decide` is the wrapper of the CUDA kernel csrc/wavefront_p.cu, which
replaces the Pallas kernel _decide_kernel
(h264_fer_tpu/kernels/wavefront_p_pallas.py:60, via pframe_decide_pallas_impl
at :387). On a CUDA tensor it launches the kernel (one launch per frame:
a persistent grid that takes the MBs in knight order d = c + 2r and starts
each as soon as its neighbours are done, kernels/dataflow.py) or raises;
on a CPU tensor it runs
`pframe_decide_plain`, the non-banded XLA contract twin
kernels/wavefront_p.pframe_decide_impl (wavefront_p.py:177-423) in plain
PyTorch: a Python loop over the diagonals with vector ops over the MBs of
each. The only loop-carried dependency of a P slice is the MV-prediction
chain (mode_pred.cpp:252-426); on d = c + 2r the left, top, top-right and
top-left neighbours all lie on earlier diagonals.

`pframe_decide_band` is K4-band, the same function over one MB-row band of
a frame (parallel/tile_p.py), the counterpart of pframe_decide_impl with
`band=` (wavefront_p.py:177-423): the band's rows in their own knight
order, row 0 reading its top neighbours' final state from `top`, the band
above's last MB row, where the reference sends that row's state from the
band above on every wave. Its plain twin is pframe_decide_plain(top=top).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.device import const
from . import build, dataflow
from .me_int import me_metric

I32 = torch.int32
MB_SKIP = -2
BIG = 2**31 - 1

# partition width / height per mb_type 0..4 (h264_globals.h:123-128)
_PW = np.array([16, 16, 8, 8, 8], np.int32)
_PH = np.array([16, 8, 16, 8, 8], np.int32)


def _loc_static(xn: int, yn: int):
    """Static half of DeriveNeighbourLocation (mode_pred.cpp:61-97):
    (dr, dc, xw, yw), or None where the neighbour never exists."""
    if (xn > 15 and yn >= 0) or yn > 15:
        return None
    if 0 <= xn < 16:
        return (0, 0, xn, yn) if yn >= 0 else (-1, 0, xn, yn + 16)
    if xn > 15:  # above right
        return (-1, 1, xn - 16, yn + 16)
    if yn < 0:  # above left
        return (-1, -1, xn + 16, yn + 16)
    return (0, -1, xn + 16, yn)  # left


def _part_origin(mb_type: int, part: int):
    if mb_type == 1:  # 16x8
        return 0, 8 * part
    if mb_type == 2:  # 8x16
        return 8 * part, 0
    if mb_type in (3, 4):
        return 8 * (part & 1), 8 * (part >> 1)
    return 0, 0


def _pred_part_width(mb_type: int) -> int:
    # sub_mb_type is always P_L0_8x8 in the encoder
    return 8 if mb_type in (2, 3, 4) else 16


class _Ctx:
    """One diagonal's MBs (rs, cs, valid) and the state grids: mvq
    (hmb + 2, wmb, 4, 2) and mbt (hmb + 2, wmb), row hmb a scratch row and
    row hmb + 1 (row -1) the MB row above the first, which exists when
    top_row is -1 (set on a band with a halo) and not when it is 0."""

    top_row = 0

    def __init__(self, mvq, mbt, rs, cs, valid, wmb: int, hmb: int):
        self.mvq, self.mbt = mvq, mbt
        self.rs, self.cs, self.valid = rs, cs, valid
        self.wmb, self.hmb = wmb, hmb

    def fetch(self, loc):
        """Neighbour MV (n, 2) and existence (n,) at a static location. No
        MB of these P slices is intra, so a neighbour that exists has
        reference index 0 (mode_pred.cpp:48-58)."""
        n = self.rs.shape[0]
        dev = self.rs.device
        if loc is None:
            return (torch.zeros((n, 2), dtype=I32, device=dev),
                    torch.zeros(n, dtype=torch.bool, device=dev))
        dr, dc, xw, yw = loc
        rn = self.rs + dr
        cn = self.cs + dc
        exists = self.valid & (cn >= 0) & (cn < self.wmb) & (rn >= self.top_row)
        cn = cn.clamp(0, self.wmb - 1)
        rn = torch.where(exists, rn, self.hmb)  # scratch row
        t = self.mbt[rn, cn]
        ti = t.clamp(0, 4).long()
        pw = const(_PW, dev)[ti]
        ph = const(_PH, dev)[ti]
        pidx = torch.where(t == MB_SKIP, 0, ((yw // ph) << 1) + (xw // pw))
        return self.mvq[rn, cn, pidx.long()], exists


def _predict(ctx: _Ctx, mb_type: int, part: int):
    """PredictMV_Luma for the encoder's cases (mode_pred.cpp:252-371),
    over a diagonal: the (n, 2) MV predictor of `part` of `mb_type`."""
    x, y = _part_origin(mb_type, part)
    pw = _pred_part_width(mb_type)
    mvA, exA = ctx.fetch(_loc_static(x - 1, y))
    mvB, exB = ctx.fetch(_loc_static(x, y - 1))
    mvC, exC = ctx.fetch(_loc_static(x + pw, y - 1))
    mvD, exD = ctx.fetch(_loc_static(x - 1, y - 1))
    # C unavailable → D (mode_pred.cpp:297-299)
    mvC = torch.where(exC[:, None], mvC, mvD)
    exC = exC | exD

    # substitution rules (mode_pred.cpp:318-340): existing refs are all 0
    both_none = ~exA & ~exB
    refA = torch.where(exA | both_none, 0, -1)
    A = torch.where(exA[:, None], mvA, 0)
    B = torch.where(exB[:, None], mvB, A)
    refB = torch.where(exB, 0, refA)
    C = torch.where(exC[:, None], mvC, A)
    refC = torch.where(exC, 0, refA)

    mA, mB, mC = refA == 0, refB == 0, refC == 0
    only_A = mA & ~mB & ~mC
    only_B = ~mA & mB & ~mC
    only_C = ~mA & ~mB & mC
    stack = torch.stack([A, B, C])
    med = stack.sum(0, dtype=I32) - stack.amax(0) - stack.amin(0)
    pred = torch.where(only_A[:, None], A,
                       torch.where(only_B[:, None], B,
                                   torch.where(only_C[:, None], C, med)))

    # directional cases, checked first by the reference: the raw neighbour
    if mb_type == 1 and part == 0:
        pred = torch.where(exB[:, None], mvB, pred)
    elif mb_type == 1 and part == 1:
        pred = torch.where(exA[:, None], mvA, pred)
    elif mb_type == 2 and part == 0:
        pred = torch.where(exA[:, None], mvA, pred)
    elif mb_type == 2 and part == 1:
        pred = torch.where(exC[:, None], mvC, pred)
    return pred


def mb_window_gather(planes, mv, mb_x, mb_y, ext: int):
    """(n, 16, 16) int32 luma prediction windows of MBs (mb_x, mb_y) (n,)
    at one qpel MV each, mv (n, 2), read from the 16-phase planes
    (codec/tpu_pframe.mb_window_gather)."""
    mv = mv.to(I32)
    frac = ((mv[:, 1] & 3) * 4 + (mv[:, 0] & 3)).long()
    px = (mb_x * 16 + (mv[:, 0] >> 2) + ext).long()
    py = (mb_y * 16 + (mv[:, 1] >> 2) + ext).long()
    ii = torch.arange(16, device=planes.device)
    return planes[frac[:, None, None], (py[:, None] + ii)[:, :, None],
                  (px[:, None] + ii)[:, None, :]].to(I32)


def pframe_decide_plain(src_y, planes, int_map, c1mv, q1map, c2mv, q2map,
                        q2ok, maxdiff, wmb: int, hmb: int, window: int,
                        ext: int, metric_id: int, lam: int, top=None):
    """The P decision wavefront in plain PyTorch.

    src_y (H, W) and planes (16, he, we), any integer dtype; int_map
    (nmb, 4, S^2), c1mv / c2mv (nmb, 4, 2), q1map / q2map (nmb, 4, 49) int32;
    q2ok (nmb, 4) bool; maxdiff (nmb,). Returns dict: skip (nmb,) bool,
    mb_type (nmb,) int32 (the merged type, also at skip MBs), mv (nmb, 4, 2)
    final quadrant-major MVs, mvd (nmb, 4, 2) per-partition mvds.

    For an MB-row band: top, None (the band's top is the frame's) or (mv
    (wmb, 4, 2), t (wmb,)) int32, the final MVs and types (MB_SKIP or the
    merged type) of the MB row above the band, which its first row reads.
    """
    dev = src_y.device
    S = 2 * window + 1
    src_grid = src_y.to(I32).reshape(hmb, 16, wmb, 16).transpose(1, 2)
    q2ok = q2ok.to(torch.bool)

    # candidate MVs in [integer shifts | c1 + offsets | c2 + offsets] order,
    # row-major (dy, dx) within each
    sh = (torch.arange(S, device=dev, dtype=I32) - window) * 4
    shx, shy = sh.repeat(S), sh.repeat_interleave(S)
    o = torch.arange(-3, 4, device=dev, dtype=I32)
    offx, offy = o.repeat(7), o.repeat_interleave(7)

    slot = torch.arange(hmb, device=dev)
    # row hmb: the scratch row; row hmb + 1, indexed as -1: the row above
    mvq = torch.zeros((hmb + 2, wmb, 4, 2), dtype=I32, device=dev)
    mbt = torch.zeros((hmb + 2, wmb), dtype=I32, device=dev)
    top_row = 0
    if top is not None:
        mvq[-1], mbt[-1] = top[0].to(I32), top[1].to(I32)
        top_row = -1
    skipg = torch.zeros((hmb + 1, wmb), dtype=torch.bool, device=dev)
    mvdg = torch.zeros((hmb + 1, wmb, 4, 2), dtype=I32, device=dev)
    typg = torch.zeros((hmb + 1, wmb), dtype=I32, device=dev)

    for d in range(wmb + 2 * hmb - 2):
        rs = slot
        cs = d - 2 * rs
        valid = (cs >= 0) & (cs < wmb)
        rc = torch.where(valid, rs, 0)
        cc = torch.where(valid, cs, 0)
        rw = torch.where(valid, rs, hmb)  # invalid slots write the scratch row
        mbi = rc * wmb + cc
        src_mb = src_grid[rc, cc]

        def ctx():
            c = _Ctx(mvq, mbt, rs, cs, valid, wmb, hmb)
            c.top_row = top_row
            return c

        # ---- P_Skip trial (mode_pred.cpp:381-426) ------------------------
        # a band's row 0 is no edge when it has a row above (then row -1)
        edge = (rs == top_row) | (cs == 0)
        top_r = torch.where(rs > top_row, rs - 1, hmb)
        left_c = (cs - 1).clamp(0, wmb - 1)
        zt = (mvq[top_r, cc, 2] == 0).all(dim=-1)
        zl = (mvq[rc, left_c, 1] == 0).all(dim=-1)
        pred16 = _predict(ctx(), 0, 0)
        skip_mv = torch.where((edge | zt | zl)[:, None], 0, pred16)
        spred = mb_window_gather(planes, skip_mv, cc, rc, ext)
        is_skip = ((src_mb - spred).abs() <= maxdiff[mbi][:, None, None]
                   ).flatten(1).all(dim=1) & valid

        # skip state in every quadrant; mb_type 4 while searching, so that
        # in-MB reads resolve under the 8x8 partitioning
        mvq[rw, cc] = skip_mv[:, None, :].expand(-1, 4, 2)
        mbt[rw, cc] = torch.where(is_skip, MB_SKIP, 4).to(I32)

        # ---- per-quadrant search ----------------------------------------
        qmv = torch.zeros((hmb, 4, 2), dtype=I32, device=dev)
        qscore = torch.zeros((hmb, 4), dtype=I32, device=dev)
        qmvp = torch.zeros((hmb, 4, 2), dtype=I32, device=dev)
        for q in range(4):
            mvp = _predict(ctx(), 4, q)
            qmvp[:, q] = mvp
            mvpx, mvpy = mvp[:, 0:1], mvp[:, 1:2]
            ci = int_map[mbi, q] + lam * ((shx - mvpx).abs() + (shy - mvpy).abs())
            c1 = c1mv[mbi, q]
            m1x, m1y = c1[:, 0:1] + offx, c1[:, 1:2] + offy
            cq1 = q1map[mbi, q] + lam * ((m1x - mvpx).abs() + (m1y - mvpy).abs())
            c2 = c2mv[mbi, q]
            m2x, m2y = c2[:, 0:1] + offx, c2[:, 1:2] + offy
            cq2 = q2map[mbi, q] + lam * ((m2x - mvpx).abs() + (m2y - mvpy).abs())
            cq2 = torch.where(q2ok[mbi, q][:, None], cq2, BIG)
            allc = torch.cat([ci, cq1, cq2], dim=1)
            allx = torch.cat([shx.expand_as(ci), m1x, m2x], dim=1)
            ally = torch.cat([shy.expand_as(ci), m1y, m2y], dim=1)
            k = allc.argmin(dim=1, keepdim=True)  # the first index on ties
            qmv[:, q, 0] = allx.gather(1, k)[:, 0]
            qmv[:, q, 1] = ally.gather(1, k)[:, 0]
            qscore[:, q] = allc.gather(1, k)[:, 0]
            # this quadrant is visible to the next quadrant's predictor
            mvq[rw, cc, q] = torch.where(is_skip[:, None], skip_mv, qmv[:, q])

        # ---- 16x16 unify trial (encoder._maybe_unify) --------------------
        all_eq0 = (qmv == qmv[:, 0:1]).flatten(1).all(dim=1)
        mvp_u = _predict(ctx(), 0, 0)
        best_c = qscore.sum(dim=1, dtype=I32)
        best_u = torch.zeros((hmb, 2), dtype=I32, device=dev)
        found = torch.zeros(hmb, dtype=torch.bool, device=dev)
        for j in range(4):
            u = qmv[:, j]
            upred = mb_window_gather(planes, u, cc, rc, ext)
            dist = me_metric(upred - src_mb, metric_id).sum(dim=(1, 2), dtype=I32)
            cost = dist + lam * ((u[:, 0] - mvp_u[:, 0]).abs()
                                 + (u[:, 1] - mvp_u[:, 1]).abs())
            upd = cost < best_c
            best_c = torch.where(upd, cost, best_c)
            best_u = torch.where(upd[:, None], u, best_u)
            found = found | upd
        unify = found & ~all_eq0 & ~is_skip
        qmv = torch.where(unify[:, None, None], best_u[:, None, :].expand_as(qmv), qmv)

        # ---- mb_type merge (moestimation.cpp:529-551) --------------------
        all_eq = (qmv == qmv[:, 0:1]).flatten(1).all(dim=1)
        eq_rows = ((qmv[:, 0] == qmv[:, 1]).all(-1) & (qmv[:, 2] == qmv[:, 3]).all(-1))
        eq_cols = ((qmv[:, 0] == qmv[:, 2]).all(-1) & (qmv[:, 1] == qmv[:, 3]).all(-1))
        mb_type = torch.where(all_eq, 0, torch.where(
            eq_rows, 1, torch.where(eq_cols, 2, 4))).to(I32)

        # final state for later neighbours
        mvq[rw, cc] = torch.where(is_skip[:, None, None],
                                  skip_mv[:, None, :].expand_as(qmv), qmv)
        mbt[rw, cc] = torch.where(is_skip, MB_SKIP, mb_type).to(I32)

        # ---- mvd, with the final state in place --------------------------
        f = ctx()
        zero = torch.zeros_like(qmv[:, 0])
        mvd_t0 = torch.stack([qmv[:, 0] - _predict(f, 0, 0), zero, zero, zero], 1)
        mvd_t1 = torch.stack([qmv[:, 0] - _predict(f, 1, 0),
                              qmv[:, 2] - _predict(f, 1, 1), zero, zero], 1)
        mvd_t2 = torch.stack([qmv[:, 0] - _predict(f, 2, 0),
                              qmv[:, 1] - _predict(f, 2, 1), zero, zero], 1)
        mvd_t4 = qmv - qmvp  # type 4: the search-time predictors still hold
        t = mb_type[:, None, None]
        mvd = torch.where(t == 0, mvd_t0, torch.where(
            t == 1, mvd_t1, torch.where(t == 2, mvd_t2, mvd_t4)))
        mvd = torch.where(is_skip[:, None, None], 0, mvd)

        skipg[rw, cc] = is_skip
        mvdg[rw, cc] = mvd.to(I32)
        typg[rw, cc] = mb_type

    nmb = wmb * hmb
    return {"skip": skipg[:hmb].reshape(nmb), "mb_type": typg[:hmb].reshape(nmb),
            "mv": mvq[:hmb].reshape(nmb, 4, 2), "mvd": mvdg[:hmb].reshape(nmb, 4, 2)}


def pframe_decide(src_y, planes, int_map, c1mv, q1map, c2mv, q2map, q2ok,
                  maxdiff, wmb: int, hmb: int, window: int, ext: int,
                  metric_id: int, lam: int, *, blocks=None):
    """K4: pframe_decide_plain's function. CUDA tensors (src_y and planes
    uint8, the maps int32, q2ok bool, all contiguous) go to the kernel, CPU
    tensors to the plain version. blocks: the kernel's grid size (None: as
    many blocks as fit on the card at once); any size gives the same
    result."""
    args = (src_y, planes, int_map, c1mv, q1map, c2mv, q2map, q2ok, maxdiff)
    grid = dataflow.check_blocks(blocks)
    if src_y.device.type == "cpu":
        return pframe_decide_plain(*args, wmb, hmb, window, ext, metric_id, lam)
    return _launch(pframe_decide, "wavefront_p_frame", args, (), wmb, hmb, window, ext,
                   metric_id, lam, grid)


# kernel launches so far, as counted by the C entry point (one per accepted
# launch, one per frame)
pframe_decide.launches = 0


def pframe_decide_band(src_y, planes, int_map, c1mv, q1map, c2mv, q2map, q2ok,
                       maxdiff, wmb: int, hmb: int, window: int, ext: int,
                       metric_id: int, lam: int, top=None, *, blocks=None):
    """K4-band: pframe_decide over one MB-row band of hmb MB rows (its
    source rows, its planes, interpolated_planes_banded's, and its rows of
    the maps). top: None for a band with no MB row above it, else (mv
    (wmb, 4, 2), t (wmb,)) int32 on the band's device, the band above's
    final MVs and types (MB_SKIP or the merged type) of its last MB row.
    CUDA tensors go to the kernel (the C entry point wavefront_p_band, one
    launch, counted on pframe_decide_band.launches), CPU tensors to
    pframe_decide_plain(top=top). blocks: as pframe_decide's."""
    args = (src_y, planes, int_map, c1mv, q1map, c2mv, q2map, q2ok, maxdiff)
    grid = dataflow.check_blocks(blocks)
    if top is not None:
        if len(top) != 2:
            raise ValueError(f"top: (mv, t), got {len(top)} tensors")
        build.check_tensor("top mv", top[0], (wmb, 4, 2), I32, src_y.device)
        build.check_tensor("top t", top[1], (wmb,), I32, src_y.device)
    if src_y.device.type == "cpu":
        return pframe_decide_plain(*args, wmb, hmb, window, ext, metric_id, lam, top)
    if top is None:  # never read: has_top 0
        top = (torch.empty((wmb, 4, 2), dtype=I32, device=src_y.device),
               torch.empty(wmb, dtype=I32, device=src_y.device))
        has_top = 0
    else:
        has_top = 1
    return _launch(pframe_decide_band, "wavefront_p_band", args, top, wmb, hmb, window,
                   ext, metric_id, lam, grid, has_top)


pframe_decide_band.launches = 0


def _launch(wrapper, symbol: str, args, top, wmb: int, hmb: int, window: int, ext: int,
            metric_id: int, lam: int, grid: int, has_top=None):
    """Check K4's CUDA arguments `args` and launch the C entry point
    `symbol` (wavefront_p_frame, or wavefront_p_band with `top` and
    has_top), counted on wrapper.launches. Returns the outputs' dict."""
    src_y = args[0]
    if src_y.device.type != "cuda":
        raise ValueError(f"unsupported device {src_y.device}")
    dev = src_y.device
    nmb = wmb * hmb
    h, w = 16 * hmb, 16 * wmb
    S = 2 * window + 1
    for name, t, shape, dtype in zip(
            ("src_y", "planes", "int_map", "c1mv", "q1map", "c2mv", "q2map", "q2ok",
             "maxdiff"), args,
            ((h, w), (16, h + 2 * ext, w + 2 * ext), (nmb, 4, S * S), (nmb, 4, 2),
             (nmb, 4, 49), (nmb, 4, 2), (nmb, 4, 49), (nmb, 4), (nmb,)),
            (torch.uint8, torch.uint8, I32, I32, I32, I32, I32, torch.bool, I32)):
        build.check_tensor(name, t, shape, dtype, dev)
    for name, t in (("src_y", src_y), ("c1mv", args[3]), ("c2mv", args[5])):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel copies it in 16-byte chunks")
    skip = torch.empty(nmb, dtype=torch.bool, device=dev)
    mb_type = torch.empty(nmb, dtype=I32, device=dev)
    mv = torch.empty((nmb, 4, 2), dtype=I32, device=dev)
    mvd = torch.empty((nmb, 4, 2), dtype=I32, device=dev)
    state_t = torch.empty(nmb, dtype=I32, device=dev)
    order, sched = dataflow.schedule(dataflow.knight_order(wmb, hmb), dev)
    band = () if has_top is None else (has_top,)
    build.launch(wrapper, "wavefront_p", symbol,
                 (*args, skip, mb_type, mv, mvd, state_t, *top, order, sched, w, hmb,
                  *band, window, ext, metric_id, lam, grid), dev)
    return {"skip": skip, "mb_type": mb_type, "mv": mv, "mvd": mvd}
