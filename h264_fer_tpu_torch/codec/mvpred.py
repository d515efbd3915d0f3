"""Motion-vector prediction of the decoder's Python form (host side).

A copy of h264_fer_tpu/codec/mvpred.py, which replicates the reference's
mode_pred.cpp semantics exactly (median + directional special cases, P_Skip
rule, the P_8x8 SubMB(part, 0) overwrite with its sub_mb_type[0] indexing
quirk, and the sub-8x8 MV collapse). The native slice decoder
(native/decoder_native.cpp) carries the same logic in C++.

State protocol (duck-typed; codec.decoder.Decoder provides):
  st.wmb           — picture width in MBs
  st.mb_type       — per-MB raw slice mb_type (MB_SKIP == -2 for skip)
  st.mb_intra      — per-MB bool
  st.mv            — (nmb, 4, 4, 2) int32, quadrant-major MVs
"""

from __future__ import annotations

import numpy as np

MB_SKIP = -2


def part_idx_of(st, addr: int, xw: int, yw: int) -> int:
    """derivation_process_for_macroblock_and_submb_partition
    (mode_pred.cpp:100-111) → quadrant index under the neighbor's own
    partitioning (intra and P_Skip resolve to 0)."""
    t = int(st.mb_type[addr])
    if t == MB_SKIP or st.mb_intra[addr]:
        return 0
    pw = [16, 16, 8, 8, 8][t]
    ph = [16, 8, 16, 8, 8][t]
    return ((yw // ph) << 1) + (xw // pw)


def locate_neighbor(st, curr: int, xn: int, yn: int):
    """DeriveNeighbourLocation (mode_pred.cpp:61-97): (addr, xw, yw) or None."""
    if xn > 15 and yn >= 0:
        return None
    if yn > 15:
        return None
    if 0 <= xn < 16 and yn >= 0:
        return curr, xn, yn
    wmb = st.wmb
    if 0 <= xn < 16:  # above
        if curr < wmb:
            return None
        return curr - wmb, xn, yn + 16
    if xn > 15:  # above-right
        if curr < wmb:
            return None
        addr = curr - wmb + 1
        if addr % wmb == 0:
            return None
        return addr, xn - 16, yn + 16
    if yn < 0:  # above-left
        if curr < wmb or curr % wmb == 0:
            return None
        return curr - wmb - 1, xn + 16, yn + 16
    if curr % wmb == 0:
        return None
    return curr - 1, xn + 16, yn


def neighbor_mv(st, addr: int, part_idx: int):
    """get_neighbour_mv (mode_pred.cpp:48-58): (mvx, mvy, refidx)."""
    if st.mb_intra[addr]:
        return 0, 0, -1
    parts = st.mv[addr]
    return int(parts[part_idx, 0, 0]), int(parts[part_idx, 0, 1]), 0


def predict_mv_luma(st, curr: int, mb_type: int, num_parts: int,
                    part_idx: int, sub_mb_type=None) -> tuple[int, int]:
    """PredictMV_Luma / PredictMV_LumaSubMB(part, 0) (mode_pred.cpp:252-371).

    For P_8x8/P_8x8ref0 the effective predictor is the SubMB(part, 0)
    prediction (the reference overwrites the plain one before adding mvd),
    with its sub_mb_type[0] indexing quirk for the directional cases.
    """
    if num_parts == 1:
        x = y = 0
    elif mb_type == 1:  # 16x8
        x, y = 0, 8 * part_idx
    elif mb_type == 2:  # 8x16
        x, y = 8 * part_idx, 0
    else:  # 8x8
        x, y = 8 * (part_idx & 1), 8 * (part_idx >> 1)
    pred_part_width = 16
    if mb_type in (3, 4):
        pred_part_width = 4 if sub_mb_type and sub_mb_type[part_idx] in (2, 3) else 8
    if mb_type == 2:
        pred_part_width = 8

    cands = [
        locate_neighbor(st, curr, x - 1, y),
        locate_neighbor(st, curr, x, y - 1),
        locate_neighbor(st, curr, x + pred_part_width, y - 1),
    ]
    if cands[2] is None:  # C invalid → D
        cands[2] = locate_neighbor(st, curr, x - 1, y - 1)

    mvn = [None, None, None]
    refn = [-1, -1, -1]
    for i, loc in enumerate(cands):
        if loc is not None:
            addr, xw, yw = loc
            pidx = part_idx_of(st, addr, xw, yw)
            mvx, mvy, ref = neighbor_mv(st, addr, pidx)
            mvn[i] = (mvx, mvy)
            refn[i] = ref

    if mb_type in (3, 4):
        s0 = sub_mb_type[0] if sub_mb_type else 0
        if s0 == 1 and mvn[1] is not None and refn[1] == 0:  # P_L0_8x4
            return mvn[1]
        if s0 == 2 and mvn[0] is not None and refn[0] == 0:  # P_L0_4x8
            return mvn[0]
    else:
        if mb_type == 1 and part_idx == 0 and mvn[1] is not None and refn[1] == 0:
            return mvn[1]
        if mb_type == 1 and part_idx == 1 and mvn[0] is not None and refn[0] == 0:
            return mvn[0]
        if mb_type == 2 and part_idx == 0 and mvn[0] is not None and refn[0] == 0:
            return mvn[0]
        if mb_type == 2 and part_idx == 1 and mvn[2] is not None and refn[2] == 0:
            return mvn[2]

    if mvn[0] is None and mvn[1] is None:
        mvn[0] = (0, 0)
        refn[0] = 0
    if mvn[0] is None and mvn[1] is not None:
        mvn[0] = (0, 0)
        refn[0] = -1
    if mvn[1] is None:
        mvn[1] = mvn[0]
        refn[1] = refn[0]
    if mvn[2] is None:
        mvn[2] = mvn[0]
        refn[2] = refn[0]

    match = [refn[i] == 0 for i in range(3)]
    if match[0] and not match[1] and not match[2]:
        return mvn[0]
    if not match[0] and match[1] and not match[2]:
        return mvn[1]
    if not match[0] and not match[1] and match[2]:
        return mvn[2]
    xs = sorted(m[0] for m in mvn)
    ys = sorted(m[1] for m in mvn)
    return xs[1], ys[1]


def skip_neighbor_zero(st, addr: int, pidx: int) -> bool:
    """One term of the P_Skip zero test (mode_pred.cpp:395-396)."""
    if st.mb_intra[addr]:
        return False
    parts = st.mv[addr]
    return int(parts[pidx, 0, 0]) == 0 and int(parts[pidx, 0, 1]) == 0


def derive_skip_mv(st, curr: int) -> tuple[int, int]:
    """PredictMV P_Skip rule (mode_pred.cpp:381-406)."""
    wmb = st.wmb
    if curr < wmb or curr % wmb == 0:
        return 0, 0
    if skip_neighbor_zero(st, curr - wmb, 2) or skip_neighbor_zero(st, curr - 1, 1):
        return 0, 0
    return predict_mv_luma(st, curr, 0, 1, 0, None)


def store_part_mvs(st, curr: int, mb_type: int, num_parts: int,
                   part_mv: np.ndarray, upto: int) -> None:
    """Populate st.mv[curr][quadrant][0] per partition layout
    (DeriveMVs fan-out, mode_pred.cpp:434-460)."""
    mv = st.mv
    if num_parts == 1:
        for q in range(4):
            mv[curr, q, 0] = part_mv[0]
    elif mb_type == 1:  # 16x8: quadrants 0,1 = part0; 2,3 = part1
        mv[curr, 0, 0] = part_mv[0]
        mv[curr, 1, 0] = part_mv[0]
        mv[curr, 2, 0] = part_mv[1]
        mv[curr, 3, 0] = part_mv[1]
    elif mb_type == 2:  # 8x16: quadrants 0,2 = part0; 1,3 = part1
        mv[curr, 0, 0] = part_mv[0]
        mv[curr, 2, 0] = part_mv[0]
        mv[curr, 1, 0] = part_mv[1]
        mv[curr, 3, 0] = part_mv[1]
    else:  # 8x8
        for q in range(min(upto + 1, 4)):
            mv[curr, q, 0] = part_mv[q]


def fan_out(st, curr: int) -> None:
    """Final [i][0] → [i][j] copy (DeriveMVs, mode_pred.cpp:470-482)."""
    st.mv[curr, :, :, 0] = st.mv[curr, :, 0:1, 0]
    st.mv[curr, :, :, 1] = st.mv[curr, :, 0:1, 1]
