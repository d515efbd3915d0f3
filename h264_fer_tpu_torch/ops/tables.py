"""Constant spec tables for the H.264 Baseline transform/quant path.

A numpy copy of the tables of h264_fer_tpu/ops/tables.py that the
port's paths need (norm tables as the reference implements them:
quantizationTransform.cpp:12-32, scaleTransform.cpp:32-52,
inttransform.cpp:8-14, h264_globals.cpp:140-214), and the Z-scan block
neighbour map of h264_fer_tpu/codec/decoder.py. Kept as numpy int32 so
that importing the package touches no device; code moves them to its device
with ops.device.const. tests/test_torch_tables.py holds each array equal to
the JAX package's.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Zig-zag scan (norm 8.5.6; reference scaleTransform.cpp:43-47).
# ZIGZAG_FLAT[i] = raster index (4*row+col) of the i-th coefficient in
# zig-zag order.
ZIGZAG_YX = np.array(
    [
        [0, 0], [0, 1], [1, 0], [2, 0], [1, 1], [0, 2], [0, 3], [1, 2],
        [2, 1], [3, 0], [3, 1], [2, 2], [1, 3], [2, 3], [3, 2], [3, 3],
    ],
    dtype=np.int32,
)
ZIGZAG_FLAT = (ZIGZAG_YX[:, 0] * 4 + ZIGZAG_YX[:, 1]).astype(np.int32)
# Inverse: INV_ZIGZAG_FLAT[raster] = zig-zag position of that raster coeff.
INV_ZIGZAG_FLAT = np.argsort(ZIGZAG_FLAT).astype(np.int32)

# ---------------------------------------------------------------------------
# Dequant scale table LevelScale[qP%6][i][j] = 16 * normAdjust(m, i, j)
# (norm 8.5.12.1 with weightScale==16; reference scaleTransform.cpp:32-40).
_V = np.array(
    [[10, 16, 13], [11, 18, 14], [13, 20, 16],
     [14, 23, 18], [16, 25, 20], [18, 29, 23]],
    dtype=np.int32,
)


def _norm_adjust_table() -> np.ndarray:
    t = np.zeros((6, 4, 4), dtype=np.int32)
    for m in range(6):
        for i in range(4):
            for j in range(4):
                if i % 2 == 0 and j % 2 == 0:
                    t[m, i, j] = _V[m, 0]
                elif i % 2 == 1 and j % 2 == 1:
                    t[m, i, j] = _V[m, 1]
                else:
                    t[m, i, j] = _V[m, 2]
    return t


LEVEL_SCALE = 16 * _norm_adjust_table()  # (6, 4, 4) int32

# ---------------------------------------------------------------------------
# Encoder-side quantization multiplier table (reference
# quantizationTransform.cpp:24-32).
LEVEL_QUANTIZE = np.array(
    [
        [[205, 158, 205, 158], [158, 128, 158, 128],
         [205, 158, 205, 158], [158, 128, 158, 128]],
        [[186, 146, 186, 146], [146, 114, 146, 114],
         [186, 146, 186, 146], [146, 114, 146, 114]],
        [[158, 128, 158, 128], [128, 102, 128, 102],
         [158, 128, 158, 128], [128, 102, 128, 102]],
        [[146, 114, 146, 114], [114, 89, 114, 89],
         [146, 114, 146, 114], [114, 89, 114, 89]],
        [[128, 102, 128, 102], [102, 82, 102, 82],
         [128, 102, 128, 102], [102, 82, 102, 82]],
        [[114, 89, 114, 89], [89, 71, 89, 71],
         [114, 89, 114, 89], [89, 71, 89, 71]],
    ],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Chroma QP mapping (norm Table 8-15; reference inttransform.cpp:8-14).
QPI_TO_QPC = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7,
     8, 9, 10, 11, 12, 13, 14, 15,
     16, 17, 18, 19, 20, 21, 22, 23,
     24, 25, 26, 27, 28, 29, 29, 30,
     31, 32, 32, 33, 34, 34, 35, 35,
     36, 36, 37, 37, 37, 38, 38, 38,
     39, 39, 39, 39],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Intra 4x4 block scan order: Intra4x4ScanOrder[blkIdx] = (x, y) pixel offset
# of the 4x4 block inside the macroblock (reference h264_globals.cpp:209-214).
# Ordering: Z-order over the four 8x8 quadrants, Z-order inside each.
INTRA4X4_SCAN_ORDER_XY = np.array(
    [
        [0, 0], [4, 0], [0, 4], [4, 4],
        [8, 0], [12, 0], [8, 4], [12, 4],
        [0, 8], [4, 8], [0, 12], [4, 12],
        [8, 8], [12, 8], [8, 12], [12, 12],
    ],
    dtype=np.int32,
)
# raster(row-major in 4x4-block units) -> zig/Z-scan block index
# (reference h264_globals.cpp:200-206 `to_4x4_luma_block`).
RASTER_TO_LUMA_BLOCK = np.array(
    [0, 1, 4, 5,
     2, 3, 6, 7,
     8, 9, 12, 13,
     10, 11, 14, 15],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Inter CBP <-> codeNum mapping, ChromaArrayType==1 (norm Table 9-4;
# reference h264_globals.cpp:140-169).
CODENUM_TO_CBP_INTER = np.array(
    [0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
     14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
     17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41],
    dtype=np.int32,
)
CBP_TO_CODENUM_INTER = np.argsort(CODENUM_TO_CBP_INTER).astype(np.int32)

# Intra CBP <-> codeNum mapping, ChromaArrayType==1 (norm Table 9-4;
# reference h264_globals.cpp:140-169).
CODENUM_TO_CBP_INTRA = np.array(
    [47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
     16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
     8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41],
    dtype=np.int32,
)
CBP_TO_CODENUM_INTRA = np.argsort(CODENUM_TO_CBP_INTRA).astype(np.int32)

# Partitions of each P_8x8 sub_mb_type 0..3 (8x8, 8x4, 4x8, 4x4; norm
# Table 7-17), which the decoder reads an mvd for.
SUB_MB_NUM_PARTS = np.array([1, 2, 2, 4], dtype=np.int32)


# ---------------------------------------------------------------------------
# Neighbouring 4x4 blocks A (left) and B (above) of each block, as
# (A in this MB, A's block, B in this MB, B's block): a copy of
# h264_fer_tpu/codec/decoder.py:_luma_blk_neighbors / _chroma_blk_neighbors
# (reference subMBNeighbours, residual.cpp:251-294). A block outside this
# MB lies in the left (A) or top (B) MB.
def _luma_blk_neighbors(blk: int):
    bx = int(INTRA4X4_SCAN_ORDER_XY[blk, 0]) // 4
    by = int(INTRA4X4_SCAN_ORDER_XY[blk, 1]) // 4
    return (bx > 0, int(RASTER_TO_LUMA_BLOCK[by * 4 + (bx - 1) % 4]),
            by > 0, int(RASTER_TO_LUMA_BLOCK[((by - 1) % 4) * 4 + bx]))


def _chroma_blk_neighbors(blk: int):
    bx, by = blk % 2, blk // 2
    return bx > 0, by * 2 + (bx - 1) % 2, by > 0, ((by - 1) % 2) * 2 + bx


LUMA_NBR = tuple(_luma_blk_neighbors(b) for b in range(16))
CHROMA_NBR = tuple(_chroma_blk_neighbors(b) for b in range(4))
