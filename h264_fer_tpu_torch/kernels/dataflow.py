"""The one-launch dataflow schedule of the persistent wavefronts, whose
device side is csrc/mb_dataflow.cuh.

A launch hands out its MBs by ticket in an order uploaded by `schedule`;
each MB waits for the ready flags of the neighbours in its kernel's wait
set, codes itself and sets its own flag. The order is topological for the
wait set, which is what makes a grid of any size finish:
- K4 (csrc/wavefront_p.cu), K6 (csrc/wavefront_mixed.cu), K4x4
  (csrc/wavefront_i4x4.cu) and K8 (csrc/deblock.cu) wait on left, top,
  top-right and top-left and take `knight_order`: K4's MV predictor and
  the Intra_4x4 prediction of K6 and K4x4 read the top-right MB's final
  state (block 5 reads its row 15), and K8's top edge reads samples that
  the top-right MB's left edge filters first in the norm's raster order.
  K4x4 waits per 4x4-block step on edge slots that carry the samples, in
  place of the ready flags (8 per MB, zeroed with the ticket counter in
  one buffer: wavefront_i4x4.scratch);
- K1 / K1t and K7 (csrc/wavefront_i16.cu) wait on left, top and top-left
  and take `diagonal_order`: Intra_16x16 and chroma prediction read no
  top-right sample, so the diagonals d = r + c are the shortest chain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.device import const


def _order(wmb: int, hmb: int, dr: int) -> np.ndarray:
    """Raster indices of the wmb x hmb MBs sorted by d = c + dr * r, then r;
    read-only int32 (nmb,)."""
    r, c = np.divmod(np.arange(wmb * hmb), wmb)
    order = np.lexsort((r, c + dr * r)).astype(np.int32)
    order.flags.writeable = False
    return order


@functools.lru_cache(maxsize=16)
def knight_order(wmb: int, hmb: int) -> np.ndarray:
    """Raster indices (r * wmb + c) of the wmb x hmb MBs in knight order:
    d = c + 2r ascending, then r. Read-only int32 (nmb,)."""
    return _order(wmb, hmb, 2)


@functools.lru_cache(maxsize=16)
def diagonal_order(wmb: int, hmb: int) -> np.ndarray:
    """Raster indices of the wmb x hmb MBs in anti-diagonal order: d = r + c
    ascending, then r. Read-only int32 (nmb,); topological for left, top
    and top-left."""
    return _order(wmb, hmb, 1)


def schedule(order: np.ndarray, device):
    """The dataflow arguments of one launch: the ticket order (a
    knight_order or diagonal_order) on `device` (uploaded once) and the
    scratch of nmb ready flags and one ticket counter (zeroed, int32
    (nmb + 1,))."""
    return (const(order, device),
            torch.zeros(order.size + 1, dtype=torch.int32, device=device))


def check_blocks(blocks) -> int:
    """The grid size argument of the C entry points: 0 for None (as many
    blocks as fit on the card at once), else `blocks` if it is a positive
    int; raises ValueError otherwise."""
    if blocks is None:
        return 0
    if not isinstance(blocks, (int, np.integer)) or blocks < 1:
        raise ValueError(f"blocks must be None or a positive int, got {blocks!r}")
    return int(blocks)
