"""The one-launch dataflow schedule of the persistent wavefronts K4
(csrc/wavefront_p.cu) and K6 (csrc/wavefront_mixed.cu), whose device side
is csrc/mb_dataflow.cuh.

A launch hands out its MBs by ticket in `knight_order`; each MB waits for
the ready flags of its left, top, top-right and top-left neighbours, codes
itself and sets its own flag. The order is topological for those
dependencies, which is what makes a grid of any size finish.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.device import const


@functools.lru_cache(maxsize=16)
def knight_order(wmb: int, hmb: int) -> np.ndarray:
    """Raster indices (r * wmb + c) of the wmb x hmb MBs in knight order:
    d = c + 2r ascending, then r. Read-only int32 (nmb,)."""
    r, c = np.divmod(np.arange(wmb * hmb), wmb)
    order = np.lexsort((r, c + 2 * r)).astype(np.int32)
    order.flags.writeable = False
    return order


def schedule(wmb: int, hmb: int, device):
    """The dataflow arguments of one launch over a wmb x hmb frame: the
    knight order on `device` (uploaded once) and the scratch of nmb ready
    flags and one ticket counter (zeroed, int32 (nmb + 1,))."""
    return (const(knight_order(wmb, hmb), device),
            torch.zeros(wmb * hmb + 1, dtype=torch.int32, device=device))


def check_blocks(blocks) -> int:
    """The grid size argument of the C entry points: 0 for None (as many
    blocks as fit on the card at once), else `blocks` if it is a positive
    int; raises ValueError otherwise."""
    if blocks is None:
        return 0
    if not isinstance(blocks, (int, np.integer)) or blocks < 1:
        raise ValueError(f"blocks must be None or a positive int, got {blocks!r}")
    return int(blocks)
