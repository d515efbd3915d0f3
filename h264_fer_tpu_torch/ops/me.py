"""Device full search with top-K integer candidates per 8x8 block.

The counterpart of h264_fer_tpu/ops/me.py (full_search_topk, :27, and its
session wrapper TpuMePipeline, :61), which the CLI's `encode --tpu-me`
runs: the SAD of every 8x8 block of the frame at every integer shift in
±window, and per block the topk least, in ascending SAD order with ties to
the lower shift index. The host P search (codec/encoder_host.py) re-ranks
them with its |mv − mvp| cost.

Two kernels compute it: K2 (kernels/me_int.integer_score_map) with metric
0, whose map is this function's SAD map, and K9
(kernels/me_topk.topk_candidates), the selection. K2 reads plane 0 of a
reference edge-extended by ext >= window: the reference padded here by
`window` in edge mode, as the JAX function pads it (the reference window
is edge-clamped, mocomp.cpp:11-36), or plane 0 of the interpolated planes
the host P frame has already built (`candidates`). The candidates are SAD
at every QP, whatever metric the host search itself uses.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.me_int import integer_score_map
from ..kernels.me_topk import topk_candidates
from .device import DEFAULT_DEVICE, resolve_device, upload
from .interp import edge_pad


def candidates(src_y, plane0, ext: int, window: int, topk: int = 16):
    """(sads, mvx, mvy), each (nb, topk) int32, of the (H, W) luma src_y
    against plane0, the reference edge-extended by ext >= window (uint8 on a
    card; any integer dtype on the CPU): K2 with metric 0, then K9."""
    h, w = src_y.shape
    if h % 8 or w % 8:
        raise ValueError(f"frame {w}x{h} is not a multiple of 8")
    if src_y.device.type == "cuda":
        src_y = src_y.to(torch.uint8).contiguous()
    return topk_candidates(integer_score_map(src_y, plane0, ext, window, 0), window, topk)


def full_search_topk(src_y, ref_y, window: int = 8, topk: int = 16):
    """Top-K integer MV candidates per 8x8 block (ops/me.full_search_topk).

    src_y, ref_y: (H, W) tensors of samples 0..255 on one device. Returns
    (sads, mvx, mvy), each (nb, topk) int32, MVs in quarter pel, blocks in
    raster order of the 8x8 grid."""
    plane0 = edge_pad(ref_y.to(torch.uint8), window).contiguous()
    return candidates(src_y, plane0, window, window, topk)


class TpuMePipeline:
    """Session wrapper of full_search_topk (TpuMePipeline's contract): numpy
    planes in, numpy arrays out, the search on `device`."""

    def __init__(self, window: int = 8, topk: int = 16, device=DEFAULT_DEVICE) -> None:
        self.window = window
        self.topk = topk
        self.device = resolve_device(device)

    def __call__(self, src_y: np.ndarray, ref_y: np.ndarray):
        src, ref = (upload(p, self.device) for p in (src_y, ref_y))
        out = torch.stack(full_search_topk(src, ref, self.window, self.topk))
        sads, mvx, mvy = out.cpu().numpy()  # one read-back
        return sads, mvx, mvy
