"""Stable top-K selection of integer MV candidates (K9).

`topk_candidates` is the wrapper of the CUDA kernel csrc/me_topk.cu, which
replaces `jax.lax.top_k(-sads_all.T, topk)` and the MV arithmetic after it
in h264_fer_tpu/ops/me.full_search_topk (ops/me.py:56-58; the function at
:27). On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
runs `topk_candidates_plain`: a stable sort of each row of the score map,
cut to its first topk columns. Either way the candidates are in ascending
score order, ties to the lower shift index, so slot 0 is the first least
score: the order lax.top_k gives and the host search relies on.
torch.topk leaves the order of ties open and is used nowhere here.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

I32 = torch.int32


def _check(score_map, window: int, topk: int) -> int:
    """The map's block count; ValueError unless score_map is (nb, S*S),
    S = 2 window + 1, and 1 <= topk <= S*S."""
    ss = (2 * window + 1) ** 2
    if window < 0 or score_map.dim() != 2 or score_map.shape[1] != ss or not score_map.shape[0]:
        raise ValueError(f"score map {tuple(score_map.shape)}: expected (nb, {ss}) "
                         f"for window {window}")
    if not 1 <= topk <= ss:
        raise ValueError(f"topk {topk} outside 1..{ss} (window {window})")
    return score_map.shape[0]


def topk_candidates_plain(score_map, window: int, topk: int):
    """(sads, mvx, mvy), each (nb, topk) int32: per row of the (nb, S*S) map
    the topk least scores by a stable sort, and their shifts as quarter-pel
    MVs."""
    _check(score_map, window, topk)
    vals, idx = torch.sort(score_map.to(I32), dim=1, stable=True)
    idx = idx[:, :topk].to(I32)
    S = 2 * window + 1
    return (vals[:, :topk].contiguous(), (idx % S - window) * 4, (idx // S - window) * 4)


def topk_candidates(score_map, window: int, topk: int):
    """K9: topk_candidates_plain's function. A CUDA map (int32, contiguous)
    goes to the kernel, which writes one (3, nb, topk) buffer; the three
    results are its planes. A CPU map goes to the plain version."""
    nb = _check(score_map, window, topk)
    if score_map.device.type == "cpu":
        return topk_candidates_plain(score_map, window, topk)
    if score_map.device.type != "cuda":
        raise ValueError(f"unsupported device {score_map.device}")
    dev = score_map.device
    build.check_tensor("score_map", score_map, (nb, (2 * window + 1) ** 2), I32, dev)
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("me_topk", "me_topk_select", [vp, vp, i, i, i, vp])
    out = torch.empty((3, nb, topk), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        err = fn(score_map.data_ptr(), out.data_ptr(), nb, window, topk,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"me_topk kernel launch failed: CUDA error {err}")
    topk_candidates.launches += 1
    return out[0], out[1], out[2]


# kernel launches so far (one per accepted launch)
topk_candidates.launches = 0
