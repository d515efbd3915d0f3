"""Integer full-search score map (K2).

`integer_score_map` is the wrapper of the CUDA kernel csrc/me_int.cu, which
replaces the Pallas kernel _int_kernel
(h264_fer_tpu/kernels/me_int_pallas.py:34, via
integer_score_map_pallas_impl at :73), the block fold after it and, for the
P frame, the argmin of codec/tpu_pframe.py:230 and the map's copy into
MB-quadrant order. On a CUDA tensor it launches the kernel or raises; on a
CPU tensor it runs `integer_score_map_plain`: the XLA contract twin
codec/tpu_pframe.integer_score_map (tpu_pframe.py:126) in plain PyTorch,
one step per shift row dy, all dx shifts of the row at once, and for the
P frame the reorder and argmin that codec/pframe.py ran after it. One
launch a call, counted on `integer_score_map.launches`.

`me_metric` is the distortion of codec/tpu_pframe._metric, shared by the
motion-search kernels of this package.
"""

from __future__ import annotations

import torch

from ..ops.tiles import blocks_to_mbq
from . import build

I32 = torch.int32


def me_metric(d, metric_id: int):
    """Per-sample distortion: |d| (SAD), d^2 (SSD) or 2 d^2 (2*SSD)."""
    if metric_id == 0:
        return d.abs()
    d = d * d
    return 2 * d if metric_id == 2 else d


def integer_score_map_plain(src_y, plane0, ext: int, window: int, metric_id: int,
                            p_frame: bool = False):
    """(nb, S*S) int32 distortion of every 8x8 block of src_y (H, W) at every
    integer shift in ±window, read from plane0 (H + 2 ext, W + 2 ext); shift
    index (dy + window) * S + (dx + window); rows in raster block order.
    With `p_frame` (H and W multiples of 16), what the P frame's decision
    takes: (the rows in MB-quadrant order, ops/tiles.blocks_to_mbq's;
    each block's first least shift index (nb,) int32 in raster block
    order). Any integer dtypes."""
    h, w = src_y.shape
    hb, wb = h // 8, w // 8
    S = 2 * window + 1
    src = src_y.to(I32)
    p0 = plane0.to(I32)
    o = ext - window
    rows = []
    for dy in range(S):
        strip = p0[o + dy: o + dy + h]
        win = torch.stack([strip[:, o + dx: o + dx + w] for dx in range(S)])
        m = me_metric(win - src, metric_id)
        rows.append(m.reshape(S, hb, 8, wb, 8).sum(dim=(2, 4), dtype=I32)
                    .reshape(S, hb * wb))
    smap = torch.stack(rows).reshape(S * S, hb * wb).T.contiguous()
    if not p_frame:
        return smap
    return (blocks_to_mbq(smap, wb // 2, hb // 2).view(smap.shape),
            smap.argmin(dim=1).to(I32))


def _check(src_y, plane0, ext: int, window: int, metric_id: int, p_frame: bool) -> None:
    """ValueError unless src_y is a contiguous uint8 (H, W) plane, H and W
    multiples of 8 (of 16 with p_frame), plane0 a contiguous uint8 (H + 2 ext,
    W + 2 ext) plane on its device, both 4-byte aligned (the kernel reads
    them in words), 0 <= window <= ext and metric_id 0, 1 or 2."""
    if src_y.dim() != 2:
        raise ValueError(f"src_y: expected an (H, W) plane, got {tuple(src_y.shape)}")
    h, w = src_y.shape
    n = 16 if p_frame else 8
    if not h or not w or h % n or w % n:
        raise ValueError(f"frame {w}x{h} is not a multiple of {n}")
    if not 0 <= window <= ext:
        raise ValueError(f"window {window}, ext {ext}: need 0 <= window <= ext")
    if metric_id not in (0, 1, 2):
        raise ValueError(f"metric_id {metric_id} is not 0, 1 or 2")
    build.check_tensor("src_y", src_y, (h, w), torch.uint8, src_y.device)
    build.check_tensor("plane0", plane0, (h + 2 * ext, w + 2 * ext), torch.uint8,
                       src_y.device)
    for name, t in (("src_y", src_y), ("plane0", plane0)):
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: the kernel reads it in aligned 4-byte words")


def integer_score_map(src_y, plane0, ext: int, window: int, metric_id: int,
                      p_frame: bool = False):
    """K2: integer_score_map_plain's function, in one launch on the card
    (src_y and plane0 uint8, contiguous, 4-byte aligned; with `p_frame`
    the map in MB-quadrant order and the index); CPU tensors go to the
    plain version."""
    if src_y.device.type == "cpu":
        return integer_score_map_plain(src_y, plane0, ext, window, metric_id, p_frame)
    if src_y.device.type != "cuda":
        raise ValueError(f"unsupported device {src_y.device}")
    return launch(src_y, plane0, ext, window, metric_id, p_frame)


def launch(src_y, plane0, ext: int, window: int, metric_id: int, p_frame: bool):
    """The kernel's route of integer_score_map: refuse what the kernel does
    not take (`_check`), then one launch on the current stream of src_y's
    device, counted on integer_score_map.launches."""
    _check(src_y, plane0, ext, window, metric_id, p_frame)
    h, w = src_y.shape
    nb, S = (h // 8) * (w // 8), 2 * window + 1
    out = torch.empty((nb, S * S), dtype=I32, device=src_y.device)
    idx = torch.empty(nb, dtype=I32, device=src_y.device) if p_frame else None
    build.launch(integer_score_map, "me_int", "me_int_score_map",
                 (src_y, plane0, out, idx, w, h, ext, window, metric_id, int(p_frame)),
                 src_y.device)
    return (out, idx) if p_frame else out


# kernel launches so far (one per accepted launch)
integer_score_map.launches = 0
