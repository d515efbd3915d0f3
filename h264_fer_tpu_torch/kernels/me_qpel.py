"""Quarter-pel refinement maps (K3).

`qpel_refine_maps` is the wrapper of the CUDA kernel csrc/me_qpel.cu, which
replaces the Pallas kernel _refine_kernel (h264_fer_tpu/kernels/me_pallas.py:28,
via qpel_refine_pallas_impl at :154): both 49-offset maps of a frame in one
launch, one warp per (block, centre) scoring the 49 offsets from the 16
phase tiles it stages in shared memory, in packed bytes. On a CUDA tensor
it launches the kernel or raises; on a CPU tensor it runs
`qpel_refine_map_plain` once per centre, the XLA contract twin
codec/tpu_pframe.qpel_refine_map (tpu_pframe.py:156) in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .me_int import me_metric

I32 = torch.int32


def qpel_refine_map_plain(src_y, planes, center_mv, ext: int, metric_id: int,
                          radius: int = 3):
    """(nb, (2r+1)^2) int32 distortion of every 8x8 block of src_y at the
    quarter-pel offsets around its centre center_mv (nb, 2) (x, y); offset
    index (dy + r) * (2r+1) + (dx + r). planes: (16, he, we) from
    ops.interp.interpolated_planes; every window must lie inside them."""
    h, w = src_y.shape
    hb, wb = h // 8, w // 8
    nb = hb * wb
    dev = src_y.device
    src_blk = (src_y.to(I32).reshape(hb, 8, wb, 8).transpose(1, 2)
               .reshape(nb, 8, 8))
    blk = torch.arange(nb, device=dev)
    bx0, by0 = (blk % wb) * 8, (blk // wb) * 8
    ii = torch.arange(8, device=dev)
    center = center_mv.to(I32)
    cols = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            mvx = center[:, 0] + dx
            mvy = center[:, 1] + dy
            frac = ((mvy & 3) * 4 + (mvx & 3)).long()
            px = bx0 + (mvx >> 2) + ext
            py = by0 + (mvy >> 2) + ext
            win = planes[frac[:, None, None],
                         (py[:, None] + ii)[:, :, None].long(),
                         (px[:, None] + ii)[:, None, :].long()]
            cols.append(me_metric(win.to(I32) - src_blk, metric_id)
                        .sum(dim=(1, 2), dtype=I32))
    return torch.stack(cols, dim=-1)


def qpel_refine_maps(src_y, planes, c1, c2, ext: int, metric_id: int):
    """K3: (q1, q2), the (nb, 49) refinement maps around the centres c1 and
    c2 (nb, 2). CUDA tensors (src_y and planes uint8, centres int32) go to
    the kernel, CPU tensors to qpel_refine_map_plain."""
    if src_y.device.type == "cpu":
        return (qpel_refine_map_plain(src_y, planes, c1, ext, metric_id),
                qpel_refine_map_plain(src_y, planes, c2, ext, metric_id))
    if src_y.device.type != "cuda":
        raise ValueError(f"unsupported device {src_y.device}")
    h, w = src_y.shape
    if h % 8 or w % 8:
        raise ValueError(f"frame {w}x{h} is not a whole number of 8x8 blocks")
    nb = (h // 8) * (w // 8)
    dev = src_y.device
    build.check_tensor("src_y", src_y, (h, w), torch.uint8, dev)
    build.check_tensor("planes", planes, (16, h + 2 * ext, w + 2 * ext),
                       torch.uint8, dev)
    build.check_tensor("c1", c1, (nb, 2), I32, dev)
    build.check_tensor("c2", c2, (nb, 2), I32, dev)
    if min(h, w) + 2 * ext < 9:
        raise ValueError(f"planes {w + 2 * ext}x{h + 2 * ext}: the kernel stages "
                         "9x9 phase tiles")
    for name, t in (("src_y", src_y), ("planes", planes)):
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: the kernel reads it in aligned 4-byte words")
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("me_qpel", "me_qpel_refine",
                        [vp] * 6 + [i] * 4 + [vp])
    q1 = torch.empty((nb, 49), dtype=I32, device=dev)
    q2 = torch.empty((nb, 49), dtype=I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(src_y.data_ptr(), planes.data_ptr(), c1.data_ptr(),
                 c2.data_ptr(), q1.data_ptr(), q2.data_ptr(), w, h, ext,
                 metric_id, stream)
    if err:
        raise RuntimeError(f"me_qpel kernel launch failed: CUDA error {err}")
    qpel_refine_maps.launches += 1
    return q1, q2


# kernel launches so far (one per accepted launch)
qpel_refine_maps.launches = 0
