"""Integer full-search score map (K2).

`integer_score_map` is the wrapper of the CUDA kernel csrc/me_int.cu, which
replaces the Pallas kernel _int_kernel
(h264_fer_tpu/kernels/me_int_pallas.py:34, via
integer_score_map_pallas_impl at :73) and the block fold after it. On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs
`integer_score_map_plain`, the XLA contract twin
codec/tpu_pframe.integer_score_map (tpu_pframe.py:126) in plain PyTorch:
one step per shift row dy, all dx shifts of the row at once.

`me_metric` is the distortion of codec/tpu_pframe._metric, shared by the
motion-search kernels of this package.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

I32 = torch.int32


def me_metric(d, metric_id: int):
    """Per-sample distortion: |d| (SAD), d^2 (SSD) or 2 d^2 (2*SSD)."""
    if metric_id == 0:
        return d.abs()
    d = d * d
    return 2 * d if metric_id == 2 else d


def integer_score_map_plain(src_y, plane0, ext: int, window: int,
                            metric_id: int):
    """(nb, S*S) int32 distortion of every 8x8 block of src_y (H, W) at every
    integer shift in ±window, read from plane0 (H + 2 ext, W + 2 ext); shift
    index (dy + window) * S + (dx + window). Any integer dtypes."""
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
    return torch.stack(rows).reshape(S * S, hb * wb).T.contiguous()


def integer_score_map(src_y, plane0, ext: int, window: int, metric_id: int):
    """K2: integer_score_map_plain's function. CUDA tensors (src_y and plane0
    uint8, contiguous) go to the kernel, CPU tensors to the plain version."""
    if src_y.device.type == "cpu":
        return integer_score_map_plain(src_y, plane0, ext, window, metric_id)
    if src_y.device.type != "cuda":
        raise ValueError(f"unsupported device {src_y.device}")
    h, w = src_y.shape
    if h % 8 or w % 8 or not 0 <= window <= ext:
        raise ValueError(f"frame {w}x{h}, window {window}, ext {ext}")
    build.check_tensor("src_y", src_y, (h, w), torch.uint8, src_y.device)
    build.check_tensor("plane0", plane0, (h + 2 * ext, w + 2 * ext),
                       torch.uint8, src_y.device)
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("me_int", "me_int_score_map",
                        [vp, vp, vp, i, i, i, i, i, vp])
    S = 2 * window + 1
    out = torch.empty(((h // 8) * (w // 8), S * S), dtype=I32,
                      device=src_y.device)
    stream = torch.cuda.current_stream(src_y.device).cuda_stream
    with torch.cuda.device(src_y.device):
        err = fn(src_y.data_ptr(), plane0.data_ptr(), out.data_ptr(), w, h,
                 ext, window, metric_id, stream)
    if err:
        raise RuntimeError(f"me_int kernel launch failed: CUDA error {err}")
    integer_score_map.launches += 1
    return out


# kernel launches so far (one per accepted launch)
integer_score_map.launches = 0
