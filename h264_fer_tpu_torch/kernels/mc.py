"""Whole-frame motion compensation (K5).

`mc_bulk` is the wrapper of the CUDA kernel csrc/mc.cu, which replaces the
Pallas kernel _mc_kernel (h264_fer_tpu/kernels/mc_pallas.py:42, via
mc_bulk_pallas_impl at :98): luma and both chroma planes in one launch,
one thread per quadrant row reading aligned 32-bit words. On a CUDA tensor
it launches the kernel or raises; on a CPU tensor it runs `mc_luma_bulk`
and `mc_chroma_bulk`, the XLA contract twins (codec/tpu_pframe.py:284,411)
in plain PyTorch. On the CUDA route it refuses the bases the kernel
cannot read in words: planes and padded chroma not 4-byte aligned, MVs
not 8 (`check_aligned`).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

I32 = torch.int32


def _quadrant_origins(wmb: int, hmb: int, n: int, device):
    """(nmb, 4) x and y of each MB quadrant's top-left sample in a plane of
    n x n MBs (n = 16 luma, 8 chroma)."""
    q = torch.arange(4, device=device)
    mb = torch.arange(wmb * hmb, device=device)
    x0 = (mb % wmb)[:, None] * n + (q[None, :] & 1) * (n // 2)
    y0 = (mb // wmb)[:, None] * n + (q[None, :] >> 1) * (n // 2)
    return x0, y0


def _quadrants_to_plane(win, wmb: int, hmb: int):
    """(nmb, 4, s, s) quadrant windows → (hmb * 2s, wmb * 2s) plane."""
    s = win.shape[-1]
    win = win.reshape(hmb, wmb, 2, 2, s, s).permute(0, 2, 4, 1, 3, 5)
    return win.reshape(hmb * 2 * s, wmb * 2 * s)


def mc_luma_bulk(planes, mv, ext: int, wmb: int, hmb: int):
    """(H, W) int32 luma prediction at the quadrant-major qpel MVs mv
    (nmb, 4, 2), read from the 16-phase planes."""
    x0, y0 = _quadrant_origins(wmb, hmb, 16, planes.device)
    mvx, mvy = mv[..., 0].to(I32), mv[..., 1].to(I32)
    frac = ((mvy & 3) * 4 + (mvx & 3)).long()
    px = (x0 + (mvx >> 2) + ext).long()
    py = (y0 + (mvy >> 2) + ext).long()
    ii = torch.arange(8, device=planes.device)
    win = planes[frac[..., None, None],
                 (py[..., None] + ii)[..., :, None],
                 (px[..., None] + ii)[..., None, :]]
    return _quadrants_to_plane(win.to(I32), wmb, hmb)


def mc_chroma_bulk(c_pad, mv, ext_c: int, wmb: int, hmb: int):
    """(H/2, W/2) int32 eighth-pel bilinear prediction of one chroma plane
    (mocomp.cpp:176-195); c_pad from ops.interp.pad_chroma(ref, ext_c)."""
    x0, y0 = _quadrant_origins(wmb, hmb, 8, c_pad.device)
    mvx, mvy = mv[..., 0].to(I32), mv[..., 1].to(I32)
    cx = x0 + (mvx >> 3) + ext_c + 1
    cy = y0 + (mvy >> 3) + ext_c + 1
    fx = (mvx & 7)[..., None, None]
    fy = (mvy & 7)[..., None, None]
    ii = torch.arange(4, device=c_pad.device)
    ys = (cy[..., None] + ii)[..., :, None].long()
    xs = (cx[..., None] + ii)[..., None, :].long()
    c = c_pad.to(I32)
    out = ((8 - fx) * (8 - fy) * c[ys, xs] + fx * (8 - fy) * c[ys, xs + 1]
           + (8 - fx) * fy * c[ys + 1, xs] + fx * fy * c[ys + 1, xs + 1]
           + 32) >> 6
    return _quadrants_to_plane(out, wmb, hmb)


def mc_bulk_plain(planes, cb_pad, cr_pad, mv, ext: int, ext_c: int,
                  wmb: int, hmb: int):
    """(pred_y, pred_cb, pred_cr) int32 of mc_luma_bulk and mc_chroma_bulk."""
    return (mc_luma_bulk(planes, mv, ext, wmb, hmb),
            mc_chroma_bulk(cb_pad, mv, ext_c, wmb, hmb),
            mc_chroma_bulk(cr_pad, mv, ext_c, wmb, hmb))


def check_aligned(planes, cb_pad, cr_pad, mv) -> None:
    """Raise ValueError for a planes / cb_pad / cr_pad base that is not
    4-byte aligned or an mv base that is not 8-byte aligned: the kernel
    reads them in aligned words (its plain twin has no such need)."""
    for name, t, align in (("planes", planes, 4), ("cb_pad", cb_pad, 4),
                           ("cr_pad", cr_pad, 4), ("mv", mv, 8)):
        if t.data_ptr() % align:
            raise ValueError(f"{name}: the kernel reads it in aligned {align}-byte words")


def mc_bulk(planes, cb_pad, cr_pad, mv, ext: int, ext_c: int,
            wmb: int, hmb: int):
    """K5: mc_bulk_plain's function. CUDA tensors (planes and padded chroma
    uint8, mv int32) go to the kernel, CPU tensors to the plain version.
    On the kernel's route, raises ValueError for bases it cannot read in
    words (check_aligned)."""
    if planes.device.type == "cpu":
        return mc_bulk_plain(planes, cb_pad, cr_pad, mv, ext, ext_c, wmb, hmb)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    h, w = 16 * hmb, 16 * wmb
    dev = planes.device
    cshape = (h // 2 + 2 * ext_c + 2, w // 2 + 2 * ext_c + 2)
    build.check_tensor("planes", planes, (16, h + 2 * ext, w + 2 * ext),
                       torch.uint8, dev)
    build.check_tensor("cb_pad", cb_pad, cshape, torch.uint8, dev)
    build.check_tensor("cr_pad", cr_pad, cshape, torch.uint8, dev)
    build.check_tensor("mv", mv, (wmb * hmb, 4, 2), I32, dev)
    check_aligned(planes, cb_pad, cr_pad, mv)
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("mc", "mc_bulk", [vp] * 7 + [i] * 4 + [vp])
    pred_y = torch.empty((h, w), dtype=I32, device=dev)
    pred_cb = torch.empty((h // 2, w // 2), dtype=I32, device=dev)
    pred_cr = torch.empty((h // 2, w // 2), dtype=I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(planes.data_ptr(), cb_pad.data_ptr(), cr_pad.data_ptr(),
                 mv.data_ptr(), pred_y.data_ptr(), pred_cb.data_ptr(),
                 pred_cr.data_ptr(), w, h, ext, ext_c, stream)
    if err:
        raise RuntimeError(f"mc kernel launch failed: CUDA error {err}")
    mc_bulk.launches += 1
    return pred_y, pred_cb, pred_cr


# kernel launches so far (one per accepted launch)
mc_bulk.launches = 0
