"""P-frame residual, transform, quantisation and reconstruction (K12).

`residual_recon` is the wrapper of the CUDA kernel csrc/residual_p.cu, the
device form of the XLA stage pframe_residual_recon
(h264_fer_tpu/codec/tpu_pframe.py:343), which no Pallas kernel replaced. It
takes CUDA tensors only: codec/pframe.pframe_residual_recon sends CPU
tensors to its plain twin (pframe_residual_recon_plain) and CUDA ones here,
and the wrapper returns what the twin returns, equal bit for bit. One
launch a P frame or band, counted on `residual_recon.launches`, writes one
int32 buffer whose parts are the outputs.
"""

from __future__ import annotations

import torch

from . import build
from .wavefront_i16 import qtab

I32 = torch.int32
# the output buffer's parts, in ints per MB, in the C entry point's order
PARTS = (("luma", 256), ("cdc", 8), ("cac", 120), ("recon_y", 256), ("recon_cb", 64),
         ("recon_cr", 64))


def _cuda(t) -> None:
    """ValueError unless t lies on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError("K12 takes CUDA tensors; codec/pframe.py sends CPU tensors "
                         "to the plain twin")


def _check(src, pred, skip, maxdiff, wmb: int, hmb: int, qp: int, qpc: int) -> None:
    """ValueError unless the planes are contiguous (16 hmb, 16 wmb) luma and
    (8 hmb, 8 wmb) chroma planes on one device, the sources uint8 and
    4-byte aligned, the predictions int32 and 16-byte aligned (the kernel
    reads them in words), skip (nmb,) bool, maxdiff (nmb,) int32, and qp
    and qpc in 0..51."""
    dev = src[0].device
    if wmb <= 0 or hmb <= 0:
        raise ValueError(f"no MBs: wmb {wmb}, hmb {hmb}")
    for name, t, n, dtype, align in (
            ("src_y", src[0], 16, torch.uint8, 4), ("src_cb", src[1], 8, torch.uint8, 4),
            ("src_cr", src[2], 8, torch.uint8, 4), ("pred_y", pred[0], 16, I32, 16),
            ("pred_cb", pred[1], 8, I32, 16), ("pred_cr", pred[2], 8, I32, 16)):
        build.check_tensor(name, t, (n * hmb, n * wmb), dtype, dev)
        if t.data_ptr() % align:
            raise ValueError(f"{name}: the kernel reads it in aligned {align}-byte words")
    build.check_tensor("skip", skip, (wmb * hmb,), torch.bool, dev)
    build.check_tensor("maxdiff", maxdiff, (wmb * hmb,), I32, dev)
    for name, q in (("qp", qp), ("qpc", qpc)):
        if not 0 <= q <= 51:
            raise ValueError(f"{name} {q} outside 0..51")


def residual_recon(src_y, src_cb, src_cr, pred_y, pred_cb, pred_cr, skip, maxdiff,
                   wmb: int, hmb: int, qp: int, qpc: int, prefilter: bool):
    """K12: pframe_residual_recon_plain's (levels dict: luma (nmb, 16, 16),
    cdc (2, nmb, 4), cac (2, nmb, 4, 15); recon_y, recon_cb, recon_cr), all
    int32, of CUDA planes (sources uint8, predictions int32)."""
    src, pred = (src_y, src_cb, src_cr), (pred_y, pred_cb, pred_cr)
    _check(src, pred, skip, maxdiff, wmb, hmb, qp, qpc)
    _cuda(src_y)
    nmb = wmb * hmb
    out = torch.empty((sum(n for _, n in PARTS) * nmb,), dtype=I32, device=src_y.device)
    build.launch(residual_recon, "residual_p", "residual_p",
                 (*src, *pred, skip, maxdiff, out, wmb, hmb, qp, qpc, int(prefilter),
                  qtab(qp), qtab(qpc)), src_y.device)
    shapes = {"luma": (nmb, 16, 16), "cdc": (2, nmb, 4), "cac": (2, nmb, 4, 15),
              "recon_y": pred_y.shape, "recon_cb": pred_cb.shape, "recon_cr": pred_cr.shape}
    parts = {name: t.view(shapes[name])
             for (name, _), t in zip(PARTS, out.split([n * nmb for _, n in PARTS]))}
    levels = {k: parts[k] for k in ("luma", "cdc", "cac")}
    return levels, parts["recon_y"], parts["recon_cb"], parts["recon_cr"]


# kernel launches so far (one per accepted launch)
residual_recon.launches = 0
