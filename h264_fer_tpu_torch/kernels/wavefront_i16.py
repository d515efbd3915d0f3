"""All-Intra16x16 frame reconstruction wavefront (K1) and its levels.

`i16_recon` is the wrapper of the CUDA kernel csrc/wavefront_i16.cu, which
replaces the Pallas kernel _i16_recon_kernel_body
(h264_fer_tpu/kernels/wavefront_pallas.py:890, via
pallas_i16_frame_fast_impl at :1170). On a CUDA tensor it launches the
kernel (one launch per MB anti-diagonal) or raises; on a CPU tensor it runs
`i16_recon_plain`, the same function in plain PyTorch: a Python loop over
the diagonals with vector ops over the MBs of each.

`i16_levels_from_recon` rebuilds the coefficient levels from the finished
reconstruction in one batched pass, as i16_levels_from_recon_impl
(wavefront_pallas.py:1089) does; `i16_frame` returns the tuple of
pallas_i16_frame_fast_impl.

Both the plain wavefront and the levels run one per-MB function,
`_i16_mb_code`, on MBs whose neighbours are final.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import intra, transform
from ..ops.device import const
from ..ops.tables import INTRA4X4_SCAN_ORDER_XY, LEVEL_QUANTIZE, LEVEL_SCALE
from ..ops.tiles import blocks_mb, chroma_blocks, chroma_mb, mb_blocks, neighbours, to_mbs
from . import build

# Z-scan block → its column / row in the MB's 4x4 grid of blocks
_ZX = (INTRA4X4_SCAN_ORDER_XY[:, 0] // 4).astype(np.int64)
_ZY = (INTRA4X4_SCAN_ORDER_XY[:, 1] // 4).astype(np.int64)


def _i16_mb_code(src, p33, modes, csrc, p17, cmodes, qp: int, qpc: int):
    """Code n MBs whose neighbours are final.

    src (n, 16, 16), p33 (n, 33), modes (n,); csrc (2, n, 8, 8), p17
    (2, n, 17), cmodes (n,), all int32. Returns (recon (n, 16, 16),
    crecon (2, n, 8, 8), i16dc (n, 16), ac (n, 16, 15), cdc (2, n, 4),
    cac (2, n, 4, 15)).
    """
    n = src.shape[0]
    preds = intra.predict_16x16_all_modes(p33)  # (4, n, 16, 16)
    pred = preds.gather(0, modes.long()[None, :, None, None].expand(1, n, 16, 16))[0]
    q = transform.quantize_residual(
        transform.forward_transform_4x4(mb_blocks(src - pred)), qp, True)
    zy, zx = const(_ZY, src.device), const(_ZX, src.device)
    dc = torch.zeros((n, 4, 4), dtype=torch.int32, device=src.device)
    dc[:, zy, zx] = q[:, :, 0, 0]
    qdc = transform.forward_dc_luma(dc, qp)
    i16dc = transform.zigzag_scan(qdc)
    ac = transform.zigzag_scan(q)[:, :, 1:]
    dcv = transform.inverse_dc_luma(qdc, qp)
    coef = transform.set_dc(q, dcv[:, zy, zx])
    res = transform.inverse_residual(coef, qp, True)
    recon = (pred + blocks_mb(res)).clamp(0, 255)

    cpreds = intra.predict_chroma_all_modes(p17)  # (4, 2, n, 8, 8)
    cidx = cmodes.long()[None, None, :, None, None].expand(1, 2, n, 8, 8)
    cpred = cpreds.gather(0, cidx)[0]
    cq = transform.quantize_residual(
        transform.forward_transform_4x4(chroma_blocks(csrc - cpred)), qpc, True)
    cqdc = transform.forward_dc_chroma(cq[..., 0, 0].reshape(2, n, 2, 2), qpc)
    cdcv = transform.inverse_dc_chroma(cqdc, qpc)
    cac = transform.zigzag_scan(cq)[..., 1:]
    ccoef = transform.set_dc(cq, cdcv.reshape(2, n, 4))
    cres = transform.inverse_residual(ccoef, qpc, True)
    crecon = (cpred + chroma_mb(cres)).clamp(0, 255)
    return recon, crecon, i16dc, ac, cqdc.reshape(2, n, 4), cac


def i16_recon_plain(y, cb, cr, modes, cmodes, qp: int, qpc: int):
    """Plain PyTorch K1: uint8 planes (H, W), (H/2, W/2) and int32 modes
    (nmb,) → uint8 recon planes. One step per anti-diagonal d = r + c."""
    h, w = y.shape
    hmb, wmb = h // 16, w // 16
    dev = y.device
    ysrc = to_mbs(y.to(torch.int32), 16)
    csrc = torch.stack([to_mbs(cb.to(torch.int32), 8),
                        to_mbs(cr.to(torch.int32), 8)])
    # recon planes with a -1 border on top and left: unavailable samples
    ypad = torch.full((h + 1, w + 1), -1, dtype=torch.int32, device=dev)
    cpad = torch.full((2, h // 2 + 1, w // 2 + 1), -1, dtype=torch.int32,
                      device=dev)
    i16 = torch.arange(16, device=dev)
    i8 = torch.arange(8, device=dev)
    for d in range(hmb + wmb - 1):
        r = torch.arange(max(0, d - wmb + 1), min(d, hmb - 1) + 1, device=dev)
        c = d - r
        mb = r * wmb + c
        # padded coordinates: pixel (py, px) of the plane is at (py+1, px+1)
        ry, cx = (16 * r)[:, None], (16 * c)[:, None]
        p33 = torch.cat([ypad[16 * r, 16 * c][:, None],
                         ypad[ry + 1 + i16, cx],
                         ypad[ry, cx + 1 + i16]], dim=-1)
        cry, ccx = (8 * r)[:, None], (8 * c)[:, None]
        p17 = torch.cat([cpad[:, 8 * r, 8 * c][..., None],
                         cpad[:, cry + 1 + i8, ccx],
                         cpad[:, cry, ccx + 1 + i8]], dim=-1)
        recon, crecon, *_ = _i16_mb_code(
            ysrc[mb], p33, modes[mb], csrc[:, mb], p17, cmodes[mb], qp, qpc)
        ypad[(ry + 1 + i16)[:, :, None], (cx + 1 + i16)[:, None, :]] = recon
        cpad[:, (cry + 1 + i8)[:, :, None], (ccx + 1 + i8)[:, None, :]] = crecon
    u8 = torch.uint8
    return (ypad[1:, 1:].to(u8), cpad[0, 1:, 1:].to(u8), cpad[1, 1:, 1:].to(u8))


def _qtab(qp: int, qpc: int) -> np.ndarray:
    """The 12 per-QP multipliers the kernel takes (see QTab in the .cu)."""
    def three(table, q):
        m = table[q % 6]
        return [int(m[0, 0]), int(m[1, 1]), int(m[0, 1])]
    return np.array(three(LEVEL_QUANTIZE, qp) + three(LEVEL_SCALE, qp)
                    + three(LEVEL_QUANTIZE, qpc) + three(LEVEL_SCALE, qpc),
                    dtype=np.int32)


def _lib():
    vp, i = ctypes.c_void_p, ctypes.c_int
    return build.function("wavefront_i16", "wavefront_i16_frame",
                          [vp] * 8 + [i] * 4 + [vp, vp, ctypes.POINTER(i)])


def i16_recon(y, cb, cr, modes, cmodes, qp: int, qpc: int):
    """K1: reconstruct an all-I16 frame. y (H, W), cb/cr (H/2, W/2) uint8;
    modes/cmodes (nmb,) int32 Intra16x16 and chroma modes. Returns the
    uint8 recon planes. CUDA tensors go to the kernel, CPU tensors to
    i16_recon_plain."""
    if y.device.type == "cpu":
        return i16_recon_plain(y, cb, cr, modes, cmodes, qp, qpc)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    h, w = y.shape
    if h % 16 or w % 16:
        raise ValueError(f"frame {w}x{h} is not a whole number of MBs")
    hmb, wmb = h // 16, w // 16
    for name, t, shape, dtype in (
            ("y", y, (h, w), torch.uint8),
            ("cb", cb, (h // 2, w // 2), torch.uint8),
            ("cr", cr, (h // 2, w // 2), torch.uint8),
            ("modes", modes, (hmb * wmb,), torch.int32),
            ("cmodes", cmodes, (hmb * wmb,), torch.int32)):
        build.check_tensor(name, t, shape, dtype, y.device)
    fn = _lib()
    ry, rcb, rcr = torch.empty_like(y), torch.empty_like(cb), torch.empty_like(cr)
    qtab = _qtab(qp, qpc)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    launched = ctypes.c_int(0)
    with torch.cuda.device(y.device):
        err = fn(y.data_ptr(), cb.data_ptr(), cr.data_ptr(), modes.data_ptr(),
                 cmodes.data_ptr(), ry.data_ptr(), rcb.data_ptr(),
                 rcr.data_ptr(), wmb, hmb, qp, qpc,
                 qtab.ctypes.data_as(ctypes.c_void_p), stream,
                 ctypes.byref(launched))
    i16_recon.launches += launched.value
    if err:
        raise RuntimeError(f"wavefront_i16 kernel launch failed: CUDA error {err}")
    return ry, rcb, rcr


# kernel launches so far, as counted by the C launch loop (one per
# accepted anti-diagonal launch)
i16_recon.launches = 0


def i16_levels_from_recon(y, cb, cr, ry, rcb, rcr, modes, cmodes,
                          qp: int, qpc: int):
    """Coefficient levels of an all-I16 frame from its reconstruction.

    Source planes and recon planes (any integer dtype) and the modes.
    Returns (i16dc (nmb, 16), ac (nmb, 16, 15), cdc (2, nmb, 4),
    cac (2, nmb, 4, 15)) int32, as i16_levels_from_recon_impl."""
    i32 = torch.int32
    csrc = torch.stack([to_mbs(cb.to(i32), 8), to_mbs(cr.to(i32), 8)])
    p17 = torch.stack([neighbours(rcb.to(i32), 8), neighbours(rcr.to(i32), 8)])
    _, _, i16dc, ac, cdc, cac = _i16_mb_code(
        to_mbs(y.to(i32), 16), neighbours(ry.to(i32), 16), modes,
        csrc, p17, cmodes, qp, qpc)
    return i16dc, ac, cdc, cac


def i16_frame(y, cb, cr, modes, cmodes, qp: int, qpc: int):
    """(recon_y, i16dc, ac, recon_cb, recon_cr, cdc, cac): the tuple of
    pallas_i16_frame_fast_impl, recon planes as uint8."""
    ry, rcb, rcr = i16_recon(y, cb, cr, modes, cmodes, qp, qpc)
    i16dc, ac, cdc, cac = i16_levels_from_recon(
        y, cb, cr, ry, rcb, rcr, modes, cmodes, qp, qpc)
    return ry, i16dc, ac, rcb, rcr, cdc, cac
