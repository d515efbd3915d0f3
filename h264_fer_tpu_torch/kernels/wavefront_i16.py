"""All-Intra16x16 frame reconstruction wavefront (K1), the same writing
its levels (K1t), its chroma half (K7), and their levels.

`i16_recon` is the wrapper of the CUDA kernel csrc/wavefront_i16.cu, which
replaces the Pallas kernel _i16_recon_kernel_body
(h264_fer_tpu/kernels/wavefront_pallas.py:890, via
pallas_i16_frame_fast_impl at :1170). On a CUDA tensor it launches the
kernel (one launch per frame: a persistent grid takes the MBs in
anti-diagonal order and starts each as soon as its left, top and top-left
neighbours are coded, kernels/dataflow.py) or raises; on a CPU tensor it
runs `i16_recon_plain`, the same function in plain PyTorch: a Python loop
over the diagonals with vector ops over the MBs of each.

`i16_frame` (K1t) replaces the Pallas kernel _i16_kernel_body
(wavefront_pallas.py:173, via pallas_i16_frame at :437) and returns its
tuple: on a CUDA tensor one launch of K1's kernel that also writes the
levels (the C entry point wavefront_i16_frame_levels); on a CPU tensor
`i16_frame_plain`, plain K1 then `i16_levels_from_recon`, which rebuilds
the levels from the finished reconstruction in one batched pass, as
i16_levels_from_recon_impl (wavefront_pallas.py:1089) does.

`chroma_recon` and `chroma_frame` (K7) run K1's chroma half as a kernel of
its own, one launch per frame on the same schedule (the C entry points
wavefront_chroma_frame and wavefront_chroma_frame_levels; both kernels run
csrc/intra16.cuh's chroma_mb): the device form of the XLA loop
wavefront_chroma_impl (h264_fer_tpu/kernels/wavefront.py:222) that the
mixed I frame runs, where the luma is K6's. `chroma_frame` returns that
function's tuple, the levels written by the kernel as they leave the
quantiser; `chroma_recon` the recon planes alone. Their plain twins are
`chroma_frame_plain` (`chroma_recon_plain`, then `chroma_levels_from_recon`)
and `chroma_recon_plain`. K1 reconstructs chroma by the same rule (chroma
mode given per MB, chroma QP, 2x2 DC path).

`i16_band` (K1t-band) and `chroma_band` (K7-band) are K1t and K7 over one
MB-row band of a frame: the device forms of the XLA loop
_banded_i16_wavefront (h264_fer_tpu/parallel/tile.py:57, fori_loop at :240)
and of wavefront_chroma_impl's band= form (wavefront.py:237-330). Their
`top` is the band above's last recon rows, which the band's first MB row
reads as its top neighbours (the C entry points wavefront_i16_band_levels
and wavefront_chroma_band_levels, with the halo copied into the row above
the band's recon planes); their plain twins are `i16_frame_plain` and
`chroma_frame_plain` with the same `top`. Their launches count on
`i16_band.launches` and `chroma_band.launches`.

The plain wavefronts and the levels run the per-MB functions
`_i16_luma_code` and `_chroma_code` on MBs whose neighbours are final.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import intra, transform
from ..ops.device import const
from ..ops.tables import INTRA4X4_SCAN_ORDER_XY, LEVEL_QUANTIZE, LEVEL_SCALE
from ..ops.tiles import blocks_mb, chroma_blocks, chroma_mb, mb_blocks, neighbours, to_mbs
from . import build, dataflow

# Z-scan block → its column / row in the MB's 4x4 grid of blocks
_ZX = (INTRA4X4_SCAN_ORDER_XY[:, 0] // 4).astype(np.int64)
_ZY = (INTRA4X4_SCAN_ORDER_XY[:, 1] // 4).astype(np.int64)


def _i16_luma_code(src, p33, modes, qp: int):
    """Code n Intra16x16 MBs whose neighbours are final: src (n, 16, 16),
    p33 (n, 33), modes (n,), int32. Returns (recon (n, 16, 16), i16dc
    (n, 16), ac (n, 16, 15))."""
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
    return (pred + blocks_mb(res)).clamp(0, 255), i16dc, ac


def _chroma_code(csrc, p17, cmodes, qpc: int):
    """Code the chroma of n MBs whose neighbours are final: csrc
    (2, n, 8, 8), p17 (2, n, 17), cmodes (n,), int32. Returns (crecon
    (2, n, 8, 8), cdc (2, n, 4), cac (2, n, 4, 15))."""
    n = csrc.shape[1]
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
    return (cpred + chroma_mb(cres)).clamp(0, 255), cqdc.reshape(2, n, 4), cac


def _diagonals(hmb: int, wmb: int, dev):
    """(r, c, mb) of each MB anti-diagonal d = r + c, in order."""
    for d in range(hmb + wmb - 1):
        r = torch.arange(max(0, d - wmb + 1), min(d, hmb - 1) + 1, device=dev)
        yield r, d - r, r * wmb + d - r


def _recon_planes(p: int, h: int, w: int, dev, top=None):
    """p int32 recon planes of h x w samples with a -1 border on top and
    left, the unavailable samples: sample (y, x) is at (y + 1, x + 1). The
    diagonals fill the rest. top: None, or the p rows (w,) above the planes
    (a band's halo), which fill the top border."""
    pad = torch.full((p, h + 1, w + 1), -1, dtype=torch.int32, device=dev)
    if top is not None:
        pad[:, 0, 1:] = torch.stack(tuple(top))
    return pad


def _step(pad, r, c, n: int, code):
    """Reconstruct the n x n MBs (r, c) of one diagonal into the padded
    recon planes pad (p, H + 1, W + 1): `code` maps the MBs' neighbours
    (p, k, 2n + 1) to their recon (p, k, n, n)."""
    i = torch.arange(n, device=pad.device)
    ry, cx = (n * r)[:, None], (n * c)[:, None]
    nbr = torch.cat([pad[:, n * r, n * c][..., None], pad[:, ry + 1 + i, cx],
                     pad[:, ry, cx + 1 + i]], dim=-1)
    pad[:, (ry + 1 + i)[:, :, None], (cx + 1 + i)[:, None, :]] = code(nbr)


def i16_recon_plain(y, cb, cr, modes, cmodes, qp: int, qpc: int, top=None):
    """Plain PyTorch K1: uint8 planes (H, W), (H/2, W/2) and int32 modes
    (nmb,) → uint8 recon planes. One step per anti-diagonal d = r + c.
    top: None, or the recon rows (y (W,), cb (W/2,), cr (W/2,)) above the
    planes, when they are an MB-row band below another."""
    h, w = y.shape
    ysrc = to_mbs(y.to(torch.int32), 16)
    csrc = torch.stack([to_mbs(cb.to(torch.int32), 8),
                        to_mbs(cr.to(torch.int32), 8)])
    ypad = _recon_planes(1, h, w, y.device, None if top is None else top[:1])
    cpad = _recon_planes(2, h // 2, w // 2, y.device, None if top is None else top[1:])
    for r, c, mb in _diagonals(h // 16, w // 16, y.device):
        _step(ypad, r, c, 16,
              lambda p: _i16_luma_code(ysrc[mb], p[0], modes[mb], qp)[0][None])
        _step(cpad, r, c, 8,
              lambda p: _chroma_code(csrc[:, mb], p, cmodes[mb], qpc)[0])
    u8 = torch.uint8
    return (ypad[0, 1:, 1:].to(u8), cpad[0, 1:, 1:].to(u8), cpad[1, 1:, 1:].to(u8))


def chroma_recon_plain(cb, cr, cmodes, qpc: int, top=None):
    """Plain PyTorch K7: the chroma half of K1, wavefront_chroma_impl
    (h264_fer_tpu/kernels/wavefront.py:222). uint8 planes (H/2, W/2), int32
    chroma modes (nmb,) → uint8 recon planes. top: None, or the recon rows
    (cb (W/2,), cr (W/2,)) above the planes (its band= form)."""
    h, w = cb.shape
    csrc = torch.stack([to_mbs(cb.to(torch.int32), 8),
                        to_mbs(cr.to(torch.int32), 8)])
    cpad = _recon_planes(2, h, w, cb.device, top)
    for r, c, mb in _diagonals(h // 8, w // 8, cb.device):
        _step(cpad, r, c, 8,
              lambda p: _chroma_code(csrc[:, mb], p, cmodes[mb], qpc)[0])
    return cpad[0, 1:, 1:].to(torch.uint8), cpad[1, 1:, 1:].to(torch.uint8)


@functools.lru_cache(maxsize=None)
def qtab(qp: int) -> np.ndarray:
    """LEVEL_QUANTIZE and LEVEL_SCALE of qp in the 3-value pattern (even,
    even), (odd, odd), mixed: the 6 ints of the kernels' QpTab, read-only
    and made once per qp (the wrappers pass it on every launch)."""
    tab = np.array([int(t[qp % 6][i, j]) for t in (LEVEL_QUANTIZE, LEVEL_SCALE)
                    for i, j in ((0, 0), (1, 1), (0, 1))], dtype=np.int32)
    tab.flags.writeable = False
    return tab


def _check_planes(y, cb, cr, modes, cmodes):
    """Raise unless the planes and modes are what the kernel takes (and the
    planes aligned as its row copies need); returns (wmb, hmb). y may be
    None (chroma only)."""
    h, w = 2 * cb.shape[0], 2 * cb.shape[1]
    if h % 16 or w % 16:
        raise ValueError(f"frame {w}x{h} is not a whole number of MBs")
    hmb, wmb = h // 16, w // 16
    checks = [("cb", cb, (h // 2, w // 2), torch.uint8),
              ("cr", cr, (h // 2, w // 2), torch.uint8),
              ("cmodes", cmodes, (hmb * wmb,), torch.int32)]
    if y is not None:
        checks += [("y", y, (h, w), torch.uint8),
                   ("modes", modes, (hmb * wmb,), torch.int32)]
    for name, t, shape, dtype in checks:
        build.check_tensor(name, t, shape, dtype, cb.device)
    for name, t, align in (("y", y, 16), ("cb", cb, 8), ("cr", cr, 8)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name}: the kernel copies its rows in {align}-byte chunks")
    return wmb, hmb


def _launch(wrapper, symbol, y, cb, cr, modes, cmodes, levels, qps, blocks,
            band=False, top=None):
    """One launch of a kernel of csrc/wavefront_i16.cu (C entry point
    `symbol`) on CUDA tensors; returns the uint8 recon planes. y and modes
    None: K7 (chroma only); levels: the int32 level arrays the kernel
    writes (() for none); qps (qp, qpc), or (qpc,) for K7. band: a band
    entry point, whose recon planes have one more row above them, filled
    with the halo rows `top` (one per plane) unless top is None."""
    wmb, hmb = _check_planes(y, cb, cr, modes, cmodes)
    planes = tuple(t for t in (y, cb, cr) if t is not None)
    dev = cb.device
    if band:
        bufs = tuple(torch.empty((t.shape[0] + 1, t.shape[1]), dtype=torch.uint8,
                                 device=dev) for t in planes)
        if top is not None:
            for buf, row in zip(bufs, top):
                buf[0].copy_(row)
        rec = tuple(buf[1:] for buf in bufs)
        has_top = (int(top is not None),)
    else:
        rec = tuple(torch.empty_like(t) for t in planes)
        has_top = ()
    order, sched = dataflow.schedule(dataflow.diagonal_order(wmb, hmb), dev)
    build.launch(wrapper, "wavefront_i16", symbol,
                 (*planes, *(t for t in (modes, cmodes) if t is not None), *rec, *levels,
                  order, sched, wmb, hmb, *has_top, *qps,
                  np.concatenate([qtab(q) for q in qps]), blocks), dev)
    return rec


def _device(t) -> bool:
    """False for a CPU tensor (the plain twin runs), True for a CUDA one;
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def i16_recon(y, cb, cr, modes, cmodes, qp: int, qpc: int, *, blocks=None):
    """K1: reconstruct an all-I16 frame. y (H, W), cb/cr (H/2, W/2) uint8;
    modes/cmodes (nmb,) int32 Intra16x16 and chroma modes. Returns the
    uint8 recon planes. CUDA tensors go to the kernel, CPU tensors to
    i16_recon_plain. blocks: the kernel's grid size (None: as many blocks
    as fit on the card at once); any size gives the same result."""
    grid = dataflow.check_blocks(blocks)
    if not _device(y):
        return i16_recon_plain(y, cb, cr, modes, cmodes, qp, qpc)
    return _launch(i16_recon, "wavefront_i16_frame", y, cb, cr, modes, cmodes, (),
                   (qp, qpc), grid)


# kernel launches so far, as counted by the C entry point (one per accepted
# launch, one per frame)
i16_recon.launches = 0


def chroma_recon(cb, cr, cmodes, qpc: int, *, blocks=None):
    """K7 without its levels: reconstruct the intra chroma of a frame.
    cb/cr (H/2, W/2) uint8, cmodes (nmb,) int32 chroma modes, qpc the
    chroma QP. Returns the uint8 recon planes. CUDA tensors go to the
    kernel (one launch, counted on chroma_frame.launches), CPU tensors to
    chroma_recon_plain. blocks: as i16_recon's."""
    grid = dataflow.check_blocks(blocks)
    if not _device(cb):
        return chroma_recon_plain(cb, cr, cmodes, qpc)
    return _launch(chroma_frame, "wavefront_chroma_frame", None, cb, cr, None, cmodes, (),
                   (qpc,), grid)


def chroma_levels_from_recon(cb, cr, rcb, rcr, cmodes, qpc: int, top=None):
    """Chroma levels of an intra frame from its chroma reconstruction
    (source and recon planes of any integer dtype): (cdc (2, nmb, 4),
    cac (2, nmb, 4, 15)) int32. top: None, or the recon rows (cb, cr) above
    the planes (a band's halo)."""
    i32 = torch.int32
    csrc = torch.stack([to_mbs(cb.to(i32), 8), to_mbs(cr.to(i32), 8)])
    top = (None, None) if top is None else top
    p17 = torch.stack([neighbours(rcb.to(i32), 8, top[0]),
                       neighbours(rcr.to(i32), 8, top[1])])
    return _chroma_code(csrc, p17, cmodes, qpc)[1:]


def i16_levels_from_recon(y, cb, cr, ry, rcb, rcr, modes, cmodes,
                          qp: int, qpc: int, top=None):
    """Coefficient levels of an all-I16 frame from its reconstruction.

    Source planes and recon planes (any integer dtype) and the modes.
    Returns (i16dc (nmb, 16), ac (nmb, 16, 15), cdc (2, nmb, 4),
    cac (2, nmb, 4, 15)) int32, as i16_levels_from_recon_impl. top: None,
    or the recon rows (y, cb, cr) above the planes (a band's halo)."""
    i32 = torch.int32
    _, i16dc, ac = _i16_luma_code(to_mbs(y.to(i32), 16),
                                  neighbours(ry.to(i32), 16, None if top is None else top[0]),
                                  modes, qp)
    return (i16dc, ac, *chroma_levels_from_recon(
        cb, cr, rcb, rcr, cmodes, qpc, None if top is None else top[1:]))


def chroma_frame_plain(cb, cr, cmodes, qpc: int, top=None):
    """Plain PyTorch K7 with its levels: plain K7, then the levels from its
    recon. Returns (recon_cb, recon_cr, cdc, cac). top: as
    chroma_recon_plain's."""
    rcb, rcr = chroma_recon_plain(cb, cr, cmodes, qpc, top)
    return (rcb, rcr, *chroma_levels_from_recon(cb, cr, rcb, rcr, cmodes, qpc, top))


def chroma_frame(cb, cr, cmodes, qpc: int, *, blocks=None):
    """K7: (recon_cb, recon_cr, cdc (2, nmb, 4), cac (2, nmb, 4, 15)), the
    tuple of wavefront_chroma_impl, recon planes as uint8. CUDA tensors go
    to the kernel, which writes the levels as it reconstructs (one launch,
    the C entry point wavefront_chroma_frame_levels, counted on
    chroma_frame.launches); CPU tensors to chroma_frame_plain. blocks: as
    i16_recon's."""
    grid = dataflow.check_blocks(blocks)
    if not _device(cb):
        return chroma_frame_plain(cb, cr, cmodes, qpc)
    levels = _levels(cmodes.numel(), cb.device, False)
    rcb, rcr = _launch(chroma_frame, "wavefront_chroma_frame_levels", None, cb, cr, None,
                       cmodes, levels, (qpc,), grid)
    return (rcb, rcr, *levels)


# K7's kernel launches so far, by chroma_frame and chroma_recon, as counted
# by the C entry points (one per accepted launch, one per frame)
chroma_frame.launches = 0


def i16_frame_plain(y, cb, cr, modes, cmodes, qp: int, qpc: int, top=None):
    """Plain PyTorch K1t: plain K1, then the levels from its recon. top:
    as i16_recon_plain's (the plain K1t-band)."""
    ry, rcb, rcr = i16_recon_plain(y, cb, cr, modes, cmodes, qp, qpc, top)
    i16dc, ac, cdc, cac = i16_levels_from_recon(
        y, cb, cr, ry, rcb, rcr, modes, cmodes, qp, qpc, top)
    return ry, i16dc, ac, rcb, rcr, cdc, cac


def i16_frame(y, cb, cr, modes, cmodes, qp: int, qpc: int, *, blocks=None):
    """K1t: (recon_y, i16dc, ac, recon_cb, recon_cr, cdc, cac), the tuple of
    pallas_i16_frame (and of pallas_i16_frame_fast_impl), recon planes as
    uint8. CUDA tensors go to the kernel, which writes the levels as it
    reconstructs (the C entry point wavefront_i16_frame_levels); CPU
    tensors to i16_frame_plain. blocks: as i16_recon's."""
    grid = dataflow.check_blocks(blocks)
    if not _device(y):
        return i16_frame_plain(y, cb, cr, modes, cmodes, qp, qpc)
    levels = _levels(modes.numel(), y.device, True)
    ry, rcb, rcr = _launch(i16_frame, "wavefront_i16_frame_levels", y, cb, cr, modes,
                           cmodes, levels, (qp, qpc), grid)
    i16dc, ac, cdc, cac = levels
    return ry, i16dc, ac, rcb, rcr, cdc, cac


# kernel launches so far, counted as i16_recon's
i16_frame.launches = 0


def _levels(nmb: int, dev, luma: bool):
    """Empty int32 level arrays of nmb MBs as K1t (luma) or K7 writes them:
    (i16dc, ac, cdc, cac), or (cdc, cac)."""
    shapes = ((nmb, 16), (nmb, 16, 15)) if luma else ()
    return tuple(torch.empty(s, dtype=torch.int32, device=dev)
                 for s in shapes + ((2, nmb, 4), (2, nmb, 4, 15)))


def _check_top(top, planes) -> None:
    """Raise ValueError unless `top` is None or holds one uint8 row per
    plane, as wide as the plane, on its device."""
    if top is None:
        return
    if len(top) != len(planes):
        raise ValueError(f"top: {len(top)} rows for {len(planes)} planes")
    for row, plane in zip(top, planes):
        build.check_tensor("top row", row, plane.shape[1:], torch.uint8, plane.device)


def i16_band(y, cb, cr, modes, cmodes, qp: int, qpc: int, top=None, *, blocks=None):
    """K1t-band: i16_frame over one MB-row band. top: None for a band with
    no MB row above it, else the band above's last recon rows (y (W,), cb
    (W/2,), cr (W/2,)) uint8 on the band's device, which the band's first
    MB row reads as its top neighbours. Returns i16_frame's tuple for the
    band. CUDA tensors go to the kernel (the C entry point
    wavefront_i16_band_levels, one launch, counted on i16_band.launches),
    CPU tensors to i16_frame_plain(top=top). blocks: as i16_recon's."""
    grid = dataflow.check_blocks(blocks)
    _check_top(top, (y, cb, cr))
    if not _device(y):
        return i16_frame_plain(y, cb, cr, modes, cmodes, qp, qpc, top)
    levels = _levels(modes.numel(), y.device, True)
    ry, rcb, rcr = _launch(i16_band, "wavefront_i16_band_levels", y, cb, cr, modes,
                           cmodes, levels, (qp, qpc), grid, band=True, top=top)
    i16dc, ac, cdc, cac = levels
    return ry, i16dc, ac, rcb, rcr, cdc, cac


i16_band.launches = 0


def chroma_band(cb, cr, cmodes, qpc: int, top=None, *, blocks=None):
    """K7-band: chroma_frame over one MB-row band. top: None, or the band
    above's last chroma recon rows (cb (W/2,), cr (W/2,)) uint8 on the
    band's device. Returns chroma_frame's tuple for the band. CUDA tensors
    go to the kernel (wavefront_chroma_band_levels, counted on
    chroma_band.launches), CPU tensors to chroma_frame_plain(top=top).
    blocks: as i16_recon's."""
    grid = dataflow.check_blocks(blocks)
    _check_top(top, (cb, cr))
    if not _device(cb):
        return chroma_frame_plain(cb, cr, cmodes, qpc, top)
    levels = _levels(cmodes.numel(), cb.device, False)
    rcb, rcr = _launch(chroma_band, "wavefront_chroma_band_levels", None, cb, cr, None,
                       cmodes, levels, (qpc,), grid, band=True, top=top)
    return (rcb, rcr, *levels)


chroma_band.launches = 0
