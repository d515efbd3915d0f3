"""MB tiling of frame planes (torch): MB tiles, their 4x4 blocks in Z-scan
(luma) or raster (chroma) order, and each MB's neighbour samples in the
layout of ops/intra."""

from __future__ import annotations

import torch


def mb_blocks(x):
    """(..., 16, 16) MB images → (..., 16, 4, 4) 4x4 blocks in Z-scan order
    (quadrant-major, Intra4x4ScanOrder)."""
    lead = x.shape[:-2]
    b = x.reshape(*lead, 2, 2, 4, 2, 2, 4)  # qr, sr, y, qc, sc, x
    b = b.permute(*range(len(lead)), -6, -3, -5, -2, -4, -1)
    return b.reshape(*lead, 16, 4, 4)


def blocks_mb(blocks):
    """Inverse of mb_blocks: (..., 16, 4, 4) Z-scan blocks → (..., 16, 16)."""
    lead = blocks.shape[:-3]
    b = blocks.reshape(*lead, 2, 2, 2, 2, 4, 4)  # qr, qc, sr, sc, y, x
    b = b.permute(*range(len(lead)), -6, -4, -2, -5, -3, -1)
    return b.reshape(*lead, 16, 16)


def chroma_blocks(x):
    """(..., 8, 8) chroma MBs → (..., 4, 4, 4) raster 4x4 blocks."""
    b = x.reshape(*x.shape[:-2], 2, 4, 2, 4).transpose(-3, -2)
    return b.reshape(*x.shape[:-2], 4, 4, 4)


def chroma_mb(blocks):
    """Inverse of chroma_blocks."""
    b = blocks.reshape(*blocks.shape[:-3], 2, 2, 4, 4).transpose(-3, -2)
    return b.reshape(*blocks.shape[:-3], 8, 8)


def to_mbs(plane, n: int):
    """(H, W) plane → (nmb, n, n) raster-ordered MB tiles."""
    h, w = plane.shape
    return (plane.reshape(h // n, n, w // n, n).transpose(1, 2)
            .reshape(-1, n, n))


def from_mbs(mbs, hm: int, wm: int):
    """Inverse of to_mbs: (hm * wm, n, n) raster MB tiles → (H, W) plane."""
    n = mbs.shape[-1]
    return mbs.reshape(hm, wm, n, n).transpose(1, 2).reshape(hm * n, wm * n)


def neighbours(plane, n: int, top=None):
    """Corner / left column / top row of every n x n MB of `plane`, with -1
    outside the frame: (nmb, 2n+1) in the corner, left, top layout of
    ops/intra. top: None, or the (W,) row above the plane (an MB-row band's
    halo), which the first MB row then reads."""
    h, w = plane.shape
    hm, wm = h // n, w // n
    pp = torch.nn.functional.pad(plane, (1, 0, 1, 0), value=-1)
    if top is not None:
        pp[0, 1:] = top
    corner = pp[0:h:n, 0:w:n]
    lefts = pp[1 : h + 1, 0:w:n].reshape(hm, n, wm).transpose(1, 2)
    tops = pp[0:h:n, 1 : w + 1].reshape(hm, wm, n)
    return torch.cat([corner[..., None], lefts, tops], dim=-1).reshape(
        hm * wm, 2 * n + 1)
