"""The 16 interpolated luma phase planes (K13).

`interp_planes` is the wrapper of the CUDA kernel csrc/interp.cu, the
device form of the XLA stages interpolated_planes_jax and
interpolated_planes_banded_jax (h264_fer_tpu/ops/interp.py:131, 138), which
no Pallas kernel replaced. It takes CUDA tensors only:
ops/interp.interpolated_planes and interpolated_planes_banded send a CPU
tensor to their plain twins (interpolated_planes_plain,
interpolated_planes_banded_plain) and a CUDA one here, and the wrapper
returns what the twin returns, equal bit for bit. One launch a reference
plane or band, counted on `interp_planes.launches`.
"""

from __future__ import annotations

import torch

from . import build

def _cuda(t) -> None:
    """ValueError unless t lies on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError("K13 takes CUDA tensors; ops/interp.py sends CPU tensors to "
                         "the plain twins")


# the widest plane row K13 takes: two strips of 120 positions for each of a
# block's 18 warps (csrc/interp.cu kStrip, kMaxWarps)
MAX_ROW = 2 * 18 * 120


def _check(ref, ext: int, band: bool) -> tuple[int, int]:
    """(he, row_off) of the launch; ValueError unless ref is a contiguous
    uint8 plane, ext >= 0, the planes' rows (W + 2 ext) are at most MAX_ROW
    wide and, for a band, ref holds more than the 2 (ext + 4) rows around
    the band's own."""
    if (ref.dim() != 2 or not ref.numel() or ref.dtype != torch.uint8
            or not ref.is_contiguous()):
        raise ValueError(f"ref: expected a contiguous uint8 plane, got "
                         f"{ref.dtype} {tuple(ref.shape)}")
    if ext < 0:
        raise ValueError(f"ext {ext} < 0")
    if ref.shape[1] + 2 * ext > MAX_ROW:
        raise ValueError(f"rows of {ref.shape[1] + 2 * ext} positions: K13 takes at most "
                         f"{MAX_ROW}")
    rows = ref.shape[0]
    if not band:
        return rows + 2 * ext, -ext
    if rows <= 2 * (ext + 4):
        raise ValueError(f"ref_v: {rows} rows hold no band within 2 x {ext + 4} halo rows")
    return rows - 8, 4


def interp_planes(ref, ext: int, band: bool = False):
    """K13: the (16, he, W + 2 ext) uint8 planes of a uint8 CUDA plane:
    interpolated_planes_plain(ref, ext), or with `band`
    interpolated_planes_banded_plain(ref, ext) (he = rows - 8)."""
    he, row_off = _check(ref, ext, band)
    _cuda(ref)
    rows, w = ref.shape
    out = torch.empty((16, he, w + 2 * ext), dtype=torch.uint8, device=ref.device)
    build.launch(interp_planes, "interp", "interp_planes",
                 (ref, out, rows, w, ext, row_off, he),
                 ref.device)
    return out


# kernel launches so far (one per accepted launch)
interp_planes.launches = 0
