"""Whole-frame intra mode decision (K11).

`i16_decision` and `full_decision` are the wrappers of the CUDA kernel
csrc/mode_decision.cu in its two forms, the device form of the XLA program
h264_fer_tpu/codec/tpu_intra.py intra_mode_decision_impl (:55) with
modes_only=True (i16_only=True for the I16 form), which no Pallas kernel
replaced. They take CUDA tensors only: codec/intra_decision.py's
intra16_mode_decision and intra_mode_decision send a CPU tensor to their
plain twins (intra16_mode_decision_plain, intra_mode_decision_plain) and a
CUDA one here, and each wrapper returns what its twin returns, equal bit
for bit. A decision is one launch, counted on its wrapper's `.launches`,
writing one int32 buffer whose parts are the outputs.
"""

from __future__ import annotations

import torch

from . import build
from .wavefront_i16 import qtab

I32 = torch.int32
PLANE_DTYPES = (torch.uint8, torch.int32)


def _check(y, qp: int, top_row=None) -> tuple[int, int]:
    """(wmb, hmb) of the source plane y; ValueError unless y is a contiguous
    (16 hmb, 16 wmb) uint8 or int32 plane with at least one MB, qp is in
    0..51 and top_row is None or a contiguous (W,) int32 row on y's
    device."""
    if (y.dim() != 2 or y.shape[0] % 16 or y.shape[1] % 16 or not y.numel()
            or y.dtype not in PLANE_DTYPES or not y.is_contiguous()):
        raise ValueError(f"y: expected a contiguous uint8 or int32 (16 hmb, 16 wmb) plane, "
                         f"got {y.dtype} {tuple(y.shape)}")
    if not 0 <= qp <= 51:
        raise ValueError(f"qp {qp} outside 0..51")
    if top_row is not None:
        build.check_tensor("top_row", top_row, (y.shape[1],), I32, y.device)
    return y.shape[1] // 16, y.shape[0] // 16


def _cuda(y) -> None:
    """ValueError unless y lies on a CUDA device."""
    if y.device.type != "cuda":
        raise ValueError("K11 takes CUDA tensors; codec/intra_decision.py sends CPU "
                         "tensors to the plain twins")


def _launch(wrapper, y, qp: int, top_row, full: bool):
    """Check the arguments, then run one launch of the kernel's form on y's
    card; returns (its output buffer, nmb)."""
    wmb, hmb = _check(y, qp, top_row)
    _cuda(y)
    nmb = wmb * hmb
    out = torch.empty(((19 if full else 2) * nmb,), dtype=I32, device=y.device)
    build.launch(wrapper, "mode_decision", "mode_decision",
                 (y, int(y.dtype == torch.uint8), top_row, int(full), out, wmb, hmb, qp,
                  qtab(qp)), y.device)
    return out, nmb


def i16_decision(y, qp: int, top_row=None):
    """K11's I16 form: intra16_mode_decision_plain's (mode16 (nmb,), satd16
    (nmb,)), int32, of a CUDA plane."""
    out, nmb = _launch(i16_decision, y, qp, top_row, full=False)
    return out[:nmb], out[nmb:]


def full_decision(y, qp: int, top_row=None) -> dict:
    """K11's full form: intra_mode_decision_plain's dict (mode16, satd16,
    mode4 (nmb, 16) Z-scan, satd4), int32, of a CUDA plane."""
    out, nmb = _launch(full_decision, y, qp, top_row, full=True)
    return {"mode16": out[:nmb], "satd16": out[nmb:2 * nmb],
            "mode4": out[3 * nmb:].view(nmb, 16), "satd4": out[2 * nmb:3 * nmb]}


# kernel launches so far (one per accepted launch)
i16_decision.launches = 0
full_decision.launches = 0
