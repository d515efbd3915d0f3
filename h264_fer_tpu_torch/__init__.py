"""H.264 Baseline intra (all-Intra16x16 or mixed I4x4/I16) and IPPP encoder
with the in-loop deblocking filter, and its decoder, in PyTorch and CUDA.

A port of the h264_fer_tpu JAX package (the frozen reference) to PyTorch
on an NVIDIA H100. It imports neither JAX nor anything of h264_fer_tpu.
Its entry points run on the card (device "cuda") unless the caller asks
for the CPU, where the plain PyTorch version of each kernel runs.

All-intra path: parallel.gop_device.GopIntraEncoder → codec.iframe.device_i16_frame
→ mode decision, the CUDA wavefront kernel K1t (kernels/csrc/wavefront_i16.cu:
the reconstruction with the levels written from the kernel), whole-slice
CAVLC on the device → host slice header, payload, EPB.

Mixed all-intra path: GopIntraEncoder(mode="mixed") → codec.iframe.device_mixed_frame
→ the full intra mode decision (Intra16x16 and Intra4x4 modes), K7 (the chroma
wavefront writing its levels, csrc/wavefront_i16.cu's
wavefront_chroma_frame_levels), chroma setup, K6
(the exact I4x4-vs-I16 arbitration wavefront, csrc/wavefront_mixed.cu, whose
Intra_4x4 MB coding csrc/intra4x4.cuh shares with K4x4,
csrc/wavefront_i4x4.cu), mixed-slice CAVLC → the same host stitch.

IPPP path: parallel.gop_device.GopIpppEncoder → codec.gop.device_gop_ippp,
one GOP at a time: the I16 frame, then per P frame codec.pframe.device_p_frame
→ interpolated planes, the CUDA kernels K2 (integer search, csrc/me_int.cu),
K3 (qpel refine, csrc/me_qpel.cu), K4 (decision wavefront, csrc/wavefront_p.cu)
and K5 (MC, csrc/mc.cu), residual and recon, P-slice CAVLC; the reference
planes and MVs carried on the device → host slice headers, payloads, EPB.

Session path: codec.encoder.Encoder, one frame in and one slice NAL out:
IDRs by period or scene cut through the I frames above, P frames through
device_p_frame, the trailing-skip drop, then with cfg.deblock the in-loop
filter K8 (csrc/deblock.cu, knight waves of MB windows) on every frame.

Host path: the same Encoder with iframe="host" and pframe="host" (python
-m h264_fer_tpu_torch encode without --tpu-* flags, cli.py) →
codec.encoder_host.HostEncoder, the reference encoder's exact per-MB
decision and CAVLC in numpy on the host (its I frames write the C++
reference's bytes), the trailing-skip drop, then with cfg.deblock K8 on
the card on every frame. Host and device frames mix (a device I frame
hands its state to host P frames, a host I frame to device P frames), and
device_modes=True gives host I frames the device's mode decision.

Decode path: codec.decoder.Decoder (python -m h264_fer_tpu_torch decode):
the bit-serial CAVLC parse and the per-MB reconstruction on the host, in
the native C++ slice loop (native/decoder_native.cpp, built by g++) or its
Python form, then with deblock=True the in-loop filter K8 on the card for
every frame whose stream signals it; the filtered planes are the next
frame's reference.

Multi-device paths (parallel/): the sequence encoders take `devices`, a
list driven by this one process whose entries may repeat, each a lane
with a CUDA stream of its own; GopIntraEncoder / GopIpppEncoder split
frames / GOPs in shares; parallel.tile.TileIntraEncoder and
GopTileIntraEncoder code each frame in MB-row bands, pipelined across
frames, with the band forms of K1t, K7 and K6; parallel.dist spans GOPs
over processes (gloo).
"""

from __future__ import annotations

import numpy as np


def entry(device="cuda"):
    """(fn, example_args): one all-I16 frame encode at QCIF, QP 28, on
    `device` (raises when CUDA is asked for and absent). fn(y, cb, cr)
    returns (payload words, nbits, recon_y)."""
    import torch

    from .codec.iframe import device_i16_frame
    from .ops.device import resolve_device
    from .ops.transform import chroma_qp

    dev = resolve_device(device)
    W, H, QP = 176, 144, 28

    def fn(y, cb, cr):
        out = device_i16_frame(y, cb, cr, QP, chroma_qp(QP, 0))
        return out["words"], out["nbits"], out["recon_y"]

    rng = np.random.default_rng(0)
    planes = (rng.integers(0, 256, (H, W)),
              rng.integers(0, 256, (H // 2, W // 2)),
              rng.integers(0, 256, (H // 2, W // 2)))
    args = tuple(torch.from_numpy(p.astype(np.uint8)).to(dev) for p in planes)
    return fn, args
